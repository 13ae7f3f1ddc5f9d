"""The port's point ops (ops/sampling.py, ops/neighbors.py, ops/grouping.py)
against the JAX ops and the numpy CUDA-semantics references
(open3dsot_tpu/ops/reference.py), on seeded inputs.

Indices are compared for exact equality. FPS (K3) runs its plain version
here: the CUDA kernel is held to it, index for index, by chip_smoke.py, and
the Pallas FPS kernel's own test skips off the TPU. What K3 decides on the
host (its block, `fps_block`) is tested here, and so is its argmax: a torch
emulation of the kernel's three levels (a thread's tree, a warp's two
redux.sync on the bits of d^2, the same over the warps' slots).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3dsot_tpu.ops import ball_query as j_ball_query
from open3dsot_tpu.ops import furthest_point_sample as j_fps
from open3dsot_tpu.ops import gather_points as j_gather
from open3dsot_tpu.ops import group_points as j_group
from open3dsot_tpu.ops import knn as j_knn
from open3dsot_tpu.ops.neighbors import pairwise_sqdist as j_sqdist
from open3dsot_tpu.ops.reference import ball_query_ref, fps_ref, knn_ref
from open3dsot_tpu_torch.ops import sampling
from open3dsot_tpu_torch.ops.grouping import gather_points, group_points
from open3dsot_tpu_torch.ops.neighbors import ball_query, knn, pairwise_sqdist, sqdist_direct
from tests._torch_port import t


def _cloud(rng, b, n, scale=2.0):
    return ((rng.random((b, n, 3)) * 2 - 1) * scale).astype(np.float32)


def _with_duplicates(rng, xyz, distinct):
    """Every point a copy of one of the first `distinct`: FPS and kNN ties,
    as BAT's templates upsampled by repetition (regularize_pc)."""
    return xyz[:, rng.integers(0, distinct, xyz.shape[1])]


@pytest.mark.parametrize("b,n,npoint,dup", [(2, 64, 16, False), (3, 256, 128, False),
                                            (2, 256, 200, True), (1, 100, 100, True)])
def test_fps_matches_reference_and_jax(b, n, npoint, dup):
    rng = np.random.default_rng(n + npoint)
    xyz = _cloud(rng, b, n, scale=rng.uniform(0.5, 20))
    if dup:
        xyz = _with_duplicates(rng, xyz, n // 4)
    got = sampling.furthest_point_sample(t(xyz), npoint)
    assert got.dtype == torch.int32 and got.shape == (b, npoint)
    np.testing.assert_array_equal(got.numpy(), fps_ref(xyz, npoint))
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_fps(jnp.asarray(xyz), npoint)))


def test_fps_spread_and_launch_count():
    xyz = np.zeros((1, 100, 3), np.float32)
    xyz[0, :, 0] = np.linspace(0, 10, 100)
    sampling.reset_launch_counts()
    got = sampling.furthest_point_sample(t(xyz), 3)[0].tolist()
    assert got[:2] == [0, 99] and got[2] in (49, 50)
    assert sampling.furthest_point_sample.launches == 0  # a CPU tensor: the plain version
    with pytest.raises(ValueError, match="winner"):
        sampling.furthest_point_sample(t(xyz), 3, winner="global")
    with pytest.raises(ValueError):
        sampling.furthest_point_sample(t(xyz).to("meta"), 3)
    with pytest.raises(ValueError):
        sampling.furthest_point_sample(t(xyz[..., :2]), 3)


UINT_MAX = 0xFFFFFFFF


def _k3_emulation(xyz: np.ndarray, npoint: int, threads: int, masked: float = 0.0) -> np.ndarray:
    """csrc/fps.cu::fps_kernel at `threads` threads, level by level: point j
    on thread j % T in slot j // T; each thread's argmax a tree over its
    slots (the lower slot on ties); a warp's argmax the largest uint32 key
    (d^2's bits), then the lowest index holding it; the same over the warps'
    slots, lanes past the last warp keyed 0 with index UINT_MAX. A masked
    slot (j >= N) holds d^2 = `masked` (the kernel's +0)."""
    x = torch.from_numpy(xyz)
    B, N, _ = x.shape
    T = threads
    ppt = 1 << max(0, -(-N // T) - 1).bit_length()
    j = torch.arange(T)[None, :] + torch.arange(ppt)[:, None] * T  # (PPT, T)
    valid = j < N
    pts = torch.zeros(B, ppt, T, 3)
    pts[:, valid] = x[:, j[valid]]
    md = torch.where(valid, torch.tensor(1e10), torch.tensor(masked)).expand(B, ppt, T).clone()
    lanes, warps = torch.arange(T), T // 32
    out = np.zeros((B, npoint), np.int64)
    last = x[:, 0]
    for s in range(1, npoint):
        d = pts - last[:, None, None, :]
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
        if masked == 0.0:
            md = torch.minimum(md, d2)
        else:  # a masked slot keeps its value
            md = torch.where(valid, torch.minimum(md, d2), md)
        v, k = md.clone(), torch.arange(ppt)[None, :, None].expand(B, ppt, T).clone()
        w = 1
        while w < ppt:
            lo, hi = v[:, 0::2 * w], v[:, w::2 * w]
            take = hi > lo
            v[:, 0::2 * w] = torch.where(take, hi, lo)
            k[:, 0::2 * w] = torch.where(take, k[:, w::2 * w], k[:, 0::2 * w])
            w *= 2
        key = v[:, 0].contiguous().view(torch.int32).long() & UINT_MAX  # (B, T)
        idx = lanes + k[:, 0] * T

        def redux(key, idx):  # two redux.sync over the last axis
            top = key.max(-1, keepdim=True).values
            return top[..., 0], torch.where(key == top, idx, UINT_MAX).min(-1).values

        wkey, widx = redux(key.view(B, warps, 32), idx.view(B, warps, 32))
        if warps > 1:
            pad = 32 - warps
            wkey, widx = redux(torch.cat([wkey, torch.zeros(B, pad, dtype=torch.long)], 1),
                               torch.cat([widx, torch.full((B, pad), UINT_MAX)], 1))
        else:  # one warp: its argmax is the block's, no slots
            widx = widx[:, 0]
        out[:, s] = widx.numpy()
        if (widx >= N).any():  # the kernel would read a point past the cloud
            return out
        last = x[torch.arange(B), widx]
    return out


def test_fps_block_covers_every_n():
    """fps_block gives K3 a block it takes for every N it accepts: T and PPT
    powers of two, T in [32, 1024], PPT <= 32, T * PPT >= N; fps_winner the
    shared-memory copy only where it fits; fps_block refuses N outside [1, 32768]."""
    for n in range(1, sampling.MAX_N + 1):
        T, ppt = sampling.fps_block(n)
        assert 32 <= T <= 1024 and T & (T - 1) == 0, n
        assert 1 <= ppt <= sampling.MAX_PPT and ppt & (ppt - 1) == 0, n
        assert T * ppt >= n, n
    # BAT's two calls (search, template) at the sweep's fastest T
    assert sampling.fps_block(1024) == (256, 4) and sampling.fps_block(512) == (512, 1)
    # the cloud's copy in shared memory where its 12 N bytes fit beside the slots
    assert sampling.fps_winner(19264) == "shared" and sampling.fps_winner(19265) == "slot"
    assert sampling.fps_winner(1024) == "shared" and sampling.fps_winner(32768) == "slot"
    for bad in (0, sampling.MAX_N + 1):
        with pytest.raises(ValueError):
            sampling.fps_block(bad)


@pytest.mark.parametrize("threads", [32, 128, 1024])
@pytest.mark.parametrize("n,npoint,kind", [(33, 16, "continuous"), (100, 50, "duplicates"),
                                           (1000, 256, "continuous"), (1000, 300, "duplicates"),
                                           (1024, 512, "duplicates"), (33, 33, "identical"),
                                           (100, 100, "duplicates")])
def test_k3_emulation_matches_reference_and_jax(threads, n, npoint, kind):
    """K3's argmax at T threads, emulated, index for index against the
    numpy reference and the JAX op: ragged N, ties from duplicated points
    (BAT's upsampling), an all-identical cloud, npoint = N."""
    rng = np.random.default_rng(n * 7 + npoint)
    xyz = _cloud(rng, 2, n, scale=rng.uniform(0.5, 20))
    if kind == "duplicates":
        xyz = _with_duplicates(rng, xyz, max(2, n // 8))
    elif kind == "identical":
        xyz = np.broadcast_to(xyz[:, :1], xyz.shape).copy()
    got = _k3_emulation(xyz, npoint, threads)
    np.testing.assert_array_equal(got, fps_ref(xyz, npoint))
    np.testing.assert_array_equal(got, np.asarray(j_fps(jnp.asarray(xyz), npoint)))
    np.testing.assert_array_equal(got, sampling.furthest_point_sample(t(xyz), npoint).numpy())


def test_k3_emulation_needs_the_masked_key_at_zero():
    """The trap of the redux argmax: a masked slot keyed by -1.f's bits
    (0xBF800000) outranks every real d^2 and is picked; keyed 0 it never is."""
    xyz = np.zeros((1, 33, 3), np.float32)  # all identical: every real d^2 is 0
    assert _k3_emulation(xyz, 4, 64, masked=-1.0)[0, 1] >= 33
    assert _k3_emulation(xyz, 4, 64).tolist() == [[0, 0, 0, 0]]


@pytest.mark.parametrize("radius,nsample,n,s", [(0.5, 16, 128, 32), (0.3, 32, 256, 64),
                                                (1.5, 8, 48, 11)])
def test_ball_query_matches_reference_and_jax(radius, nsample, n, s):
    rng = np.random.default_rng(n)
    xyz = _cloud(rng, 2, n)
    centers = xyz[:, :s]
    got = ball_query(radius, nsample, t(xyz), t(centers))
    assert got.dtype == torch.int32 and got.shape == (2, s, nsample)
    np.testing.assert_array_equal(got.numpy(), ball_query_ref(radius, nsample, xyz, centers))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_ball_query(radius, nsample, jnp.asarray(xyz), jnp.asarray(centers))))


def test_ball_query_clustered_pad_and_empty():
    rng = np.random.default_rng(3)
    xyz = np.zeros((2, 512, 3), np.float32)
    xyz[:, :64] = rng.normal(size=(2, 64, 3)) * 0.05  # a dense cluster at 0
    xyz[:, 64:] = rng.normal(size=(2, 448, 3)) * 50 + 100  # far away
    centers = np.zeros((2, 16, 3), np.float32)
    np.testing.assert_array_equal(ball_query(0.3, 32, t(xyz), t(centers)).numpy(),
                                  ball_query_ref(0.3, 32, xyz, centers))
    # one isolated point: only itself in the ball, every slot repeats it
    xyz = np.array([[[0, 0, 0], [10, 10, 10]]], np.float32)
    assert (ball_query(0.5, 4, t(xyz), t(xyz[:, 1:])) == 1).all()
    # no point in the ball: zeros; nsample beyond N: padded with the first
    assert (ball_query(0.1, 4, t(xyz), t(xyz[:, :1] + 100)) == 0).all()
    assert ball_query(20.0, 5, t(xyz), t(xyz[:, :1])).tolist() == [[[0, 1, 0, 0, 0]]]


def test_sqdist_forms():
    rng = np.random.default_rng(4)
    a, b = _cloud(rng, 2, 16), _cloud(rng, 2, 40)
    want = np.asarray(j_sqdist(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(pairwise_sqdist(t(a), t(b)).numpy(), want, atol=1e-5)
    direct = ((a[:, :, None] - b[:, None]) ** 2).sum(-1)
    np.testing.assert_allclose(sqdist_direct(t(a), t(b)).numpy(), direct, rtol=1e-6, atol=1e-7)
    assert (pairwise_sqdist(t(a), t(a)).numpy() >= 0).all()  # clamped at 0


@pytest.mark.parametrize("dup", [False, True])
def test_knn_matches_reference_and_jax(dup):
    rng = np.random.default_rng(6)
    q, r = _cloud(rng, 2, 16), _cloud(rng, 2, 32)
    if dup:  # exact ties: the lowest index comes first, as lax.top_k
        r = _with_duplicates(rng, r, 6)
        q = np.concatenate([q, r[:, :4]], axis=1)
    got = knn(t(q), t(r), 4)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), knn_ref(q, r, 4))
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_knn(jnp.asarray(q), jnp.asarray(r), 4)))


def test_gather_and_group_match_jax():
    rng = np.random.default_rng(5)
    feats = rng.random((2, 10, 4)).astype(np.float32)
    idx = rng.integers(0, 10, (2, 6)).astype(np.int32)
    gidx = rng.integers(0, 10, (2, 3, 5)).astype(np.int32)
    np.testing.assert_array_equal(gather_points(t(feats), torch.from_numpy(idx)).numpy(),
                                  np.asarray(j_gather(jnp.asarray(feats), jnp.asarray(idx))))
    got = group_points(t(feats), torch.from_numpy(gidx))
    assert got.shape == (2, 3, 5, 4)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_group(jnp.asarray(feats), jnp.asarray(gidx))))
