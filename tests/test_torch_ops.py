"""The port's point ops (ops/sampling.py, ops/neighbors.py, ops/grouping.py)
against the JAX ops and the numpy CUDA-semantics references
(open3dsot_tpu/ops/reference.py), on seeded inputs.

Indices are compared for exact equality. FPS (K3) runs its plain version
here: the CUDA kernel is held to it, index for index, by chip_smoke.py, and
the Pallas FPS kernel's own test skips off the TPU.
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
    with pytest.raises(ValueError):
        sampling.furthest_point_sample(t(xyz).to("meta"), 3)
    with pytest.raises(ValueError):
        sampling.furthest_point_sample(t(xyz[..., :2]), 3)


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
