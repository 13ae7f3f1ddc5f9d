"""The port's fused SA (ops/sa_fused.py, kernels K4/K5) and SetAbstraction
against the JAX package, at the small widths of tests/test_sa_fused.py
(B 2, N 64, S 16, K 8).

On the CPU the wrapper runs its plain version `sa_eval_plain`; it is held
against the JAX fused kernel (Pallas, interpret mode on CPU) and the
unfused flax SetAbstraction at atol 1e-4, the tolerance of
tests/test_sa_fused.py: f32 throughout, the BN fold and the A-form
reassociate. The CUDA kernels are held to the plain version on the card by
chip_smoke.py.

The bf16 mode against JAX's `dtype=jnp.bfloat16` with `int8_gather=True`
(its interpret mode then gathers bf16-rounded A rows, as the compiled TPU
kernel and the port do), at tests/_torch_port.py's bf16 limits: |port -
jax| <= 2^-8 max|jax| at any element, one bf16 step at the top of the
range, for a rounding boundary crossed by another f32 sum order, and <=
2^-15 max|jax| on average. Measured: equal. The f32 mode on the same inputs
is held outside those limits (the control).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3dsot_tpu.models.pointnet import SetAbstraction as JSA
from open3dsot_tpu.ops import ball_query as j_ball_query
from open3dsot_tpu.ops.sa_fused import a_form as j_a_form
from open3dsot_tpu.ops.sa_fused import fold_dense_bn as j_fold
from open3dsot_tpu.ops.sa_fused import fused_sa_apply as j_fused_sa_apply
from open3dsot_tpu_torch.models.layers import set_compute_dtype
from open3dsot_tpu_torch.models.pointnet import SetAbstraction
from open3dsot_tpu_torch.ops import sa_fused
from open3dsot_tpu_torch.ops.neighbors import ball_query
from tests._torch_port import (assert_close_bf16, assert_f32_fails_bf16, load_into, randomize,
                               t)

ATOL = 1e-4
B, N, S, K, C = 2, 64, 16, 8, 12
MLP = [16, 16, 24]


def _setup(seed, with_features=True, normalize_xyz=False, n=N, s=S, k=K, mlp=MLP,
           radius=0.8, use_fps=False):
    rng = np.random.default_rng(seed)
    xyz = rng.standard_normal((B, n, 3)).astype(np.float32)
    feats = rng.standard_normal((B, n, C)).astype(np.float32) if with_features else None
    kw = dict(mlp=mlp, radius=radius, nsample=k, use_fps=use_fps, normalize_xyz=normalize_xyz)
    jsa = JSA(**kw)
    v = randomize(jsa.init(jax.random.PRNGKey(0), xyz, feats, s, train=False), rng)
    port = load_into(SetAbstraction(C if with_features else 0, mlp, radius, k, use_fps=use_fps,
                                    normalize_xyz=normalize_xyz), v)
    return xyz, feats, jsa, v, port


def _mlp(v):
    return v["params"]["mlp_shared"], v["batch_stats"]["mlp_shared"]


@pytest.mark.parametrize("with_features", [False, True])
@pytest.mark.parametrize("normalize_xyz", [False, True])
def test_plain_matches_jax_kernel(with_features, normalize_xyz):
    xyz, feats, _, v, port = _setup(0, with_features, normalize_xyz)
    new_xyz = xyz[:, :S]
    kw = dict(radius=0.8, normalize_xyz=normalize_xyz, use_xyz=True)
    want = j_fused_sa_apply(xyz, feats, new_xyz, None, *_mlp(v), nsample=K, interpret=True, **kw)
    f = None if feats is None else t(feats)
    got = sa_fused.fused_sa_apply(t(xyz), f, t(new_xyz), None, port.folded_chains(),
                                  nsample=K, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    plain = sa_fused.sa_eval_plain(t(xyz), f, t(new_xyz), None, port.folded_chains(),
                                   nsample=K, **kw)
    np.testing.assert_array_equal(plain.numpy(), got.numpy())


def test_ragged_centroid_count_matches_jax_kernel():
    """S = 11: no tile divides it (the kernel masks the last tile)."""
    xyz, feats, _, v, port = _setup(1, n=48, s=11, k=4, mlp=[8, 8, 8], radius=1.5)
    new_xyz = xyz[:, :11]
    kw = dict(radius=1.5, normalize_xyz=False, use_xyz=True)
    want = j_fused_sa_apply(xyz, feats, new_xyz, None, *_mlp(v), nsample=4, interpret=True, **kw)
    got = sa_fused.fused_sa_apply(t(xyz), t(feats), t(new_xyz), None, port.folded_chains(),
                                  nsample=4, **kw)
    assert got.shape == (B, 11, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_idx_mode_matches_bq_mode_and_jax_idx_kernel():
    xyz, feats, _, v, port = _setup(4)
    new_xyz = xyz[:, :S]
    kw = dict(radius=0.8, normalize_xyz=False, use_xyz=True)
    idx = ball_query(0.8, K, t(xyz), t(new_xyz))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_ball_query(0.8, K, xyz, new_xyz)))
    folded = port.folded_chains()
    by_idx = sa_fused.fused_sa_apply(t(xyz), t(feats), t(new_xyz), idx, folded, **kw)
    by_bq = sa_fused.fused_sa_apply(t(xyz), t(feats), t(new_xyz), None, folded, nsample=K, **kw)
    np.testing.assert_array_equal(by_idx.numpy(), by_bq.numpy())
    want = j_fused_sa_apply(xyz, feats, new_xyz, idx.numpy(), *_mlp(v), interpret=True, **kw)
    np.testing.assert_allclose(by_idx.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("use_xyz", [True, False])
def test_a_form_matches_jax(use_xyz):
    xyz, feats, _, v, port = _setup(5)
    w1, b1 = port.folded_chains()[0]
    jw1, jb1 = j_fold(v["params"]["mlp_shared"]["layer0"], v["batch_stats"]["mlp_shared"]["layer0"])
    np.testing.assert_allclose(w1.numpy(), np.asarray(jw1), rtol=1e-6, atol=1e-6)
    if not use_xyz:  # layer 1 then reads the features only
        w1, jw1 = w1[3:], np.asarray(jw1)[3:]
    a, ct = sa_fused.a_form(t(xyz), t(feats), t(xyz[:, :S]), w1, b1, inv_r=1.25, use_xyz=use_xyz)
    ja, jct = j_a_form(xyz, feats, xyz[:, :S], jw1, jb1, inv_r=1.25, use_xyz=use_xyz)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=ATOL)
    np.testing.assert_allclose(ct.numpy(), np.asarray(jct), atol=ATOL)


@pytest.mark.parametrize("fused_eval", [True, False])
@pytest.mark.parametrize("with_features,use_fps", [(True, False), (False, True)])
def test_set_abstraction_matches_unfused_flax(fused_eval, with_features, use_fps):
    xyz, feats, jsa, v, port = _setup(2, with_features, use_fps=use_fps)
    port.fused_eval = fused_eval
    want_xyz, want, want_idx = jsa.apply(v, xyz, feats, S, train=False)
    with torch.no_grad():
        got_xyz, got, got_idx = port(t(xyz), None if feats is None else t(feats), S)
    assert got_idx.dtype == torch.int32
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_wrapper_checks_and_counts():
    xyz, feats, _, _, port = _setup(6)
    folded = port.folded_chains()
    kw = dict(radius=0.8, normalize_xyz=False, use_xyz=True)
    sa_fused.reset_launch_counts()
    sa_fused.fused_sa_apply(t(xyz), t(feats), t(xyz[:, :S]), None, folded, nsample=K, **kw)
    assert (sa_fused.fused_sa_apply.launches, sa_fused.fused_sa_apply.idx_launches) == (0, 0)
    with pytest.raises(ValueError, match="nsample"):
        sa_fused.fused_sa_apply(t(xyz), t(feats), t(xyz[:, :S]), None, folded, **kw)
    with pytest.raises(ValueError, match="gather"):
        sa_fused.fused_sa_apply(t(xyz), t(feats), t(xyz[:, :S]), None, folded, nsample=K,
                                gather="bulk", **kw)
    with pytest.raises(ValueError, match="3 folded layers"):
        sa_fused.fused_sa_apply(t(xyz), t(feats), t(xyz[:, :S]), None, folded[:2], nsample=K, **kw)
    with pytest.raises(ValueError):
        sa_fused.fused_sa_apply(t(xyz).to("meta"), None, t(xyz[:, :S]).to("meta"), None,
                                folded, nsample=K, **kw)
    port.train()  # the folded weights are eval-only; training takes the batch statistics
    with pytest.raises(NotImplementedError):
        port.folded_chains()


# --- K4/K5 on the tensor cores: what the CPU can check --------------------------
# csrc/sa_fused.cu runs layers 2-3 in 3xTF32 from weights packed by pack_sa
# (ops/chain_fused.py::pack_chunks) and computes ct itself. The tests below
# hold the packing to the folded weights bit for bit, an emulation of the
# kernel's arithmetic to float64 within TOL_3XTF32 (the bound chip_smoke.py
# holds the kernel to; TF32 alone misses it), and the kernel's ct formula to
# a_form's.

from open3dsot_tpu_torch.ops.chain_fused import CHUNK_IN, CHUNK_OUT, TOL_3XTF32, split_tf32


def _cdiv(a, b):
    return -(-a // b)


def _unpack(packed, k, c):
    """(hi, lo) of W^T (out, in), padded, from pack_chunks' layout."""
    nc, nk = _cdiv(_cdiv(c, 8) * 8, CHUNK_OUT), _cdiv(_cdiv(k, 8) * 8, CHUNK_IN)
    t = packed.reshape(nc, nk, 2, CHUNK_OUT // 8, CHUNK_IN // 4, 8, 4).permute(2, 0, 3, 5, 1, 4, 6)
    hi, lo = t.reshape(2, nc * CHUNK_OUT, nk * CHUNK_IN)
    return hi, lo


@pytest.mark.parametrize("mlp", [(64, 64, 128), (128, 128, 256), (256, 256, 256), (16, 16, 24)])
def test_packed_weights_unpack_to_the_folded_weights(mlp):
    """K4's weights as pack_sa lays them out (the BAT backbone's three SA
    widths and the tests' small one): layer 1's xyz rows and the biases as
    folded, W2 and W3 as whole zero-padded chunks of hi = tf32(W^T) and lo =
    tf32(W^T - hi), bit for bit."""
    _, _, _, _, port = _setup(7, mlp=list(mlp))
    folded = port.folded_chains()
    assert isinstance(folded, sa_fused.FoldedSA) and folded.packed is None  # CPU: nothing packed
    packed = sa_fused.pack_sa(folded)
    (w1, b1), (w2, b2), (w3, b3) = folded
    assert torch.equal(packed.w1x, w1[:3]) and torch.equal(packed.b1, b1)
    assert torch.equal(packed.b2, b2) and torch.equal(packed.b3, b3)
    for w, p in ((w2, packed.w2), (w3, packed.w3)):
        k, c = w.shape
        # csrc/sa_fused.cu::packed_floats
        assert p.numel() == _cdiv(_cdiv(c, 8) * 8, CHUNK_OUT) * _cdiv(_cdiv(k, 8) * 8, CHUNK_IN) \
            * 2 * CHUNK_OUT * CHUNK_IN
        hi, lo = _unpack(p, k, c)
        want_hi, want_lo = split_tf32(w.t().contiguous())
        assert torch.equal(hi[:c, :k], want_hi) and torch.equal(lo[:c, :k], want_lo)
        assert not hi[c:].any() and not hi[:, k:].any() and not lo[c:].any() and not lo[:, k:].any()


def test_folded_sa_is_the_folded_pairs_and_cached():
    _, _, _, _, port = _setup(8)
    folded = port.folded_chains()
    assert folded is port.folded_chains()  # packed once per change of the weights
    assert len(folded) == 3 and isinstance(folded[:2], tuple) and len(folded[:2]) == 2
    for (w, b), (pw, pb) in zip(folded, port.mlp_shared.folded()):
        assert torch.equal(w, pw) and torch.equal(b, pb)


def _tc_layer(h, w, b, three):
    """relu(h @ w + b) as csrc/sa_fused.cu runs it: the accumulators start at
    b, and each 32-input chunk's products a_lo w_hi + a_hi w_lo + a_hi w_hi
    are summed on the tensor cores and added to the accumulators on the CUDA
    cores (TF32 alone: a_hi w_hi only)."""
    hh, hl = split_tf32(h)
    wh, wl = split_tf32(w)
    acc = b.expand(h.shape[0], -1).clone()
    for k0 in range(0, h.shape[1], CHUNK_IN):
        k1 = k0 + CHUNK_IN
        part = hh[:, k0:k1] @ wh[k0:k1]
        if three:
            part = (hl[:, k0:k1] @ wh[k0:k1] + hh[:, k0:k1] @ wl[k0:k1]) + part
        acc = acc + part
    return torch.relu(acc)


def _within(got, want, tol):
    """chip_smoke.py's form: |got - want| <= tol * max|want| + tol * |want|."""
    err = (got.double() - want).abs()
    return bool((err <= tol * want.abs().max() + tol * want.abs()).all()), err.max().item()


def test_3xtf32_emulation_of_k4_within_bound_of_float64():
    """Layers 2-3 and the max of K4 in the kernel's arithmetic at one BAT call
    (template SA2: N 128 -> S 64, K 32, 256 -> 256 -> 256), from the A-form
    rows and ct: within TOL_3XTF32 of float64, where TF32 alone misses."""
    rng = np.random.default_rng(11)
    n_pts, s, k, c = 128, 64, 32, 256
    f = lambda *sh: torch.from_numpy(rng.standard_normal(sh).astype(np.float32))  # noqa: E731
    a, ct = f(n_pts, c), f(s, c)
    w2, b2, w3, b3 = f(c, c) / 16, f(c) * 0.1, f(c, c) / 16, f(c) * 0.1
    idx = torch.from_numpy(rng.integers(0, n_pts, (s, k)))
    h1 = torch.relu(a[idx] + ct[:, None]).reshape(s * k, c)
    h64 = torch.relu(h1.double() @ w2.double() + b2.double())
    want = torch.relu(h64 @ w3.double() + b3.double()).reshape(s, k, c).amax(1)

    def k4(three):
        return _tc_layer(_tc_layer(h1, w2, b2, three), w3, b3, three).reshape(s, k, c).amax(1)

    ok3, err3 = _within(k4(True), want, TOL_3XTF32)
    ok1, err1 = _within(k4(False), want, TOL_3XTF32)
    assert ok3, f"3xTF32 emulation {err3:.3e} from float64"
    assert not ok1 and err1 > 10 * err3, (err1, err3)


def _fma(x, y, z):
    """f32 fused multiply-add, rounded once (through float64, exact for these)."""
    return (x.double() * y.double() + z.double()).float()


@pytest.mark.parametrize("normalize_xyz", [False, True])
def test_kernel_ct_formula_matches_a_form(normalize_xyz):
    """ct = b1 - (c * inv_r) W1_xyz as csrc/sa_fused.cu computes it per tile,
    fma(z, w_z, fma(y, w_y, x * w_x)), against a_form's ct (a torch.matmul)."""
    xyz, feats, _, _, port = _setup(9)
    (w1, b1), _, _ = port.folded_chains()
    inv_r = 1.0 / 0.8 if normalize_xyz else 1.0
    c = t(xyz[:, :S]) * inv_r
    x, y, z = c[..., 0:1], c[..., 1:2], c[..., 2:3]
    got = b1 - _fma(z, w1[2], _fma(y, w1[1], x * w1[0]))
    _, want = sa_fused.a_form(t(xyz), t(feats), t(xyz[:, :S]), w1, b1, inv_r=inv_r, use_xyz=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6 * float(want.abs().max()))


def test_c_signatures_match_the_sources():
    """ops/_build.py's ctypes signatures against each `extern "C"` entry of
    csrc/*.cu: as many arguments, each a pointer, int, long long or float
    where the source has one (ctypes would pass a wrong one silently or fail
    only on the card)."""
    import ctypes
    import re

    from open3dsot_tpu_torch.ops._build import CSRC, SIGNATURES

    kinds = {ctypes.c_void_p: "ptr", ctypes.c_int: "int", ctypes.c_longlong: "long long",
             ctypes.c_float: "float", ctypes.POINTER(ctypes.c_int): "ptr"}
    for lib, entries in SIGNATURES.items():
        src = (CSRC / f"{lib}.cu").read_text()
        found = dict(re.findall(r'extern "C" [\w ]+?\b(\w+)\(([^)]*)\)', src))
        assert set(found) == set(entries), lib
        for fn, sig in entries.items():
            argtypes = sig[0] if isinstance(sig, tuple) else sig
            params = [" ".join(a.split()) for a in found[fn].split(",")]
            want = ["ptr" if "*" in a else "long long" if a.startswith("long long")
                    else a.rsplit(" ", 1)[0] for a in params]
            assert [kinds[t] for t in argtypes] == want, fn


# --- the bf16 mode ------------------------------------------------------------

BF = torch.bfloat16


@pytest.mark.parametrize("with_features", [False, True])
@pytest.mark.parametrize("fuse_bq", [True, False])
def test_plain_bf16_matches_jax_int8_gather_kernel(fuse_bq, with_features):
    """K4 (ball query fused) and K5 (idx given) in bf16."""
    xyz, feats, _, v, port = _setup(9, with_features)
    port.dtype = BF
    new_xyz = xyz[:, :S]
    kw = dict(radius=0.8, normalize_xyz=False, use_xyz=True)
    idx = None if fuse_bq else ball_query(0.8, K, t(xyz), t(new_xyz))
    want = j_fused_sa_apply(xyz, feats, new_xyz, None if idx is None else idx.numpy(), *_mlp(v),
                            nsample=K if fuse_bq else None, interpret=True, dtype=jnp.bfloat16,
                            int8_gather=True, **kw)
    folded = port.folded_chains()
    assert folded.dtype is BF
    f = None if feats is None else t(feats)
    got = sa_fused.fused_sa_apply(t(xyz), f, t(new_xyz), idx, folded,
                                  nsample=K if fuse_bq else None, **kw)
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    assert_close_bf16(got, want)
    # bf16 features are the same features (a_form takes them as f32)
    if feats is not None:
        fb = t(feats).to(BF)
        a = sa_fused.fused_sa_apply(t(xyz), fb, t(new_xyz), idx, folded,
                                    nsample=K if fuse_bq else None, **kw)
        b = sa_fused.fused_sa_apply(t(xyz), fb.float(), t(new_xyz), idx, folded,
                                    nsample=K if fuse_bq else None, **kw)
        assert torch.equal(a, b)
    # the same layers folded for the f32 mode: f32 out, outside the bf16 limits
    f32 = sa_fused.fused_sa_apply(t(xyz), f, t(new_xyz), idx, sa_fused.FoldedSA(folded),
                                  nsample=K if fuse_bq else None, **kw)
    assert f32.dtype == torch.float32
    assert_f32_fails_bf16(f32, want)


@pytest.mark.parametrize("fused_eval", [True, False])
@pytest.mark.parametrize("with_features,use_fps", [(True, False), (False, True)])
def test_set_abstraction_matches_flax_bf16(fused_eval, with_features, use_fps, monkeypatch):
    """JAX's fused SA gathers bf16-rounded A rows on the TPU (its int8 byte
    planes); its interpret mode does so with OPEN3DSOT_INT8_GATHER=1."""
    monkeypatch.setenv("OPEN3DSOT_INT8_GATHER", "1")
    rng = np.random.default_rng(5)
    xyz = rng.standard_normal((2, 64, 3)).astype(np.float32)
    feats = rng.standard_normal((2, 64, 12)).astype(np.float32) if with_features else None
    kw = dict(mlp=[16, 16, 24], radius=0.8, nsample=8, use_fps=use_fps)
    v = randomize(JSA(**kw).init(jax.random.PRNGKey(0), xyz, feats, 16, train=False), rng)
    jsa = JSA(fused_eval=fused_eval, dtype=jnp.bfloat16, **kw)
    port = load_into(SetAbstraction(12 if with_features else 0, [16, 16, 24], 0.8, 8,
                                    use_fps=use_fps, fused_eval=fused_eval, dtype=BF), v)
    want_xyz, want, want_idx = jsa.apply(v, xyz, feats, 16, train=False)
    with torch.no_grad():
        got_xyz, got, got_idx = port(t(xyz), None if feats is None else t(feats), 16)
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    assert_close_bf16(got, want)
    set_compute_dtype(port, None)
    with torch.no_grad():
        assert_f32_fails_bf16(port(t(xyz), None if feats is None else t(feats), 16)[1], want)



@pytest.mark.parametrize("mlp", [(64, 64, 128), (256, 256, 256), (16, 16, 24), (24, 36, 68)])
def test_bf16_packed_weights_unpack_to_the_rounded_weights(mlp):
    """pack_sa in the bf16 mode: W2 and W3 as whole zero-padded panels of
    bf16(W^T), 64 or 128 output x 64 input channels, output-chunk major, core
    matrices of 8 x 8
    (csrc/sa_fused_bf16.cu::panel_floats, csrc/bf16_layers.cuh); (24, 36, 68):
    widths that are multiples of 4 but not of 8."""
    from open3dsot_tpu_torch.ops.chain_fused import PANEL_K as P, panel_width

    _, _, _, _, port = _setup(7, mlp=list(mlp))
    folded = port.folded_chains()
    packed = sa_fused.pack_sa(folded, BF)
    (w1, b1), (w2, b2), (w3, b3) = folded
    assert torch.equal(packed.w1x, w1[:3]) and torch.equal(packed.b2, b2)
    for w, p in ((w2, packed.w2), (w3, packed.w3)):
        k, c = w.shape
        pw = panel_width(c)
        nc, nk = _cdiv(c, pw), _cdiv(k, P)
        assert p.dtype == torch.float32 and p.numel() == nc * nk * pw * P // 2
        wt = (p.view(BF).reshape(nc, nk, pw // 8, P // 8, 8, 8)
              .permute(0, 2, 4, 1, 3, 5).reshape(nc * pw, nk * P))
        assert torch.equal(wt[:c, :k], w.t().to(BF))
        assert not wt[c:].float().any() and not wt[:, k:].float().any()
