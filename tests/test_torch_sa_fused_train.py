"""The port's training-mode SA (ops/sa_fused_train.py, kernel K6) and
SetAbstraction in training against the JAX package, at the sizes of
tests/test_sa_fused_train.py (B 2, N 64, S 16, K 8, C 12, MLP 16-16-24).

On the CPU the autograd.Function runs K6's plain version, forward and
backward. It is held against the JAX `fused_sa_train_apply` with
impl="ref" and impl="pallas" (interpret mode) at the tolerances of
tests/test_sa_fused_train.py: output rtol 2e-4 / atol 2e-5, batch
statistics rtol 1e-4 / atol 1e-5, gradients rtol 5e-4 / atol 5e-5 *
max(1, max|g|). Both sides are f32; the A-form reassociates layer 1 and the
statistics are E[y^2] - E[y]^2 sums in another order. The CUDA kernel is
held to the plain version on the card by chip_smoke.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3dsot_tpu.models.layers import MLP as JMLP
from open3dsot_tpu.models.pointnet import SetAbstraction as JSA
from open3dsot_tpu.ops import ball_query as j_ball_query
from open3dsot_tpu.ops.sa_fused_train import fused_sa_train_apply as j_fused_sa_train_apply
from open3dsot_tpu_torch.models.layers import MLP
from open3dsot_tpu_torch.models.pointnet import SetAbstraction
from open3dsot_tpu_torch.ops import sa_fused_train
from open3dsot_tpu_torch.weights import state_dict_from_jax
from tests._torch_port import load_into, randomize, t, to_numpy

B, N, S, K, C = 2, 64, 16, 8, 12
MLP_W = (16, 16, 24)
OUT_TOL = dict(rtol=2e-4, atol=2e-5)
STAT_TOL = dict(rtol=1e-4, atol=1e-5)


def _grad_close(got, want, name):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-5 * scale, err_msg=name)


def _setup(seed=0, radius=0.8):
    """The inputs and the perturbed MLP of tests/test_sa_fused_train.py::_setup."""
    rng = np.random.default_rng(seed)
    xyz = rng.standard_normal((B, N, 3)).astype(np.float32)
    feats = rng.standard_normal((B, N, C)).astype(np.float32)
    new_xyz = xyz[:, :S]
    idx = np.array(j_ball_query(radius, K, xyz, new_xyz))
    mod = JMLP(list(MLP_W))
    v = mod.init(jax.random.PRNGKey(1), jnp.zeros((B, S, K, 3 + C), jnp.float32), train=True)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.standard_normal(x.shape).astype(np.float32) * 0.3,
        v["params"])
    port = MLP(3 + C, list(MLP_W))
    port.load_state_dict(state_dict_from_jax({"params": params,
                                              "batch_stats": to_numpy(v["batch_stats"])}))
    g = rng.standard_normal((B, S, MLP_W[-1])).astype(np.float32)
    return xyz, feats, new_xyz, idx, params, port, g, radius


def _compare_with_jax(impl, normalize_xyz, seed=0, radius=0.8):
    xyz, feats, new_xyz, idx, params, port, g, radius = _setup(seed, radius)
    kw = dict(radius=radius, normalize_xyz=normalize_xyz, use_xyz=True)

    def loss(p, x, f, n):
        out, stats = j_fused_sa_train_apply(x, f, n, idx, p, impl=impl, interpret=True, **kw)
        return jnp.sum(out * g), (out, stats)

    (_, (want, want_stats)), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                                        has_aux=True)(params, xyz, feats, new_xyz)
    tx, tf, tn = (t(a).requires_grad_() for a in (xyz, feats, new_xyz))
    out, stats = sa_fused_train.fused_sa_train_apply(tx, tf, tn, torch.from_numpy(idx), port, **kw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **OUT_TOL)
    for i, (mean, var) in enumerate(stats):
        j_mean, j_var = want_stats[f"layer{i}"]
        np.testing.assert_allclose(mean.numpy(), np.asarray(j_mean), **STAT_TOL)
        np.testing.assert_allclose(var.numpy(), np.asarray(j_var), **STAT_TOL)
    (out * t(g)).sum().backward()
    for name, a, b in (("xyz", tx, grads[1]), ("features", tf, grads[2]),
                       ("new_xyz", tn, grads[3])):
        _grad_close(a.grad.numpy(), np.asarray(b), name)
    want_param_grads = state_dict_from_jax({"params": to_numpy(grads[0])})
    for name, p in port.named_parameters():
        _grad_close(p.grad.numpy(), want_param_grads[name].numpy(), name)
    # the Dense biases that feed a BatchNorm get exactly 0
    assert not port.layer1.dense.bias.grad.any() and not port.layer2.dense.bias.grad.any()
    return idx, out


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("normalize_xyz", [False, True])
def test_plain_matches_jax_kernel(impl, normalize_xyz):
    _compare_with_jax(impl, normalize_xyz)


def test_ties_split_like_jax():
    """Radius 0.3: most centroids have fewer than K points in the ball, so
    the pad-with-first indices repeat and the max over K has exact ties."""
    idx, _ = _compare_with_jax("ref", False, seed=3, radius=0.3)
    repeats = (np.sort(idx, axis=-1)[..., 1:] == np.sort(idx, axis=-1)[..., :-1]).any(-1)
    assert repeats.mean() > 0.5


def test_wrapper_checks_and_counts():
    """A CPU tensor runs the plain version and counts no launch; wrong
    shapes are refused; a 2-layer MLP is not K6's."""
    xyz, feats, new_xyz, idx, _, port, _, radius = _setup()
    sa_fused_train.reset_launch_counts()
    kw = dict(radius=radius, normalize_xyz=False, use_xyz=True)
    out, _ = sa_fused_train.fused_sa_train_apply(t(xyz), t(feats), t(new_xyz),
                                                 torch.from_numpy(idx), port, **kw)
    assert out.shape == (B, S, MLP_W[-1])
    assert (sa_fused_train.fused_sa_train_apply.fwd_launches,
            sa_fused_train.fused_sa_train_apply.bwd_launches) == (0, 0)
    with pytest.raises(ValueError):
        sa_fused_train.fused_sa_train_apply(t(xyz), t(feats), t(new_xyz),
                                            torch.from_numpy(idx[:, :3]), port, **kw)
    with pytest.raises(ValueError):
        sa_fused_train.fused_sa_train_apply(t(xyz), t(feats), t(new_xyz), torch.from_numpy(idx),
                                            MLP(3 + C, [16, 24]), **kw)


@pytest.mark.parametrize("fused_train", [True, False])
def test_set_abstraction_train_matches_flax(fused_train):
    """The port's SetAbstraction in training (K6's plain version, or the
    plain grid MLP with training BatchNorm) against flax
    SetAbstraction(train=True): output, running statistics and gradients."""
    rng = np.random.default_rng(5)
    xyz = rng.standard_normal((B, N, 3)).astype(np.float32)
    feats = rng.standard_normal((B, N, C)).astype(np.float32)
    g = rng.standard_normal((B, S, MLP_W[-1])).astype(np.float32)
    jsa = JSA(mlp=list(MLP_W), radius=0.8, nsample=K)
    v = randomize(jsa.init(jax.random.PRNGKey(0), xyz, feats, S, train=False), rng)

    def loss(params, x, f):
        (_, out, _), upd = jsa.apply({"params": params, "batch_stats": v["batch_stats"]}, x, f, S,
                                     train=True, mutable=["batch_stats"])
        return jnp.sum(out * g), (out, upd["batch_stats"])

    (_, (want, want_stats)), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        v["params"], xyz, feats)
    port = load_into(SetAbstraction(C, list(MLP_W), 0.8, K, fused_train=fused_train), v).train()
    tx, tf = t(xyz).requires_grad_(), t(feats).requires_grad_()
    _, out, _ = port(tx, tf, S)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **OUT_TOL)
    want_sd = state_dict_from_jax({"params": v["params"], "batch_stats": to_numpy(want_stats)})
    for name, buf in port.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), want_sd[name].numpy(), **STAT_TOL,
                                       err_msg=name)
    (out * t(g)).sum().backward()
    _grad_close(tx.grad.numpy(), np.asarray(grads[1]), "xyz")
    _grad_close(tf.grad.numpy(), np.asarray(grads[2]), "features")
    want_grads = state_dict_from_jax({"params": to_numpy(grads[0])})
    for name, p in port.named_parameters():
        _grad_close(p.grad.numpy(), want_grads[name].numpy(), name)


# --- the kernel's 3xTF32 arithmetic, emulated on the CPU ----------------------
# csrc/sa_fused_train.cu runs every grid product on the tensor cores in
# 3xTF32 (ops/chain_fused.py::split_tf32). The emulation below repeats its
# order of sums: a row product adds one 32-input chunk's products at a time;
# dW = h^T dy adds one 32-row step's products at a time within each row chunk
# of `_dw_split`, and the chunks' partial tiles in order. It is held to the
# plain version run in float64 within TOL_3XTF32, the bound chip_smoke.py
# holds the kernel to on the card; TF32 alone misses it.

from open3dsot_tpu_torch.ops.chain_fused import (CHUNK_IN, CHUNK_OUT, TOL_3XTF32, pack_chunks,
                                                 split_tf32)

DW_TILE, DW_ROWS, DW_WANT_BLOCKS = 128, 32, 264  # csrc/sa_fused_train.cu kDwT, kDwRows, kWantBlocks


def _cdiv(a, b):
    return -(-a // b)


def _dw_split(R, I, J):
    """(chunks, rows per chunk) of dW's row split, as csrc/sa_fused_train.cu::dw_split."""
    p = min(_cdiv(DW_WANT_BLOCKS, _cdiv(I, DW_TILE) * _cdiv(J, DW_TILE)), _cdiv(R, DW_ROWS))
    chunk = _cdiv(_cdiv(R, p), DW_ROWS) * DW_ROWS
    return _cdiv(R, chunk), chunk


def _products(a, w, three):
    """a (M, k) @ w (k, n) on TF32 inputs, f32 sums: a_lo w_hi + a_hi w_lo + a_hi w_hi."""
    ah, al = split_tf32(a)
    wh, wl = split_tf32(w)
    return (al @ wh + ah @ wl) + ah @ wh if three else ah @ wh


def _rowmm(a, w, three):
    acc = a.new_zeros(a.shape[0], w.shape[1])
    for k0 in range(0, a.shape[1], CHUNK_IN):
        acc = acc + _products(a[:, k0:k0 + CHUNK_IN], w[k0:k0 + CHUNK_IN], three)
    return acc


def _dw(x, d, three):
    R = x.shape[0]
    P, chunk = _dw_split(R, x.shape[1], d.shape[1])
    total = x.new_zeros(x.shape[1], d.shape[1])
    for p in range(P):
        acc = torch.zeros_like(total)
        for r in range(p * chunk, min(R, (p + 1) * chunk), DW_ROWS):
            acc = acc + _products(x[r:r + DW_ROWS].t(), d[r:r + DW_ROWS], three)
        total = total + acc
    return total


def _stats64(y):
    """Mean and biased variance from double sums, as the kernel's finalize."""
    y64 = y.double()
    mean = y64.mean(0)
    return mean.float(), (y64.square().mean(0) - mean * mean).float()


def _k6_emulated(a, ct, idx, w2, b2, w3, b3, bn, g, three=True):
    """K6 forward and backward with the kernel's products and double sums, f32
    elsewhere, in the row layout (R, C) of the kernel."""
    fold = sa_fused_train._fold
    Bb, Ss, Kk = idx.shape
    n_points, C1 = a.shape[1], a.shape[2]
    y1 = sa_fused_train._y1(a, ct, idx).reshape(-1, C1)
    R = y1.shape[0]
    stats, folds, ys = [], [], [y1]
    for i, (w, b) in enumerate(((w2, b2), (w3, b3), (None, None))):
        m, v = _stats64(ys[-1])
        stats += [m, v]
        folds.append(fold(m, v, bn[2 * i], bn[2 * i + 1]))
        if w is not None:
            ys.append(_rowmm(torch.relu(ys[-1] * folds[i][0] + folds[i][1]), w, three) + b)
    hs = [torch.relu(y * s + t) for y, (s, t, _) in zip(ys, folds)]
    yhs = [(y - stats[2 * i]) * folds[i][2] for i, y in enumerate(ys)]
    h3 = hs[2].reshape(Bb, Ss, Kk, -1)
    out = h3.amax(dim=2)

    def bn_bwd(dz, i):
        sdz = dz.double().sum(0).float()
        sdzy = (dz.double() * yhs[i].double()).sum(0).float()
        return folds[i][0] * (dz - sdz / R - yhs[i] * (sdzy / R)), sdzy, sdz

    mask = (h3 == out[:, :, None]).to(h3.dtype)
    dz3 = ((g[:, :, None, :] / mask.sum(dim=2, keepdim=True)) * mask * (h3 > 0)).reshape(R, -1)
    dy3, dg3, dbt3 = bn_bwd(dz3, 2)
    dw3 = _dw(hs[1], dy3, three)
    dy2, dg2, dbt2 = bn_bwd(_rowmm(dy3, w3.t(), three) * (hs[1] > 0), 1)
    dw2 = _dw(hs[0], dy2, three)
    dy1, dg1, dbt1 = bn_bwd(_rowmm(dy2, w2.t(), three) * (hs[0] > 0), 0)
    rows = (idx.long() + n_points * torch.arange(Bb)[:, None, None]).reshape(-1)
    da = torch.zeros(Bb * n_points, C1).index_add_(0, rows, dy1)
    grads = (da.reshape(Bb, n_points, C1), dy1.reshape(Bb, Ss, Kk, C1).sum(dim=2), dw2, dw3,
             torch.cat([dg1, dbt1, dg2, dbt2, dg3, dbt3]))
    return out, stats, grads


def _within(got, want, tol):
    """chip_smoke.py's form: |got - want| <= tol * max|want| + tol * |want|."""
    err = (got.double() - want).abs()
    return bool((err <= tol * want.abs().max() + tol * want.abs()).all()), err.max().item()


def test_3xtf32_emulation_of_k6_within_bound_of_float64():
    """The forward products, dh, and dW in the kernel's row-chunked partial
    order, at widths that take two input chunks (48) and rows that take
    several dW steps per chunk, against the plain version in float64."""
    rng = np.random.default_rng(21)
    Bb, n_points, Ss, Kk, (C1, C2, C3) = 4, 128, 64, 64, (16, 48, 40)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    a, ct = f(Bb, n_points, C1), f(Bb, Ss, C1)
    idx = torch.from_numpy(rng.integers(0, n_points, (Bb, Ss, Kk)).astype(np.int32))
    w2, b2, w3, b3 = f(C1, C2) * 0.3, f(C2), f(C2, C3) * 0.2, f(C3)
    bn = [1 + 0.2 * f(c) if i % 2 == 0 else 0.5 * f(c)
          for c in (C1, C2, C3) for i in range(2)]
    g = f(Bb, Ss, C3)
    assert _dw_split(Bb * Ss * Kk, C2, C3)[1] > DW_ROWS  # several steps per partial tile

    d = lambda t: t.double()  # noqa: E731
    out64, stats64, grids64 = sa_fused_train.sa_train_fwd_plain(
        d(a), d(ct), idx, d(w2), d(b2), d(w3), d(b3), [d(p) for p in bn])
    da, dct, dw2, dw3, dbn = sa_fused_train.sa_train_bwd_plain(
        d(g), d(a), d(ct), idx, grids64, stats64, d(w2), d(b2), d(w3), d(b3), [d(p) for p in bn])
    want = {"out": out64, "stats": torch.cat(stats64), "da": da, "dct": dct, "dW2": dw2,
            "dW3": dw3, "dgamma,dbeta": torch.cat(dbn)}

    def run(three):
        out, stats, (e_da, e_dct, e_dw2, e_dw3, e_dbn) = _k6_emulated(a, ct, idx, w2, b2, w3, b3,
                                                                      bn, g, three)
        got = {"out": out, "stats": torch.cat(stats), "da": e_da, "dct": e_dct, "dW2": e_dw2,
               "dW3": e_dw3, "dgamma,dbeta": e_dbn}
        return {k: _within(got[k], want[k], TOL_3XTF32) for k in want}

    three, one = run(True), run(False)
    for k, (ok, err) in three.items():
        assert ok, f"{k}: 3xTF32 emulation {err:.3e} from float64"
    missed = [k for k, (ok, _) in one.items() if not ok]
    assert missed, f"TF32 alone stayed within {TOL_3XTF32}: {one}"
    assert one["dW2"][1] > 10 * three["dW2"][1]


def _unpack(packed, k, c):
    """(hi, lo) of W^T (out, in), padded, from pack_chunks' layout."""
    nc, nk = _cdiv(_cdiv(c, 8) * 8, CHUNK_OUT), _cdiv(_cdiv(k, 8) * 8, CHUNK_IN)
    t = packed.reshape(nc, nk, 2, CHUNK_OUT // 8, CHUNK_IN // 4, 8, 4).permute(2, 0, 3, 5, 1, 4, 6)
    hi, lo = t.reshape(2, nc * CHUNK_OUT, nk * CHUNK_IN)
    return hi, lo


@pytest.mark.parametrize("which", ["W2", "W3", "W2^T", "W3^T"])
@pytest.mark.parametrize("width", [16, 24, 128, 256])
def test_packed_weights_unpack_to_the_weights(width, which):
    """K6's weights as the wrapper packs them (W2, W3 forward, W2^T, W3^T for
    dh): whole zero-padded chunks of the kernel's size rule, hi = tf32(W) and
    lo = tf32(W - hi) with their low 13 bits zero, hi + lo within 2^-22 of W."""
    rng = np.random.default_rng(width)
    c1, c2, c3 = width, width + 8, width
    w2 = torch.from_numpy(rng.standard_normal((c1, c2)).astype(np.float32))
    w3 = torch.from_numpy(rng.standard_normal((c2, c3)).astype(np.float32))
    w = {"W2": w2, "W3": w3, "W2^T": w2.t(), "W3^T": w3.t()}[which]
    k, c = w.shape
    packed = pack_chunks(w)
    # csrc/sa_fused_train.cu::packed_floats
    assert packed.numel() == _cdiv(_cdiv(c, 8) * 8, CHUNK_OUT) * _cdiv(_cdiv(k, 8) * 8, CHUNK_IN) \
        * 2 * CHUNK_OUT * CHUNK_IN
    hi, lo = _unpack(packed, k, c)
    for part in (hi, lo):
        assert not (part.numpy().view(np.uint32) & 0x1FFF).any()
        assert not part[c:].any() and not part[:, k:].any()
    wt = w.t().double()
    assert ((hi[:c, :k].double() + lo[:c, :k].double() - wt).abs() <= 2.0 ** -22 * wt.abs()).all()
    want_hi, want_lo = split_tf32(w.t().contiguous())
    assert torch.equal(hi[:c, :k], want_hi) and torch.equal(lo[:c, :k], want_lo)


@pytest.mark.parametrize("mangled, want", [
    ("_ZN50_GLOBAL__N__2da38c52_17_sa_fused_train_cu_369a5c5d12rowmm_kernelILi2ELi1EEEvNS_7RowArgsE",
     "rowmm_kernel<2,1>"),
    ("_ZN50_GLOBAL__N__2da38c52_17_sa_fused_train_cu_369a5c5d9dw_kernelILi0ELi3EEEvNS_6DwArgsE",
     "dw_kernel<0,3>"),
    ("_ZN50_GLOBAL__N__2da38c52_17_sa_fused_train_cu_369a5c5d19sum_partials_kernelEPKfPfix",
     "sum_partials_kernel"),
    ("_ZN50_GLOBAL__N__c3bba3_14_chain_fused_cu_4670a85215chain_tc_kernelILi64EEEvNS_9StageArgsE",
     "chain_tc_kernel<64>"),
    ("_ZN12_GLOBAL__N_116pool_bias_kernelEPKfS1_S1_Pfii", "pool_bias_kernel"),
])
def test_sass_kernel_names(mangled, want):
    """chip_smoke.py names each kernel of a library's SASS to check that
    K1/K2's and K6's products hold tensor-core instructions: the mangled
    names (nvcc's, from cuobjdump) carry a namespace tag whose digits can run
    into the length of the kernel's name."""
    import chip_smoke

    assert chip_smoke.kernel_name(mangled) == want
