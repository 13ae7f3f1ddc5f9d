"""K6's bf16 mode (ops/sa_fused_train.py) and SetAbstraction in bf16
training against the JAX package, at the sizes of
tests/test_sa_fused_train.py::_setup (B 2, N 64, S 16, K 8, C 12, MLP
16-16-24).

The reference of the plain bf16 version is JAX's `_core` with
`cdt='bfloat16'`, `impl='pallas'` in interpret mode and `i8g=True` (the
A-form rows gathered as bf16, as the compiled TPU kernel gathers them): the
bf16 rounding lives in the Pallas passes only (`impl='ref'` ignores the
dtype). Both sides round the same values at the same points; only the f32
sums run in another order, which can move a value across a bf16 rounding
boundary (one step, 2^-8 of it). Tolerances:
- y1's statistics (the bf16 rows plus ct in f32, no product): rtol 1e-4,
  atol 1e-5, as the f32 mode's tests;
- the output, the other statistics and every gradient (da, dct, dW2, dW3,
  dgamma, dbeta): `tests/_torch_port.py::assert_close_bf16`, 2^-8 of
  max|jax| at any element and 2^-15 on average. The control: the port's f32
  mode on the same inputs must fail that check (`assert_f32_fails_bf16`).
- the grids the plain bf16 forward keeps (h1, h2, bf16, as JAX's bf16
  kernel stores them) against JAX's `_pallas_fwd` grids: assert_close_bf16
  (h1 has no product: only the statistics' sum order can move a value one
  bf16 step; h2 takes y2's too), the unrounded activations outside;
- SetAbstraction(fused_train=True) in bf16 against flax's unfused bf16 SA:
  JAX's own bounds for its bf16 kernel against that path
  (tests/test_sa_fused_train.py::test_pallas_bf16_close_to_unfused_bf16):
  loss rtol 0.05, gradients rtol 0.15 and atol 0.08 * max(1, max|g|), the
  Dense biases that feed a BatchNorm left out (exactly 0 on the fused path,
  rounding noise on the unfused one). The port's unfused bf16 SA rounds as
  flax does and is held to it at the bf16 limits above, its gradients at
  2^-8 of max|jax| at any element and 2^-11 on average (GRAD_MAX_REL), with
  the f32 layers' gradients outside.
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
from open3dsot_tpu.ops import sa_fused_train as jft
from open3dsot_tpu_torch.models.layers import set_compute_dtype
from open3dsot_tpu_torch.models.pointnet import SetAbstraction
from open3dsot_tpu_torch.ops import sa_fused_train
from open3dsot_tpu_torch.weights import state_dict_from_jax
from tests._torch_port import (
    assert_close_bf16,
    assert_f32_fails_bf16,
    bf16_errors,
    load_into,
    randomize,
    t,
    to_numpy,
)

B, N, S, K, C = 2, 64, 16, 8, 12
MLP_W = (16, 16, 24)
BF = torch.bfloat16
# The unfused bf16 SA's gradients against flax's: the forwards agree to the
# bit, but the backward's bf16 products round at points autograd and XLA
# place differently (measured: at most 2^-8.6 of max|jax|, 2^-11.5 on
# average over a tensor); the f32 layers' gradients sit outside.
GRAD_MAX_REL, GRAD_MEAN_REL = 2.0 ** -8, 2.0 ** -11


def _core_inputs(seed, k=K, widths=MLP_W):
    """a, ct, idx, the layer weights and a bf16 cotangent, from the A-form of
    tests/test_sa_fused_train.py::_setup's MLP (at K = k neighbours and MLP
    widths `widths`)."""
    rng = np.random.default_rng(seed)
    xyz = rng.standard_normal((B, N, 3)).astype(np.float32)
    feats = rng.standard_normal((B, N, C)).astype(np.float32)
    new_xyz = xyz[:, :S]
    idx = np.asarray(j_ball_query(0.8 if seed % 2 == 0 else 0.3, k, xyz, new_xyz))
    v = JMLP(list(widths)).init(jax.random.PRNGKey(1), jnp.zeros((B, S, k, 3 + C)), train=True)
    p = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.standard_normal(x.shape).astype(np.float32) * 0.3,
        v["params"])
    layer = [p[f"layer{i}"] for i in range(3)]
    w1 = np.asarray(layer[0]["dense"]["kernel"])
    a = xyz @ w1[:3] + feats @ w1[3:]
    ct = np.asarray(layer[0]["dense"]["bias"]) - new_xyz @ w1[:3]
    w = [np.asarray(layer[i]["dense"][k], np.float32) for i in (1, 2) for k in ("kernel", "bias")]
    bn = [np.asarray(layer[i]["bn"][k], np.float32) for i in range(3) for k in ("scale", "bias")]
    g = rng.standard_normal((B, S, widths[-1])).astype(np.float32)
    g = np.asarray(jnp.asarray(g, jnp.bfloat16).astype(jnp.float32))  # a bf16 output's cotangent
    return a.astype(np.float32), ct.astype(np.float32), idx, w, bn, g


def _jax_core(a, ct, idx, w, bn, g):
    """JAX's bf16 Pallas K6 (interpret mode, bf16 row gather): out, stats and
    the VJP in (a, ct, w2, w3, g1, bt1, g2, bt2, g3, bt3)."""
    cfg = jft._SACfg(B=B, N=N, S=S, K=idx.shape[2], C1=w[0].shape[0], C2=w[0].shape[1],
                     C3=w[2].shape[1], cdt="bfloat16", interpret=True, impl="pallas", i8g=True)

    def f(a, ct, w2, w3, *bn_):
        return jft._core(cfg, a, ct, w2, w[1], w3, w[3], *bn_, idx)

    (out, stats), vjp = jax.vjp(f, a, ct, w[0], w[2], *bn)
    grads = vjp((jnp.asarray(g), tuple(jnp.zeros_like(s) for s in stats)))
    return np.asarray(out), [np.asarray(s) for s in stats], [np.asarray(x) for x in grads]


def _port(a, ct, idx, w, bn, g, bf16):
    """The port's plain K6 in the mode `bf16`, a rounded to bf16 as the
    wrapper rounds it: out, stats and (da, dct, dw2, dw3, dbn...)."""
    ta = t(a).to(BF).float() if bf16 else t(a)
    ti = torch.from_numpy(idx.astype(np.int32))
    tw = [t(x) for x in w]
    tbn = [t(x) for x in bn]
    out, stats, grids = sa_fused_train.sa_train_fwd_plain(ta, t(ct), ti, tw[0], tw[1], tw[2],
                                                          tw[3], tbn, bf16)
    da, dct, dw2, dw3, dbn = sa_fused_train.sa_train_bwd_plain(t(g), ta, t(ct), ti, grids, stats,
                                                               *tw, tbn, bf16)
    return out, list(stats), [da, dct, dw2, dw3, *dbn]


GRAD_NAMES = ("da", "dct", "dW2", "dW3", "dg1", "dbt1", "dg2", "dbt2", "dg3", "dbt3")


def _check_plain_bf16_against_jax(args):
    want_out, want_stats, want_grads = _jax_core(*args)
    out, stats, grads = _port(*args, bf16=True)
    out32, stats32, grads32 = _port(*args, bf16=False)
    assert_close_bf16(out, want_out)
    assert_f32_fails_bf16(out32, want_out)
    np.testing.assert_allclose(stats[0].numpy(), want_stats[0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(stats[1].numpy(), want_stats[1], rtol=1e-4, atol=1e-5)
    for got, want in zip(stats[2:], want_stats[2:]):
        assert_close_bf16(got, want)
    # JAX's VJP order: a, ct, w2, w3, g1, bt1, g2, bt2, g3, bt3
    for name, got, f32, want in zip(GRAD_NAMES, grads, grads32, want_grads):
        assert_close_bf16(got, want), name
    # the control on the products' gradients: an f32 backward is outside
    for i in (0, 2, 3):
        assert_f32_fails_bf16(grads32[i], want_grads[i])


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_bf16_matches_jax_pallas_bf16(seed):
    """Seed 1 takes radius 0.3: most balls hold fewer than K points, so the
    pad-with-first indices repeat and the max over K has exact ties."""
    _check_plain_bf16_against_jax(_core_inputs(seed))


@pytest.mark.parametrize("k", [6, 12])
def test_plain_bf16_matches_jax_pallas_bf16_at_other_k_and_widths(k):
    """The same at a K that is not a power of two (the kernel's max then
    comes from scan_kernel, not from within a 64-row tile) and at widths
    that are multiples of 4 but not of 8 (the kernel pads the grids' rows);
    radius 0.3 (seed 1), so the max has exact ties."""
    _check_plain_bf16_against_jax(_core_inputs(1, k=k, widths=(12, 20, 28)))


def test_plain_bf16_backward_takes_the_kernels_y3():
    """`sa_train_bwd_plain(y3=)` routes the max gradient by the y3 it is
    given: the y3 of h2 W3 + b3 gives the backward without it bit for bit;
    a y3 whose maxima moved routes dz3 to the new maxima."""
    a, ct, idx, w, bn, g = _core_inputs(1)
    ta, ti = t(a).to(BF).float(), torch.from_numpy(idx.astype(np.int32))
    tw, tbn = [t(x) for x in w], [t(x) for x in bn]
    _, stats, grids = sa_fused_train.sa_train_fwd_plain(ta, t(ct), ti, *tw, tbn, True)
    want = sa_fused_train.sa_train_bwd_plain(t(g), ta, t(ct), ti, grids, stats, *tw, tbn, True)
    y3 = grids[1].float() @ tw[2].to(BF).float() + tw[3]
    got = sa_fused_train.sa_train_bwd_plain(t(g), ta, t(ct), ti, grids, stats, *tw, tbn, True,
                                            y3=y3)
    for x, y in zip(got[:4] + tuple(got[4]), want[:4] + tuple(want[4])):
        assert torch.equal(x, y)
    moved = y3.clone()
    moved[:, :, 0] += 100.0 * y3.abs().max()  # neighbour 0 is every centroid's only maximum
    got = sa_fused_train.sa_train_bwd_plain(t(g), ta, t(ct), ti, grids, stats, *tw, tbn, True,
                                            y3=moved)
    assert not torch.equal(got[3], want[3])


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_bf16_grids_match_jax_pallas_grids(seed):
    """The grids the plain bf16 forward keeps for its backward, h1 and h2 in
    bf16, against the h1, h2 that JAX's bf16 Pallas forward stores; the
    activations before their rounding to bf16 are the control."""
    a, ct, idx, w, bn, _ = _core_inputs(seed)
    cfg = jft._SACfg(B=B, N=N, S=S, K=K, C1=MLP_W[0], C2=MLP_W[1], C3=MLP_W[2],
                     cdt="bfloat16", interpret=True, impl="pallas", i8g=True)
    _, _, (_, j_h1, j_h2) = jft._pallas_fwd(cfg, a, ct, w[0], w[1], w[2], w[3], *bn,
                                            jnp.asarray(idx, jnp.int32))
    want = [np.asarray(h.astype(jnp.float32)).reshape(B, S, K, -1) for h in (j_h1, j_h2)]
    ta, ti = t(a).to(BF).float(), torch.from_numpy(idx.astype(np.int32))
    tw, tbn = [t(x) for x in w], [t(x) for x in bn]
    _, stats, grids = sa_fused_train.sa_train_fwd_plain(ta, t(ct), ti, *tw, tbn, True)
    assert all(h.dtype == BF for h in grids)
    s1, t1, _ = sa_fused_train._fold(stats[0], stats[1], tbn[0], tbn[1])
    s2, t2, _ = sa_fused_train._fold(stats[2], stats[3], tbn[2], tbn[3])
    h1_f32 = sa_fused_train._relu_fold(sa_fused_train._y1(ta, t(ct), ti), s1, t1)
    h2_f32 = sa_fused_train._relu_fold(grids[0].float() @ tw[0].to(BF).float() + tw[1], s2, t2)
    for got, f32, jax_grid in zip(grids, (h1_f32, h2_f32), want):
        assert_close_bf16(got.float(), jax_grid)
        assert_f32_fails_bf16(f32, jax_grid)


@pytest.mark.parametrize("widths", [(16, 16, 24), (12, 20, 28)])
def test_bf16_packs_are_the_kernels_operands(widths):
    """The bf16 mode's packs: each product's B operand K-major in bf16 (the
    forward's W2, W3 as the rows of W2^T, W3^T; the backward's W2^T, W3^T as
    the rows of W2, W3), rows zero-padded to a multiple of 8 inputs;
    `Packs.check` refuses another form."""
    c1, c2, c3 = widths
    rng = np.random.default_rng(c1)
    w2, w3 = t(rng.standard_normal((c1, c2))), t(rng.standard_normal((c2, c3)))
    packs = sa_fused_train.Packs(w2, w3, True)
    for got, want in ((packs.w2, w2.t()), (packs.w3, w3.t()), (packs.w2t, w2), (packs.w3t, w3)):
        n, k = want.shape
        assert got.dtype == BF and tuple(got.shape) == (n, -(-k // 8) * 8)
        assert torch.equal(got[:, :k], want.to(BF)) and not got[:, k:].any()
    packs.check(("W2", packs.w2, c1, c2), ("W3^T", packs.w3t, c3, c2))
    with pytest.raises(RuntimeError, match="bf16"):
        packs.check(("W2", packs.w2.float(), c1, c2))
    with pytest.raises(RuntimeError, match="bf16"):
        packs.check(("W3", packs.w2, c2, c3))


def _bf16_call(c1=12):
    """A bf16 K6 call at widths (c1, 16, 24) and its plain forward, CPU tensors."""
    rng = np.random.default_rng(7)
    f = lambda *sh: t(rng.standard_normal(sh))  # noqa: E731
    a, ct = f(B, N, c1), f(B, S, c1)
    idx = torch.from_numpy(rng.integers(0, N, (B, S, K)).astype(np.int32))
    w2, b2, w3, b3 = f(c1, 16), f(16), f(16, 24), f(24)
    bn = [f(c) for c in (c1, 16, 24) for _ in range(2)]
    out, stats, grids = sa_fused_train.sa_train_fwd_plain(a.to(BF).float(), ct, idx, w2, b2, w3,
                                                          b3, bn, True)
    return a, ct, idx, (w2, b2, w3, b3, bn), stats, grids, out


@pytest.mark.parametrize("case", ["plain grids", "unpadded h1", "mxt shape", "f32 packs",
                                  "four grids", "y3_out shape", "y3_out in f32"])
def test_bf16_kernel_wrappers_refuse_before_launching(case):
    """The bf16 kernels' wrappers check the grids their forward keeps (h1, h2
    padded to a multiple of 8 channels, mxt (3, B, S, C3): three, no y3
    among them), the packs' mode and the forward's y3_out ((B, S, K, C3)
    f32, the bf16 mode's only) before they reach the library, and count no
    launch then."""
    a, ct, idx, (w2, b2, w3, b3, bn), stats, grids, out = _bf16_call()
    h1, h2 = grids
    pad = lambda h: torch.nn.functional.pad(h, (0, (-h.shape[-1]) % 8))  # noqa: E731
    mxt = torch.stack([out, out, out])
    y3 = torch.zeros(B, S, K, 24)
    kernel_grids = {"plain grids": grids, "unpadded h1": (h1, pad(h2), mxt),
                    "mxt shape": (pad(h1), pad(h2), mxt[:2]),
                    "four grids": (pad(h1), pad(h2), mxt, y3)}.get(case)
    packs = sa_fused_train.Packs(w2, w3, case not in ("f32 packs", "y3_out in f32"))
    g = torch.ones_like(out)
    sa_fused_train.reset_launch_counts()
    with pytest.raises((ValueError, TypeError, RuntimeError)) as err:
        if case == "f32 packs":
            packs.bf16 = True  # a 3xTF32 pack taken as the bf16 mode's
            sa_fused_train.sa_train_fwd_kernel(a, ct, idx, w2, b2, w3, b3, bn, packs)
        elif case.startswith("y3_out"):
            sa_fused_train.sa_train_fwd_kernel(a, ct, idx, w2, b2, w3, b3, bn, packs,
                                               y3_out=y3[..., :-4] if "shape" in case else y3)
        else:
            sa_fused_train.sa_train_bwd_kernel(g, a, ct, idx, kernel_grids, stats, w2, b2, w3, b3,
                                               bn, packs)
    assert "nvcc" not in str(err.value)
    counts = sa_fused_train.fused_sa_train_apply
    assert (counts.fwd_launches, counts.bwd_launches, counts.bf16_fwd_launches,
            counts.bf16_bwd_launches) == (0, 0, 0, 0)


def test_fused_sa_train_apply_bf16_takes_the_layers_mode():
    """The wrapper's mode is the MLP's: a bf16 MLP gives a bf16 output equal
    to the plain bf16 version's on bf16(a), f32 features or bf16 ones alike;
    an f32 MLP an f32 output. Parameters stay f32, and so do their gradients."""
    rng = np.random.default_rng(3)
    xyz, feats = (t(rng.standard_normal((B, N, c))) for c in (3, C))
    new_xyz = xyz[:, :S].contiguous()
    idx = torch.from_numpy(np.asarray(j_ball_query(0.8, K, xyz.numpy(), new_xyz.numpy())))
    sa = SetAbstraction(C, list(MLP_W), 0.8, K, fused_train=True, dtype=BF).train()
    mlp = sa.mlp_shared
    kw = dict(radius=0.8, normalize_xyz=False, use_xyz=True)
    out, _ = sa_fused_train.fused_sa_train_apply(xyz, feats, new_xyz, idx, mlp, **kw)
    out_b, _ = sa_fused_train.fused_sa_train_apply(xyz, feats.to(BF), new_xyz, idx, mlp, **kw)
    assert out.dtype == BF and out_b.dtype == BF
    layers = list(mlp.children())
    a, ct = sa_fused_train.a_form(xyz, feats, new_xyz, layers[0].dense.weight.t(),
                                  layers[0].dense.bias, inv_r=1.0, use_xyz=True)
    bn = [p for layer in layers for p in (layer.bn.weight, layer.bn.bias)]
    want, _, _ = sa_fused_train.sa_train_fwd_plain(
        a.to(BF).float(), ct, idx.int(), layers[1].dense.weight.t(), layers[1].dense.bias,
        layers[2].dense.weight.t(), layers[2].dense.bias, bn, True)
    assert torch.equal(out.float(), want.to(BF).float())
    out.float().sum().backward()
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in mlp.parameters())
    sa32 = SetAbstraction(C, list(MLP_W), 0.8, K, fused_train=True).train()
    out32, _ = sa_fused_train.fused_sa_train_apply(xyz, feats, new_xyz, idx, sa32.mlp_shared, **kw)
    assert out32.dtype == torch.float32


@pytest.mark.parametrize("fused_train", [True, False])
def test_set_abstraction_bf16_train_against_flax_bf16(fused_train):
    """The port's SetAbstraction in bf16 training (K6's plain bf16 version, or
    the flax-order bf16 grid MLP) against flax's unfused bf16 SetAbstraction
    (train=True): loss, gradients and running statistics."""
    rng = np.random.default_rng(5)
    xyz = rng.standard_normal((B, N, 3)).astype(np.float32)
    feats = rng.standard_normal((B, N, C)).astype(np.float32)
    g = rng.standard_normal((B, S, MLP_W[-1])).astype(np.float32)
    jsa = JSA(mlp=list(MLP_W), radius=0.8, nsample=K, dtype=jnp.bfloat16)
    v = randomize(jsa.init(jax.random.PRNGKey(0), xyz, feats, S, train=False), rng)

    def loss(params, x, f):
        (_, out, _), upd = jsa.apply({"params": params, "batch_stats": v["batch_stats"]}, x, f, S,
                                     train=True, mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32) * g), upd["batch_stats"]

    (want_loss, want_stats), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        v["params"], xyz, feats)
    port = load_into(SetAbstraction(C, list(MLP_W), 0.8, K, fused_train=fused_train, dtype=BF),
                     v).train()
    tx, tf = t(xyz).requires_grad_(), t(feats).requires_grad_()
    _, out, _ = port(tx, tf, S)
    assert out.dtype == BF
    got_loss = (out.float() * t(g)).sum()
    got_loss.backward()
    want_grads = state_dict_from_jax({"params": to_numpy(grads[0])})
    want_sd = state_dict_from_jax({"params": v["params"], "batch_stats": to_numpy(want_stats)})
    if fused_train:
        np.testing.assert_allclose(float(got_loss.detach()), float(want_loss), rtol=0.05)
        for name, p in port.named_parameters():
            if "dense.bias" in name:  # analytically 0: JAX's test leaves them out
                if "layer0" not in name:
                    assert not p.grad.any(), name  # exactly 0 on the fused path
                continue
            w = want_grads[name].numpy()
            scale = max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(p.grad.numpy(), w, rtol=0.15, atol=0.08 * scale,
                                       err_msg=name)
        for name, buf in port.named_buffers():
            if "running" in name:
                np.testing.assert_allclose(buf.numpy(), want_sd[name].numpy(), rtol=0.05,
                                           atol=0.05, err_msg=name)
        return
    assert_close_bf16(out.detach(), np.asarray(jsa.apply(
        {"params": v["params"], "batch_stats": v["batch_stats"]}, xyz, feats, S, train=True,
        mutable=["batch_stats"])[0][1].astype(jnp.float32)))
    for name, buf in port.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), want_sd[name].numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=name)
    grads16 = {k: p.grad for k, p in port.named_parameters()}
    port32 = load_into(SetAbstraction(C, list(MLP_W), 0.8, K), v).train()
    _, out32, _ = port32(t(xyz), t(feats), S)
    (out32 * t(g)).sum().backward()
    for name, p in port32.named_parameters():
        if "dense.bias" in name:  # analytically 0: rounding noise on both sides
            continue
        assert grads16[name].dtype == torch.float32
        worst, mean = bf16_errors(grads16[name], want_grads[name].numpy())
        assert worst <= GRAD_MAX_REL and mean <= GRAD_MEAN_REL, (name, worst, mean)
        worst, mean = bf16_errors(p.grad, want_grads[name].numpy())  # the control
        assert worst > GRAD_MAX_REL or mean > GRAD_MEAN_REL, (name, worst, mean)


def test_packs_are_cached_per_weights_and_mode():
    """K6's packed weights are held in the SA layer's fold cache: the same
    weights and mode reuse them, as does a write of the running statistics
    (every training forward makes one); a step of the optimizer (an in-place
    update) or the other mode packs again."""
    sa = SetAbstraction(C, list(MLP_W), 0.8, K, fused_train=True)
    mlp = sa.mlp_shared
    first = sa.train_packs()
    assert sa.train_packs() is first and not first.bf16
    mlp.update_batch_stats([(torch.zeros(c), torch.ones(c)) for c in MLP_W])
    assert sa.train_packs() is first
    set_compute_dtype(sa, torch.bfloat16)
    bf = sa.train_packs()
    # the bf16 kernels' form: W2^T's rows in bf16, as their products read the weight
    assert bf is not first and bf.bf16 and bf.w2.dtype == BF
    assert torch.equal(bf.w2, mlp.layer1.dense.weight.detach().to(BF))
    with torch.no_grad():
        mlp.layer1.dense.weight.add_(1.0)
    assert sa.train_packs() is not bf
