"""The shapes every hand kernel takes beyond the shipped configs, as their
Pallas counterparts take them: K6 at any width (30-50-70, 512-512-512), K4/K5
at nsample 128, K1/K2 with a tap of 60 and a first seg-head width of 36, K3
past 32768 points.

On the CPU each wrapper runs its plain version, held here to the JAX
function (interpret mode, or its `impl="ref"`) at the tolerances of
tests/test_torch_sa_fused_train.py (K6), tests/test_torch_sa_fused.py (K4)
and tests/test_torch_chain_fused.py (K1/K2); K3's indices are exact. The
CUDA paths that take these shapes run only on the card (chip_smoke.py
phase 26 holds each to its plain version there). What the CPU can check of
them:
  - widths that are not a multiple of 4 (K4-K6) or 8 (K1's tap, K2's first
    width) run at the padded widths: the packs of the padded weights are
    those of the unpadded ones, and each plain version at the padded widths,
    sliced, equals itself at the real widths (bit for bit, or within 1e-6 of
    the largest value where the matmul sums in another order);
  - the wrappers hand the entries the padded widths, take K > 64 and
    widths whose tiles do not fit to the rows path, and clouds past 32768
    points to K3's cluster entry (a stand-in library, as
    tests/test_torch_bf16_kernels.py's).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_kernel_domain.py -q -n 3 -p xdist
"""

from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from open3dsot_tpu.models.layers import MLP as JMLP
from open3dsot_tpu.models.pointnet import SegPointNet as JSeg
from open3dsot_tpu.models.pointnet import SetAbstraction as JSA
from open3dsot_tpu.ops import ball_query as j_ball_query
from open3dsot_tpu.ops.chain_fused import fused_pointnet_encoder as j_encoder
from open3dsot_tpu.ops.chain_fused import fused_seg_head as j_head
from open3dsot_tpu.ops.sa_fused import fused_sa_apply as j_fused_sa_apply
from open3dsot_tpu.ops.sa_fused_train import fused_sa_train_apply as j_fused_sa_train_apply
from open3dsot_tpu.ops.reference import fps_ref as j_fps_ref
from open3dsot_tpu.ops.sampling import furthest_point_sample as j_fps
from open3dsot_tpu_torch.models.layers import MLP
from open3dsot_tpu_torch.models.pointnet import SegPointNet, SetAbstraction
from open3dsot_tpu_torch.ops import _build
from open3dsot_tpu_torch.ops import chain_fused as cf
from open3dsot_tpu_torch.ops import sa_fused as saf
from open3dsot_tpu_torch.ops import sa_fused_train as k6
from open3dsot_tpu_torch.ops import sampling
from open3dsot_tpu_torch.weights import state_dict_from_jax
from tests._torch_port import (assert_close_bf16, assert_f32_fails_bf16, load_into, randomize,
                               t, to_numpy)
from tests.test_torch_bf16_kernels import _Lib

BF = torch.bfloat16
# tests/test_torch_sa_fused_train.py's tolerances (K6)
OUT_TOL = dict(rtol=2e-4, atol=2e-5)
STAT_TOL = dict(rtol=1e-4, atol=1e-5)
K4_ATOL = 1e-4    # tests/test_torch_sa_fused.py's
CHAIN_ATOL = 2e-5  # tests/test_torch_chain_fused.py's
PAD_REL = 1e-6    # a plain version at padded widths against itself at the real ones


def _grad_close(got, want, name):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-5 * scale, err_msg=name)


def _same(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    """Equal within PAD_REL of max|want| (bit for bit where the sums keep their order)."""
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got.float() - want.float()).abs().max())
    assert err <= PAD_REL * scale, (what, err, scale)


# --- K6 at any width ----------------------------------------------------------------

def _k6_setup(widths, b, n, s, k, c, seed):
    rng = np.random.default_rng(seed)
    xyz = rng.standard_normal((b, n, 3)).astype(np.float32)
    feats = rng.standard_normal((b, n, c)).astype(np.float32)
    new_xyz = xyz[:, :s]
    idx = np.array(j_ball_query(0.8, k, xyz, new_xyz))
    mod = JMLP(list(widths))
    v = mod.init(jax.random.PRNGKey(1), jnp.zeros((b, s, k, 3 + c), jnp.float32), train=True)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.standard_normal(x.shape).astype(np.float32) * 0.3,
        v["params"])
    port = MLP(3 + c, list(widths))
    port.load_state_dict(state_dict_from_jax({"params": params,
                                              "batch_stats": to_numpy(v["batch_stats"])}))
    g = rng.standard_normal((b, s, widths[-1])).astype(np.float32)
    return xyz, feats, new_xyz, idx, params, port, g


@pytest.mark.parametrize("widths,impl,size", [
    ((30, 50, 70), "pallas", (1, 48, 8, 8, 12)),
    ((512, 512, 512), "ref", (1, 32, 4, 4, 12)),
])
def test_k6_plain_matches_jax_at_new_widths(widths, impl, size):
    """K6's plain forward and VJP (the path the wrapper takes on the CPU)
    against JAX's fused_sa_train_apply, at widths that are not multiples of
    4 and at 512, which the f32 kernel refused before its vectors could live
    in device memory."""
    b, n, s, k, c = size
    xyz, feats, new_xyz, idx, params, port, g = _k6_setup(widths, b, n, s, k, c, seed=sum(widths))
    kw = dict(radius=0.8, normalize_xyz=True, use_xyz=True)

    def loss(p, x, f, nx):
        out, stats = j_fused_sa_train_apply(x, f, nx, idx, p, impl=impl, interpret=True, **kw)
        return jnp.sum(out * g), (out, stats)

    (_, (want, want_stats)), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                                        has_aux=True)(params, xyz, feats, new_xyz)
    tx, tf, tn = (t(a).requires_grad_() for a in (xyz, feats, new_xyz))
    out, stats = k6.fused_sa_train_apply(tx, tf, tn, torch.from_numpy(idx), port, **kw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **OUT_TOL)
    for i, (mean, var) in enumerate(stats):
        j_mean, j_var = want_stats[f"layer{i}"]
        np.testing.assert_allclose(mean.numpy(), np.asarray(j_mean), **STAT_TOL)
        np.testing.assert_allclose(var.numpy(), np.asarray(j_var), **STAT_TOL)
    (out * t(g)).sum().backward()
    for name, a, want_g in (("xyz", tx, grads[1]), ("features", tf, grads[2]),
                            ("new_xyz", tn, grads[3])):
        _grad_close(a.grad.numpy(), np.asarray(want_g), name)
    want_param_grads = state_dict_from_jax({"params": to_numpy(grads[0])})
    for name, p in port.named_parameters():
        _grad_close(p.grad.numpy(), want_param_grads[name].numpy(), name)


def test_set_abstraction_train_at_width_512_matches_flax():
    """A BAT SetAbstraction in training at width 512 (the model-level case):
    the port's layer (K6's plain version on the CPU) against flax's, output,
    running statistics and gradients."""
    rng = np.random.default_rng(5)
    b, n, s, k, c, mlp = 1, 32, 4, 4, 12, [512, 512, 512]
    xyz = rng.standard_normal((b, n, 3)).astype(np.float32)
    feats = rng.standard_normal((b, n, c)).astype(np.float32)
    g = rng.standard_normal((b, s, mlp[-1])).astype(np.float32)
    jsa = JSA(mlp=mlp, radius=0.8, nsample=k)
    v = randomize(jsa.init(jax.random.PRNGKey(0), xyz, feats, s, train=False), rng)

    def loss(params, x, f):
        (_, out, _), upd = jsa.apply({"params": params, "batch_stats": v["batch_stats"]}, x, f, s,
                                     train=True, mutable=["batch_stats"])
        return jnp.sum(out * g), (out, upd["batch_stats"])

    (_, (want, want_stats)), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        v["params"], xyz, feats)
    port = load_into(SetAbstraction(c, mlp, 0.8, k, fused_train=True), v).train()
    tx, tf = t(xyz).requires_grad_(), t(feats).requires_grad_()
    _, out, _ = port(tx, tf, s)
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


# --- K4/K5 at nsample 128 --------------------------------------------------------------

def _sa_setup(seed, mlp, k, b=1, n=144, c=12):
    rng = np.random.default_rng(seed)
    xyz = rng.standard_normal((b, n, 3)).astype(np.float32)
    feats = rng.standard_normal((b, n, c)).astype(np.float32)
    jsa = JSA(mlp=mlp, radius=1.5, nsample=k, use_fps=False, normalize_xyz=True)
    v = randomize(jsa.init(jax.random.PRNGKey(0), xyz, feats, 8, train=False), rng)
    port = load_into(SetAbstraction(c, mlp, 1.5, k, use_fps=False, normalize_xyz=True), v)
    return xyz, feats, jsa, v, port


@pytest.mark.parametrize("bf16", [False, True])
def test_k4_plain_matches_jax_at_nsample_128(bf16):
    """K4 (ball query in the kernel) at nsample 128, past one 64-row tile:
    the plain version against JAX's fused kernel in interpret mode; the
    bf16 mode at tests/_torch_port.py's bf16 limits with the f32 control."""
    xyz, feats, _, v, port = _sa_setup(11, [16, 20, 24], 128)
    new_xyz = xyz[:, :8]
    kw = dict(radius=1.5, normalize_xyz=True, use_xyz=True)
    mlp = (v["params"]["mlp_shared"], v["batch_stats"]["mlp_shared"])
    dtype = jnp.bfloat16 if bf16 else None
    want = j_fused_sa_apply(xyz, feats, new_xyz, None, *mlp, nsample=128, interpret=True,
                            dtype=dtype, int8_gather=bf16 or None, **kw)
    folded = saf.FoldedSA(port.folded_chains(), dtype=BF if bf16 else None)
    got = saf.fused_sa_apply(t(xyz), t(feats), t(new_xyz), None, folded, nsample=128, **kw)
    assert got.shape == (1, 8, 24)
    if bf16:
        assert_close_bf16(got, np.asarray(want, np.float32))
        f32 = saf.fused_sa_apply(t(xyz), t(feats), t(new_xyz), None, port.folded_chains(),
                                 nsample=128, **kw)
        assert_f32_fails_bf16(f32, np.asarray(want, np.float32))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=K4_ATOL)


def test_set_abstraction_eval_at_nsample_128_matches_flax():
    """A SetAbstraction in eval at nsample 128 through the port's layer (the
    fused path's plain version on the CPU) against the flax layer."""
    xyz, feats, jsa, v, port = _sa_setup(12, [32, 32, 64], 128)
    want_xyz, want, _ = jsa.apply(v, xyz, feats, 8, train=False)
    with torch.no_grad():
        got_xyz, got, _ = port(t(xyz), t(feats), 8)
    np.testing.assert_allclose(got_xyz.numpy(), np.asarray(want_xyz), atol=K4_ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=K4_ATOL)


# --- K1/K2 with a tap of 60 --------------------------------------------------------------

MLP1, MLP2 = [16, 60, 32, 64], [36, 16]  # the tap (mlp1 layer 1) 60 wide, K2's first width 36


def _seg(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, n, 14)).astype(np.float32)
    jm = JSeg(per_point_mlp1=MLP1, per_point_mlp2=MLP2, output_size=11)
    v = randomize(jm.init(jax.random.PRNGKey(0), x, train=False), rng)
    return x, jm, v, load_into(SegPointNet(14, MLP1, MLP2, 11), v)


def test_k1_k2_plain_match_jax_at_a_tap_of_60():
    x, jm, v, port = _seg(50, seed=20)
    p, st = v["params"], v["batch_stats"]
    want_tap, want_pool = j_encoder(x, [p[f"mlp1_{i}"]["layer0"] for i in range(4)],
                                    [st[f"mlp1_{i}"]["layer0"] for i in range(4)], tap_at=1)
    chain1, chain2 = port.folded_chains()
    tap, pooled = cf.fused_pointnet_encoder(t(x), chain1, tap_at=1)
    assert tap.shape == (2, 50, 60)
    np.testing.assert_allclose(tap.numpy(), np.asarray(want_tap), atol=CHAIN_ATOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pool), atol=CHAIN_ATOL)
    want = j_head(np.asarray(want_tap), np.asarray(want_pool),
                  [p[f"mlp2_{i}"]["layer0"] for i in range(2)],
                  [st[f"mlp2_{i}"]["layer0"] for i in range(2)], p["fc"])
    got = cf.fused_seg_head(tap, pooled, chain2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=CHAIN_ATOL)
    with torch.no_grad():
        np.testing.assert_allclose(port(t(x)).numpy(), np.asarray(jm.apply(v, x, train=False)),
                                   atol=CHAIN_ATOL)


# --- K3 past 32768 points ----------------------------------------------------------------

def test_k3_plain_matches_jax_past_32768_points():
    """A cloud of 40000 points (one block's registers hold 32768; the card
    runs it over a cluster of blocks): the plain version's indices equal
    those of the JAX package's plain reference (`fps_ref`, which its Pallas
    kernel is held to; that kernel runs on a TPU only) and of its XLA loop."""
    rng = np.random.default_rng(30)
    xyz = rng.standard_normal((2, 40000, 3)).astype(np.float32)
    got = sampling.furthest_point_sample(t(xyz), 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_fps_ref(xyz, 12)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_fps(xyz, 12)))


@pytest.mark.parametrize("n,ppt", [(32769, 8), (65536, 8), (65537, 16), (131072, 16),
                                   (262144, 32)])
def test_k3_cluster_points_a_thread(n, ppt):
    assert sampling.fps_cluster_ppt(n) == ppt
    assert sampling.CLUSTER_BLOCKS * sampling.CLUSTER_THREADS * ppt >= n


@pytest.mark.parametrize("n", [32768, 262145])
def test_k3_cluster_form_refuses_what_it_does_not_hold(n):
    with pytest.raises(ValueError):
        sampling.fps_cluster_ppt(n)


# --- zero padding: the packs and the plain versions at padded widths -------------------

def _weights(k, c, rng):
    return torch.from_numpy((rng.standard_normal((k, c)) * k ** -0.5).astype(np.float32))


@pytest.mark.parametrize("k,c", [(30, 50), (50, 70), (13, 61), (62, 127), (510, 66)])
def test_zero_padded_packs_equal_the_unpadded(k, c):
    """pack_chunks and pack_panels_bf16 of a weight zero-padded to the next
    multiple of 4 in both dims are the packs of the weight itself, bit for
    bit: the kernels read the padded widths from the same buffers."""
    rng = np.random.default_rng(k * c)
    w = _weights(k, c, rng)
    wp = F.pad(w, (0, -(-c // 4) * 4 - c, 0, -(-k // 4) * 4 - k))
    assert torch.equal(cf.pack_chunks(w), cf.pack_chunks(wp))
    assert torch.equal(cf.pack_panels_bf16(w), cf.pack_panels_bf16(wp))
    assert torch.equal(cf.pack_layer(w, w[0], BF), cf.pack_layer(wp, F.pad(w[0], (0, wp.shape[1] - c)), BF))


def _k6_inputs(widths, rng, b=2, n=40, s=6, k=5):
    C1, C2, C3 = widths

    def f(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    idx = torch.from_numpy(rng.integers(0, n, (b, s, k)).astype(np.int32))
    bn = [1 + f(C1, scale=0.1), f(C1, scale=0.1), 1 + f(C2, scale=0.1), f(C2, scale=0.1),
          1 + f(C3, scale=0.1), f(C3, scale=0.1)]
    return (f(b, n, C1), f(b, s, C1, scale=0.1), idx, _weights(C1, C2, rng), f(C2, scale=0.1),
            _weights(C2, C3, rng), f(C3, scale=0.1), bn, f(b, s, C3))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("widths", [(30, 50, 70), (13, 8, 21)])
def test_k6_plain_at_padded_widths_equals_the_unpadded(widths, bf16):
    """K6's plain forward and backward on the inputs the wrapper pads
    (`_padded_call`: zero channels with gamma = beta = 0), sliced to the
    real widths, against the plain version at the real widths."""
    rng = np.random.default_rng(sum(widths) + bf16)
    a, ct, idx, w2, b2, w3, b3, bn, g = _k6_inputs(widths, rng)
    if bf16:
        a = a.to(BF).float()
    C1, C2, C3 = widths
    packs = SimpleNamespace(bf16=bf16)
    P, w2p, b2p, w3p, b3p, bnp, _ = k6._padded_call(widths, w2, b2, w3, b3, bn, packs)
    assert P == [-(-c // 4) * 4 for c in widths]
    out, stats, grids = k6.sa_train_fwd_plain(a, ct, idx, w2, b2, w3, b3, bn, bf16)
    outp, statsp, gridsp = k6.sa_train_fwd_plain(cf.pad_to(a, P[0]), cf.pad_to(ct, P[0]), idx,
                                                 w2p, b2p, w3p, b3p, bnp, bf16)
    _same(outp[..., :C3], out, "out")
    for i, c in enumerate((C1, C1, C2, C2, C3, C3)):
        _same(statsp[i][:c], stats[i], f"stat {i}")
        assert not statsp[i][c:].any()  # a padded channel: mean 0, variance 0
    want = k6.sa_train_bwd_plain(g, a, ct, idx, grids, stats, w2, b2, w3, b3, bn, bf16)
    got = k6.sa_train_bwd_plain(cf.pad_to(g, P[2]), cf.pad_to(a, P[0]), cf.pad_to(ct, P[0]),
                                idx, gridsp, statsp, w2p, b2p, w3p, b3p, bnp, bf16)
    for name, x, y in zip(("da", "dct"), got[:2], want[:2]):
        _same(x[..., :C1], y, name)
    _same(got[2][:C1, :C2], want[2], "dw2")
    _same(got[3][:C2, :C3], want[3], "dw3")
    for i, c in enumerate((C1, C1, C2, C2, C3, C3)):
        _same(got[4][i][:c], want[4][i], f"dbn {i}")


@pytest.mark.parametrize("bf16", [False, True])
def test_k4_plain_at_padded_widths_equals_the_unpadded(bf16):
    """K4's plain version with its three folded layers zero-padded to
    multiples of 4 (as `_launch` pads them), sliced, against the real widths."""
    rng = np.random.default_rng(40 + bf16)
    xyz = torch.from_numpy(rng.standard_normal((2, 80, 3)).astype(np.float32))
    feats = torch.from_numpy(rng.standard_normal((2, 80, 5)).astype(np.float32))
    new = xyz[:, :10].contiguous()
    widths = (8, 30, 50, 70)
    layers = [(_weights(k, c, rng), torch.from_numpy(rng.standard_normal(c).astype(np.float32)))
              for k, c in zip(widths[:-1], widths[1:])]
    pw = [8] + [-(-c // 4) * 4 for c in widths[1:]]
    padded = [(F.pad(w, (0, pw[i + 1] - w.shape[1], 0, pw[i] - w.shape[0])),
               F.pad(b, (0, pw[i + 1] - b.shape[0]))) for i, (w, b) in enumerate(layers)]
    kw = dict(radius=1.0, normalize_xyz=True, use_xyz=True, nsample=20,
              dtype=BF if bf16 else None)
    want = saf.sa_eval_plain(xyz, feats, new, None, layers, **kw)
    got = saf.sa_eval_plain(xyz, feats, new, None, padded, **kw)
    _same(got[..., :70], want, "out")
    assert not got[..., 70:].float().any()


def test_chains_plain_at_padded_widths_equal_the_unpadded():
    """K1 with its tap layer and K2 with its first layer zero-padded to a
    multiple of 8 (as the wrappers run them), sliced, against the real
    widths; the packed buffers of both are the same."""
    rng = np.random.default_rng(50)
    x = torch.from_numpy(rng.standard_normal((2, 30, 14)).astype(np.float32))
    enc = [(_weights(14, 60, rng), torch.from_numpy(rng.standard_normal(60).astype(np.float32))),
           (_weights(60, 32, rng), torch.from_numpy(rng.standard_normal(32).astype(np.float32)))]
    enc_p = [(F.pad(enc[0][0], (0, 4)), F.pad(enc[0][1], (0, 4))), (F.pad(enc[1][0], (0, 0, 0, 4)), enc[1][1])]
    c, cp = cf.FoldedChain(enc), cf.FoldedChain(enc_p)
    assert torch.equal(c.packed, cp.packed)
    tap, pooled = cf.pointnet_encoder_plain(x, c, tap_at=0)
    tap_p, pooled_p = cf.pointnet_encoder_plain(x, cp, tap_at=0)
    _same(tap_p[..., :60], tap, "tap")
    assert not tap_p[..., 60:].any()
    _same(pooled_p, pooled, "pooled")
    head = [(_weights(92, 36, rng), torch.from_numpy(rng.standard_normal(36).astype(np.float32))),
            (_weights(36, 11, rng), torch.from_numpy(rng.standard_normal(11).astype(np.float32)))]
    head_p = [(F.pad(head[0][0], (0, 4)), F.pad(head[0][1], (0, 4))), (F.pad(head[1][0], (0, 0, 0, 4)), head[1][1])]
    h, hp = cf.FoldedChain(head, split=60), cf.FoldedChain(head_p, split=60)
    assert torch.equal(h.packed, hp.packed)
    assert torch.equal(F.pad(h.w_pool, (0, 4)), hp.w_pool)
    _same(cf.seg_head_plain(tap, pooled, hp), cf.seg_head_plain(tap, pooled, h), "logits")


# --- the wrappers route the new shapes to the kernels' entries ----------------------------

class _Refusing(_Lib):
    """A stand-in library whose K4 entries refuse every shape as kErrSmem."""

    def _entry(self, fn):
        call = super()._entry(fn)
        if fn not in ("sa_fused_k4", "sa_fused_k4_bf16"):
            return call

        def refuse(*args):
            call(*args)
            return -3
        refuse.__name__ = fn
        return refuse


@pytest.fixture
def libs(monkeypatch):
    """Stand-in libraries by name (`made`); those named in `refusing` are
    `_Refusing` ones."""
    made, refusing = {}, set()

    def load_library(name):
        if name not in made:
            made[name] = SimpleNamespace(lib=(_Refusing if name in refusing else _Lib)(name))
        return made[name]

    monkeypatch.setattr(_build, "load_library", load_library)
    monkeypatch.setattr(k6.Packs, "check", lambda self, *weights: None)  # no packed sizes here
    for mod in (saf, cf, k6, sampling):
        monkeypatch.setattr(mod, "stream_of", lambda x: 0)
    return SimpleNamespace(made=made, refusing=refusing)


def _calls(libs, name, fn):
    calls = [args for f, args in libs.made[name].lib.calls if f == fn]
    sig = _build.SIGNATURES[name][fn]
    assert all(len(a) == len(sig[0] if isinstance(sig, tuple) else sig) for a in calls), fn
    return calls


@pytest.mark.parametrize("bf16", [False, True])
def test_k4_routes_past_one_tile_and_wide_tiles_to_the_rows_path(libs, bf16):
    """K > 64 goes to sa_rows_eval without trying K4's entry; a shape whose
    tiles the entry refuses (kErrSmem) goes there after it; ragged widths
    reach either entry padded to multiples of 4."""
    rng = np.random.default_rng(60)
    dtype = BF if bf16 else None
    xyz = torch.from_numpy(rng.uniform(0, 1, (2, 64, 3)).astype(np.float32))
    new = xyz[:, :16].contiguous()
    folded = saf.FoldedSA([(_weights(3, 30, rng), torch.zeros(30)),
                           (_weights(30, 50, rng), torch.zeros(50)),
                           (_weights(50, 70, rng), torch.zeros(70))], dtype=dtype)
    entry = "sa_fused_k4_bf16" if bf16 else "sa_fused_k4"
    kw = dict(radius=0.3, normalize_xyz=False, use_xyz=True, gather=-1, bf16=bf16)
    saf.reset_launch_counts()
    out = saf._launch(xyz, None, new, None, folded, saf.pack_sa(folded, dtype), K=128, **kw)
    assert out.shape == (2, 16, 70) and out.is_contiguous()
    assert "sa_fused" not in libs.made and "sa_fused_bf16" not in libs.made  # not tried
    rows = _calls(libs, "sa_fused_train", "sa_rows_eval")
    assert len(rows) == 1 and list(rows[0][14:21]) == [2, 64, 16, 128, 32, 52, 72]
    assert rows[0][-2] == int(bf16)
    out = saf._launch(xyz, None, new, None, folded, saf.pack_sa(folded, dtype), K=16, **kw)
    first = _calls(libs, "sa_fused_bf16" if bf16 else "sa_fused", entry)
    assert len(first) == 1 and list(first[0][14:21]) == [2, 64, 16, 16, 32, 52, 72]
    assert len(_calls(libs, "sa_fused_train", "sa_rows_eval")) == 1  # the entry took it
    libs.refusing.update(("sa_fused", "sa_fused_bf16"))
    libs.made.pop("sa_fused", None)
    libs.made.pop("sa_fused_bf16", None)
    saf._launch(xyz, None, new, None, folded, saf.pack_sa(folded, dtype), K=16, **kw)
    assert len(_calls(libs, "sa_fused_train", "sa_rows_eval")) == 2
    assert saf.fused_sa_apply.rows_launches == 2


@pytest.mark.parametrize("bf16", [False, True])
def test_k6_entries_take_ragged_widths_padded(libs, bf16):
    """K6's forward and backward reach their entries at the widths rounded
    up to 4 and hand back the real widths."""
    rng = np.random.default_rng(61)
    a, ct, idx, w2, b2, w3, b3, bn, g = _k6_inputs((30, 50, 70), rng)
    packs = k6.Packs(w2, w3, bf16)
    out, stats, grids = k6.sa_train_fwd_kernel(a, ct, idx, w2, b2, w3, b3, bn, packs)
    da, dct, dw2, dw3, dbn = k6.sa_train_bwd_kernel(g, a, ct, idx, grids, stats, w2, b2, w3, b3,
                                                    bn, packs)
    lib = "sa_fused_train_bf16" if bf16 else "sa_fused_train"
    fwd, bwd = ("sa_train_bf16_fwd", "sa_train_bf16_bwd") if bf16 else ("sa_train_fwd", "sa_train_bwd")
    f, b = _calls(libs, lib, fwd), _calls(libs, lib, bwd)
    assert len(f) == len(b) == 1
    assert list(f[0][-8:-1]) == [2, 40, 6, 5, 32, 52, 72]
    assert list(b[0][-9:-2]) == [2, 40, 6, 5, 32, 52, 72]
    assert out.shape == (2, 6, 70) and [s.shape[0] for s in stats] == [30, 30, 50, 50, 70, 70]
    assert (da.shape, dct.shape, dw2.shape, dw3.shape) == ((2, 40, 30), (2, 6, 30), (30, 50),
                                                           (50, 70))
    assert [d.shape[0] for d in dbn] == [30, 30, 50, 50, 70, 70]


@pytest.mark.parametrize("bf16", [False, True])
def test_chain_entries_take_a_ragged_tap_padded(libs, bf16):
    rng = np.random.default_rng(62)
    dtype = BF if bf16 else None
    chain = cf.FoldedChain([(_weights(14, 60, rng), torch.zeros(60)),
                            (_weights(60, 64, rng), torch.zeros(64))], dtype=dtype)
    x = torch.from_numpy(rng.standard_normal((2, 50, 14)).astype(np.float32))
    tap, pooled = cf._k1_cuda(x, chain.packed, chain.weights, chain.biases, chain.packed_widths,
                              0, bf16)
    assert tap.shape == (2, 50, 60) and tap.is_contiguous() and pooled.shape == (2, 64)
    head = cf.FoldedChain([(_weights(124, 36, rng), torch.zeros(36)),
                           (_weights(36, 11, rng), torch.zeros(11))], split=60, dtype=dtype)
    out = cf._k2_cuda(tap, pooled, head.packed, head.w_pool, head.weights, head.biases,
                      head.packed_widths, bf16)
    assert out.shape == (2, 50, 11)
    name, sfx = ("chain_fused_bf16", "_bf16") if bf16 else ("chain_fused", "")
    (a1,), (a2,) = _calls(libs, name, "chain_fused_k1" + sfx), _calls(libs, name, "chain_fused_k2" + sfx)
    assert list(a1[3]) == [14, 64, 64]  # the tap's width rounded up to 8
    assert list(a2[5]) == [60, 40, 11]  # K2's first width rounded up to 8; the tap as it is


def test_k3_routes_past_32768_points_to_the_cluster_entry(libs):
    xyz = torch.zeros(2, 40000, 3)
    sampling.reset_launch_counts()
    out = sampling._k3_cuda(xyz, 64, -1, -1)
    assert out.shape == (2, 64)
    (args,) = _calls(libs, "fps", "fps_k3_cluster")
    assert list(args[1:5]) == [2, 40000, 64, 8]
    assert not _calls(libs, "fps", "fps_k3")
    assert (sampling.furthest_point_sample.launches,
            sampling.furthest_point_sample.cluster_launches) == (1, 1)
    with pytest.raises(ValueError, match="one form"):
        sampling._k3_cuda(xyz, 64, 1024, -1)


def test_batches_past_the_grids_y_run_a_slice_at_a_time(libs):
    """K4/K5 and K1/K2 put the batch on grid.y (at most 65535 blocks): a
    larger batch reaches the entries in slices, and comes back whole."""
    B = 65535 + 2
    rng = np.random.default_rng(63)
    xyz = torch.zeros(B, 4, 3)
    folded = saf.FoldedSA([(_weights(3, 16, rng), torch.zeros(16)),
                           (_weights(16, 16, rng), torch.zeros(16)),
                           (_weights(16, 24, rng), torch.zeros(24))])
    out = saf._launch(xyz, None, xyz[:, :2].contiguous(), None, folded, saf.pack_sa(folded),
                      radius=0.3, normalize_xyz=False, use_xyz=True, K=4, gather=-1)
    assert out.shape == (B, 2, 24)
    assert [a[14] for a in _calls(libs, "sa_fused", "sa_fused_k4")] == [65535, 2]
    chain = cf.FoldedChain([(_weights(8, 16, rng), torch.zeros(16)),
                            (_weights(16, 32, rng), torch.zeros(32))])
    tap, pooled = cf._k1_cuda(torch.zeros(B, 3, 8), chain.packed, chain.weights, chain.biases,
                              chain.packed_widths, 0, False)
    assert tap.shape == (B, 3, 16) and pooled.shape == (B, 32)
    assert [a[5] for a in _calls(libs, "chain_fused", "chain_fused_k1")] == [65535, 2]
    head = cf.FoldedChain([(_weights(48, 16, rng), torch.zeros(16)),
                           (_weights(16, 11, rng), torch.zeros(11))], split=16)
    out = cf._k2_cuda(tap, pooled, head.packed, head.w_pool, head.weights, head.biases,
                      head.packed_widths, False)
    assert out.shape == (B, 3, 11)
    assert [a[8] for a in _calls(libs, "chain_fused", "chain_fused_k2")] == [65535, 2]
