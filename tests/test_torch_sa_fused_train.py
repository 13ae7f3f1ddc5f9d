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
