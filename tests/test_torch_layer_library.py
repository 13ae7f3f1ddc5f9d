"""The rest of the layer library (models/pointnet.py's SetAbstractionMSG,
SetAbstractionAll and FeaturePropagation, models/flow.py's FlowEmbedding and
PointNetSetUpConv, ops/interpolate.py) against the JAX modules on the same
weights (a flax init perturbed by tests/_torch_port.randomize, mapped by
weights.state_dict_from_jax), on the CPU: forward in eval and in training
mode (outputs and the running statistics each BatchNorm blends in), and one
gradient against jax.grad.

Tolerances: outputs rtol 2e-4 / atol 2e-5 and statistics rtol 1e-4 / atol
1e-5 (tests/test_torch_sa_fused_train.py's for SetAbstraction against
flax); gradients rtol 5e-4 with atol 5e-5 of the largest gradient of the
module (a Dense bias that a training BatchNorm follows has a zero gradient
in exact arithmetic, which both sides compute as rounding noise of up to
that size); neighbour and nearest indices exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3dsot_tpu.models import flow as jflow
from open3dsot_tpu.models import pointnet as jpn
from open3dsot_tpu.ops import interpolate as jinterp
from open3dsot_tpu_torch.models import flow, pointnet
from open3dsot_tpu_torch.ops import interpolate, reference
from open3dsot_tpu_torch.weights import state_dict_from_jax
from tests._torch_port import load_into, randomize, t, to_numpy

OUT_TOL = dict(rtol=2e-4, atol=2e-5)
STAT_TOL = dict(rtol=1e-4, atol=1e-5)
B, N, C = 2, 96, 5


def _grad_close(got, want, name, scale):
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-5 * scale, err_msg=name)


def _clouds(seed: int, n: int = N, c: int = C):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (B, n, 3)).astype(np.float32),
            rng.standard_normal((B, n, c)).astype(np.float32), rng)


def _case(name: str, seed: int = 0):
    """(JAX module, the inputs of both as numpy arrays, the port's module,
    the index of the output compared, None for the whole output)."""
    xyz, feats, rng = _clouds(seed)
    if name.startswith("msg"):
        fps = name == "msg-fps"
        kw = dict(mlps=[[8, 16], [8, 12, 12]], radii=[0.3, 0.6], nsamples=[8, 16],
                  use_fps=fps, normalize_xyz=fps)
        jm = jpn.SetAbstractionMSG(**kw)
        pm = pointnet.SetAbstractionMSG(C, **kw)
        return jm, (xyz, feats, 24), pm, 1
    if name.startswith("all"):
        use_xyz = name == "all"
        jm = jpn.SetAbstractionAll(mlp=[16, 24], use_xyz=use_xyz)
        pm = pointnet.SetAbstractionAll(C, [16, 24], use_xyz=use_xyz)
        return jm, (xyz, feats), pm, 1
    if name.startswith("fp"):
        known, known_feats, _ = _clouds(seed + 1, 24, 7)
        if name == "fp-broadcast":  # no known points: the known features broadcast
            jm = jpn.FeaturePropagation(mlp=[16, 8])
            pm = pointnet.FeaturePropagation(7 + C, [16, 8])
            return jm, (xyz, None, feats, known_feats[:, :1]), pm, None
        jm = jpn.FeaturePropagation(mlp=[16, 8])
        pm = pointnet.FeaturePropagation(7 + C, [16, 8])
        return jm, (xyz, known, feats, known_feats), pm, None
    xyz2, feats2, _ = _clouds(seed + 2, 64)
    use_knn = not name.endswith("ball")
    if name.startswith("flow"):
        jm = jflow.FlowEmbedding(radius=0.5, nsample=8, mlp=[16, 12], use_knn=use_knn)
        pm = flow.FlowEmbedding(0.5, 8, C, [16, 12], use_knn=use_knn)
        return jm, (xyz, xyz2, feats, feats2), pm, 1
    mlp = [] if name == "upconv-nomlp1" else [16]
    jm = jflow.PointNetSetUpConv(nsample=8, radius=0.6, mlp=mlp, mlp2=[12], use_knn=use_knn)
    pm = flow.PointNetSetUpConv(8, 0.6, C, C, mlp, [12], use_knn=use_knn)
    return jm, (xyz, xyz2, feats, feats2), pm, None


CASES = ["msg", "msg-fps", "all", "all-noxyz", "fp", "fp-broadcast", "flow", "flow-ball",
         "upconv", "upconv-ball", "upconv-nomlp1"]


def _pick(out, i):
    return out if i is None else out[i]


def _port_args(args):
    return [None if a is None else (t(a) if isinstance(a, np.ndarray) else a) for a in args]


def _setup(name: str):
    jm, args, pm, i = _case(name)
    rng = np.random.default_rng(7)
    jargs = [None if a is None else (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
             for a in args]
    v = randomize(jm.init(jax.random.PRNGKey(0), *jargs, train=False), rng)
    return jm, jargs, args, load_into(pm, v), i, v


@pytest.mark.parametrize("name", CASES)
def test_eval_forward_matches_jax(name):
    jm, jargs, args, pm, i, v = _setup(name)
    want = np.asarray(_pick(jm.apply(v, *jargs, train=False), i))
    with torch.no_grad():
        got = _pick(pm(*_port_args(args)), i)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **OUT_TOL)
    if name.startswith("msg"):  # the centroids and their order
        np.testing.assert_array_equal(pm(*_port_args(args))[2].numpy(),
                                      np.asarray(jm.apply(v, *jargs, train=False)[2]))


@pytest.mark.parametrize("name", CASES)
def test_train_forward_matches_jax(name):
    """Batch statistics: the output of the training forward and the running
    statistics blended in."""
    jm, jargs, args, pm, i, v = _setup(name)
    out, upd = jm.apply(v, *jargs, train=True, mutable=["batch_stats"])
    pm.train()
    got = _pick(pm(*_port_args(args)), i)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(_pick(out, i)), **OUT_TOL)
    want_sd = state_dict_from_jax({"params": v["params"],
                                   "batch_stats": to_numpy(upd["batch_stats"])})
    names = [n for n, _ in pm.named_buffers() if "running" in n]
    assert names
    for n, buf in pm.named_buffers():
        if "running" in n:
            np.testing.assert_allclose(buf.numpy(), want_sd[n].numpy(), **STAT_TOL, err_msg=n)


@pytest.mark.parametrize("name", ["msg", "fp"])
def test_train_gradient_matches_jax_grad(name):
    """d(sum(out * g)) by the parameters and the point inputs, in training
    mode: autograd against jax.grad (three_interpolate's scatter-add, the
    max over neighbours, BatchNorm's batch statistics)."""
    jm, jargs, args, pm, i, v = _setup(name)
    shape = _pick(jm.apply(v, *jargs, train=False), i).shape
    g = np.random.default_rng(11).standard_normal(shape).astype(np.float32)
    wrt = [k for k, a in enumerate(args) if isinstance(a, np.ndarray)]

    def loss(params, *xs):
        full = list(jargs)
        for k, x in zip(wrt, xs):
            full[k] = x
        out, _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, *full,
                          train=True, mutable=["batch_stats"])
        return jnp.sum(_pick(out, i) * g)

    grads = jax.jit(jax.grad(loss, argnums=tuple(range(1 + len(wrt)))))(v["params"],
                                                               *[jargs[k] for k in wrt])
    pm.train()
    targs = _port_args(args)
    for k in wrt:
        targs[k].requires_grad_(True)
    (_pick(pm(*targs), i) * t(g)).sum().backward()
    for k, gk in zip(wrt, grads[1:]):
        gk = np.asarray(gk)
        _grad_close(targs[k].grad.numpy(), gk, f"input {k}", max(1.0, float(np.abs(gk).max())))
    want = state_dict_from_jax({"params": to_numpy(grads[0])})
    scale = max(1.0, max(float(w.abs().max()) for w in want.values()))
    for n, p in pm.named_parameters():
        _grad_close(p.grad.numpy(), want[n].numpy(), n, scale)


@pytest.mark.parametrize("m", [16, 3])
def test_three_nn_and_interpolate_match_jax_and_the_reference(m):
    """m = 3: every known point is a neighbour; duplicated known points
    (equal distances) keep the lower index first, as lax.top_k and the
    reference's stable argsort do."""
    rng = np.random.default_rng(m)
    unknown = rng.uniform(-1, 1, (B, 40, 3)).astype(np.float32)
    known = rng.uniform(-1, 1, (B, m, 3)).astype(np.float32)
    if m > 3:
        known[:, 5] = known[:, 2]
    dist, idx = interpolate.three_nn(t(unknown), t(known))
    jd, ji = jinterp.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    assert idx.dtype == torch.int32 and dist.shape == (B, 40, 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_allclose(dist.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)
    rd, ri = reference.three_nn_ref(unknown.astype(np.float64), known.astype(np.float64))
    np.testing.assert_array_equal(idx.numpy(), ri)
    np.testing.assert_allclose(dist.numpy(), rd, rtol=1e-4, atol=1e-5)
    feats = rng.standard_normal((B, m, 6)).astype(np.float32)
    w = rng.uniform(0, 1, (B, 40, 3)).astype(np.float32)
    got = interpolate.three_interpolate(t(feats), idx, t(w))
    want = jinterp.three_interpolate(jnp.asarray(feats), ji, jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # its gradient: the weighted scatter-add into the known features
    ft, wt = t(feats).requires_grad_(), t(w).requires_grad_()
    gout = rng.standard_normal((B, 40, 6)).astype(np.float32)
    (interpolate.three_interpolate(ft, idx, wt) * t(gout)).sum().backward()
    jf, jw = jax.grad(lambda f, ww: jnp.sum(jinterp.three_interpolate(f, ji, ww) * gout),
                      argnums=(0, 1))(jnp.asarray(feats), jnp.asarray(w))
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(jf), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-5)
