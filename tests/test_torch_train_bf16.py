"""BAT/P2B training under bf16 compute (`bf16: true`, `--bf16`) in the port
against the JAX package: one train step, the state after an optimizer step,
`Trainer.fit` and the training CLI, on the CPU at tests/test_torch_train.py's
small sizes, from the same `random_variables` weights and siamese batch.

Two bf16 paths are held, each to its JAX counterpart: the model's own (K6's
plain bf16 version in the backbone's SA layers 2-3, the flax-order bf16
layers elsewhere) to JAX's fused bf16 step (its Pallas K6 in interpret mode,
bf16 rows gathered as on the TPU), and the port's unfused bf16 path
(`fused_train=False`) to JAX's unfused bf16 step; both JAX steps jitted.

Tolerances. A bf16 step cannot be held to float64, or to another bf16 step
that rounds at other places, at a bf16-scale limit: the gradients of this
net are ill-conditioned. The port's own float32 step sits 1e-7 to 5e-3 of
max|truth| from float64 per leaf (the backbone 1e-4 to 5e-3), and each bf16
step's distance per leaf is about 10^4 times its float32 distance (2^16,
the ratio of the two roundings, times 0.1-0.5), so most leaves sit 0.1 to
several times max|truth| from float64, JAX's jitted bf16 steps as far or
farther (measured here: BAT's fused backbone leaves 0.5-4.8 on the port,
7-65 on JAX). Three checks follow from that:
- the loss terms, the gradients per leaf and the running statistics, each
  held to the float64 step (JAX's, jitted) as `_dist`, the mean |x - truth| /
  max|truth|: the port's bf16 distance at most JAX_FACTOR = 10x JAX's bf16
  distance (measured at most 6.3x per leaf, on P2B's vote-offset bias, and
  at most 2.4x on every other leaf), and at least 4x the port's own float32
  step's (the control, measured 64x-1e4x per leaf: a path that quietly
  computed in float32 would sit there). Left out: the biases whose exact
  gradient is 0 (a Dense bias that feeds a BatchNorm), where float64 holds
  only rounding noise (`_zero_leaves`). This bounds the step as a whole; it
  cannot fail a zero gradient of a leaf where JAX's bf16 step is itself
  that far from float64.
- the leaves of the K6 layers (backbone.sa1/sa2.mlp_shared: W1 through the
  A-form and da/dct, W2, W3, the three BatchNorms) on the model's bf16
  path, held to the sum, over the step's K6 calls of that layer, of JAX's
  Pallas bf16 VJP (interpret mode, bf16 row gather) at the inputs and the
  output cotangent that the port's step gave each call: within K6_MAX_REL
  of max|jax| at any element and K6_MEAN_REL on average (measured at most
  2^-7.5 and 2^-10.5), and the port's float32 K6 on the same inputs outside
  them (measured 2^-6.6 of max|jax| at least). Both sides round the same
  values; the rest is f32 sums in another order, which moves a value across
  a bf16 boundary now and then, and the BatchNorm backward's cancellation
  magnifies. Left out: each layer's Dense biases (b2, b3 exactly 0 on both
  sides; b1 feeds BN1 through ct, rounding noise).
Parameters, their gradients and Adam's state stay float32.
"""

from __future__ import annotations

import contextlib
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from open3dsot_tpu.config import load_config as j_load_config
from open3dsot_tpu.models import get_model as j_get_model
from open3dsot_tpu.ops.sa_fused_train import fused_sa_train_apply as j_fused_sa_train_apply
from open3dsot_tpu_torch.config import load_config
from open3dsot_tpu_torch.data import get_dataset
from open3dsot_tpu_torch.data.loader import collate
from open3dsot_tpu_torch.models import get_model, pointnet
from open3dsot_tpu_torch.models.layers import computes_in_bf16, set_compute_dtype
from open3dsot_tpu_torch.ops.sa_fused_train import fused_sa_train_apply
from open3dsot_tpu_torch.train.optim import make_optimizer
from open3dsot_tpu_torch.train.trainer import train_step
from open3dsot_tpu_torch.weights import random_variables, state_dict_from_jax
from tests._torch_port import bf16_errors, to_numpy

SYNTHETIC = {"bat": "cfgs/BAT_synthetic.yaml", "p2b": "cfgs/P2B_synthetic.yaml"}
SMALL = dict(template_size=64, search_size=128, feature_channel=32, hidden_channel=32,
             out_channel=32, vote_channel=32, num_proposal=8, syn_num_tracklets=2,
             syn_tracklet_len=5, seed=3, tensorboard=False, dataset="synthetic")
PARTS = ("losses", "gradients", "running statistics")
JAX_FACTOR = 10.0
K6_MAX_REL, K6_MEAN_REL = 2.0 ** -7, 2.0 ** -9


def _setup(name):
    port = get_model(name)(load_config(SYNTHETIC[name], SMALL), device="cpu")
    variables = random_variables(port.net, seed=4)
    np.random.seed(0)
    batch = collate([get_dataset(port.config, "train_siamese", "train")[i] for i in (1, 6)])
    return variables, batch


def _jax_step(name, variables, batch, x64=False, **flags):
    """JAX's train step, jitted (in float64 with x64): (losses, gradients,
    running statistics) in the port's names."""
    jcfg = j_load_config(SYNTHETIC[name], dict(SMALL, **flags))
    jm = j_get_model(name)(jcfg)

    @jax.jit
    def loss_and_grad(params, batch_stats, batch):
        def loss_fn(p):
            out, mut = jm.apply({"params": p, "batch_stats": batch_stats}, batch, train=True)
            loss_dict = jm.loss(jcfg, batch, out)
            return loss_dict["loss_total"], (loss_dict, mut["batch_stats"])

        return jax.grad(loss_fn, has_aux=True)(params)

    cast = (lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), t)) if x64 \
        else to_numpy
    with jax.enable_x64(x64):
        grads, (losses, stats) = loss_and_grad(cast(variables["params"]),
                                               cast(variables["batch_stats"]), cast(batch))
        grads, stats = to_numpy(grads), to_numpy(stats)
        losses = {k: float(v) for k, v in losses.items()}
    sd = state_dict_from_jax({"params": variables["params"], "batch_stats": stats})
    return (losses,
            {k: v.numpy().astype(np.float64)
             for k, v in state_dict_from_jax({"params": grads}).items()},
            {k: v.numpy().astype(np.float64) for k, v in sd.items() if "running" in k})


@contextlib.contextmanager
def _recording_k6(calls: list):
    """Inside: each K6 call of the SA layers appended to `calls` with its
    inputs, its SA layer's MLP and, after the backward, its output's cotangent."""
    real = pointnet.fused_sa_train_apply

    def recording(xyz, features, new_xyz, idx, mlp, **kw):
        out, stats = real(xyz, features, new_xyz, idx, mlp, **kw)
        rec = dict(inputs=[x.detach().float().clone() for x in (xyz, features, new_xyz)],
                   idx=idx.detach().int().clone(), mlp=mlp, kw=kw)
        out.register_hook(lambda g: rec.__setitem__("g", g.detach().float().clone()))
        calls.append(rec)
        return out, stats

    pointnet.fused_sa_train_apply = recording
    try:
        yield calls
    finally:
        pointnet.fused_sa_train_apply = real


def _port_step(name, variables, batch, bf16, fused_train=True, calls=None):
    port = get_model(name)(load_config(SYNTHETIC[name], dict(SMALL, bf16=bf16)), device="cpu",
                           fused_train=fused_train)
    assert computes_in_bf16(port.net) == bf16
    port.net.load_state_dict(state_dict_from_jax(variables), strict=True)
    b = port.device_batch(batch)
    with _recording_k6([] if calls is None else calls):
        losses = port.loss(b, port.apply_train(b))
        losses["loss_total"].backward()
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in port.net.parameters())
    if calls is not None:
        names = {id(m): n for n, m in port.net.named_modules()}
        for rec in calls:
            rec["layer"] = names[id(rec["mlp"])]
    return ({k: float(v.detach()) for k, v in losses.items()},
            {k: p.grad.double().numpy() for k, p in port.net.named_parameters()},
            {k: b_.double().numpy() for k, b_ in port.net.named_buffers() if "running" in k})


@functools.lru_cache(maxsize=None)
def _truth(name):
    """(variables, batch, JAX's float64 step, the port's float32 step)."""
    variables, batch = _setup(name)
    return (variables, batch,
            _jax_step(name, variables, batch, x64=True, fused_sa=False, fused_sa_train=False),
            _port_step(name, variables, batch, False))


def _dist(got: dict, truth: dict) -> float:
    g = np.concatenate([np.ravel(got[k]) for k in truth])
    t = np.concatenate([np.ravel(truth[k]) for k in truth])
    return float(np.abs(g - t).mean() / np.abs(t).max())


def _zero_leaves(grads: dict) -> set:
    """The leaves whose exact gradient is 0, float64 rounding noise in `grads`:
    each a bias (checked) that feeds a BatchNorm."""
    top = max(np.abs(g).max() for g in grads.values())
    zero = {k for k, g in grads.items() if np.abs(g).max() <= 1e-9 * top}
    assert all(k.endswith("bias") for k in zero), zero
    return zero


def _hold_to_jax_and_float64(got, want, truth, port32):
    """The loss terms and running statistics together, the gradients per
    leaf: the port's distance from float64 at most JAX_FACTOR x JAX's, at
    least 4x the port's float32 step's (the control)."""
    for i, part in enumerate(PARTS):
        keys = [k for k in truth[i] if not (i == 1 and k in _zero_leaves(truth[1]))]
        groups = [[k] for k in keys] if i == 1 else [keys]
        for group in groups:
            d_port, d_jax, d_f32 = (_dist({k: x[i][k] for k in group},
                                          {k: truth[i][k] for k in group})
                                    for x in (got, want, port32))
            assert d_port < JAX_FACTOR * d_jax, (part, group, d_port, d_jax)
            assert d_port > 4 * d_f32, (part, group, d_port, d_f32)  # the control


def _flax_mlp_params(mlp) -> dict:
    return {f"layer{i}": {"dense": {"kernel": layer.dense.weight.detach().t().numpy(),
                                    "bias": layer.dense.bias.detach().numpy()},
                          "bn": {"scale": layer.bn.weight.detach().numpy(),
                                 "bias": layer.bn.bias.detach().numpy()}}
            for i, layer in enumerate(mlp.children())}


def _k6_leaf_grads(calls, jax_dtype=None):
    """{leaf: the sum over its layer's K6 calls of the VJP at each call's
    inputs and cotangent}: JAX's Pallas K6 in `jax_dtype` (interpret mode,
    bf16 rows gathered), or the port's K6 in float32 when None."""
    total = {}
    for rec in calls:
        kw = {k: v for k, v in rec["kw"].items() if k != "packs"}
        if jax_dtype is None:
            mlp = set_compute_dtype(copy.deepcopy(rec["mlp"]), None)
            out, _ = fused_sa_train_apply(*rec["inputs"], rec["idx"], mlp, **kw)
            (out * rec["g"]).sum().backward()
            grads = {k: p.grad.double().numpy() for k, p in mlp.named_parameters()}
        else:
            def loss(p, xyz, feats, new_xyz, idx, g):
                out, _ = j_fused_sa_train_apply(xyz, feats, new_xyz, idx, p, dtype=jax_dtype,
                                                interpret=True, impl="pallas",
                                                int8_gather=True, **kw)
                return jnp.sum(out.astype(jnp.float32) * g)

            tree = jax.jit(jax.grad(loss))(_flax_mlp_params(rec["mlp"]),
                                           *(x.numpy() for x in rec["inputs"]),
                                           rec["idx"].numpy(), rec["g"].numpy())
            grads = {}
            for i in range(3):
                layer = tree[f"layer{i}"]
                grads[f"layer{i}.dense.weight"] = np.asarray(layer["dense"]["kernel"]).T
                grads[f"layer{i}.dense.bias"] = np.asarray(layer["dense"]["bias"])
                grads[f"layer{i}.bn.weight"] = np.asarray(layer["bn"]["scale"])
                grads[f"layer{i}.bn.bias"] = np.asarray(layer["bn"]["bias"])
        for k, v in grads.items():
            key = f"{rec['layer']}.{k}"
            total[key] = total.get(key, 0.0) + np.asarray(v, np.float64)
    return total


@pytest.mark.parametrize("name", ["bat", "p2b"])
def test_bf16_unfused_train_step_against_jax_unfused_bf16(name):
    """The port's unfused bf16 path (flax's rounding order everywhere)
    against JAX's unfused bf16 step."""
    variables, batch, truth, port32 = _truth(name)
    want = _jax_step(name, variables, batch, bf16=True, fused_sa=False, fused_sa_train=False)
    got = _port_step(name, variables, batch, True, fused_train=False)
    _hold_to_jax_and_float64(got, want, truth, port32)


@functools.lru_cache(maxsize=None)
def _port_bf16_step(name):
    """The model's bf16 step (K6 in bf16) and its recorded K6 calls."""
    variables, batch, _, _ = _truth(name)
    calls = []
    return _port_step(name, variables, batch, True, calls=calls), calls


@pytest.mark.parametrize("name", ["bat", "p2b"])
def test_bf16_train_step_against_jax_fused_bf16(name, monkeypatch):
    """The model's bf16 path (K6 in bf16) against JAX's fused bf16 step."""
    monkeypatch.setenv("OPEN3DSOT_INT8_GATHER", "1")  # JAX's K6 gathers bf16 rows, as on the TPU
    variables, batch, truth, port32 = _truth(name)
    want = _jax_step(name, variables, batch, bf16=True, fused_sa=False, fused_sa_train=True)
    _hold_to_jax_and_float64(_port_bf16_step(name)[0], want, truth, port32)


@pytest.mark.parametrize("name", ["bat", "p2b"])
def test_bf16_train_step_k6_leaves_against_jax_pallas_vjp(name):
    """The K6 layers' leaves of the model's bf16 step against JAX's Pallas
    bf16 VJP at the step's own K6 inputs and cotangents, summed over each
    layer's calls; the port's float32 K6 on the same inputs as the control."""
    got, calls = _port_bf16_step(name)
    assert sorted({rec["layer"] for rec in calls}) == ["backbone.sa1.mlp_shared",
                                                       "backbone.sa2.mlp_shared"]
    assert len(calls) == 4  # template and search through SA layers 2 and 3
    want = _k6_leaf_grads(calls, jnp.bfloat16)
    f32 = _k6_leaf_grads(calls)
    held = [k for k in want if not k.endswith("dense.bias")]
    assert len(held) == 2 * 9  # W1-W3 and three BatchNorms in each of the two layers
    for k in held:
        worst, mean = bf16_errors(torch.from_numpy(got[1][k]), want[k])
        assert worst <= K6_MAX_REL and mean <= K6_MEAN_REL, (k, worst, mean)
        worst, mean = bf16_errors(torch.from_numpy(f32[k]), want[k])  # the control
        assert worst > K6_MAX_REL or mean > K6_MEAN_REL, (k, worst, mean)
    for k in want:
        if k.endswith(("layer1.dense.bias", "layer2.dense.bias")):
            assert not got[1][k].any(), k  # a Dense bias that feeds a BatchNorm, on K6: exactly 0


@pytest.mark.parametrize("name", ["bat", "p2b"])
def test_bf16_optimizer_step_keeps_float32_state(name):
    """After an Adam step under bf16: parameters, gradients and the optimizer's
    moments float32, the running statistics float32 and finite."""
    over = dict(SMALL, dataset="synthetic", bf16=True)
    port = get_model(name)(load_config(SYNTHETIC[name], over), device="cpu")
    assert computes_in_bf16(port.net)
    port.net.load_state_dict(state_dict_from_jax(random_variables(port.net, seed=4)), strict=True)
    np.random.seed(0)
    batch = collate([get_dataset(port.config, "train_siamese", "train")[i] for i in (1, 6)])
    optimizer, scheduler = make_optimizer(port.config, port.net.parameters(), 1)
    scalars = train_step(port, optimizer, port.device_batch(batch), scheduler, fetch=True)
    assert np.isfinite(scalars["loss_total"])
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in port.net.parameters())
    moments = [v for st in optimizer.state.values() for v in st.values()
               if torch.is_tensor(v) and v.dim() > 0]
    assert moments and all(v.dtype == torch.float32 for v in moments)
    assert all(b.dtype == torch.float32 and torch.isfinite(b).all()
               for k, b in port.net.named_buffers() if "running" in k)


@pytest.mark.parametrize("name", ["bat", "p2b"])
def test_bf16_trainer_fit_and_cli(name, tmp_path, capsys):
    """Trainer.fit under bf16 validating on the scan tracker, then `--bf16`
    through the training CLI (--device cpu) and an eval of its checkpoint."""
    from open3dsot_tpu_torch import main as port_main

    cfg = yaml.safe_load(open(SYNTHETIC[name]))
    cfg.update(SMALL, syn_num_tracklets=1, syn_tracklet_len=4, num_candidates=1)
    path = tmp_path / "small.yaml"
    path.write_text(yaml.safe_dump(cfg))
    run = tmp_path / "run"
    port_main.main(["--cfg", str(path), "--epoch", "1", "--batch_size", "2", "--device", "cpu",
                    "--bf16", "--log_dir", str(run)])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("trained 2 steps; loss ")
    assert "precision" in (run / "history.jsonl").read_text()
    port_main.main(["--cfg", str(path), "--test", "--bf16", "--checkpoint",
                    str(run / "ckpt_last.pt"), "--device", "cpu"])
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("success/test:")
