"""BAT/P2B training in the port against the JAX package: training-mode
BatchNorm, one train step (loss terms, parameter gradients, running
statistics), parameters after two optimizer steps, `Trainer.fit` and the
training CLI, on the CPU at small sizes (template 64, search 128, heads 32
wide; the backbone widths are fixed).

The JAX model runs with its unfused SA (`fused_sa_train=False`), jitted;
the port runs K6's plain version in the backbone's SA layers 2-3 and the
plain grid MLP elsewhere, as it does on the card with the kernel. Both
start from the same `random_variables` weights, with the Dense biases that
feed a BatchNorm at 0 as flax initialises them, and the same numpy batch
from the siamese sampler.

The step is compared in float64 on both sides (`jax.enable_x64`, the port's
net in double). In float32 a train step at these sizes is only good to
about 1e-2 of each gradient: BatchNorms over 32-128 rows whose inputs carry
absolute coordinates have |mean| >> std, so E[y^2] - E[y]^2 loses digits,
and the backward amplifies them. JAX's own float32 gradients are 1e-2 to
5e-2 away from its float64 ones there, the port's about 1e-3 to 2e-2. In
float64 the two agree to about 5e-7 (float32 casts left inside both, such
as the ball query's distances), so a different formula shows at once.
Tolerances: loss terms rtol 1e-6 (float64) and 1e-3 (the port in float32
against JAX in float64); gradients rtol 1e-5, atol 1e-5 * max(1, max|g|)
of each tensor; running statistics rtol 1e-6, atol 1e-8; parameters after
two Adam steps atol 1e-4: Adam scales a gradient by 1 / (sqrt(v) + 1e-6),
so an element whose gradient is within the agreement above of 0 can move
by up to the learning rate (1e-3) differently; seen: 9e-6.
"""

from __future__ import annotations

import functools
import json

import jax
import numpy as np
import optax
import pytest
import torch
import yaml

from open3dsot_tpu.config import load_config
from open3dsot_tpu.models import get_model as jax_get_model
from open3dsot_tpu.models.layers import DenseBNRelu as JDenseBNRelu
from open3dsot_tpu.train.optim import make_optimizer as jax_make_optimizer
from open3dsot_tpu_torch.config import load_config as port_load_config
from open3dsot_tpu_torch.data import get_dataset
from open3dsot_tpu_torch.data.loader import collate
from open3dsot_tpu_torch.models import get_model
from open3dsot_tpu_torch.models.layers import DenseBNRelu
from open3dsot_tpu_torch.train.optim import make_optimizer
from open3dsot_tpu_torch.train.trainer import Trainer, train_step
from open3dsot_tpu_torch.weights import random_variables, state_dict_from_jax
from tests._torch_port import t, to_numpy

SYNTHETIC = {"bat": "cfgs/BAT_synthetic.yaml", "p2b": "cfgs/P2B_synthetic.yaml"}
SMALL = dict(template_size=64, search_size=128, feature_channel=32, hidden_channel=32,
             out_channel=32, vote_channel=32, num_proposal=8, syn_num_tracklets=2,
             syn_tracklet_len=5, seed=3, tensorboard=False)


def _grad_close(got, want, name):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale, err_msg=name)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def test_dense_bn_relu_train_matches_flax():
    """Batch statistics over every leading axis, biased variance, and the
    running statistics blended 0.9 / 0.1 with it, as flax."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 7, 5, 6)) * 2 + 1).astype(np.float32)
    jm = JDenseBNRelu(8)
    v = to_numpy(jm.init(jax.random.PRNGKey(0), x, train=True))
    v["batch_stats"]["bn"]["var"] = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    want, upd = jm.apply(v, x, train=True, mutable=["batch_stats"])
    port = DenseBNRelu(6, 8)
    port.load_state_dict(state_dict_from_jax(v))
    got = port.train()(t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    stats = to_numpy(upd["batch_stats"])["bn"]
    np.testing.assert_allclose(port.bn.running_mean.numpy(), stats["mean"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port.bn.running_var.numpy(), stats["var"], rtol=1e-5, atol=1e-6)
    # an eval forward after the update uses the new running statistics
    want_eval = jm.apply({"params": v["params"], "batch_stats": upd["batch_stats"]}, x)
    np.testing.assert_allclose(port.eval()(t(x)).detach().numpy(), np.asarray(want_eval),
                               rtol=1e-5, atol=1e-5)


def _biases_before_bn_zeroed(variables):
    """The Dense biases that feed a BatchNorm set to 0, as flax initialises them."""
    def walk(params):
        for v in params.values():
            if hasattr(v, "items"):
                if "dense" in v and "bn" in v:
                    v["dense"]["bias"] = np.zeros_like(v["dense"]["bias"])
                walk(v)

    walk(variables["params"])
    return variables


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(port model on the CPU, JAX config, the jitted JAX train step's
    gradients and outputs, numpy batch, initial variables) at the small sizes."""
    over = dict(SMALL, dataset="synthetic")
    jcfg = load_config(SYNTHETIC[name], dict(over, fused_sa=False, fused_sa_train=False))
    port = get_model(name)(port_load_config(SYNTHETIC[name], over), device="cpu")
    variables = _biases_before_bn_zeroed(random_variables(port.net, seed=4))
    jm = jax_get_model(name)(jcfg)

    @jax.jit
    def loss_and_grad(params, batch_stats, batch):
        def loss_fn(p):
            out, mut = jm.apply({"params": p, "batch_stats": batch_stats}, batch, train=True)
            loss_dict = jm.loss(jcfg, batch, out)
            return loss_dict["loss_total"], (loss_dict, mut["batch_stats"])

        return jax.grad(loss_fn, has_aux=True)(params)

    np.random.seed(0)
    sampler = get_dataset(port.config, "train_siamese", "train")
    batch = collate([sampler[i] for i in (1, 6)])
    return port, jcfg, loss_and_grad, batch, variables


def _port_at(name, variables, dtype):
    port = _pair(name)[0]
    port.net.load_state_dict(state_dict_from_jax(variables), strict=True)
    port.net.to(dtype)
    return port


def _batch_as(batch, dtype):
    return {k: torch.from_numpy(np.asarray(v)).to(dtype) for k, v in batch.items()}


@pytest.mark.parametrize("name", ["bat", "p2b"])
def test_train_step_matches_jax(name):
    _, _, loss_and_grad, batch, variables = _pair(name)
    with jax.enable_x64(True):
        grads, (want_losses, want_stats) = loss_and_grad(
            _f64(variables["params"]), _f64(variables["batch_stats"]), _f64(batch))
        grads, want_stats = to_numpy(grads), to_numpy(want_stats)
        want_losses = {k: float(v) for k, v in want_losses.items()}
    port = _port_at(name, variables, torch.float32)
    b = _batch_as(batch, torch.float32)
    with torch.no_grad():
        losses = port.loss(b, port.apply_train(b))
    assert set(losses) == set(want_losses)
    for k, v in losses.items():
        np.testing.assert_allclose(float(v), want_losses[k], rtol=1e-3, err_msg=f"f32 {k}")

    port = _port_at(name, variables, torch.float64)
    b = _batch_as(batch, torch.float64)
    losses = port.loss(b, port.apply_train(b))
    for k, v in losses.items():
        np.testing.assert_allclose(float(v.detach()), want_losses[k], rtol=1e-6, err_msg=k)
    losses["loss_total"].backward()
    want_grads = state_dict_from_jax({"params": grads})
    for k, p in port.net.named_parameters():
        _grad_close(p.grad.numpy(), want_grads[k].numpy().astype(np.float64), k)
    want_sd = state_dict_from_jax({"params": variables["params"], "batch_stats": want_stats})
    for k, buf in port.net.named_buffers():
        if "running" in k:
            np.testing.assert_allclose(buf.numpy(), want_sd[k].numpy(), rtol=1e-6, atol=1e-8,
                                       err_msg=k)


def test_two_adam_steps_match_optax():
    """Parameters after two steps of the port's optimizer (Adam, betas
    (0.5, 0.999), eps 1e-6, the StepLR schedule) against the JAX package's
    optax chain on the same batch, both in float64."""
    _, jcfg, loss_and_grad, batch, variables = _pair("bat")
    with jax.enable_x64(True):
        tx = jax_make_optimizer(jcfg, steps_per_epoch=1)

        @jax.jit
        def update(grads, opt_state, params):
            updates, opt_state = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state

        params, stats = _f64(variables["params"]), _f64(variables["batch_stats"])
        opt_state = tx.init(params)
        for _ in range(2):
            grads, (_, stats) = loss_and_grad(params, stats, _f64(batch))
            params, opt_state = update(grads, opt_state, params)
        want = state_dict_from_jax({"params": to_numpy(params), "batch_stats": to_numpy(stats)})
    port = _port_at("bat", variables, torch.float64)
    optimizer, scheduler = make_optimizer(port.config, port.net.parameters(), steps_per_epoch=1)
    for _ in range(2):
        train_step(port, optimizer, _batch_as(batch, torch.float64), scheduler)
    for k, v in port.net.state_dict().items():
        if "num_batches" not in k:
            np.testing.assert_allclose(v.numpy(), want[k].numpy().astype(np.float64), atol=1e-4,
                                       err_msg=k)


def test_lr_schedule_matches_optax():
    """StepLR per step: lr * rate ** ((step // steps_per_epoch) // decay_step)."""
    cfg = port_load_config(SYNTHETIC["p2b"], dict(lr_decay_step=2, lr_decay_rate=0.5))
    optimizer, scheduler = make_optimizer(cfg, [torch.zeros(1, requires_grad=True)],
                                          steps_per_epoch=3)
    from open3dsot_tpu.train.optim import steplr_schedule

    want = steplr_schedule(cfg.lr, 3, 2, 0.5)
    for step in range(14):
        assert optimizer.param_groups[0]["lr"] == pytest.approx(float(want(step)), rel=1e-12)
        optimizer.step()
        scheduler.step()


def test_trainer_fit_writes_checkpoints(tmp_path):
    port = _port_at("p2b", _pair("p2b")[-1], torch.float32)
    cfg = port.config.copy()
    cfg.batch_size = 4
    val = get_dataset(port_load_config(SYNTHETIC["p2b"], dict(SMALL, syn_num_tracklets=1)),
                      "test", "test")
    history = Trainer(port, cfg, work_dir=str(tmp_path)).fit(
        get_dataset(cfg, "train_siamese", "train"), val, epochs=1, steps_per_epoch=2)
    assert history[0]["steps"] == 2 and np.isfinite(history[0]["loss"])
    assert 0 <= history[0]["precision"] <= 100
    for f in ("ckpt_best.pt", "ckpt_last.pt", "ckpt_meta.json", "history.jsonl",
              "scalars.jsonl"):
        assert (tmp_path / f).exists(), f
    ckpt = torch.load(tmp_path / "ckpt_last.pt", weights_only=True)
    assert ckpt["step"] == 2
    assert set(ckpt["state_dict"]) == set(port.net.state_dict())
    meta = json.loads((tmp_path / "ckpt_meta.json").read_text())
    assert meta["best_metric"] == history[0]["precision"]


def test_cli_trains_then_evaluates_its_checkpoint(tmp_path, capsys):
    from open3dsot_tpu_torch import main as port_main

    cfg = yaml.safe_load(open(SYNTHETIC["bat"]))
    cfg.update(SMALL, syn_num_tracklets=1, syn_tracklet_len=4, num_candidates=1)
    path = tmp_path / "bat_small.yaml"
    path.write_text(yaml.safe_dump(cfg))
    run = tmp_path / "run"
    port_main.main(["--cfg", str(path), "--epoch", "1", "--batch_size", "2", "--device", "cpu",
                    "--log_dir", str(run)])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("trained 2 steps; loss ")
    history = [json.loads(line) for line in (run / "history.jsonl").read_text().splitlines()]
    assert len(history) == 1 and np.isfinite(history[0]["loss"])
    port_main.main(["--cfg", str(path), "--test", "--checkpoint", str(run / "ckpt_last.pt"),
                    "--device", "cpu"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("success/test:")


def test_loader_thread_ends_when_the_consumer_stops():
    """Trainer.fit stops an epoch after `steps_per_epoch` batches; the
    loader's background thread must not stay blocked on a full queue."""
    import threading

    from open3dsot_tpu_torch.data.loader import BatchLoader

    def producers():
        return [t for t in threading.enumerate() if "producer" in t.name]

    samples = [{"x": np.full(3, i, np.float32)} for i in range(20)]
    loader = BatchLoader(samples, 2, prefetch=1, workers=2)
    batches = iter(loader)
    np.testing.assert_array_equal(next(batches)["x"].shape, (2, 3))
    assert len(producers()) == 1
    batches.close()
    assert producers() == []
    loader.close()


@pytest.mark.parametrize("key,value", [("dp_shard_map", True), ("mesh_shape", [1])])
def test_unported_config_keys_are_refused(key, value, tmp_path):
    """The keys once refused here are taken now (UNPORTED_KEYS is empty):
    `dp_shard_map: true` is the per-device statistics mode, which in a world
    of one trains as the default does, and `mesh_shape` is accepted and
    ignored, as in JAX (tests/test_torch_distributed.py holds both modes
    over two ranks)."""
    from open3dsot_tpu_torch.train.trainer import UNPORTED_KEYS, Trainer

    assert UNPORTED_KEYS == {}
    over = dict(SMALL, dataset="synthetic", batch_size=2)
    runs = []
    for cfg in (port_load_config(SYNTHETIC["bat"], dict(over, **{key: value})),
                port_load_config(SYNTHETIC["bat"], over)):
        port = get_model("bat")(cfg, device="cpu")
        port.net.load_state_dict(state_dict_from_jax(random_variables(port.net, seed=4)))
        trainer = Trainer(port, cfg, work_dir=str(tmp_path / str(len(runs))))
        assert trainer.per_device_stats == (key == "dp_shard_map" and not runs)
        np.random.seed(0)
        trainer.fit(get_dataset(cfg, "train_siamese", "train"), epochs=1, steps_per_epoch=1)
        runs.append(port.net.state_dict())
    for k, v in runs[0].items():
        assert torch.equal(v, runs[1][k]), k
