"""M2-Track training in the port against the JAX package: `m2track_loss`,
one train step in float64 and in bf16, `Trainer.fit` validating on
M2ScanTracker, and the training CLI, on the CPU at small sizes
(point_sample_size 32 or 64, box_aware; the encoders' widths are fixed).

M2 trains on the plain layers in both packages (K1/K2 are eval-only). The
step is compared in float64 on both sides (`jax.enable_x64`, the port's net
in double), as tests/test_torch_train.py compares BAT's: the JAX model
unfused and jitted, the same `random_variables` weights with the Dense
biases that feed a BatchNorm at 0, the same numpy batch from the motion
sampler. Tolerances:
- `m2track_loss` on the same outputs and labels, float64: rtol 1e-12;
- the float64 step: loss terms and accuracies rtol 1e-4, gradients rtol
  1e-3 and atol 5e-3 * max(1, max|g|) of each tensor, running statistics
  rtol 1e-4, atol 1e-6. JAX's M2TrackNet casts the seg output and every
  head to float32 (`.astype(jnp.float32)`, m2track.py:68, :103-131) under
  x64 too, where the port keeps float64, and the second stage (the motion
  moves the t0 points, a MiniPointNet and its box head) amplifies those
  roundings (seen: seg logits 1.2e-7 apart, the boxes 9.5e-5, loss_center
  2.5e-5, gradients 1.5e-3 of max|g|, running means 4.1e-7); a wrong term
  or formula is off by order one;
- the bf16 step (`bf16: true`): the argmax gates (seg mask, motion state)
  turn a flipped bf16 step into a different point set, so each bf16 side is
  held to the float64 step (JAX's), not to the other: the port's distance
  from it, mean |x - truth| / max|truth| over the loss terms and over all
  gradients together, between 0.25x and 4x JAX bf16's, and the port's own
  float32 step below 0.25x (the control). Parameters, gradients and Adam's
  state stay float32.
"""

from __future__ import annotations

import functools
import json

import jax
import numpy as np
import pytest
import torch
import yaml

from open3dsot_tpu.config import load_config as j_load_config
from open3dsot_tpu.models import get_model as j_get_model
from open3dsot_tpu.models.m2track import m2track_loss as j_m2track_loss
from open3dsot_tpu.data import get_dataset as j_get_dataset
from open3dsot_tpu_torch.config import load_config
from open3dsot_tpu_torch.data import get_dataset
from open3dsot_tpu_torch.data.loader import collate
from open3dsot_tpu_torch.models import get_model
from open3dsot_tpu_torch.models.m2track import m2track_loss
from open3dsot_tpu_torch.train.optim import make_optimizer
from open3dsot_tpu_torch.train.trainer import Trainer, train_step
from open3dsot_tpu_torch.weights import random_variables, state_dict_from_jax
from tests._torch_port import to_numpy

CFG = "cfgs/M2_track_synthetic.yaml"
SMALL = dict(point_sample_size=32, syn_num_tracklets=2, syn_tracklet_len=5, seed=3,
             tensorboard=False, use_augmentation=False)


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64) if np.asarray(a).dtype.kind == "f" else np.asarray(a),
        tree)


def _biases_before_bn_zeroed(variables):
    def walk(params):
        for v in params.values():
            if hasattr(v, "items"):
                if "dense" in v and "bn" in v:
                    v["dense"]["bias"] = np.zeros_like(v["dense"]["bias"])
                walk(v)

    walk(variables["params"])
    return variables


def test_m2track_loss_matches_jax():
    """Every term and accuracy of the loss on the same outputs and labels,
    with and without the motion classifier and the BoxCloud."""
    rng = np.random.default_rng(0)
    B, N = 4, 16
    out = {"seg_logits": rng.standard_normal((B, 2 * N, 2)),
           "motion_cls": rng.standard_normal((B, 2)),
           "pred_bc": rng.standard_normal((B, 2 * N, 9))}
    for k in ("aux_estimation_boxes", "motion_pred", "estimation_boxes", "estimation_boxes_prev"):
        out[k] = rng.standard_normal((B, 4))
    batch = {"seg_label": rng.integers(0, 2, (B, 2 * N)).astype(np.int32),
             "motion_state_label": np.array([0, 1, 1, 0], np.int32),
             "prev_bc": rng.standard_normal((B, N, 9)), "this_bc": rng.standard_normal((B, N, 9))}
    for k in ("box_label", "box_label_prev", "motion_label"):
        batch[k] = rng.standard_normal((B, 4))
    for flags in (dict(), dict(use_motion_cls=False, box_aware=False)):
        cfg = load_config(CFG, flags)
        with jax.enable_x64(True):
            want = {k: float(v) for k, v in j_m2track_loss(j_load_config(CFG, flags), batch,
                                                           out).items()}
        got = m2track_loss(cfg, {k: torch.from_numpy(v) for k, v in batch.items()},
                           {k: torch.from_numpy(v) for k, v in out.items()})
        assert set(got) == set(want)
        for k, v in got.items():
            np.testing.assert_allclose(float(v), want[k], rtol=1e-12, err_msg=k)


@functools.lru_cache(maxsize=None)
def _pair(bf16: bool):
    """(port model, the jitted JAX loss-and-grad, numpy batch, variables)."""
    over = dict(SMALL, bf16=bf16)
    jcfg = j_load_config(CFG, dict(over, fused_chain=False))
    port = get_model("m2track")(load_config(CFG, over), device="cpu")
    variables = _biases_before_bn_zeroed(random_variables(port.net, seed=4))
    jm = j_get_model("m2track")(jcfg)

    @jax.jit
    def loss_and_grad(params, batch_stats, batch):
        def loss_fn(p):
            out, mut = jm.apply({"params": p, "batch_stats": batch_stats}, batch, train=True)
            loss_dict = j_m2track_loss(jcfg, batch, out)
            return loss_dict["loss_total"], (loss_dict, mut["batch_stats"])

        return jax.grad(loss_fn, has_aux=True)(params)

    np.random.seed(0)
    sampler = get_dataset(port.config, "train_motion", "train")
    batch = collate([sampler[i] for i in (1, 3, 6)])
    return port, loss_and_grad, batch, variables


def _port_step(port, variables, batch, dtype):
    port.net.load_state_dict(state_dict_from_jax(variables), strict=True)
    port.net.to(dtype)
    b = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    b = {k: v.to(dtype) if v.is_floating_point() else v.long() for k, v in b.items()}
    port.net.zero_grad(set_to_none=True)
    losses = port.loss(b, port.apply_train(b))
    losses["loss_total"].backward()
    grads = {k: p.grad.double().numpy() for k, p in port.net.named_parameters()}
    stats = {k: b_.double().numpy() for k, b_ in port.net.named_buffers() if "running" in k}
    port.net.float()
    return {k: float(v.detach()) for k, v in losses.items()}, grads, stats


@functools.lru_cache(maxsize=None)
def _jax_float64_step():
    """JAX's float64 step: (loss terms, gradients as a state_dict, batch_stats)."""
    _, loss_and_grad, batch, variables = _pair(False)
    with jax.enable_x64(True):
        grads, (losses, stats) = loss_and_grad(
            _f64(variables["params"]), _f64(variables["batch_stats"]), _f64(batch))
        grads, stats = to_numpy(grads), to_numpy(stats)
        losses = {k: float(v) for k, v in losses.items()}
    grads = {k: v.numpy().astype(np.float64)
             for k, v in state_dict_from_jax({"params": grads}).items()}
    return losses, grads, stats


def test_train_step_matches_jax_in_float64():
    port, _, batch, variables = _pair(False)
    want_losses, want_grads, want_stats = _jax_float64_step()
    losses, got_grads, got_stats = _port_step(port, variables, batch, torch.float64)
    assert set(losses) == set(want_losses)
    assert any(k.startswith("acc_") for k in losses)
    for k, v in losses.items():
        np.testing.assert_allclose(v, want_losses[k], rtol=1e-4, err_msg=k)
    for k, g in got_grads.items():
        w = want_grads[k]
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=5e-3 * max(1.0, np.abs(w).max()),
                                   err_msg=k)
    want_sd = state_dict_from_jax({"params": variables["params"], "batch_stats": want_stats})
    for k, s in got_stats.items():
        np.testing.assert_allclose(s, want_sd[k].numpy(), rtol=1e-4, atol=1e-6, err_msg=k)


def _dist(got: dict, truth: dict) -> float:
    """mean |got - truth| / max|truth| over the entries together."""
    g = np.concatenate([np.ravel(got[k]) for k in truth])
    t = np.concatenate([np.ravel(truth[k]) for k in truth])
    return float(np.abs(g - t).mean() / np.abs(t).max())


def test_bf16_train_step_against_jax_bf16(monkeypatch):
    # The batch this test was built on, cropped by numpy: the native crop's
    # batch (a few bits apart) makes the float32 step ill-conditioned here.
    # Its hidden MLPs' BatchNorms see B = 3 rows, where flax's variance
    # E[x^2] - E[x]^2 (both packages) loses about four digits, and the f32
    # step lands 3.2e-3 from float64 against JAX bf16's 1.5e-3, so the
    # control below cannot tell f32 from bf16 on it.
    monkeypatch.setenv("OPEN3DSOT_TPU_NATIVE", "0")
    port16, lg16, batch, variables = _pair(True)
    port32 = _pair(False)[0]
    params, stats = to_numpy(variables["params"]), to_numpy(variables["batch_stats"])
    g16, (l16, _) = lg16(params, stats, batch)
    l64, truth_g, _ = _jax_float64_step()
    loss_keys = [k for k in l64 if k.startswith("loss_")]
    truth_l = {k: l64[k] for k in loss_keys}
    jax_l = {k: float(l16[k]) for k in loss_keys}
    jax_g = {k: v.numpy() for k, v in state_dict_from_jax({"params": to_numpy(g16)}).items()}
    got_l, got_g, _ = _port_step(port16, variables, batch, torch.float32)
    f32_l, f32_g, _ = _port_step(port32, variables, batch, torch.float32)
    for got, f32, want, truth in ((got_l, f32_l, jax_l, truth_l), (got_g, f32_g, jax_g, truth_g)):
        d_port, d_jax, d_f32 = (_dist(x, truth) for x in (got, want, f32))
        assert 0.25 * d_jax < d_port < 4 * d_jax, (d_port, d_jax)
        assert d_f32 < 0.25 * d_jax, (d_f32, d_jax)  # the control
    # parameters, gradients and Adam's state stay float32 under bf16
    port16.net.load_state_dict(state_dict_from_jax(variables), strict=True)
    optimizer, scheduler = make_optimizer(port16.config, port16.net.parameters(), 1)
    train_step(port16, optimizer, port16.device_batch(batch), scheduler)
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in port16.net.parameters())
    assert all(v.dtype == torch.float32 for st in optimizer.state.values() for v in st.values()
               if v.is_floating_point() and v.dim() > 0)


def test_motion_sampler_and_dataset_type():
    """`train_motion` gives the motion sampler, whose samples carry every key
    the loss reads; the same numpy seed gives the JAX package's samples
    (held element for element in tests/test_torch_host_copies.py)."""
    cfg = load_config(CFG, SMALL)
    sampler = get_dataset(cfg, "train_motion", "train")
    j_sampler = j_get_dataset(j_load_config(CFG, SMALL), "train_motion", "train")
    assert type(sampler).__name__ == "MotionTrackingSampler" and len(sampler) == len(j_sampler)
    np.random.seed(1)
    sample = sampler[2]
    assert set(get_model("m2track")(cfg, device="cpu").dummy_batch(1)) <= set(sample) | {"bbox_size"}


def test_trainer_fit_validates_on_the_m2_scan_tracker(tmp_path):
    """Trainer.fit for M2-Track: validation on M2ScanTracker (built once and
    kept), checkpoints, and the accuracies logged under train/, the loss
    terms under loss/, as the JAX trainer logs them."""
    from open3dsot_tpu_torch.tracking.scan_tracker import M2ScanTracker

    cfg = load_config(CFG, dict(SMALL, batch_size=4))
    model = get_model("m2track")(cfg, device="cpu")
    model.net.load_state_dict(state_dict_from_jax(random_variables(model.net, 1)), strict=True)
    val = get_dataset(load_config(CFG, dict(SMALL, syn_num_tracklets=1)), "test", "test")
    trainer = Trainer(model, cfg, work_dir=str(tmp_path), log_every=1)
    history = trainer.fit(get_dataset(cfg, "train_motion", "train"), val, epochs=1,
                          steps_per_epoch=2)
    assert isinstance(trainer._val_scan, M2ScanTracker)
    assert history[0]["steps"] == 2 and np.isfinite(history[0]["loss"])
    assert 0 <= history[0]["precision"] <= 100
    tags = {k for line in (tmp_path / "scalars.jsonl").read_text().splitlines()
            for k in json.loads(line)}
    assert {"train/acc_seg_background", "train/acc_seg_foreground", "train/acc_motion_static",
            "train/acc_motion_dynamic", "loss/loss_total", "loss/loss_seg"} <= tags
    assert not any(t.startswith("loss/acc_") for t in tags)
    assert (tmp_path / "ckpt_best.pt").exists() and (tmp_path / "ckpt_last.pt").exists()


@pytest.mark.parametrize("bf16", [False, True])
def test_cli_trains_m2(bf16, tmp_path, capsys):
    """`main --cfg cfgs/M2_track_synthetic.yaml` (no --test) trains M2-Track,
    in bf16 with --bf16, and evaluates its checkpoint."""
    from open3dsot_tpu_torch import main as port_main

    cfg = yaml.safe_load(open(CFG))
    cfg.update(SMALL, syn_num_tracklets=1, syn_tracklet_len=4, num_candidates=1)
    path = tmp_path / "m2_small.yaml"
    path.write_text(yaml.safe_dump(cfg))
    run = tmp_path / "run"
    extra = ["--bf16"] if bf16 else []
    port_main.main(["--cfg", str(path), "--epoch", "1", "--batch_size", "2", "--device", "cpu",
                    "--log_dir", str(run)] + extra)
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("trained 2 steps; loss ")
    port_main.main(["--cfg", str(path), "--test", "--checkpoint", str(run / "ckpt_last.pt"),
                    "--device", "cpu"] + extra)
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("success/test:")
