"""The trainer's features the port added beside the device sampler, on the
CPU at small sizes: resume (a run of 2 + 2 epochs across fresh `Trainer`s
equals 4 uninterrupted epochs bit for bit, with the device sampler, the
LR schedule and the BN-momentum schedule all keyed off the restored
position), a corrupt ckpt_meta.json, top-k checkpoints (-1, 0, 2; a top-k
checkpoint evaluated through the CLI's --checkpoint), the BN-momentum
schedule against JAX's `bn_momentum_schedule` and `reblend_batch_stats`,
the CLI flags, and the first step of `Trainer.fit` with the device sampler
on BAT against JAX's `make_train_step(device_builder=...)`.
"""

from __future__ import annotations

import functools
import json

import jax
import numpy as np
import pytest
import torch
import yaml

from open3dsot_tpu.train import bn_momentum as jax_bn
from open3dsot_tpu_torch.config import make_config
from open3dsot_tpu_torch.data import get_dataset
from open3dsot_tpu_torch.data.loader import collate
from open3dsot_tpu_torch.models import get_model
from open3dsot_tpu_torch.train import bn_momentum
from open3dsot_tpu_torch.train.optim import make_optimizer
from open3dsot_tpu_torch.train.trainer import Trainer
from open3dsot_tpu_torch.weights import random_variables, state_dict_from_jax
from tests._torch_port import to_numpy
from tests.test_torch_device_sampler import SIAMESE, first_step_losses

# M2-Track as JAX tests/test_trainer.py::cfg_for_trainer trains it: 2
# tracklets of 6 frames, 64 points, B = 4 (3 steps an epoch)
M2 = dict(dataset="synthetic", net_model="m2track", category_name="Car", bb_scale=1.25,
          bb_offset=2, point_sample_size=64, degrees=False, up_axis=[0, 0, 1],
          data_limit_box=True, train_type="train_motion", num_candidates=1,
          motion_threshold=0.15, box_aware=False, use_second_stage=False,
          use_prev_refinement=False, use_motion_cls=False, center_weight=2.0, angle_weight=10.0,
          seg_weight=0.1, motion_cls_seg_weight=0.1, use_z=True, limit_box=False, IoU_space=3,
          batch_size=4, epoch=4, lr=1e-3, optimizer="Adam", lr_decay_step=1, lr_decay_rate=0.5,
          wd=0.0, gradient_clip_val=1.0, check_val_every_n_epoch=1, syn_num_tracklets=2,
          syn_tracklet_len=6, seed=0, tensorboard=False, val_tracker="host")


def _trainer(tmp_path, **over):
    cfg = make_config(dict(M2, **over))
    model = get_model("m2track")(cfg, device="cpu")
    model.net.load_state_dict(state_dict_from_jax(random_variables(model.net, 1)), strict=True)
    return Trainer(model, cfg, work_dir=str(tmp_path), log_every=100), cfg


def test_chunked_fit_equals_uninterrupted(tmp_path):
    """2 + 2 epochs across fresh Trainers and models equal 4 epochs bit for
    bit (JAX tests/test_trainer.py:145-182): the device sampler with
    augmentation (its key folds in the step), the LR halving every epoch,
    the BN momentum halving every epoch."""
    over = dict(device_sampler=True, max_raw_points=256, use_augmentation=True,
                bn_decay_step=1, bn_decay_rate=0.5)
    whole, cfg = _trainer(tmp_path / "a", **over)
    sampler = get_dataset(cfg, "train_motion", "train")
    history = whole.fit(sampler, None)
    first, _ = _trainer(tmp_path / "b", **over)
    first.fit(sampler, None, epochs=2)
    second, _ = _trainer(tmp_path / "b", **over)
    resumed = second.fit(sampler, None, resume_from=str(tmp_path / "b" / "ckpt_last.pt"))
    assert [h["epoch"] for h in resumed] == [2, 3]
    assert [h["steps"] for h in resumed] == [h["steps"] for h in history[2:]] == [9, 12]
    assert [h["loss"] for h in resumed] == [h["loss"] for h in history[2:]]
    want, got = whole.model.net.state_dict(), second.model.net.state_dict()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    a = torch.load(tmp_path / "a" / "ckpt_last.pt", weights_only=True)
    b = torch.load(tmp_path / "b" / "ckpt_last.pt", weights_only=True)
    assert a["scheduler"] == b["scheduler"] and b["step"] == 12 and b["epoch"] == 3
    for sa, sb in zip(a["optimizer"]["state"].values(), b["optimizer"]["state"].values()):
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    # the rate of the next step, the 13th: epoch 4's
    assert b["optimizer"]["param_groups"][0]["lr"] == pytest.approx(1e-3 * 0.5 ** 4, rel=1e-12)
    moms = {m.momentum for m in second.model.net.modules() if isinstance(m, torch.nn.BatchNorm1d)}
    assert moms == {bn_momentum.bn_momentum_schedule(0.1, 0.5, 1)(3)} == {0.0125}


def test_resume_from_a_corrupt_meta_goes_on(tmp_path, capsys):
    """A truncated ckpt_meta.json is ignored with a warning (best_metric
    restarts at -inf) and the resumed run trains on (JAX :433-450)."""
    trainer, cfg = _trainer(tmp_path)
    sampler = get_dataset(cfg, "train_motion", "train")
    trainer.fit(sampler, None, epochs=1, steps_per_epoch=1)
    (tmp_path / "ckpt_meta.json").write_text('{"best_metric": 1.')
    resumed, _ = _trainer(tmp_path)
    history = resumed.fit(sampler, None, epochs=2, steps_per_epoch=1,
                          resume_from=str(tmp_path / "ckpt_last.pt"))
    assert [h["steps"] for h in history] == [2] and resumed.best_metric == -np.inf
    assert "WARNING: ignoring corrupt" in capsys.readouterr().out


def _epoch_files(path) -> list:
    return sorted(p.name for p in path.glob("ckpt_ep*.pt"))


@pytest.mark.parametrize("k,kept", [(-1, [0, 1, 2, 3, 4]), (0, []), (2, [1, 3])])
def test_top_k_checkpoints(k, kept, tmp_path):
    """save_top_k keeps the k best epochs by precision (-1 all, 0 none); a
    checkpoint that would be evicted at once is not written; the table
    survives in ckpt_meta.json for a resumed Trainer (JAX
    tests/test_save_top_k.py)."""
    trainer, cfg = _trainer(tmp_path, save_top_k=k)
    optimizer, scheduler = make_optimizer(cfg, trainer.model.net.parameters(), 2)
    writes = []
    real = trainer.save_checkpoint
    trainer.save_checkpoint = lambda *a: writes.append(a[-1]) or real(*a)
    for epoch, prec in enumerate([10.0, 30.0, 20.0, 40.0, 5.0]):
        trainer.save_topk_checkpoint(optimizer, scheduler, 2 * epoch, epoch, prec)
    assert _epoch_files(tmp_path) == [f"ckpt_ep{e:03d}.pt" for e in kept]
    if k == 2:
        assert writes == ["ep000", "ep001", "ep002", "ep003"]  # epoch 4 would go at once
        assert [p for p, _ in trainer._topk] == [40.0, 30.0]
    trainer._save_ckpt_meta()
    meta = json.loads((tmp_path / "ckpt_meta.json").read_text())
    assert len(meta["topk"]) == len(kept)
    fresh, _ = _trainer(tmp_path, save_top_k=k)
    fresh._load_ckpt_meta()
    assert fresh._topk == trainer._topk


def test_top_k_checkpoint_from_the_cli_loads_through_checkpoint(tmp_path, capsys):
    """Training through the CLI with --device_sampler --save_top_k 1 leaves
    one epoch checkpoint, which --test --checkpoint evaluates."""
    from open3dsot_tpu_torch import main as port_main

    cfg = yaml.safe_load(open("cfgs/M2_track_synthetic.yaml"))
    cfg.update(M2, syn_num_tracklets=1, max_raw_points=256)
    path = tmp_path / "m2.yaml"
    path.write_text(yaml.safe_dump(cfg))
    run = tmp_path / "run"
    port_main.main(["--cfg", str(path), "--epoch", "2", "--device", "cpu", "--log_dir", str(run),
                    "--device_sampler", "--save_top_k", "1"])
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("trained 2 steps; loss ")
    (ckpt,) = _epoch_files(run)
    meta = json.loads((run / "ckpt_meta.json").read_text())
    assert [p for p, _ in meta["topk"]] == [meta["best_metric"]]
    port_main.main(["--cfg", str(path), "--test", "--checkpoint", str(run / ckpt),
                    "--device", "cpu"])
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("success/test:")


@pytest.mark.parametrize("initial,decay,step", [(0.1, 0.5, 20), (0.2, 0.3, 3), (0.05, 0.9, 1)])
def test_bn_momentum_schedule_matches_jax(initial, decay, step):
    port = bn_momentum.bn_momentum_schedule(initial, decay, step)
    want = jax_bn.bn_momentum_schedule(initial, decay, step)
    assert [port(e) for e in range(120)] == [want(e) for e in range(120)]


@functools.lru_cache(maxsize=None)
def _jax_m2_train_forward():
    """JAX's M2 (box_aware) training forward, jitted once for the module."""
    from open3dsot_tpu.config import make_config as jax_make_config
    from open3dsot_tpu.models import get_model as jax_get_model

    jm = jax_get_model("m2track")(jax_make_config(dict(M2, box_aware=True)))
    return jax.jit(lambda v, b: jm.apply(v, b, train=True))


@pytest.mark.parametrize("epoch", [0, 1, 3])
def test_scheduled_momentum_matches_jax_reblend(epoch):
    """The running statistics after one training forward at the scheduled
    momentum m equal JAX's flax forward (momentum 0.9) re-blended to 1 - m
    (`reblend_batch_stats`), both in float64 (in float32 the batch
    statistics themselves differ by up to 4e-5 of |var| at the first
    layers, whose inputs carry absolute coordinates): |diff| <= 1e-6 (1 +
    |want|), seen 5e-8 (JAX's M2 keeps float32 casts under x64); a wrong
    momentum would be off by |m - m'| |batch - running|, some 1e-2."""
    m = bn_momentum.bn_momentum_schedule(0.1, 0.5, 1)(epoch)
    trainer, cfg = _trainer("unused", box_aware=True)
    model = trainer.model
    variables = random_variables(model.net, 1)
    np.random.seed(2)
    sampler = get_dataset(cfg, "train_motion", "train")
    batch = collate([sampler[i] for i in range(4)])
    def f64(tree):
        return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)

    with jax.enable_x64(True):
        _, mutated = _jax_m2_train_forward()(f64(variables), f64(batch))
        want = jax_bn.reblend_batch_stats(f64(variables["batch_stats"]), mutated["batch_stats"],
                                          jax_bn.to_flax_momentum(m))
        want = state_dict_from_jax({"params": variables["params"], "batch_stats": to_numpy(want)})
    bn_momentum.set_bn_momentum(model.net, m)
    model.net.double()
    with torch.no_grad():
        model.apply_train({k: torch.from_numpy(np.asarray(v, np.float64))
                           for k, v in batch.items()})
    got = model.net.state_dict()
    stats = [k for k in want if "running" in k]
    assert stats
    for k in stats:
        w = want[k].numpy()
        np.testing.assert_array_less(np.abs(got[k].numpy() - w), 1e-6 * (1 + np.abs(w)), err_msg=k)


@pytest.mark.parametrize("argv,want", [
    (["--save_top_k", "3", "--check_val_every_n_epoch", "2", "--preloading", "--category_name",
      "Van", "--device_sampler", "--fused_sa", "false", "--fused_sa_train", "auto"],
     dict(save_top_k=3, check_val_every_n_epoch=2, preloading=True, category_name="Van",
          device_sampler=True, fused_sa=False, fused_sa_train="auto")),
    ([], dict(save_top_k=-1, preloading=False, device_sampler=False, fused_sa="auto")),
    (["--fused_sa_train", "false", "--fused_sa", "true"],
     dict(fused_sa=True, fused_sa_train=False)),
])
def test_cli_flags_reach_the_config(argv, want, tmp_path):
    """The JAX CLI's flags (main.py:31-46) reach the config; --save_top_k and
    --preloading override the YAML even at their defaults; fused_sa /
    fused_sa_train pick the models' kernel paths (auto: on)."""
    from open3dsot_tpu_torch.main import config_of, kernel_options, parse_args

    path = tmp_path / "bat.yaml"
    path.write_text(yaml.safe_dump(dict(yaml.safe_load(open("cfgs/BAT_synthetic.yaml")),
                                        save_top_k=5, preloading=True)))
    cfg = config_of(parse_args(["--cfg", str(path)] + argv))
    for k, v in want.items():
        assert getattr(cfg, k) == v, k
    opts = kernel_options(cfg, "bat")
    assert opts == {"fused_eval": cfg.fused_sa is not False,
                    "fused_train": cfg.fused_sa_train is not False}
    assert set(kernel_options(cfg, "m2track")) == {"fused_eval"}
    sa = [m for m in get_model("bat")(cfg, device="cpu", **opts).net.backbone.modules()
          if hasattr(m, "fused_train")]
    assert sa and all((m.fused_eval, m.fused_train) == (opts["fused_eval"], opts["fused_train"])
                      for m in sa)


def test_first_fit_step_matches_jax_bat(tmp_path):
    """BAT at small widths (template 32, search 64, channels 16, 8
    proposals), augmentation and data_limit_box on, 2 candidates: loss_total
    within 1e-4 relative."""
    base = dict(SIAMESE, template_size=32, search_size=64, num_candidates=2, feature_channel=16,
                hidden_channel=16, out_channel=16, vote_channel=16, num_proposal=8, k=2,
                bc_channel=9, use_fps=True, normalize_xyz=False, objectiveness_weight=1.0,
                box_weight=0.2, seg_weight=0.1, vote_weight=1.0, bc_weight=1.0, batch_size=4,
                lr=1e-3, optimizer="Adam", lr_decay_step=20, lr_decay_rate=0.1, seed=3)
    got, want = first_step_losses(base, tmp_path)
    assert np.isfinite(got) and abs(got - want) <= 1e-4 * abs(want), (got, want)


