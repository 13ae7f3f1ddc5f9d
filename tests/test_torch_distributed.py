"""Data-parallel training of the port (parallel/distributed.py,
train/trainer.py) against the JAX package, on the CPU; the sharded evals
are in tests/test_torch_distributed_eval.py.

One two-rank gloo world (tests/_torch_dist.py) runs every job of this file
once (`world`): one data-parallel BAT train step in float64 in each
BatchNorm mode, and K6's plain version with the statistics summed over the
ranks. The JAX references run here, in the test process, on the 8 virtual
CPU devices of tests/conftest.py.

Tolerances: the train step at tests/test_torch_train.py's float64
ones (losses rtol 1e-6, gradients rtol 1e-5 and atol 1e-5 * max(1, max|g|),
running statistics rtol 1e-6 and atol 1e-8), the gradient read as the step
of SGD at learning rate 1 on both sides; K6 over two ranks against the
global batch rtol 1e-9 (float64, sums in another order).
"""

from __future__ import annotations

import json
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from open3dsot_tpu.config import load_config as j_load_config
from open3dsot_tpu.config import make_config as j_make_config
from open3dsot_tpu.data import get_dataset as j_get_dataset
from open3dsot_tpu.models import get_model as j_get_model
from open3dsot_tpu.parallel import make_mesh
from open3dsot_tpu.tracking import scan_matching as jsm
from open3dsot_tpu.tracking import scan_tracker as js
from open3dsot_tpu.tracking.eval import evaluate_dataset as j_evaluate_dataset
from open3dsot_tpu.train.trainer import TrainState, make_train_step
from open3dsot_tpu_torch.config import load_config, make_config
from open3dsot_tpu_torch.data import get_dataset
from open3dsot_tpu_torch.data.loader import collate
from open3dsot_tpu_torch.models import get_model
from open3dsot_tpu_torch.ops import sa_fused_train as k6
from open3dsot_tpu_torch.parallel import distributed
from open3dsot_tpu_torch.weights import random_variables, state_dict_from_jax
from tests._torch_dist import run_world
from tests._torch_port import to_numpy

REPO = Path(__file__).resolve().parents[1]
TRAIN = dict(template_size=64, search_size=128, feature_channel=32, hidden_channel=32,
             out_channel=32, vote_channel=32, num_proposal=8, syn_num_tracklets=2,
             syn_tracklet_len=5, seed=3, tensorboard=False, dataset="synthetic")
K6_SHAPE = dict(B=4, N=32, S=8, K=8, C1=8, C2=12, C3=16)

def _biases_before_bn_zeroed(variables):
    def walk(params):
        for v in params.values():
            if hasattr(v, "items"):
                if "dense" in v and "bn" in v:
                    v["dense"]["bias"] = np.zeros_like(v["dense"]["bias"])
                walk(v)

    walk(variables["params"])
    return variables


def _train_inputs():
    over = dict(TRAIN, gradient_clip_val=0.0)
    jcfg = j_load_config("cfgs/BAT_synthetic.yaml", dict(over, fused_sa=False, fused_sa_train=False))
    pcfg = load_config("cfgs/BAT_synthetic.yaml", over)
    port = get_model("bat")(pcfg, device="cpu")
    variables = _biases_before_bn_zeroed(random_variables(port.net, seed=4))
    np.random.seed(0)
    sampler = get_dataset(pcfg, "train_siamese", "train")
    batch = collate([sampler[i] for i in (1, 6, 3, 8)])
    return jcfg, pcfg, variables, batch


def _k6_inputs():
    rng = np.random.default_rng(7)
    s = K6_SHAPE
    B, N, S, K, C1, C2, C3 = (s[k] for k in ("B", "N", "S", "K", "C1", "C2", "C3"))
    rows = {"a": rng.standard_normal((B, N, C1)), "ct": rng.standard_normal((B, S, C1)),
            "idx": rng.integers(0, N, (B, S, K)).astype(np.int32),
            "g": rng.standard_normal((B, S, C3))}
    weights = {"w2": rng.standard_normal((C1, C2)) * 0.3, "b2": np.zeros(C2),
               "w3": rng.standard_normal((C2, C3)) * 0.3, "b3": np.zeros(C3)}
    for i, c in enumerate((C1, C2, C3), 1):
        weights[f"g{i}"] = rng.uniform(0.5, 1.5, c)
        weights[f"bt{i}"] = rng.standard_normal(c) * 0.1
    return rows, weights


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jobs = {}
    _, pcfg, variables, batch = _train_inputs()
    for per_device in (False, True):
        jobs[f"train-{per_device}"] = dict(kind="train", cfg=pcfg.to_dict(),
                                           state_dict=state_dict_from_jax(variables),
                                           batch=batch, per_device=per_device)
    rows, weights = _k6_inputs()
    jobs["k6"] = dict(kind="k6", rows=rows, weights=weights)
    return run_world(jobs, tmp_path_factory.mktemp("world"))


# --- data-parallel training ---------------------------------------------------------

def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _grad_close(got, want, name):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale, err_msg=name)


@pytest.mark.parametrize("per_device", [False, True], ids=["global_stats", "dp_shard_map"])
def test_two_rank_train_step_equals_jax_mesh_step(world, per_device):
    """One step on two ranks (one BAT sample pair each) against JAX's
    make_train_step on make_mesh(2): GSPMD (statistics and losses over the
    global batch; the port's K6 plain version with the summed statistics in
    the backbone) or dp_shard_map (each device's own, pmean'd)."""
    jcfg, _, variables, batch = _train_inputs()
    with jax.enable_x64(True):
        jm = j_get_model("bat")(jcfg)
        tx = optax.sgd(1.0)
        params, stats = _f64(variables["params"]), _f64(variables["batch_stats"])
        state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                           opt_state=tx.init(params))
        step = make_train_step(jm, tx, mesh=make_mesh(2), donate=False, dp_shard_map=per_device)
        new, want_losses = step(state, _f64(batch))
        new_params, new_stats = to_numpy(new.params), to_numpy(new.batch_stats)
        want_losses = {k: float(v) for k, v in want_losses.items()}
    before = state_dict_from_jax({"params": to_numpy(variables["params"])})
    after = state_dict_from_jax({"params": new_params, "batch_stats": new_stats})
    for rank in world:
        losses, sd = rank[f"train-{per_device}"]
        assert set(losses) == set(want_losses)
        for k, v in losses.items():
            np.testing.assert_allclose(v, want_losses[k], rtol=1e-6, err_msg=k)
        for k, p in before.items():
            want_g = p.numpy().astype(np.float64) - after[k].numpy().astype(np.float64)
            _grad_close(p.numpy().astype(np.float64) - sd[k], want_g, k)
        for k, v in sd.items():
            if "running" in k:
                np.testing.assert_allclose(v, after[k].numpy(), rtol=1e-6, atol=1e-8, err_msg=k)


def test_staged_k6_plain_over_two_ranks_equals_the_global_batch(world):
    """K6's plain version with the statistics and the BN backward's sums
    summed over the ranks: each rank's rows of the output, da and dct are
    the global batch's, its statistics are the global ones, and its dW,
    dgamma and dbeta add up over the ranks to the global batch's."""
    rows, weights = _k6_inputs()
    x = {k: torch.from_numpy(v) for k, v in rows.items()}
    w = {k: torch.from_numpy(v) for k, v in weights.items()}
    bn = [w[k] for k in ("g1", "bt1", "g2", "bt2", "g3", "bt3")]
    out, stats, grids = k6.sa_train_fwd_plain(x["a"], x["ct"], x["idx"], w["w2"], w["b2"], w["w3"],
                                              w["b3"], bn)
    da, dct, dw2, dw3, dbn = k6.sa_train_bwd_plain(x["g"], x["a"], x["ct"], x["idx"], grids, stats,
                                                   w["w2"], w["b2"], w["w3"], w["b3"], bn)
    b = K6_SHAPE["B"] // 2
    close = dict(rtol=1e-9, atol=1e-12)
    for r, rank in enumerate(world):
        got_out, got_stats, (g_da, g_dct, _, _), _ = rank["k6"]
        np.testing.assert_allclose(got_out, out[r * b:(r + 1) * b].numpy(), **close)
        for g, s in zip(got_stats, stats):
            np.testing.assert_allclose(g, s.numpy(), **close)
        np.testing.assert_allclose(g_da, da[r * b:(r + 1) * b].numpy(), **close)
        np.testing.assert_allclose(g_dct, dct[r * b:(r + 1) * b].numpy(), **close)
    for i, want in ((2, dw2), (3, dw3)):
        np.testing.assert_allclose(sum(rank["k6"][2][i] for rank in world), want.numpy(), **close)
    for i, want in enumerate(dbn):
        np.testing.assert_allclose(sum(rank["k6"][3][i] for rank in world), want.numpy(), **close)


# --- the device sampler's draws in the global mode ----------------------------------

@pytest.mark.parametrize("train_type", ["train_siamese", "train_motion"])
def test_global_mode_device_build_keeps_the_global_build_rows(train_type):
    """A rank's build of its rows (shard=(rank, 2)) equals rows [rank * B/2,
    (rank + 1) * B/2) of the one-process build of the global batch, bit for
    bit: the draws are made for the global batch under one key."""
    from open3dsot_tpu_torch.data import device_sampler as ds
    from open3dsot_tpu_torch.utils import prng

    path = {"train_siamese": "cfgs/BAT_synthetic.yaml",
            "train_motion": "cfgs/M2_track_synthetic.yaml"}[train_type]
    cfg = load_config(path, dict(TRAIN, point_sample_size=64, use_augmentation=True,
                                 data_limit_box=True))
    raw_type = {"train_siamese": ds.RawSiameseSampler, "train_motion": ds.RawMotionSampler}
    raw = raw_type[train_type](get_dataset(cfg, train_type, "train").dataset, cfg,
                               max_raw_points=256)
    batch = {k: torch.from_numpy(v) for k, v in collate([raw[i] for i in range(4)]).items()}
    key = prng.fold_in(prng.prng_key(4), 3)
    whole = ds.make_builder(cfg, train_type)(batch, key)
    for r in range(2):
        part = ds.make_builder(cfg, train_type, shard=(r, 2))(
            {k: v[2 * r:2 * r + 2] for k, v in batch.items()}, key)
        for k, v in whole.items():
            assert torch.equal(part[k], v[2 * r:2 * r + 2]), k
    # the per-device key differs
    other = ds.make_builder(cfg, train_type)(batch, prng.fold_in(key, 1))
    assert not torch.equal(other["search_points" if train_type == "train_siamese"
                                 else "points"], whole["search_points" if train_type ==
                                                       "train_siamese" else "points"])


# --- the CLI and the refusals -------------------------------------------------------

def test_one_rank_joins_nothing_and_local_devices_refuses_missing_cards():
    assert distributed.init_from_env("cpu") == torch.device("cpu")
    assert not distributed.is_initialized() and distributed.world_size() == 1
    with pytest.raises(ValueError, match="cards requested"):
        distributed.local_devices(torch.cuda.device_count() + 1)
    with distributed.global_batch():
        assert not distributed.in_global_batch()  # a world of one has nothing to sum
    x = torch.randn(3, requires_grad=True)
    assert distributed.sum_over_batch(x) is x and distributed.gather_rows(x) is x


def test_trainer_refuses_a_batch_that_does_not_divide_over_the_ranks(monkeypatch, tmp_path):
    from open3dsot_tpu_torch.train.trainer import Trainer

    cfg = load_config("cfgs/M2_track_synthetic.yaml", dict(batch_size=3, tensorboard=False))
    model = get_model("m2track")(cfg, device="cpu")
    monkeypatch.setattr(distributed, "world_size", lambda: 2)
    with pytest.raises(ValueError, match="batch_size 3 does not divide over 2 ranks"):
        Trainer(model, cfg, work_dir=str(tmp_path))
