"""Process-sharded evals of the port (`shard_across_processes`, its CLI's
`--num_devices`) against the JAX package's unsharded evals, on the CPU.

One two-rank gloo world (tests/_torch_dist.py) runs the host-loop and scan
evals of M2-Track and BAT (the weights and data of
tests/test_torch_scan_tracker.py and tests/test_torch_scan_matching.py):
tracklets 0 and 2 on rank 0, 1 on rank 1, the metric states summed. The
JAX references run here, unsharded. Success/Precision must be equal: the
metric states are integer counts, summed exactly.
"""

from __future__ import annotations

import json
from types import SimpleNamespace

import numpy as np
import pytest

from open3dsot_tpu.config import load_config as j_load_config
from open3dsot_tpu.config import make_config as j_make_config
from open3dsot_tpu.data import get_dataset as j_get_dataset
from open3dsot_tpu.models import get_model as j_get_model
from open3dsot_tpu.tracking import scan_matching as jsm
from open3dsot_tpu.tracking import scan_tracker as js
from open3dsot_tpu.tracking.eval import evaluate_dataset as j_evaluate_dataset
from open3dsot_tpu_torch import main as port_main
from open3dsot_tpu_torch.config import load_config, make_config
from open3dsot_tpu_torch.models import get_model
from open3dsot_tpu_torch.weights import random_variables, state_dict_from_jax
from tests._torch_dist import REPO, run_world

M2 = dict(point_sample_size=64, syn_num_tracklets=3, syn_tracklet_len=6, seed=5)
BAT = dict(dataset="synthetic", net_model="bat", category_name="Car", search_bb_scale=1.25,
           search_bb_offset=2, model_bb_scale=1.25, model_bb_offset=0, template_size=64,
           search_size=128, degrees=True, up_axis=[0, 0, 1], data_limit_box=False,
           train_type="train_siamese", num_candidates=1, normalize_xyz=False, feature_channel=32,
           hidden_channel=32, out_channel=32, vote_channel=32, num_proposal=16, k=4,
           bc_channel=9, reference_BB="previous_result", shape_aggregation="firstandprevious",
           use_z=True, limit_box=False, IoU_space=3, syn_num_tracklets=3, syn_tracklet_len=5,
           seed=0, tensorboard=False, box_aware=True, use_fps=True)
SCAN_KW = {"m2track": dict(max_points=256, frame_bucket=4),
           "bat": dict(max_points=256, first_crop_points=128, frame_bucket=4)}


@pytest.fixture(autouse=True)
def numpy_crop(monkeypatch):
    """The JAX package's numpy crop, which the port copies
    (tests/test_torch_scan_matching.py)."""
    monkeypatch.setenv("OPEN3DSOT_TPU_NATIVE", "0")


# --- the models, weights and inputs both sides take ------------------------

def _eval_pair(net: str):
    if net == "m2track":
        jcfg, pcfg = j_load_config("cfgs/M2_track_synthetic.yaml", M2), \
            load_config("cfgs/M2_track_synthetic.yaml", M2)
    else:
        jcfg, pcfg = j_make_config(BAT), make_config(BAT)
    port = get_model(net)(pcfg, device="cpu")
    variables = random_variables(port.net, seed=11 if net == "m2track" else 3)
    return j_get_model(net)(jcfg), variables, jcfg, pcfg


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jobs = {}
    for net in ("m2track", "bat"):
        _, variables, _, pcfg = _eval_pair(net)
        common = dict(kind="eval", cfg=pcfg.to_dict(), state_dict=state_dict_from_jax(variables))
        jobs[f"host-{net}"] = dict(common, path="host")
        jobs[f"scan-{net}"] = dict(common, path="scan", kw=SCAN_KW[net])
    return run_world(jobs, tmp_path_factory.mktemp("world"))


# --- sharded evals ------------------------------------------------------------------

@pytest.mark.parametrize("net", ["m2track", "bat"])
@pytest.mark.parametrize("path", ["host", "scan"])
def test_sharded_eval_equals_jax_unsharded(world, net, path):
    """Tracklets 0, 2 on rank 0 and 1 on rank 1, the metric states summed:
    every rank returns JAX's unsharded Success/Precision."""
    jm, variables, jcfg, _ = _eval_pair(net)
    sampler = j_get_dataset(jcfg, "test", "test")
    if path == "host":
        want = j_evaluate_dataset(jm, variables, sampler, jcfg)
    elif net == "m2track":
        tracker = js.M2ScanTracker(jm, variables, jcfg, **SCAN_KW[net])
        want = js.evaluate_dataset_scan(jm, variables, sampler, jcfg, tracker=tracker)
    else:
        tracker = jsm.MatchScanTracker(jm, variables, jcfg, **SCAN_KW[net])
        want = jsm.evaluate_dataset_scan_matching(jm, variables, sampler, jcfg, tracker=tracker)
    for rank in world:
        got = rank[f"{path}-{net}"]
        assert np.isfinite(got).all()
        assert tuple(got) == tuple(float(v) for v in want)


# --- the CLI -------------------------------------------------------------------------

def test_cli_num_devices_shards_the_eval_over_two_cpu_ranks(tmp_path, capfd):
    """`--num_devices 2` on the CPU starts two gloo ranks, which print the
    one-process eval's scores; `--save_results` writes each rank's
    tracklets, rank 1 to its own file."""
    base = ["--cfg", "cfgs/M2_track_synthetic.yaml", "--device", "cpu", "--test",
            "--max_tracklets", "2"]
    port_main.main(base)
    want = capfd.readouterr().out.strip().splitlines()[-1]
    port_main.main(base + ["--num_devices", "2", "--save_results", str(tmp_path / "r.jsonl")])
    got = [line for line in capfd.readouterr().out.splitlines() if line.startswith("success")]
    assert got == [want] and want.startswith("success/test:")
    ids = sorted(json.loads(line)["tracklet"] for name in ("r.jsonl", "r.rank1.jsonl")
                 for line in (tmp_path / name).read_text().splitlines()[1:])
    assert ids == [0, 1]


def test_prep_store_keeps_one_store_a_rank(monkeypatch, tmp_path):
    """Sharded, each rank's packed batches go to `shard_{r}_of_{n}` under the
    one --eval_prep_cache directory, with the stripe in the fingerprint, as
    the JAX package's store; unsharded, to the directory itself."""
    from open3dsot_tpu_torch.parallel import distributed
    from open3dsot_tpu_torch.tracking.prep_store import eval_store

    _, _, _, pcfg = _eval_pair("m2track")
    tracker = SimpleNamespace(max_points=256, frame_bucket=4, transfer_dtype=None,
                              device=SimpleNamespace(type="cpu"))
    one = eval_store(str(tmp_path), pcfg, tracker, 3, 16)
    assert one.path == str(tmp_path) and one._fingerprint["shard"] == [0, 1]
    monkeypatch.setattr(distributed, "world_size", lambda: 2)
    for r in range(2):
        monkeypatch.setattr(distributed, "rank", lambda r=r: r)
        store = eval_store(str(tmp_path), pcfg, tracker, 3, 16, shard_across_processes=True)
        assert store.path == str(tmp_path / f"shard_{r}_of_2")
        assert store._fingerprint["shard"] == [r, 2]


def test_cli_launches_the_gcd_of_batch_and_devices_and_checks_the_world(monkeypatch):
    """Training: a global batch of 3 over --num_devices 2 starts gcd(3, 2) = 1
    rank (JAX's Trainer shrinks its mesh so); under a launcher whose world
    is not --num_devices, or does not divide the batch, the CLI refuses."""
    args = port_main.parse_args(["--cfg", "x", "--num_devices", "2"])
    assert port_main.ranks_to_launch(args, SimpleNamespace(batch_size=3)) == 1
    assert port_main.ranks_to_launch(args, SimpleNamespace(batch_size=4)) == 2
    argv = ["--cfg", "cfgs/M2_track_synthetic.yaml", "--device", "cpu", "--batch_size", "3"]
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="--num_devices 4 but the launcher started 2"):
        port_main.main(argv + ["--num_devices", "4"])
    with pytest.raises(ValueError, match="batch_size 3 does not divide over the launcher's 2"):
        port_main.main(argv)
