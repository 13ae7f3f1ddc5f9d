"""The port's eval outputs: tracking/results.py (ResultsWriter,
read_results, `--save_results`) and tracking/prep_store.py (the disk prep
store, `--eval_prep_cache`), against the JAX package's.

- The writer's records are the JAX writer's, byte for byte, on the same
  trajectories; the host loop's records hold JAX's host loop's on the same
  weights; each scan eval writes what its tracker's host-scored batches
  give, in tracklet order.
- The store (as tests/test_prep_store.py holds JAX's): an eval through a
  cold store returns the plain eval's metrics, a warm store serves the
  whole eval with the sampler poisoned and builds no packed batch, a
  fingerprint mismatch raises, a store the JAX package wrote is refused,
  and sharding across processes raises.
- The CLI's two flags.
"""

from __future__ import annotations

import contextlib
import io
import json

import numpy as np
import pytest

from open3dsot_tpu.config import make_config as j_make_config
from open3dsot_tpu.data import get_dataset as j_get_dataset
from open3dsot_tpu.models import get_model as j_get_model
from open3dsot_tpu.tracking.eval import evaluate_dataset as j_evaluate
from open3dsot_tpu.tracking.results import ResultsWriter as JWriter
from open3dsot_tpu_torch.config import load_config as p_load_config
from open3dsot_tpu_torch.config import make_config as p_make_config
from open3dsot_tpu_torch.data import get_dataset as p_get_dataset
from open3dsot_tpu_torch.models import get_model
from open3dsot_tpu_torch.tracking import prep_store
from open3dsot_tpu_torch.tracking import scan_tracker as st
from open3dsot_tpu_torch.tracking.eval import evaluate_dataset
from open3dsot_tpu_torch.tracking.results import ResultsWriter, read_results
from open3dsot_tpu_torch.weights import random_variables, state_dict_from_jax
from tests._torch_port import to_numpy  # noqa: F401  (and one torch thread, as every port test)
from tests.test_prep_store import _PoisonedSampler

M2 = dict(dataset="synthetic", net_model="m2track", category_name="Car", bb_scale=1.25,
          bb_offset=2, point_sample_size=64, degrees=False, up_axis=[0, 0, 1], box_aware=True,
          use_z=True, limit_box=False, IoU_space=3, motion_threshold=0.15,
          train_type="train_motion", syn_num_tracklets=4, syn_tracklet_len=6, seed=11)
MAX_POINTS = 256


def _m2(**over):
    cfg = p_make_config(dict(M2, **over))
    model = get_model("m2track")(cfg, device="cpu")
    variables = random_variables(model.net, seed=3)
    model.net.load_state_dict(state_dict_from_jax(variables), strict=True)
    return cfg, model, variables, p_get_dataset(cfg, "test", "test")


def _bat():
    cfg = p_load_config("cfgs/BAT_synthetic.yaml", dict(syn_num_tracklets=3, syn_tracklet_len=6,
                                                        seed=5, template_size=64, search_size=128))
    model = get_model("bat")(cfg, device="cpu")
    model.net.load_state_dict(state_dict_from_jax(random_variables(model.net, seed=4)))
    return cfg, model, p_get_dataset(cfg, "test", "test")


def _lines(path) -> list:
    with open(path) as f:
        return f.read().splitlines()


def test_writer_records_equal_jax_on_the_same_tracks(tmp_path):
    """The same Box trajectories through both writers: the same file."""
    from open3dsot_tpu.geometry import Box as JBox
    from open3dsot_tpu.geometry import Quaternion as JQ
    from open3dsot_tpu_torch.geometry import Box as PBox
    from open3dsot_tpu_torch.geometry import Quaternion as PQ

    rng = np.random.default_rng(0)
    cfg = p_make_config(dict(M2, up_axis=[0, -1, 0], IoU_space=2))
    jw, pw = JWriter(str(tmp_path / "j.jsonl"), cfg), ResultsWriter(str(tmp_path / "p.jsonl"), cfg)
    for i in (0, 3, 4):
        n = int(rng.integers(2, 6))
        c, wlh, ang = rng.standard_normal((n, 3)), rng.uniform(1, 4, (n, 3)), rng.uniform(-3, 3, n)
        ious, dists = rng.uniform(0, 1, n), rng.uniform(0, 5, n)
        jw.add(i, [JBox(c[t], wlh[t], JQ(axis=[0, 0, 1], radians=ang[t])) for t in range(n)],
               ious, dists)
        pw.add(i, [PBox(c[t], wlh[t], PQ(axis=[0, 0, 1], radians=ang[t])) for t in range(n)],
               ious, dists)
    jw.close()
    pw.close()
    assert _lines(tmp_path / "p.jsonl") == _lines(tmp_path / "j.jsonl")
    header, records = read_results(str(tmp_path / "p.jsonl"))
    assert header["up_axis"] == [0, -1, 0] and [r["tracklet"] for r in records] == [0, 3, 4]


def test_host_loop_records_hold_jax(tmp_path):
    """tests/test_torch_eval.py's pair (3 tracklets x 6 frames, the same
    weights on both sides) through both writers: the same header, tracklet
    ids and frame counts, the first box exact, the trajectories and scores
    at that test's atol 1e-3, Success and Precision equal."""
    from open3dsot_tpu.config import load_config as j_load_config

    cfg_path = "cfgs/M2_track_synthetic.yaml"
    over = dict(point_sample_size=64, syn_num_tracklets=3, syn_tracklet_len=6, seed=5)
    cfg = p_load_config(cfg_path, over)
    model = get_model("m2track")(cfg, device="cpu")
    variables = random_variables(model.net, seed=11)
    model.net.load_state_dict(state_dict_from_jax(variables), strict=True)
    with ResultsWriter(str(tmp_path / "p.jsonl"), cfg) as w:
        got = evaluate_dataset(model, p_get_dataset(cfg, "test", "test"), cfg, results_writer=w)
    assert w.n_written == 3
    jcfg = j_load_config(cfg_path, over)
    jm = j_get_model("m2track")(jcfg)
    with JWriter(str(tmp_path / "j.jsonl"), jcfg) as jw:
        want = j_evaluate(jm, variables, j_get_dataset(jcfg, "test", "test"), jcfg,
                          results_writer=jw)
    assert got == want
    ph, pr = read_results(str(tmp_path / "p.jsonl"))
    jh, jr = read_results(str(tmp_path / "j.jsonl"))
    assert ph == jh
    for p, j in zip(pr, jr, strict=True):
        assert (p["tracklet"], p["n_frames"]) == (j["tracklet"], j["n_frames"])
        assert p["boxes"][0] == j["boxes"][0]  # the gt first box
        pb, jb = np.array(p["boxes"]), np.array(j["boxes"])
        np.testing.assert_allclose(pb[:, :3], jb[:, :3], atol=1e-3)  # centres
        np.testing.assert_allclose(pb[:, 6:], jb[:, 6:], atol=1e-3)  # rotations
        np.testing.assert_array_equal(pb[:, 3:6], jb[:, 3:6])  # wlh: the first box's
        np.testing.assert_allclose(p["ious"], j["ious"], atol=1e-3)
        np.testing.assert_allclose(p["distances"], j["distances"], atol=1e-3)


def _scan_records(tracker, sampler, cfg, batch_tracklets, path):
    """What a scan eval's writer should hold: the tracker's host-scored
    batches, tracklet by tracklet, through the JAX package's writer."""
    with JWriter(path, cfg) as w:
        for j in range(0, len(sampler), batch_tracklets):
            ids = range(j, min(len(sampler), j + batch_tracklets))
            for i, (ious, dists, bbs) in zip(ids, tracker.evaluate_sequences(
                    [sampler[i] for i in ids], cfg)):
                w.add(i, bbs, ious, dists)


@pytest.mark.parametrize("which", ["m2", "bat"])
def test_scan_eval_records(tmp_path, which):
    from open3dsot_tpu_torch.tracking.scan_matching import (
        MatchScanTracker,
        evaluate_dataset_scan_matching,
    )

    if which == "m2":
        cfg, model, _, sampler = _m2()
        tracker = st.M2ScanTracker(model, cfg, max_points=MAX_POINTS, frame_bucket=4)
        evaluate = st.evaluate_dataset_scan
    else:
        cfg, model, sampler = _bat()
        tracker = MatchScanTracker(model, cfg, max_points=MAX_POINTS, first_crop_points=128,
                                   frame_bucket=4)
        evaluate = evaluate_dataset_scan_matching
    with ResultsWriter(str(tmp_path / "p.jsonl"), cfg) as w:
        got = evaluate(model, sampler, cfg, tracker=tracker, batch_tracklets=2,
                       results_writer=w, prep_store_path=str(tmp_path / "ignored"))
    _scan_records(tracker, sampler, cfg, 2, str(tmp_path / "want.jsonl"))
    assert _lines(tmp_path / "p.jsonl") == _lines(tmp_path / "want.jsonl")
    _, records = read_results(str(tmp_path / "p.jsonl"))
    assert [r["tracklet"] for r in records] == list(range(len(sampler)))
    host = evaluate(model, sampler, cfg, tracker=tracker, batch_tracklets=2,
                    device_metrics=False)
    assert got == host


def _count_prepares(monkeypatch) -> list:
    calls = []
    real = st._ScanTracker._prepare

    def counted(self, sequences):
        calls.append(len(sequences))
        return real(self, sequences)

    monkeypatch.setattr(st._ScanTracker, "_prepare", counted)
    return calls


@pytest.mark.parametrize("which", ["m2", "m2_int16", "bat"])
def test_store_cold_equals_plain_and_warm_builds_nothing(tmp_path, monkeypatch, which):
    from open3dsot_tpu_torch.tracking.scan_matching import (
        MatchScanTracker,
        evaluate_dataset_scan_matching,
    )

    if which == "bat":
        cfg, model, sampler = _bat()
        tracker = MatchScanTracker(model, cfg, max_points=MAX_POINTS, first_crop_points=128,
                                   frame_bucket=4)
        evaluate = evaluate_dataset_scan_matching
    else:
        cfg, model, _, sampler = _m2(transfer_quant="int16" if which == "m2_int16" else None)
        tracker = st.M2ScanTracker(model, cfg, max_points=MAX_POINTS, frame_bucket=4)
        evaluate = st.evaluate_dataset_scan
    kw = dict(tracker=tracker, batch_tracklets=2)
    plain = evaluate(model, sampler, cfg, **kw)
    path = str(tmp_path / "store")
    calls = _count_prepares(monkeypatch)
    cold = evaluate(model, sampler, cfg, prep_store_path=path, **kw)
    assert cold == plain and len(calls) == -(-len(sampler) // 2)
    calls.clear()
    warm = evaluate(model, _PoisonedSampler(len(sampler)), cfg, prep_store_path=path, **kw)
    assert warm == plain and calls == []
    # a host-scored eval does not take the store's stubs
    assert evaluate(model, sampler, cfg, prep_store_path=path, device_metrics=False, **kw) == \
        evaluate(model, sampler, cfg, device_metrics=False, **kw)


def test_store_refuses_other_fingerprints_jax_stores_and_sharding(tmp_path):
    from open3dsot_tpu.tracking.prep_store import eval_store as j_eval_store

    cfg, model, _, sampler = _m2()
    tracker = st.M2ScanTracker(model, cfg, max_points=MAX_POINTS, frame_bucket=4)
    path = str(tmp_path / "store")
    prep_store.eval_store(path, cfg, tracker, n=len(sampler), batch_tracklets=2)
    with pytest.raises(ValueError, match="different fingerprint"):
        prep_store.eval_store(path, cfg, tracker, n=len(sampler), batch_tracklets=3)
    # a store the JAX package wrote, for a tracker of the same name and settings
    jax_path = str(tmp_path / "jax_store")
    jax_tracker = type("M2ScanTracker", (), dict(max_points=MAX_POINTS, frame_bucket=4,
                                                 transfer_dtype=None, _mesh_size=1))()
    j_eval_store(jax_path, j_make_config(M2), jax_tracker, n=len(sampler), batch_tracklets=2)
    with open(f"{jax_path}/meta.json") as f:
        assert "package" not in json.load(f)["fingerprint"]
    with pytest.raises(ValueError, match="different fingerprint"):
        prep_store.eval_store(jax_path, cfg, tracker, n=len(sampler), batch_tracklets=2)
    # sharding is taken: in a world of one the stripe is the whole, and the
    # store is the unsharded one (tests/test_torch_distributed_eval.py holds
    # the stripes' directories of a two-rank world)
    sharded = prep_store.eval_store(path, cfg, tracker, n=len(sampler), batch_tracklets=2,
                                    shard_across_processes=True)
    assert sharded.path == path and sharded._fingerprint["shard"] == [0, 1]


def test_store_round_trips_the_packed_batch(tmp_path):
    """(host, gt) lists of tensors, int16 tuples, None: written as numpy,
    read back as tensors equal to what went in."""
    import torch

    store = prep_store.PackedPrepStore(str(tmp_path / "s"), {"k": 1})
    value = ([torch.arange(6, dtype=torch.int16).reshape(2, 3), torch.ones(2, 4)],
             [torch.zeros(3, dtype=torch.float64)], (None, np.float32(2.5)))
    store[("prep", 0)] = value
    store["batches"] = [[[0] * 3, [0] * 5]]
    again = prep_store.PackedPrepStore(str(tmp_path / "s"), {"k": 1})
    assert "batches" in again and [len(s) for s in again["batches"][0]] == [3, 5]
    got = again[("prep", 0)]
    assert isinstance(got[0], list) and isinstance(got[2], tuple) and got[2][0] is None
    for a, b in zip(got[0] + got[1], value[0] + value[1]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got[2][1] == np.float32(2.5)


@pytest.mark.parametrize("kind", ["sweep", "ties", "small"])
def test_pad_frame_of_a_sweep_matches_jax(kind):
    """pad_frame's nearest-P cut by partition (scan_tracker.nearest) gives
    JAX's stable-argsort cut bit for bit: a LiDAR sweep's 120000 points, a
    frame of integer coordinates (many equal distances), a small frame."""
    from open3dsot_tpu.tracking.scan_tracker import pad_frame as j_pad

    rng = np.random.default_rng({"sweep": 0, "ties": 1, "small": 2}[kind])
    if kind == "sweep":
        pts, P = rng.uniform(-40, 40, (120000, 3)).astype(np.float32), 4096
    elif kind == "ties":
        pts, P = rng.integers(-3, 4, (5000, 3)).astype(np.float32), 777
    else:
        pts, P = rng.normal(0, 5, (300, 3)).astype(np.float32), 299
    for got, want in zip(st.pad_frame(pts, P), j_pad(pts, P)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    d = rng.integers(0, 4, 1000).astype(np.float32)
    d[[3, 500]] = np.nan
    for P in (1, 10, 997, 999):
        np.testing.assert_array_equal(st.nearest(d, P), np.argsort(d, kind="stable")[:P])


def _main(argv) -> str:
    from open3dsot_tpu_torch.main import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def test_cli_save_results_and_eval_prep_cache(tmp_path, monkeypatch):
    """--save_results on both trackers; --eval_prep_cache: the second run
    builds no packed batch and prints the first's Success/Precision."""
    base = ["--cfg", "cfgs/M2_track_synthetic.yaml", "--test", "--device", "cpu",
            "--max_tracklets", "3"]
    host = _main(base + ["--save_results", str(tmp_path / "host.jsonl")])
    header, records = read_results(str(tmp_path / "host.jsonl"))
    assert header["net_model"].lower() == "m2track" and len(records) == 3
    assert "saved 3 tracklet trajectories" in host
    assert host.strip().splitlines()[-1].startswith("success/test:")
    scan = base + ["--tracker", "scan"]
    _main(scan + ["--save_results", str(tmp_path / "scan.jsonl")])
    assert [r["tracklet"] for r in read_results(str(tmp_path / "scan.jsonl"))[1]] == [0, 1, 2]
    calls = _count_prepares(monkeypatch)
    cold = _main(scan + ["--eval_prep_cache", str(tmp_path / "cache")])
    assert calls and (tmp_path / "cache" / "meta.json").is_file()
    calls.clear()
    warm = _main(scan + ["--eval_prep_cache", str(tmp_path / "cache")])
    assert calls == []
    assert warm.strip().splitlines()[-1] == cold.strip().splitlines()[-1]
