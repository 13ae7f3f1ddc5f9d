"""The port's span recorder (open3dsot_tpu_torch/utils/profiling.py) and the
spans its layers record, on the CPU: nothing without a profiler or a
`recording()` block, a span's name, parent, thread and attributes under a
profiler, its stamps on the profiler's own clock, the ring that drops the
oldest spans, self time, and the spans an eager scan eval, an online step
and a short `Trainer.fit` record."""

from __future__ import annotations

import sys
import threading
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from open3dsot_tpu_torch.config import load_config, make_config
from open3dsot_tpu_torch.data import get_dataset
from open3dsot_tpu_torch.models import get_model
from open3dsot_tpu_torch.tracking import online, scan_tracker
from open3dsot_tpu_torch.train.trainer import Trainer
from open3dsot_tpu_torch.utils import profiling

CLOCK_NS = 100_000  # a span's start against its own profiler range's


@pytest.fixture(autouse=True)
def empty_store():
    profiling.clear()
    yield
    profiling.clear()


def _names(spans) -> list:
    return [s.name for s in spans]


def _by_name(spans) -> dict:
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_nothing_recorded_without_a_profiler(monkeypatch):
    """No profiler, no recording(): a site stores nothing, counts nothing,
    and opens no profiler range or NVTX range."""

    def opened(*a, **k):
        raise AssertionError("a range was opened")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", opened)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", opened)
    for _ in range(1000):  # the first calls fill the interpreter's free lists
        with profiling.annotate("graph.replay"):
            pass
    blocks = sys.getallocatedblocks()
    for _ in range(10000):
        with profiling.annotate("scan.frame_loop", card=0, B=16, T=48):
            pass
        profiling.count("frames", 16)
    assert sys.getallocatedblocks() - blocks < 100  # no block kept a call
    assert profiling.records() == [] and profiling.counters() == {}
    assert profiling.dropped() == 0


def test_span_recorded_under_a_profiler():
    """Name, parent, thread and attributes; the stamps lie within 100 us of
    the span's own profiler range (the shared clock) and inside it."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.annotate("outer.span", card=0, B=2, T=5):
            with profiling.annotate("inner.span"):
                torch.ones(8).sum()
            profiling.count("things", 3)
    spans = _by_name(profiling.records())
    (outer,), (inner,) = spans["outer.span"], spans["inner.span"]
    assert outer.parent is None and inner.parent == outer.id
    assert outer.thread == inner.thread == threading.get_native_id()
    assert outer.attrs == {"card": 0, "B": 2, "T": 5} and inner.attrs == {}
    assert outer.start_ns <= inner.start_ns < inner.end_ns <= outer.end_ns
    assert profiling.counters() == {"things": 3}
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    for s in (outer, inner):
        ev = events[s.name]
        assert abs(s.start_ns - ev.start_ns()) < CLOCK_NS
        assert abs(s.end_ns - ev.end_ns()) < CLOCK_NS
        assert ev.start_ns() <= s.start_ns and s.end_ns <= ev.end_ns()
    # the profiler is off again: nothing more is stored
    with profiling.annotate("after"):
        pass
    assert len(profiling.records()) == 2


def test_recording_block_and_threads():
    """recording() records with no profiler, nested too, and stops at its
    end; each thread keeps its own stack of open spans."""
    seen = {}

    def worker():
        with profiling.annotate("in.thread"):
            pass
        seen["tid"] = threading.get_native_id()

    with profiling.recording():
        with profiling.recording():
            with profiling.annotate("a"):
                t = threading.Thread(target=worker)
                t.start()
                t.join(timeout=30)
        with profiling.annotate("b"):
            pass
    assert not t.is_alive()
    with profiling.annotate("c"):
        pass
    spans = _by_name(profiling.records())
    assert set(spans) == {"a", "b", "in.thread"}
    assert spans["in.thread"][0].parent is None  # another thread: no parent
    assert spans["in.thread"][0].thread == seen["tid"] != spans["a"][0].thread


def test_ring_drops_the_oldest_and_counts_them(monkeypatch):
    monkeypatch.setattr(profiling, "CAPACITY", 3)
    profiling.clear()
    with profiling.recording():
        for i in range(5):
            with profiling.annotate(f"s{i}"):
                pass
    assert _names(profiling.records()) == ["s2", "s3", "s4"]
    assert profiling.dropped() == 2
    profiling.clear()
    assert profiling.records() == [] and profiling.dropped() == 0


def test_summary_self_time_subtracts_the_children():
    S = profiling.Span
    spans = [S("child", 10, 30, 1, 0, 7, {}), S("grand", 12, 20, 2, 1, 7, {}),
             S("child", 40, 70, 3, 0, 7, {}), S("parent", 0, 100, 0, None, 7, {}),
             S("parent", 200, 210, 4, None, 7, {})]
    got = profiling.summary(spans)
    assert got["parent"] == {"count": 2, "total_ns": 110, "self_ns": 60}
    assert got["child"] == {"count": 2, "total_ns": 50, "self_ns": 42}
    assert got["grand"] == {"count": 1, "total_ns": 8, "self_ns": 8}


def test_eager_scan_eval_records_its_spans():
    """The eager M2 scan eval: one batch prepared, tracked in one frame loop
    (its B and padded T) and scored; no graph, no wait on the CPU."""
    cfg = load_config("cfgs/M2_track_synthetic.yaml",
                      dict(point_sample_size=64, syn_num_tracklets=3, syn_tracklet_len=6, seed=5))
    torch.manual_seed(0)
    model = get_model("m2track")(cfg, device="cpu")
    model.net.eval()
    with profiling.recording():
        scan_tracker.evaluate_dataset_scan(model, get_dataset(cfg, "test", "test"), cfg,
                                           max_points=256)
    spans = _by_name(profiling.records())
    assert {n: len(v) for n, v in spans.items()} == {"scan.prepare": 1, "scan.frame_loop": 1,
                                                       "scan.score": 1}
    loop = spans["scan.frame_loop"][0]
    assert loop.attrs == {"card": None, "B": 3, "T": 16} and loop.parent is None


MATCH = dict(dataset="synthetic", net_model="bat", category_name="Car", search_bb_scale=1.25,
             search_bb_offset=2, model_bb_scale=1.25, model_bb_offset=0, template_size=64,
             search_size=128, degrees=True, up_axis=[0, 0, 1], data_limit_box=False,
             train_type="train_siamese", num_candidates=1, normalize_xyz=False,
             feature_channel=32, hidden_channel=32, out_channel=32, vote_channel=32,
             num_proposal=16, k=4, bc_channel=9, box_aware=True, use_fps=True,
             reference_BB="previous_result", shape_aggregation="firstandprevious", use_z=True,
             limit_box=False, IoU_space=3, syn_num_tracklets=2, syn_tracklet_len=4, seed=0,
             tensorboard=False)


def test_online_step_after_two_resets_records_its_spans():
    """Two resets, then one step: two `online.reset`, one `online.pack`, one
    `online.fetch`, none nested; no graph replay on the eager path."""
    cfg = make_config(MATCH)
    torch.manual_seed(0)
    model = get_model("bat")(cfg, device="cpu")
    model.net.eval()
    seqs = [get_dataset(cfg, "test", "test")[i] for i in range(2)]
    tracker = online.OnlineMatchTracker(model, cfg, max_streams=2, max_points=256,
                                        first_crop_points=128)
    with profiling.recording():
        for slot, seq in enumerate(seqs):
            tracker.reset(slot, seq[0]["pc"], seq[0]["3d_bbox"])
        boxes = tracker.step({slot: seq[1]["pc"].points.T.astype(np.float32)
                              for slot, seq in enumerate(seqs)})
    assert sorted(boxes) == [0, 1]
    spans = profiling.records()
    assert _names(spans) == ["online.reset", "online.reset", "online.pack", "online.fetch"]
    assert all(s.parent is None for s in spans)


def test_short_fit_records_build_update_and_fetch(tmp_path):
    """A 3-step `fit` with the samples built on the device: a build and an
    update a step, the first step's loss read under its update, the
    epoch's checkpoint; no synchronisation span on the CPU."""
    cfg = load_config("cfgs/M2_track_synthetic.yaml",
                      dict(point_sample_size=64, batch_size=4, syn_num_tracklets=2,
                           syn_tracklet_len=6, device_sampler=True, max_raw_points=256,
                           tensorboard=False))
    torch.manual_seed(0)
    model = get_model("m2track")(cfg, device="cpu")
    data = types.SimpleNamespace(dataset=get_dataset(cfg, cfg.train_type, "train").dataset)
    trainer = Trainer(model, cfg, work_dir=str(tmp_path))
    with profiling.recording():
        trainer.fit(data, None, epochs=1, steps_per_epoch=3)
    spans = profiling.records()
    assert {n: len(v) for n, v in _by_name(spans).items()} == {
        "train.sample_build": 3, "train.update": 3, "train.fetch": 1, "train.checkpoint": 1}
    updates = [s for s in spans if s.name == "train.update"]
    (fetch,) = [s for s in spans if s.name == "train.fetch"]
    assert fetch.parent == updates[0].id
    summary = profiling.summary(spans)["train.update"]
    assert summary["self_ns"] == summary["total_ns"] - (fetch.end_ns - fetch.start_ns)
