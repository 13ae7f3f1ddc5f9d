"""The readers of the program's own spans (metrics/_program.py and the ten
metrics on it): on spans and a device timeline made up here, on a program
that records no spans, in traced runs of the toy cells on the CPU, and (on
the card) in a traced run of each one-card cell at its own size."""

from types import SimpleNamespace

import pytest
import torch

from portbench import harness, trace
from portbench.metrics import _program
from test_portbench_faults import ONLINE, SEED, TRAIN

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
PROGRAM = [m["name"] for m in BENCH["per_layer"]
           if harness.reader_path(m["name"]).read_text().count("portbench.metrics._program")]


class Ev:
    def __init__(self, name, start, dur, kind="kernel", device="CUDA", card=0):
        self._n, self._s, self._d, self._k, self._dev, self._c = name, start, dur, kind, device, card

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def activity_type(self):
        return self._k

    def device_type(self):
        return f"DeviceType.{self._dev}"

    def device_index(self):
        return self._c


def _timeline(busy=((1000, 2000), (5000, 6000))):
    """A window of 0-10000 ns; card 0 busy over `busy`, card 1 over 0-10000."""
    evs = [Ev(trace.WINDOW, 0, 10000, kind="user_annotation", device="CPU"),
           Ev("k", 0, 10000, card=1)]
    return trace.Timeline(evs + [Ev("k", s, e - s) for s, e in busy])


def _span(i, name, start, end, parent=None):
    from open3dsot_tpu_torch.utils.profiling import Span

    return Span(name, start, end, i, parent, 1, {})


SCAN = [(1, "scan.frame_loop", 500, 3000), (2, "graph.replay", 600, 700, 1),
        (3, "graph.replay", 1500, 1800, 1), (4, "scan.frame_loop", 7000, 9000),
        (5, "graph.replay", 7100, 7300, 4), (6, "graph.replay", 9500, 9600),
        (7, "scan.frame_loop", 20000, 21000), (8, "graph.replay", 20100, 20200, 7)]
ONLINE_SPANS = [(1, "online.reset", 100, 400), (2, "online.reset", 500, 600),
                (3, "online.pack", 700, 900), (4, "graph.replay", 950, 1000),
                (5, "online.fetch", 1000, 4000), (6, "online.pack", 5000, 5400),
                (7, "graph.replay", 5400, 5430), (8, "online.fetch", 5500, 6500),
                (9, "online.pack", 7000, 7100), (10, "online.fetch", 7100, 9100),
                (11, "graph.replay", 9200, 9210)]
TRAIN_SPANS = [(1, "train.sample_build", 0, 1000), (2, "train.update", 1000, 3000),
               (3, "train.fetch", 2500, 2900, 2), (4, "train.sample_build", 3000, 3600),
               (5, "train.update", 3600, 4600), (6, "train.fetch", 4600, 9000),
               (7, "train.checkpoint", 9000, 9900)]
EXPECTED = {
    # loops 2500 + 2000 ns over the 3 replays inside them (the one outside
    # them and the loop outside the window left out)
    "scan.step_host_us": (SCAN, 1.5),
    "scan.replay_us": (SCAN, 0.2),
    # card 0 idle 0-1000, 2000-5000, 6000-10000 (8000 ns); inside the loops
    # 500-1000, 2000-3000, 7000-9000
    "scan.idle_in_frame_loop_share": (SCAN, 100.0 * 3500 / 8000),
    "online.reset_ms": (ONLINE_SPANS, 200e-6),
    "online.pack_ms": (ONLINE_SPANS, 200e-6),  # median of 200, 400, 100
    "online.replay_us": (ONLINE_SPANS, 0.03),  # mean of 50, 30, 10
    "online.fetch_wait_ms": (ONLINE_SPANS, 2000e-6),  # median of 3000, 1000, 2000
    "train.build_host_ms_per_step": (TRAIN_SPANS, 1600e-6 / 2),
    # update self times 2000 - 400 and 1000
    "train.update_host_ms_per_step": (TRAIN_SPANS, 2600e-6 / 2),
    "train.sync_wait_ms_per_step": (TRAIN_SPANS, 4800e-6 / 2),
}


@pytest.fixture
def recorded(monkeypatch):
    """Make `profiling.records()` return the given spans."""
    from open3dsot_tpu_torch.utils import profiling

    def give(rows):
        spans = [_span(*r) for r in rows]
        monkeypatch.setattr(profiling, "records", lambda: list(spans))

    return give


def test_every_new_metric_has_a_case():
    assert sorted(PROGRAM) == sorted(EXPECTED)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_made_up_spans(name, recorded):
    rows, want = EXPECTED[name]
    recorded(rows)
    run = SimpleNamespace(counters={"timeline": _timeline()})
    assert harness.reader(name).read(run) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_finds_nothing_in_a_program_without_spans(name, monkeypatch):
    """A program whose profiling module has no `records` (the port before it
    recorded spans), and one that recorded none in the window: None."""
    from open3dsot_tpu_torch.utils import profiling

    run = SimpleNamespace(counters={"timeline": _timeline()})
    monkeypatch.setattr(profiling, "records", lambda: [_span(1, "other", 0, 10)])
    assert harness.reader(name).read(run) is None
    monkeypatch.delattr(profiling, "records")
    assert harness.reader(name).read(run) is None


def test_idle_share_with_no_idle_time_is_none(recorded):
    recorded(SCAN)
    run = SimpleNamespace(counters={"timeline": _timeline(busy=((0, 10000),))})
    assert harness.reader("scan.idle_in_frame_loop_share").read(run) is None


def test_interval_arithmetic():
    assert _program.union([(5, 9), (0, 2), (1, 3), (9, 10)]) == [[0, 3], [5, 10]]
    assert _program.overlap_ns([[0, 3], [5, 10]], [[2, 6], [8, 20]]) == 1 + 1 + 2
    assert _program.idle_intervals(_timeline(), 0) == [[0, 1000], [2000, 5000], [6000, 10000]]


@pytest.mark.parametrize("name, overrides, metrics", [
    ("m2track_kitti_car.train_b100", TRAIN, ["train.build_host_ms_per_step",
                                             "train.update_host_ms_per_step",
                                             "train.sync_wait_ms_per_step"]),
    ("bat_kitti_car.online_32", ONLINE, ["online.reset_ms", "online.pack_ms",
                                         "online.fetch_wait_ms"]),
])
def test_traced_toy_cell_on_the_cpu_reads_the_program_spans(name, overrides, metrics):
    """A traced run of the toy cell on the CPU (eager: no graph replays, no
    card) prints the metrics the program's spans give there."""
    run = harness.Run(name, SEED, 1.0, True, devices=[torch.device("cpu")], overrides=overrides)
    line = harness.execute(run, BENCH, 0.0)
    assert line["correct"]
    for m in metrics:
        assert line["metrics"][m]["value"] > 0, m


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"] if w["chips"] == 1])
def test_traced_cell_reports_every_metric_and_no_program_range_as_device_work(card, cell):
    """A traced run of the one-card cell prints every per-layer metric that
    lists it, the program's and the benchmark's own; no name of a program
    span is among the window's device records."""
    from open3dsot_tpu_torch.utils import profiling

    profiling.clear()
    run = harness.Run(cell, SEED + 5, 2.0, True, devices=[card])
    line = harness.execute(run, BENCH, 0.0)
    assert line["correct"]
    want = [m["name"] for m in BENCH["per_layer"] if harness.applies(m, cell)]
    assert [m for m in want if m not in line["metrics"]] == []
    tl = run.counters["timeline"]
    spans = _program.window_spans(run)
    assert spans and profiling.dropped() == 0
    assert not {s.name for s in spans} & {n for _, _, n, _ in tl.device}
