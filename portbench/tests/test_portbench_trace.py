"""The reading of a traced window: busy union, idle gaps by host activity,
time by kernel name, on records made up here."""

import pytest

from portbench import trace


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



def ann(name, start, dur):
    return Ev(name, start, dur, kind="user_annotation", device="CPU")


SPANS = {"scan.dispatch_scored", "online.step"}
EVENTS = [ann(trace.WINDOW, 0, 1000), ann("scan.dispatch_scored", 0, 150),
          ann("online.step", 600, 300),
          Ev("void chain_tc_kernel<1>(StageArgs)", 100, 200), Ev("pool_bias_kernel", 250, 100),
          Ev("Memcpy HtoD", 500, 50, kind="gpu_memcpy"), Ev("elementwise", 900, 200),
          Ev("aten::mm", 0, 999, kind="cpu_op", device="CPU"),
          Ev("scan.dispatch_scored", 0, 300, kind="gpu_user_annotation")]


class OldEv(Ev):
    """A record of a torch without `activity_type`."""

    def __getattribute__(self, name):
        if name == "activity_type":
            raise AttributeError(name)
        return super().__getattribute__(name)


def test_records_without_their_kind_read_alike():
    old = [OldEv(e._n, e._s, e._d, e._k, e._dev, e._c) for e in EVENTS]
    assert trace.Timeline(old, SPANS).merged() == trace.Timeline(EVENTS, SPANS).merged()


def test_busy_is_the_union_inside_the_window():
    tl = trace.Timeline(EVENTS, SPANS)
    assert tl.window_s == pytest.approx(1e-6)
    assert tl.merged() == [[100, 350], [500, 550], [900, 1000]]
    assert tl.busy_s() == pytest.approx(400e-9)


def test_kernel_time_by_name():
    tl = trace.Timeline(EVENTS, SPANS)
    assert tl.kernel_s(("chain_tc_kernel", "pool_bias_kernel")) == pytest.approx(300e-9)
    top = tl.top_ops()
    assert top[0] == ["chain_tc_kernel<1>", pytest.approx(200e-9)]


def test_idle_gaps_named_by_the_innermost_span():
    gaps = dict(trace.Timeline(EVENTS, SPANS).idle_gaps())
    assert gaps["scan.dispatch_scored"] == pytest.approx(100e-9)  # 0-100
    assert gaps["online.step"] == pytest.approx(350e-9)  # 550-900, its middle in the step
    assert gaps["no span"] == pytest.approx(150e-9)  # 350-500


def test_busy_averaged_over_cards():
    evs = [ann(trace.WINDOW, 0, 1000), Ev("k", 0, 400, card=0), Ev("k", 0, 200, card=1)]
    assert trace.Timeline(evs).busy_s() == pytest.approx(300e-9)


def test_a_trace_without_its_window_is_refused():
    with pytest.raises(RuntimeError):
        trace.Timeline([Ev("k", 0, 10)])


def test_spans_record_durations():
    s = trace.Spans()
    with s.span("a"):
        pass
    assert len(s.durations_s("a")) == 1 and s.durations_s("b") == []
