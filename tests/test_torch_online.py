"""The port's online trackers (tracking/online.py) on the CPU, where the
advance runs eagerly and the kernels' plain versions: against the JAX
online trackers on the same weights (weights.random_variables) and frames,
and against the port's own scan trackers (tests/test_torch_scan_tracker.py
and tests/test_torch_scan_matching.py: their small widths, synthetic
tracklets and helpers).

Tolerances: trajectories against JAX atol 1e-3, as the scan tests hold
them (one step's forward rounds differently on the two sides, atol 5e-4);
everything within the port bit for bit: the online step is the scan step
(`make_m2_step`, `make_match_step`) on the same rows, so online equals
offline at the same B and P, a stream started mid-flight equals the stream
alone, int16 equals f32 fed the dequantized rows, and the graph path's
buffers equal the eager advance.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from open3dsot_tpu.tracking import online as jon
from open3dsot_tpu_torch.data import get_dataset
from open3dsot_tpu_torch.geometry import rigid
from open3dsot_tpu_torch.tracking import online as pon
from open3dsot_tpu_torch.tracking import scan_matching as psm
from open3dsot_tpu_torch.tracking import scan_tracker as pst
from open3dsot_tpu_torch.utils.quant import dequantize, quantize_per_sample
from tests.test_torch_scan_matching import FIRST_CROP
from tests.test_torch_scan_matching import MAX_POINTS as MATCH_P
from tests.test_torch_scan_matching import _fake_capture
from tests.test_torch_scan_matching import _pair as match_pair
from tests.test_torch_scan_matching import numpy_crop  # noqa: F401  (autouse)
from tests.test_torch_scan_tracker import MAX_POINTS as M2_P
from tests.test_torch_scan_tracker import _pair as m2_pair

# the limit-box tests' heads: an x offset past the box every frame, so
# that every step redraws it ('uniform', keyed on each slot's own counter)
M2_LIMIT = dict(seed=13, offset=[5.0, 0.5, 0.3, 0.1], limit_box=True)
MATCH_LIMIT = dict(offset=(9.0, 0.3, 0.1, 5.0), limit_box=True)


def _frames(seq) -> list:
    return [f["pc"].points.T.astype(np.float32) for f in seq]


def _run(tracker, seqs, match: bool, slots=None) -> list:
    """Reset one slot per tracklet and feed every frame; the trajectories."""
    slots = list(range(len(seqs))) if slots is None else slots
    for slot, seq in zip(slots, seqs):
        tracker.reset(slot, seq[0]["pc"] if match else _frames(seq)[0], seq[0]["3d_bbox"])
    out = {slot: [] for slot in slots}
    for t in range(1, min(len(s) for s in seqs)):
        boxes = tracker.step({slot: _frames(seq)[t] for slot, seq in zip(slots, seqs)})
        for slot in slots:
            out[slot].append(boxes[slot])
    return [np.stack(out[slot]) for slot in slots]


# case -> (family, pair overrides)
CASES = {
    "m2": ("m2", {}),
    "m2-limit_uniform": ("m2", M2_LIMIT),
    "bat": ("bat", {}),
    "p2b": ("p2b", {}),
    "bat-all": ("bat", dict(shape_aggregation="all", template_pool=48)),
    "p2b-limit_uniform": ("p2b", MATCH_LIMIT),
}


def _setup(case: str, n: int = 3):
    """(JAX side, port model, port config, port tracklets, JAX tracklets, match)."""
    family, over = CASES[case]
    if family == "m2":
        (jm, variables, jcfg), (port, pcfg) = m2_pair(**over)
    else:
        (jm, variables, jcfg), (port, pcfg) = match_pair(family, **over)
    from open3dsot_tpu.data import get_dataset as j_get_dataset

    seqs = [get_dataset(pcfg, "test", "test")[i] for i in range(n)]
    jseqs = [j_get_dataset(jcfg, "test", "test")[i] for i in range(n)]
    return (jm, variables, jcfg), port, pcfg, seqs, jseqs, family != "m2"


def _online(port, pcfg, match: bool, B: int, **kw):
    if match:
        return pon.OnlineMatchTracker(port, pcfg, max_streams=B, max_points=MATCH_P,
                                      first_crop_points=FIRST_CROP, **kw)
    return pon.OnlineM2Tracker(port, pcfg, max_streams=B, max_points=M2_P, **kw)


def _scan(port, pcfg, match: bool):
    if match:
        return psm.MatchScanTracker(port, pcfg, max_points=MATCH_P, first_crop_points=FIRST_CROP,
                                    frame_bucket=4)
    return pst.M2ScanTracker(port, pcfg, max_points=M2_P, frame_bucket=4)


@pytest.mark.parametrize("case", ["m2", "bat", "p2b"])
def test_matches_jax_online(case):
    """The port's online tracker against JAX's on the same weights and
    frames, at atol 1e-3 (the scan tests' trajectory tolerance)."""
    (jm, variables, jcfg), port, pcfg, seqs, jseqs, match = _setup(case)
    if match:
        jt = jon.OnlineMatchTracker(jm, variables, jcfg, max_streams=3, max_points=MATCH_P,
                                    first_crop_points=FIRST_CROP)
    else:
        jt = jon.OnlineM2Tracker(jm, variables, jcfg, max_streams=3, max_points=M2_P)
    want = _run(jt, jseqs, match)
    got = _run(_online(port, pcfg, match, 3), seqs, match)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=1e-3)


@pytest.mark.parametrize("case", list(CASES))
def test_online_equals_offline_scan(case):
    """Online trajectories equal the port's scan tracker's bit for bit on
    the CPU at the same B and P, in the 'all' reservoir and under the
    'uniform' limit-box redraw too (each slot's own counter / age)."""
    _, port, pcfg, seqs, _, match = _setup(case)
    want = _scan(port, pcfg, match).track_batch(seqs)
    online = _online(port, pcfg, match, len(seqs))
    assert ("age" in online._state) == (case in ("bat-all", "p2b-limit_uniform"))
    got = _run(online, seqs, match)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(online.current_box(1), got[1][-1])


def test_m2_step_takes_a_counter_per_row():
    """make_m2_step with a (B, 1) step counter, as the online tracker feeds
    it, gives each row what the step with that row's 0-d counter gives it:
    the prior-targetness switch and the 'uniform' limit-box redraw go per
    row (the JAX fold, open3dsot_tpu/tracking/scan_tracker.py:336-342). The
    port's step took this already; nothing was repaired."""
    _, (port, pcfg) = m2_pair(**M2_LIMIT)
    seqs = [get_dataset(pcfg, "test", "test")[i] for i in range(2)]
    rows = [[pst.pad_frame(s[t]["pc"].points.T, M2_P) for s in seqs] for t in (1, 2)]
    ref = np.stack([np.append(s[1]["3d_bbox"].center,
                              rigid.theta_from_rotation(s[1]["3d_bbox"].rotation_matrix, None))
                    for s in seqs]).astype(np.float32)
    wlh = np.stack([s[0]["3d_bbox"].wlh for s in seqs]).astype(np.float32)
    args = [torch.from_numpy(a) for a in (wlh, ref)] + [
        torch.from_numpy(np.stack([r[i] for r in rows[t]])) for t in (0, 1) for i in (0, 1)]
    step = pst.make_m2_step(port.net, pcfg, None, True)
    per_row = step(*args, torch.tensor([[0], [5]], dtype=torch.int32))
    for b, idx in enumerate((0, 5)):
        np.testing.assert_array_equal(per_row[b].numpy(), step(*args, torch.tensor(idx))[b].numpy())
    assert not torch.equal(step(*args, torch.tensor(0)), step(*args, torch.tensor(5)))


@pytest.mark.parametrize("case", ["m2", "bat-all"])
def test_staggered_stream_equals_the_stream_alone(case):
    """A stream started mid-flight, while another runs, gives the
    trajectory it gives alone (its reservoir starts empty, its counter at
    0), bit for bit at the same B."""
    _, port, pcfg, seqs, _, match = _setup(case, n=2)
    seq_a, seq_b = seqs
    fa, fb = _frames(seq_a), _frames(seq_b)
    online = _online(port, pcfg, match, 4)
    online.reset(0, seq_a[0]["pc"] if match else fa[0], seq_a[0]["3d_bbox"])
    online.step({0: fa[1]})
    online.reset(1, seq_b[0]["pc"] if match else fb[0], seq_b[0]["3d_bbox"])
    got = [online.step({0: fa[t + 1], 1: fb[t]})[1] for t in range(1, len(seq_a) - 1)]
    solo = _online(port, pcfg, match, 4)
    want = _run(solo, [seq_b[: len(got) + 1]], match, slots=[2])[0]
    np.testing.assert_array_equal(np.stack(got), want)


def test_slot_reuse_after_stop():
    _, port, pcfg, seqs, _, _ = _setup("m2", n=1)
    f, box = _frames(seqs[0]), seqs[0][0]["3d_bbox"]
    online = _online(port, pcfg, False, 2)
    online.reset(0, f[0], box)
    online.step({0: f[1]})
    online.stop(0)
    assert online.free_slots() == [0, 1]
    online.step({})  # nothing active: every slot is stepped with an empty frame
    online.reset(0, f[0], box)  # the same slot from scratch: the trajectory starts over
    fresh = _online(port, pcfg, False, 2)
    fresh.reset(0, f[0], box)
    np.testing.assert_array_equal(online.step({0: f[1]})[0], fresh.step({0: f[1]})[0])


def test_slot_checks():
    """Inactive and unfed slots are refused, and a slot must be an int in
    [0, max_streams): a negative one would alias another stream."""
    _, port, pcfg, seqs, _, _ = _setup("m2", n=1)
    f, box = _frames(seqs[0]), seqs[0][0]["3d_bbox"]
    online = _online(port, pcfg, False, 2)
    with pytest.raises(ValueError, match="not active"):
        online.step({0: f[1]})
    for bad in (-1, 2, 1.0):
        with pytest.raises(ValueError, match="slot"):
            online.reset(bad, f[0], box)
    online.reset(1, f[0], box)
    with pytest.raises(ValueError, match="got no frame"):
        online.step({})
    with pytest.raises(ValueError, match="slot"):
        online.step({-1: f[1], 1: f[1]})
    with pytest.raises(ValueError, match="slot"):
        online.stop(-1)


@pytest.mark.parametrize("ref_mode", ["previous_gt", "current_gt"])
def test_gt_reference_modes_refused(ref_mode):
    _, (port, pcfg) = match_pair("p2b", reference_BB=ref_mode)
    with pytest.raises(ValueError, match="serving time"):
        pon.OnlineMatchTracker(port, pcfg)


def test_factory_picks_the_family():
    _, port, pcfg, _, _, _ = _setup("m2", n=1)
    assert type(pon.make_online_tracker(port, pcfg, max_points=64)) is pon.OnlineM2Tracker
    _, (mport, mcfg) = match_pair("p2b")
    assert type(pon.make_online_tracker(mport, mcfg, max_points=64)) is pon.OnlineMatchTracker


@pytest.mark.parametrize("case", ["m2", "bat"])
def test_int16_equals_f32_fed_the_dequantized_rows(case):
    """The int16 path equals the f32 path fed the rows it dequantizes (only
    where the decode runs differs)."""
    _, port, pcfg, seqs, _, match = _setup(case, n=1)
    seq, f = seqs[0], _frames(seqs[0])
    P = MATCH_P if match else M2_P
    tr_q = _online(port, pcfg, match, 2, transfer_dtype="int16")
    tr_f = _online(port, pcfg, match, 2)
    for tr in (tr_q, tr_f):
        tr.reset(0, seq[0]["pc"] if match else f[0], seq[0]["3d_bbox"])
    for t in range(1, len(seq)):
        pts = np.zeros((2, P, 3), np.float32)
        valid = np.zeros((2, P), bool)
        pts[0], valid[0] = pst.pad_frame(f[t], P)
        q, scale, off = quantize_per_sample(pts, valid)
        deq = dequantize(*(torch.from_numpy(a) for a in (q, scale, off))).numpy()
        np.testing.assert_array_equal(tr_q.step({0: f[t]})[0],
                                      tr_f.step({0: deq[0][: int(valid[0].sum())]})[0])


def _fake_capture_with_warmups(monkeypatch):
    """A `_CapturedStep` that runs its two warm-up steps, as the real one
    does on a side stream, and replays by running the step eagerly."""

    def init(self, device, counted):
        for _ in range(2):
            self._body()
        self.graph = SimpleNamespace(replay=self._body)
        self.launches = tuple(0 for _ in counted)

    monkeypatch.setattr(pst._CapturedStep, "__init__", init)


@pytest.mark.parametrize("fake", ["capture", "capture_with_warmups"])
@pytest.mark.parametrize("case", ["m2-limit_uniform", "bat-all"])
def test_graph_path_equals_the_eager_advance(case, fake, monkeypatch):
    """The graph path's plumbing (static inputs, the state updated in place,
    the warm-ups' writes undone, one graph a tracker) replayed eagerly gives
    the eager advance's boxes bit for bit; each step is one replay."""
    (_fake_capture if fake == "capture" else _fake_capture_with_warmups)(monkeypatch)
    _, port, pcfg, seqs, _, match = _setup(case, n=2)
    want = _run(_online(port, pcfg, match, 2), seqs, match)
    graph = _online(port, pcfg, match, 2)
    graph.cuda_graph = True
    got = _run(graph, seqs, match)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    launches = graph.graph_launches()
    assert len(launches["captured_per_replay"]) == 1
    assert launches["replays"] == min(len(s) for s in seqs) - 1
