"""The scan eval's enqueue never waits on a card (tracking/scan_tracker.py):
`dispatch_scored` tracks and scores a batch with no host synchronisation,
on one card and split over cards, and `pipelined_scores` waits only in its
drains, which it counts.

The tests marked `card` need a CUDA card and skip without one; this file
imports no JAX, so on a machine with a card they run without the tests'
conftest (which loads JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_scan_sync.py
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

from open3dsot_tpu_torch.config import load_config
from open3dsot_tpu_torch.data import get_dataset
from open3dsot_tpu_torch.geometry import iou_device
from open3dsot_tpu_torch.models import get_model
from open3dsot_tpu_torch.tracking import scan_tracker as st
from open3dsot_tpu_torch.utils import profiling

KW = dict(max_points=512, frame_bucket=4)
BATCH = 2  # tracklets a batch: five batches, more than the pipeline's depth of 3


def bev_quad_host_signs(params, wlh, up_idx):
    """bev_quad as it was with its corners' signs in tensors made on the
    host (a blocking copy on a card), frozen for the bit-for-bit tests."""
    theta = params[..., 3]
    w, length = wlh[..., 0], wlh[..., 1]
    sx = params.new_tensor([1.0, 1.0, -1.0, -1.0])
    sy = params.new_tensor([1.0, -1.0, -1.0, 1.0])
    lx = 0.5 * length[..., None] * sx
    ly = 0.5 * w[..., None] * sy
    ct, st_ = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
    u = lx * ct - ly * st_
    v = lx * st_ + ly * ct
    plane = [i for i in range(3) if i != up_idx]
    return torch.stack([params[..., plane[0], None] + u, params[..., plane[1], None] + v], dim=-1)


@pytest.fixture
def cards():
    """Every card present; decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on a machine with a card")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@pytest.fixture(autouse=True)
def empty_store():
    profiling.clear()
    yield
    profiling.clear()


def _m2(device):
    """A seeded M2-Track on `device`, its config and five batches of tracklets."""
    cfg = load_config("cfgs/M2_track_synthetic.yaml",
                      dict(syn_num_tracklets=5 * BATCH, syn_tracklet_len=12, seed=5))
    torch.manual_seed(0)
    model = get_model("m2track")(cfg, device=device)
    model.net.eval()
    sampler = get_dataset(cfg, "test", "test")
    seqs = [sampler[i] for i in range(len(sampler))]
    return model, cfg, [seqs[j:j + BATCH] for j in range(0, len(seqs), BATCH)]


def _scores(tracker, batches, prep) -> list:
    """Each batch's (iou, dist) on the host, from warm prep-cache entries."""
    out = [tracker.dispatch_scored(b, prep, ("prep", j)) for j, b in enumerate(batches)]
    return [(i.cpu(), d.cpu()) for i, d in out]


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


class _Event:
    """A stand-in for a card's event: pending at its first query."""

    def __init__(self, log: list):
        self.log, self.done = log, False

    def query(self) -> bool:
        self.log.append("query")
        done, self.done = self.done, True
        return done

    def synchronize(self) -> None:
        self.log.append("wait")
        self.done = True


@pytest.mark.parametrize("record", [False, True])
def test_drains_counted_and_queried_only_while_recording(record, monkeypatch):
    """Every drain waits on its batch's event; while spans record, each is
    counted, and those still pending, by one query, apart; otherwise no
    query and no counter."""
    model, cfg, batches = _m2("cpu")
    tracker = st.M2ScanTracker(model, cfg, **KW)
    log: list = []
    monkeypatch.setattr(st, "_fetch_async", lambda iou, dist: (iou, dist, _Event(log)))
    with profiling.recording() if record else contextlib.nullcontext():
        assert profiling.active() == record
        got = list(st.pipelined_scores(tracker, batches, depth=3))
    assert len(got) == 5 * BATCH
    if record:
        assert profiling.counters() == {"scan.drains": 5, "scan.drains_pending": 5}
        assert log == ["query", "wait"] * 5
    else:
        assert profiling.counters() == {} and log == ["wait"] * 5


def test_cpu_drains_have_no_event():
    """On the CPU the scores are on the host at once: every drain counted,
    none pending, the scores those of `dispatch_scored`."""
    model, cfg, batches = _m2("cpu")
    tracker = st.M2ScanTracker(model, cfg, **KW)
    want = _scores(tracker, batches, {})
    with profiling.recording():
        got = list(st.pipelined_scores(tracker, batches))
    assert profiling.counters() == {"scan.drains": 5}
    for j, (iou, dist) in enumerate(want):
        for b in range(BATCH):
            np.testing.assert_array_equal(got[j * BATCH + b][0], iou[b].numpy())
            np.testing.assert_array_equal(got[j * BATCH + b][1], dist[b].numpy())


@pytest.mark.card
@pytest.mark.parametrize("split", [False, True], ids=["one_card", "split"])
def test_dispatch_scored_never_waits_on_a_card(cards, split, monkeypatch):
    """Warm (graphs captured, prep cache filled), `dispatch_scored` and the
    fetch of its scores raise nothing under the sync debug mode's "error",
    on one card and split over every card (over the first card twice where
    there is one); its scores equal, bit for bit, those of the scorer with
    host-made signs; a pipelined pass counts one drain a batch."""
    devices = (cards if len(cards) > 1 else cards * 2) if split else None
    model, cfg, batches = _m2(cards[0])
    tracker = st.M2ScanTracker(model, cfg, devices=devices, **KW)
    assert tracker.cards == (len(devices) if split else 1)
    prep: dict = {}
    got = _scores(tracker, batches, prep)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for j, b in enumerate(batches):
            st._fetch_async(*tracker.dispatch_scored(b, prep, ("prep", j)))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for d in cards:
        torch.cuda.synchronize(d)
    with monkeypatch.context() as m:
        m.setattr(iou_device, "bev_quad", bev_quad_host_signs)
        want = _scores(tracker, batches, prep)
    for (gi, gd), (wi, wd) in zip(got, want):
        assert _same_bits(gi, wi) and _same_bits(gd, wd)
    assert all(0 < float(i.max()) <= 1 for i, _ in got)
    with profiling.recording():
        piped = list(st.pipelined_scores(tracker, batches, prep_cache=prep))
    counts = profiling.counters()
    assert counts["scan.drains"] == len(batches)
    assert counts.get("scan.drains_pending", 0) <= counts["scan.drains"]
    for j, (iou, dist) in enumerate(got):
        for b in range(BATCH):
            np.testing.assert_array_equal(piped[j * BATCH + b][0], iou[b].numpy())
            np.testing.assert_array_equal(piped[j * BATCH + b][1], dist[b].numpy())
