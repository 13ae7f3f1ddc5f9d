"""The port's scan trackers split over several devices in one process
(`devices=`, tracking/scan_tracker.py::_ScanTracker) against the JAX
trackers' `mesh=` (shard_map over a 1-D data mesh of two of the conftest's
eight virtual CPU devices), on the CPU: the port's parts on ["cpu", "cpu"].

The JAX side is held as tests/test_torch_scan_tracker.py and
tests/test_torch_scan_matching.py hold the unsplit trackers (the same
weights, data and sizes): whole trajectories within 1e-3. Each part of a
split tracker is held to an unsplit tracker at the part's batch size bit
for bit (the same kernels in the same order on the same rows), and the
dataset loop's Success/Precision to the unsplit tracker's exactly.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from open3dsot_tpu.data import get_dataset as j_get_dataset
from open3dsot_tpu.parallel import make_mesh
from open3dsot_tpu.tracking import scan_matching as jsm
from open3dsot_tpu.tracking import scan_tracker as js
from open3dsot_tpu_torch.data import get_dataset
from open3dsot_tpu_torch.tracking import prep_store
from open3dsot_tpu_torch.tracking import scan_matching as psm
from open3dsot_tpu_torch.tracking import scan_tracker as ps
from tests import _torch_port  # noqa: F401  (one torch thread a worker)
from tests.test_torch_scan_matching import KW as MATCH_KW
from tests.test_torch_scan_matching import _pair as match_pair
from tests.test_torch_scan_tracker import MAX_POINTS
from tests.test_torch_scan_tracker import _pair as m2_pair

CPUS = ["cpu", "cpu"]
M2_KW = dict(max_points=MAX_POINTS, frame_bucket=4)


@pytest.fixture(autouse=True)
def numpy_crop(monkeypatch):
    """Both packages crop with numpy (tests/test_torch_scan_matching.py)."""
    monkeypatch.setenv("OPEN3DSOT_TPU_NATIVE", "0")


@pytest.fixture(scope="module")
def m2():
    return m2_pair(syn_num_tracklets=4)


@pytest.fixture(scope="module")
def m2_mesh(m2):
    """JAX's M2 tracker on a mesh of two devices (one compile for both batches)."""
    jm, variables, jcfg = m2[0]
    return js.M2ScanTracker(jm, variables, jcfg, mesh=make_mesh(2), **M2_KW)


def _seqs(cfg, jcfg, n: int):
    return ([get_dataset(cfg, "test", "test")[i] for i in range(n)],
            [j_get_dataset(jcfg, "test", "test")[i] for i in range(n)])


def _parts_unsplit(make, seqs, per: int) -> list:
    """Unsplit trackers (make()) at the part's batch size over `seqs`."""
    return [b for s in range(0, len(seqs), per) for b in make().track_batch(seqs[s:s + per])]


def _fake_capture(monkeypatch):
    """A `_CapturedStep` whose replay runs the step eagerly, counting the
    replays' body runs: the graph path's buffers and frame loop on the CPU."""

    def init(self, device, counted):
        self.graph = SimpleNamespace(replay=self._body)
        self.launches = tuple(0 for _ in counted)

    monkeypatch.setattr(ps._CapturedStep, "__init__", init)


def test_one_device_is_the_unsplit_tracker(m2):
    _, (port, pcfg) = m2
    for devices in (None, ["cpu"], [torch.device("cpu")]):
        tr = ps.M2ScanTracker(port, pcfg, devices=devices, **M2_KW)
        assert tr.parts == [] and tr.cards == 1 and tr.model is port
        assert tr.device == torch.device("cpu")
    seqs = [get_dataset(pcfg, "test", "test")[i] for i in range(2)]
    want = ps.M2ScanTracker(port, pcfg, **M2_KW).track_batch(seqs)
    for g, w in zip(ps.M2ScanTracker(port, pcfg, devices=["cpu"], **M2_KW).track_batch(seqs),
                    want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n", [3, 4])
def test_m2_split_matches_jax_mesh(m2, m2_mesh, n):
    """n = 3 is padded to 4 by repeating the last tracklet on both sides
    (JAX scan_tracker.py:442-446); 3 trajectories come back."""
    (_, _, jcfg), (port, pcfg) = m2
    jt = m2_mesh
    pt = ps.M2ScanTracker(port, pcfg, devices=CPUS, **M2_KW)
    assert pt.cards == 2 and len(pt.parts) == 2 and pt.model is port
    seqs, jseqs = _seqs(pcfg, jcfg, n)
    want, got = jt.track_batch(jseqs), pt.track_batch(seqs)
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        assert g.shape == (5, 4)
        np.testing.assert_allclose(g, w, atol=1e-3)
    # each part equals an unsplit tracker at the part's B (2) on its rows
    padded = seqs + seqs[-1:] * (4 - n)
    unsplit = _parts_unsplit(lambda: ps.M2ScanTracker(port, pcfg, **M2_KW), padded, 2)
    for g, w in zip(got, unsplit):
        np.testing.assert_array_equal(g, w)


def test_m2_split_graph_path_and_launches(m2, monkeypatch):
    """The parts' captured steps (replayed eagerly): each part keeps its own
    graphs, counts its own replays, and gives the eager split's boxes."""
    _fake_capture(monkeypatch)
    _, (port, pcfg) = m2
    seqs = [get_dataset(pcfg, "test", "test")[i] for i in range(4)]
    eager = ps.M2ScanTracker(port, pcfg, devices=CPUS, **M2_KW)
    graph = ps.M2ScanTracker(port, pcfg, devices=CPUS, **M2_KW)
    for part in graph.parts:
        part.cuda_graph = True
    want = eager.track_batch(seqs)
    for g, w in zip(graph.track_batch(seqs), want):
        np.testing.assert_array_equal(g, w)
    launches = graph.graph_launches()
    steps = graph._bucket_len(6) - 1
    assert [p["replays"] for p in launches["parts"]] == [steps, steps]
    assert launches["replays"] == 2 * steps and len(launches["captured_per_replay"]) == 2
    assert graph.parts[0]._graphs is not graph.parts[1]._graphs


def test_m2_split_bf16_parts_equal_unsplit(m2):
    """Under bf16 each part rounds its own copy of the net, and equals an
    unsplit bf16 tracker at the part's B bit for bit."""
    _, (port, pcfg) = m2
    kw = dict(M2_KW, compute_dtype=torch.bfloat16)
    seqs = [get_dataset(pcfg, "test", "test")[i] for i in range(4)]
    split = ps.M2ScanTracker(port, pcfg, devices=CPUS, **kw)
    got = split.track_batch(seqs)
    nets = [p._step for p in split.parts]
    assert nets[0] is not nets[1]
    want = _parts_unsplit(lambda: ps.M2ScanTracker(port, pcfg, **kw), seqs, 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_split_follows_new_weights(m2):
    """The parts are made anew when the model's weights change (a part on
    another device holds a copy), and track with the new weights."""
    _, (port, pcfg) = m2
    seqs = [get_dataset(pcfg, "test", "test")[i] for i in range(2)]
    split = ps.M2ScanTracker(port, pcfg, devices=CPUS, **M2_KW)
    before = split.track_batch(seqs)
    parts = list(split.parts)
    saved = {k: v.clone() for k, v in port.net.state_dict().items()}
    try:
        with torch.no_grad():
            for p in port.net.parameters():
                p.mul_(1.01)
        after = split.track_batch(seqs)
        assert split.parts[0] is not parts[0]
        want = _parts_unsplit(lambda: ps.M2ScanTracker(port, pcfg, **M2_KW), seqs, 1)
        for g, w, b in zip(after, want, before):
            np.testing.assert_array_equal(g, w)
            assert not np.array_equal(g, b)
    finally:
        port.net.load_state_dict(saved)


@pytest.mark.parametrize("device_metrics", [True, False])
def test_evaluate_dataset_scan_split_equals_unsplit(m2, device_metrics):
    _, (port, pcfg) = m2
    sampler = get_dataset(pcfg, "test", "test")
    split = ps.M2ScanTracker(port, pcfg, devices=CPUS, **M2_KW)
    # batches of 3: each padded to 4 for the two parts
    kw = dict(max_points=MAX_POINTS, batch_tracklets=3, device_metrics=device_metrics)
    got = ps.evaluate_dataset_scan(port, sampler, pcfg, tracker=split, **kw)
    want = ps.evaluate_dataset_scan(port, sampler, pcfg,
                                    tracker=ps.M2ScanTracker(port, pcfg, **M2_KW), **kw)
    assert np.isfinite(got).all() and got == want
    assert split.model is port


def test_prep_store_refuses_another_card_count(m2, tmp_path):
    """A batch packed for n cards is padded to a multiple of n: the card
    count is in the store's fingerprint, and a split eval runs from its
    warm store as from its cold one."""
    _, (port, pcfg) = m2
    sampler = get_dataset(pcfg, "test", "test")
    split = ps.M2ScanTracker(port, pcfg, devices=CPUS, **M2_KW)
    one = ps.M2ScanTracker(port, pcfg, **M2_KW)
    path = str(tmp_path / "store")
    kw = dict(max_points=MAX_POINTS, batch_tracklets=3)
    cold = ps.evaluate_dataset_scan(port, sampler, pcfg, tracker=split, prep_store_path=path, **kw)
    warm = ps.evaluate_dataset_scan(port, sampler, pcfg, tracker=split, prep_store_path=path, **kw)
    assert cold == warm == ps.evaluate_dataset_scan(port, sampler, pcfg, tracker=one, **kw)
    with pytest.raises(ValueError, match="different fingerprint"):
        ps.evaluate_dataset_scan(port, sampler, pcfg, tracker=one, prep_store_path=path, **kw)
    store = prep_store.eval_store(str(tmp_path / "other"), pcfg, split, n=4, batch_tracklets=3)
    assert store._fingerprint["cards"] == 2
    assert prep_store.eval_store(str(tmp_path / "one"), pcfg, one, n=4,
                                 batch_tracklets=3)._fingerprint["cards"] == 1


MATCH_CASES = {
    "bat": ("bat", {}),
    # the reservoir and the 'uniform' redraw keyed on each row's age
    "bat-all-limit_uniform": ("bat", dict(shape_aggregation="all", template_pool=48,
                                          limit_box=True)),
    "p2b-current_gt": ("p2b", dict(reference_BB="current_gt")),
}


@pytest.mark.parametrize("case", list(MATCH_CASES))
def test_match_split_matches_jax_mesh(case):
    """Each part keeps its own carry, first crops and gt inputs: the split
    tracker against JAX's mesh tracker (3 tracklets, padded to 4), and each
    part bit for bit against an unsplit tracker on its rows."""
    net, over = MATCH_CASES[case]
    (jm, variables, jcfg), (port, pcfg) = match_pair(net, **over)
    jt = jsm.MatchScanTracker(jm, variables, jcfg, mesh=make_mesh(2), **MATCH_KW)
    pt = psm.MatchScanTracker(port, pcfg, devices=CPUS, **MATCH_KW)
    seqs, jseqs = _seqs(pcfg, jcfg, 3)
    want, got = jt.track_batch(jseqs), pt.track_batch(seqs)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.shape == (4, 4)
        np.testing.assert_allclose(g, w, atol=1e-3)
    unsplit = _parts_unsplit(lambda: psm.MatchScanTracker(port, pcfg, **MATCH_KW),
                             seqs + seqs[-1:], 2)
    for g, w in zip(got, unsplit):
        np.testing.assert_array_equal(g, w)


def test_match_split_rows_keep_their_draws():
    """The 'all' reservoir's priorities and the redraw are keyed on a row's
    age, not on its place: the last tracklet tracked in part 1 (row 0 of its
    part) equals the same tracklet tracked alone, and the dataset loop
    split equals unsplit."""
    _, (port, pcfg) = match_pair("bat", shape_aggregation="all", template_pool=48,
                                 limit_box=True)
    sampler = get_dataset(pcfg, "test", "test")
    seqs = [sampler[i] for i in range(3)]
    pt = psm.MatchScanTracker(port, pcfg, devices=CPUS, **MATCH_KW)
    got = pt.track_batch(seqs)
    alone = psm.MatchScanTracker(port, pcfg, **MATCH_KW).track_batch(seqs[2:])
    np.testing.assert_allclose(got[2], alone[0], atol=1e-4)
    kw = dict(max_points=MAX_POINTS, batch_tracklets=3)
    assert psm.evaluate_dataset_scan_matching(port, sampler, pcfg, tracker=pt, **kw) == \
        psm.evaluate_dataset_scan_matching(
            port, sampler, pcfg, tracker=psm.MatchScanTracker(port, pcfg, **MATCH_KW), **kw)


def test_match_split_graph_path(monkeypatch):
    """The matching parts' captured steps (replayed eagerly) in a gt mode:
    each part's gt anchors and carry buffers, equal to the eager split."""
    _fake_capture(monkeypatch)
    _, (port, pcfg) = match_pair("bat", reference_BB="previous_gt")
    seqs = [get_dataset(pcfg, "test", "test")[i] for i in range(3)]
    eager = psm.MatchScanTracker(port, pcfg, devices=CPUS, **MATCH_KW)
    graph = psm.MatchScanTracker(port, pcfg, devices=CPUS, **MATCH_KW)
    for part in graph.parts:
        part.cuda_graph = True
    for g, w in zip(graph.track_batch(seqs), eager.track_batch(seqs)):
        np.testing.assert_array_equal(g, w)
    assert all(p["replays"] == graph._bucket_len(5) - 1
               for p in graph.graph_launches()["parts"])
    # device scoring of the split batch: padded to 4 rows, the first 3 the tracklets'
    iou, dist = eager.dispatch_scored(seqs)
    assert iou.shape[0] == 4
    for b, (ious, dists, _) in enumerate(eager.evaluate_sequences(seqs, pcfg)):
        np.testing.assert_allclose(iou[b, :5].numpy(), ious, atol=2e-4)
        np.testing.assert_allclose(dist[b, :5].numpy(), dists, atol=2e-4)
