"""The port's matching scan tracker (tracking/scan_matching.py, BAT and P2B)
against the JAX one, on the CPU, where the port runs its eager loop and the
plain versions of K3/K4 and the JAX side its flax forward. Same weights
(weights.random_variables), same synthetic data (3 tracklets x 5 frames),
the JAX tests' sizes (tests/test_scan_matching.py::cfg_for: 32 channels,
template 64, search 128, 16 proposals), max_points 256, first_crop_points
128.

Tolerances: one step's box atol 5e-4 (the forward's,
tests/test_torch_matching.py); the carries' ages and reservoir keys
exactly, the reservoir's points atol 1e-5 (the crop's rigid transform
rounds differently on the two sides); whole trajectories atol 1e-3 and
Success/Precision equal.
Tracklets are short on purpose: over long ones a tiny float difference can
flip an argmax and the trajectories part for a reason that is not a fault.
"""

from __future__ import annotations

from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3dsot_tpu.config import make_config as j_make_config
from open3dsot_tpu.data import get_dataset as j_get_dataset
from open3dsot_tpu.geometry import rigid as j_rigid
from open3dsot_tpu.models import get_model as j_get_model
from open3dsot_tpu.tracking import scan_matching as jsm
from open3dsot_tpu_torch import main as port_main
from open3dsot_tpu_torch.config import load_config, make_config
from open3dsot_tpu_torch.data import get_dataset
from open3dsot_tpu_torch.geometry import rigid
from open3dsot_tpu_torch.models import get_model
from open3dsot_tpu_torch.tracking import scan_matching as psm
from open3dsot_tpu_torch.tracking import scan_tracker as pst
from open3dsot_tpu_torch.weights import random_variables, state_dict_from_jax

# tests/test_scan_matching.py::cfg_for, with three tracklets of five frames
BASE = dict(dataset="synthetic", category_name="Car", search_bb_scale=1.25, search_bb_offset=2,
            model_bb_scale=1.25, model_bb_offset=0, template_size=64, search_size=128,
            degrees=True, up_axis=[0, 0, 1], data_limit_box=False, train_type="train_siamese",
            num_candidates=1, normalize_xyz=False, feature_channel=32, hidden_channel=32,
            out_channel=32, vote_channel=32, num_proposal=16, k=4, bc_channel=9,
            reference_BB="previous_result", shape_aggregation="firstandprevious", use_z=True,
            limit_box=False, IoU_space=3, syn_num_tracklets=3, syn_tracklet_len=5, seed=0,
            tensorboard=False)
CAMERA = dict(coordinate_mode="camera", up_axis=[0, -1, 0])
MAX_POINTS, FIRST_CROP = 256, 128
KW = dict(max_points=MAX_POINTS, first_crop_points=FIRST_CROP, frame_bucket=4)


@pytest.fixture(autouse=True)
def numpy_crop(monkeypatch):
    """The JAX package crops with its native library when it is built (same
    points, other rounding); the port copies the numpy path, which the JAX
    side then takes too (tests/test_torch_eval.py)."""
    monkeypatch.setenv("OPEN3DSOT_TPU_NATIVE", "0")


def _pair(net: str, seed: int = 3, offset=None, **over):
    """(JAX model, variables, JAX config), (port model, port config). With
    `offset` (dx, dy, dz, dtheta), every proposal predicts that box offset
    from its cluster centre with equal objectness."""
    d = dict(BASE, net_model=net, box_aware=net == "bat", use_fps=net == "bat", **over)
    jcfg, pcfg = j_make_config(d), make_config(d)
    port = get_model(net)(pcfg, device="cpu")
    variables = random_variables(port.net, seed=seed)
    if offset is not None:
        last = variables["params"]["rpn"]["FC_proposal"]["layer2"]["dense"]
        last["kernel"][:] = 0
        last["bias"][:] = list(offset) + [0.0]
    port.net.load_state_dict(state_dict_from_jax(variables), strict=True)
    return (j_get_model(net)(jcfg), variables, jcfg), (port, pcfg)


def _seqs(pcfg, jcfg, n: int = 3):
    return ([get_dataset(pcfg, "test", "test")[i] for i in range(n)],
            [j_get_dataset(jcfg, "test", "test")[i] for i in range(n)])


@pytest.mark.parametrize("agg, want", [
    ("firstandprevious", "firstandprevious"), ("FirstAndPrevious", "firstandprevious"),
    ("first", "first"), ("First_frame", "first"), ("previous", "previous"),
    ("PREVIOUS_result", "previous"), ("all", "all"), ("All_Frames", "all"),
    ("first_or_previous", "first"), ("previousAndAll", "previous")])
def test_parse_agg_mode_matches_jax(agg, want):
    assert psm.parse_agg_mode(agg) == jsm.parse_agg_mode(agg) == want


def test_parse_modes_refuse_unknown_strings():
    for parse in (psm.parse_agg_mode, jsm.parse_agg_mode):
        with pytest.raises(ValueError):
            parse("latest")
    with pytest.raises(ValueError, match="reference_BB"):
        psm.parse_ref_mode("next_gt")
    assert psm.parse_ref_mode("Previous_GT") == "previous_gt"


def _step_inputs(pt, seqs, t: int):
    """Frames (t, t + 1) of each tracklet on the port tracker's host path:
    first crop, points, counts, wlh, the gt box of frame t, gt arrays."""
    _, T_pad, host = pt._prepare(seqs)
    pts, counts, wlh, init, first_pts, first_count = (h.numpy() for h in host)
    gt_params, gt_wlh = (g.numpy() for g in pt._gt_host(seqs, T_pad))
    valid = np.arange(MAX_POINTS)[None, None, :] < counts[..., None]
    first_valid = np.arange(FIRST_CROP)[None, :] < first_count[:, None]
    xs = (pts[:, t], valid[:, t], pts[:, t + 1], valid[:, t + 1])
    return first_pts, first_valid, wlh, gt_params[:, t], xs, (gt_params, gt_wlh)


# (net, config overrides, heads' offset or None, steps chained)
STEP_CASES = {
    **{f"{net}-{agg}": (net, dict(shape_aggregation=agg), None, 1)
       for net in ("bat", "p2b") for agg in ("firstandprevious", "first", "previous")},
    # a pool smaller than two frames' crops: the second step overflows it
    "bat-all": ("bat", dict(shape_aggregation="all", template_pool=48), None, 2),
    "p2b-all": ("p2b", dict(shape_aggregation="all", template_pool=48), None, 2),
    "bat-previous_gt": ("bat", dict(reference_BB="previous_gt"), None, 1),
    "bat-current_gt": ("bat", dict(reference_BB="current_gt"), None, 1),
    "bat-limit_uniform": ("bat", dict(limit_box=True), (9.0, 0.3, 0.1, 5.0), 2),
    "p2b-limit_zero": ("p2b", dict(limit_box=True, limit_box_redraw="zero"),
                       (9.0, 0.3, 0.1, 5.0), 1),
    "p2b-camera": ("p2b", CAMERA, None, 1),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_step_matches_jax(case):
    net, over, offset, n_steps = STEP_CASES[case]
    (jm, variables, jcfg), (port, pcfg) = _pair(net, offset=offset, **over)
    pt = psm.MatchScanTracker(port, pcfg, **KW)
    jA = j_rigid.up_frame(jcfg.up_axis)
    assert (jA is None) == (case != "p2b-camera")
    agg, gt_mode = pt._agg_mode, pt.gt_inputs
    jstep = jax.jit(partial(jsm.make_match_step(jm, jcfg, jA, net == "bat", agg, gt_mode),
                            variables, None))
    pstep = psm.make_match_step(port.net, pcfg, pt._A, net == "bat", agg, gt_mode)
    seqs = [get_dataset(pcfg, "test", "test")[i] for i in range(2)]
    t_ = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    first_pts, first_valid, wlh, ref0, _, gt = _step_inputs(pt, seqs, 0)
    carry = [ref0, wlh]
    if agg == "all":
        C = pt.template_pool
        carry += [np.zeros((2, C, 3), np.float32), np.full((2, C), -np.inf, np.float32),
                  np.zeros(2, np.int32)]
    elif pt._lb_uniform:
        carry += [np.zeros(2, np.int32)]
    for t in range(n_steps):
        *_, xs, (gt_params, gt_wlh) = _step_inputs(pt, seqs, t)
        if gt_mode:
            xs += (gt_params[:, t + pt._gt_shift], gt_wlh[:, t + pt._gt_shift])
        want_carry, want = jstep(jnp.asarray(first_pts), jnp.asarray(first_valid),
                                 tuple(jnp.asarray(c) for c in carry),
                                 tuple(jnp.asarray(x) for x in xs))
        got_carry, got = pstep(t_(first_pts), t_(first_valid), tuple(t_(c) for c in carry),
                               tuple(t_(x) for x in xs))
        assert got.shape == (2, 4) and torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, err_msg=case)
        assert len(got_carry) == len(want_carry)
        np.testing.assert_allclose(got_carry[1].numpy(), np.asarray(want_carry[1]), atol=1e-6)
        if agg == "all":
            np.testing.assert_array_equal(got_carry[3].numpy(), np.asarray(want_carry[3]))
            np.testing.assert_allclose(got_carry[2].numpy(), np.asarray(want_carry[2]), atol=1e-5)
        if len(got_carry) > 2:
            assert got_carry[-1].dtype == torch.int32
            np.testing.assert_array_equal(got_carry[-1].numpy(), np.asarray(want_carry[-1]))
            assert np.all(got_carry[-1].numpy() == t + 1)
        if offset is not None:
            # the x offset overshoots the box: redrawn in U(-1, 1), or set to 0
            local = rigid.transform_box_params(got, t_(carry[0]).float()).numpy()
            if pt._lb_uniform:
                assert np.all(np.abs(local[:, 0]) < 1.0) and np.all(local[:, 0] != 0.0)
            else:
                np.testing.assert_allclose(local[:, 0], 0.0, atol=1e-5)
        carry = [np.asarray(c) for c in want_carry]  # both sides go on from JAX's carry
    if agg == "all":
        assert np.all(np.isfinite(carry[3]))  # the reservoir overflowed: no empty slot left


@pytest.fixture(scope="module")
def bat_pair():
    return _pair("bat")


@pytest.fixture(scope="module")
def bat_trackers(bat_pair):
    (jm, variables, jcfg), (port, pcfg) = bat_pair
    return (jsm.MatchScanTracker(jm, variables, jcfg, **KW),
            psm.MatchScanTracker(port, pcfg, **KW))


TRACK_CASES = {
    "bat": ("bat", {}),
    "bat-all-limit_uniform": ("bat", dict(shape_aggregation="all", template_pool=48,
                                          limit_box=True)),
    "p2b-current_gt": ("p2b", dict(reference_BB="current_gt")),
}


@pytest.mark.parametrize("case", list(TRACK_CASES))
def test_track_batch_matches_jax(case, bat_pair, bat_trackers):
    net, over = TRACK_CASES[case]
    if case == "bat":
        (_, _, jcfg), (_, pcfg) = bat_pair
        jt, pt = bat_trackers
    else:
        (jm, variables, jcfg), (port, pcfg) = _pair(net, **over)
        jt = jsm.MatchScanTracker(jm, variables, jcfg, **KW)
        pt = psm.MatchScanTracker(port, pcfg, **KW)
    seqs, jseqs = _seqs(pcfg, jcfg)
    want, got = jt.track_batch(jseqs), pt.track_batch(seqs)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.shape == (4, 4)
        np.testing.assert_allclose(g, w, atol=1e-3)
    # batched equals one at a time (the JAX tests' tolerance: the forward's sums
    # block by the batch size)
    np.testing.assert_allclose(pt.track_batch([seqs[1]])[0], got[1], atol=1e-4)


@pytest.mark.parametrize("device_metrics", [True, False])
def test_success_precision_equal(bat_pair, bat_trackers, device_metrics):
    (jm, variables, jcfg), (port, pcfg) = bat_pair
    jt, pt = bat_trackers
    want = jsm.evaluate_dataset_scan_matching(jm, variables, j_get_dataset(jcfg, "test", "test"),
                                              jcfg, max_points=MAX_POINTS, tracker=jt,
                                              device_metrics=device_metrics)
    sampler = get_dataset(pcfg, "test", "test")
    got = psm.evaluate_dataset_scan_matching(port, sampler, pcfg, max_points=MAX_POINTS,
                                             tracker=pt, device_metrics=device_metrics)
    assert np.isfinite(got).all()
    assert got == want
    cache = {}
    for _ in range(2):
        again = psm.evaluate_dataset_scan_matching(port, sampler, pcfg, tracker=pt,
                                                   device_metrics=device_metrics,
                                                   prep_cache=cache)
        assert again == got
    assert "batches" in cache


def test_device_scores_match_host_scores_in_a_gt_mode():
    """previous_gt: each prediction takes its gt anchor's wlh on both
    scoring paths."""
    _, (port, pcfg) = _pair("bat", reference_BB="previous_gt")
    pt = psm.MatchScanTracker(port, pcfg, **KW)
    seqs = [get_dataset(pcfg, "test", "test")[i] for i in range(3)]
    iou_d, dist_d = (t.numpy() for t in pt.dispatch_scored(seqs))
    for b, (ious, dists, boxes) in enumerate(pt.evaluate_sequences(seqs, pcfg)):
        np.testing.assert_allclose(iou_d[b, :5], ious, atol=2e-4)
        np.testing.assert_allclose(dist_d[b, :5], dists, atol=2e-4)
        np.testing.assert_allclose(boxes[2].wlh, seqs[b][1]["3d_bbox"].wlh)


def test_int16_transfer_matches_jax(bat_pair):
    (jm, variables, jcfg), (port, pcfg) = bat_pair
    jt = jsm.MatchScanTracker(jm, variables, jcfg, transfer_dtype="int16", **KW)
    pt = psm.MatchScanTracker(port, pcfg, transfer_dtype="int16", **KW)
    seqs, jseqs = _seqs(pcfg, jcfg, 2)
    for g, w in zip(pt.track_batch(seqs), jt.track_batch(jseqs)):
        np.testing.assert_allclose(g, w, atol=1e-3)


def _fake_capture(monkeypatch):
    """A `_CapturedStep` whose replay runs the step eagerly: the graph
    path's buffers and frame loop on the CPU."""

    def init(self, device, counted):
        self.graph = SimpleNamespace(replay=self._body)
        self.launches = tuple(0 for _ in counted)

    monkeypatch.setattr(pst._CapturedStep, "__init__", init)


@pytest.mark.parametrize("over", [{}, dict(shape_aggregation="all", template_pool=48),
                                  dict(reference_BB="current_gt", limit_box=True)],
                         ids=["firstandprevious", "all", "current_gt-limit_uniform"])
def test_graph_frame_loop_equals_the_eager_loop(over, monkeypatch):
    """The graph path's static buffers (frame pair, first crop, carry, gt
    anchor) and its frame loop, replayed eagerly, give the eager loop's
    boxes bit for bit; the replays are counted."""
    _fake_capture(monkeypatch)
    _, (port, pcfg) = _pair("bat", **over)
    seqs = [get_dataset(pcfg, "test", "test")[i] for i in range(3)]
    eager = psm.MatchScanTracker(port, pcfg, **KW)
    graph = psm.MatchScanTracker(port, pcfg, **KW)
    graph.cuda_graph = True
    want = eager.track_batch(seqs)
    for _ in range(2):  # the second call replays the same graph from a fresh carry
        for g, w in zip(graph.track_batch(seqs), want):
            np.testing.assert_array_equal(g, w)
    launches = graph.graph_launches()
    steps = graph._bucket_len(5) - 1  # 5 frames padded to the bucket
    assert len(launches["captured_per_replay"]) == 1 and launches["replays"] == 2 * steps


def test_graphs_captured_again_on_new_weights(bat_pair, monkeypatch):
    """A captured graph keeps the folded weights it was captured with: the
    tracker keeps one graph per shape and captures again after the model's
    weights change (here a load_state_dict, an in-place copy)."""
    _, (port, pcfg) = bat_pair
    captured = []

    class FakeGraph:
        def __init__(self, step, B, P, P1, carry0, gt_mode, device):
            captured.append((B, P, P1))

    monkeypatch.setattr(psm, "_MatchStepGraph", FakeGraph)
    tr = psm.MatchScanTracker(port, pcfg, **KW)
    carry = tr._carry0(torch.zeros(2, 4), torch.ones(2, 3))
    first = tr._graph_for(2, MAX_POINTS, FIRST_CROP, carry)
    assert tr._graph_for(2, MAX_POINTS, FIRST_CROP, carry) is first
    tr._graph_for(2, MAX_POINTS, 64, carry)
    port.net.load_state_dict(port.net.state_dict())
    assert tr._graph_for(2, MAX_POINTS, FIRST_CROP, carry) is not first
    assert captured == [(2, MAX_POINTS, FIRST_CROP), (2, MAX_POINTS, 64),
                        (2, MAX_POINTS, FIRST_CROP)]
    assert tr.replays == 0


def test_refusals(bat_pair):
    _, (port, pcfg) = bat_pair
    # bf16 is no longer refused: the tracker runs the model it is given, a
    # bf16 one too (tests/test_torch_bf16.py)
    bf16 = pcfg.copy()
    bf16.bf16 = True
    assert psm.MatchScanTracker(port, bf16).model is port
    bad = pcfg.copy()
    bad.reference_BB = "next_gt"
    with pytest.raises(ValueError, match="reference_BB"):
        psm.MatchScanTracker(port, bad)
    with pytest.raises(ValueError, match="reference_BB"):  # raises: no fallback to the host loop
        psm.evaluate_dataset_scan_matching(port, get_dataset(pcfg, "test", "test"), bad)
    bad = pcfg.copy()
    bad.up_axis = [1, 0, 0]
    with pytest.raises(ValueError, match="up_axis"):
        psm.MatchScanTracker(port, bad)
    with pytest.raises(ValueError, match="transfer_dtype"):
        psm.MatchScanTracker(port, pcfg, transfer_dtype="int8")


@pytest.mark.parametrize("args", [
    ["--cfg", "cfgs/P2B_synthetic.yaml"],
    ["--cfg", "cfgs/BAT_synthetic.yaml", "--host_metrics", "--transfer_quant", "int16"]],
    ids=["p2b", "bat-host_metrics-int16"])
def test_cli_tracker_scan(args, capsys):
    port_main.main(args + ["--test", "--tracker", "scan", "--device", "cpu",
                           "--max_tracklets", "2"])
    cfg = load_config(args[1], {"transfer_quant": "int16"} if "int16" in args else None)
    model = get_model(cfg.net_model)(cfg, device="cpu")
    model.net.load_state_dict(state_dict_from_jax(random_variables(model.net, cfg.seed)))
    want = psm.evaluate_dataset_scan_matching(model, get_dataset(cfg, "test", "test"), cfg,
                                              max_tracklets=2,
                                              device_metrics="--host_metrics" not in args)
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last == f"success/test: {want[0]:.2f}  precision/test: {want[1]:.2f}"


@pytest.mark.parametrize("val_tracker", ["scan", "host"])
def test_trainer_validates_on_the_scan_tracker(val_tracker, tmp_path):
    """val_tracker 'scan' validates through one MatchScanTracker (kept
    across epochs, its graphs keyed on the weights) and gives what the
    scan evaluation gives on the trained weights; 'host' the host loop's."""
    from open3dsot_tpu_torch.tracking.eval import evaluate_dataset
    from open3dsot_tpu_torch.train.trainer import Trainer

    _, (port, pcfg) = _pair("p2b", val_tracker=val_tracker, batch_size=4,
                            objectiveness_weight=1.5, box_weight=0.2, vote_weight=1.0,
                            seg_weight=0.2)
    val = get_dataset(pcfg, "test", "test")
    trainer = Trainer(port, pcfg, work_dir=str(tmp_path))
    history = trainer.fit(get_dataset(pcfg, "train_siamese", "train"), val, epochs=1,
                          steps_per_epoch=1)
    assert port.net.training  # back in training mode after validation
    got = (history[-1]["success"], history[-1]["precision"])
    port.net.eval()
    if val_tracker == "scan":
        assert isinstance(trainer._val_scan, psm.MatchScanTracker)
        assert "batches" in trainer._val_prep_cache
        want = psm.evaluate_dataset_scan_matching(port, val, pcfg)
    else:
        assert trainer._val_scan is None
        want = evaluate_dataset(port, val, pcfg)
    assert got == want
