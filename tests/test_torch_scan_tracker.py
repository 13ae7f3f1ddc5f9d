"""The port's M2-Track scan tracker (tracking/scan_tracker.py) against the
JAX one (fused_chain off, the JAX default), on the CPU, where the port runs
its eager loop and the plain versions of K1/K2. Same weights
(weights.random_variables), same synthetic data (3 tracklets x 6 frames),
M2's widths (box_aware) at point_sample_size 64 and max_points 256.

Tolerances: `_select_fixed` indices exactly; one step's box atol 5e-4 (the
forward's tolerance, tests/test_torch_m2track.py); whole trajectories atol
1e-3 and Success/Precision equal. Tracklets are short on purpose: over
long ones a tiny float difference can flip an argmax gate (seg mask,
motion state) and the trajectories part for a reason that is not a fault.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from open3dsot_tpu.config import load_config as j_load_config
from open3dsot_tpu.data import get_dataset as j_get_dataset
from open3dsot_tpu.geometry import rigid as j_rigid
from open3dsot_tpu.models import get_model as j_get_model
from open3dsot_tpu.tracking import scan_tracker as js
from open3dsot_tpu_torch import main as port_main
from open3dsot_tpu_torch.config import load_config
from open3dsot_tpu_torch.data import get_dataset
from open3dsot_tpu_torch.geometry import rigid
from open3dsot_tpu_torch.models import get_model
from open3dsot_tpu_torch.tracking import scan_tracker as ps
from open3dsot_tpu_torch.weights import random_variables, state_dict_from_jax

CFG = "cfgs/M2_track_synthetic.yaml"
OVERRIDES = dict(point_sample_size=64, syn_num_tracklets=3, syn_tracklet_len=6, seed=5)
CAMERA = dict(coordinate_mode="camera", up_axis=[0, -1, 0])
MAX_POINTS = 256


def _pair(seed: int = 11, offset=None, **over):
    """(JAX model, variables, JAX config), (port model, port config). With
    `offset`, the heads' last layers predict that box offset for every input."""
    over = {**OVERRIDES, **over}
    jcfg, pcfg = j_load_config(CFG, over), load_config(CFG, over)
    port = get_model("m2track")(pcfg, device="cpu")
    variables = random_variables(port.net, seed=seed)
    if offset is not None:
        for head in ("motion_mlp", "final_mlp", "box_mlp"):
            last = variables["params"][head]["layer2"]["dense"]
            last["kernel"][:] = 0
            last["bias"][:] = offset if head == "box_mlp" else 0
    port.net.load_state_dict(state_dict_from_jax(variables), strict=True)
    return (j_get_model("m2track")(jcfg), variables, jcfg), (port, pcfg)


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.fixture(scope="module")
def trackers(pair):
    (jm, variables, jcfg), (port, pcfg) = pair
    return (js.M2ScanTracker(jm, variables, jcfg, max_points=MAX_POINTS, frame_bucket=4),
            ps.M2ScanTracker(port, pcfg, max_points=MAX_POINTS, frame_bucket=4))


def _valid(rng, case: str, B: int, P: int):
    v = rng.random((B, P)) < {"down": 0.95, "up": 0.3, "mixed": 0.6}[case]
    v[0] = False  # an empty row
    v[-1] = True  # a full one
    return v


@pytest.mark.parametrize("case", ["down", "up", "mixed"])
@pytest.mark.parametrize("mode", ["strided", "first"])
def test_select_fixed_indices_match_jax(mode, case):
    """B = 4, P = 64, n = 48: valid counts above n (down), below (up), both."""
    B, P, n = 4, 64, 48
    rng = np.random.default_rng(["down", "up", "mixed"].index(case))
    valid = _valid(rng, case, B, P)
    # the row's index in channel 0 (+1, so an empty row's zeros stand apart)
    pts = np.concatenate([np.broadcast_to(np.arange(1, P + 1, dtype=np.float32)[None, :, None],
                                          (B, P, 1)),
                          rng.standard_normal((B, P, 2)).astype(np.float32)], -1)
    want = np.asarray(js._select_fixed(jnp.asarray(pts), jnp.asarray(valid), n, mode=mode))
    got = ps._select_fixed(torch.from_numpy(pts), torch.from_numpy(valid), n, mode=mode)
    assert got.shape == (B, n, 3) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.all(want[0] == 0)
    assert set(np.unique(want[1:, :, 0]).astype(int)) <= set(np.nonzero(valid.any(0))[0] + 1)


def test_counts_round_trip_and_rejection():
    rng = np.random.default_rng(0)
    counts = rng.integers(0, 33, (3, 5)).astype(np.int32)
    valid = np.arange(32)[None, None, :] < counts[..., None]
    np.testing.assert_array_equal(ps._counts(valid), js._counts(valid))
    np.testing.assert_array_equal(ps._counts(valid), counts)
    back = ps._expand_counts(torch.from_numpy(counts), 32)
    np.testing.assert_array_equal(back.numpy(), np.asarray(js._expand_counts(jnp.asarray(counts), 32)))
    np.testing.assert_array_equal(back.numpy(), valid)
    holey = valid.copy()
    holey[1, 2, 0] = False
    holey[1, 2, 1] = True
    with pytest.raises(ValueError, match="prefix"):
        ps._counts(holey)


@pytest.mark.parametrize("N", [100, 400])
def test_pad_frame_matches_jax(N):
    pts = np.random.default_rng(N).normal(0, 5, (N, 3)).astype(np.float32)
    for got, want in zip(ps.pad_frame(pts, MAX_POINTS), js.pad_frame(pts, MAX_POINTS)):
        np.testing.assert_array_equal(got, want)


def _step_inputs(sampler, first: int, A_np):
    """Two tracklets' frames (first, first + 1) padded, wlh, and the gt box of `first`."""
    seqs = [sampler[0], sampler[1]]
    prev = [ps.pad_frame(s[first]["pc"].points.T, MAX_POINTS) for s in seqs]
    this = [ps.pad_frame(s[first + 1]["pc"].points.T, MAX_POINTS) for s in seqs]
    ref = np.stack([np.append(s[first]["3d_bbox"].center,
                              rigid.theta_from_rotation(s[first]["3d_bbox"].rotation_matrix, A_np))
                    for s in seqs]).astype(np.float32)
    wlh = np.stack([s[0]["3d_bbox"].wlh for s in seqs]).astype(np.float32)
    stack = lambda fr, i: np.stack([f[i] for f in fr])  # noqa: E731
    return wlh, ref, stack(prev, 0), stack(prev, 1), stack(this, 0), stack(this, 1)


@pytest.mark.parametrize("step_idx", [0, 1])
@pytest.mark.parametrize("basis", ["z-up", "camera"])
def test_step_matches_jax(basis, step_idx):
    (jm, variables, jcfg), (port, pcfg) = _pair(**(CAMERA if basis == "camera" else {}))
    jA, pA = j_rigid.up_frame(jcfg.up_axis), rigid.up_frame(pcfg.up_axis)
    assert (jA is None) == (basis == "z-up")
    inputs = _step_inputs(get_dataset(pcfg, "test", "test"), step_idx,
                          None if pA is None else pA.numpy())
    wlh, ref, *xs = inputs
    jstep = js.make_m2_step(jm, jcfg, jA, True)
    want, _ = jstep(variables, jnp.asarray(wlh), jnp.asarray(ref),
                    tuple(jnp.asarray(x) for x in xs) + (jnp.asarray(step_idx),))
    pstep = ps.make_m2_step(port.net, pcfg, pA, True)
    got = pstep(*(torch.from_numpy(x) for x in inputs), torch.tensor(step_idx))
    assert got.shape == (2, 4) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4)
    assert not np.allclose(got.numpy(), ref, atol=1e-3)  # the step moved the box


def test_track_batch_matches_jax(pair, trackers):
    jt, pt = trackers
    seqs = [get_dataset(pair[1][1], "test", "test")[i] for i in range(3)]
    jseqs = [j_get_dataset(pair[0][2], "test", "test")[i] for i in range(3)]
    want, got = jt.track_batch(jseqs), pt.track_batch(seqs)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.shape == (5, 4)
        np.testing.assert_allclose(g, w, atol=1e-3)
    # batched equals one at a time
    for g, s in zip(got, seqs):
        np.testing.assert_allclose(pt.track_batch([s])[0], g, atol=1e-5)


@pytest.mark.parametrize("device_metrics", [True, False])
def test_success_precision_equal(pair, trackers, device_metrics):
    (jm, variables, jcfg), (port, pcfg) = pair
    jt, pt = trackers
    want = js.evaluate_dataset_scan(jm, variables, j_get_dataset(jcfg, "test", "test"), jcfg,
                                    max_points=MAX_POINTS, tracker=jt,
                                    device_metrics=device_metrics)
    sampler = get_dataset(pcfg, "test", "test")
    got = ps.evaluate_dataset_scan(port, sampler, pcfg, max_points=MAX_POINTS, tracker=pt,
                                   device_metrics=device_metrics)
    assert np.isfinite(got).all()
    assert got == want
    # the prep cache gives the same again
    cache = {}
    for _ in range(2):
        again = ps.evaluate_dataset_scan(port, sampler, pcfg, max_points=MAX_POINTS, tracker=pt,
                                         device_metrics=device_metrics, prep_cache=cache)
        assert again == got
    assert "batches" in cache


def test_int16_transfer_matches_jax(pair):
    (jm, variables, jcfg), (port, pcfg) = pair
    jt = js.M2ScanTracker(jm, variables, jcfg, max_points=MAX_POINTS, frame_bucket=4,
                          transfer_dtype="int16")
    pt = ps.M2ScanTracker(port, pcfg, max_points=MAX_POINTS, frame_bucket=4,
                          transfer_dtype="int16")
    want = jt.track_batch([j_get_dataset(jcfg, "test", "test")[i] for i in range(2)])
    got = pt.track_batch([get_dataset(pcfg, "test", "test")[i] for i in range(2)])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-3)


def test_limit_box_zero_matches_jax():
    """Heads that predict an x offset past the box (and y, z, theta within
    it) every frame: the limit sets x to 0 and keeps the rest."""
    over = dict(limit_box=True, limit_box_redraw="zero", syn_num_tracklets=2)
    (jm, variables, jcfg), (port, pcfg) = _pair(seed=13, offset=[5.0, 0.5, 0.3, 0.1], **over)
    seqs = [get_dataset(pcfg, "test", "test")[i] for i in range(2)]
    inputs = _step_inputs(get_dataset(pcfg, "test", "test"), 0, None)
    with torch.no_grad():
        pred = port.net(*_net_inputs(pcfg, inputs))["estimation_boxes"]
    assert (pred[:, 0] > torch.from_numpy(inputs[0][:, 0])).all()  # the offsets exceed the box
    step = ps.make_m2_step(port.net, pcfg, None, True)(*(torch.from_numpy(x) for x in inputs),
                                                        torch.tensor(0))
    local = rigid.transform_box_params(step, torch.from_numpy(inputs[1]))
    np.testing.assert_allclose(local.numpy(), [[0.0, 0.5, 0.3, 0.1]] * 2, atol=1e-5)
    jt = js.M2ScanTracker(jm, variables, jcfg, max_points=MAX_POINTS, frame_bucket=4)
    pt = ps.M2ScanTracker(port, pcfg, max_points=MAX_POINTS, frame_bucket=4)
    want = jt.track_batch([j_get_dataset(jcfg, "test", "test")[i] for i in range(2)])
    for g, w in zip(pt.track_batch(seqs), want):
        np.testing.assert_allclose(g, w, atol=1e-3)


def test_limit_box_uniform_matches_jax():
    """The same heads under limit_box_redraw 'uniform': x is redrawn from
    U(-1, 1) keyed on the step (jax.random.fold_in(PRNGKey(2), step)), the
    rest kept; one step at the tolerance of the forward, then whole
    trajectories."""
    over = dict(limit_box=True, limit_box_redraw="uniform", syn_num_tracklets=2)
    (jm, variables, jcfg), (port, pcfg) = _pair(seed=13, offset=[5.0, 0.5, 0.3, 0.1], **over)
    inputs = _step_inputs(get_dataset(pcfg, "test", "test"), 1, None)
    wlh, ref, *xs = inputs
    want, _ = js.make_m2_step(jm, jcfg, None, True)(
        variables, jnp.asarray(wlh), jnp.asarray(ref),
        tuple(jnp.asarray(x) for x in xs) + (jnp.asarray(3),))
    got = ps.make_m2_step(port.net, pcfg, None, True)(*(torch.from_numpy(x) for x in inputs),
                                                      torch.tensor(3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4)
    local = rigid.transform_box_params(got, torch.from_numpy(ref)).numpy()
    assert np.all(np.abs(local[:, 0]) < 1.0) and np.all(local[:, 0] != 0.0)  # redrawn
    np.testing.assert_allclose(local[:, 1:], [[0.5, 0.3, 0.1]] * 2, atol=1e-5)
    jt = js.M2ScanTracker(jm, variables, jcfg, max_points=MAX_POINTS, frame_bucket=4)
    pt = ps.M2ScanTracker(port, pcfg, max_points=MAX_POINTS, frame_bucket=4)
    want = jt.track_batch([j_get_dataset(jcfg, "test", "test")[i] for i in range(2)])
    for g, w in zip(pt.track_batch([get_dataset(pcfg, "test", "test")[i] for i in range(2)]),
                    want):
        np.testing.assert_allclose(g, w, atol=1e-3)


def _net_inputs(pcfg, inputs):
    """The first step's forward inputs, as make_m2_step builds them."""
    captured = {}

    def spy(points, bc):
        captured["x"] = (points, bc)
        return {"estimation_boxes": points.new_zeros(points.shape[0], 4)}

    ps.make_m2_step(spy, pcfg, None, pcfg.box_aware)(*(torch.from_numpy(x) for x in inputs),
                                                     torch.tensor(0))
    return captured["x"]


def test_graphs_captured_again_on_new_weights(pair, monkeypatch):
    """A captured graph keeps the folded weights it was captured with: the
    tracker keeps one graph per (B, P) and captures again after the model's
    weights change (here a load_state_dict, an in-place copy)."""
    _, (port, pcfg) = pair
    captured = []

    class FakeGraph:
        def __init__(self, step, B, P, device):
            captured.append((B, P))

    monkeypatch.setattr(ps, "_StepGraph", FakeGraph)
    tr = ps.M2ScanTracker(port, pcfg, max_points=MAX_POINTS)
    first = tr._graph_for(2, MAX_POINTS)
    assert tr._graph_for(2, MAX_POINTS) is first and captured == [(2, MAX_POINTS)]
    tr._graph_for(3, MAX_POINTS)
    port.net.load_state_dict(port.net.state_dict())
    assert tr._graph_for(2, MAX_POINTS) is not first
    assert captured == [(2, MAX_POINTS), (3, MAX_POINTS), (2, MAX_POINTS)]
    assert tr.replays == 0


def test_refusals():
    _, (port, pcfg) = _pair()
    # limit_box_redraw 'uniform' is no longer refused: it tracks
    uniform = load_config(CFG, dict(OVERRIDES, limit_box=True, limit_box_redraw="uniform"))
    boxes = ps.M2ScanTracker(port, uniform, max_points=MAX_POINTS, frame_bucket=4).track_batch(
        [get_dataset(uniform, "test", "test")[0]])[0]
    assert boxes.shape == (5, 4) and np.isfinite(boxes).all()
    # bf16 compute is no longer refused: it tracks (tests/test_torch_bf16.py
    # holds it to JAX's), and so does online serving of a bf16 model
    # (tests/test_torch_online_bf16.py holds it to this tracker)
    bf16 = ps.M2ScanTracker(port, pcfg, max_points=MAX_POINTS, frame_bucket=4,
                            compute_dtype=torch.bfloat16)
    boxes = bf16.track_batch([get_dataset(pcfg, "test", "test")[0]])[0]
    assert boxes.shape == (5, 4) and boxes.dtype == np.float32 and np.isfinite(boxes).all()
    bf16_cfg = load_config(CFG, dict(OVERRIDES, bf16=True))
    bf16_model = get_model("m2track")(bf16_cfg, device="cpu")
    from open3dsot_tpu_torch.tracking.online import OnlineM2Tracker

    online = OnlineM2Tracker(bf16_model, bf16_cfg, max_streams=2, max_points=MAX_POINTS)
    assert online.compute_mode == "bfloat16"
    with pytest.raises(ValueError):
        ps.M2ScanTracker(port, pcfg, transfer_dtype="int8")


def test_cli_tracker_scan(capsys):
    port_main.main(["--cfg", CFG, "--test", "--tracker", "scan", "--device", "cpu",
                    "--max_tracklets", "2"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("success/test:") and "precision/test:" in last
    # BAT's --tracker scan, refused before the matching scan tracker was ported, runs
    port_main.main(["--cfg", "cfgs/BAT_synthetic.yaml", "--test", "--tracker", "scan",
                    "--device", "cpu", "--max_tracklets", "2"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("success/test:") and "precision/test:" in last
