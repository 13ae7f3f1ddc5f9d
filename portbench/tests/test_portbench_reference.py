"""The plain references against the port's plain CPU path at toy sizes:
the same weights and inputs give the same outputs (the port's kernels run
their plain versions on the CPU). Also the frozen copies of the host
padding, the first crop and the scores."""

import json

import numpy as np
import pytest
import torch

from portbench import harness, weights
from portbench.reference import bat as ref_bat
from portbench.reference import common
from portbench.reference import m2track as ref_m2

SEED = 2**33 + 3


def _cfg(name, **over):
    from open3dsot_tpu_torch.config import make_config

    conf = harness.load_json(harness.HERE / "configs" / f"{name}.json")
    d = {k: v for k, v in conf.items() if k not in harness.META_KEYS}
    d.update(conf["assumed"], **over)
    return d, make_config(dict(d))


BAT_TOY = dict(feature_channel=32, hidden_channel=32, out_channel=32, vote_channel=32,
               template_size=64, search_size=128, num_proposal=16)


def _model(name, cfg, sd):
    from open3dsot_tpu_torch.models import get_model

    m = get_model(name)(cfg, device="cpu", fused_eval=False)
    m.net.load_state_dict(sd)
    return m


def test_m2_weights_and_forward_equal_the_port():
    d, cfg = _cfg("m2track_kitti_car")
    sd = weights.make(ref_m2.param_specs(), SEED, "cpu")
    m = _model("m2track", cfg, sd)
    assert list(m.net.state_dict()) == [s[0] for s in ref_m2.param_specs()]
    g = torch.Generator().manual_seed(1)
    pts, bc = torch.randn(3, 96, 5, generator=g), torch.rand(3, 96, 9, generator=g)
    with torch.no_grad():
        want = m.net(pts, bc)["estimation_boxes"]
    torch.testing.assert_close(ref_m2.forward(sd, pts, bc)["estimation_boxes"], want,
                               rtol=1e-5, atol=1e-5)


def _frames(B, P, n_valid, g):
    pts = torch.randn(B, P, 3, generator=g) * 2.0
    valid = torch.arange(P)[None, :] < torch.tensor(n_valid)[:, None]
    return pts, valid


@pytest.mark.parametrize("first", [True, False])
def test_m2_step_equals_the_scan_step(first):
    from open3dsot_tpu_torch.tracking.scan_tracker import make_m2_step

    d, cfg = _cfg("m2track_kitti_car", point_sample_size=48)
    sd = weights.make(ref_m2.param_specs(), SEED, "cpu")
    m = _model("m2track", cfg, sd)
    g = torch.Generator().manual_seed(2)
    prev, prev_ok = _frames(2, 128, [128, 60], g)
    this, this_ok = _frames(2, 128, [100, 128], g)
    wlh = torch.tensor([[1.8, 4.0, 1.5], [1.6, 3.5, 1.6]])
    box = torch.tensor([[0.1, -0.2, 0.0, 0.3], [0.5, 0.4, -0.1, -2.0]])
    step = make_m2_step(m.net, cfg, None, True)
    want = step(wlh, box, prev, prev_ok, this, this_ok, torch.tensor(0 if first else 3))
    got = ref_m2.step(sd, d, wlh, box, prev, prev_ok, this, this_ok,
                      torch.full((2, 1), first))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_bat_weights_and_forward_equal_the_port():
    d, cfg = _cfg("bat_kitti_car", **BAT_TOY)
    sd = weights.make(ref_bat.param_specs(d), SEED, "cpu")
    m = _model("bat", cfg, sd)
    assert list(m.net.state_dict()) == [s[0] for s in ref_bat.param_specs(d)]
    g = torch.Generator().manual_seed(3)
    t, s = torch.randn(2, 64, 3, generator=g), torch.randn(2, 128, 3, generator=g)
    bc = torch.rand(2, 64, 9, generator=g)
    with torch.no_grad():
        want = m.net(t, s, bc)["estimation_boxes"]
    torch.testing.assert_close(ref_bat.forward(sd, d, t, s, bc), want, rtol=1e-4, atol=1e-5)


def test_bat_step_holds_the_scan_steps_box_among_its_proposals():
    from open3dsot_tpu_torch.tracking.scan_matching import make_match_step

    d, cfg = _cfg("bat_kitti_car", **BAT_TOY)
    sd = weights.make(ref_bat.param_specs(d), SEED, "cpu")
    m = _model("bat", cfg, sd)
    g = torch.Generator().manual_seed(4)
    first = torch.randn(2, 32, 3, generator=g) * 0.8
    first_ok = torch.arange(32)[None, :] < torch.tensor([[32], [20]])
    prev, prev_ok = _frames(2, 128, [128, 90], g)
    this, this_ok = _frames(2, 128, [128, 128], g)
    wlh = torch.tensor([[1.8, 4.0, 1.5], [1.6, 3.5, 1.6]])
    box = torch.tensor([[0.1, -0.2, 0.0, 0.3], [0.5, 0.4, -0.1, -2.0]])
    step = make_match_step(m.net, cfg, None, True, "firstandprevious", gt_mode=False)
    (want, _), _ = step(first, first_ok, (box, wlh), (prev, prev_ok, this, this_ok))
    cand, score = ref_bat.step(sd, d, wlh, box, first, first_ok, prev, prev_ok, this, this_ok)
    best = cand[torch.arange(2), score.argmax(dim=1)]
    torch.testing.assert_close(best, want, rtol=1e-5, atol=1e-5)


def test_first_crop_equals_the_online_reset():
    from open3dsot_tpu_torch.geometry import Box, PointCloud, Quaternion
    from open3dsot_tpu_torch.tracking.online import OnlineMatchTracker

    d, cfg = _cfg("bat_kitti_car", **BAT_TOY)
    m = _model("bat", cfg, weights.make(ref_bat.param_specs(d), SEED, "cpu"))
    tracker = OnlineMatchTracker(m, cfg, max_streams=2, max_points=256, first_crop_points=64)
    rng = np.random.default_rng(5)
    pts = (rng.uniform(-3, 3, size=(300, 3))).astype(np.float32)
    center, theta, wlh = np.array([0.3, -0.2, 0.1]), 0.7, np.array([1.8, 4.0, 1.5])
    tracker.reset(1, PointCloud(pts.T), Box(center, wlh, Quaternion(axis=[0, 0, 1], radians=theta)))
    got, n = ref_bat.first_crop(pts, center, theta, wlh, d, 64)
    assert n == int(tracker._state["first_count"][1])
    np.testing.assert_allclose(got, tracker._state["first_pts"][1].numpy(), atol=1e-6)


@pytest.mark.parametrize("N", [50, 128, 400])
def test_pad_frame_copy_equals_the_port(N):
    from open3dsot_tpu_torch.tracking.scan_tracker import pad_frame

    p = np.random.default_rng(N).normal(size=(N, 3)).astype(np.float32)
    for a, b in zip(common.pad_frame(p, 128), pad_frame(p, 128)):
        np.testing.assert_array_equal(a, b)


def test_scores_equal_the_ports_device_scores():
    from open3dsot_tpu_torch.geometry.iou_device import overlap_accuracy

    rng = np.random.default_rng(6)
    a = np.column_stack([rng.normal(size=(40, 3)) * 0.5, rng.uniform(-3, 3, 40)])
    b = a + np.column_stack([rng.normal(size=(40, 3)) * 0.3, rng.normal(size=40) * 0.3])
    wa, wb = rng.uniform([1.5, 3.2, 1.4], [2, 4.5, 1.8], (40, 3)), rng.uniform(1, 4, (40, 3))
    iou, dist = overlap_accuracy(*(torch.tensor(x, dtype=torch.float64) for x in (a, wa, b, wb)),
                                 dim=3, up_idx=2)
    for i in range(40):
        want = common.overlap_accuracy(a[i], wa[i], b[i], wb[i])
        assert want[0] == pytest.approx(float(iou[i]), abs=2e-6)  # the port scores in float32
        assert want[1] == pytest.approx(float(dist[i]), abs=2e-6)
