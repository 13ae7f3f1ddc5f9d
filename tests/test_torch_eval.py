"""The port's host eval loop (tracking/eval.py) against the JAX one: same
weights, synthetic dataset, 3 tracklets x 6 frames; M2-Track at
point_sample_size 64 and BAT at cfgs/BAT_synthetic.yaml's sizes.

Tracklets are short on purpose: over long ones a tiny float difference can
flip an argmax gate (seg mask, motion state) and the trajectories part for
a reason that is not a fault. Trajectories at atol 1e-3; Success and
Precision equal.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from open3dsot_tpu.config import load_config
from open3dsot_tpu.data import get_dataset as jax_get_dataset
from open3dsot_tpu.models import get_model as jax_get_model
from open3dsot_tpu.tracking import eval as jax_eval
from open3dsot_tpu_torch.config import load_config as port_load_config
from open3dsot_tpu_torch.data import get_dataset
from open3dsot_tpu_torch.models import get_model
from open3dsot_tpu_torch.tracking import eval as port_eval
from open3dsot_tpu_torch.weights import random_variables, state_dict_from_jax

CFG = "cfgs/M2_track_synthetic.yaml"
OVERRIDES = dict(point_sample_size=64, syn_num_tracklets=3, syn_tracklet_len=6, seed=5)


@pytest.fixture(scope="module")
def pair():
    jcfg = load_config(CFG, OVERRIDES)
    pcfg = port_load_config(CFG, OVERRIDES)
    port = get_model("m2track")(pcfg, device="cpu")
    variables = random_variables(port.net, seed=11)
    port.net.load_state_dict(state_dict_from_jax(variables), strict=True)
    jm = jax_get_model("m2track")(jcfg)
    return (jm, variables, jcfg), (port, pcfg)


def test_trajectories_match(pair):
    (jm, variables, jcfg), (port, pcfg) = pair
    jt = jax_eval.Tracker(jm, variables)
    pt = port_eval.Tracker(port)
    js, ps = jax_get_dataset(jcfg, "test", "test"), get_dataset(pcfg, "test", "test")
    assert len(js) == len(ps) == 3
    for i in range(3):
        j_ious, j_dist, j_boxes = jt.evaluate_one_sequence(js[i], jcfg)
        p_ious, p_dist, p_boxes = pt.evaluate_one_sequence(ps[i], pcfg)
        assert len(p_boxes) == len(j_boxes) == 6
        for jb, pb in zip(j_boxes, p_boxes):
            np.testing.assert_allclose(pb.center, jb.center, atol=1e-3)
            np.testing.assert_allclose(pb.rotation_matrix, jb.rotation_matrix, atol=1e-3)
        np.testing.assert_allclose(p_ious, j_ious, atol=1e-3)
        np.testing.assert_allclose(p_dist, j_dist, atol=1e-3)


def test_success_precision_equal(pair):
    (jm, variables, jcfg), (port, pcfg) = pair
    want = jax_eval.evaluate_dataset(jm, variables, jax_get_dataset(jcfg, "test", "test"), jcfg)
    got = port_eval.evaluate_dataset(port, get_dataset(pcfg, "test", "test"), pcfg)
    assert np.isfinite(got).all()
    assert got == want


BAT_CFG = "cfgs/BAT_synthetic.yaml"
BAT_OVERRIDES = dict(syn_num_tracklets=3, syn_tracklet_len=6, seed=5)


@pytest.fixture(scope="module")
def bat_pair():
    jcfg = load_config(BAT_CFG, BAT_OVERRIDES)
    pcfg = port_load_config(BAT_CFG, BAT_OVERRIDES)
    port = get_model("bat")(pcfg, device="cpu")
    variables = random_variables(port.net, seed=12)
    port.net.load_state_dict(state_dict_from_jax(variables), strict=True)
    return (jax_get_model("bat")(jcfg), variables, jcfg), (port, pcfg)


@pytest.fixture
def numpy_crop(monkeypatch):
    """The JAX package crops search areas with its native C++ library when it
    is built (same points, other rounding; tests/test_native.py); the port
    copies the numpy path, so the JAX side takes it too: the inputs are then
    bit-equal and FPS indices can be compared."""
    monkeypatch.setenv("OPEN3DSOT_TPU_NATIVE", "0")


def test_bat_trajectories_and_metrics_match(bat_pair, numpy_crop):
    (jm, variables, jcfg), (port, pcfg) = bat_pair
    jt = jax_eval.Tracker(jm, variables)
    pt = port_eval.Tracker(port)
    js, ps = jax_get_dataset(jcfg, "test", "test"), get_dataset(pcfg, "test", "test")
    assert len(js) == len(ps) == 3
    for i in range(3):
        data, _ = port.build_input_dict(ps[i], 1, [ps[i][0]["3d_bbox"]])
        jdata, _ = jm.build_input_dict(js[i], 1, [js[i][0]["3d_bbox"]])
        assert set(data) == set(jdata)
        for k in data:
            np.testing.assert_array_equal(data[k], jdata[k], err_msg=k)
        j_ious, j_dist, j_boxes = jt.evaluate_one_sequence(js[i], jcfg)
        p_ious, p_dist, p_boxes = pt.evaluate_one_sequence(ps[i], pcfg)
        assert len(p_boxes) == len(j_boxes) == 6
        for jb, pb in zip(j_boxes, p_boxes):
            np.testing.assert_allclose(pb.center, jb.center, atol=1e-3)
            np.testing.assert_allclose(pb.rotation_matrix, jb.rotation_matrix, atol=1e-3)
        np.testing.assert_allclose(p_ious, j_ious, atol=1e-3)
        np.testing.assert_allclose(p_dist, j_dist, atol=1e-3)
    want = jax_eval.evaluate_dataset(jm, variables, js, jcfg)
    got = port_eval.evaluate_dataset(port, ps, pcfg)
    assert np.isfinite(got).all()
    assert got == want


def test_cli_eval_with_checkpoint(tmp_path, capsys):
    from open3dsot_tpu_torch import main as port_main

    cfg = port_load_config(CFG)
    port = get_model("m2track")(cfg, device="cpu")
    port.net.load_state_dict(state_dict_from_jax(random_variables(port.net, seed=2)))
    ckpt = tmp_path / "port.pt"
    torch.save(port.net.state_dict(), ckpt)
    port_main.main(["--cfg", CFG, "--test", "--checkpoint", str(ckpt), "--max_tracklets", "1",
                    "--device", "cpu"])
    want = port_eval.evaluate_dataset(port, get_dataset(cfg, "test", "test"), cfg, max_tracklets=1)
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last == f"success/test: {want[0]:.2f}  precision/test: {want[1]:.2f}"


@pytest.mark.parametrize("cfg_path", ["cfgs/BAT_synthetic.yaml", "cfgs/P2B_synthetic.yaml"])
def test_cli_eval_matching(cfg_path, capsys):
    from open3dsot_tpu_torch import main as port_main

    port_main.main(["--cfg", cfg_path, "--test", "--max_tracklets", "1", "--device", "cpu"])
    cfg = port_load_config(cfg_path)
    port = get_model(cfg.net_model)(cfg, device="cpu")
    port.net.load_state_dict(state_dict_from_jax(random_variables(port.net, cfg.seed)))
    want = port_eval.evaluate_dataset(port, get_dataset(cfg, "test", "test"), cfg, max_tracklets=1)
    assert np.isfinite(want).all()
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last == f"success/test: {want[0]:.2f}  precision/test: {want[1]:.2f}"
