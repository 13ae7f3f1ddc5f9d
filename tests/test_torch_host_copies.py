"""Each numpy host module that the port carries as a copy gives the
original's output on seeded inputs (config, quaternion, data_classes,
points_utils, iou, metrics, synthetic data, the test and siamese training
samplers, the search spaces, the batch loader, the scalar logger, the
visualization writers, the nuScenes split and category tables, the ops'
numpy references, the Stopwatch; the real datasets' loaders are held in
tests/test_torch_datasets.py)."""

from __future__ import annotations

import numpy as np
import pytest

import open3dsot_tpu.config as j_config
import open3dsot_tpu.geometry.iou as j_iou
import open3dsot_tpu.geometry.points_utils as j_pu
import open3dsot_tpu.geometry.rigid as j_rigid
import open3dsot_tpu.utils.metrics as j_metrics
import open3dsot_tpu.utils.quant as j_quant
from open3dsot_tpu.data import get_dataset as j_get_dataset
from open3dsot_tpu.geometry import Box as JBox
from open3dsot_tpu.geometry import PointCloud as JPC
from open3dsot_tpu.geometry import Quaternion as JQ
import open3dsot_tpu_torch.config as p_config
import open3dsot_tpu_torch.geometry.iou as p_iou
import open3dsot_tpu_torch.geometry.points_utils as p_pu
import open3dsot_tpu_torch.geometry.rigid as p_rigid
import open3dsot_tpu_torch.utils.metrics as p_metrics
import open3dsot_tpu_torch.utils.quant as p_quant
from open3dsot_tpu_torch.data import get_dataset as p_get_dataset
from open3dsot_tpu_torch.geometry import Box as PBox
from open3dsot_tpu_torch.geometry import PointCloud as PPC
from open3dsot_tpu_torch.geometry import Quaternion as PQ


def _boxes(seed, n=6):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        c = rng.uniform(-5, 5, 3)
        wlh = rng.uniform(1, 4, 3)
        ang = rng.uniform(-np.pi, np.pi)
        out.append((JBox(c, wlh, JQ(axis=[0, 0, 1], radians=ang)),
                    PBox(c, wlh, PQ(axis=[0, 0, 1], radians=ang))))
    return out


def test_config_copy():
    for path in ("cfgs/M2_track_synthetic.yaml", "cfgs/M2_track_kitti.yaml", "cfgs/BAT_Car.yaml",
                 "cfgs/BAT_synthetic.yaml", "cfgs/P2B_synthetic.yaml"):
        over = {"seed": 3, "point_sample_size": 64}
        assert p_config.load_config(path, over).to_dict() == j_config.load_config(path, over).to_dict()
    assert p_config.DEFAULTS == j_config.DEFAULTS
    with pytest.raises(ValueError):
        p_config.make_config({"coordinate_mode": "bogus"})


def test_quaternion_copy():
    rng = np.random.default_rng(0)
    for _ in range(5):
        axis, ang = rng.standard_normal(3), rng.uniform(-3, 3)
        jq, pq = JQ(axis=axis, radians=ang), PQ(axis=axis, radians=ang)
        np.testing.assert_array_equal(pq.rotation_matrix, jq.rotation_matrix)
        np.testing.assert_array_equal(PQ(matrix=pq.rotation_matrix).elements,
                                      JQ(matrix=jq.rotation_matrix).elements)
        np.testing.assert_array_equal((pq * pq.inverse).elements, (jq * jq.inverse).elements)
        assert pq.radians == jq.radians and pq.degrees == jq.degrees
        np.testing.assert_array_equal(pq.axis, jq.axis)


def test_box_and_pointcloud_copy():
    rng = np.random.default_rng(1)
    for jb, pb in _boxes(1):
        np.testing.assert_array_equal(pb.corners(1.25), jb.corners(1.25))
        np.testing.assert_array_equal(pb.bottom_corners(), jb.bottom_corners())
        q = rng.uniform(-1, 1)
        jb.rotate(JQ(axis=[0, 0, 1], radians=q))
        pb.rotate(PQ(axis=[0, 0, 1], radians=q))
        jb.translate([1.0, 2.0, 3.0])
        pb.translate([1.0, 2.0, 3.0])
        np.testing.assert_array_equal(pb.center, jb.center)
        np.testing.assert_array_equal(pb.orientation.elements, jb.orientation.elements)
    pts = rng.standard_normal((3, 50))
    jp, pp = JPC(pts.copy()), PPC(pts.copy())
    R = JQ(axis=[0, 0, 1], radians=0.3).rotation_matrix
    jp.rotate(R)
    pp.rotate(R)
    np.testing.assert_array_equal(pp.points, jp.points)


def test_points_utils_copy():
    rng = np.random.default_rng(2)
    for k, (jb, pb) in enumerate(_boxes(2)):
        pts = (rng.uniform(-8, 8, (3, 400))).astype(np.float32)
        jsub = j_pu.generate_subwindow(JPC(pts.copy()), jb, scale=1.25, offset=2)
        psub = p_pu.generate_subwindow(PPC(pts.copy()), pb, scale=1.25, offset=2)
        # the original may take its native C++ crop (same strict-bound
        # semantics, tests/test_native.py): same points up to rounding
        np.testing.assert_allclose(psub.points, jsub.points, atol=1e-5)
        jc, pc = j_pu.transform_box(jb, jb), p_pu.transform_box(pb, pb)
        np.testing.assert_array_equal(pc.center, jc.center)
        np.testing.assert_array_equal(p_pu.points_in_box(pc, pts, 1.25),
                                      j_pu.points_in_box(jc, pts, 1.25))
        np.testing.assert_array_equal(p_pu.get_point_to_box_distance(pts.T, pc),
                                      j_pu.get_point_to_box_distance(pts.T, jc))
        a, ia = p_pu.regularize_pc(pts.T, 64 + k * 100, seed=1)
        b, ib = j_pu.regularize_pc(pts.T, 64 + k * 100, seed=1)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ia, ib)
        off = rng.uniform(-1, 1, 4)
        for kw in (dict(degrees=False, use_z=True, limit_box=False),
                   dict(degrees=True, use_z=False, limit_box=False)):
            po, jo = p_pu.getOffsetBB(pb, off, **kw), j_pu.getOffsetBB(jb, off, **kw)
            np.testing.assert_array_equal(po.center, jo.center)
            np.testing.assert_array_equal(po.orientation.elements, jo.orientation.elements)
        # the matching trackers' template: crop + centre one frame, or merge two
        jcc, jcb = j_pu.cropAndCenterPC(JPC(pts.copy()), jb, offset=0.5, scale=1.25)
        pcc, pcb = p_pu.cropAndCenterPC(PPC(pts.copy()), pb, offset=0.5, scale=1.25)
        np.testing.assert_array_equal(pcc.points, jcc.points)
        np.testing.assert_array_equal(pcb.center, jcb.center)
        jb2, pb2 = _boxes(10 + k, n=1)[0]
        jm, jmb = j_pu.getModel([JPC(pts.copy()), JPC(pts[:, ::-1].copy())], [jb, jb2], scale=2.0)
        pm, pmb = p_pu.getModel([PPC(pts.copy()), PPC(pts[:, ::-1].copy())], [pb, pb2], scale=2.0)
        np.testing.assert_array_equal(pm.points, jm.points)
        np.testing.assert_array_equal(pmb.orientation.elements, jmb.orientation.elements)


def test_iou_copy():
    boxes = _boxes(3)
    for (ja, pa), (jb, pb) in zip(boxes, boxes[1:] + boxes[:1]):
        for dim in (2, 3):
            assert (p_iou.estimateOverlap(pa, pb, dim=dim, up_axis=[0, 0, 1])
                    == j_iou.estimateOverlap(ja, jb, dim=dim, up_axis=[0, 0, 1]))
            assert (p_iou.estimateAccuracy(pa, pb, dim=dim, up_axis=[0, 0, 1])
                    == j_iou.estimateAccuracy(ja, jb, dim=dim, up_axis=[0, 0, 1]))
        assert p_iou.estimateOverlap(pa, pa, dim=3, up_axis=[0, 0, 1]) == pytest.approx(1.0)


@pytest.mark.parametrize("up_axis", [(0, 0, 1), (0, -1, 0)])
def test_rigid_host_functions_copy(up_axis):
    """theta_from_rotation / rotation_from_theta (numpy) in both bases."""
    pA, jA = p_rigid.up_frame(up_axis), j_rigid.up_frame(up_axis)
    pA = None if pA is None else pA.numpy()
    jA = None if jA is None else np.asarray(jA)
    for theta in np.random.default_rng(5).uniform(-np.pi, np.pi, 8):
        R = p_rigid.rotation_from_theta(theta, pA)
        np.testing.assert_array_equal(R, j_rigid.rotation_from_theta(theta, jA))
        got = p_rigid.theta_from_rotation(R, pA)
        assert got == j_rigid.theta_from_rotation(R, jA)
        assert abs(got - theta) < 1e-12


def test_quantize_per_sample_copy():
    rng = np.random.default_rng(6)
    pts = (rng.normal(0, 30, (4, 3, 40, 3)) + 50).astype(np.float32)
    valid = rng.random((4, 3, 40)) > 0.4
    valid[2] = False
    for got, want in zip(p_quant.quantize_per_sample(pts, valid),
                         j_quant._quantize_per_sample_numpy(pts, valid)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_metrics_copy():
    rng = np.random.default_rng(4)
    for P, J, scale in ((p_metrics.Success, j_metrics.Success, 1.0),
                        (p_metrics.Precision, j_metrics.Precision, 2.5)):
        p, j = P(), J()
        for _ in range(3):
            v = rng.uniform(0, scale, 17)
            p.update(v)
            j.update(v)
        assert p.compute() == j.compute()
        np.testing.assert_array_equal(p.state(), j.state())


def test_synthetic_dataset_and_test_sampler_copy():
    over = dict(syn_num_tracklets=2, syn_tracklet_len=3, seed=9)
    jcfg = j_config.load_config("cfgs/M2_track_synthetic.yaml", over)
    pcfg = p_config.load_config("cfgs/M2_track_synthetic.yaml", over)
    js, ps = j_get_dataset(jcfg, "test", "test"), p_get_dataset(pcfg, "test", "test")
    assert len(js) == len(ps) == 2
    for i in range(2):
        for jf, pf in zip(js[i], ps[i]):
            np.testing.assert_array_equal(pf["pc"].points, jf["pc"].points)
            np.testing.assert_array_equal(pf["3d_bbox"].center, jf["3d_bbox"].center)
            np.testing.assert_array_equal(pf["3d_bbox"].wlh, jf["3d_bbox"].wlh)


def test_unported_datasets_and_models_are_refused():
    """What the port does not run raises: an unknown dataset or sampler
    type, an unknown model (the real datasets load since their copies
    came, tests/test_torch_datasets.py). The siamese and the motion training
    samplers run."""
    from open3dsot_tpu_torch.models import get_model

    with pytest.raises(ValueError, match="unknown dataset 'argoverse'"):
        p_get_dataset(p_config.make_config({"dataset": "argoverse"}), "test", "test")
    cfg = p_config.make_config({"dataset": "synthetic"})
    with pytest.raises(ValueError, match="unknown dataset type"):
        p_get_dataset(cfg, "train_flow", "train")
    assert len(p_get_dataset(cfg, "train_motion", "train")) > 0
    assert len(p_get_dataset(cfg, "train_siamese", "train")) > 0
    with pytest.raises(ValueError, match="unknown model"):
        get_model("votenet")


def test_visualization_writers_copy(tmp_path):
    """get_3d_box, write_ply (with and without colours), write_obj, box2obj
    and write_bbox write the original's files byte for byte."""
    import open3dsot_tpu.utils.visualization as j_vis
    import open3dsot_tpu_torch.utils.visualization as p_vis

    rng = np.random.default_rng(7)
    np.testing.assert_array_equal(p_vis.get_3d_box((1.6, 3.9, 1.5), 0.3, [1.0, 2.0, 0.5]),
                                  j_vis.get_3d_box((1.6, 3.9, 1.5), 0.3, [1.0, 2.0, 0.5]))
    pts = rng.standard_normal((20, 3)).astype(np.float32)
    colors = rng.integers(0, 255, (20, 3))
    jb, pb = _boxes(7, n=1)[0]
    corners = jb.corners().T
    for tag, vis, box in (("j", j_vis, jb), ("p", p_vis, pb)):
        vis.write_ply(pts, str(tmp_path / f"{tag}.ply"))
        vis.write_ply(pts, str(tmp_path / f"{tag}_c.ply"), colors=colors)
        vis.write_obj(pts, str(tmp_path / f"{tag}_pts"))
        vis.box2obj(box, str(tmp_path / f"{tag}_box.obj"))
        vis.write_bbox(corners, 2, str(tmp_path / f"{tag}_bbox.ply"))
    for name in (".ply", "_c.ply", "_pts.obj", "_box.obj", "_bbox.ply"):
        assert (tmp_path / f"p{name}").read_bytes() == (tmp_path / f"j{name}").read_bytes(), name


def test_nuscenes_split_tables_copy():
    """The vendored split constants and their checks are the original's."""
    import open3dsot_tpu.data.nuscenes_splits as j_ns
    import open3dsot_tpu_torch.data.nuscenes_splits as p_ns

    assert p_ns.MINI_TRAIN == j_ns.MINI_TRAIN and p_ns.MINI_VAL == j_ns.MINI_VAL
    assert p_ns._EXPECTED_SIZES == j_ns._EXPECTED_SIZES
    assert p_ns._vendored_splits() == j_ns._vendored_splits()
    for split in ("mini_train", "mini_val"):
        assert p_ns.get_split_scenes(split) == j_ns.get_split_scenes(split)


def test_nuscenes_category_tables_copy():
    import open3dsot_tpu.data.nuscenes_data as j_nd
    import open3dsot_tpu_torch.data.nuscenes_data as p_nd

    assert p_nd.general_to_tracking_class == j_nd.general_to_tracking_class
    assert p_nd.tracking_to_general_class == j_nd.tracking_to_general_class


def test_kalman_search_space_copy():
    from open3dsot_tpu.data.searchspace import KalmanFiltering as JK
    from open3dsot_tpu_torch.data.searchspace import KalmanFiltering as PK

    jk, pk = JK(bnd=[1, 1, 5]), PK(bnd=[1, 1, 5])
    rng = np.random.default_rng(6)
    data, score = rng.standard_normal((12, 3)), rng.uniform(0, 1, 12)
    jk.addData(data, score)
    pk.addData(data, score)
    np.random.seed(2)
    want = jk.sample(7)
    np.random.seed(2)
    np.testing.assert_array_equal(pk.sample(7), want)


def test_other_search_spaces_copy():
    """ExhaustiveSearch's grid, ParticleFiltering's draws around its scored
    data, and the Gaussian mixture: the weighted EM fit (weights, means,
    covariances) and the draws from it, unfitted and fitted, under one
    numpy seed."""
    import open3dsot_tpu.data.searchspace as j_ss
    import open3dsot_tpu_torch.data.searchspace as p_ss

    for kw in ({}, dict(search_space=((-1.0, 2.0), (-2.0, 2.0), (-5.0, 5.0)),
                        search_dims=(3, 4, 5))):
        np.testing.assert_array_equal(p_ss.ExhaustiveSearch(**kw).sample(),
                                      j_ss.ExhaustiveSearch(**kw).sample())
    rng = np.random.default_rng(8)
    data, score = rng.standard_normal((30, 3)) * [1.0, 1.0, 5.0], rng.uniform(0, 1, 30)

    def draws(space, n):
        np.random.seed(4)
        return space.sample(n)

    spaces = [(cls(bnd=[1, 1, 5]), getattr(j_ss, cls.__name__)(bnd=[1, 1, 5]))
              for cls in (p_ss.ParticleFiltering, p_ss.KalmanFiltering)]
    spaces.append((p_ss.GaussianMixtureModel(n_comp=3), j_ss.GaussianMixtureModel(n_comp=3)))
    for ps_, js_ in spaces:
        assert isinstance(ps_, p_ss.SearchSpace)
        np.testing.assert_array_equal(draws(ps_, 10), draws(js_, 10))  # before any data
        ps_.addData(data, score)
        js_.addData(data, score)
        np.testing.assert_array_equal(draws(ps_, 10), draws(js_, 10))
    gp, gj = spaces[-1]
    for a, b in zip((gp._pi, gp._means, gp._covs), (gj._pi, gj._means, gj._covs)):
        np.testing.assert_array_equal(a, b)
    w = score / score.sum()
    for a, b in zip(p_ss._weighted_em_gmm(data, w, 4, iters=20, seed=3),
                    j_ss._weighted_em_gmm(data, w, 4, iters=20, seed=3)):
        np.testing.assert_array_equal(a, b)
    assert np.isclose(gp._pi.sum(), 1.0) and gp._means.shape == (3, 3)


def test_op_references_copy():
    """ops/reference.py's golden models: FPS, ball query, kNN and 3-NN."""
    import open3dsot_tpu.ops.reference as j_ref
    import open3dsot_tpu_torch.ops.reference as p_ref

    rng = np.random.default_rng(9)
    xyz = rng.uniform(-1, 1, (2, 64, 3)).astype(np.float32)
    new = xyz[:, :10]
    np.testing.assert_array_equal(p_ref.fps_ref(xyz, 16), j_ref.fps_ref(xyz, 16))
    np.testing.assert_array_equal(p_ref.ball_query_ref(0.4, 8, xyz, new),
                                  j_ref.ball_query_ref(0.4, 8, xyz, new))
    np.testing.assert_array_equal(p_ref.knn_ref(new, xyz, 5), j_ref.knn_ref(new, xyz, 5))
    for a, b in zip(p_ref.three_nn_ref(new, xyz), j_ref.three_nn_ref(new, xyz)):
        np.testing.assert_array_equal(a, b)


def test_stopwatch_copy_and_trace(tmp_path):
    """Stopwatch accumulates as the original (counts and keys; the times are
    the clock's); trace writes a Chrome trace holding annotate's span."""
    import json

    from open3dsot_tpu.utils.profiling import Stopwatch as JS
    from open3dsot_tpu_torch.utils.profiling import Stopwatch as PS
    from open3dsot_tpu_torch.utils.profiling import annotate, trace

    summaries = []
    for sw in (PS(), JS()):
        for name in ("sample", "step", "sample"):
            with sw(name):
                pass
        summaries.append(sw.summary())
    for got, want in zip(*(sorted(s.items()) for s in summaries)):
        assert got[0] == want[0] and got[1]["count"] == want[1]["count"]
        assert set(got[1]) == set(want[1]) == {"total_s", "count", "mean_ms"}
    import torch

    with trace(str(tmp_path / "tr")):
        with annotate("span_of_the_test"):
            torch.ones(8).sum()
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "span_of_the_test" for e in events)


@pytest.mark.parametrize("cfg_path", ["cfgs/BAT_synthetic.yaml", "cfgs/P2B_synthetic.yaml"])
def test_siamese_sampler_copy(cfg_path, monkeypatch):
    """Same numpy seed, same training pairs (offsets, crops, labels,
    BoxClouds). The original crops with its native library when it is
    built; the port copies the numpy path, so the original takes it too."""
    monkeypatch.setenv("OPEN3DSOT_TPU_NATIVE", "0")
    over = dict(syn_num_tracklets=2, syn_tracklet_len=4, seed=8)
    js = j_get_dataset(j_config.load_config(cfg_path, over), "train_siamese", "train")
    ps = p_get_dataset(p_config.load_config(cfg_path, over), "train_siamese", "train")
    assert len(js) == len(ps) == 16
    for i in (0, 1, 5, 14):
        np.random.seed(100 + i)
        want = js[i]
        np.random.seed(100 + i)
        got = ps[i]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("augment", [False, True])
def test_motion_sampler_copy(augment, monkeypatch):
    """M2-Track's motion samples (motion_processing, MotionTrackingSampler):
    the same numpy seed gives the same perturbed reference box, crops,
    labels, motion-state label and BoxClouds, with the augmentation of both
    frames too."""
    monkeypatch.setenv("OPEN3DSOT_TPU_NATIVE", "0")
    over = dict(syn_num_tracklets=2, syn_tracklet_len=4, seed=8, use_augmentation=augment,
                point_sample_size=64)
    js = j_get_dataset(j_config.load_config("cfgs/M2_track_synthetic.yaml", over),
                       "train_motion", "train")
    ps = p_get_dataset(p_config.load_config("cfgs/M2_track_synthetic.yaml", over),
                       "train_motion", "train")
    assert type(ps).__name__ == "MotionTrackingSampler" and len(js) == len(ps) == 16
    for i in (0, 1, 5, 14):
        np.random.seed(200 + i)
        want = js[i]
        np.random.seed(200 + i)
        got = ps[i]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_batch_loader_copy():
    from open3dsot_tpu.data.loader import BatchLoader as JLoader
    from open3dsot_tpu_torch.data.loader import BatchLoader as PLoader

    rng = np.random.default_rng(7)
    samples = [{"x": rng.standard_normal((5, 3)), "y": np.float32(i)} for i in range(11)]
    for kw in (dict(prefetch=2, workers=0), dict(prefetch=0, workers=2)):
        jl, pl = JLoader(samples, 3, seed=4, **kw), PLoader(samples, 3, seed=4, **kw)
        assert len(pl) == len(jl) == 3
        for epoch in (0, 1):
            jl.set_epoch(epoch)
            pl.set_epoch(epoch)
            for jb, pb in zip(jl, pl, strict=True):
                for k in jb:
                    np.testing.assert_array_equal(pb[k], jb[k])


def test_scalar_logger_copy(tmp_path):
    import json

    from open3dsot_tpu.utils.logging import ScalarLogger as JLogger
    from open3dsot_tpu_torch.utils.logging import ScalarLogger as PLogger

    for cls, d in ((JLogger, tmp_path / "j"), (PLogger, tmp_path / "p")):
        log = cls(str(d), enable_tensorboard=False)
        log.log_scalars({"a": 1.5, "b": np.float32(2.0)}, step=3, prefix="loss/")
        log.log_scalars({"c": 4}, step=4)
        log.close()
    records = [[{k: v for k, v in json.loads(line).items() if k != "time"}
                for line in (d / "scalars.jsonl").read_text().splitlines()]
               for d in (tmp_path / "j", tmp_path / "p")]
    assert records[0] == records[1] and len(records[0]) == 2
