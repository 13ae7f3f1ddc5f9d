"""The port's real-dataset loaders (data/kitti.py, nuscenes_data.py,
nuscenes_splits.py, waymo_data.py and get_dataset) against the JAX
package's on fixture files the tests write (tests/test_dataset_loaders.py's
fixtures, and a KITTI label file with several types, tracks and
out-of-order frames): the same tracklets, annos, frame points and boxes,
bit for bit. Also the preload round trip (the port never reads the JAX
package's preload file), the missing-frame fallback, the nuScenes split
cases, and the KITTI loader with pandas blocked."""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from open3dsot_tpu.config import make_config as j_make_config
from open3dsot_tpu.data import get_dataset as j_get_dataset
from open3dsot_tpu.data.kitti import KittiDataset as JKitti
from open3dsot_tpu.data.nuscenes_data import NuScenesDataset as JNusc
from open3dsot_tpu.data.waymo_data import WaymoDataset as JWaymo
from open3dsot_tpu_torch.config import make_config as p_make_config
from open3dsot_tpu_torch.data import get_dataset as p_get_dataset
from open3dsot_tpu_torch.data import nuscenes_splits as p_ns
from open3dsot_tpu_torch.data.kitti import KittiDataset as PKitti
from open3dsot_tpu_torch.data.nuscenes_data import NuScenesDataset as PNusc
from open3dsot_tpu_torch.data.waymo_data import WaymoDataset as PWaymo
import tests._torch_port  # noqa: F401  (one torch thread, as every port test)
import tests.test_dataset_loaders as loaders
from tests.test_dataset_loaders import kitti_root, nusc_root, waymo_root  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent

# frame, track id, type, then the box fields; several types, tracks whose
# ids do not come in order, frames out of order in the file
_KITTI_ROWS = [
    (2, 7, "Car", 1.52, 1.63, 3.88, 2.4110, 1.0212, 10.503, 0.113),
    (0, 7, "Car", 1.52, 1.63, 3.88, 2.0010, 1.0013, 10.001, 0.101),
    (0, 3, "Pedestrian", 1.71, 0.61, 0.83, -3.30, 1.20, 8.0, -1.2),
    (1, 7, "Car", 1.52, 1.63, 3.88, 2.2032, 1.0111, 10.25, 0.107),
    (0, 5, "Van", 2.10, 1.90, 5.10, 6.5, 1.4, 14.2, 1.5),
    (1, 3, "Pedestrian", 1.71, 0.61, 0.83, -3.1, 1.21, 8.1, -1.17),
    (1, 9, "DontCare", -1, -1, -1, -1000, -1000, -1000, -10),
    (1, 5, "Van", 2.10, 1.90, 5.10, 6.6, 1.4, 14.3, 1.52),
    (2, 3, "Pedestrian", 1.71, 0.61, 0.83, -2.9, 1.22, 8.2, -1.14),
    (2, 11, "Cyclist", 1.75, 0.55, 1.80, 4.0, 1.6, 6.0, 0.3),
    (3, 7, "Car", 1.52, 1.63, 3.88, 2.6, 1.03, 10.75, 0.119),
]


def write_kitti(root: Path, scenes=("0019", "0020"), n_frames: int = 4, seed: int = 0) -> str:
    """A KITTI tracking layout under root: calib (a rotation, not the
    identity), label_02 (_KITTI_ROWS, the second scene's shifted by 0.5 m)
    and velodyne frames of 400 points."""
    rng = np.random.default_rng(seed)
    for d in ("label_02", "calib"):
        (root / d).mkdir(parents=True, exist_ok=True)
    c, s = np.cos(0.02), np.sin(0.02)
    tr = np.array([[c, -s, 0, 0.27], [0, 0, -1, -0.08], [s, c, 0, -0.06]])
    for k, scene in enumerate(scenes):
        (root / "velodyne" / scene).mkdir(parents=True, exist_ok=True)
        with open(root / "calib" / f"{scene}.txt", "w") as f:
            f.write("P0: " + " ".join(["0.0"] * 12) + "\n")
            f.write("Tr_velo_cam " + " ".join(repr(float(v)) for v in tr.reshape(-1)) + "\n")
        rows = []
        for fr, tid, typ, h, w, l, x, y, z, ry in _KITTI_ROWS:
            rows.append(f"{fr} {tid} {typ} 0 0 -1.5 0 0 50 50 {h} {w} {l} {x + 0.5 * k} {y} "
                        f"{z} {ry}")
        (root / "label_02" / f"{scene}.txt").write_text("\n".join(rows) + "\n")
        for fr in range(n_frames):
            pts = rng.uniform(-20, 20, (400, 4)).astype(np.float32)
            pts.tofile(root / "velodyne" / scene / f"{fr:06}.bin")
    return str(root)


def assert_frames_equal(jf: dict, pf: dict) -> None:
    np.testing.assert_array_equal(pf["pc"].points, jf["pc"].points)
    jb, pb = jf["3d_bbox"], pf["3d_bbox"]
    np.testing.assert_array_equal(pb.center, jb.center)
    np.testing.assert_array_equal(pb.wlh, jb.wlh)
    np.testing.assert_array_equal(pb.orientation.elements, jb.orientation.elements)
    np.testing.assert_array_equal(pb.velocity, jb.velocity)
    assert pb.name == jb.name


def assert_datasets_equal(jd, pd_) -> None:
    assert pd_.tracklet_len_list == jd.tracklet_len_list
    for t, n in enumerate(jd.tracklet_len_list):
        for jf, pf in zip(jd.get_frames(t, range(n)), pd_.get_frames(t, range(n))):
            assert_frames_equal(jf, pf)


def assert_kitti_annos_equal(jd, pd_) -> None:
    for ja, pa in zip(jd.tracklet_anno_list, pd_.tracklet_anno_list):
        assert len(ja) == len(pa)
        for j_anno, p_anno in zip(ja, pa):
            assert list(p_anno) == list(j_anno.index)
            for k in j_anno.index:
                if k in ("scene", "type"):
                    assert p_anno[k] == j_anno[k]
                elif k in ("frame", "track_id"):
                    assert isinstance(p_anno[k], int) and p_anno[k] == j_anno[k], k
                else:  # float64, the bits of pandas' parse (which may give an int column)
                    assert isinstance(p_anno[k], np.float64), k
                    assert p_anno[k].tobytes() == np.float64(j_anno[k]).tobytes(), k


@pytest.mark.parametrize("category", ["Car", "Pedestrian", "All", "Other"])
@pytest.mark.parametrize("mode", ["velodyne", "camera"])
def test_kitti_matches_jax(tmp_path, category, mode):
    """The type filter (one type, All, the not-DontCare branch), track ids in
    first-appearance order, tracklets sorted by frame; frames and boxes."""
    root = write_kitti(tmp_path)
    kw = dict(split="test", category_name=category, coordinate_mode=mode, preloading=False)
    for offset in (-1, 10):
        jd, pd_ = JKitti(root, preload_offset=offset, **kw), PKitti(root, preload_offset=offset, **kw)
        assert pd_.scene_list == jd.scene_list == ["0019", "0020"]
        assert_kitti_annos_equal(jd, pd_)
        assert_datasets_equal(jd, pd_)
    if category == "Other":  # every type but DontCare
        assert {a[0]["type"] for a in pd_.tracklet_anno_list} == {"Car", "Pedestrian", "Van",
                                                                 "Cyclist"}


def test_kitti_fixtures_of_the_jax_tests(kitti_root, tmp_path):  # noqa: F811
    from tests.test_kitti_e2e import write_kitti_scene

    write_kitti_scene(str(tmp_path), scene="0019", n_frames=6)
    for root, split in ((kitti_root, "train_tiny"), (str(tmp_path), "test_tiny")):
        kw = dict(split=split, category_name="Car", coordinate_mode="velodyne", preloading=False)
        jd, pd_ = JKitti(root, **kw), PKitti(root, **kw)
        assert pd_.get_num_tracklets() == 1
        assert_kitti_annos_equal(jd, pd_)
        assert_datasets_equal(jd, pd_)


def test_parse_float_rounds_as_pandas():
    """data/kitti.py::parse_float against pd.read_csv (the JAX loader's
    parser) on 25000 decimal strings, the 17-digit reprs among them."""
    import io

    import pandas as pd

    from open3dsot_tpu_torch.data.kitti import parse_float

    rng = np.random.default_rng(5)
    strs = []
    for _ in range(20000):
        digs = "".join(str(d) for d in rng.integers(0, 10, rng.integers(1, 22)))
        if rng.random() < 0.3:
            digs = "0" * rng.integers(1, 4) + digs
        ni = rng.integers(0, 4)
        ip, fp = digs[:ni] or "0", digs[ni:]
        s = ("-" if rng.random() < 0.3 else "") + ip + ("." + fp if fp else "")
        strs.append(s + (f"e{rng.integers(-30, 30)}" if rng.random() < 0.1 else ""))
    strs += [repr(float(x)) for x in rng.standard_normal(5000) * 10.0 ** rng.integers(-5, 5, 5000)]
    strs += ["0.12000000000000001", "1e-05", "-0.0", "50", "1000000000000000000000"]
    want = pd.read_csv(io.StringIO("\n".join(s + " Car" for s in strs)), sep=" ", header=None,
                       names=["v", "type"])["v"].to_numpy(np.float64)
    got = np.array([parse_float(s) for s in strs])
    assert got.tobytes() == want.tobytes()
    assert parse_float("0.12000000000000001") != float("0.12000000000000001")


def test_kitti_missing_frame_fallback(tmp_path):
    root = write_kitti(tmp_path)
    os.remove(os.path.join(root, "velodyne", "0019", "000001.bin"))
    kw = dict(split="test", category_name="Car", coordinate_mode="velodyne", preloading=False)
    jd, pd_ = JKitti(root, **kw), PKitti(root, **kw)
    frame = pd_.get_frames(0, [1])[0]
    assert frame["pc"].points.shape == (3, 1) and np.all(frame["pc"].points == 0)
    assert_datasets_equal(jd, pd_)


def test_kitti_preload_round_trip_never_reads_the_jax_file(tmp_path, monkeypatch):
    """The port writes and reads its own preload file; the JAX package's
    (its classes pickled) under the JAX name is never opened."""
    root = write_kitti(tmp_path)
    kw = dict(split="test", category_name="Car", coordinate_mode="velodyne", preloading=True,
              preload_offset=10)
    jd = JKitti(root, **kw)
    jax_file = tmp_path / "preload_kitti_Car_test_velodyne_10.dat"
    assert jax_file.is_file()
    jax_file.write_bytes(b"not a pickle: reading it fails")
    pd1 = PKitti(root, **kw)
    port_file = tmp_path / "port_preload_kitti_Car_test_velodyne_10.dat"
    assert port_file.is_file()
    assert_datasets_equal(jd, pd1)

    def no_decode(self, anno):
        raise AssertionError("a warm preload decodes no frame")

    monkeypatch.setattr(PKitti, "_get_frame_from_anno", no_decode)
    pd2 = PKitti(root, **kw)
    assert_datasets_equal(jd, pd2)


def test_kitti_loader_runs_without_pandas(tmp_path):
    root = write_kitti(tmp_path)
    script = (
        "import sys\n"
        "sys.modules['pandas'] = None\n"  # any import of pandas raises
        "from open3dsot_tpu_torch.data.kitti import KittiDataset\n"
        f"ds = KittiDataset({root!r}, split='test', category_name='All', preloading=False)\n"
        "print(ds.tracklet_len_list, ds.get_frames(0, [0])[0]['3d_bbox'].center.tolist())\n"
        "assert 'pandas' not in [m.split('.')[0] for m in sys.modules if sys.modules[m]]\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    jd = JKitti(root, split="test", category_name="All", preloading=False)
    want = f"{jd.tracklet_len_list} {jd.get_frames(0, [0])[0]['3d_bbox'].center.tolist()}"
    assert proc.stdout.strip() == want


def test_waymo_matches_jax(waymo_root, tmp_path):  # noqa: F811
    """sot_infos built by the port, then the frames (points moved to the
    global frame, boxes with the length/width swap, heading and velocity)."""
    for tiny in (False, True):
        for offset in (-1, 10):
            kw = dict(split="train", category_name="Vehicle", preloading=False,
                      preload_offset=offset, tiny=tiny)
            pd_ = PWaymo(waymo_root, **kw)
            jd = JWaymo(waymo_root, **kw)
            assert_datasets_equal(jd, pd_)
    # the preload files keep apart
    kw = dict(split="train", category_name="Vehicle", preloading=True, preload_offset=10)
    jd = JWaymo(waymo_root, **kw)
    Path(waymo_root, "preload_train_vehicle_10.dat").write_bytes(b"not a pickle")
    pd_ = PWaymo(waymo_root, **kw)
    assert Path(waymo_root, "port_preload_train_vehicle_10.dat").is_file()
    assert_datasets_equal(jd, pd_)
    assert_datasets_equal(jd, PWaymo(waymo_root, **kw))


def test_nuscenes_matches_jax(nusc_root):  # noqa: F811
    for min_points, key_frame_only in ((1, False), (1, True), (100, False)):
        for offset in (-1, 10):
            kw = dict(split="mini_train", category_name="Car", version="v1.0-mini",
                      preloading=False, min_points=min_points, preload_offset=offset,
                      key_frame_only=key_frame_only)
            jd, pd_ = JNusc(nusc_root, **kw), PNusc(nusc_root, **kw)
            assert pd_.get_num_tracklets() == jd.get_num_tracklets()
            assert [[a["box_anno"]["token"] for a in t] for t in pd_.tracklet_anno_list] == \
                [[a["box_anno"]["token"] for a in t] for t in jd.tracklet_anno_list]
            assert_datasets_equal(jd, pd_)
    kw = dict(split="mini_train", category_name="Car", version="v1.0-mini", preloading=True,
              min_points=1, preload_offset=10)
    jd = JNusc(nusc_root, **kw)
    Path(nusc_root, "preload_nuscenes_Car_mini_train_v1.0-mini_10_1.dat").write_bytes(b"x")
    pd_ = PNusc(nusc_root, **kw)
    assert Path(nusc_root, "port_preload_nuscenes_Car_mini_train_v1.0-mini_10_1.dat").is_file()
    assert_datasets_equal(jd, pd_)


class TestPortNuScenesSplits(loaders.TestNuScenesSplits):
    """tests/test_dataset_loaders.py's split cases, run on the port's copy."""

    @pytest.fixture(autouse=True)
    def _port_module(self, monkeypatch):
        import open3dsot_tpu.data as j_data
        import open3dsot_tpu.data.nuscenes_data as j_nd
        import open3dsot_tpu_torch.data.nuscenes_data as p_nd

        # the inherited tests import the JAX package's modules by name
        monkeypatch.setitem(sys.modules, "open3dsot_tpu.data.nuscenes_splits", p_ns)
        monkeypatch.setattr(j_data, "nuscenes_splits", p_ns, raising=False)
        monkeypatch.setitem(sys.modules, "open3dsot_tpu.data.nuscenes_data", p_nd)
        monkeypatch.setattr(j_data, "nuscenes_data", p_nd, raising=False)
        assert j_nd is not p_nd

    def test_the_port_module_is_the_one_tested(self):
        from open3dsot_tpu.data import nuscenes_splits

        assert nuscenes_splits is p_ns
        assert p_ns.MINI_TRAIN and p_ns._EXPECTED_SIZES["train"] == 700


def _cfgs(dataset: str, root: str, **kw) -> tuple:
    d = dict(dataset=dataset, path=root, net_model="m2track", point_sample_size=64,
             degrees=False, preloading=False, **kw)
    return j_make_config(d), p_make_config(d)


@pytest.mark.parametrize("dataset", ["kitti", "nuscenes", "waymo"])
def test_get_dataset_matches_jax(dataset, tmp_path, nusc_root, waymo_root):  # noqa: F811
    """get_dataset's factory arguments (preload_offset -1 for test,
    key_frame_only, min_points on the eval splits): the test sampler's
    tracklets frame by frame, and the motion training sampler's dataset."""
    if dataset == "kitti":
        root, kw = write_kitti(tmp_path), dict(category_name="Car", preload_offset=10,
                                               test_split="test", train_split="test")
    elif dataset == "nuscenes":
        root, kw = nusc_root, dict(category_name="Car", version="v1.0-mini", preload_offset=10,
                                   test_split="mini_train", train_split="mini_train",
                                   key_frame_only=True)
    else:
        root, kw = waymo_root, dict(category_name="Vehicle", preload_offset=10,
                                    test_split="train", train_split="train")
    jc, pc = _cfgs(dataset, root, **kw)
    js, ps = j_get_dataset(jc, "test", jc.test_split), p_get_dataset(pc, "test", pc.test_split)
    assert len(ps) == len(js) > 0
    for i in range(len(js)):
        for jf, pf in zip(js[i], ps[i]):
            assert_frames_equal(jf, pf)
    jt = j_get_dataset(jc, "train_motion", jc.train_split).dataset
    pt = p_get_dataset(pc, "train_motion", pc.train_split).dataset
    assert pt.preload_offset == jt.preload_offset
    assert_datasets_equal(jt, pt)


def test_get_dataset_refuses_unknown_names():
    with pytest.raises(ValueError, match="unknown dataset"):
        p_get_dataset(p_make_config(dict(dataset="argoverse")), "test", "test")
    with pytest.raises(ValueError, match="unknown dataset type"):
        p_get_dataset(p_make_config(dict(dataset="synthetic")), "train_flow", "test")


def test_waymo_sot_infos_shared(waymo_root):  # noqa: F811
    """The port's sot_infos index (numpy and strings only) is the JAX
    package's, key for key, so either may build it for both."""
    from open3dsot_tpu.data.waymo_data import generate_waymo_data as j_gen
    from open3dsot_tpu_torch.data.waymo_data import generate_waymo_data as p_gen

    path = Path(waymo_root, "sot_infos_vehicle_train.pkl")
    j_gen(waymo_root, "Vehicle", "train")
    want = pickle.loads(path.read_bytes())
    p_gen(waymo_root, "Vehicle", "train")
    got = pickle.loads(path.read_bytes())
    assert list(got) == list(want)
    for k in want:
        for g, w in zip(got[k], want[k]):
            assert g["PC"] == w["PC"] and g["Class"] == w["Class"]
            np.testing.assert_array_equal(g["Box"], w["Box"])
    assert json.dumps(sorted(got)) == json.dumps(sorted(want))
