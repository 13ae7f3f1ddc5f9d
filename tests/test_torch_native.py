"""The port's native host library (open3dsot_tpu_torch/native) against the
JAX package's (open3dsot_tpu/native), both built here from their own
copies of geomlib.cpp with the same compiler and flags: every entry bit for
bit. Against the port's numpy paths at tests/test_native.py's tolerances
(the crop and BoxCloud within 1e-4, the inclusive in-box mask on more than
99.9% of points: f32 rounding at the boundary), the AABB mask and the int16
encoder exactly. The dispatch sites under OPEN3DSOT_TPU_NATIVE, a build
that writes nothing under open3dsot_tpu/, and a failed build that raises.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from open3dsot_tpu import native as j_native
from open3dsot_tpu.geometry import Box as JBox
from open3dsot_tpu.geometry import PointCloud as JPC
from open3dsot_tpu.geometry import Quaternion as JQ
from open3dsot_tpu.geometry import points_utils as j_pu
from open3dsot_tpu_torch import native
from open3dsot_tpu_torch.geometry import Box, PointCloud, Quaternion
from open3dsot_tpu_torch.geometry import points_utils as pu
from open3dsot_tpu_torch.utils import quant
from tests._torch_port import jax_native_library

ROOT = Path(__file__).resolve().parent.parent
DEFAULT_BUILD = native.BUILD_DIR


@pytest.fixture(scope="module")
def libs():
    """Both libraries built and loaded (the JAX one next to its source)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("OPEN3DSOT_TPU_NATIVE", raising=False)
        j_lib = jax_native_library()
        assert native.available()
    return j_lib, native.library()


def _box(rng):
    return Box(rng.uniform(-3, 3, 3), rng.uniform(1, 3, 3),
               Quaternion(axis=[0, 0, 1], radians=rng.uniform(-np.pi, np.pi)))


def _crop_args(box, scale=1.25, offset=2.0):
    box_tmp = pu.transform_box(box, box)
    box_tmp.wlh = box_tmp.wlh * scale
    return box.rotation_matrix.T, box.center, np.max(box_tmp.corners(), 1) + offset


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_entries_equal_the_jax_library_bit_for_bit(libs, seed):
    j_lib, _ = libs
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-10, 10, (5000, 3)).astype(np.float32)
    box = _box(rng)
    rot, center, half = _crop_args(box)
    got = native.crop_canonical(pts, rot, center, half)
    want = j_native.crop_canonical(pts, rot, center, half)
    assert got.dtype == np.float32 and 0 < len(got) < len(pts)
    np.testing.assert_array_equal(got, want)
    in_half = np.array([box.wlh[1], box.wlh[0], box.wlh[2]]) * 1.25 / 2
    np.testing.assert_array_equal(native.points_in_box_native(pts, rot, center, in_half),
                                  j_native.points_in_box_native(pts, rot, center, in_half))
    kp = np.concatenate([box.center[None], box.corners().T], 0)
    np.testing.assert_array_equal(native.box_cloud_native(pts[:300], kp),
                                  j_native.box_cloud_native(pts[:300], kp))
    mini, maxi = rng.uniform(-6, -1, 3), rng.uniform(1, 6, 3)
    mask = np.empty(len(pts), np.uint8)
    j_lib.aabb_mask(pts.ctypes.data_as(j_lib.aabb_mask.argtypes[0]), len(pts),
                    np.ascontiguousarray(mini).ctypes.data_as(j_lib.aabb_mask.argtypes[2]),
                    np.ascontiguousarray(maxi).ctypes.data_as(j_lib.aabb_mask.argtypes[3]),
                    mask.ctypes.data_as(j_lib.aabb_mask.argtypes[4]))
    np.testing.assert_array_equal(native.aabb_mask(pts, mini, maxi), mask.astype(bool))
    # an M2 scan batch's shape: (B, T, P, 3) with prefix masks, one sample empty
    batch = rng.normal(0, 20, (4, 3, 256, 3)).astype(np.float32)
    valid = np.arange(256)[None, None] < rng.integers(0, 257, (4, 3))[..., None]
    valid[1] = False
    for a, b in zip(native.quantize_per_sample_native(batch, valid),
                    j_native.quantize_per_sample_native(batch, valid)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_entries_against_the_numpy_paths(libs, monkeypatch):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-10, 10, (5000, 3)).astype(np.float32)
    box = _box(rng)
    got = native.crop_canonical(pts, *_crop_args(box))
    monkeypatch.setenv("OPEN3DSOT_TPU_NATIVE", "0")
    want = pu.generate_subwindow(PointCloud(pts.T.astype(np.float64)), box, scale=1.25,
                                 offset=2.0).points.T
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)
    pts = rng.uniform(-4, 4, (2000, 3)).astype(np.float32)
    box = Box([0.5, -0.5, 0], [2, 3, 1.5], Quaternion(axis=[0, 0, 1], degrees=30))
    half = np.array([box.wlh[1], box.wlh[0], box.wlh[2]]) * 1.25 / 2
    mask = native.points_in_box_native(pts, box.rotation_matrix.T, box.center, half)
    assert (mask == pu.points_in_box(box, pts.T.astype(np.float64), 1.25)).mean() > 0.999
    kp = np.concatenate([box.center[None], box.corners().T], 0)
    np.testing.assert_allclose(native.box_cloud_native(pts[:100], kp),
                               pu.get_point_to_box_distance(pts[:100].astype(np.float64), box),
                               atol=1e-4)
    np.testing.assert_array_equal(
        native.aabb_mask(pts, box.center - box.wlh, box.center + box.wlh),
        pu._aabb_mask(pts.T.astype(np.float64), Box(box.center, 2 * box.wlh[[1, 0, 2]],
                                                      Quaternion())))
    for shape in ((3, 100, 3), (2, 4, 64, 3)):
        batch = rng.normal(0, 30, shape).astype(np.float32)
        valid = rng.random(shape[:-1]) < 0.7
        valid[0] = False
        for a, b in zip(native.quantize_per_sample_native(batch, valid),
                        quant._quantize_per_sample_numpy(batch, valid)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("switch", [None, "0"])
def test_dispatch_sites_follow_the_switch(libs, monkeypatch, switch):
    """generate_subwindow and quantize_per_sample take the library unless
    OPEN3DSOT_TPU_NATIVE=0; the call counters show which path ran."""
    if switch is None:
        monkeypatch.delenv("OPEN3DSOT_TPU_NATIVE", raising=False)
    else:
        monkeypatch.setenv("OPEN3DSOT_TPU_NATIVE", switch)
    rng = np.random.default_rng(3)
    pc = PointCloud(rng.uniform(-8, 8, (3, 3000)).astype(np.float32))
    box = _box(rng)
    batch = rng.normal(0, 5, (2, 64, 3)).astype(np.float32)
    valid = rng.random((2, 64)) < 0.5
    native.reset_call_counts()
    crop = pu.generate_subwindow(pc, box, scale=1.25, offset=2.0)
    q = quant.quantize_per_sample(batch, valid)
    on = switch is None
    assert native.available() == on
    assert (native.crop_canonical.calls, native.quantize_per_sample_native.calls) == \
        ((1, 1) if on else (0, 0))
    for a, b in zip(q, quant._quantize_per_sample_numpy(batch, valid)):
        np.testing.assert_array_equal(a, b)
    if not on:  # the numpy path, the copy of JAX's with the switch at 0 there too
        want = j_pu.generate_subwindow(JPC(pc.points), JBox(box.center, box.wlh,
                                                            JQ(box.orientation.elements)),
                                       scale=1.25, offset=2.0)
        np.testing.assert_array_equal(crop.points, want.points)


def test_generate_subwindow_equals_jax_with_the_library_on(libs, monkeypatch):
    monkeypatch.delenv("OPEN3DSOT_TPU_NATIVE", raising=False)
    rng = np.random.default_rng(4)
    for _ in range(3):
        pts = rng.uniform(-15, 15, (3, 20000)).astype(np.float32)
        box = _box(rng)
        jbox = JBox(box.center, box.wlh, JQ(box.orientation.elements))
        for scale, offset in ((1.25, 2.0), (1.0, 0.0)):
            got = pu.generate_subwindow(PointCloud(pts), box, scale=scale, offset=offset)
            want = j_pu.generate_subwindow(JPC(pts), jbox, scale=scale, offset=offset)
            assert got.points.dtype == want.points.dtype == np.float32
            np.testing.assert_array_equal(got.points, want.points)


def _tree(path: Path) -> dict:
    return {str(p): p.stat().st_mtime_ns for p in path.rglob("*") if p.is_file()}


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """The port's library built anew into a temporary build directory."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    native.library.cache_clear()
    yield tmp_path / "_build"
    native.library.cache_clear()


def test_build_goes_to_its_own_directory(libs, fresh_build):
    before = _tree(ROOT / "open3dsot_tpu")
    lib = native.library()
    built = sorted(p.name for p in fresh_build.iterdir())
    assert len(built) == 1 and built[0].startswith("libgeomlib-") and built[0].endswith(".so")
    assert Path(lib._name).parent == fresh_build
    assert _tree(ROOT / "open3dsot_tpu") == before
    # the default build directory is the port's git-ignored _build/
    assert DEFAULT_BUILD == ROOT / "open3dsot_tpu_torch" / "_build"
    assert "open3dsot_tpu_torch/_build/" in (ROOT / ".gitignore").read_text()


def test_failed_build_raises_with_the_compiler_message(fresh_build, tmp_path, monkeypatch):
    """No silent fallback to numpy: a source that does not compile raises,
    at the dispatch site too, unless OPEN3DSOT_TPU_NATIVE=0."""
    bad = tmp_path / "geomlib.cpp"
    bad.write_text('extern "C" int crop_canonical( {\n')
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.delenv("OPEN3DSOT_TPU_NATIVE", raising=False)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build") as err:
        native.available()
    assert "error" in str(err.value)
    pc = PointCloud(np.zeros((3, 10), np.float32))
    box = Box([0, 0, 0], [1, 1, 1], Quaternion())
    with pytest.raises(RuntimeError):
        pu.generate_subwindow(pc, box, scale=1.25)
    assert not list(fresh_build.glob("*.so"))  # no half-written library left
    monkeypatch.setenv("OPEN3DSOT_TPU_NATIVE", "0")
    assert not native.available()
    assert pu.generate_subwindow(pc, box, scale=1.25).points.shape == (3, 10)
