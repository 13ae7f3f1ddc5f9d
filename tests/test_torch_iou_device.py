"""The port's device geometry (geometry/iou_device.py, geometry/rigid.py)
and transfer codec (utils/quant.py) against the JAX originals, on inputs
made with numpy from a seed.

Tolerances: overlap_accuracy atol 1e-5 (both sides clip in float32 in the
same order of operations); the rigid functions atol 1e-5 (a 3-term
rotation sum may round in another order); the codec exactly.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3dsot_tpu.geometry import iou_device as j_iou
from open3dsot_tpu.geometry import rigid as j_rigid
from open3dsot_tpu.utils import quant as j_quant
from open3dsot_tpu_torch.geometry import iou_device as p_iou
from open3dsot_tpu_torch.geometry import rigid as p_rigid
from open3dsot_tpu_torch.utils import quant as p_quant

def _pairs(kind: str, rng, n: int = 24):
    """(params_a, wlh_a, params_b, wlh_b) (n, 4) / (n, 3) float32 of a kind."""
    pa = np.concatenate([rng.uniform(-3, 3, (n, 3)), rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    wa = rng.uniform(0.5, 4.0, (n, 3))
    if kind == "random":
        pb = pa + np.concatenate([rng.normal(0, 0.8, (n, 3)), rng.normal(0, 0.5, (n, 1))], 1)
        wb = wa * rng.uniform(0.7, 1.3, (n, 3))
    elif kind == "identical":
        pb, wb = pa.copy(), wa.copy()
    elif kind == "disjoint":
        pb, wb = pa + np.array([20.0, 20.0, 20.0, 0.3]), wa.copy()
    elif kind == "touching":
        # axis-aligned boxes side by side along their length: footprints share an edge
        pa[:, 3] = 0.0
        pb, wb = pa.copy(), wa.copy()
        pb[:, 0] += wa[:, 1]
    else:  # nonfinite: every other pair has a NaN or an inf in one box
        pb, wb = pa + rng.normal(0, 0.3, (n, 4)), wa.copy()
        pa[::4, 0] = np.nan
        pb[1::4, 3] = np.inf
    f = np.float32
    return pa.astype(f), wa.astype(f), pb.astype(f), wb.astype(f)


KINDS = ["random", "identical", "disjoint", "touching", "nonfinite"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("up_idx", [1, 2])
@pytest.mark.parametrize("dim", [2, 3])
def test_overlap_accuracy_matches_jax(kind, up_idx, dim):
    rng = np.random.default_rng(KINDS.index(kind) * 4 + up_idx * 2 + dim)
    pa, wa, pb, wb = _pairs(kind, rng)
    # a (B, T) batch layout, as the scorer passes it
    args = [a.reshape(4, 6, -1) for a in (pa, wa, pb, wb)]
    want = j_iou.overlap_accuracy(*(jnp.asarray(a) for a in args), dim=dim, up_idx=up_idx)
    got = p_iou.overlap_accuracy(*(torch.from_numpy(a) for a in args), dim=dim, up_idx=up_idx)
    for g, w, what in zip(got, want, ("iou", "dist")):
        assert g.dtype == torch.float32 and g.shape == (4, 6)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, err_msg=what)
    if kind == "identical":
        assert np.all(got[0].numpy() > 1 - 1e-5)
    if kind in ("disjoint", "touching"):
        assert np.all(got[0].numpy() <= 1e-5)
    if kind == "nonfinite":
        assert np.all(got[0].numpy()[~np.isfinite(args[0] + args[2]).all(-1)] == 0)


def test_up_index_and_errors():
    assert p_iou.up_index((0, 0, 1)) == j_iou.up_index((0, 0, 1)) == 2
    assert p_iou.up_index((0, -1, 0)) == j_iou.up_index((0, -1, 0)) == 1
    with pytest.raises(ValueError):
        p_iou.up_index((1, 1, 0))
    z = torch.zeros(2, 4)
    with pytest.raises(ValueError):
        p_iou.overlap_accuracy(z, torch.ones(2, 3), z, torch.ones(2, 3), dim=1, up_idx=2)


def _rigid_inputs(seed: int):
    rng = np.random.default_rng(seed)
    B, N = 3, 40
    f = np.float32
    return dict(
        points=rng.uniform(-4, 4, (B, N, 3)).astype(f),
        box=np.concatenate([rng.uniform(-2, 2, (B, 3)), rng.uniform(-3, 3, (B, 1))], 1).astype(f),
        offset=np.concatenate([rng.normal(0, 1.5, (B, 3)), rng.normal(0, 0.3, (B, 1))], 1).astype(f),
        wlh=rng.uniform(0.8, 3.0, (B, 3)).astype(f),
        angles=rng.uniform(-9, 9, (B, 5)).astype(f),
    )


RIGID_CASES = {
    "remove_transform_points": lambda m, a, x: m.remove_transform_points(x["points"], x["box"], A=a),
    "apply_transform_points": lambda m, a, x: m.apply_transform_points(x["points"], x["box"], A=a),
    "get_offset_points": lambda m, a, x: m.get_offset_points(x["points"], x["box"], x["offset"], A=a),
    "get_offset_box": lambda m, a, x: m.get_offset_box(x["box"], x["offset"], A=a),
    "box_corners": lambda m, a, x: m.box_corners(x["box"], x["wlh"], 1.25, A=a),
    "box_cloud": lambda m, a, x: m.box_cloud(x["points"], x["box"], x["wlh"], A=a),
    "points_in_box": lambda m, a, x: m.points_in_box(x["points"], x["box"], 2 * x["wlh"], 1.25, A=a),
    "points_in_box_strict": lambda m, a, x: m.points_in_box(x["points"], x["box"], 2 * x["wlh"],
                                                            A=a, strict=True),
    "transform_box_params": lambda m, a, x: m.transform_box_params(x["offset"], x["box"], A=a),
    "rotz": lambda m, a, x: m.rotz(x["angles"]),
    "roty": lambda m, a, x: m.roty(x["angles"]),
    "wrap_angle": lambda m, a, x: m.wrap_angle(x["angles"]),
}


@pytest.mark.parametrize("basis", ["z-up", "camera"])
@pytest.mark.parametrize("name", sorted(RIGID_CASES))
def test_rigid_matches_jax(name, basis):
    up = (0, 0, 1) if basis == "z-up" else (0, -1, 0)
    x = _rigid_inputs(len(name))
    want = RIGID_CASES[name](j_rigid, j_rigid.up_frame(up), {k: jnp.asarray(v) for k, v in x.items()})
    got = RIGID_CASES[name](p_rigid, p_rigid.up_frame(up), {k: torch.from_numpy(v) for k, v in x.items()})
    want = np.array(want)
    assert tuple(got.shape) == want.shape and got.dtype == torch.from_numpy(want).dtype
    if want.dtype == bool:
        np.testing.assert_array_equal(got.numpy(), want)
        assert 0 < want.sum() < want.size  # both sides of the test occur
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("use_z", [False, True])
@pytest.mark.parametrize("redraw", [False, True])
def test_limit_box_offset_matches_jax(use_z, redraw):
    rng = np.random.default_rng(4)
    offset = rng.normal(0, 2.5, (64, 4)).astype(np.float32)  # many overshoot the box
    wlh = rng.uniform(0.8, 3.0, (64, 3)).astype(np.float32)
    rd = rng.uniform(-1, 1, (64, 2)).astype(np.float32) if redraw else None
    want = j_rigid.limit_box_offset(jnp.asarray(offset), jnp.asarray(wlh), use_z,
                                    redraw=None if rd is None else jnp.asarray(rd))
    got = p_rigid.limit_box_offset(torch.from_numpy(offset), torch.from_numpy(wlh), use_z,
                                   redraw=None if rd is None else torch.from_numpy(rd))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), offset)


def test_up_frame_matches_jax():
    assert p_rigid.up_frame([0, 0, 1]) is None and j_rigid.up_frame([0, 0, 1]) is None
    np.testing.assert_array_equal(p_rigid.up_frame([0, -1, 0]).numpy(),
                                  np.asarray(j_rigid.up_frame([0, -1, 0])))
    with pytest.raises(ValueError):
        p_rigid.up_frame([1, 0, 0])


@pytest.mark.parametrize("shape", [(3, 50), (2, 4, 30)])
def test_quant_roundtrip_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    pts = (rng.normal(0, 20, shape + (3,)) + rng.uniform(-60, 60, (shape[0],) + (1,) * len(shape))
           ).astype(np.float32)
    valid = rng.random(shape) > 0.3
    valid[0] = False  # an all-invalid sample: off 0, scale 1e-6
    q, scale, off = p_quant.quantize_per_sample(pts, valid)
    jq, jscale, joff = j_quant.quantize_per_sample(pts, valid)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(scale, jscale)
    np.testing.assert_array_equal(off, joff)
    got = p_quant.dequantize(torch.from_numpy(q), torch.from_numpy(scale), torch.from_numpy(off))
    want = j_quant.dequantize(jnp.asarray(jq), jnp.asarray(jscale), jnp.asarray(joff))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # within half a step of the input on the valid rows
    step = scale.reshape((-1,) + (1,) * len(shape))
    assert np.all((np.abs(got.numpy() - pts) <= 0.5001 * step + 1e-6)[valid])
