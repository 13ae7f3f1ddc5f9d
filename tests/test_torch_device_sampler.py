"""The port's training-sample builder (open3dsot_tpu_torch/data/device_sampler.py)
and its draws (utils/prng.py) against the JAX package, on the CPU at small
sizes (P <= 256 raw points, n <= 128 sampled, B = 4, the synthetic dataset
with 2 tracklets of 6 frames).

- The draws: `split`, `bits`, `randint`, `bernoulli` and `uniform` equal
  `jax.random`'s bit for bit; `normal` is within `prng.NORMAL_ULPS` of it.
- `random_select` picks JAX's rows in all four regimes; ties of the sort
  keys keep index order, as `jax.lax.top_k`.
- The raw samplers equal JAX's bit for bit (a synthetic frame has 760
  points, so P = 256 takes the nearest-P cut).
- The builds of one raw batch and key, port against JAX (jitted), with and
  without augmentation, `data_limit_box`, the camera up axis and int16
  transfer: points, boxes and BoxClouds within 1e-5, labels and masks
  equal. Two exceptions, both rounding: a label may differ only for a
  point within 1e-5 of its label box's faces (the synthetic frames put
  the object's points exactly on its box, so the strict factor-1.0 label
  of the siamese builder is decided by the last bit of sin, cos and the
  sums: tens of the 512 labels differ here), and a row's outputs may
  differ only where a raw point lies within 1e-5 of that row's crop
  boundary (then the crop, and so the sample, may differ).
- The deterministic cases of JAX's tests/test_device_sampler.py against
  the port's own host `motion_processing` / `siamese_processing`.
- The slice: the first step of `Trainer.fit` with `device_sampler: true`
  on M2-Track, against JAX's `make_train_step(device_builder=...)` from the
  same weights and raw batch (BAT's is in test_torch_trainer_features.py).
"""

from __future__ import annotations

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3dsot_tpu.config import make_config as jax_make_config
from open3dsot_tpu.data import device_sampler as jds
from open3dsot_tpu.data import get_dataset as jax_get_dataset
from open3dsot_tpu.data.loader import BatchLoader as JaxLoader
from open3dsot_tpu.data.loader import collate as jax_collate
from open3dsot_tpu.geometry import rigid as jrigid
from open3dsot_tpu.models import get_model as jax_get_model
from open3dsot_tpu.train.optim import make_optimizer as jax_make_optimizer
from open3dsot_tpu.train.trainer import TrainState, make_train_step
from open3dsot_tpu_torch.config import make_config
from open3dsot_tpu_torch.data import device_sampler as ds
from open3dsot_tpu_torch.data import get_dataset
from open3dsot_tpu_torch.data.loader import collate
from open3dsot_tpu_torch.data.sampler import motion_processing, siamese_processing
from open3dsot_tpu_torch.geometry import rigid
from open3dsot_tpu_torch.geometry.data_classes import Box, PointCloud
from open3dsot_tpu_torch.geometry.quaternion import Quaternion
from open3dsot_tpu_torch.models import get_model
from open3dsot_tpu_torch.train.trainer import Trainer
from open3dsot_tpu_torch.utils import prng
from open3dsot_tpu_torch.weights import random_variables, state_dict_from_jax
from tests._torch_port import t  # noqa: F401  (one torch thread per worker)

P = 256  # max_raw_points: below the synthetic frames' 760 points
SEEDS = [0, 1, 123456]
MOTION = dict(dataset="synthetic", net_model="m2track", category_name="Car", point_sample_size=64,
              bb_scale=1.25, bb_offset=2.0, degrees=False, up_axis=[0, 0, 1],
              train_type="train_motion", num_candidates=2, motion_threshold=0.15, box_aware=True,
              use_augmentation=True, data_limit_box=True, syn_num_tracklets=2,
              syn_tracklet_len=6, seed=0)
SIAMESE = dict(dataset="synthetic", net_model="bat", category_name="Car", template_size=64,
               search_size=128, model_bb_scale=1.25, model_bb_offset=0.0, search_bb_scale=1.25,
               search_bb_offset=2.0, degrees=True, up_axis=[0, 0, 1], data_limit_box=True,
               train_type="train_siamese", num_candidates=4, box_aware=True,
               use_augmentation=True, syn_num_tracklets=2, syn_tracklet_len=6, seed=0)
# with augmentation and data_limit_box, z-up; without them, camera frame,
# the other angle unit and the int16 raw transfer
VARIANTS = {"aug": {}, "camera_int16": dict(use_augmentation=False, data_limit_box=False,
                                            up_axis=[0, -1, 0], transfer_quant="int16")}


def _words(key) -> list:
    return [int(v) for v in np.asarray(jax.random.key_data(key)).ravel()]


def _ulps(a, b) -> np.ndarray:
    return np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                  - np.asarray(b, np.float32).view(np.int32).astype(np.int64))


# --- the draws ------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_split_bits_bernoulli_uniform_match_jax(seed):
    jk, pk = jax.random.fold_in(jax.random.PRNGKey(seed), 17), prng.fold_in(prng.prng_key(seed), 17)
    assert _words(jk) == list(pk)
    for n in (2, 3, 4, 5, 7):
        assert [_words(k) for k in jax.random.split(jk, n)] == [list(k) for k in prng.split(pk, n)]
    np.testing.assert_array_equal(np.asarray(jax.random.bits(jk, (4, 33))).astype(np.int64),
                                  prng.bits(pk, (4, 33)).numpy())
    for p in (0.5, 0.3):
        np.testing.assert_array_equal(np.asarray(jax.random.bernoulli(jk, p, (300,))),
                                      prng.bernoulli(pk, p, (300,)).numpy())
    for lo, hi in ((0.0, 1.0), (-0.3, 0.3), (-10.0, 10.0)):
        want = jax.random.uniform(jk, (5, 3), minval=lo, maxval=hi)
        assert _ulps(want, prng.uniform(pk, (5, 3), lo, hi)).max() == 0


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_matches_jax(seed):
    """Spans 0 and 1 (minval), 3, 2**16 + 3 (the multiplier wraps in
    uint32) and 2**31 - 1, a per-row (B, 1) maxval, a negative minval."""
    jk, pk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    for maxval in (0, 1, 3, 100, 2 ** 16 + 3, 2 ** 20, 2 ** 31 - 1):
        np.testing.assert_array_equal(np.asarray(jax.random.randint(jk, (3, 64), 0, maxval)),
                                      prng.randint(pk, (3, 64), 0, maxval).numpy(), err_msg=maxval)
    rows = np.array([[0], [1], [3], [70000], [2048]], np.int32)
    np.testing.assert_array_equal(
        np.asarray(jax.random.randint(jk, (5, 33), 0, jnp.asarray(rows))),
        prng.randint(pk, (5, 33), 0, torch.from_numpy(rows)).numpy())
    np.testing.assert_array_equal(np.asarray(jax.random.randint(jk, (40,), -7, 9)),
                                  prng.randint(pk, (40,), -7, 9).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_its_ulp_bound(seed):
    want = jax.random.normal(jax.random.PRNGKey(seed), (1 << 16,))
    got = prng.normal(prng.prng_key(seed), (1 << 16,))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert _ulps(want, got).max() <= prng.NORMAL_ULPS


# --- random_select ----------------------------------------------------------

@pytest.mark.parametrize("m,n", [(48, 16), (16, 16), (7, 16), (2, 16)])
def test_random_select_picks_jax_rows(m, n):
    """Rows encode their index, so equal outputs are equal indices; m valid
    rows of 128, in every row of a batch of 3 at other positions."""
    rng = np.random.default_rng(m)
    pts = np.zeros((3, 128, 3), np.float32)
    pts[..., 0] = np.arange(128)
    pts[..., 1:] = rng.standard_normal((3, 128, 2))
    valid = np.zeros((3, 128), bool)
    for b in range(3):
        valid[b, rng.choice(128, m, replace=False)] = True
    for seed in (1, 2):
        want = np.asarray(jds.random_select(jnp.asarray(pts), jnp.asarray(valid), n,
                                            jax.random.PRNGKey(seed)))
        got = ds.random_select(torch.from_numpy(pts), torch.from_numpy(valid), n,
                               prng.prng_key(seed)).numpy()
        np.testing.assert_array_equal(got, want)
    if m <= 2:
        assert not got.any()


def test_sort_keeps_equal_keys_in_index_order():
    keys = np.array([[0.5, 0.25, 0.5, 0.25, 0.75, 0.25, 0.5, 2.0]] * 2, np.float32)
    keys[1, ::2] = 0.5
    want = np.asarray(jax.lax.top_k(-jnp.asarray(keys), 6)[1])
    got = ds.first_smallest(torch.from_numpy(keys), 6).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], [1, 3, 5, 0, 2, 6])


# --- the raw samplers -------------------------------------------------------

@pytest.mark.parametrize("kind,over", [("motion", {}), ("siamese", {}),
                                       ("siamese", dict(random_sample=True, sample_per_epoch=3)),
                                       ("siamese", dict(up_axis=[0, -1, 0]))])
def test_raw_samplers_match_jax(kind, over):
    base = dict(MOTION if kind == "motion" else SIAMESE, **over)
    pc, jc = make_config(base), jax_make_config(base)
    port_cls, jax_cls = ((ds.RawMotionSampler, jds.RawMotionSampler) if kind == "motion" else
                         (ds.RawSiameseSampler, jds.RawSiameseSampler))
    port = port_cls(get_dataset(pc, pc.train_type, "train").dataset, pc, max_raw_points=P)
    want = jax_cls(jax_get_dataset(jc, jc.train_type, "train").dataset, jc, max_raw_points=P)
    assert len(port) == len(want)
    idx = list(range(0, len(port), 3))
    np.random.seed(5)
    got = collate([port[i] for i in idx])
    np.random.seed(5)
    ref = jax_collate([want[i] for i in idx])
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    valid = got["prev_valid" if kind == "motion" else "search_valid"]
    assert valid.shape[1] == P and valid.all()  # every frame was cut to its P nearest points


# --- the builds ---------------------------------------------------------------

def _raw_pair(base):
    """(port config, JAX config, a collated raw batch of 4, its int16 pack
    under transfer_quant)."""
    pc, jc = make_config(base), jax_make_config(base)
    raw_cls = ds.RawMotionSampler if pc.train_type == "train_motion" else ds.RawSiameseSampler
    sampler = raw_cls(get_dataset(pc, pc.train_type, "train").dataset, pc, max_raw_points=P)
    batch = collate([sampler[i] for i in (0, 1, 5, 7)])
    if getattr(pc, "transfer_quant", None):
        batch = ds.pack_raw_batch(batch)
    return pc, jc, batch


@pytest.fixture(scope="module")
def jax_builds():
    """(kind, variant) -> the jitted JAX build of that raw batch at key 7,
    compiled once for the module."""
    cache = {}

    def get(kind, variant):
        if (kind, variant) not in cache:
            base = dict(MOTION if kind == "motion" else SIAMESE, **VARIANTS[variant])
            pc, jc, batch = _raw_pair(base)
            make = jds.make_motion_builder if kind == "motion" else jds.make_siamese_builder
            build = make(jc, A=jrigid.up_frame(jc.up_axis))
            if getattr(jc, "transfer_quant", None):
                build = jds.dequant_builder(build)
            out = jax.jit(build)({k: jnp.asarray(v) for k, v in batch.items()},
                                 jax.random.PRNGKey(7))
            cache[kind, variant] = (pc, batch, {k: np.asarray(v) for k, v in out.items()})
        return cache[kind, variant]

    return get


def _recording_crops(monkeypatch) -> list:
    """Make the port's builder record, for each crop, the (B,) distance of
    the valid raw point nearest the crop boundary."""
    margins, crop = [], ds._crop

    def recording(pts, valid, box, half, A=None):
        local, ok = crop(pts, valid, box, half, A=A)
        gap = (local.abs() - half[:, None, :]).abs().amin(dim=-1)
        margins.append(torch.where(valid, gap, float("inf")).amin(dim=-1))
        return local, ok

    monkeypatch.setattr(ds, "_crop", recording)
    return margins


def _face_gap(points, box4, wlh, factor: float) -> np.ndarray:
    """Distance of each point (B, N, 3) from the faces of its box (B, 4),
    in the box frame, at the label's factor."""
    local = rigid.remove_transform_points(torch.as_tensor(points), torch.as_tensor(box4)).numpy()
    half = np.stack([wlh[:, 1], wlh[:, 0], wlh[:, 2]], -1)[:, None, :] * factor / 2
    return np.abs(np.abs(local) - half).min(axis=-1)


def _labels_equal_but_on_faces(got, want, points, box4, wlh, factor, name) -> int:
    flips = got != want
    if flips.any():
        gap = _face_gap(points, box4, wlh, factor)[flips]
        assert gap.max() <= 1e-5, f"{name}: a label differs {gap.max()} from its box's faces"
    return int(flips.sum())


def _radians(theta, degrees: bool):
    return np.deg2rad(theta) if degrees else theta


@pytest.mark.parametrize("kind", ["motion", "siamese"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_build_matches_jax(kind, variant, jax_builds, monkeypatch):
    pc, batch, want = jax_builds(kind, variant)
    margins = _recording_crops(monkeypatch)
    build = ds.make_builder(pc, pc.train_type, A=rigid.up_frame(pc.up_axis))
    got = {k: v.numpy() for k, v in build({k: torch.from_numpy(v) for k, v in batch.items()},
                                          prng.prng_key(7)).items()}
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == (np.int64 if want[k].dtype == np.int32 else want[k].dtype), k
    near = torch.stack(margins).amin(dim=0).numpy() <= 1e-5  # rows whose crop may differ
    keep = ~near
    wlh = got["bbox_size"][keep]
    if kind == "motion":
        n = pc.point_sample_size
        pts, d = got["points"][keep], pc.degrees
        box = np.concatenate([got["box_label"][keep][:, :3],
                              _radians(got["box_label"][keep][:, 3:], d)], -1)
        prev = np.concatenate([got["box_label_prev"][keep][:, :3],
                               _radians(got["box_label_prev"][keep][:, 3:], d)], -1)
        seg, seg_want = got["seg_label"][keep], want["seg_label"][keep]
        _labels_equal_but_on_faces(seg[:, :n], seg_want[:, :n], pts[:, :n, :3], prev, wlh, 1.25,
                                   "seg_label prev")
        _labels_equal_but_on_faces(seg[:, n:], seg_want[:, n:], pts[:, n:, :3], box, wlh, 1.25,
                                   "seg_label this")
        _labels_equal_but_on_faces(pts[:, :n, 4], want["points"][keep][:, :n, 4], pts[:, :n, :3],
                                   np.zeros_like(box), wlh, 1.25, "seg_mask_prev")
        np.testing.assert_array_equal(got["motion_state_label"], want["motion_state_label"])
        np.testing.assert_array_equal(pts[:, :, 3], want["points"][keep][:, :, 3])
        np.testing.assert_array_equal(pts[:, n:, 4], want["points"][keep][:, n:, 4])
        close = ["box_label", "box_label_prev", "motion_label", "prev_bc", "this_bc",
                 "candidate_bc"]
        np.testing.assert_allclose(pts[..., :3], want["points"][keep][..., :3], rtol=0, atol=1e-5)
    else:
        # the label box: its center, and its angle in the sample box's frame
        # (box_label[3] is that angle in config units)
        box = np.concatenate([got["box_label"][keep][:, :3],
                              _radians(got["box_label"][keep][:, 3:], pc.degrees)], -1)
        flips = _labels_equal_but_on_faces(got["seg_label"][keep], want["seg_label"][keep],
                                           got["search_points"][keep], box, wlh, 1.0, "seg_label")
        print(f"{kind} {variant}: {flips} labels differ, each on its box's faces")
        close = ["template_points", "search_points", "box_label", "points2cc_dist_t",
                 "points2cc_dist_s"]
    np.testing.assert_array_equal(got["bbox_size"], want["bbox_size"])
    for k in close:
        np.testing.assert_allclose(got[k][keep], want[k][keep], rtol=0, atol=1e-5, err_msg=k)


# --- the deterministic cases against the host samplers -----------------------

def _frame(points_w, box):
    return {"pc": PointCloud(points_w.T.copy()), "3d_bbox": box}


def _mk_box(center, theta, wlh):
    return Box(list(center), list(wlh), Quaternion(axis=[0, 0, 1], radians=theta))


def _raw(frames: dict) -> dict:
    return {k: torch.as_tensor(np.asarray(v))[None] for k, v in frames.items()}


@pytest.mark.parametrize("theta", [(0.7, 0.8), (3.1, -3.1)])
def test_motion_deterministic_case_matches_host(theta):
    """Candidate 0, no augmentation and exactly n points in each subwindow:
    the build equals motion_processing (JAX tests/test_device_sampler.py:59,
    and :370 for headings across the +-pi cut, whose motion label wraps)."""
    cfg = make_config(dict(MOTION, bb_scale=1.0, bb_offset=0.1, use_augmentation=False,
                           data_limit_box=False))
    n = cfg.point_sample_size
    rng = np.random.default_rng(3)
    wlh = np.array([1.8, 4.2, 1.6], np.float32)
    prev_box = _mk_box([10.0, -4.0, 0.5], theta[0], wlh)
    this_box = _mk_box([10.4, -3.8, 0.55], theta[1], wlh)
    half = np.array([wlh[1], wlh[0], wlh[2]]) * cfg.bb_scale / 2 + cfg.bb_offset
    local = (rng.random((n, 3)) * 2 - 1) * (half * 0.95)
    local[: n // 2] *= 0.2
    R = prev_box.rotation_matrix
    world_prev, world_this = local @ R.T + prev_box.center, (local * 0.9) @ R.T + prev_box.center
    host = motion_processing({"prev_frame": _frame(world_prev, prev_box),
                              "this_frame": _frame(world_this, this_box), "candidate_id": 0}, cfg)
    raw = _raw({"prev_pts": world_prev.astype(np.float32), "prev_valid": np.ones(n, bool),
                "this_pts": world_this.astype(np.float32), "this_valid": np.ones(n, bool),
                "prev_box": np.append(prev_box.center, theta[0]).astype(np.float32),
                "this_box": np.append(this_box.center, theta[1]).astype(np.float32),
                "wlh": wlh, "candidate_zero": np.bool_(True)})
    dev = {k: v[0].numpy() for k, v in ds.make_motion_builder(cfg)(raw, prng.prng_key(0)).items()}
    np.testing.assert_allclose(dev["points"], host["points"], atol=2e-5)
    np.testing.assert_array_equal(dev["seg_label"], host["seg_label"])
    for k in ("box_label", "box_label_prev", "motion_label"):
        np.testing.assert_allclose(dev[k], host[k], atol=2e-5, rtol=1e-5, err_msg=k)
    assert int(dev["motion_state_label"]) == int(host["motion_state_label"])
    np.testing.assert_allclose(dev["bbox_size"], host["bbox_size"])
    for k in ("prev_bc", "this_bc", "candidate_bc"):
        np.testing.assert_allclose(dev[k], host[k], atol=2e-4, rtol=1e-4, err_msg=k)
    if theta == (3.1, -3.1):  # the unwrapped difference would be -6.2
        assert abs(float(dev["motion_label"][3]) - 0.0832) < 1e-3


def test_siamese_deterministic_case_matches_host():
    """Candidate 0 with num_candidates > 1 (no template or search offset),
    no augmentation, crop counts equal to the template and search sizes:
    the build equals siamese_processing (JAX tests/test_device_sampler.py:210)."""
    t_size, s_size = 48, 64
    cfg = make_config(dict(SIAMESE, template_size=t_size, search_size=s_size,
                           use_augmentation=False, data_limit_box=False))
    rng = np.random.default_rng(11)
    wlh = np.array([1.7, 4.0, 1.5], np.float32)
    boxes = {"first": ([2.0, 1.0, 0.2], 0.4), "template": ([2.5, 1.5, 0.25], 0.5),
             "search": ([3.0, 2.0, 0.3], 0.6)}
    boxes = {k: (_mk_box(c, th, wlh), th) for k, (c, th) in boxes.items()}

    def pts_inside(box, count, scale, offset):
        half = (np.array([wlh[1], wlh[0], wlh[2]]) * scale / 2 + offset) * 0.9
        local = (rng.random((count, 3)) * 2 - 1) * half
        local[: count // 2] *= 0.15
        return local @ box.rotation_matrix.T + box.center

    world = {"first": pts_inside(boxes["first"][0], 20, 1.25, 0.0),
             "template": pts_inside(boxes["template"][0], t_size - 20, 1.25, 0.0),
             "search": pts_inside(boxes["search"][0], s_size, 1.25, 2.0)}
    host = siamese_processing({f"{k}_frame": _frame(world[k], boxes[k][0]) for k in world}
                              | {"candidate_id": 0}, cfg)
    raw = {"wlh": wlh, "candidate_zero": np.bool_(True)}
    for k in world:
        pts = np.zeros((80, 3), np.float32)
        pts[: len(world[k])] = world[k]
        raw[f"{k}_pts"], raw[f"{k}_valid"] = pts, np.arange(80) < len(world[k])
        raw[f"{k}_box"] = np.append(boxes[k][0].center, boxes[k][1]).astype(np.float32)
    built = ds.make_siamese_builder(cfg)(_raw(raw), prng.prng_key(0))
    dev = {k: v[0].numpy() for k, v in built.items()}
    for k in ("template_points", "search_points", "box_label"):
        np.testing.assert_allclose(dev[k], host[k], atol=2e-5, err_msg=k)
    np.testing.assert_array_equal(dev["seg_label"], host["seg_label"])
    np.testing.assert_allclose(dev["bbox_size"], host["bbox_size"])
    for k in ("points2cc_dist_t", "points2cc_dist_s"):
        np.testing.assert_allclose(dev[k], host[k], atol=2e-4, rtol=1e-4, err_msg=k)


def test_builders_make_no_host_value(jax_builds):
    """The build runs on a meta device: any host read of a device value
    (a Python branch on it, .item()) would raise there."""
    for kind in ("motion", "siamese"):
        pc, batch, _ = jax_builds(kind, "camera_int16")
        raw = {k: torch.from_numpy(v).to("meta") for k, v in batch.items()}
        build = ds.make_builder(pc, pc.train_type, A=rigid.up_frame(pc.up_axis, device="meta"))
        assert all(v.device.type == "meta" for v in build(raw, prng.prng_key(3)).values())


# --- the slice: the first step of fit -----------------------------------------

class _LargerBoxes:
    """A dataset whose boxes are 0.1% larger than the synthetic ones: the
    synthetic frames put the object's points exactly on its box, where the
    strict in-box seg label is decided by the last bit of the arithmetic
    (test_build_matches_jax holds those flips to the box's faces); here no
    label sits on a face, so both sides train on the same labels."""

    def __init__(self, dataset):
        self._dataset = dataset

    def __getattr__(self, name):
        return getattr(self._dataset, name)

    def get_frames(self, seq_id, frame_ids):
        out = []
        for frame in self._dataset.get_frames(seq_id, frame_ids):
            box = copy.deepcopy(frame["3d_bbox"])
            box.wlh = box.wlh * 1.001
            out.append(dict(frame, **{"3d_bbox": box}))
        return out


def first_step_losses(base: dict, tmp_path, larger_boxes: bool = True, seed: int = 5) -> tuple:
    """(loss_total of the first step of the port's Trainer.fit with
    device_sampler: true, that of JAX's make_train_step(device_builder=...,
    sampler_seed=config seed + 1)), both from random_variables(seed) on the
    first raw batch of epoch 0 of the same data (`_LargerBoxes` with
    larger_boxes)."""
    base = dict(base, device_sampler=True, max_raw_points=P, tensorboard=False)
    pc, jc = make_config(base), jax_make_config(dict(base, fused_sa=False, fused_sa_train=False))
    port = get_model(pc.net_model)(pc, device="cpu")
    variables = random_variables(port.net, seed)
    port.net.load_state_dict(state_dict_from_jax(variables), strict=True)
    wrap = _LargerBoxes if larger_boxes else (lambda d: d)
    data = types.SimpleNamespace(dataset=wrap(get_dataset(pc, pc.train_type, "train").dataset))
    history = Trainer(port, pc, work_dir=str(tmp_path)).fit(data, None, epochs=1, steps_per_epoch=1)

    motion = pc.train_type == "train_motion"
    raw_cls, make = ((jds.RawMotionSampler, jds.make_motion_builder) if motion
                     else (jds.RawSiameseSampler, jds.make_siamese_builder))
    raw = raw_cls(wrap(jax_get_dataset(jc, jc.train_type, "train").dataset), jc, max_raw_points=P)
    batch = next(iter(JaxLoader(raw, jc.batch_size, shuffle=True, seed=jc.seed, prefetch=0)))
    optimizer = jax_make_optimizer(jc, 1)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                       opt_state=jax.jit(optimizer.init)(params))
    step = make_train_step(jax_get_model(jc.net_model)(jc), optimizer, donate=False,
                           device_builder=make(jc, A=jrigid.up_frame(jc.up_axis)),
                           sampler_seed=jc.seed + 1)
    _, losses = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return history[0]["loss"], float(losses["loss_total"])


def test_first_fit_step_matches_jax_m2(tmp_path):
    """M2-Track at 64 points, box_aware and the motion classifier on,
    augmentation and data_limit_box on, 2 candidates: loss_total within
    1e-4 relative (its labels take the 1.25 box, off the object's points)."""
    base = dict(MOTION, use_second_stage=False, use_prev_refinement=False, use_motion_cls=True,
                center_weight=2.0, angle_weight=10.0, seg_weight=0.1, bc_weight=1.0,
                motion_cls_seg_weight=0.1, use_z=True, limit_box=False, IoU_space=3,
                batch_size=4, lr=1e-3, optimizer="Adam", lr_decay_step=20, lr_decay_rate=0.1,
                seed=3)
    got, want = first_step_losses(base, tmp_path, larger_boxes=False)
    assert np.isfinite(got) and abs(got - want) <= 1e-4 * abs(want), (got, want)
