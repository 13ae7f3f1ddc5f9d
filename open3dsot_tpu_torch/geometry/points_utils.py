"""Host-side (numpy) box/point-cloud geometry.

Functional parity with the reference's `datasets/points_utils.py` host path:
cropping, canonicalization, template merging, BoxCloud distances, in-box
masks, augmentation. Used by the dataset samplers and the tracklet eval
driver; the batched on-device equivalents live in `geometry/rigid.py`.

TRANSCRIPTION NOTICE: several functions here (regularize_pc, getOffsetBB,
getModel, cropAndCenterPC, crop_pc_*, apply_transform/apply_augmentation)
are deliberate semantics-pinned transcriptions of the reference's
datasets/points_utils.py host path. They are the declared exact-parity
surface (CLAUDE.md): training labels and eval inputs depend on the precise
numpy RNG call order, strict-vs-inclusive bounds and statement order, so any
"idiomatic" restructuring changes the produced datasets. Each is golden- and
live-reference-tested (tests/test_reference_live_parity.py); everything
device-side is an original design (geometry/rigid.py).

Exact-semantics notes (reference file:line):
- regularize_pc RNG: np.random.default_rng(seed).choice with replace iff
  upsampling, unseeded np.random.choice otherwise (points_utils.py:24-40).
  Eval uses seed=1 (base_model.py:228-231) so metric parity depends on this.
- getOffsetBB limit_box re-draws offsets in-place (points_utils.py:70-76).
- crop_pc_axis_aligned uses strict </> comparisons (points_utils.py:155-166).
- cropAndCenterPC double-crop with (2*offset, 4*scale) then (offset, scale)
  (points_utils.py:107-120).
"""

from __future__ import annotations

import numpy as np

from open3dsot_tpu_torch import native
from open3dsot_tpu_torch.geometry.data_classes import Box, PointCloud
from open3dsot_tpu_torch.geometry.quaternion import Quaternion


def regularize_pc(points: np.ndarray, sample_size: int, seed=None):
    """Random re-sample an (N, C) point array to exactly sample_size rows.

    Returns (points, idx); idx is None when the input had <=2 points, in
    which case zeros are returned (matching the reference fallback).
    """
    num_points = points.shape[0]
    new_pts_idx = None
    rng = np.random if seed is None else np.random.default_rng(seed)
    if num_points > 2:
        if num_points != sample_size:
            new_pts_idx = rng.choice(
                num_points, size=sample_size, replace=sample_size > num_points
            )
        else:
            new_pts_idx = np.arange(num_points)
    if new_pts_idx is not None:
        points = points[new_pts_idx, :]
    else:
        points = np.zeros((sample_size, 3), dtype="float32")
    return points, new_pts_idx


def getOffsetBB(box: Box, offset, degrees=True, use_z=False, limit_box=True, inplace=False) -> Box:
    """Apply a 3/4-DoF offset to a box in its local frame."""
    # limit_box re-draws offsets in place (reference points_utils.py:70-76);
    # work on a copy so read-only arrays (e.g. device outputs) are accepted
    offset = np.array(offset, dtype=np.float64)
    rot_quat = Quaternion(matrix=box.rotation_matrix)
    trans = np.array(box.center)
    new_box = box if inplace else box.copy()

    new_box.translate(-trans)
    new_box.rotate(rot_quat.inverse)
    if len(offset) == 3:
        use_z = False
    angle = offset[2] if len(offset) == 3 else offset[3]
    if degrees:
        new_box.rotate(Quaternion(axis=[0, 0, 1], degrees=angle))
    else:
        new_box.rotate(Quaternion(axis=[0, 0, 1], radians=angle))
    if limit_box:
        if offset[0] > new_box.wlh[0]:
            offset[0] = np.random.uniform(-1, 1)
        if offset[1] > min(new_box.wlh[1], 2):
            offset[1] = np.random.uniform(-1, 1)
        if use_z and offset[2] > new_box.wlh[2]:
            offset[2] = 0
    if use_z:
        new_box.translate(np.array([offset[0], offset[1], offset[2]]))
    else:
        new_box.translate(np.array([offset[0], offset[1], 0]))

    new_box.rotate(rot_quat)
    new_box.translate(trans)
    return new_box


def getModel(PCs, boxes, offset=0, scale=1.0, normalize=False):
    """Crop+center each (pc, box) pair and merge into one template cloud."""
    if len(PCs) == 0:
        return PointCloud(np.ones((3, 0)))
    points = [np.ones((PCs[0].points.shape[0], 0), dtype="float32")]
    new_box = None
    for PC, box in zip(PCs, boxes):
        cropped_PC, new_box = cropAndCenterPC(PC, box, offset=offset, scale=scale, normalize=normalize)
        if cropped_PC.nbr_points() > 0:
            points.append(cropped_PC.points)
    PC = PointCloud(np.concatenate(points, axis=1))
    return PC, new_box


def cropAndCenterPC(PC: PointCloud, box: Box, offset=0, scale=1.0, normalize=False):
    """Crop around the box, canonicalize to the box frame, crop again tight."""
    new_PC = crop_pc_axis_aligned(PC, box, offset=2 * offset, scale=4 * scale)

    new_box = box.copy()
    rot_mat = np.transpose(new_box.rotation_matrix)
    trans = -new_box.center

    new_PC.translate(trans)
    new_box.translate(trans)
    new_PC.rotate(rot_mat)
    new_box.rotate(Quaternion(matrix=rot_mat))

    new_PC = crop_pc_axis_aligned(new_PC, new_box, offset=offset, scale=scale)

    if normalize:
        new_PC.normalize(box.wlh)
    return new_PC, new_box


def get_point_to_box_distance(pc, box: Box, wlh_factor: float = 1.0) -> np.ndarray:
    """BoxCloud: (N, 9) distances of each point to box center + 8 corners."""
    if isinstance(pc, PointCloud):
        points = pc.points.T  # N,3
    else:
        points = pc
        assert points.shape[1] == 3
    box_corners = box.corners(wlh_factor=wlh_factor)  # 3,8
    box_centers = box.center.reshape(-1, 1)  # 3,1
    box_points = np.concatenate([box_centers, box_corners], axis=1)  # 3,9
    # pairwise euclidean (N,9) without scipy
    diff = points[:, None, :] - box_points.T[None, :, :]
    return np.sqrt(np.sum(diff * diff, axis=-1))


def _aabb_mask(points: np.ndarray, box: Box, offset=0, scale=1.0) -> np.ndarray:
    box_tmp = box.copy()
    box_tmp.wlh = box_tmp.wlh * scale
    maxi = np.max(box_tmp.corners(), 1) + offset
    mini = np.min(box_tmp.corners(), 1) - offset
    close = (
        (points[0, :] < maxi[0])
        & (points[0, :] > mini[0])
        & (points[1, :] < maxi[1])
        & (points[1, :] > mini[1])
        & (points[2, :] < maxi[2])
        & (points[2, :] > mini[2])
    )
    return close


def crop_pc_axis_aligned(PC: PointCloud, box: Box, offset=0, scale=1.0, return_mask=False):
    """Axis-aligned crop by the box's AABB (inflated by scale/offset)."""
    close = _aabb_mask(PC.points, box, offset=offset, scale=scale)
    new_PC = PointCloud(PC.points[:, close])
    if return_mask:
        return new_PC, close
    return new_PC


def crop_pc_oriented(PC: PointCloud, box: Box, offset=0, scale=1.0, return_mask=False):
    """Oriented crop: transform into the box frame, AABB-crop, transform back."""
    box_tmp = box.copy()
    new_PC = PC.copy()
    rot_mat = np.transpose(box_tmp.rotation_matrix)
    trans = -box_tmp.center

    new_PC.translate(trans)
    box_tmp.translate(trans)
    new_PC.rotate(rot_mat)
    box_tmp.rotate(Quaternion(matrix=rot_mat))

    close = _aabb_mask(new_PC.points, box_tmp, offset=offset, scale=scale)
    new_PC = PointCloud(new_PC.points[:, close])

    new_PC.rotate(np.transpose(rot_mat))
    new_PC.translate(-trans)
    if return_mask:
        return new_PC, close
    return new_PC


def generate_subwindow(pc: PointCloud, sample_bb: Box, scale, offset=2, oriented=True) -> PointCloud:
    """Crop the search region around sample_bb, canonicalized to its frame.

    Hot path of both samplers and the eval input builders; unless
    OPEN3DSOT_TPU_NATIVE=0 the translate+rotate+crop runs as one fused C++
    pass (open3dsot_tpu_torch/native), else the numpy path below (the same
    strict bounds, other rounding; tests/test_torch_native.py).
    """
    rot_mat = np.transpose(sample_bb.rotation_matrix)
    trans = -sample_bb.center
    if oriented and native.enabled():
        box_tmp = transform_box(sample_bb, sample_bb)
        box_tmp.wlh = box_tmp.wlh * scale
        maxi = np.max(box_tmp.corners(), 1) + offset
        cropped = native.crop_canonical(pc.points.T, rot_mat, sample_bb.center, maxi)
        return PointCloud(cropped.T)
    if oriented:
        new_pc = pc.copy()
        box_tmp = sample_bb.copy()
        new_pc.translate(trans)
        box_tmp.translate(trans)
        new_pc.rotate(rot_mat)
        box_tmp.rotate(Quaternion(matrix=rot_mat))
        new_pc = crop_pc_axis_aligned(new_pc, box_tmp, scale=scale, offset=offset)
    else:
        new_pc = crop_pc_axis_aligned(pc, sample_bb, scale=scale, offset=offset)
        new_pc.translate(trans)
        new_pc.rotate(rot_mat)
    return new_pc


def transform_box(box: Box, ref_box: Box, inplace=False) -> Box:
    if not inplace:
        box = box.copy()
    box.translate(-ref_box.center)
    box.rotate(Quaternion(matrix=ref_box.rotation_matrix.T))
    return box


def transform_pc(pc: PointCloud, ref_box: Box, inplace=False) -> PointCloud:
    if not inplace:
        pc = pc.copy()
    pc.translate(-ref_box.center)
    pc.rotate(ref_box.rotation_matrix.T)
    return pc


def get_in_box_mask(PC: PointCloud, box: Box) -> np.ndarray:
    """Strict-inequality in-box mask (canonicalize then AABB check)."""
    box_tmp = box.copy()
    new_PC = PC.copy()
    rot_mat = np.transpose(box_tmp.rotation_matrix)
    trans = -box_tmp.center
    new_PC.translate(trans)
    box_tmp.translate(trans)
    new_PC.rotate(rot_mat)
    box_tmp.rotate(Quaternion(matrix=rot_mat))
    return _aabb_mask(new_PC.points, box_tmp, offset=0, scale=1.0)


def points_in_box(box: Box, points: np.ndarray, wlh_factor: float = 1.0) -> np.ndarray:
    """Inclusive oriented in-box test for (3, N) points.

    Equivalent to nuscenes geometry_utils.points_in_box (used by the
    reference's motion sampler, sampler.py:98,130-132): transform points
    into the box frame and test |p| <= half-extent on each axis.
    """
    rot = box.rotation_matrix  # box -> world
    local = rot.T @ (points[:3, :] - box.center.reshape(3, 1))
    w, l, h = box.wlh * wlh_factor
    return (
        (np.abs(local[0, :]) <= l / 2)
        & (np.abs(local[1, :]) <= w / 2)
        & (np.abs(local[2, :]) <= h / 2)
    )


def apply_transform(in_box_pc: PointCloud, box: Box, translation, rotation, flip_x, flip_y,
                    rotation_axis=(0, 0, 1)):
    """Flip/rotate/translate a box and its interior points, in the box frame."""
    rot_mat = box.rotation_matrix
    trans = box.center

    new_box = box.copy()
    new_pc = in_box_pc.copy()

    new_pc.translate(-trans)
    new_box.translate(-trans)
    new_pc.rotate(rot_mat.T)
    new_box.rotate(Quaternion(matrix=rot_mat.T))

    if flip_x:
        new_pc.points[0, :] = -new_pc.points[0, :]
        # rotate the box so the x-axis still points to the head
        new_box.rotate(Quaternion(axis=[0, 0, 1], degrees=180))
    if flip_y:
        new_pc.points[1, :] = -new_pc.points[1, :]

    rot_quat = Quaternion(axis=rotation_axis, degrees=rotation)
    new_box.rotate(rot_quat)
    new_pc.rotate(rot_quat.rotation_matrix)

    new_box.translate(translation)
    new_pc.translate(translation)

    new_box.rotate(Quaternion(matrix=rot_mat))
    new_pc.rotate(rot_mat)
    new_box.translate(trans)
    new_pc.translate(trans)
    return new_pc, new_box


def apply_augmentation(pc: PointCloud, box: Box, wlh_factor: float = 1.25):
    """Random flip/rotation/translation of the target points inside the box."""
    in_box_mask = points_in_box(box, pc.points, wlh_factor=wlh_factor)
    in_box_pc = PointCloud(pc.points[:, in_box_mask])

    rand_trans = np.random.uniform(low=-0.3, high=0.3, size=3)
    rand_rot = np.random.uniform(low=-10, high=10)
    flip_x, flip_y = np.random.choice([True, False], size=2, replace=True)

    new_in_box_pc, new_box = apply_transform(in_box_pc, box, rand_trans, rand_rot, flip_x, flip_y)

    new_pc = pc.copy()
    new_pc.points[:, in_box_mask] = new_in_box_pc.points
    return new_pc, new_box


def box_to_params(box: Box, degrees: bool = False) -> np.ndarray:
    """Box -> (cx, cy, cz, theta_z) with theta signed about +z.

    theta = orientation.angle * axis_z, the reference's 4-DoF label encoding
    (sampler.py:148-156).
    """
    theta = (box.orientation.degrees if degrees else box.orientation.radians)
    theta = theta * box.orientation.axis[-1]
    return np.append(box.center, theta).astype("float32")
