"""Synthetic tracklet dataset (tests / benchmarks / smoke training).

The reference has no test fixtures at all (SURVEY §4); this generator fills
that gap: deterministic tracklets of a rigid box translating/yawing through a
scattered background, with points on the object surface so seg labels,
BoxClouds and motion labels are all non-degenerate. No files on disk needed.
"""

from __future__ import annotations

import numpy as np

from open3dsot_tpu_torch.data.base import BaseDataset
from open3dsot_tpu_torch.geometry import Box, PointCloud, Quaternion


def _make_frame(rng, center, theta, wlh, n_obj=160, n_bg=600, world_T=None):
    """Point cloud = object surface points + uniform background clutter.

    `world_T` (3x3) re-bases the whole z-up scene into another coordinate
    convention (e.g. Rx(pi/2) for KITTI camera mode, where box orientations
    become the Qy(ry)*Qx90 family — kitti.py:162-164).
    """
    w, l, h = wlh
    # object points on the box surface (in box frame)
    local = rng.uniform(-0.5, 0.5, size=(3, n_obj)) * np.array([[l], [w], [h]])
    face = rng.integers(0, 3, size=n_obj)
    sign = rng.choice([-0.5, 0.5], size=n_obj)
    local[0, face == 0] = sign[face == 0] * l
    local[1, face == 1] = sign[face == 1] * w
    local[2, face == 2] = sign[face == 2] * h
    q = Quaternion(axis=[0, 0, 1], radians=theta)
    obj = q.rotation_matrix @ local + np.asarray(center).reshape(3, 1)
    bg = rng.uniform(-1, 1, size=(3, n_bg)) * np.array([[18.0], [18.0], [2.0]])
    bg[2] += center[2]
    pts = np.concatenate([obj, bg], axis=1).astype(np.float32)
    rot = q.rotation_matrix
    ctr = np.asarray(center, dtype=np.float64)
    if world_T is not None:
        pts = (world_T @ pts).astype(np.float32)
        ctr = world_T @ ctr
        rot = world_T @ rot
    box = Box(ctr.tolist(), list(wlh), Quaternion(matrix=rot))
    return {"pc": PointCloud(pts), "3d_bbox": box, "meta": None}


class SyntheticDataset(BaseDataset):
    def __init__(self, split="train", num_tracklets=4, tracklet_len=8, seed=42,
                 category_name="Car", up_axis=(0, 0, 1), **kwargs):
        super().__init__(path=None, split=split, category_name=category_name, **kwargs)
        import zlib

        up = np.asarray(up_axis, dtype=np.float64)
        if np.allclose(up / np.linalg.norm(up), [0, -1, 0]):
            # camera mode: re-base the z-up scene by Rx(pi/2)
            world_T = np.array([[1.0, 0, 0], [0, 0, -1.0], [0, 1.0, 0]])
        else:
            world_T = None

        # deterministic across processes (python str hash is salted)
        rng = np.random.default_rng(seed + (zlib.crc32(split.encode()) % 1000))
        self.tracklets = []
        for _ in range(num_tracklets):
            wlh = rng.uniform([1.5, 3.2, 1.4], [2.0, 4.5, 1.8])
            center = rng.uniform([-8, -8, -1.0], [8, 8, 0.5])
            theta = rng.uniform(-np.pi, np.pi)
            vel = rng.uniform(-0.5, 0.5, size=3)
            vel[2] = 0.0
            dtheta = rng.uniform(-0.05, 0.05)
            frames = []
            for t in range(tracklet_len):
                frames.append(
                    _make_frame(rng, center + vel * t, theta + dtheta * t, wlh,
                                world_T=world_T)
                )
            self.tracklets.append(frames)
        self.tracklet_anno_list = [[None] * tracklet_len for _ in range(num_tracklets)]
        self.tracklet_len_list = [tracklet_len] * num_tracklets

    def get_frames(self, seq_id, frame_ids):
        return [self.tracklets[seq_id][f] for f in frame_ids]
