"""Host-side point-cloud / 3D-box containers.

API-compatible with the reference's `datasets/data_classes.py` (itself from
the public nuScenes devkit): `PointCloud` holds a (3, N) float array;
`Box` holds center / wlh / orientation-quaternion. These are *host* data
structures for dataset IO and the tracklet eval driver; everything on device
works on fixed-shape (x, y, z[, extra]) arrays plus (cx, cy, cz, theta) box
params instead (geometry/rigid.py).

TRANSCRIPTION NOTICE: the Box container's method-by-method semantics are a
deliberate semantics-pinned transcription of the reference's
datasets/data_classes.py (itself the nuScenes devkit's public container).
Corner ordering, the wlh->xyz axis mapping, the rotate/translate composition
order, and the transform form ARE the parity surface — every crop, label,
metric and checkpoint in the framework is defined against them, so an
"idiomatic" restructuring would change the produced datasets and break the
north-star Success/Precision parity goal (CLAUDE.md exact-parity surfaces).
Pinned against the LIVE reference code in tests/test_reference_live_parity.py.

Behavioral parity notes (reference file:line):
- Box.corners() ordering and wlh->xyz mapping: data_classes.py:226-250.
- Box.transform uses the reference's (transposed, perspective-divide) form:
  data_classes.py:220-224.
- PointCloud keeps only the first 3 rows: data_classes.py:18-20.
"""

from __future__ import annotations

import numpy as np

from open3dsot_tpu_torch.geometry.quaternion import Quaternion


class PointCloud:
    def __init__(self, points: np.ndarray):
        points = np.asarray(points)
        if points.shape[0] > 3:
            points = points[0:3, :]
        self.points = points

    @staticmethod
    def load_pcd_bin(file_name: str) -> np.ndarray:
        """KITTI/nuScenes .bin: rows of (x, y, z, intensity[, ring])."""
        scan = np.fromfile(file_name, dtype=np.float32)
        points = scan.reshape((-1, 5))[:, :4]
        return points.T

    @classmethod
    def from_file(cls, file_name: str) -> "PointCloud":
        if file_name.endswith(".bin"):
            points = cls.load_pcd_bin(file_name)
        elif file_name.endswith(".npy"):
            points = np.load(file_name)
        else:
            raise ValueError(f"Unsupported filetype {file_name}")
        return cls(points)

    def nbr_points(self) -> int:
        return self.points.shape[1]

    def subsample(self, ratio: float) -> None:
        selected = np.random.choice(
            np.arange(0, self.nbr_points()), size=int(self.nbr_points() * ratio)
        )
        self.points = self.points[:, selected]

    def remove_close(self, radius: float) -> None:
        x_filt = np.abs(self.points[0, :]) < radius
        y_filt = np.abs(self.points[1, :]) < radius
        not_close = np.logical_not(np.logical_and(x_filt, y_filt))
        self.points = self.points[:, not_close]

    def translate(self, x) -> None:
        self.points[:3, :] = self.points[:3, :] + np.asarray(x).reshape(3, 1)

    def rotate(self, rot_matrix: np.ndarray) -> None:
        self.points[:3, :] = np.dot(rot_matrix, self.points[:3, :])

    def transform(self, transf_matrix: np.ndarray) -> None:
        self.points[:3, :] = transf_matrix.dot(
            np.vstack((self.points[:3, :], np.ones(self.nbr_points())))
        )[:3, :]

    def normalize(self, wlh) -> None:
        normalizer = [wlh[1], wlh[0], wlh[2]]
        self.points = self.points / np.atleast_2d(normalizer).T

    def copy(self) -> "PointCloud":
        return PointCloud(self.points.copy())


class Box:
    """3D box: center xyz, size (w, l, h), orientation quaternion."""

    def __init__(
        self,
        center,
        size,
        orientation: Quaternion,
        label=np.nan,
        score=np.nan,
        velocity=(np.nan, np.nan, np.nan),
        name=None,
    ):
        assert not np.any(np.isnan(center))
        assert not np.any(np.isnan(size))
        assert len(center) == 3
        assert len(size) == 3

        self.center = np.array(center, dtype=np.float64)
        self.wlh = np.array(size, dtype=np.float64)
        self.orientation = orientation
        self.label = int(label) if not np.isnan(label) else label
        self.score = float(score) if not np.isnan(score) else score
        self.velocity = np.array(velocity)
        self.name = name

    def __eq__(self, other):
        center = np.allclose(self.center, other.center)
        wlh = np.allclose(self.wlh, other.wlh)
        orientation = np.allclose(self.orientation.elements, other.orientation.elements)
        return center and wlh and orientation

    def __repr__(self):
        return (
            f"Box(xyz=[{self.center[0]:.2f}, {self.center[1]:.2f}, {self.center[2]:.2f}], "
            f"wlh=[{self.wlh[0]:.2f}, {self.wlh[1]:.2f}, {self.wlh[2]:.2f}], "
            f"ang(deg)={self.orientation.degrees:.2f})"
        )

    def encode(self):
        return (
            self.center.tolist()
            + self.wlh.tolist()
            + self.orientation.elements.tolist()
            + [self.label]
            + [self.score]
            + self.velocity.tolist()
            + [self.name]
        )

    @classmethod
    def decode(cls, data):
        return Box(
            data[0:3],
            data[3:6],
            Quaternion(data[6:10]),
            label=data[10],
            score=data[11],
            velocity=data[12:15],
            name=data[15],
        )

    @property
    def rotation_matrix(self) -> np.ndarray:
        return self.orientation.rotation_matrix

    def translate(self, x) -> None:
        self.center = self.center + np.asarray(x, dtype=np.float64)

    def rotate(self, quaternion: Quaternion) -> None:
        self.center = np.dot(quaternion.rotation_matrix, self.center)
        self.orientation = quaternion * self.orientation
        self.velocity = np.dot(quaternion.rotation_matrix, self.velocity)

    def transform(self, transf_matrix: np.ndarray) -> None:
        transformed = np.dot(transf_matrix[0:3, 0:4].T, self.center)
        self.center = transformed[0:3] / transformed[3]
        self.orientation = self.orientation * Quaternion(matrix=transf_matrix[0:3, 0:3])
        self.velocity = np.dot(transf_matrix[0:3, 0:3], self.velocity)

    def corners(self, wlh_factor: float = 1.0) -> np.ndarray:
        """(3, 8) corners; convention: x forward, y left, z up;
        first four face forward, last four backward."""
        w, l, h = self.wlh * wlh_factor

        x_corners = l / 2 * np.array([1, 1, 1, 1, -1, -1, -1, -1])
        y_corners = w / 2 * np.array([1, -1, -1, 1, 1, -1, -1, 1])
        z_corners = h / 2 * np.array([1, 1, -1, -1, 1, 1, -1, -1])
        corners = np.vstack((x_corners, y_corners, z_corners))

        corners = np.dot(self.orientation.rotation_matrix, corners)
        corners = corners + self.center.reshape(3, 1)
        return corners

    def bottom_corners(self) -> np.ndarray:
        """(3, 4) bottom face; first two forward, last two backward."""
        return self.corners()[:, [2, 3, 7, 6]]

    def copy(self) -> "Box":
        return Box(
            self.center.copy(),
            self.wlh.copy(),
            Quaternion(self.orientation.elements),
            label=self.label,
            score=self.score,
            velocity=tuple(self.velocity),
            name=self.name,
        )
