"""Minimal unit-quaternion math (numpy, host side).

Self-contained replacement for the small slice of `pyquaternion.Quaternion`
the reference's host geometry uses (construction from axis/angle or rotation
matrix, composition, inverse, rotation_matrix, signed angle/axis accessors;
cf. /root/reference/datasets/points_utils.py and data_classes.py). Device-side
math never touches this class: boxes are (x, y, z, theta) tensors there
(see geometry/rigid.py).
"""

from __future__ import annotations

import math

import numpy as np


class Quaternion:
    __slots__ = ("q",)

    def __init__(self, *args, axis=None, degrees=None, radians=None, matrix=None, **kwargs):
        if matrix is not None:
            self.q = _from_matrix(np.asarray(matrix, dtype=np.float64))
        elif axis is not None:
            if degrees is not None:
                angle = math.radians(degrees)
            elif radians is not None:
                angle = float(radians)
            else:
                angle = 0.0
            ax = np.asarray(axis, dtype=np.float64)
            n = np.linalg.norm(ax)
            if n < 1e-12:
                raise ValueError("zero-norm rotation axis")
            ax = ax / n
            half = angle / 2.0
            s = math.sin(half)
            self.q = np.array([math.cos(half), ax[0] * s, ax[1] * s, ax[2] * s])
        elif len(args) == 1:
            arg = args[0]
            if isinstance(arg, Quaternion):
                self.q = arg.q.copy()
            else:
                self.q = np.asarray(arg, dtype=np.float64).reshape(4).copy()
        elif len(args) == 4:
            self.q = np.array(args, dtype=np.float64)
        elif len(args) == 0:
            self.q = np.array([1.0, 0.0, 0.0, 0.0])
        else:
            raise ValueError(f"cannot construct Quaternion from {args!r}")

    # --- accessors -------------------------------------------------------
    @property
    def elements(self) -> np.ndarray:
        return self.q.copy()

    @property
    def scalar(self) -> float:
        return float(self.q[0])

    @property
    def vector(self) -> np.ndarray:
        return self.q[1:].copy()

    @property
    def norm(self) -> float:
        return float(np.linalg.norm(self.q))

    def _normalised_q(self) -> np.ndarray:
        n = np.linalg.norm(self.q)
        if n < 1e-12:
            raise ValueError("zero-norm quaternion")
        return self.q / n

    @property
    def axis(self) -> np.ndarray:
        q = self._normalised_q()
        v = q[1:]
        n = np.linalg.norm(v)
        if n < 1e-12:
            return np.zeros(3)
        return v / n

    @property
    def angle(self) -> float:
        """Signed rotation angle wrapped to (-pi, pi]."""
        q = self._normalised_q()
        n = np.linalg.norm(q[1:])
        theta = 2.0 * math.atan2(n, q[0])
        # wrap to (-pi, pi]
        wrapped = ((theta + math.pi) % (2.0 * math.pi)) - math.pi
        if wrapped == -math.pi:
            wrapped = math.pi
        return wrapped

    @property
    def radians(self) -> float:
        return self.angle

    @property
    def degrees(self) -> float:
        return math.degrees(self.angle)

    @property
    def rotation_matrix(self) -> np.ndarray:
        w, x, y, z = self._normalised_q()
        return np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ]
        )

    @property
    def inverse(self) -> "Quaternion":
        w, x, y, z = self.q
        n2 = w * w + x * x + y * y + z * z
        return Quaternion(np.array([w, -x, -y, -z]) / n2)

    @property
    def conjugate(self) -> "Quaternion":
        w, x, y, z = self.q
        return Quaternion(np.array([w, -x, -y, -z]))

    # --- ops -------------------------------------------------------------
    def __mul__(self, other: "Quaternion") -> "Quaternion":
        w1, x1, y1, z1 = self.q
        w2, x2, y2, z2 = other.q
        return Quaternion(
            np.array(
                [
                    w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                    w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                    w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                    w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                ]
            )
        )

    def rotate(self, v):
        """Rotate a 3-vector."""
        return self.rotation_matrix @ np.asarray(v, dtype=np.float64)

    def __eq__(self, other):
        return np.allclose(self.q, other.q) or np.allclose(self.q, -other.q)

    def __repr__(self):
        return f"Quaternion({self.q[0]:+.6f}, {self.q[1]:+.6f}, {self.q[2]:+.6f}, {self.q[3]:+.6f})"


def _from_matrix(m: np.ndarray) -> np.ndarray:
    """Rotation matrix (3x3 or 4x4) -> quaternion elements [w, x, y, z].

    Shepperd's method: numerically stable for all rotation angles.
    """
    if m.shape == (4, 4):
        m = m[:3, :3]
    if m.shape != (3, 3):
        raise ValueError(f"expected 3x3 or 4x4 matrix, got {m.shape}")
    t = np.trace(m)
    if t > 0.0:
        s = math.sqrt(t + 1.0) * 2.0
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = math.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2.0
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = math.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2.0
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = math.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2.0
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)
