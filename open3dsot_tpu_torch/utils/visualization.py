"""Debug visualization writers (PLY / OBJ), port of
`open3dsot_tpu/utils/visualization.py`.

The reference's debug dump path (its datasets/utils.py get_3d_box,
write_ply, box2obj, write_bbox, write_obj): point clouds as PLY/OBJ vertex
lists, boxes as corner wireframes/meshes for quick inspection in any mesh
viewer.
"""

from __future__ import annotations

import numpy as np


def get_3d_box(box_size, heading_angle, center) -> np.ndarray:
    """(8, 3) corners for (w, l, h), z-yaw heading, center — same corner
    ordering convention as the reference helper."""
    w, l, h = box_size
    c, s = np.cos(heading_angle), np.sin(heading_angle)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    x = l / 2 * np.array([1, 1, 1, 1, -1, -1, -1, -1])
    y = w / 2 * np.array([1, -1, -1, 1, 1, -1, -1, 1])
    z = h / 2 * np.array([1, 1, -1, -1, 1, 1, -1, -1])
    corners = R @ np.vstack([x, y, z])
    return (corners + np.asarray(center).reshape(3, 1)).T


def write_ply(points: np.ndarray, path: str, colors=None) -> None:
    """(N, 3) points (+ optional (N, 3) uint8 colors) -> ascii PLY."""
    points = np.asarray(points)
    n = len(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for i in range(n):
            row = f"{points[i, 0]} {points[i, 1]} {points[i, 2]}"
            if colors is not None:
                row += f" {int(colors[i, 0])} {int(colors[i, 1])} {int(colors[i, 2])}"
            f.write(row + "\n")


def write_obj(points: np.ndarray, path: str) -> None:
    """(N, 3) points -> OBJ vertex list (`.obj` appended if absent)."""
    if not path.endswith(".obj"):
        path = path + ".obj"
    with open(path, "w") as f:
        for p in np.asarray(points):
            f.write(f"v {p[0]} {p[1]} {p[2]}\n")


_BOX_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),  # front face
    (4, 5), (5, 6), (6, 7), (7, 4),  # back face
    (0, 4), (1, 5), (2, 6), (3, 7),  # connectors
]

_BOX_FACES = [
    (1, 2, 3, 4), (5, 8, 7, 6), (1, 5, 6, 2), (2, 6, 7, 3), (3, 7, 8, 4), (5, 1, 4, 8),
]


def box2obj(box, path: str) -> None:
    """Box (geometry.Box) -> OBJ quad mesh of its 8 corners."""
    corners = box.corners().T  # (8, 3)
    with open(path, "w") as f:
        for p in corners:
            f.write(f"v {p[0]} {p[1]} {p[2]}\n")
        for face in _BOX_FACES:
            f.write("f " + " ".join(str(i) for i in face) + "\n")


def write_bbox(corners: np.ndarray, color_idx: int, path: str, segments: int = 8,
               radius: float = 0.02) -> None:
    """(8, 3) corners -> PLY wireframe of cylinder-approximated edges.

    A lightweight stand-in for the reference's cylinder-mesh writer
    (datasets/utils.py:79-206): each edge becomes a thin triangulated tube.
    """
    corners = np.asarray(corners, dtype=float)
    verts, faces = [], []
    palette = [(255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0)]
    color = palette[color_idx % len(palette)]
    for a_idx, b_idx in _BOX_EDGES:
        a, b = corners[a_idx], corners[b_idx]
        axis = b - a
        L = np.linalg.norm(axis)
        if L < 1e-9:
            continue
        axis = axis / L
        # orthonormal frame
        ref = np.array([0.0, 0.0, 1.0]) if abs(axis[2]) < 0.9 else np.array([1.0, 0.0, 0.0])
        u = np.cross(axis, ref)
        u /= np.linalg.norm(u)
        v = np.cross(axis, u)
        base = len(verts)
        for end in (a, b):
            for k in range(segments):
                ang = 2 * np.pi * k / segments
                verts.append(end + radius * (np.cos(ang) * u + np.sin(ang) * v))
        for k in range(segments):
            k2 = (k + 1) % segments
            faces.append((base + k, base + k2, base + segments + k2))
            faces.append((base + k, base + segments + k2, base + segments + k))
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element face {len(faces)}\nproperty list uchar int vertex_index\n")
        f.write("end_header\n")
        for p in verts:
            f.write(f"{p[0]} {p[1]} {p[2]} {color[0]} {color[1]} {color[2]}\n")
        for face in faces:
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n")
