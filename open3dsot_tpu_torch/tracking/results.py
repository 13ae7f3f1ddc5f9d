"""Tracking-results persistence (--save_results), port of
`open3dsot_tpu/tracking/results.py`.

The reference computes each tracklet's predicted trajectory but never
writes it anywhere, so error analysis or downstream consumption requires
rerunning the tracker. This writer persists one JSONL record per tracklet:

    {"tracklet": i, "n_frames": T,
     "boxes":  [[cx, cy, cz, w, l, h, r00..r22], ...]   # one per frame,
     "ious":   [...], "distances": [...]}                # frame 0 = gt box

with a header line recording the config essentials (model, category,
up_axis, IoU_space) so a record is self-describing. Boxes carry the full
rotation matrix, so camera-mode (y-up) trajectories need no convention
knowledge to consume. The records are the JAX package's, field for field.
"""

from __future__ import annotations

import json

import numpy as np


class ResultsWriter:
    def __init__(self, path: str, config):
        self.path = path
        self._f = open(path, "w")
        header = {
            "net_model": getattr(config, "net_model", None),
            "category_name": getattr(config, "category_name", None),
            "up_axis": list(getattr(config, "up_axis", [0, 0, 1])),
            "IoU_space": int(getattr(config, "IoU_space", 3)),
            "box_format": "cx cy cz w l h r00 r01 r02 r10 r11 r12 r20 r21 r22",
        }
        self._f.write(json.dumps({"header": header}) + "\n")
        self.n_written = 0

    @staticmethod
    def _encode_box(box) -> list:
        return (
            [float(v) for v in np.asarray(box.center).reshape(3)]
            + [float(v) for v in np.asarray(box.wlh).reshape(3)]
            + [float(v) for v in np.asarray(box.rotation_matrix).reshape(9)]
        )

    def add(self, tracklet_index: int, results_bbs, ious, distances):
        rec = {
            "tracklet": int(tracklet_index),
            "n_frames": len(results_bbs),
            "boxes": [self._encode_box(b) for b in results_bbs],
            "ious": [float(v) for v in ious],
            "distances": [float(v) for v in distances],
        }
        self._f.write(json.dumps(rec) + "\n")
        self.n_written += 1

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_results(path: str):
    """Load a results file -> (header, list of records)."""
    with open(path) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    return lines[0]["header"], lines[1:]
