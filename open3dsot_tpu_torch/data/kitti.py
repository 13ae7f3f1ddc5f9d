"""KITTI-tracking SOT dataset (host IO), port of `open3dsot_tpu/data/kitti.py`.

Scene splits (train 0000-0016, valid 0017-0018, test 0019-0020, TINY
variants), per-category tracklet extraction from the label_02 files,
Tr_velo_cam calibration, camera/velodyne coordinate modes, a per-frame
velodyne cache, the optional preload-crop, a whole-split pickle preload
cache, and the missing-frame single-zero-point fallback.

The label files are parsed without pandas (the card's machine has none):
`_read_labels` splits each line into the 17 named fields, the numeric ones
as float64 and `frame` / `track_id` as ints, and the tracklets come out as
the JAX package's `read_csv` path gives them: the type filter, track ids
in first-appearance order, each tracklet sorted by frame. An anno is a dict
with the fields of the JAX package's row (`scene` first), so the boxes are
the same bit for bit.

The preload pickle holds the port's classes and has a name of its own
(`port_preload_kitti_...`): the JAX package's `preload_kitti_...` file in
the same folder holds its classes, and is never read here.
"""

from __future__ import annotations

import os
import pickle
from collections import defaultdict

import numpy as np

from open3dsot_tpu_torch.data.base import BaseDataset
from open3dsot_tpu_torch.geometry import Box, PointCloud, Quaternion
from open3dsot_tpu_torch.geometry import points_utils

LABEL_FIELDS = (
    "frame", "track_id", "type", "truncated", "occluded",
    "alpha", "bbox_left", "bbox_top", "bbox_right",
    "bbox_bottom", "height", "width", "length", "x", "y", "z",
    "rotation_y",
)
_INT_FIELDS = ("frame", "track_id")
_POW10 = [float(f"1e{k}") for k in range(309)]


def parse_float(text: str) -> np.float64:
    """A decimal number rounded as the JAX loader's `pd.read_csv` rounds it
    (pandas' default C parser, `precise_xstrtod`): at most 17 digits, leading
    zeros among them, summed in float64, then scaled by one power of ten.
    That is the correctly rounded value for up to 15 significant digits, but
    not always beyond (0.12000000000000001 reads as 0.12): the boxes must be
    the JAX loader's bit for bit."""
    s = text.strip()
    neg = s[:1] == "-"
    if s[:1] in ("-", "+"):
        s = s[1:]
    mant, _, exp = s.replace("E", "e").partition("e")
    ip, _, fp = mant.partition(".")
    if not (ip + fp).isdigit() or (exp and not exp.lstrip("+-").isdigit()):
        return np.float64(text)  # nan, inf
    number, digits, exponent = 0.0, 0, 0
    for ch in ip:
        if digits < 17:
            number = number * 10.0 + (ord(ch) - 48)
            digits += 1
        else:
            exponent += 1
    for ch in fp[:max(0, 17 - digits)]:
        number = number * 10.0 + (ord(ch) - 48)
        exponent -= 1
    if neg:
        number = -number
    if exp:
        exponent += int(exp)
    if exponent > 308:
        return np.float64(-np.inf if neg else np.inf)
    if exponent > 0:
        number *= _POW10[exponent]
    elif exponent < -616:
        number = 0.0 * number
    elif exponent < -308:
        number = number / _POW10[-308 - exponent] / _POW10[308]
    else:
        number /= _POW10[-exponent]
    return np.float64(number)


def _read_labels(label_file: str) -> list:
    """One dict per line of a label_02 file, its fields by LABEL_FIELDS:
    `type` a str, `frame` and `track_id` ints, the others float64 (as
    `parse_float` reads them)."""
    rows = []
    with open(label_file) as f:
        for line in f:
            values = line.split()
            if not values:
                continue
            if len(values) != len(LABEL_FIELDS):
                raise ValueError(f"{label_file}: {len(values)} fields in a line, expected "
                                 f"{len(LABEL_FIELDS)}")
            rows.append({name: v if name == "type" else int(v) if name in _INT_FIELDS
                         else parse_float(v) for name, v in zip(LABEL_FIELDS, values)})
    return rows


class KittiDataset(BaseDataset):
    def __init__(self, path, split, category_name="Car", **kwargs):
        super().__init__(path, split, category_name, **kwargs)
        self.KITTI_Folder = path
        self.KITTI_velo = os.path.join(path, "velodyne")
        self.KITTI_label = os.path.join(path, "label_02")
        self.KITTI_calib = os.path.join(path, "calib")
        self.scene_list = self._build_scene_list(split)
        self.velos = defaultdict(dict)
        self.calibs = {}
        self.coordinate_mode = kwargs.get("coordinate_mode", "velodyne")
        self.preload_offset = kwargs.get("preload_offset", -1)
        self.tracklet_anno_list, self.tracklet_len_list = self._build_tracklet_anno()
        if self.preloading:
            self.training_samples = self._load_data()

    @staticmethod
    def _build_scene_list(split):
        split_u = split.upper()
        if "TRAIN" in split_u:
            scene_names = [0] if "TINY" in split_u else list(range(0, 17))
        elif "VALID" in split_u:
            scene_names = [18] if "TINY" in split_u else list(range(17, 19))
        elif "TEST" in split_u:
            scene_names = [19] if "TINY" in split_u else list(range(19, 21))
        else:
            scene_names = list(range(21))
        return ["%04d" % s for s in scene_names]

    def _load_data(self):
        preload_path = os.path.join(
            self.KITTI_Folder,
            f"port_preload_kitti_{self.category_name}_{self.split}_"
            f"{self.coordinate_mode}_{self.preload_offset}.dat",
        )
        if os.path.isfile(preload_path):
            with open(preload_path, "rb") as f:
                return pickle.load(f)
        training_samples = []
        for annos in self.tracklet_anno_list:
            training_samples.append([self._get_frame_from_anno(a) for a in annos])
        try:
            with open(preload_path, "wb") as f:
                pickle.dump(training_samples, f)
        except OSError:
            pass  # read-only data dir: keep in memory only
        return training_samples

    def get_num_scenes(self):
        return len(self.scene_list)

    def _build_tracklet_anno(self):
        list_of_tracklet_anno = []
        list_of_tracklet_len = []
        for scene in self.scene_list:
            label_file = os.path.join(self.KITTI_label, scene + ".txt")
            rows = _read_labels(label_file)
            if self.category_name in [
                "Car", "Van", "Truck", "Pedestrian", "Person_sitting",
                "Cyclist", "Tram", "Misc",
            ]:
                rows = [r for r in rows if r["type"] == self.category_name]
            elif self.category_name == "All":
                rows = [r for r in rows if r["type"] in ("Car", "Van", "Pedestrian", "Cyclist")]
            else:
                rows = [r for r in rows if r["type"] != "DontCare"]
            rows = [dict(scene=scene, **r) for r in rows]
            for track_id in dict.fromkeys(r["track_id"] for r in rows):
                tracklet_anno = sorted((r for r in rows if r["track_id"] == track_id),
                                       key=lambda r: r["frame"])
                list_of_tracklet_anno.append(tracklet_anno)
                list_of_tracklet_len.append(len(tracklet_anno))
        return list_of_tracklet_anno, list_of_tracklet_len

    def get_frames(self, seq_id, frame_ids):
        if self.preloading:
            return [self.training_samples[seq_id][f_id] for f_id in frame_ids]
        seq_annos = self.tracklet_anno_list[seq_id]
        return [self._get_frame_from_anno(seq_annos[f_id]) for f_id in frame_ids]

    def _get_frame_from_anno(self, anno):
        scene_id = anno["scene"]
        frame_id = anno["frame"]
        if scene_id not in self.calibs:
            self.calibs[scene_id] = self._read_calib_file(
                os.path.join(self.KITTI_calib, scene_id + ".txt")
            )
        calib = self.calibs[scene_id]
        velo_to_cam = np.vstack((calib["Tr_velo_cam"], np.array([0, 0, 0, 1])))

        if self.coordinate_mode == "velodyne":
            box_center_cam = np.array(
                [anno["x"], anno["y"] - anno["height"] / 2, anno["z"], 1]
            )
            box_center_velo = np.dot(np.linalg.inv(velo_to_cam), box_center_cam)[:3]
            size = [anno["width"], anno["length"], anno["height"]]
            orientation = Quaternion(
                axis=[0, 0, -1], radians=anno["rotation_y"]
            ) * Quaternion(axis=[0, 0, -1], degrees=90)
            bb = Box(box_center_velo, size, orientation)
        else:
            center = [anno["x"], anno["y"] - anno["height"] / 2, anno["z"]]
            size = [anno["width"], anno["length"], anno["height"]]
            orientation = Quaternion(
                axis=[0, 1, 0], radians=anno["rotation_y"]
            ) * Quaternion(axis=[1, 0, 0], radians=np.pi / 2)
            bb = Box(center, size, orientation)

        try:
            try:
                pc = self.velos[scene_id][frame_id]
            except KeyError:
                velodyne_path = os.path.join(
                    self.KITTI_velo, scene_id, "{:06}.bin".format(frame_id)
                )
                pc = PointCloud(
                    np.fromfile(velodyne_path, dtype=np.float32).reshape(-1, 4).T
                )
                if self.coordinate_mode == "camera":
                    pc.transform(velo_to_cam)
                self.velos[scene_id][frame_id] = pc
            if self.preload_offset > 0:
                pc = points_utils.crop_pc_axis_aligned(pc, bb, offset=self.preload_offset)
        except Exception:
            # missing velodyne frame: single origin point (the reference's fallback)
            pc = PointCloud(np.array([[0, 0, 0]]).T)
        return {"pc": pc, "3d_bbox": bb, "meta": anno}

    @staticmethod
    def _read_calib_file(filepath):
        data = {}
        with open(filepath, "r") as f:
            for line in f.readlines():
                values = line.split()
                try:
                    data[values[0]] = np.array(
                        [float(x) for x in values[1:]]
                    ).reshape(3, 4)
                except ValueError:
                    pass
        return data
