"""nuScenes SOT dataset (host IO), devkit-free, port of
`open3dsot_tpu/data/nuscenes_data.py`.

Instead of depending on nuscenes-devkit, the public JSON table format is
read directly (`NuScenesTables`): instance / sample_annotation / sample /
sample_data / scene / category / calibrated_sensor / ego_pose, indexed by
token. Tracklets are annotation-chain walks filtered by scene split,
category, and first-box lidar point count; per-frame lidar is transformed
into the global frame via calibrated_sensor then ego_pose.

Scene splits: `{dataroot}/splits.json` (mapping split -> scene-name list)
wins, else data/nuscenes_splits.py (vendored mini splits, the optional full
JSON, the devkit if importable).

The category-mapping tables (general_to_tracking_class /
tracking_to_general_class) and the tracklet-assembly rules (keyframe
filtering, min_points on eval splits, annotation-chain walk order) are the
reference's: they define WHICH tracklets exist and in what order.

The preload pickle holds the port's classes and has a name of its own
(`port_preload_nuscenes_...`): the JAX package's `preload_nuscenes_...` file
is never read here.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np

from open3dsot_tpu_torch.data.base import BaseDataset
from open3dsot_tpu_torch.geometry import Box, PointCloud, Quaternion
from open3dsot_tpu_torch.geometry import points_utils

general_to_tracking_class = {
    "animal": "void / ignore",
    "human.pedestrian.personal_mobility": "void / ignore",
    "human.pedestrian.stroller": "void / ignore",
    "human.pedestrian.wheelchair": "void / ignore",
    "movable_object.barrier": "void / ignore",
    "movable_object.debris": "void / ignore",
    "movable_object.pushable_pullable": "void / ignore",
    "movable_object.trafficcone": "void / ignore",
    "static_object.bicycle_rack": "void / ignore",
    "vehicle.emergency.ambulance": "void / ignore",
    "vehicle.emergency.police": "void / ignore",
    "vehicle.construction": "void / ignore",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.car": "car",
    "vehicle.motorcycle": "motorcycle",
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
    "vehicle.trailer": "trailer",
    "vehicle.truck": "truck",
}

tracking_to_general_class = {}
for _g, _t in general_to_tracking_class.items():
    tracking_to_general_class.setdefault(_t, []).append(_g)


class NuScenesTables:
    """Minimal reader for the nuScenes JSON tables, indexed by token."""

    TABLES = (
        "instance",
        "sample_annotation",
        "sample",
        "sample_data",
        "scene",
        "category",
        "calibrated_sensor",
        "ego_pose",
    )

    def __init__(self, dataroot: str, version: str):
        self.dataroot = dataroot
        self.version = version
        table_dir = os.path.join(dataroot, version)
        self._tables = {}
        self._index = {}
        for name in self.TABLES:
            with open(os.path.join(table_dir, name + ".json")) as f:
                rows = json.load(f)
            self._tables[name] = rows
            self._index[name] = {row["token"]: row for row in rows}

    def get(self, table: str, token: str) -> dict:
        return self._index[table][token]

    def table(self, table: str):
        return self._tables[table]


def _load_scene_splits(dataroot: str, split: str) -> list:
    """Scene names for a split. dataroot/splits.json (user override) wins;
    otherwise the vendored in-tree constants / devkit / error chain in
    data/nuscenes_splits.py (mini splits always work devkit-free; the full
    v1.0 lists once nuscenes_splits_full.json is vendored)."""
    splits_path = os.path.join(dataroot, "splits.json")
    if os.path.isfile(splits_path):
        with open(splits_path) as f:
            table = json.load(f)
        if split in table:
            return table[split]
    from open3dsot_tpu_torch.data.nuscenes_splits import get_split_scenes

    return get_split_scenes(split, dataroot=dataroot)


class NuScenesDataset(BaseDataset):
    def __init__(self, path, split, category_name="Car", version="v1.0-trainval", **kwargs):
        super().__init__(path, split, category_name, **kwargs)
        self.nusc = NuScenesTables(dataroot=path, version=version)
        self.version = version
        self.key_frame_only = kwargs.get("key_frame_only", False)
        self.min_points = kwargs.get("min_points", -1)
        self.preload_offset = kwargs.get("preload_offset", -1)
        self.track_instances = self.filter_instance(
            split, category_name.lower(), self.min_points
        )
        self.tracklet_anno_list, self.tracklet_len_list = self._build_tracklet_anno()
        if self.preloading:
            self.training_samples = self._load_data()

    def filter_instance(self, split, category_name=None, min_points=-1):
        general_classes = (
            tracking_to_general_class[category_name] if category_name is not None else None
        )
        scene_names = set(_load_scene_splits(self.path, split))
        instances = []
        for instance in self.nusc.table("instance"):
            anno = self.nusc.get("sample_annotation", instance["first_annotation_token"])
            sample = self.nusc.get("sample", anno["sample_token"])
            scene = self.nusc.get("scene", sample["scene_token"])
            category = self.nusc.get("category", instance["category_token"])["name"]
            if (
                scene["name"] in scene_names
                and anno["num_lidar_pts"] >= min_points
                and (general_classes is None or category in general_classes)
            ):
                instances.append(instance)
        return instances

    def _build_tracklet_anno(self):
        list_of_tracklet_anno = []
        list_of_tracklet_len = []
        for instance in self.track_instances:
            track_anno = []
            curr_anno_token = instance["first_annotation_token"]
            while curr_anno_token != "":
                ann_record = self.nusc.get("sample_annotation", curr_anno_token)
                sample = self.nusc.get("sample", ann_record["sample_token"])
                sample_data_lidar = self.nusc.get("sample_data", sample["data"]["LIDAR_TOP"])
                curr_anno_token = ann_record["next"]
                if self.key_frame_only and not sample_data_lidar["is_key_frame"]:
                    continue
                track_anno.append(
                    {"sample_data_lidar": sample_data_lidar, "box_anno": ann_record}
                )
            list_of_tracklet_anno.append(track_anno)
            list_of_tracklet_len.append(len(track_anno))
        return list_of_tracklet_anno, list_of_tracklet_len

    def _load_data(self):
        preload_path = os.path.join(
            self.path,
            f"port_preload_nuscenes_{self.category_name}_{self.split}_{self.version}_"
            f"{self.preload_offset}_{self.min_points}.dat",
        )
        if os.path.isfile(preload_path):
            with open(preload_path, "rb") as f:
                return pickle.load(f)
        training_samples = []
        for annos in self.tracklet_anno_list:
            training_samples.append([self._get_frame_from_anno_data(a) for a in annos])
        try:
            with open(preload_path, "wb") as f:
                pickle.dump(training_samples, f)
        except OSError:
            pass
        return training_samples

    def get_frames(self, seq_id, frame_ids):
        if self.preloading:
            return [self.training_samples[seq_id][f_id] for f_id in frame_ids]
        seq_annos = self.tracklet_anno_list[seq_id]
        return [self._get_frame_from_anno_data(seq_annos[f_id]) for f_id in frame_ids]

    def _get_frame_from_anno_data(self, anno):
        sample_data_lidar = anno["sample_data_lidar"]
        box_anno = anno["box_anno"]
        bb = Box(
            box_anno["translation"],
            box_anno["size"],
            Quaternion(box_anno["rotation"]),
            name=self.category_name,
        )
        pcl_path = os.path.join(self.path, sample_data_lidar["filename"])
        pc = PointCloud(PointCloud.load_pcd_bin(pcl_path))

        cs = self.nusc.get("calibrated_sensor", sample_data_lidar["calibrated_sensor_token"])
        pc.rotate(Quaternion(cs["rotation"]).rotation_matrix)
        pc.translate(np.array(cs["translation"]))

        pose = self.nusc.get("ego_pose", sample_data_lidar["ego_pose_token"])
        pc.rotate(Quaternion(pose["rotation"]).rotation_matrix)
        pc.translate(np.array(pose["translation"]))

        if self.preload_offset > 0:
            pc = points_utils.crop_pc_axis_aligned(pc, bb, offset=self.preload_offset)
        return {"pc": pc, "3d_bbox": bb, "meta": anno}
