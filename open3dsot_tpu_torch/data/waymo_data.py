"""Waymo SOT dataset (CenterPoint-style pickles; host IO), port of
`open3dsot_tpu/data/waymo_data.py`.

Consumes `infos_{split}_01sweeps_filter_zero_gt.pkl`, auto-builds
per-tracklet `sot_infos_{cat}_{split}.pkl` when missing, loads per-frame
lidar/annos pickles, transforms vehicle->global via veh_to_global, swaps the
Waymo length/width box convention to KITTI's and negates heading, as the
reference does. `tiny` caps to the first 100 tracklets.

The preload pickle holds the port's classes and has a name of its own
(`port_preload_...`): the JAX package's `preload_...` file is never read
here. The `sot_infos_*.pkl` index holds only numpy arrays and strings, so
both packages share it.
"""

from __future__ import annotations

import os
import pickle
from collections import defaultdict

import numpy as np

from open3dsot_tpu_torch.data.base import BaseDataset
from open3dsot_tpu_torch.geometry import Box, PointCloud, Quaternion
from open3dsot_tpu_torch.geometry import points_utils


def generate_waymo_data(root: str, class_name: str, split: str) -> None:
    """Group per-frame object annos by object name into per-tracklet infos
    (the reference's generate_waymo_sot.py)."""
    split = split.lower()
    class_name = class_name.lower()
    infos_path = os.path.join(root, f"infos_{split}_01sweeps_filter_zero_gt.pkl")
    with open(infos_path, "rb") as f:
        infos = pickle.load(f)

    label_map = {1: "vehicle", 2: "pedestrian", 4: "cyclist"}
    sot_infos = defaultdict(list)
    for info in infos:
        lidar_path = info["path"]
        anno_path = info.get("anno_path", lidar_path.replace("lidar", "annos"))
        if not os.path.isabs(anno_path):
            anno_path = os.path.join(root, anno_path)
        with open(anno_path, "rb") as f:
            annos = pickle.load(f)
        for obj in annos["objects"]:
            if label_map.get(obj["label"]) != class_name:
                continue
            sot_infos[obj["name"]].append(
                {
                    "PC": lidar_path,
                    "Box": np.array(obj["box"], dtype=np.float32),
                    "Class": class_name,
                }
            )
    out_path = os.path.join(root, f"sot_infos_{class_name}_{split}.pkl")
    with open(out_path, "wb") as f:
        pickle.dump(dict(sot_infos), f)


class WaymoDataset(BaseDataset):
    def __init__(self, path, split, category_name="Vehicle", **kwargs):
        super().__init__(path, split, category_name, **kwargs)
        self.Waymo_Folder = path
        self.split = "val" if split.lower() == "test" else split.lower()
        self.category_name = category_name.lower()
        assert self.split in ["train", "val"]
        assert self.category_name in ["vehicle", "pedestrian", "cyclist"]

        self.tiny = kwargs.get("tiny", False)
        self.tracklet_anno_list, self.tracklet_len_list = self._build_tracklet_anno()
        if self.tiny:
            self.tracklet_anno_list = self.tracklet_anno_list[:100]
            self.tracklet_len_list = self.tracklet_len_list[:100]

        self.preload_offset = kwargs.get("preload_offset", 10)
        if self.preloading:
            self.training_samples = self._load_data()

    def _build_tracklet_anno(self):
        sot_path = os.path.join(
            self.Waymo_Folder, f"sot_infos_{self.category_name}_{self.split}.pkl"
        )
        if not os.path.exists(sot_path):
            generate_waymo_data(self.Waymo_Folder, self.category_name, self.split)
        with open(sot_path, "rb") as f:
            infos = pickle.load(f)
        annos, lens = [], []
        for scene in list(infos.keys()):
            annos.append(infos[scene])
            lens.append(len(infos[scene]))
        return annos, lens

    def _load_data(self):
        tag = "_tiny" if self.tiny else ""
        preload_path = os.path.join(
            self.Waymo_Folder,
            f"port_preload_{self.split}_{self.category_name}_{self.preload_offset}{tag}.dat",
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
            pass
        return training_samples

    def get_frames(self, seq_id, frame_ids):
        if self.preloading:
            return [self.training_samples[seq_id][f_id] for f_id in frame_ids]
        seq_annos = self.tracklet_anno_list[seq_id]
        return [self._get_frame_from_anno(seq_annos[f_id]) for f_id in frame_ids]

    def _get_frame_from_anno(self, anno):
        lidar_path = anno["PC"]
        if not os.path.isabs(lidar_path):
            lidar_path = os.path.join(self.Waymo_Folder, lidar_path)
        gt_boxes = np.array(anno["Box"], dtype=np.float64).copy()

        with open(lidar_path, "rb") as f:
            pc_info = pickle.load(f)
        pointcloud = pc_info["lidars"]["points_xyz"].transpose((1, 0))

        with open(lidar_path.replace("lidar", "annos"), "rb") as f:
            ref_obj = pickle.load(f)
        ref_pose = np.reshape(ref_obj["veh_to_global"], [4, 4])
        global_from_car = np.eye(4)
        global_from_car[:3, :3] = ref_pose[:3, :3]
        global_from_car[:3, 3] = ref_pose[:3, 3]

        nbr = pointcloud.shape[1]
        pointcloud = pointcloud.astype(np.float64)
        pointcloud[:3, :] = global_from_car.dot(
            np.vstack((pointcloud[:3, :], np.ones(nbr)))
        )[:3, :]

        # Waymo (x,y,z,length,width,...) heading ccw-from-x -> KITTI convention
        gt_boxes[[3, 4]] = gt_boxes[[4, 3]]

        pc = PointCloud(pointcloud)
        bb = Box(
            gt_boxes[0:3],
            gt_boxes[3:6],
            Quaternion(axis=[0, 0, 1], radians=-gt_boxes[-1]),
            velocity=gt_boxes[6:9],
            name=anno["Class"],
        )
        bb.rotate(Quaternion(matrix=global_from_car[:3, :3]))
        bb.translate(global_from_car[:3, -1])
        if self.preload_offset > 0:
            pc = points_utils.crop_pc_axis_aligned(pc, bb, offset=self.preload_offset)
        return {"pc": pc, "3d_bbox": bb, "meta": anno}
