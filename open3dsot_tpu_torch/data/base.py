"""Abstract tracklet dataset (reference datasets/base_dataset.py:7-25)."""

from __future__ import annotations


class BaseDataset:
    def __init__(self, path, split, category_name="Car", **kwargs):
        self.path = path
        self.split = split
        self.category_name = category_name
        self.preloading = kwargs.get("preloading", True)
        self.tracklet_anno_list = []
        self.tracklet_len_list = []

    def get_num_tracklets(self) -> int:
        return len(self.tracklet_anno_list)

    def get_num_frames_total(self) -> int:
        return sum(self.tracklet_len_list)

    def get_num_frames_tracklet(self, tracklet_id: int) -> int:
        return self.tracklet_len_list[tracklet_id]

    def get_frames(self, seq_id: int, frame_ids):
        """Return a list of {"pc": PointCloud, "3d_bbox": Box, "meta": ...}."""
        raise NotImplementedError
