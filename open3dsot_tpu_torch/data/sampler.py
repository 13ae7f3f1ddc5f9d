"""Eval sampler (host, numpy): copy of `open3dsot_tpu/data/sampler.py`'s
TestTrackingSampler (reference sampler.py:246-259).

The training samplers (siamese and motion processing) wait for the
training slice of the port (ROADMAP.md, modules to port).
"""

from __future__ import annotations


class TestTrackingSampler:
    """index = tracklet id -> the whole tracklet (sampler.py:246-259)."""

    def __init__(self, dataset, config=None, **kwargs):
        if config is None:
            from open3dsot_tpu_torch.config import Config

            config = Config(kwargs)
        self.dataset = dataset
        self.config = config

    def __len__(self):
        return self.dataset.get_num_tracklets()

    def __getitem__(self, index):
        tracklet_annos = self.dataset.tracklet_anno_list[index]
        frame_ids = list(range(len(tracklet_annos)))
        return self.dataset.get_frames(index, frame_ids)
