"""Training and eval samplers (host, numpy): copy of
`open3dsot_tpu/data/sampler.py`'s `siamese_processing`,
`PointTrackingSampler` and `TestTrackingSampler` (reference
sampler.py:16-79, 183-259).

`siamese_processing` follows the reference statement for statement (the
random draws for the offsets come in the same order), so the same numpy
seed gives the same training pairs as the JAX package. The motion sampler
of M2-Track training is not ported yet (ROADMAP.md, modules to port).
"""

from __future__ import annotations

import numpy as np

from open3dsot_tpu_torch.data.searchspace import KalmanFiltering
from open3dsot_tpu_torch.geometry import points_utils


def siamese_processing(data, config, template_transform=None, search_transform=None):
    first_frame = data["first_frame"]
    template_frame = data["template_frame"]
    search_frame = data["search_frame"]
    candidate_id = data["candidate_id"]
    first_pc, first_box = first_frame["pc"], first_frame["3d_bbox"]
    template_pc, template_box = template_frame["pc"], template_frame["3d_bbox"]
    search_pc, search_box = search_frame["pc"], search_frame["3d_bbox"]
    if template_transform is not None:
        template_pc, template_box = template_transform(template_pc, template_box)
        first_pc, first_box = template_transform(first_pc, first_box)
    if search_transform is not None:
        search_pc, search_box = search_transform(search_pc, search_box)

    # template: merge first + (perturbed) template-frame crops
    if candidate_id == 0:
        samplegt_offsets = np.zeros(3)
    else:
        samplegt_offsets = np.random.uniform(low=-0.3, high=0.3, size=3)
        samplegt_offsets[2] = samplegt_offsets[2] * (5 if config.degrees else np.deg2rad(5))
    template_box = points_utils.getOffsetBB(
        template_box, samplegt_offsets, limit_box=config.data_limit_box, degrees=config.degrees
    )
    model_pc, model_box = points_utils.getModel(
        [first_pc, template_pc],
        [first_box, template_box],
        scale=config.model_bb_scale,
        offset=config.model_bb_offset,
    )
    assert model_pc.nbr_points() > 20, "not enough template points"

    # search area around a Kalman-perturbed gt box
    if candidate_id == 0 and config.num_candidates > 1:
        sample_offset = np.zeros(3)
    else:
        gaussian = KalmanFiltering(bnd=[1, 1, (5 if config.degrees else np.deg2rad(5))])
        sample_offset = gaussian.sample(1)[0]
    sample_bb = points_utils.getOffsetBB(
        search_box, sample_offset, limit_box=config.data_limit_box, degrees=config.degrees
    )
    search_pc_crop = points_utils.generate_subwindow(
        search_pc, sample_bb, scale=config.search_bb_scale, offset=config.search_bb_offset
    )
    assert search_pc_crop.nbr_points() > 20, "not enough search points"
    search_box = points_utils.transform_box(search_box, sample_bb)
    seg_label = points_utils.get_in_box_mask(search_pc_crop, search_box).astype(int)
    search_bbox_reg = [
        search_box.center[0],
        search_box.center[1],
        search_box.center[2],
        -sample_offset[2],
    ]

    template_points, idx_t = points_utils.regularize_pc(model_pc.points.T, config.template_size)
    search_points, idx_s = points_utils.regularize_pc(search_pc_crop.points.T, config.search_size)
    seg_label = seg_label[idx_s]
    data_dict = {
        "template_points": template_points.astype("float32"),
        "search_points": search_points.astype("float32"),
        "box_label": np.array(search_bbox_reg).astype("float32"),
        "bbox_size": search_box.wlh.astype("float32"),
        "seg_label": seg_label.astype("float32"),
    }
    if getattr(config, "box_aware", False):
        template_bc = points_utils.get_point_to_box_distance(template_points, model_box)
        search_bc = points_utils.get_point_to_box_distance(search_points, search_box)
        data_dict.update(
            points2cc_dist_t=template_bc.astype("float32"),
            points2cc_dist_s=search_bc.astype("float32"),
        )
    return data_dict


class PointTrackingSampler:
    """Siamese training sampler (sampler.py:183-243): a flat index is (frame,
    candidate), `num_candidates` perturbed variants per frame; a sample that
    fails its asserts is redrawn at a random index."""

    def __init__(self, dataset, random_sample, sample_per_epoch=10000,
                 processing=siamese_processing, config=None, **kwargs):
        if config is None:
            from open3dsot_tpu_torch.config import Config

            config = Config(kwargs)
        self.sample_per_epoch = sample_per_epoch
        self.dataset = dataset
        self.processing = processing
        self.config = config
        self.random_sample = random_sample
        self.num_candidates = getattr(config, "num_candidates", 1)
        if getattr(config, "use_augmentation", False):
            self.transform = points_utils.apply_augmentation
        else:
            self.transform = None
        if not self.random_sample:
            num_frames_total = 0
            self.tracklet_start_ids = [num_frames_total]
            for i in range(dataset.get_num_tracklets()):
                num_frames_total += dataset.get_num_frames_tracklet(i)
                self.tracklet_start_ids.append(num_frames_total)

    def get_anno_index(self, index):
        return index // self.num_candidates

    def get_candidate_index(self, index):
        return index % self.num_candidates

    def _locate(self, anno_id):
        for i in range(self.dataset.get_num_tracklets()):
            if self.tracklet_start_ids[i] <= anno_id < self.tracklet_start_ids[i + 1]:
                this_frame_id = anno_id - self.tracklet_start_ids[i]
                prev_frame_id = max(this_frame_id - 1, 0)
                return i, (0, prev_frame_id, this_frame_id)
        raise IndexError(anno_id)

    def __len__(self):
        if self.random_sample:
            return self.sample_per_epoch * self.num_candidates
        return self.dataset.get_num_frames_total() * self.num_candidates

    def __getitem__(self, index):
        anno_id = self.get_anno_index(index)
        candidate_id = self.get_candidate_index(index)
        try:
            if self.random_sample:
                tracklet_id = int(np.random.randint(0, self.dataset.get_num_tracklets()))
                tracklet_annos = self.dataset.tracklet_anno_list[tracklet_id]
                frame_ids = [0] + list(
                    np.random.choice(len(tracklet_annos), size=2, replace=False)
                )
            else:
                tracklet_id, frame_ids = self._locate(anno_id)
            first_frame, template_frame, search_frame = self.dataset.get_frames(
                tracklet_id, frame_ids=frame_ids
            )
            data = {
                "first_frame": first_frame,
                "template_frame": template_frame,
                "search_frame": search_frame,
                "candidate_id": candidate_id,
            }
            return self.processing(
                data, self.config, template_transform=None, search_transform=self.transform
            )
        except AssertionError:
            return self[int(np.random.randint(0, len(self)))]


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
