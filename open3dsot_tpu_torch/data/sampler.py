"""Training and eval samplers (host, numpy): copy of
`open3dsot_tpu/data/sampler.py`'s `siamese_processing`, `motion_processing`,
`PointTrackingSampler`, `TestTrackingSampler` and `MotionTrackingSampler`
(reference sampler.py:16-288).

`siamese_processing` and `motion_processing` follow the reference
statement for statement (the random draws for the offsets come in the same
order), so the same numpy seed gives the same training pairs and M2-Track
motion samples as the JAX package; `MotionTrackingSampler` is its
sequential motion sampler (reference sampler.py:262-288).
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


def motion_processing(data, config, template_transform=None, search_transform=None):
    prev_frame = data["prev_frame"]
    this_frame = data["this_frame"]
    candidate_id = data["candidate_id"]
    prev_pc, prev_box = prev_frame["pc"], prev_frame["3d_bbox"]
    this_pc, this_box = this_frame["pc"], this_frame["3d_bbox"]

    num_points_in_prev_box = points_utils.points_in_box(prev_box, prev_pc.points).sum()
    assert num_points_in_prev_box > 10, "not enough target points"

    if template_transform is not None:
        prev_pc, prev_box = template_transform(prev_pc, prev_box)
    if search_transform is not None:
        this_pc, this_box = search_transform(this_pc, this_box)

    if candidate_id == 0:
        sample_offsets = np.zeros(3)
    else:
        sample_offsets = np.random.uniform(low=-0.3, high=0.3, size=3)
        sample_offsets[2] = sample_offsets[2] * (5 if config.degrees else np.deg2rad(5))
    ref_box = points_utils.getOffsetBB(
        prev_box, sample_offsets, limit_box=config.data_limit_box, degrees=config.degrees
    )
    prev_frame_pc = points_utils.generate_subwindow(
        prev_pc, ref_box, scale=config.bb_scale, offset=config.bb_offset
    )
    this_frame_pc = points_utils.generate_subwindow(
        this_pc, ref_box, scale=config.bb_scale, offset=config.bb_offset
    )
    assert this_frame_pc.nbr_points() > 20, "not enough search points"

    this_box = points_utils.transform_box(this_box, ref_box)
    prev_box = points_utils.transform_box(prev_box, ref_box)
    ref_box = points_utils.transform_box(ref_box, ref_box)
    motion_box = points_utils.transform_box(this_box, prev_box)

    n = config.point_sample_size
    prev_points, _ = points_utils.regularize_pc(prev_frame_pc.points.T, n)
    this_points, _ = points_utils.regularize_pc(this_frame_pc.points.T, n)

    seg_label_this = points_utils.points_in_box(this_box, this_points.T, 1.25).astype(int)
    seg_label_prev = points_utils.points_in_box(prev_box, prev_points.T, 1.25).astype(int)
    seg_mask_prev = points_utils.points_in_box(ref_box, prev_points.T, 1.25).astype(float)
    if candidate_id != 0:
        # soft 0.2/0.8 prior-targetness when the ref box is perturbed
        seg_mask_prev[seg_mask_prev == 0] = 0.2
        seg_mask_prev[seg_mask_prev == 1] = 0.8
    seg_mask_this = np.full(seg_mask_prev.shape, fill_value=0.5)

    timestamp_prev = np.full((n, 1), fill_value=0.0)
    timestamp_this = np.full((n, 1), fill_value=0.1)
    prev_points = np.concatenate([prev_points, timestamp_prev, seg_mask_prev[:, None]], axis=-1)
    this_points = np.concatenate([this_points, timestamp_this, seg_mask_this[:, None]], axis=-1)

    stack_points = np.concatenate([prev_points, this_points], axis=0)
    stack_seg_label = np.hstack([seg_label_prev, seg_label_this])
    box_label = points_utils.box_to_params(this_box, degrees=config.degrees)
    box_label_prev = points_utils.box_to_params(prev_box, degrees=config.degrees)
    motion_label = points_utils.box_to_params(motion_box, degrees=config.degrees)
    motion_state_label = (
        np.sqrt(np.sum((this_box.center - prev_box.center) ** 2)) > config.motion_threshold
    )

    data_dict = {
        "points": stack_points.astype("float32"),
        "box_label": box_label,
        "box_label_prev": box_label_prev,
        "motion_label": motion_label,
        "motion_state_label": np.int32(motion_state_label),
        "bbox_size": this_box.wlh.astype("float32"),
        "seg_label": stack_seg_label.astype("int32"),
    }
    if getattr(config, "box_aware", False):
        prev_bc = points_utils.get_point_to_box_distance(stack_points[:n, :3], prev_box)
        this_bc = points_utils.get_point_to_box_distance(stack_points[n:, :3], this_box)
        candidate_bc_prev = points_utils.get_point_to_box_distance(stack_points[:n, :3], ref_box)
        candidate_bc_this = np.zeros_like(candidate_bc_prev)
        candidate_bc = np.concatenate([candidate_bc_prev, candidate_bc_this], axis=0)
        data_dict.update(
            prev_bc=prev_bc.astype("float32"),
            this_bc=this_bc.astype("float32"),
            candidate_bc=candidate_bc.astype("float32"),
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


class MotionTrackingSampler(PointTrackingSampler):
    """Sequential-only motion sampler; augmentation on both frames
    (sampler.py:262-288)."""

    def __init__(self, dataset, config=None, **kwargs):
        super().__init__(dataset, random_sample=False, config=config, **kwargs)
        self.processing = motion_processing

    def __getitem__(self, index):
        anno_id = self.get_anno_index(index)
        candidate_id = self.get_candidate_index(index)
        try:
            tracklet_id, frame_ids = self._locate(anno_id)
            first_frame, prev_frame, this_frame = self.dataset.get_frames(
                tracklet_id, frame_ids=frame_ids
            )
            data = {
                "first_frame": first_frame,
                "prev_frame": prev_frame,
                "this_frame": this_frame,
                "candidate_id": candidate_id,
            }
            return self.processing(
                data,
                self.config,
                template_transform=self.transform,
                search_transform=self.transform,
            )
        except AssertionError:
            return self[int(np.random.randint(0, len(self)))]
