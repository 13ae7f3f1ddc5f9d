"""Shared logic of the matching trackers (P2B, BAT), port of
`open3dsot_tpu/models/matching_base.py` (reference base_model.py:120-247):
the four-term matching loss and, in `MatchingEvalMixin`, the eval-time
input building (the template from the shape_aggregation mode, the search
area around the reference_BB box, seeded regularize_pc, the
argmax-objectness proposal as the output box) and the forwards on the
device, eval and training.
"""

from __future__ import annotations

import numpy as np
import torch

from open3dsot_tpu_torch.models.losses import bce_with_logits, smooth_l1


def matching_loss(config, batch: dict, output: dict) -> dict:
    """Reference base_model.py:122-164; `batch["seg_label"]` already gathered
    through the backbone's sample indices (the model's `loss` does it)."""
    estimation_boxes = output["estimation_boxes"]  # (B, P, 5)
    seg_label = batch["seg_label"]  # (B, N) float
    box_label = batch["box_label"]  # (B, 4)
    vote_xyz = output["vote_xyz"]  # (B, N, 3)

    loss_seg = bce_with_logits(output["estimation_cla"], seg_label)
    loss_vote = smooth_l1(vote_xyz, box_label[:, None, :3].expand_as(vote_xyz))
    loss_vote = (loss_vote.mean(dim=2) * seg_label).sum() / (seg_label.sum() + 1e-6)

    dist = ((output["center_xyz"] - box_label[:, None, :3]) ** 2).sum(dim=-1)
    dist = torch.sqrt(dist + 1e-6)  # (B, P)
    objectness_label = (dist < 0.3).to(dist.dtype)
    objectness_mask = ((dist < 0.3) | (dist > 0.6)).to(dist.dtype)
    # the reference's quirk, kept (base_model.py:150-153): the BCE is the
    # default 'mean' reduction, a scalar, so the mask only scales it by
    # sum(mask) / (sum(mask) + 1e-6); the 0.3-0.6 band is not excluded
    loss_objective = bce_with_logits(estimation_boxes[:, :, 4], objectness_label, pos_weight=2.0)
    loss_objective = loss_objective * objectness_mask.sum() / (objectness_mask.sum() + 1e-6)
    boxes = estimation_boxes[:, :, :4]
    loss_box = smooth_l1(boxes, box_label[:, None, :4].expand_as(boxes))
    loss_box = (loss_box.mean(dim=2) * objectness_label).sum() / (objectness_label.sum() + 1e-6)
    return {"loss_objective": loss_objective, "loss_box": loss_box, "loss_seg": loss_seg,
            "loss_vote": loss_vote}


def matching_total_loss(config, loss_dict: dict) -> torch.Tensor:
    """Weighted sum (p2b.py:81-84 / bat.py:139-143)."""
    total = (loss_dict["loss_objective"] * config.objectiveness_weight
             + loss_dict["loss_box"] * config.box_weight
             + loss_dict["loss_seg"] * config.seg_weight
             + loss_dict["loss_vote"] * config.vote_weight)
    if "loss_bc" in loss_dict:
        total = total + loss_dict["loss_bc"] * config.bc_weight
    return total


class MatchingEvalMixin:
    """Host input building (numpy, per frame) and the device forwards of a
    matching model; the class sets `self.net`, `self.config`, `self.device`
    and `input_keys`, the batch keys the net takes in order."""

    input_keys = ("template_points", "search_points")

    def device_batch(self, batch: dict) -> dict:
        """A batch of numpy arrays or tensors as float32 tensors on the device."""
        return {k: torch.as_tensor(v, dtype=torch.float32).to(self.device)
                for k, v in batch.items()}

    def apply(self, batch: dict) -> dict:
        """Eval forward on a batch of numpy arrays or tensors; outputs stay on the device."""
        self.net.eval()
        with torch.no_grad():
            return self.net(*(torch.as_tensor(batch[k], dtype=torch.float32).to(self.device)
                              for k in self.input_keys))

    def apply_train(self, batch: dict) -> dict:
        """Training forward (batch statistics, running statistics updated,
        autograd on) on a `device_batch`; outputs stay on the device, f32 for
        the loss in the bf16 mode too (JAX tests/test_bf16.py:42-53)."""
        self.net.train()
        return self.net(*(batch[k] for k in self.input_keys))

    def scan_tracker(self, config, **kw):
        """The batched on-device tracker of this model (tracking/scan_matching.py)."""
        from open3dsot_tpu_torch.tracking.scan_matching import MatchScanTracker

        return MatchScanTracker(self, config, **kw)

    def evaluate_scan(self, test_sampler, config, **kw):
        """(success, precision) on `test_sampler` through `scan_tracker`; keywords
        as tracking/scan_matching.py::evaluate_dataset_scan_matching's."""
        from open3dsot_tpu_torch.tracking.scan_matching import evaluate_dataset_scan_matching

        return evaluate_dataset_scan_matching(self, test_sampler, config, **kw)

    def dummy_batch(self, batch_size: int = 2) -> dict:
        """A zero batch with the inputs and the training labels."""
        m, n = self.config.template_size, self.config.search_size
        return {"template_points": np.zeros((batch_size, m, 3), np.float32),
                "search_points": np.zeros((batch_size, n, 3), np.float32),
                "box_label": np.zeros((batch_size, 4), np.float32),
                "seg_label": np.zeros((batch_size, n), np.float32)}

    def generate_template(self, sequence, current_frame_id, results_bbs):
        from open3dsot_tpu_torch.geometry import points_utils

        config = self.config
        first_pc = sequence[0]["pc"]
        previous_pc = sequence[current_frame_id - 1]["pc"]
        agg = config.shape_aggregation.upper()
        if "FIRSTANDPREVIOUS" in agg:
            return points_utils.getModel(
                [first_pc, previous_pc],
                [results_bbs[0], results_bbs[current_frame_id - 1]],
                scale=config.model_bb_scale,
                offset=config.model_bb_offset,
            )
        if "FIRST" in agg:
            return points_utils.cropAndCenterPC(
                first_pc, results_bbs[0],
                scale=config.model_bb_scale, offset=config.model_bb_offset,
            )
        if "PREVIOUS" in agg:
            return points_utils.cropAndCenterPC(
                previous_pc, results_bbs[current_frame_id - 1],
                scale=config.model_bb_scale, offset=config.model_bb_offset,
            )
        if "ALL" in agg:
            return points_utils.getModel(
                [frame["pc"] for frame in sequence[:current_frame_id]],
                results_bbs,
                scale=config.model_bb_scale,
                offset=config.model_bb_offset,
            )
        raise ValueError(config.shape_aggregation)

    def generate_search_area(self, sequence, current_frame_id, results_bbs):
        from open3dsot_tpu_torch.geometry import points_utils

        config = self.config
        this_bb = sequence[current_frame_id]["3d_bbox"]
        this_pc = sequence[current_frame_id]["pc"]
        ref = config.reference_BB.upper()
        if "PREVIOUS_RESULT" in ref:
            ref_bb = results_bbs[-1]
        elif "PREVIOUS_GT" in ref:
            ref_bb = sequence[current_frame_id - 1]["3d_bbox"]
        elif "CURRENT_GT" in ref:
            ref_bb = this_bb
        else:
            raise ValueError(config.reference_BB)
        search_pc_crop = points_utils.generate_subwindow(
            this_pc, ref_bb,
            scale=config.search_bb_scale, offset=config.search_bb_offset,
        )
        return search_pc_crop, ref_bb

    def prepare_input(self, template_pc, search_pc, template_box):
        from open3dsot_tpu_torch.geometry import points_utils

        config = self.config
        template_points, _ = points_utils.regularize_pc(
            template_pc.points.T, config.template_size, seed=1
        )
        search_points, _ = points_utils.regularize_pc(
            search_pc.points.T, config.search_size, seed=1
        )
        return {
            "template_points": template_points[None].astype(np.float32),
            "search_points": search_points[None].astype(np.float32),
        }

    def build_input_dict(self, sequence, frame_id, results_bbs):
        search_pc_crop, ref_bb = self.generate_search_area(sequence, frame_id, results_bbs)
        template_pc, canonical_box = self.generate_template(sequence, frame_id, results_bbs)
        data_dict = self.prepare_input(template_pc, search_pc_crop, canonical_box)
        return data_dict, ref_bb

    def extract_output_box(self, output, ref_box):
        """argmax-objectness proposal -> world box (base_model.py:44-57)."""
        from open3dsot_tpu_torch.geometry import points_utils

        boxes = output["estimation_boxes"][0].cpu().numpy()  # (P, 5)
        best = int(np.argmax(boxes[:, 4]))
        return points_utils.getOffsetBB(
            ref_box,
            boxes[best, 0:4],
            degrees=self.config.degrees,
            use_z=self.config.use_z,
            limit_box=self.config.limit_box,
        )
