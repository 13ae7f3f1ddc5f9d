"""Eval-time input building of the matching trackers (P2B, BAT), port of
`open3dsot_tpu/models/matching_base.py::MatchingEvalMixin` (reference
base_model.py:166-247): the template from the shape_aggregation mode, the
search area around the reference_BB box, seeded regularize_pc, and the
argmax-objectness proposal as the output box. The matching loss comes with
training (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch


class MatchingEvalMixin:
    """Host input building (numpy, per frame) and the device forward of a
    matching model; the class sets `self.net`, `self.config`, `self.device`
    and `input_keys`, the batch keys the net takes in order."""

    input_keys = ("template_points", "search_points")

    def apply(self, batch: dict) -> dict:
        """Eval forward on a batch of numpy arrays or tensors; outputs stay on the device."""
        with torch.no_grad():
            return self.net(*(torch.as_tensor(batch[k], dtype=torch.float32).to(self.device)
                              for k in self.input_keys))

    def dummy_batch(self, batch_size: int = 2) -> dict:
        m, n = self.config.template_size, self.config.search_size
        return {"template_points": np.zeros((batch_size, m, 3), np.float32),
                "search_points": np.zeros((batch_size, n, 3), np.float32)}

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
