"""M2-Track eval forward, port of `open3dsot_tpu/models/m2track.py`
(M2TrackNet :31-142, M2TrackModel :245-362).

A two-frame stacked point cloud (xyz | timestamp | prior-targetness, plus
the BoxCloud when box_aware) runs through SegPointNet; the foreground
points are embedded by a MiniPointNet; MLP heads regress the 4-DoF motion
(gated by the static/dynamic classifier) and a refined previous box; stage
2 moves the t0 points by the motion, canonicalizes around the stage-1 box
and regresses a residual. The loss (m2track_loss) comes with training.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from open3dsot_tpu_torch.geometry import rigid
from open3dsot_tpu_torch.models.layers import MLP, resolve_device
from open3dsot_tpu_torch.models.pointnet import MiniPointNet, SegPointNet


class M2TrackNet(nn.Module):
    def __init__(self, box_aware: bool = False, use_motion_cls: bool = True,
                 use_second_stage: bool = True, use_prev_refinement: bool = True,
                 fused_eval: bool = True, device=None):
        super().__init__()
        self.box_aware = box_aware
        self.use_motion_cls = use_motion_cls
        self.use_second_stage = use_second_stage
        self.use_prev_refinement = use_prev_refinement
        bc = 9 if box_aware else 0
        self.seg_pointnet = SegPointNet(5 + bc, [64, 64, 64, 128, 1024], [512, 256, 128, 128],
                                        2 + bc, fused_eval=fused_eval, device=device)
        self.mini_pointnet = MiniPointNet(4 + bc, [64, 128, 256, 512], [512, 256],
                                          fused_eval=fused_eval, device=device)
        self.motion_mlp = MLP(256, [128, 128, 4], final_plain=True, device=device)
        if use_motion_cls:
            self.motion_state_mlp = MLP(256, [128, 128, 2], final_plain=True, device=device)
        if use_prev_refinement:
            self.final_mlp = MLP(256, [128, 128, 4], final_plain=True, device=device)
        if use_second_stage:
            self.mini_pointnet2 = MiniPointNet(3 + bc, [64, 128, 256, 512], [512, 256],
                                               fused_eval=fused_eval, device=device)
            self.box_mlp = MLP(256, [128, 128, 4], final_plain=True, device=device)

    def forward(self, points: torch.Tensor,
                candidate_bc: Optional[torch.Tensor] = None) -> dict:
        """points (B, N, 5); N = 2 frames stacked (t0 first half). candidate_bc (B, N, 9)."""
        x = points
        if self.box_aware:
            x = torch.cat([x, candidate_bc], dim=-1)
        N = x.shape[1]

        output = {}
        seg_out = self.seg_pointnet(x)
        seg_logits = seg_out[..., :2]
        pred_cls = torch.argmax(seg_logits, dim=-1, keepdim=True).to(x.dtype)
        mask_points = x[..., :4] * pred_cls
        mask_xyz_t0 = mask_points[:, : N // 2, :3]
        mask_xyz_t1 = mask_points[:, N // 2:, :3]
        if self.box_aware:
            pred_bc = seg_out[..., 2:]
            mask_pred_bc = pred_bc * pred_cls
            mask_points = torch.cat([mask_points, mask_pred_bc], dim=-1)
            output["pred_bc"] = pred_bc

        point_feature = self.mini_pointnet(mask_points)
        motion_pred = self.motion_mlp(point_feature)
        if self.use_motion_cls:
            motion_state_logits = self.motion_state_mlp(point_feature)
            motion_mask = torch.argmax(motion_state_logits, dim=-1, keepdim=True).to(motion_pred.dtype)
            motion_pred_masked = motion_pred * motion_mask
            output["motion_cls"] = motion_state_logits
        else:
            motion_pred_masked = motion_pred

        if self.use_prev_refinement:
            prev_boxes = self.final_mlp(point_feature)
            output["estimation_boxes_prev"] = prev_boxes
        else:
            prev_boxes = torch.zeros_like(motion_pred)

        aux_box = rigid.get_offset_box(prev_boxes, motion_pred_masked)

        if self.use_second_stage:
            mask_xyz_t0_2_t1 = rigid.get_offset_points(mask_xyz_t0, prev_boxes[:, :4],
                                                       motion_pred_masked)
            mask_xyz_t01 = torch.cat([mask_xyz_t0_2_t1, mask_xyz_t1], dim=1)
            mask_xyz_t01 = rigid.remove_transform_points(mask_xyz_t01, aux_box)
            if self.box_aware:
                mask_xyz_t01 = torch.cat([mask_xyz_t01, mask_pred_bc], dim=-1)
            stage2_feat = self.mini_pointnet2(mask_xyz_t01)
            output_offset = self.box_mlp(stage2_feat)
            output["estimation_boxes"] = rigid.get_offset_box(aux_box, output_offset)
        else:
            output["estimation_boxes"] = aux_box

        output.update(seg_logits=seg_logits, motion_pred=motion_pred, aux_estimation_boxes=aux_box)
        return output


class M2TrackModel:
    """Orchestration wrapper: the net on `device` (eval mode; the card unless
    the caller asks for the CPU) plus the host input building of the eval
    loop (reference base_model.py:255-303)."""

    name = "m2track"

    def __init__(self, config, device="cuda", fused_eval: bool = True):
        self.config = config
        self.device = resolve_device(device)
        self.net = M2TrackNet(
            box_aware=getattr(config, "box_aware", False),
            use_motion_cls=getattr(config, "use_motion_cls", True),
            use_second_stage=getattr(config, "use_second_stage", True),
            use_prev_refinement=getattr(config, "use_prev_refinement", True),
            fused_eval=fused_eval,
            device=self.device,
        ).eval()

    def dummy_batch(self, batch_size: int = 2) -> dict:
        n = self.config.point_sample_size
        batch = {"points": np.zeros((batch_size, 2 * n, 5), np.float32)}
        if getattr(self.config, "box_aware", False):
            batch["candidate_bc"] = np.zeros((batch_size, 2 * n, 9), np.float32)
        return batch

    def apply(self, batch: dict) -> dict:
        """Eval forward on a batch of numpy arrays or tensors; outputs stay on the device."""
        def dev(a):
            return torch.as_tensor(a, dtype=torch.float32).to(self.device)

        with torch.no_grad():
            bc = dev(batch["candidate_bc"]) if self.net.box_aware else None
            return self.net(dev(batch["points"]), bc)

    # --- eval-time input building (host, per frame) -----------------------
    def build_input_dict(self, sequence, frame_id, results_bbs):
        from open3dsot_tpu_torch.geometry import points_utils

        assert frame_id > 0, "no need to construct an input_dict at frame 0"
        config = self.config
        prev_pc = sequence[frame_id - 1]["pc"]
        this_pc = sequence[frame_id]["pc"]
        ref_box = results_bbs[-1]
        prev_frame_pc = points_utils.generate_subwindow(
            prev_pc, ref_box, scale=config.bb_scale, offset=config.bb_offset
        )
        this_frame_pc = points_utils.generate_subwindow(
            this_pc, ref_box, scale=config.bb_scale, offset=config.bb_offset
        )
        canonical_box = points_utils.transform_box(ref_box, ref_box)
        n = config.point_sample_size
        prev_points, _ = points_utils.regularize_pc(prev_frame_pc.points.T, n, seed=1)
        this_points, _ = points_utils.regularize_pc(this_frame_pc.points.T, n, seed=1)

        seg_mask_prev = points_utils.points_in_box(
            canonical_box, prev_points.T, 1.25
        ).astype(np.float64)
        if frame_id != 1:
            # soft prior-targetness after frame 1 (ref box is a prediction)
            seg_mask_prev[seg_mask_prev == 0] = 0.2
            seg_mask_prev[seg_mask_prev == 1] = 0.8
        seg_mask_this = np.full(seg_mask_prev.shape, fill_value=0.5)

        timestamp_prev = np.full((n, 1), fill_value=0.0)
        timestamp_this = np.full((n, 1), fill_value=0.1)
        prev_points = np.concatenate([prev_points, timestamp_prev, seg_mask_prev[:, None]], axis=-1)
        this_points = np.concatenate([this_points, timestamp_this, seg_mask_this[:, None]], axis=-1)
        stack_points = np.concatenate([prev_points, this_points], axis=0)

        data_dict = {"points": stack_points[None].astype(np.float32)}
        if getattr(config, "box_aware", False):
            candidate_bc_prev = points_utils.get_point_to_box_distance(
                stack_points[:n, :3], canonical_box
            )
            candidate_bc_this = np.zeros_like(candidate_bc_prev)
            candidate_bc = np.concatenate([candidate_bc_prev, candidate_bc_this], axis=0)
            data_dict["candidate_bc"] = candidate_bc[None].astype(np.float32)
        return data_dict, results_bbs[-1]

    def extract_output_box(self, output, ref_box):
        """Predicted 4-DoF box (device) -> world Box via getOffsetBB."""
        from open3dsot_tpu_torch.geometry import points_utils

        estimation_box = output["estimation_boxes"][0].cpu().numpy()  # (4,)
        return points_utils.getOffsetBB(
            ref_box,
            estimation_box[:4],
            degrees=self.config.degrees,
            use_z=self.config.use_z,
            limit_box=self.config.limit_box,
        )
