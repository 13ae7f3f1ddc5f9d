"""M2-Track, port of `open3dsot_tpu/models/m2track.py` (M2TrackNet
:31-142, m2track_loss :145-243, M2TrackModel :245-362).

A two-frame stacked point cloud (xyz | timestamp | prior-targetness, plus
the BoxCloud when box_aware) runs through SegPointNet; the foreground
points are embedded by a MiniPointNet; MLP heads regress the 4-DoF motion
(gated by the static/dynamic classifier) and a refined previous box; stage
2 moves the t0 points by the motion, canonicalizes around the stage-1 box
and regresses a residual. `m2track_loss` is the weighted multi-task loss
with the train-time accuracies (`acc_*`). In training (`apply_train`) the
encoders run the plain layers with training BatchNorm: K1/K2 are eval-only,
in JAX too.

`dtype=torch.bfloat16` (config `bf16: true`) computes the encoders and heads
in bf16 (K1/K2 in their bf16 mode in eval), with the f32 casts where JAX has
them: the seg output, the motion / state / box heads; the rigid box math and
the loss stay f32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from open3dsot_tpu_torch.geometry import rigid
from open3dsot_tpu_torch.models.layers import MLP, compute_dtype, resolve_device, to_f32
from open3dsot_tpu_torch.models.losses import cross_entropy_logits, smooth_l1
from open3dsot_tpu_torch.models.pointnet import MiniPointNet, SegPointNet


class M2TrackNet(nn.Module):
    def __init__(self, box_aware: bool = False, use_motion_cls: bool = True,
                 use_second_stage: bool = True, use_prev_refinement: bool = True,
                 fused_eval: bool = True, device=None, dtype=None):
        super().__init__()
        self.box_aware = box_aware
        self.use_motion_cls = use_motion_cls
        self.use_second_stage = use_second_stage
        self.use_prev_refinement = use_prev_refinement
        bc = 9 if box_aware else 0
        kw = dict(device=device, dtype=dtype)
        self.seg_pointnet = SegPointNet(5 + bc, [64, 64, 64, 128, 1024], [512, 256, 128, 128],
                                        2 + bc, fused_eval=fused_eval, **kw)
        self.mini_pointnet = MiniPointNet(4 + bc, [64, 128, 256, 512], [512, 256],
                                          fused_eval=fused_eval, **kw)
        self.motion_mlp = MLP(256, [128, 128, 4], final_plain=True, **kw)
        if use_motion_cls:
            self.motion_state_mlp = MLP(256, [128, 128, 2], final_plain=True, **kw)
        if use_prev_refinement:
            self.final_mlp = MLP(256, [128, 128, 4], final_plain=True, **kw)
        if use_second_stage:
            self.mini_pointnet2 = MiniPointNet(3 + bc, [64, 128, 256, 512], [512, 256],
                                               fused_eval=fused_eval, **kw)
            self.box_mlp = MLP(256, [128, 128, 4], final_plain=True, **kw)

    def forward(self, points: torch.Tensor,
                candidate_bc: Optional[torch.Tensor] = None) -> dict:
        """points (B, N, 5); N = 2 frames stacked (t0 first half). candidate_bc (B, N, 9)."""
        x = points
        if self.box_aware:
            x = torch.cat([x, candidate_bc], dim=-1)
        N = x.shape[1]

        output = {}
        seg_out = to_f32(self.seg_pointnet(x))
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
        # heads regress boxes and logits: back to f32 for the rigid math
        motion_pred = to_f32(self.motion_mlp(point_feature))
        if self.use_motion_cls:
            motion_state_logits = to_f32(self.motion_state_mlp(point_feature))
            motion_mask = torch.argmax(motion_state_logits, dim=-1, keepdim=True).to(motion_pred.dtype)
            motion_pred_masked = motion_pred * motion_mask
            output["motion_cls"] = motion_state_logits
        else:
            motion_pred_masked = motion_pred

        if self.use_prev_refinement:
            prev_boxes = to_f32(self.final_mlp(point_feature))
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
            output_offset = to_f32(self.box_mlp(stage2_feat))
            output["estimation_boxes"] = rigid.get_offset_box(aux_box, output_offset)
        else:
            output["estimation_boxes"] = aux_box

        output.update(seg_logits=seg_logits, motion_pred=motion_pred, aux_estimation_boxes=aux_box)
        return output


def m2track_loss(config, batch: dict, output: dict) -> dict:
    """Weighted multi-task loss (reference m2track.py:153-231) -> the terms,
    the accuracies `acc_*` (per true class, torchmetrics Accuracy(average=
    'none'), reference m2track.py:250-258) and `loss_total`."""
    loss_total = 0.0
    loss_dict = {}
    aux_boxes = output["aux_estimation_boxes"]  # (B, 4)
    motion_pred = output["motion_pred"]  # (B, 4)
    seg_logits = output["seg_logits"]  # (B, N, 2)

    seg_label = batch["seg_label"].long()  # (B, N)
    box_label = batch["box_label"]  # (B, 4)
    box_label_prev = batch["box_label_prev"]
    motion_label = batch["motion_label"]
    motion_state_label = batch["motion_state_label"].float()  # (B,), f32 as JAX casts it
    center_label = box_label[:, :3]
    angle_label = torch.sin(box_label[:, 3])
    center_label_prev = box_label_prev[:, :3]
    angle_label_prev = torch.sin(box_label_prev[:, 3])
    center_label_motion = motion_label[:, :3]
    angle_label_motion = torch.sin(motion_label[:, 3])

    loss_seg = cross_entropy_logits(seg_logits, seg_label, weight=[0.5, 2.0])

    use_motion_cls = getattr(config, "use_motion_cls", True)
    if use_motion_cls:
        motion_cls = output["motion_cls"]  # (B, 2)
        loss_motion_cls = cross_entropy_logits(motion_cls, motion_state_label.long())
        loss_total += loss_motion_cls * config.motion_cls_seg_weight
        loss_dict["loss_motion_cls"] = loss_motion_cls

        denom = motion_state_label.sum() + 1e-6
        lcm = smooth_l1(motion_pred[:, :3], center_label_motion).mean(dim=1)
        loss_center_motion = (motion_state_label * lcm).sum() / denom
        lam = smooth_l1(torch.sin(motion_pred[:, 3]), angle_label_motion)
        loss_angle_motion = (motion_state_label * lam).sum() / denom
    else:
        loss_center_motion = smooth_l1(motion_pred[:, :3], center_label_motion).mean()
        loss_angle_motion = smooth_l1(torch.sin(motion_pred[:, 3]), angle_label_motion).mean()

    if getattr(config, "use_second_stage", True):
        est_boxes = output["estimation_boxes"]
        loss_center = smooth_l1(est_boxes[:, :3], center_label).mean()
        loss_angle = smooth_l1(torch.sin(est_boxes[:, 3]), angle_label).mean()
        loss_total += loss_center * config.center_weight + loss_angle * config.angle_weight
        loss_dict["loss_center"] = loss_center
        loss_dict["loss_angle"] = loss_angle

    if getattr(config, "use_prev_refinement", True):
        est_prev = output["estimation_boxes_prev"]
        loss_center_prev = smooth_l1(est_prev[:, :3], center_label_prev).mean()
        loss_angle_prev = smooth_l1(torch.sin(est_prev[:, 3]), angle_label_prev).mean()
        loss_total += (loss_center_prev * config.center_weight
                       + loss_angle_prev * config.angle_weight)
        loss_dict["loss_center_prev"] = loss_center_prev
        loss_dict["loss_angle_prev"] = loss_angle_prev

    loss_center_aux = smooth_l1(aux_boxes[:, :3], center_label).mean()
    loss_angle_aux = smooth_l1(torch.sin(aux_boxes[:, 3]), angle_label).mean()

    loss_total += (loss_seg * config.seg_weight
                   + loss_center_aux * config.center_weight
                   + loss_angle_aux * config.angle_weight
                   + loss_center_motion * config.center_weight
                   + loss_angle_motion * config.angle_weight)
    loss_dict.update(loss_seg=loss_seg, loss_center_aux=loss_center_aux,
                     loss_center_motion=loss_center_motion, loss_angle_aux=loss_angle_aux,
                     loss_angle_motion=loss_angle_motion)
    if getattr(config, "box_aware", False):
        bc_label = torch.cat([batch["prev_bc"], batch["this_bc"]], dim=1)
        loss_bc = smooth_l1(output["pred_bc"], bc_label).mean()
        loss_total += loss_bc * config.bc_weight
        loss_dict["loss_bc"] = loss_bc

    with torch.no_grad():
        pred_seg = seg_logits.argmax(dim=-1)
        for c, name in ((0, "acc_seg_background"), (1, "acc_seg_foreground")):
            m = (seg_label == c).float()  # f32, as JAX casts the masks
            loss_dict[name] = ((pred_seg == c) * m).sum() / (m.sum() + 1e-6)
        if use_motion_cls:
            pred_motion = output["motion_cls"].argmax(dim=-1)
            lbl = motion_state_label.long()
            for c, name in ((0, "acc_motion_static"), (1, "acc_motion_dynamic")):
                m = (lbl == c).float()
                loss_dict[name] = ((pred_motion == c) * m).sum() / (m.sum() + 1e-6)

    loss_dict["loss_total"] = loss_total
    return loss_dict


class M2TrackModel:
    """Orchestration wrapper: the net on `device` (eval mode; the card unless
    the caller asks for the CPU), its training forward and loss
    (`apply_train`, `loss`), plus the host input building of the eval loop
    (reference base_model.py:255-303). `bf16: true` computes in bf16
    (m2track.py:266); parameters and statistics stay f32."""

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
            dtype=compute_dtype(config),
        ).eval()

    def dummy_batch(self, batch_size: int = 2) -> dict:
        """A zero batch with the inputs and the training labels."""
        n = self.config.point_sample_size
        batch = {"points": np.zeros((batch_size, 2 * n, 5), np.float32),
                 "seg_label": np.zeros((batch_size, 2 * n), np.int32),
                 "box_label": np.zeros((batch_size, 4), np.float32),
                 "box_label_prev": np.zeros((batch_size, 4), np.float32),
                 "motion_label": np.zeros((batch_size, 4), np.float32),
                 "motion_state_label": np.zeros((batch_size,), np.int32)}
        if getattr(self.config, "box_aware", False):
            batch["candidate_bc"] = np.zeros((batch_size, 2 * n, 9), np.float32)
            batch["prev_bc"] = np.zeros((batch_size, n, 9), np.float32)
            batch["this_bc"] = np.zeros((batch_size, n, 9), np.float32)
        return batch

    def device_batch(self, batch: dict) -> dict:
        """A batch of numpy arrays or tensors on the device: floats as
        float32, the labels of integer type as int64."""
        def dev(v):
            v = torch.as_tensor(v)
            dtype = torch.float32 if v.is_floating_point() else torch.int64
            return v.to(device=self.device, dtype=dtype)

        return {k: dev(v) for k, v in batch.items()}

    def apply_train(self, batch: dict) -> dict:
        """Training forward (batch statistics, running statistics updated,
        autograd on) on a `device_batch`; outputs f32 (float64 for a net in
        double) for the loss."""
        self.net.train()
        return self.net(batch["points"], batch["candidate_bc"] if self.net.box_aware else None)

    def loss(self, batch: dict, output: dict) -> dict:
        return m2track_loss(self.config, batch, output)

    def scan_tracker(self, config, **kw):
        """The batched on-device tracker of this model (tracking/scan_tracker.py)."""
        from open3dsot_tpu_torch.tracking.scan_tracker import M2ScanTracker

        return M2ScanTracker(self, config, **kw)

    def evaluate_scan(self, test_sampler, config, **kw):
        """(success, precision) on `test_sampler` through `scan_tracker`;
        keywords as tracking/scan_tracker.py::evaluate_dataset_scan's."""
        from open3dsot_tpu_torch.tracking.scan_tracker import evaluate_dataset_scan

        return evaluate_dataset_scan(self, test_sampler, config, **kw)

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
