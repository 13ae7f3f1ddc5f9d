"""BAT eval forward, port of `open3dsot_tpu/models/bat.py` (reference
models/bat.py): P2B's backbone and RPN with BoxCloud features. An `mlp_bc`
head predicts the search BoxCloud from xyz || features, the template
BoxCloud is gathered through the first M/8 FPS indices of the template's SA
layer 1, and `BoxAwareXCorr` fuses template and search. The BoxCloud loss
comes with training.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from open3dsot_tpu_torch.models.layers import MLP, compute_dtype, linear, resolve_device, to_f32
from open3dsot_tpu_torch.models.losses import smooth_l1
from open3dsot_tpu_torch.models.matching_base import (
    MatchingEvalMixin,
    matching_loss,
    matching_total_loss,
)
from open3dsot_tpu_torch.models.pointnet import PointnetBackbone
from open3dsot_tpu_torch.models.rpn import P2BVoteNetRPN
from open3dsot_tpu_torch.ops.chain_fused import BF16, is_bf16
from open3dsot_tpu_torch.models.xcorr import BoxAwareXCorr
from open3dsot_tpu_torch.ops.grouping import gather_points


class BATNet(nn.Module):
    def __init__(self, feature_channel: int = 256, hidden_channel: int = 256,
                 out_channel: int = 256, vote_channel: int = 256, num_proposal: int = 64,
                 k: int = 4, bc_channel: int = 9, use_search_bc: bool = False,
                 use_search_feature: bool = False, use_fps: bool = True,
                 normalize_xyz: bool = False, fused_eval: bool = True, fused_train: bool = True,
                 device=None, dtype=None):
        super().__init__()
        f = feature_channel
        kw = dict(device=device, dtype=dtype)
        self.dtype = BF16 if is_bf16(dtype) else None
        self.backbone = PointnetBackbone(use_fps=use_fps, normalize_xyz=normalize_xyz,
                                         fused_eval=fused_eval, fused_train=fused_train, **kw)
        self.conv_final = nn.Linear(PointnetBackbone.OUT_CHANNELS, f, device=device)
        self.mlp_bc = MLP(3 + f, [f, f, bc_channel], final_plain=True, **kw)
        self.xcorr = BoxAwareXCorr(f, hidden_channel, out_channel, k=k, bc_channel=bc_channel,
                                   use_search_bc=use_search_bc,
                                   use_search_feature=use_search_feature, **kw)
        self.rpn = P2BVoteNetRPN(out_channel, vote_channel, num_proposal,
                                 normalize_xyz=normalize_xyz, fused_eval=fused_eval, **kw)

    def forward(self, template: torch.Tensor, search: torch.Tensor,
                template_bc: torch.Tensor) -> dict:
        """template (B, M, 3), search (B, N, 3), template_bc (B, M, 9)."""
        M, N = template.shape[1], search.shape[1]
        template_xyz, template_feature, sample_idxs_t = self.backbone(
            template, [M // 2, M // 4, M // 8])
        search_xyz, search_feature, sample_idxs = self.backbone(search, [N // 2, N // 4, N // 8])
        template_feature = linear(template_feature, self.conv_final, self.dtype)
        search_feature = linear(search_feature, self.conv_final, self.dtype)
        # BoxCloud targets regress in f32 (JAX bat.py:79)
        pred_search_bc = to_f32(self.mlp_bc(torch.cat([search_xyz, search_feature], dim=-1)))
        template_bc = gather_points(template_bc, sample_idxs_t[:, : M // 8])
        fusion_feature = self.xcorr(template_feature, search_feature, template_xyz, search_xyz,
                                    template_bc, pred_search_bc)
        estimation_boxes, estimation_cla, vote_xyz, center_xyzs = self.rpn(search_xyz,
                                                                           fusion_feature)
        return {
            "estimation_boxes": estimation_boxes,
            "estimation_cla": estimation_cla,
            "vote_xyz": vote_xyz,
            "center_xyz": center_xyzs,
            "sample_idxs": sample_idxs,
            "pred_search_bc": pred_search_bc,
        }


class BATModel(MatchingEvalMixin):
    """The net on `device` (the card unless the caller asks for the CPU) and
    the matching input building, with the template BoxCloud channel
    (reference bat.py:41-55). `fused_eval`: K3/K4 in eval; `fused_train`:
    K6 in training (FPS stays K3 with `fused_eval`). `bf16: true` computes the
    eval forward in bf16 (K4 in its bf16 mode); training then is refused."""

    name = "bat"
    input_keys = ("template_points", "search_points", "points2cc_dist_t")

    def __init__(self, config, device="cuda", fused_eval: bool = True, fused_train: bool = True):
        self.config = config
        self.device = resolve_device(device)
        self.net = BATNet(
            feature_channel=config.feature_channel,
            hidden_channel=config.hidden_channel,
            out_channel=config.out_channel,
            vote_channel=config.vote_channel,
            num_proposal=config.num_proposal,
            k=getattr(config, "k", 4),
            bc_channel=getattr(config, "bc_channel", 9),
            use_search_bc=getattr(config, "use_search_bc", False),
            use_search_feature=getattr(config, "use_search_feature", False),
            use_fps=getattr(config, "use_fps", True),
            normalize_xyz=getattr(config, "normalize_xyz", False),
            fused_eval=fused_eval,
            fused_train=fused_train,
            device=self.device,
            dtype=compute_dtype(config),
        ).eval()

    def dummy_batch(self, batch_size: int = 2) -> dict:
        batch = super().dummy_batch(batch_size)
        bc = getattr(self.config, "bc_channel", 9)
        for key, n in (("points2cc_dist_t", self.config.template_size),
                       ("points2cc_dist_s", self.config.search_size)):
            batch[key] = np.zeros((batch_size, n, bc), np.float32)
        return batch

    def loss(self, batch: dict, output: dict) -> dict:
        """Loss terms and `loss_total` of a `device_batch` and its training
        forward: seg labels and the search BoxCloud gathered through the
        backbone's sample indices (bat.py:130-136)."""
        idx = output["sample_idxs"][:, :output["estimation_cla"].shape[1]].long()
        seg_label = torch.gather(batch["seg_label"], 1, idx)
        loss_dict = matching_loss(self.config, dict(batch, seg_label=seg_label), output)
        loss_bc = smooth_l1(output["pred_search_bc"], gather_points(batch["points2cc_dist_s"], idx))
        loss_dict["loss_bc"] = (loss_bc.mean(dim=2) * seg_label).sum() / (seg_label.sum() + 1e-6)
        loss_dict["loss_total"] = matching_total_loss(self.config, loss_dict)
        return loss_dict

    def prepare_input(self, template_pc, search_pc, template_box):
        from open3dsot_tpu_torch.geometry import points_utils

        config = self.config
        template_points, _ = points_utils.regularize_pc(
            template_pc.points.T, config.template_size, seed=1
        )
        search_points, _ = points_utils.regularize_pc(
            search_pc.points.T, config.search_size, seed=1
        )
        # from the points before their f32 cast, as the reference
        template_bc = points_utils.get_point_to_box_distance(template_points, template_box)
        return {
            "template_points": template_points[None].astype(np.float32),
            "search_points": search_points[None].astype(np.float32),
            "points2cc_dist_t": template_bc[None].astype(np.float32),
        }
