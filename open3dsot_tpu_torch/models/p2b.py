"""P2B, port of `open3dsot_tpu/models/p2b.py` (reference models/p2b.py): a
shared PointNet++ backbone over the template (M points) and the search area
(N points) with npoint [X/2, X/4, X/8], a final Dense projection, dense
cosine xcorr, and the VoteNet proposal head; the matching loss with the seg
labels gathered through the backbone's sample indices (p2b.py:75-78).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from open3dsot_tpu_torch.models.layers import resolve_device
from open3dsot_tpu_torch.models.matching_base import (
    MatchingEvalMixin,
    matching_loss,
    matching_total_loss,
    refuse_bf16,
)
from open3dsot_tpu_torch.models.pointnet import PointnetBackbone
from open3dsot_tpu_torch.models.rpn import P2BVoteNetRPN
from open3dsot_tpu_torch.models.xcorr import P2BXCorr


class P2BNet(nn.Module):
    def __init__(self, feature_channel: int = 256, hidden_channel: int = 256,
                 out_channel: int = 256, vote_channel: int = 256, num_proposal: int = 64,
                 use_fps: bool = False, normalize_xyz: bool = False, fused_eval: bool = True,
                 fused_train: bool = True, device=None):
        super().__init__()
        self.backbone = PointnetBackbone(use_fps=use_fps, normalize_xyz=normalize_xyz,
                                         fused_eval=fused_eval, fused_train=fused_train,
                                         device=device)
        self.conv_final = nn.Linear(PointnetBackbone.OUT_CHANNELS, feature_channel, device=device)
        self.xcorr = P2BXCorr(feature_channel, hidden_channel, out_channel, device=device)
        self.rpn = P2BVoteNetRPN(out_channel, vote_channel, num_proposal,
                                 normalize_xyz=normalize_xyz, fused_eval=fused_eval,
                                 device=device)

    def forward(self, template: torch.Tensor, search: torch.Tensor) -> dict:
        """template (B, M, 3), search (B, N, 3)."""
        M, N = template.shape[1], search.shape[1]
        template_xyz, template_feature, _ = self.backbone(template, [M // 2, M // 4, M // 8])
        search_xyz, search_feature, sample_idxs = self.backbone(search, [N // 2, N // 4, N // 8])
        template_feature = self.conv_final(template_feature)
        search_feature = self.conv_final(search_feature)
        fusion_feature = self.xcorr(template_feature, search_feature, template_xyz)
        estimation_boxes, estimation_cla, vote_xyz, center_xyzs = self.rpn(search_xyz,
                                                                           fusion_feature)
        return {
            "estimation_boxes": estimation_boxes,
            "estimation_cla": estimation_cla,
            "vote_xyz": vote_xyz,
            "center_xyz": center_xyzs,
            "sample_idxs": sample_idxs,
        }


class P2BModel(MatchingEvalMixin):
    """The net on `device` (the card unless the caller asks for the CPU) and
    the matching input building; `fused_eval` and `fused_train` as BATModel's."""

    name = "p2b"

    def __init__(self, config, device="cuda", fused_eval: bool = True, fused_train: bool = True):
        refuse_bf16(config)
        self.config = config
        self.device = resolve_device(device)
        self.net = P2BNet(
            feature_channel=config.feature_channel,
            hidden_channel=config.hidden_channel,
            out_channel=config.out_channel,
            vote_channel=config.vote_channel,
            num_proposal=config.num_proposal,
            use_fps=getattr(config, "use_fps", False),
            normalize_xyz=getattr(config, "normalize_xyz", False),
            fused_eval=fused_eval,
            fused_train=fused_train,
            device=self.device,
        ).eval()

    def loss(self, batch: dict, output: dict) -> dict:
        """Loss terms and `loss_total` of a `device_batch` and its training forward."""
        idx = output["sample_idxs"][:, :output["estimation_cla"].shape[1]].long()
        seg_label = torch.gather(batch["seg_label"], 1, idx)
        loss_dict = matching_loss(self.config, dict(batch, seg_label=seg_label), output)
        loss_dict["loss_total"] = matching_total_loss(self.config, loss_dict)
        return loss_dict
