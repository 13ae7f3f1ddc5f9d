"""VoteNet-style region proposal head, port of `open3dsot_tpu/models/rpn.py`
(reference head/rpn.py:12-67): per-point classification, vote offsets on
xyz || feature, score-prepended vote features, an SA layer (radius 0.3,
nsample 16, through K4 in eval) that aggregates the votes into
num_proposal clusters, and the proposal regression (dxyz, theta,
objectness) added to the cluster centres. With `dtype` bf16 the MLPs and the
vote SA layer compute in bf16; the logits, the votes and the proposals are
f32 (JAX rpn.py:35-63).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from open3dsot_tpu_torch.models.layers import MLP, to_f32
from open3dsot_tpu_torch.models.pointnet import SetAbstraction


class P2BVoteNetRPN(nn.Module):
    def __init__(self, feature_channel: int, vote_channel: int = 256, num_proposal: int = 64,
                 normalize_xyz: bool = False, fused_eval: bool = True, device=None,
                 dtype=None):
        super().__init__()
        f, v = feature_channel, vote_channel
        kw = dict(device=device, dtype=dtype)
        self.num_proposal = num_proposal
        self.FC_layer_cla = MLP(f, [f, f, 1], final_plain=True, **kw)
        self.vote_layer = MLP(3 + f, [f, f, 3 + f], final_plain=True, **kw)
        self.vote_aggregation = SetAbstraction(1 + f, [v, v, v], radius=0.3, nsample=16,
                                               use_xyz=True, use_fps=False,
                                               normalize_xyz=normalize_xyz,
                                               fused_eval=fused_eval, **kw)
        self.FC_proposal = MLP(v, [v, v, 5], final_plain=True, **kw)

    def forward(self, xyz: torch.Tensor, feature: torch.Tensor):
        """xyz (B, N, 3), feature (B, N, f) -> (estimation_boxes (B, P, 5),
        estimation_cla (B, N), vote_xyz (B, N, 3), center_xyzs (B, P, 3))."""
        # classification logits feed the loss and the vote scores: f32
        estimation_cla = to_f32(self.FC_layer_cla(feature)[..., 0])
        score = torch.sigmoid(estimation_cla)
        xyz_feature = torch.cat([xyz, feature], dim=-1)  # (B, N, 3 + f)
        # votes are geometry (xyz offsets in meters): summed in f32
        vote = to_f32(xyz_feature) + to_f32(self.vote_layer(xyz_feature))
        vote_xyz = vote[..., 0:3]
        vote_feature = torch.cat([score[..., None], vote[..., 3:]], dim=-1)
        center_xyzs, proposal_features, _ = self.vote_aggregation(
            vote_xyz, vote_feature, self.num_proposal)
        proposal_offsets = to_f32(self.FC_proposal(proposal_features))  # (B, P, 3 + 1 + 1)
        estimation_boxes = torch.cat(
            [proposal_offsets[..., 0:3] + center_xyzs, proposal_offsets[..., 3:5]], dim=-1)
        return estimation_boxes, estimation_cla, vote_xyz, center_xyzs
