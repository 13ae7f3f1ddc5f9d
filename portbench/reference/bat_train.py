"""Plain BAT in training: the training forward with batch-statistics
BatchNorm and the matching loss, over parameters that carry gradients.

Follows the port's open3dsot_tpu_torch/models/bat.py (BATNet.forward in
train mode and BATModel.loss), models/matching_base.py::matching_loss and
matching_total_loss and models/losses.py, at the widths of
portbench/reference/bat.py, whose farthest-point sampling, ball query and
gathers it reuses. Every set-abstraction layer is the plain grouping, a
shared MLP with the batch's statistics (mean and biased variance over
every leading axis, as the port's layers and its SA kernels take them) and
a max over the neighbours; the port runs SA layers 2-3 of the backbone
through its fused kernel K6, the rest as here. The loss: objectness (BCE,
positive weight 2, scaled by the mask's share), box and vote (smooth L1 on
the positive rows), seg (BCE on the search's first N/8 sampled points) and
the BoxCloud term, at the configuration's weights. Float32; nothing of the
port or of JAX is imported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import bat
from portbench.reference.m2track import _t_mlp as mlp, leaves  # noqa: F401 (leaves: the runner's)


def set_abstraction(p, prefix, xyz, feats, npoint, radius, nsample, use_fps):
    """-> (centroids (B, S, 3), features (B, S, C3), centroid indices (B, S))."""
    B = xyz.shape[0]
    if use_fps:
        idx = bat.fps(xyz.detach(), npoint)
    else:
        idx = torch.arange(npoint, device=xyz.device)[None].expand(B, npoint)
    new_xyz = bat.gather(xyz, idx)
    nb = bat.ball_query(radius, nsample, xyz.detach(), new_xyz.detach())
    grouped = bat.gather(xyz, nb) - new_xyz[:, :, None, :]
    if feats is not None:
        grouped = torch.cat([grouped, bat.gather(feats, nb)], dim=-1)
    return new_xyz, mlp(grouped, p, prefix + ".mlp_shared", 3).amax(dim=2), idx


def backbone(p, pts):
    n = pts.shape[1]
    xyz, feats, first_idx = pts, None, None
    for i, (_, radius) in enumerate(bat.SA):
        xyz, feats, idx = set_abstraction(p, f"backbone.sa{i}", xyz, feats, n // (2 << i),
                                          radius, bat.NSAMPLE, i == 0)
        if i == 0:
            first_idx = idx
    return xyz, feats, first_idx


def train_forward(p: dict, cfg: dict, template, search, template_bc) -> dict:
    """BATNet.forward in train mode over parameters `p` (leaves with grad)."""
    M = template.shape[1]
    t_xyz, t_feat, t_idx = backbone(p, template)
    s_xyz, s_feat, s_idx = backbone(p, search)
    t_feat = F.linear(t_feat, p["conv_final.weight"], p["conv_final.bias"])
    s_feat = F.linear(s_feat, p["conv_final.weight"], p["conv_final.bias"])
    pred_bc = mlp(torch.cat([s_xyz, s_feat], dim=-1), p, "mlp_bc", 3, final_plain=True)
    t_bc = bat.gather(template_bc, t_idx[:, : M // 8])
    idx = bat.knn(pred_bc, t_bc, int(cfg.get("k", 4)))
    corr = bat.gather(torch.cat([t_xyz, t_bc, t_feat], dim=-1), idx)
    fusion = mlp(mlp(corr, p, "xcorr.mlp", 3).amax(dim=2), p, "xcorr.fea_layer", 2,
                 final_plain=True)
    cla = mlp(fusion, p, "rpn.FC_layer_cla", 3, final_plain=True)[..., 0]
    xf = torch.cat([s_xyz, fusion], dim=-1)
    vote = xf + mlp(xf, p, "rpn.vote_layer", 3, final_plain=True)
    centers, prop, _ = set_abstraction(
        p, "rpn.vote_aggregation", vote[..., :3],
        torch.cat([torch.sigmoid(cla)[..., None], vote[..., 3:]], dim=-1),
        int(cfg["num_proposal"]), bat.VOTE_RADIUS, bat.VOTE_NSAMPLE, False)
    off = mlp(prop, p, "rpn.FC_proposal", 3, final_plain=True)
    return {"estimation_boxes": torch.cat([off[..., 0:3] + centers, off[..., 3:5]], dim=-1),
            "estimation_cla": cla, "vote_xyz": vote[..., :3], "center_xyz": centers,
            "sample_idxs": s_idx, "pred_search_bc": pred_bc}


def _smooth_l1(pred, target):
    diff = (pred - target).abs()
    return torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)


def _bce(logits, targets, pos_weight=None):
    pos = targets * F.logsigmoid(logits)
    if pos_weight is not None:
        pos = pos_weight * pos
    return (-(pos + (1.0 - targets) * F.logsigmoid(-logits))).mean()


def loss(cfg: dict, batch: dict, out: dict) -> torch.Tensor:
    """BAT's weighted matching loss with its BoxCloud term, its total."""
    idx = out["sample_idxs"][:, : out["estimation_cla"].shape[1]]
    seg = torch.gather(batch["seg_label"], 1, idx)
    box = batch["box_label"]
    seg_n = seg.sum() + 1e-6
    vote = out["vote_xyz"]
    l_seg = _bce(out["estimation_cla"], seg)
    l_vote = (_smooth_l1(vote, box[:, None, :3].expand_as(vote)).mean(dim=2) * seg).sum() / seg_n
    dist = torch.sqrt(((out["center_xyz"] - box[:, None, :3]) ** 2).sum(dim=-1) + 1e-6)
    obj = (dist < 0.3).to(dist.dtype)
    mask = ((dist < 0.3) | (dist > 0.6)).to(dist.dtype)
    est = out["estimation_boxes"]
    l_obj = _bce(est[:, :, 4], obj, pos_weight=2.0) * mask.sum() / (mask.sum() + 1e-6)
    l_box = (_smooth_l1(est[:, :, :4], box[:, None, :4].expand_as(est[:, :, :4])).mean(dim=2)
             * obj).sum() / (obj.sum() + 1e-6)
    l_bc = (_smooth_l1(out["pred_search_bc"], bat.gather(batch["points2cc_dist_s"], idx))
            .mean(dim=2) * seg).sum() / seg_n
    return (l_obj * float(cfg["objectiveness_weight"]) + l_box * float(cfg["box_weight"])
            + l_seg * float(cfg["seg_weight"]) + l_vote * float(cfg["vote_weight"])
            + l_bc * float(cfg["bc_weight"]))
