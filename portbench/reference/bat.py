"""Plain BAT: the net of Zheng et al., "Box-Aware Feature Enhancement for
Single Object Tracking on Point Clouds" (ICCV 2021), at the widths of
Open3DSOT's cfgs/BAT_Car.yaml, and the matching tracker's single-frame
step around it ('firstandprevious' template, 'previous_result' reference
box, angles in degrees, z offset used, no limit box).

Plain PyTorch in float32 over a state dict with the port's parameter names:
every Dense and BatchNorm unfolded, farthest-point sampling as a loop, the
ball query and the kNN over dense distance matrices, no kernel. The net
follows the port's open3dsot_tpu_torch/models/bat.py:28-73 (the PointNet++
backbone of models/pointnet.py:367-396 with SetAbstraction :239-264,
BoxAwareXCorr of models/xcorr.py:56-103, P2BVoteNetRPN of models/rpn.py),
the neighbour searches open3dsot_tpu_torch/ops/neighbors.py and
ops/sampling.py::furthest_point_sample_plain (the same rounding of the
squared distances, so that the indices are those the kernels must give);
`step` follows open3dsot_tpu_torch/tracking/scan_matching.py::
make_match_step:108-195 and `first_crop` the host crop of a stream's first
frame (tracking/online.py::OnlineMatchTracker.reset, geometry/
points_utils.py::cropAndCenterPC), in float64 numpy. Nothing of the port or
of JAX is imported.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import common as c

SA = (((64, 64, 128), 0.3), ((128, 128, 256), 0.5), ((256, 256, 256), 0.7))
NSAMPLE = 32
VOTE_RADIUS, VOTE_NSAMPLE = 0.3, 16


def param_specs(cfg: dict) -> list:
    """(name, shape, init) of every parameter and buffer, in the port's order."""
    f, h, o, v = (int(cfg[k]) for k in ("feature_channel", "hidden_channel", "out_channel",
                                        "vote_channel"))
    bc = int(cfg.get("bc_channel", 9))
    s, cin = [], 0
    for i, (mlp, _) in enumerate(SA):
        s += c.mlp_specs(f"backbone.sa{i}.mlp_shared", cin + 3, mlp)
        cin = mlp[-1]
    s += c.dense_specs("conv_final", SA[-1][0][-1], f)
    s += c.mlp_specs("mlp_bc", 3 + f, (f, f, bc), final_plain=True)
    s += c.mlp_specs("xcorr.mlp", 3 + bc + f, (h, h, h))
    s += c.mlp_specs("xcorr.fea_layer", h, (h, o), final_plain=True)
    s += c.mlp_specs("rpn.FC_layer_cla", o, (o, o, 1), final_plain=True)
    s += c.mlp_specs("rpn.vote_layer", 3 + o, (o, o, 3 + o), final_plain=True)
    s += c.mlp_specs("rpn.vote_aggregation.mlp_shared", 3 + 1 + o, (v, v, v))
    s += c.mlp_specs("rpn.FC_proposal", v, (v, v, 5), final_plain=True)
    return s


def _sqdist_direct(centers, xyz):
    d = [centers[:, :, None, k] - xyz[:, None, :, k] for k in range(3)]
    return (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]


def _radius_sq(radius: float) -> float:
    """r^2 taken in double and rounded once to float32."""
    return float(np.float32(radius * radius))


def ball_query(radius: float, nsample: int, xyz, new_xyz):
    """The first nsample points strictly inside the radius, in index order,
    unfilled slots repeating the first; (B, S, nsample) int64."""
    N = xyz.shape[1]
    d2 = _sqdist_direct(new_xyz, xyz)
    iota = torch.arange(N, device=xyz.device)
    key = torch.where(d2 < _radius_sq(radius), iota, N)
    if nsample > N:
        key = torch.nn.functional.pad(key, (0, nsample - N), value=N)
    key = torch.sort(key, dim=-1).values[..., :nsample]
    valid = key < N
    first = torch.where(valid[..., :1], key[..., :1], 0)
    return torch.where(valid, key, first)


def fps(xyz, npoint: int):
    """Farthest-point sampling from index 0; (B, npoint) int64."""
    B, N, _ = xyz.shape
    idxs = torch.zeros(B, npoint, dtype=torch.int64, device=xyz.device)
    min_d2 = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    last = xyz[:, 0]
    for i in range(1, npoint):
        d = xyz - last[:, None, :]
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
        min_d2 = torch.minimum(min_d2, d2)
        nxt = torch.argmax(min_d2, dim=-1)
        idxs[:, i] = nxt
        last = xyz[rows, nxt]
    return idxs


def gather(x, idx):
    """x (B, N, C) rows at idx (B, ...) -> (B, ..., C)."""
    B, C = x.shape[0], x.shape[-1]
    flat = idx.reshape(B, -1)
    out = torch.gather(x, 1, flat[..., None].expand(B, flat.shape[1], C))
    return out.reshape(*idx.shape, C)


def set_abstraction(sd, prefix, xyz, feats, npoint, radius, nsample, use_fps):
    """-> (centroids (B, S, 3), features (B, S, C3), centroid indices (B, S))."""
    B = xyz.shape[0]
    if use_fps:
        idx = fps(xyz, npoint)
    else:
        idx = torch.arange(npoint, device=xyz.device)[None].expand(B, npoint)
    new_xyz = gather(xyz, idx)
    nb = ball_query(radius, nsample, xyz, new_xyz)
    grouped = gather(xyz, nb) - new_xyz[:, :, None, :]
    if feats is not None:
        grouped = torch.cat([grouped, gather(feats, nb)], dim=-1)
    out = c.mlp(grouped, sd, prefix + ".mlp_shared", 3).amax(dim=2)
    return new_xyz, out, idx


def backbone(sd, pts):
    n = pts.shape[1]
    xyz, feats, first_idx = pts, None, None
    for i, (_, radius) in enumerate(SA):
        xyz, feats, idx = set_abstraction(sd, f"backbone.sa{i}", xyz, feats, n // (2 << i),
                                          radius, NSAMPLE, i == 0)
        if i == 0:
            first_idx = idx
    return xyz, feats, first_idx


def knn(query, ref, k: int):
    """k nearest refs per query, by a^2 + b^2 - 2ab, stable on ties."""
    a2 = (query * query).sum(-1, keepdim=True)
    b2 = (ref * ref).sum(-1, keepdim=True)
    d2 = (a2 + b2.transpose(1, 2) - 2.0 * torch.matmul(query, ref.transpose(1, 2))).clamp_min(0.0)
    return torch.sort(d2, dim=-1, stable=True).indices[..., :k]


def forward(sd, cfg, template, search, template_bc):
    """-> proposals (B, P, 5): (dx, dy, dz, angle, objectness logit)."""
    M = template.shape[1]
    t_xyz, t_feat, t_idx = backbone(sd, template)
    s_xyz, s_feat, _ = backbone(sd, search)
    t_feat, s_feat = c.dense(t_feat, sd, "conv_final"), c.dense(s_feat, sd, "conv_final")
    s_bc = c.mlp(torch.cat([s_xyz, s_feat], dim=-1), sd, "mlp_bc", 3, final_plain=True)
    t_bc = gather(template_bc, t_idx[:, : M // 8])
    idx = knn(s_bc, t_bc, int(cfg.get("k", 4)))
    corr = gather(torch.cat([t_xyz, t_bc, t_feat], dim=-1), idx)
    fusion = c.mlp(corr, sd, "xcorr.mlp", 3).amax(dim=2)
    fusion = c.mlp(fusion, sd, "xcorr.fea_layer", 2, final_plain=True)
    score = torch.sigmoid(c.mlp(fusion, sd, "rpn.FC_layer_cla", 3, final_plain=True)[..., 0])
    xf = torch.cat([s_xyz, fusion], dim=-1)
    vote = xf + c.mlp(xf, sd, "rpn.vote_layer", 3, final_plain=True)
    centers, prop, _ = set_abstraction(
        sd, "rpn.vote_aggregation", vote[..., :3], torch.cat([score[..., None], vote[..., 3:]],
                                                              dim=-1),
        int(cfg["num_proposal"]), VOTE_RADIUS, VOTE_NSAMPLE, False)
    off = c.mlp(prop, sd, "rpn.FC_proposal", 3, final_plain=True)
    return torch.cat([off[..., 0:3] + centers, off[..., 3:5]], dim=-1)


def first_crop(points: np.ndarray, center, theta: float, wlh, cfg: dict, P1: int):
    """A stream's first frame cropped to its first box (scaled by
    model_bb_scale, grown by model_bb_offset, strict bounds) in the box's
    frame, in the cloud's order: -> ((P1, 3) float32, count)."""
    ct, st = math.cos(theta), math.sin(theta)
    rot_t = np.array([[ct, st, 0.0], [-st, ct, 0.0], [0.0, 0.0, 1.0]])
    local = (np.asarray(points, np.float64) - np.asarray(center, np.float64)) @ rot_t.T
    w, l, h = np.asarray(wlh, np.float64) * float(cfg["model_bb_scale"])
    half = np.array([l, w, h]) / 2 + float(cfg["model_bb_offset"])
    keep = np.all((local < half) & (local > -half), axis=1)
    crop = local[keep].astype(np.float32)[:P1]
    out = np.zeros((P1, 3), np.float32)
    out[: len(crop)] = crop
    return out, len(crop)


def step(sd, cfg, wlh, ref_box, first_pts, first_valid, prev_pts, prev_valid, this_pts,
         this_valid):
    """One tracking step of B rows -> (every proposal composed onto
    ref_box (B, P, 4), their objectness (B, P))."""
    t_size, s_size = int(cfg["template_size"]), int(cfg["search_size"])
    B = ref_box.shape[0]
    half_wlh = torch.stack([wlh[:, 1], wlh[:, 0], wlh[:, 2]], dim=-1) / 2.0

    def crop(pts, pad_valid, half):
        local = c.remove_transform_points(pts, ref_box)
        return local, ((local < half[:, None, :]) & (local > -half[:, None, :])).all(dim=-1) \
            & pad_valid

    m_half = half_wlh * float(cfg["model_bb_scale"]) + float(cfg["model_bb_offset"])
    prev_local, prev_ok = crop(prev_pts, prev_valid, m_half)
    template = c.select_strided(torch.cat([first_pts, prev_local], dim=1),
                                torch.cat([first_valid, prev_ok], dim=1), t_size)
    s_half = half_wlh * float(cfg["search_bb_scale"]) + float(cfg["search_bb_offset"])
    search = c.select_strided(*crop(this_pts, this_valid, s_half), s_size)
    bc = c.box_cloud(template, template.new_zeros(B, 4), wlh)
    with torch.no_grad():
        boxes = forward(sd, cfg, template, search, bc)
    P = boxes.shape[1]
    theta = boxes[..., 3] * (math.pi / 180.0) if cfg.get("degrees", True) else boxes[..., 3]
    dz = boxes[..., 2] if cfg.get("use_z", True) else torch.zeros_like(boxes[..., 2])
    offset = torch.stack([boxes[..., 0], boxes[..., 1], dz, theta], dim=-1)
    composed = c.get_offset_box(ref_box.repeat_interleave(P, 0), offset.reshape(B * P, 4))
    return composed.reshape(B, P, 4), boxes[..., 4]
