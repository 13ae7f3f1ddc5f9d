"""Plain M2-Track: the net of Zheng et al., "Beyond 3D Siamese Tracking: A
Motion-Centric Paradigm for 3D Single Object Tracking in Point Clouds"
(CVPR 2022), at the widths of Open3DSOT's cfgs/M2_track_kitti.yaml
(box_aware, motion classifier, second stage, previous-box refinement), and
the scan tracker's single-frame step around it.

Plain PyTorch in float32 over a state dict with the port's parameter names
(`seg_pointnet.mlp1_0.layer0.dense.weight`, ...): every Dense and BatchNorm
unfolded, no kernel, no cache, no batching beyond the rows given. The net
follows the port's open3dsot_tpu_torch/models/m2track.py:31-142 (itself the
JAX package's and the reference's m2track.py); `step` follows
open3dsot_tpu_torch/tracking/scan_tracker.py::make_m2_step:299-340 (the
crop, the strided resampling, the prior-targetness and timestamp channels,
the BoxCloud, the 4-DoF box composition) for a z-up dataset without
limit_box. Nothing of the port or of JAX is imported.
"""

from __future__ import annotations

import torch

from portbench.reference import common as c

BC = 9  # BoxCloud channels
SEG_MLP1, SEG_MLP2, SEG_OUT = (64, 64, 64, 128, 1024), (512, 256, 128, 128), 2 + BC
MINI_MLP, MINI_HIDDEN = (64, 128, 256, 512), (512, 256)
HEAD = (128, 128)
TAP_AT = 1


def param_specs() -> list:
    """(name, shape, init) of every parameter and buffer, in the port's
    state-dict order."""
    s, cin = [], 5 + BC
    for i, w in enumerate(SEG_MLP1):
        s += c.dense_bn_specs(f"seg_pointnet.mlp1_{i}.layer0", cin, w)
        cin = w
    cin = SEG_MLP1[TAP_AT] + SEG_MLP1[-1]
    for i, w in enumerate(SEG_MLP2):
        s += c.dense_bn_specs(f"seg_pointnet.mlp2_{i}.layer0", cin, w)
        cin = w
    s += c.dense_specs("seg_pointnet.fc", cin, SEG_OUT)
    s += c.mlp_specs("mini_pointnet.per_point", 4 + BC, MINI_MLP)
    s += c.mlp_specs("mini_pointnet.hidden", MINI_MLP[-1], MINI_HIDDEN)
    s += c.mlp_specs("motion_mlp", MINI_HIDDEN[-1], HEAD + (4,), final_plain=True)
    s += c.mlp_specs("motion_state_mlp", MINI_HIDDEN[-1], HEAD + (2,), final_plain=True)
    s += c.mlp_specs("final_mlp", MINI_HIDDEN[-1], HEAD + (4,), final_plain=True)
    s += c.mlp_specs("mini_pointnet2.per_point", 3 + BC, MINI_MLP)
    s += c.mlp_specs("mini_pointnet2.hidden", MINI_MLP[-1], MINI_HIDDEN)
    s += c.mlp_specs("box_mlp", MINI_HIDDEN[-1], HEAD + (4,), final_plain=True)
    return s


def _mini(x, sd, prefix):
    x = c.mlp(x, sd, prefix + ".per_point", len(MINI_MLP)).amax(dim=1)
    return c.mlp(x, sd, prefix + ".hidden", len(MINI_HIDDEN))


def _seg(x, sd):
    tap = None
    for i in range(len(SEG_MLP1)):
        x = c.dense_bn_relu(x, sd, f"seg_pointnet.mlp1_{i}.layer0")
        if i == TAP_AT:
            tap = x
    pooled = x.amax(dim=1, keepdim=True).expand(-1, x.shape[1], -1)
    x = torch.cat([tap, pooled], dim=-1)
    for i in range(len(SEG_MLP2)):
        x = c.dense_bn_relu(x, sd, f"seg_pointnet.mlp2_{i}.layer0")
    return c.dense(x, sd, "seg_pointnet.fc")


def forward(sd: dict, points: torch.Tensor, bc: torch.Tensor) -> dict:
    """points (B, 2n, 5) (frame t-1 first), bc (B, 2n, 9) -> the boxes."""
    x = torch.cat([points, bc], dim=-1)
    N = x.shape[1]
    seg_out = _seg(x, sd)
    pred_cls = torch.argmax(seg_out[..., :2], dim=-1, keepdim=True).to(x.dtype)
    mask_points = x[..., :4] * pred_cls
    mask_xyz_t0, mask_xyz_t1 = mask_points[:, : N // 2, :3], mask_points[:, N // 2:, :3]
    mask_pred_bc = seg_out[..., 2:] * pred_cls
    feat = _mini(torch.cat([mask_points, mask_pred_bc], dim=-1), sd, "mini_pointnet")
    n_head = len(HEAD) + 1
    motion = c.mlp(feat, sd, "motion_mlp", n_head, final_plain=True)
    state = c.mlp(feat, sd, "motion_state_mlp", n_head, final_plain=True)
    motion_masked = motion * torch.argmax(state, dim=-1, keepdim=True).to(motion.dtype)
    prev_boxes = c.mlp(feat, sd, "final_mlp", n_head, final_plain=True)
    aux_box = c.get_offset_box(prev_boxes, motion_masked)
    moved = c.get_offset_points(mask_xyz_t0, prev_boxes[:, :4], motion_masked)
    xyz01 = c.remove_transform_points(torch.cat([moved, mask_xyz_t1], dim=1), aux_box)
    feat2 = _mini(torch.cat([xyz01, mask_pred_bc], dim=-1), sd, "mini_pointnet2")
    offset = c.mlp(feat2, sd, "box_mlp", n_head, final_plain=True)
    return {"estimation_boxes": c.get_offset_box(aux_box, offset), "aux_box": aux_box}


def step(sd: dict, cfg: dict, wlh, ref_box, prev_pts, prev_valid, this_pts, this_valid,
         first: torch.Tensor) -> torch.Tensor:
    """One tracking step of B rows: the frames (B, P, 3) with validity
    (B, P) cropped around `ref_box` (B, 4), resampled to n points each,
    stacked with their channels, through the net, the predicted offset
    composed onto `ref_box`. `first` (B, 1) bool: the hard prior-targetness
    of a tracklet's first step (later steps the soft 0.8 / 0.2)."""
    n = int(cfg["point_sample_size"])
    scale, offset = float(cfg["bb_scale"]), float(cfg["bb_offset"])
    B = ref_box.shape[0]
    half = (torch.stack([wlh[:, 1], wlh[:, 0], wlh[:, 2]], dim=-1) * (scale / 2.0)
            + offset)[:, None, :]

    def crop(pts, pad_valid):
        local = c.remove_transform_points(pts, ref_box)
        return local, ((local < half) & (local > -half)).all(dim=-1) & pad_valid

    prev_sel = c.select_strided(*crop(prev_pts, prev_valid), n)
    this_sel = c.select_strided(*crop(this_pts, this_valid), n)
    canonical = prev_sel.new_zeros(B, 4)
    seg_prev = c.points_in_box(prev_sel, canonical, wlh, 1.25).to(prev_sel.dtype)
    soft = torch.where(seg_prev > 0.5, 0.8, 0.2).to(prev_sel.dtype)
    seg_prev = torch.where(first, seg_prev, soft)
    prev_stack = torch.cat([prev_sel, prev_sel.new_zeros(B, n, 1), seg_prev[..., None]], dim=-1)
    this_stack = torch.cat([this_sel, this_sel.new_full((B, n, 1), 0.1),
                            this_sel.new_full((B, n, 1), 0.5)], dim=-1)
    bc_prev = c.box_cloud(prev_sel, canonical, wlh)
    bc = torch.cat([bc_prev, torch.zeros_like(bc_prev)], dim=1)
    with torch.no_grad():
        pred = forward(sd, torch.cat([prev_stack, this_stack], dim=1), bc)["estimation_boxes"]
    return c.get_offset_box(ref_box, pred)


# --- training: batch statistics, the loss, autograd ---------------------------
TRAINED = ("weight", "bias")  # the leaves of a Dense and of a BatchNorm's affine


def leaves(sd: dict) -> list:
    """The names of the trained parameters, in the port's order."""
    return [n for n in sd if n.rsplit(".", 1)[1] in TRAINED]


def _t_dense_bn_relu(x, p, prefix):
    """Dense -> BatchNorm with the batch's statistics (mean and biased
    variance over every leading axis, mean(x^2) - mean^2 clipped at 0, as
    flax and the port) -> ReLU."""
    x = torch.nn.functional.linear(x, p[prefix + ".dense.weight"], p[prefix + ".dense.bias"])
    dims = tuple(range(x.dim() - 1))
    mean = x.mean(dims)
    var = ((x * x).mean(dims) - mean * mean).clamp_min(0.0)
    x = (x - mean) * (torch.rsqrt(var + c.BN_EPS) * p[prefix + ".bn.weight"]) + p[prefix + ".bn.bias"]
    return torch.relu(x)


def _t_mlp(x, p, prefix, n, final_plain=False):
    for i in range(n):
        if final_plain and i == n - 1:
            x = torch.nn.functional.linear(x, p[f"{prefix}.layer{i}.dense.weight"],
                                           p[f"{prefix}.layer{i}.dense.bias"])
        else:
            x = _t_dense_bn_relu(x, p, f"{prefix}.layer{i}")
    return x


def train_forward(p: dict, points: torch.Tensor, bc: torch.Tensor) -> dict:
    """The training forward (models/m2track.py:59-113 in train mode) over
    parameters `p` (leaves with grad)."""
    x = torch.cat([points, bc], dim=-1)
    N = x.shape[1]
    tap = None
    h = x
    for i in range(len(SEG_MLP1)):
        h = _t_dense_bn_relu(h, p, f"seg_pointnet.mlp1_{i}.layer0")
        if i == TAP_AT:
            tap = h
    h = torch.cat([tap, h.amax(dim=1, keepdim=True).expand(-1, N, -1)], dim=-1)
    for i in range(len(SEG_MLP2)):
        h = _t_dense_bn_relu(h, p, f"seg_pointnet.mlp2_{i}.layer0")
    seg_out = torch.nn.functional.linear(h, p["seg_pointnet.fc.weight"], p["seg_pointnet.fc.bias"])
    seg_logits = seg_out[..., :2]
    pred_cls = torch.argmax(seg_logits, dim=-1, keepdim=True).to(x.dtype)
    mask_points = x[..., :4] * pred_cls
    mask_xyz_t0, mask_xyz_t1 = mask_points[:, : N // 2, :3], mask_points[:, N // 2:, :3]
    pred_bc = seg_out[..., 2:]
    mask_pred_bc = pred_bc * pred_cls

    def mini(z, prefix):
        z = _t_mlp(z, p, prefix + ".per_point", len(MINI_MLP)).amax(dim=1)
        return _t_mlp(z, p, prefix + ".hidden", len(MINI_HIDDEN))

    feat = mini(torch.cat([mask_points, mask_pred_bc], dim=-1), "mini_pointnet")
    n_head = len(HEAD) + 1
    motion = _t_mlp(feat, p, "motion_mlp", n_head, True)
    state = _t_mlp(feat, p, "motion_state_mlp", n_head, True)
    masked = motion * torch.argmax(state, dim=-1, keepdim=True).to(motion.dtype)
    prev_boxes = _t_mlp(feat, p, "final_mlp", n_head, True)
    aux_box = c.get_offset_box(prev_boxes, masked)
    moved = c.get_offset_points(mask_xyz_t0, prev_boxes[:, :4], masked)
    xyz01 = c.remove_transform_points(torch.cat([moved, mask_xyz_t1], dim=1), aux_box)
    offset = _t_mlp(mini(torch.cat([xyz01, mask_pred_bc], dim=-1), "mini_pointnet2"), p,
                    "box_mlp", n_head, True)
    return {"estimation_boxes": c.get_offset_box(aux_box, offset), "aux_estimation_boxes": aux_box,
            "motion_pred": motion, "motion_cls": state, "estimation_boxes_prev": prev_boxes,
            "seg_logits": seg_logits, "pred_bc": pred_bc}


def _smooth_l1(pred, target):
    diff = (pred - target).abs()
    return torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)


def _cross_entropy(logits, labels, weight=None):
    nll = -torch.gather(torch.log_softmax(logits, dim=-1), -1, labels[..., None])[..., 0]
    if weight is None:
        return nll.mean()
    w = torch.as_tensor(weight, dtype=logits.dtype, device=logits.device)[labels]
    return (nll * w).sum() / (w.sum() + 1e-12)


def loss(cfg: dict, batch: dict, out: dict) -> torch.Tensor:
    """M2-Track's weighted multi-task loss (the reference's m2track.py:153-231,
    the port's models/m2track.py::m2track_loss), its total."""
    box, prev, motion = batch["box_label"], batch["box_label_prev"], batch["motion_label"]
    state_label = batch["motion_state_label"].float()
    mp = out["motion_pred"]
    denom = state_label.sum() + 1e-6
    lcm = (state_label * _smooth_l1(mp[:, :3], motion[:, :3]).mean(dim=1)).sum() / denom
    lam = (state_label * _smooth_l1(torch.sin(mp[:, 3]), torch.sin(motion[:, 3]))).sum() / denom
    cw, aw = float(cfg["center_weight"]), float(cfg["angle_weight"])

    def box_terms(est, label):
        return (_smooth_l1(est[:, :3], label[:, :3]).mean() * cw
                + _smooth_l1(torch.sin(est[:, 3]), torch.sin(label[:, 3])).mean() * aw)

    total = _cross_entropy(out["motion_cls"], batch["motion_state_label"]) \
        * float(cfg["motion_cls_seg_weight"])
    total = total + box_terms(out["estimation_boxes"], box)
    total = total + box_terms(out["estimation_boxes_prev"], prev)
    total = total + (_cross_entropy(out["seg_logits"], batch["seg_label"], [0.5, 2.0])
                     * float(cfg["seg_weight"]) + box_terms(out["aux_estimation_boxes"], box)
                     + lcm * cw + lam * aw)
    bc_label = torch.cat([batch["prev_bc"], batch["this_bc"]], dim=1)
    return total + _smooth_l1(out["pred_bc"], bc_label).mean() * float(cfg["bc_weight"])
