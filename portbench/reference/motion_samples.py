"""M2-Track's training samples as the port's trainer makes them with
`device_sampler: true`, worked out again from the raw tracklets: which
(tracklet, frame, candidate) each row of a batch is, the raw frames padded
to fixed shapes, and the build on the device with threefry draws.

Frozen copies, in plain numpy and PyTorch, of:
- the loader's order, open3dsot_tpu_torch/data/loader.py::BatchLoader
  (_indices: a numpy Generator seeded seed + epoch shuffles arange(n));
- the host side, data/device_sampler.py::RawMotionSampler (the (anno,
  candidate) walk over the tracklets' frames, frames above max_raw_points
  keeping the points nearest the previous box's centre);
- the build, data/device_sampler.py::make_motion_builder and its helpers
  (draw requests, augmentation, reference-box offset, subwindow crop,
  resampling, labels, BoxClouds), for a z-up dataset on one rank;
- the trainer's keys, train/trainer.py::Trainer.fit (the sampler key is
  prng_key(seed + 1), step s builds with fold_in(that key, s)).
Nothing of the port or of JAX is imported.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import common as c
from portbench.reference import prng

_DEG2RAD = float(np.float32(np.pi / 180.0))
_RAD2DEG = float(np.float32(180.0 / np.pi))
_DEG5 = float(np.float32(np.deg2rad(5.0)))


def loader_rows(n: int, batch: int, seed: int, epoch: int, step: int) -> np.ndarray:
    """The sample indices of batch `step` of an epoch."""
    idx = np.arange(n)
    np.random.default_rng(seed + epoch).shuffle(idx)
    return idx[step * batch:(step + 1) * batch]


def step_key(seed: int, step: int):
    return prng.fold_in(prng.prng_key(int(seed) + 1), step)


def _pad(points: np.ndarray, center, P: int):
    p = np.asarray(points, np.float32)
    if len(p) > P:
        d = np.linalg.norm(p - np.asarray(center, np.float32)[None, :3], axis=1)
        p = p[np.argsort(d, kind="stable")[:P]]
    out = np.zeros((P, 3), np.float32)
    out[: len(p)] = p
    valid = np.zeros((P,), bool)
    valid[: len(p)] = True
    return out, valid


def _box4(center, theta) -> np.ndarray:
    th = float(theta)
    return np.append(center, np.arctan2(np.sin(th), np.cos(th))).astype(np.float32)


def _in_box(points, center, theta, wlh) -> int:
    """Points inside the box (inclusive bounds), as the sampler's target check."""
    ct, st = np.cos(theta), np.sin(theta)
    local = (np.asarray(points, np.float64) - center) @ np.array([[ct, -st, 0], [st, ct, 0],
                                                                  [0, 0, 1.0]])
    w, l, h = wlh
    return int(np.sum((np.abs(local[:, 0]) <= l / 2) & (np.abs(local[:, 1]) <= w / 2)
                      & (np.abs(local[:, 2]) <= h / 2)))


def raw_batch(data: list, rows, num_candidates: int, P: int) -> dict:
    """The collated raw samples of `rows` (indices into the (anno,
    candidate) walk of the tracklets `data`)."""
    lens = [len(tr["points"]) for tr in data]
    starts = np.cumsum([0] + lens)
    out = {k: [] for k in ("prev_pts", "prev_valid", "this_pts", "this_valid", "prev_box",
                           "this_box", "wlh", "candidate_zero")}
    for index in rows:
        anno, cand = int(index) // num_candidates, int(index) % num_candidates
        t = int(np.searchsorted(starts, anno, side="right") - 1)
        this_id = anno - starts[t]
        prev_id = max(this_id - 1, 0)
        tr = data[t]
        prev_box = _box4(tr["center"][prev_id], tr["theta"][prev_id])
        if _in_box(tr["points"][prev_id], tr["center"][prev_id], tr["theta"][prev_id],
                   tr["wlh"]) <= 10:
            raise ValueError("the traffic drew a frame with ten target points or fewer, which "
                             "the sampler would redraw from numpy's global state")
        this_box = _box4(tr["center"][this_id], tr["theta"][this_id])
        for name, f in (("prev", prev_id), ("this", this_id)):
            pts, valid = _pad(tr["points"][f], prev_box, P)
            out[f"{name}_pts"].append(pts)
            out[f"{name}_valid"].append(valid)
        out["prev_box"].append(prev_box)
        out["this_box"].append(this_box)
        out["wlh"].append(np.asarray(tr["wlh"], np.float32))
        out["candidate_zero"].append(np.bool_(cand == 0))
    return {k: np.stack(v) for k, v in out.items()}


# --- frozen copy of data/device_sampler.py:49-200 (one rank, z-up) ---
def first_smallest(keys: torch.Tensor, k: int) -> torch.Tensor:
    return torch.sort(keys, dim=1, stable=True)[1][:, :k]


def _draw(requests: dict, device) -> dict:
    flat = [r for rs in requests.values() for r in rs]
    made = iter(prng.bits_many(flat, device) if flat else [])
    return {name: [next(made) for _ in rs] for name, rs in requests.items()}


def _select_requests(key, B: int, P: int, n: int) -> list:
    k_u, k_r = prng.split(key)
    return [(k_u, (B, P))] + prng.randint_requests(k_r, (B, n))


def _select(points, valid, n: int, draws: list):
    B, P, _ = points.shape
    k = min(n, P)
    count = valid.sum(dim=1, keepdim=True)
    iota = torch.arange(P, device=points.device).expand(B, P)
    order_n = torch.sort(torch.where(valid, iota, iota + P), dim=1)[0][:, :k].clamp_max(P - 1)
    if n > P:
        order_n = torch.cat([order_n, order_n[:, :1].expand(B, n - P)], dim=1)
    idx_wo = first_smallest(torch.where(valid, prng.uniform_of(draws[0]), 2.0), k)
    if n > P:
        idx_wo = torch.cat([idx_wo, idx_wo[:, :1].expand(B, n - P)], dim=1)
    r = prng.randint_of(draws[1], draws[2], 0, count.clamp_min(1))
    idx_wr = order_n.gather(1, r.clamp_max(k - 1))
    idx = torch.where(count > n, idx_wo, torch.where(count == n, order_n, idx_wr))
    sel = points.gather(1, idx[..., None].expand(B, n, points.shape[2]))
    return torch.where(count[..., None] > 2, sel, 0.0)


def _augment_requests(key, B: int) -> list:
    k_t, k_rot, k_fx, k_fy = prng.split(key, 4)
    return [(k_t, (B, 3)), (k_rot, (B,)), (k_fx, (B,)), (k_fy, (B,))]


def _augment(pts, valid, box, wlh, draws: list):
    t = prng.uniform_of(draws[0], -0.3, 0.3)
    alpha = prng.uniform_of(draws[1], -10.0, 10.0) * _DEG2RAD
    flip_x, flip_y = prng.bernoulli_of(draws[2], 0.5), prng.bernoulli_of(draws[3], 0.5)
    mask = c.points_in_box(pts, box, wlh, 1.25) & valid
    local = c.remove_transform_points(pts, box)
    lx = torch.where(flip_x[:, None], -local[..., 0], local[..., 0])
    ly = torch.where(flip_y[:, None], -local[..., 1], local[..., 1])
    local = torch.stack([lx, ly, local[..., 2]], dim=-1)
    local = c.rotate(local, c.rotz(alpha)) + t[:, None, :]
    moved = c.apply_transform_points(local, box)
    new_pts = torch.where(mask[..., None], moved, pts)
    theta_off = torch.where(flip_x, float(np.float32(np.pi)), 0.0) + alpha
    new_box = c.get_offset_box(box, torch.cat([t, theta_off[:, None]], dim=-1))
    return new_pts, torch.cat([new_box[:, :3], c.wrap_angle(new_box[:, 3:])], dim=-1)


def _ref_offset_requests(key, B: int, data_limit_box: bool) -> list:
    k_o, k_rx, k_ry = prng.split(key, 3)
    return [(k_o, (B, 3))] + ([(k_rx, (B,)), (k_ry, (B,))] if data_limit_box else [])


def _draw_ref_offset(draws: list, degrees: bool, wlh, candidate_zero):
    off = prng.uniform_of(draws[0], -0.3, 0.3)
    theta = off[:, 2] * 5.0 * _DEG2RAD if degrees else off[:, 2] * _DEG5
    dx, dy = off[:, 0], off[:, 1]
    if draws[1:]:
        dx = torch.where(dx > wlh[:, 0], prng.uniform_of(draws[1], -1.0, 1.0), dx)
        dy = torch.where(dy > wlh[:, 1].clamp_max(2.0), prng.uniform_of(draws[2], -1.0, 1.0), dy)
    offset4 = torch.stack([dx, dy, torch.zeros_like(dx), theta], dim=-1)
    return torch.where(candidate_zero[:, None], 0.0, offset4)


def _crop(pts, valid, box, half):
    local = c.remove_transform_points(pts, box)
    h = half[:, None, :]
    return local, ((local < h) & (local > -h)).all(dim=-1) & valid


def build(cfg: dict, raw: dict, key) -> dict:
    """An M2-Track batch from a raw batch on the device (make_motion_builder)."""
    n = int(cfg["point_sample_size"])
    scale, offset = float(cfg["bb_scale"]), float(cfg["bb_offset"])
    degrees = bool(cfg["degrees"])
    data_limit_box = bool(cfg.get("data_limit_box", False))
    use_aug = bool(cfg.get("use_augmentation", False))
    threshold = float(cfg.get("motion_threshold", 0.15))
    prev_pts, prev_valid = raw["prev_pts"], raw["prev_valid"]
    this_pts, this_valid = raw["this_pts"], raw["this_valid"]
    prev_box, this_box = raw["prev_box"], raw["this_box"]
    wlh, cand0 = raw["wlh"], raw["candidate_zero"]
    (B, P, _), dev = prev_pts.shape, prev_pts.device
    k_aug_p, k_aug_t, k_off, k_sel_p, k_sel_t = prng.split(key, 5)
    d = _draw({"aug_p": _augment_requests(k_aug_p, B) if use_aug else [],
               "aug_t": _augment_requests(k_aug_t, B) if use_aug else [],
               "off": _ref_offset_requests(k_off, B, data_limit_box),
               "sel_p": _select_requests(k_sel_p, B, P, n),
               "sel_t": _select_requests(k_sel_t, B, this_pts.shape[1], n)}, dev)
    if use_aug:
        prev_pts, prev_box = _augment(prev_pts, prev_valid, prev_box, wlh, d["aug_p"])
        this_pts, this_box = _augment(this_pts, this_valid, this_box, wlh, d["aug_t"])
    ref_box = c.get_offset_box(prev_box, _draw_ref_offset(d["off"], degrees, wlh, cand0))
    half = torch.stack([wlh[:, 1], wlh[:, 0], wlh[:, 2]], dim=-1) * (scale / 2.0) + offset
    prev_sel = _select(*_crop(prev_pts, prev_valid, ref_box, half), n, d["sel_p"])
    this_sel = _select(*_crop(this_pts, this_valid, ref_box, half), n, d["sel_t"])
    this_local_box = c.transform_box_params(this_box, ref_box)
    prev_local_box = c.transform_box_params(prev_box, ref_box)
    canonical = torch.zeros(B, 4, dtype=prev_sel.dtype, device=dev)
    motion_box = c.transform_box_params(this_box, prev_box)
    seg_label_this = c.points_in_box(this_sel, this_local_box, wlh, 1.25)
    seg_label_prev = c.points_in_box(prev_sel, prev_local_box, wlh, 1.25)
    seg_mask_prev = c.points_in_box(prev_sel, canonical, wlh, 1.25).float()
    soft = torch.where(seg_mask_prev > 0.5, 0.8, 0.2)
    seg_mask_prev = torch.where(cand0[:, None], seg_mask_prev, soft)
    seg_mask_this = torch.full((B, n), 0.5, device=dev)
    ts_prev = torch.zeros(B, n, 1, device=dev)
    ts_this = torch.full((B, n, 1), 0.1, device=dev)
    points = torch.cat([torch.cat([prev_sel, ts_prev, seg_mask_prev[..., None]], -1),
                        torch.cat([this_sel, ts_this, seg_mask_this[..., None]], -1)], dim=1)

    def params4(b):
        return torch.cat([b[:, :3], b[:, 3:4] * _RAD2DEG if degrees else b[:, 3:4]], dim=-1)

    shift = this_local_box[:, :3] - prev_local_box[:, :3]
    cand_bc_prev = c.box_cloud(prev_sel, canonical, wlh)
    return {"points": points, "box_label": params4(this_local_box),
            "box_label_prev": params4(prev_local_box), "motion_label": params4(motion_box),
            "motion_state_label": (torch.sqrt((shift * shift).sum(dim=-1)) > threshold).long(),
            "seg_label": torch.cat([seg_label_prev, seg_label_this], dim=1).long(),
            "prev_bc": c.box_cloud(prev_sel, prev_local_box, wlh),
            "this_bc": c.box_cloud(this_sel, this_local_box, wlh),
            "candidate_bc": torch.cat([cand_bc_prev, torch.zeros_like(cand_bc_prev)], dim=1)}
