"""BAT's (and P2B's) training samples as the port's trainer makes them with
`device_sampler: true`, worked out again from the raw tracklets: which
(tracklet, frame, candidate) each row of a batch is, the raw first,
template and search frames padded to fixed shapes, and the build on the
device with threefry draws.

Frozen copies, in plain numpy and PyTorch, of:
- the host side, open3dsot_tpu_torch/data/device_sampler.py::
  RawSiameseSampler without random_sample (the (anno, candidate) walk over
  the tracklets' frames: the first frame, the one before the anno's and
  the anno's; each frame padded around its own box, frames above
  max_raw_points keeping the points nearest that box's centre);
- the build, data/device_sampler.py::make_siamese_builder (the template's
  gt offset, the merged first and template crops resampled, the search
  offset drawn from N(0, diag(1, 1, 5)) with candidate 0 unperturbed, the
  subwindow crop, the strict seg labels, the target, the BoxClouds), for a
  z-up dataset on one rank.
The loader's order and the trainer's keys are motion_samples.py's
(`loader_rows`, `step_key`), as are the draws, the resampling and the
augmentation it shares with the motion builder. Nothing of the port or of
JAX is imported.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import common as c
from portbench.reference import motion_samples as ms
from portbench.reference import prng

loader_rows, step_key = ms.loader_rows, ms.step_key


def raw_batch(data: list, rows, num_candidates: int, P: int) -> dict:
    """The collated raw samples of `rows` (indices into the (anno,
    candidate) walk of the tracklets `data`)."""
    lens = [len(tr["points"]) for tr in data]
    starts = np.cumsum([0] + lens)
    names = ("first", "template", "search")
    out = {f"{n}_{k}": [] for n in names for k in ("pts", "valid", "box")}
    out.update(wlh=[], candidate_zero=[])
    for index in rows:
        anno, cand = int(index) // num_candidates, int(index) % num_candidates
        t = int(np.searchsorted(starts, anno, side="right") - 1)
        this_id = anno - starts[t]
        tr = data[t]
        for name, f in zip(names, (0, max(this_id - 1, 0), this_id)):
            box = ms._box4(tr["center"][f], tr["theta"][f])
            pts, valid = ms._pad(tr["points"][f], box, P)
            out[f"{name}_pts"].append(pts)
            out[f"{name}_valid"].append(valid)
            out[f"{name}_box"].append(box)
        out["wlh"].append(np.asarray(tr["wlh"], np.float32))
        out["candidate_zero"].append(np.bool_(cand == 0))
    return {k: np.stack(v) for k, v in out.items()}


# --- frozen copy of data/device_sampler.py::make_siamese_builder (one rank, z-up) ---
def _limit_requests(key, B: int, data_limit_box: bool) -> list:
    if not data_limit_box:
        return []
    k_x, k_y = prng.split(key)
    return [(k_x, (B,)), (k_y, (B,))]


def _limit_redraw(draws: list, dx, dy, wlh):
    if not draws:
        return dx, dy
    dx = torch.where(dx > wlh[:, 0], prng.uniform_of(draws[0], -1.0, 1.0), dx)
    dy = torch.where(dy > wlh[:, 1].clamp_max(2.0), prng.uniform_of(draws[1], -1.0, 1.0), dy)
    return dx, dy


def _half(wlh, scale: float, offset: float):
    return torch.stack([wlh[:, 1], wlh[:, 0], wlh[:, 2]], dim=-1) * (scale / 2.0) + offset


def points_in_box_strict(points, box, wlh) -> torch.Tensor:
    """Strict (<) in-box mask of (B, N, 3) points in (B, 4) boxes."""
    local = c.remove_transform_points(points, box)
    half = torch.stack([wlh[:, 1], wlh[:, 0], wlh[:, 2]], dim=-1) / 2.0
    return (local.abs() < half[:, None, :]).all(dim=-1)


def build(cfg: dict, raw: dict, key) -> dict:
    """A BAT batch from a raw batch on the device (make_siamese_builder)."""
    t_size, s_size = int(cfg["template_size"]), int(cfg["search_size"])
    m_scale, m_offset = float(cfg["model_bb_scale"]), float(cfg["model_bb_offset"])
    s_scale, s_offset = float(cfg["search_bb_scale"]), float(cfg["search_bb_offset"])
    degrees = bool(cfg["degrees"])
    data_limit_box = bool(cfg.get("data_limit_box", False))
    use_aug = bool(cfg.get("use_augmentation", False))
    num_candidates = int(cfg.get("num_candidates", 1))
    ang_sd = float(np.sqrt(np.float32(5.0 if degrees else np.deg2rad(5.0))))
    first_pts, first_valid = raw["first_pts"], raw["first_valid"]
    tmpl_pts, tmpl_valid = raw["template_pts"], raw["template_valid"]
    srch_pts, srch_valid = raw["search_pts"], raw["search_valid"]
    first_box, tmpl_box, srch_box = raw["first_box"], raw["template_box"], raw["search_box"]
    wlh, cand0 = raw["wlh"], raw["candidate_zero"]
    B, dev = first_pts.shape[0], first_pts.device
    k_aug, k_toff, k_tlim, k_koff, k_klim, k_sel_t, k_sel_s = prng.split(key, 7)
    d = ms._draw({"aug": ms._augment_requests(k_aug, B) if use_aug else [],
                  "toff": [(k_toff, (B, 3))],
                  "tlim": _limit_requests(k_tlim, B, data_limit_box),
                  "koff": [(k_koff, (B, 3))],
                  "klim": _limit_requests(k_klim, B, data_limit_box),
                  "sel_t": ms._select_requests(k_sel_t, B, first_pts.shape[1] + tmpl_pts.shape[1],
                                               t_size),
                  "sel_s": ms._select_requests(k_sel_s, B, srch_pts.shape[1], s_size)}, dev)
    if use_aug:
        srch_pts, srch_box = ms._augment(srch_pts, srch_valid, srch_box, wlh, d["aug"])

    off = prng.uniform_of(d["toff"][0], -0.3, 0.3)
    t_theta = off[:, 2] * 5.0 * ms._DEG2RAD if degrees else off[:, 2] * ms._DEG5
    tdx, tdy = _limit_redraw(d["tlim"], off[:, 0], off[:, 1], wlh)
    t_off4 = torch.stack([tdx, tdy, torch.zeros_like(tdx), t_theta], dim=-1)
    tmpl_ref = c.get_offset_box(tmpl_box, torch.where(cand0[:, None], 0.0, t_off4))

    m_half = _half(wlh, m_scale, m_offset)
    f_local, f_ok = ms._crop(first_pts, first_valid, first_box, m_half)
    t_local, t_ok = ms._crop(tmpl_pts, tmpl_valid, tmpl_ref, m_half)
    template_points = ms._select(torch.cat([f_local, t_local], dim=1),
                                 torch.cat([f_ok, t_ok], dim=1), t_size, d["sel_t"])

    g = prng.normal_of(d["koff"][0])
    g = torch.cat([g[:, :2], g[:, 2:] * ang_sd], dim=-1)
    s_theta = g[:, 2] * ms._DEG2RAD if degrees else g[:, 2]
    sdx, sdy = _limit_redraw(d["klim"], g[:, 0], g[:, 1], wlh)
    s_off4 = torch.stack([sdx, sdy, torch.zeros_like(sdx), s_theta], dim=-1)
    drawn_theta = g[:, 2]
    if num_candidates > 1:
        s_off4 = torch.where(cand0[:, None], 0.0, s_off4)
        drawn_theta = torch.where(cand0, 0.0, drawn_theta)
    sample_bb = c.get_offset_box(srch_box, s_off4)

    s_local, s_ok = ms._crop(srch_pts, srch_valid, sample_bb, _half(wlh, s_scale, s_offset))
    search_points = ms._select(s_local, s_ok, s_size, d["sel_s"])

    srch_local_box = c.transform_box_params(srch_box, sample_bb)
    canonical = torch.zeros(B, 4, dtype=template_points.dtype, device=dev)
    return {"template_points": template_points, "search_points": search_points,
            "box_label": torch.cat([srch_local_box[:, :3], -drawn_theta[:, None]], dim=-1),
            "bbox_size": wlh,
            "seg_label": points_in_box_strict(search_points, srch_local_box, wlh).float(),
            "points2cc_dist_t": c.box_cloud(template_points, canonical, wlh),
            "points2cc_dist_s": c.box_cloud(search_points, srch_local_box, wlh)}
