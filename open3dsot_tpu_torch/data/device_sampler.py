"""Training samples built on the device, port of
`open3dsot_tpu/data/device_sampler.py`.

The host samplers (data/sampler.py) build every sample with numpy: on the
card that host work, not the train step, sets the pace of `Trainer.fit`.
Here the host only pads raw frames to fixed shapes and walks the
(anno, candidate) indices (`RawMotionSampler`, `RawSiameseSampler`); the
crop, canonicalisation, random resampling, labels, soft masks and BoxClouds
run batched on the device (`make_motion_builder`, `make_siamese_builder`)
with threefry draws (utils/prng.py) keyed by the caller, so the same raw
batch and key give JAX's draws: the same offsets, flips and resampled rows
as JAX's builders, and outputs equal to theirs up to float32 rounding. A
build splits its key on the host as JAX does, then makes all of its draws
in one threefry pass on the device (`_draw`): each draw alone would cost
some 170 elementwise kernels.

A builder is `build(raw, key) -> batch`: `raw` a dict of tensors on the
device (the collated raw samples), `key` a threefry key of Python ints; the
builder's up basis `A` (geometry/rigid.py::up_frame) lies on that device.
The batch has the dtypes of the models' `device_batch`: floats float32,
M2-Track's integer labels int64. It makes no host sync.

Semantics (as the JAX module): every deterministic step mirrors
`motion_processing` / `siamese_processing`; the random draws are
distribution-equivalent to the host's numpy stream, not stream-equivalent.
A cropped region with few points keeps its sample (zero-padded crop) where
the host sampler would draw a new index; frames larger than
`max_raw_points` keep the points nearest the box center.
"""

from __future__ import annotations

import numpy as np
import torch

from open3dsot_tpu_torch.geometry import points_utils, rigid
from open3dsot_tpu_torch.utils import prng
from open3dsot_tpu_torch.utils.quant import dequantize, quantize_per_sample

_DEG2RAD = float(np.float32(np.pi / 180.0))  # jnp.deg2rad's float32 constant
_RAD2DEG = float(np.float32(180.0 / np.pi))
_DEG5 = float(np.float32(np.deg2rad(5.0)))


# ---------------------------------------------------------------------------
# device-side pieces
# ---------------------------------------------------------------------------

def first_smallest(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest keys of each row, equal keys in index order
    (`jax.lax.top_k` of the negated keys; `torch.topk` orders ties as it
    likes)."""
    return torch.sort(keys, dim=1, stable=True)[1][:, :k]


def _draw(requests: dict, device, rows=None) -> dict:
    """name -> a list of (key, shape) requests  =>  name -> their bits, all
    made in one threefry pass (prng.bits_many); `rows` (lo, hi): only those
    rows of each draw are kept."""
    flat = [r for rs in requests.values() for r in rs]
    made = iter(prng.bits_many(flat, device) if flat else [])
    if rows is not None:
        made = (t[rows[0]:rows[1]] for t in made)
    return {name: [next(made) for _ in rs] for name, rs in requests.items()}


def _draw_batch(B: int, shard):
    """(the batch the draws are made for, the rows kept of them): a builder
    under `shard` = (rank, n) builds rows [rank * B, (rank + 1) * B) of a
    global batch of n * B, and draws for all of it as JAX's GSPMD build
    does, so that its rows are that build's, bit for bit."""
    if shard is None:
        return B, None
    rank, n = shard
    return B * n, (rank * B, (rank + 1) * B)


def _select_requests(key, B: int, P: int, n: int) -> list:
    k_u, k_r = prng.split(key)
    return [(k_u, (B, P))] + prng.randint_requests(k_r, (B, n))


def _select(points: torch.Tensor, valid: torch.Tensor, n: int, draws: list) -> torch.Tensor:
    B, P, _ = points.shape
    k = min(n, P)
    count = valid.sum(dim=1, keepdim=True)  # (B, 1)
    iota = torch.arange(P, device=points.device).expand(B, P)

    # the first k valid positions in index order (past P where fewer)
    order_n = torch.sort(torch.where(valid, iota, iota + P), dim=1)[0][:, :k].clamp_max(P - 1)
    if n > P:
        order_n = torch.cat([order_n, order_n[:, :1].expand(B, n - P)], dim=1)

    # without replacement: the n smallest random keys among the valid rows
    idx_wo = first_smallest(torch.where(valid, prng.uniform_of(draws[0]), 2.0), k)
    if n > P:  # degenerate: m > n cannot hold then
        idx_wo = torch.cat([idx_wo, idx_wo[:, :1].expand(B, n - P)], dim=1)

    # with replacement: r_j ~ U[0, m), the j-th draw takes the r_j-th valid row
    r = prng.randint_of(draws[1], draws[2], 0, count.clamp_min(1))
    idx_wr = order_n.gather(1, r.clamp_max(k - 1))

    idx = torch.where(count > n, idx_wo, torch.where(count == n, order_n, idx_wr))
    sel = points.gather(1, idx[..., None].expand(B, n, points.shape[2]))
    return torch.where(count[..., None] > 2, sel, 0.0)


def random_select(points: torch.Tensor, valid: torch.Tensor, n: int, key) -> torch.Tensor:
    """np.random.choice-like fixed-shape resampling (B, P, C) -> (B, n, C) of
    the valid rows (regularize_pc's regimes, as torch.where over the batch):
      m > n  : n of them at random, without replacement;
      m == n : all of them in index order;
      m < n  : n uniform draws with replacement;
      m <= 2 : zeros (the reference's fallback).
    """
    B, P, _ = points.shape
    return _select(points, valid, n, prng.bits_many(_select_requests(key, B, P, n), points.device))


def _augment_requests(key, B: int) -> list:
    k_t, k_rot, k_fx, k_fy = prng.split(key, 4)
    return [(k_t, (B, 3)), (k_rot, (B,)), (k_fx, (B,)), (k_fy, (B,))]


def _augment(pts, valid, box, wlh, draws: list, A=None):
    """apply_augmentation (points_utils.py) on the device: flip, rotate and
    translate the in-box (factor 1.25) points in the box frame.

    pts (B, P, 3), box (B, 4) -> (new_pts, new_box). Per batch element: t ~
    U(-0.3, 0.3)^3, alpha ~ U(-10, 10) degrees, flips ~ Bernoulli(0.5);
    `draws` the bits of `_augment_requests`.
    """
    t = prng.uniform_of(draws[0], -0.3, 0.3)
    alpha = prng.uniform_of(draws[1], -10.0, 10.0) * _DEG2RAD
    flip_x, flip_y = prng.bernoulli_of(draws[2], 0.5), prng.bernoulli_of(draws[3], 0.5)

    mask = rigid.points_in_box(pts, box, wlh, 1.25, A=A) & valid
    local = rigid.remove_transform_points(pts, box, A=A)
    lx = torch.where(flip_x[:, None], -local[..., 0], local[..., 0])
    ly = torch.where(flip_y[:, None], -local[..., 1], local[..., 1])
    local = torch.stack([lx, ly, local[..., 2]], dim=-1)
    local = rigid._rotate(local, rigid.rotz(alpha)) + t[:, None, :]
    moved = rigid.apply_transform_points(local, box, A=A)
    new_pts = torch.where(mask[..., None], moved, pts)

    # box: theta += pi * flip_x + alpha (flip_y leaves the box, as in the
    # reference); the center moves by t in the box frame; theta wrapped into
    # (-pi, pi] as the host's quaternion angle
    theta_off = torch.where(flip_x, float(np.float32(np.pi)), 0.0) + alpha
    new_box = rigid.get_offset_box(box, torch.cat([t, theta_off[:, None]], dim=-1), A=A)
    return new_pts, torch.cat([new_box[:, :3], rigid.wrap_angle(new_box[:, 3:])], dim=-1)


def _limit_requests(key, B: int, data_limit_box: bool) -> list:
    if not data_limit_box:
        return []
    k_x, k_y = prng.split(key)
    return [(k_x, (B,)), (k_y, (B,))]


def _limit_redraw(draws: list, dx, dy, wlh):
    """getOffsetBB's limit_box redraw (points_utils.py) with device draws
    (`_limit_requests`' bits; none without data_limit_box): an x / y offset
    past the box (positive overshoot only, the reference's quirk) becomes
    U(-1, 1)."""
    if not draws:
        return dx, dy
    dx = torch.where(dx > wlh[:, 0], prng.uniform_of(draws[0], -1.0, 1.0), dx)
    dy = torch.where(dy > wlh[:, 1].clamp_max(2.0), prng.uniform_of(draws[1], -1.0, 1.0), dy)
    return dx, dy


def _ref_offset_requests(key, B: int, data_limit_box: bool) -> list:
    k_o, k_rx, k_ry = prng.split(key, 3)
    return [(k_o, (B, 3))] + ([(k_rx, (B,)), (k_ry, (B,))] if data_limit_box else [])


def _draw_ref_offset(draws: list, degrees: bool, wlh, candidate_zero: torch.Tensor):
    """sample_offsets + getOffsetBB (sampler.py): a 3-DoF (dx, dy, dtheta)
    offset, 0 for candidate 0; with data_limit_box (two more draws) the
    limit_box redraw from U(-1, 1)."""
    off = prng.uniform_of(draws[0], -0.3, 0.3)
    theta = off[:, 2] * 5.0 * _DEG2RAD if degrees else off[:, 2] * _DEG5
    dx, dy = _limit_redraw(draws[1:], off[:, 0], off[:, 1], wlh)
    offset4 = torch.stack([dx, dy, torch.zeros_like(dx), theta], dim=-1)
    return torch.where(candidate_zero[:, None], 0.0, offset4)


def _half_extent(wlh, scale: float, offset: float) -> torch.Tensor:
    """(B, 3) half extents of generate_subwindow's strict AABB in the box
    frame: (l, w, h) * scale / 2 + offset."""
    return torch.stack([wlh[:, 1], wlh[:, 0], wlh[:, 2]], dim=-1) * (scale / 2.0) + offset


def _crop(pts, valid, box, half, A=None):
    """Points canonicalised into `box`'s frame and their membership of the
    strict AABB `half` (generate_subwindow)."""
    local = rigid.remove_transform_points(pts, box, A=A)
    h = half[:, None, :]
    return local, ((local < h) & (local > -h)).all(dim=-1) & valid


def make_motion_builder(config, A=None, shard=None):
    """build(raw, key) -> an M2-Track batch, the device twin of
    motion_processing (JAX device_sampler.py:148-266); `shard` as in
    `_draw_batch`."""
    n = int(config.point_sample_size)
    scale = float(config.bb_scale)
    offset = float(config.bb_offset)
    degrees = bool(config.degrees)
    data_limit_box = bool(getattr(config, "data_limit_box", False))
    use_aug = bool(getattr(config, "use_augmentation", False))
    box_aware = bool(getattr(config, "box_aware", False))
    motion_threshold = float(getattr(config, "motion_threshold", 0.15))

    def build(raw: dict, key) -> dict:
        prev_pts, prev_valid = raw["prev_pts"], raw["prev_valid"]  # (B, P, 3), (B, P)
        this_pts, this_valid = raw["this_pts"], raw["this_valid"]
        prev_box, this_box = raw["prev_box"], raw["this_box"]  # (B, 4) world (c, theta)
        wlh, cand0 = raw["wlh"], raw["candidate_zero"]  # (B, 3), (B,)
        (B, P, _), dev = prev_pts.shape, prev_pts.device
        Bd, rows = _draw_batch(B, shard)

        k_aug_p, k_aug_t, k_off, k_sel_p, k_sel_t = prng.split(key, 5)
        d = _draw({"aug_p": _augment_requests(k_aug_p, Bd) if use_aug else [],
                   "aug_t": _augment_requests(k_aug_t, Bd) if use_aug else [],
                   "off": _ref_offset_requests(k_off, Bd, data_limit_box),
                   "sel_p": _select_requests(k_sel_p, Bd, P, n),
                   "sel_t": _select_requests(k_sel_t, Bd, this_pts.shape[1], n)}, dev, rows)
        if use_aug:
            prev_pts, prev_box = _augment(prev_pts, prev_valid, prev_box, wlh, d["aug_p"], A=A)
            this_pts, this_box = _augment(this_pts, this_valid, this_box, wlh, d["aug_t"], A=A)

        off4 = _draw_ref_offset(d["off"], degrees, wlh, cand0)
        ref_box = rigid.get_offset_box(prev_box, off4, A=A)

        # subwindow crop and canonicalisation of both frames around ref_box
        half = _half_extent(wlh, scale, offset)
        prev_local, prev_ok = _crop(prev_pts, prev_valid, ref_box, half, A=A)
        this_local, this_ok = _crop(this_pts, this_valid, ref_box, half, A=A)
        prev_sel = _select(prev_local, prev_ok, n, d["sel_p"])  # (B, n, 3)
        this_sel = _select(this_local, this_ok, n, d["sel_t"])

        # boxes in the ref frame (transform_box)
        this_local_box = rigid.transform_box_params(this_box, ref_box, A=A)
        prev_local_box = rigid.transform_box_params(prev_box, ref_box, A=A)
        canonical = torch.zeros(B, 4, dtype=prev_sel.dtype, device=dev)  # ref in its own frame
        motion_box = rigid.transform_box_params(this_box, prev_box, A=A)

        # local-frame quantities: no A basis (the ref-box frame is z-up)
        seg_label_this = rigid.points_in_box(this_sel, this_local_box, wlh, 1.25)
        seg_label_prev = rigid.points_in_box(prev_sel, prev_local_box, wlh, 1.25)
        seg_mask_prev = rigid.points_in_box(prev_sel, canonical, wlh, 1.25).float()
        soft = torch.where(seg_mask_prev > 0.5, 0.8, 0.2)
        seg_mask_prev = torch.where(cand0[:, None], seg_mask_prev, soft)
        seg_mask_this = torch.full((B, n), 0.5, device=dev)

        ts_prev = torch.zeros(B, n, 1, device=dev)
        ts_this = torch.full((B, n, 1), 0.1, device=dev)
        points = torch.cat([torch.cat([prev_sel, ts_prev, seg_mask_prev[..., None]], -1),
                            torch.cat([this_sel, ts_this, seg_mask_this[..., None]], -1)],
                           dim=1)  # (B, 2n, 5)

        def params4(b):  # box_to_params: theta signed about +z
            return torch.cat([b[:, :3], b[:, 3:4] * _RAD2DEG if degrees else b[:, 3:4]], dim=-1)

        shift = this_local_box[:, :3] - prev_local_box[:, :3]
        motion_state = torch.sqrt((shift * shift).sum(dim=-1)) > motion_threshold
        batch = {
            "points": points,
            "box_label": params4(this_local_box),
            "box_label_prev": params4(prev_local_box),
            "motion_label": params4(motion_box),
            "motion_state_label": motion_state.long(),
            "bbox_size": wlh,
            "seg_label": torch.cat([seg_label_prev, seg_label_this], dim=1).long(),
        }
        if box_aware:
            cand_bc_prev = rigid.box_cloud(prev_sel, canonical, wlh)
            batch.update(prev_bc=rigid.box_cloud(prev_sel, prev_local_box, wlh),
                         this_bc=rigid.box_cloud(this_sel, this_local_box, wlh),
                         candidate_bc=torch.cat([cand_bc_prev, torch.zeros_like(cand_bc_prev)],
                                                dim=1))
        return batch

    return build


def make_siamese_builder(config, A=None, shard=None):
    """build(raw, key) -> a BAT / P2B batch, the device twin of
    siamese_processing (JAX device_sampler.py:375-495): perturbed-template
    merge, Kalman search offset, subwindow crop, strict seg labels, the
    4-DoF target, BoxClouds; `shard` as in `_draw_batch`."""
    t_size = int(config.template_size)
    s_size = int(config.search_size)
    m_scale, m_offset = float(config.model_bb_scale), float(config.model_bb_offset)
    s_scale, s_offset = float(config.search_bb_scale), float(config.search_bb_offset)
    degrees = bool(config.degrees)
    data_limit_box = bool(getattr(config, "data_limit_box", False))
    use_aug = bool(getattr(config, "use_augmentation", False))
    box_aware = bool(getattr(config, "box_aware", False))
    num_candidates = int(getattr(config, "num_candidates", 1))
    # the fresh Kalman state's N(0, diag(1, 1, ang_var)): sqrt(ang_var) in float32
    ang_sd = float(np.sqrt(np.float32(5.0 if degrees else np.deg2rad(5.0))))

    def build(raw: dict, key) -> dict:
        first_pts, first_valid = raw["first_pts"], raw["first_valid"]
        tmpl_pts, tmpl_valid = raw["template_pts"], raw["template_valid"]
        srch_pts, srch_valid = raw["search_pts"], raw["search_valid"]
        first_box, tmpl_box, srch_box = raw["first_box"], raw["template_box"], raw["search_box"]
        wlh, cand0 = raw["wlh"], raw["candidate_zero"]
        B, dev = first_pts.shape[0], first_pts.device
        Bd, rows = _draw_batch(B, shard)

        k_aug, k_toff, k_tlim, k_koff, k_klim, k_sel_t, k_sel_s = prng.split(key, 7)
        d = _draw({"aug": _augment_requests(k_aug, Bd) if use_aug else [],
                   "toff": [(k_toff, (Bd, 3))],
                   "tlim": _limit_requests(k_tlim, Bd, data_limit_box),
                   "koff": [(k_koff, (Bd, 3))],
                   "klim": _limit_requests(k_klim, Bd, data_limit_box),
                   "sel_t": _select_requests(k_sel_t, Bd, first_pts.shape[1] + tmpl_pts.shape[1],
                                             t_size),
                   "sel_s": _select_requests(k_sel_s, Bd, srch_pts.shape[1], s_size)}, dev, rows)
        if use_aug:  # the search frame only (PointTrackingSampler.__getitem__)
            srch_pts, srch_box = _augment(srch_pts, srch_valid, srch_box, wlh, d["aug"], A=A)

        # the template's gt-offset draw
        off = prng.uniform_of(d["toff"][0], -0.3, 0.3)
        t_theta = off[:, 2] * 5.0 * _DEG2RAD if degrees else off[:, 2] * _DEG5
        tdx, tdy = _limit_redraw(d["tlim"], off[:, 0], off[:, 1], wlh)
        t_off4 = torch.stack([tdx, tdy, torch.zeros_like(tdx), t_theta], dim=-1)
        tmpl_ref = rigid.get_offset_box(tmpl_box, torch.where(cand0[:, None], 0.0, t_off4), A=A)

        # template = the first frame's crop and the perturbed template crop, resampled
        m_half = _half_extent(wlh, m_scale, m_offset)
        f_local, f_ok = _crop(first_pts, first_valid, first_box, m_half, A=A)
        t_local, t_ok = _crop(tmpl_pts, tmpl_valid, tmpl_ref, m_half, A=A)
        template_points = _select(torch.cat([f_local, t_local], dim=1),
                                  torch.cat([f_ok, t_ok], dim=1), t_size, d["sel_t"])

        # the search offset: N(0, diag(1, 1, ang_var)); candidate 0 is
        # unperturbed only when num_candidates > 1
        g = prng.normal_of(d["koff"][0])
        g = torch.cat([g[:, :2], g[:, 2:] * ang_sd], dim=-1)
        s_theta = g[:, 2] * _DEG2RAD if degrees else g[:, 2]
        sdx, sdy = _limit_redraw(d["klim"], g[:, 0], g[:, 1], wlh)
        s_off4 = torch.stack([sdx, sdy, torch.zeros_like(sdx), s_theta], dim=-1)
        drawn_theta = g[:, 2]
        if num_candidates > 1:
            s_off4 = torch.where(cand0[:, None], 0.0, s_off4)
            drawn_theta = torch.where(cand0, 0.0, drawn_theta)
        sample_bb = rigid.get_offset_box(srch_box, s_off4, A=A)

        s_local, s_ok = _crop(srch_pts, srch_valid, sample_bb, _half_extent(wlh, s_scale, s_offset),
                              A=A)
        search_points = _select(s_local, s_ok, s_size, d["sel_s"])

        # labels: the box center in the sample_bb frame and the NEGATED drawn
        # offset in config units (the model regresses the un-perturbation)
        srch_local_box = rigid.transform_box_params(srch_box, sample_bb, A=A)
        batch = {
            "template_points": template_points,
            "search_points": search_points,
            "box_label": torch.cat([srch_local_box[:, :3], -drawn_theta[:, None]], dim=-1),
            "bbox_size": wlh,
            "seg_label": rigid.points_in_box(search_points, srch_local_box, wlh, 1.0,
                                             strict=True).float(),
        }
        if box_aware:  # local-frame quantities: no A basis
            canonical = torch.zeros(B, 4, dtype=template_points.dtype, device=dev)
            batch["points2cc_dist_t"] = rigid.box_cloud(template_points, canonical, wlh)
            batch["points2cc_dist_s"] = rigid.box_cloud(search_points, srch_local_box, wlh)
        return batch

    return build


# ---------------------------------------------------------------------------
# host-side raw batchers
# ---------------------------------------------------------------------------

class _RawFrames:
    """What both raw samplers share: the up basis and the padding of a frame."""

    def __init__(self, dataset, config, max_raw_points: int):
        self.dataset = dataset
        self.config = config
        self.P = int(max_raw_points)
        A = rigid.up_frame(config.up_axis)
        self._A_np = None if A is None else A.numpy()

    def _box4(self, box) -> np.ndarray:
        theta = rigid.theta_from_rotation(box.rotation_matrix, self._A_np)
        return np.append(box.center, theta).astype(np.float32)

    def _pad(self, pc, center) -> tuple:
        """(P, 3) points and (P,) validity; a larger frame keeps the P points
        nearest `center`."""
        p = pc.points.T.astype(np.float32)
        if len(p) > self.P:
            d = np.linalg.norm(p - center[None, :3], axis=1)
            p = p[np.argsort(d, kind="stable")[: self.P]]
        out = np.zeros((self.P, 3), np.float32)
        out[: len(p)] = p
        valid = np.zeros((self.P,), bool)
        valid[: len(p)] = True
        return out, valid


class RawMotionSampler(_RawFrames):
    """The host side of the motion builder: MotionTrackingSampler's
    (anno, candidate) walk, returning raw fixed-shape frames and box params.
    The > 10 target points check runs here (cached per anno) with the
    reference's draw of a new anno on failure."""

    def __init__(self, dataset, config, max_raw_points: int = 2048):
        super().__init__(dataset, config, max_raw_points)
        self.num_candidates = int(getattr(config, "num_candidates", 4))
        lens = [dataset.get_num_frames_tracklet(i) for i in range(dataset.get_num_tracklets())]
        self._starts = np.cumsum([0] + lens)
        self.num_annos = int(self._starts[-1])
        self._ok_cache: dict = {}

    def __len__(self):
        return self.num_annos * self.num_candidates

    def _locate(self, anno_id: int):
        tracklet_id = int(np.searchsorted(self._starts, anno_id, side="right") - 1)
        this_id = anno_id - self._starts[tracklet_id]
        return tracklet_id, [0, max(this_id - 1, 0), this_id]

    def _target_ok(self, anno_id: int, prev_frame) -> bool:
        hit = self._ok_cache.get(anno_id)
        if hit is None:
            cnt = points_utils.points_in_box(prev_frame["3d_bbox"], prev_frame["pc"].points).sum()
            hit = self._ok_cache[anno_id] = bool(cnt > 10)
        return hit

    def __getitem__(self, index: int) -> dict:
        anno_id = index // self.num_candidates
        candidate_id = index % self.num_candidates
        for _ in range(64):  # the resample loop (sampler.py)
            tracklet_id, frame_ids = self._locate(anno_id)
            _, prev_frame, this_frame = self.dataset.get_frames(tracklet_id, frame_ids=frame_ids)
            if self._target_ok(anno_id, prev_frame):
                break
            anno_id = int(np.random.randint(0, self.num_annos))
        prev_box = self._box4(prev_frame["3d_bbox"])
        this_box = self._box4(this_frame["3d_bbox"])
        prev_pts, prev_valid = self._pad(prev_frame["pc"], prev_box)
        this_pts, this_valid = self._pad(this_frame["pc"], prev_box)
        return {
            "prev_pts": prev_pts, "prev_valid": prev_valid,
            "this_pts": this_pts, "this_valid": this_valid,
            "prev_box": prev_box, "this_box": this_box,
            "wlh": prev_frame["3d_bbox"].wlh.astype(np.float32),
            "candidate_zero": np.bool_(candidate_id == 0),
        }


class RawSiameseSampler(_RawFrames):
    """The host side of the siamese builder: PointTrackingSampler's
    (anno, candidate) walk returning raw fixed-shape first, template and
    search frames and their box params."""

    def __init__(self, dataset, config, max_raw_points: int = 2048):
        super().__init__(dataset, config, max_raw_points)
        self.num_candidates = int(getattr(config, "num_candidates", 1))
        self.random_sample = bool(getattr(config, "random_sample", False))
        self.sample_per_epoch = int(getattr(config, "sample_per_epoch", 10000))
        if not self.random_sample:
            lens = [dataset.get_num_frames_tracklet(i) for i in range(dataset.get_num_tracklets())]
            self._starts = np.cumsum([0] + lens)

    def __len__(self):
        if self.random_sample:
            return self.sample_per_epoch * self.num_candidates
        return int(self._starts[-1]) * self.num_candidates

    def __getitem__(self, index: int) -> dict:
        anno_id = index // self.num_candidates
        candidate_id = index % self.num_candidates
        if self.random_sample:
            tracklet_id = int(np.random.randint(0, self.dataset.get_num_tracklets()))
            n_frames = len(self.dataset.tracklet_anno_list[tracklet_id])
            frame_ids = [0] + list(np.random.choice(n_frames, size=2, replace=False))
        else:
            tracklet_id = int(np.searchsorted(self._starts, anno_id, side="right") - 1)
            this_id = anno_id - self._starts[tracklet_id]
            frame_ids = [0, max(this_id - 1, 0), this_id]
        first, tmpl, srch = self.dataset.get_frames(tracklet_id, frame_ids=frame_ids)
        out = {}
        for name, frame in (("first", first), ("template", tmpl), ("search", srch)):
            box4 = self._box4(frame["3d_bbox"])
            out[f"{name}_pts"], out[f"{name}_valid"] = self._pad(frame["pc"], box4)
            out[f"{name}_box"] = box4
        out["wlh"] = first["3d_bbox"].wlh.astype(np.float32)
        out["candidate_zero"] = np.bool_(candidate_id == 0)
        return out


# ---------------------------------------------------------------------------
# int16 raw-frame transfer (config.transfer_quant)
# ---------------------------------------------------------------------------
#
# With the device builders the host-to-device traffic of a step is the raw
# padded frames. transfer_quant 'int16' packs every *_pts key per sample on
# the host (utils/quant.py) and the builder dequantises it on the device
# before the build, so the labels come from the dequantised points.

RAW_POINT_KEYS = ("prev_pts", "this_pts", "first_pts", "template_pts", "search_pts")


def pack_raw_batch(batch: dict) -> dict:
    """Host side: int16-pack every raw points key of a collated batch."""
    out = dict(batch)
    for k in RAW_POINT_KEYS:
        if k in out:
            q, scale, off = quantize_per_sample(np.asarray(out[k]),
                                                np.asarray(out[k[:-4] + "_valid"]))
            out[k], out[k + "_qscale"], out[k + "_qoff"] = q, scale, off
    return out


def dequant_builder(builder):
    """A builder that takes int16-packed raw batches: it dequantises them on
    the device, then builds."""

    def wrapped(raw: dict, key) -> dict:
        raw = dict(raw)
        for k in RAW_POINT_KEYS:
            if k + "_qscale" in raw:
                raw[k] = dequantize(raw[k], raw.pop(k + "_qscale"), raw.pop(k + "_qoff"))
        return builder(raw, key)

    return wrapped


def make_builder(config, train_type: str, A=None, shard=None):
    """The builder of `train_type` ('train_motion' or 'train_siamese'), with
    the int16 dequantisation under `transfer_quant`; `shard` (rank, n): the
    rank's rows of a global batch (`_draw_batch`)."""
    make = {"train_motion": make_motion_builder, "train_siamese": make_siamese_builder}[train_type]
    build = make(config, A=A, shard=shard)
    return dequant_builder(build) if getattr(config, "transfer_quant", None) else build
