"""Batched, device-resident tracker for the matching models (P2B, BAT),
port of `open3dsot_tpu/tracking/scan_matching.py`.

B tracklets move through their frames together, and every part of a frame
stays on the device (reference base_model.py:166-247, 44-57):

  template: the first frame's crop (cropped once on the host) and/or the
  previous frame cropped around the carried box, canonical to it, merged
  and resampled to template_size (`shape_aggregation`)
  ->  search: the current frame cropped around the carried box (or the gt
  box in the gt `reference_BB` modes), resampled to search_size
  ->  BAT: the template BoxCloud against the canonical box
  ->  forward (K3 x2 and K4 x7 for BAT, K4 x7 for P2B)
  ->  argmax-objectness proposal composed onto the reference box

Modes, as the JAX package's: shape_aggregation 'firstandprevious', 'first',
'previous' and 'all' ('all' carries a key reservoir of every earlier
frame's crop, `template_pool` points a tracklet: under capacity the merged
cloud itself, on overflow a uniform subsample of it); reference_BB
'previous_result', 'previous_gt' and 'current_gt'; `degrees`, `use_z`,
`limit_box` with both redraws, and the camera basis (`up_axis [0, -1, 0]`).
The reservoir's priorities and the 'uniform' redraws are JAX's threefry
draws (utils/prng.py), so the port tracks as the JAX package does.

On the card the frame loop replays one captured CUDA graph of the step per
batch shape; the eager loop is what the graph is held to, and what the CPU
runs. Host plumbing, scoring and the dataset loop are shared with the M2
tracker (tracking/scan_tracker.py). A model made under `bf16: true` runs in
its bf16 mode inside the graph as it does eagerly (the JAX tracker has no
compute_dtype of its own here). The dataset loop takes the disk prep store,
the results writer and `shard_across_processes` as the M2 tracker's does.
`devices=[card, ...]` (the JAX tracker's `mesh=`) splits each batch over
several cards in one process as the M2 tracker's does: each part keeps its
own carry ('all' reservoir included), first crops and gt inputs. The
reservoir's and the redraw's draws are keyed on each row's age, not on its
place in the batch, so a part tracks its rows as JAX's shard_map does.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from open3dsot_tpu_torch.geometry import points_utils, rigid
from open3dsot_tpu_torch.tracking.scan_tracker import (
    LIMIT_BOX_KEY,
    _CapturedStep,
    _expand_counts,
    _ScanTracker,
    _select_fixed,
    evaluate_with_tracker,
    redraws_uniform,
)
from open3dsot_tpu_torch.utils import prng, profiling

# The 'all' reservoir's priority key, jax.random.PRNGKey(1) in the JAX package
POOL_KEY = prng.prng_key(1)
REF_MODES = ("previous_result", "previous_gt", "current_gt")


def parse_agg_mode(shape_aggregation: str) -> str:
    """shape_aggregation with the reference's substring precedence
    (base_model.py:177-194): firstandprevious > first > previous > all."""
    agg = shape_aggregation.upper()
    for mode in ("firstandprevious", "first", "previous", "all"):
        if mode.upper() in agg:
            return mode
    raise ValueError(f"unknown shape_aggregation {shape_aggregation!r} (expected "
                     f"firstandprevious/first/previous/all)")


def parse_ref_mode(reference_BB: str) -> str:
    """reference_BB by substring (base_model.py:208-216)."""
    ref = reference_BB.upper()
    for mode in REF_MODES:
        if mode.upper() in ref:
            return mode
    raise ValueError(f"unknown reference_BB {reference_BB!r} (expected one of {REF_MODES})")


def make_match_step(net, config, A, is_bat: bool, agg_mode: str, gt_mode: bool):
    """The single-frame P2B/BAT step on tensors (JAX make_match_step):

        step(first_pts, first_valid, carry, xs) -> (carry, new_ref)

    first_pts (B, P1, 3) the first frame's canonical crop with its (B, P1)
    validity; carry = (ref_box (B, 4), ref_wlh (B, 3)), plus (pool_pts
    (B, C, 3), pool_key (B, C) f32, age (B,) int32) under agg_mode 'all',
    or (age,) under limit_box with the 'uniform' redraw; xs = (prev_pts,
    prev_valid, this_pts, this_valid[, gt_box (B, 4), gt_wlh (B, 3)]),
    points (B, P, 3) with (B, P) validity, the gt anchor in the gt modes.
    ref_box / ref_wlh are the results_bbs chain's box and dimensions:
    getOffsetBB copies the anchor's wlh onto each prediction, so the chain
    keeps the first box's wlh under previous_result and takes each gt
    anchor's in the gt modes; the template crop and BoxCloud use the
    carried wlh. `net` is the BATNet or P2BNet, called directly.
    """
    m_scale, m_offset = float(config.model_bb_scale), float(config.model_bb_offset)
    s_scale, s_offset = float(config.search_bb_scale), float(config.search_bb_offset)
    t_size, s_size = int(config.template_size), int(config.search_size)
    resample = getattr(config, "scan_resample", "strided")
    degrees, use_z = bool(config.degrees), bool(config.use_z)
    limit_box = bool(getattr(config, "limit_box", False))
    lb_uniform = redraws_uniform(config)
    need_age = agg_mode == "all" or lb_uniform

    def crop_local(pts, pad_valid, ref_box, half):
        local = rigid.remove_transform_points(pts, ref_box, A=A)
        inside = ((local < half[:, None, :]) & (local > -half[:, None, :])).all(dim=-1)
        return local, inside & pad_valid

    def step(first_pts, first_valid, carry, xs):
        if agg_mode == "all":
            ref_box, carry_wlh, pool_pts, pool_key, age = carry
        elif need_age:
            ref_box, carry_wlh, age = carry
        else:
            ref_box, carry_wlh = carry
        prev_pts, prev_valid, this_pts, this_valid = xs[:4]
        B = ref_box.shape[0]
        half_wlh = torch.stack([carry_wlh[:, 1], carry_wlh[:, 0], carry_wlh[:, 2]], dim=-1) / 2.0

        # the template crops use the carried prediction in every reference_BB mode
        m_half = half_wlh * m_scale + m_offset
        if agg_mode == "first":
            template = _select_fixed(first_pts, first_valid, t_size, mode=resample)
        else:
            prev_local, prev_ok = crop_local(prev_pts, prev_valid, ref_box, m_half)
            if agg_mode == "previous":
                template = _select_fixed(prev_local, prev_ok, t_size, mode=resample)
            elif agg_mode == "all":
                # every crop point draws a uniform priority keyed on the row's
                # age and the pool keeps the top C keys (-inf: an empty slot);
                # a stable descending sort gives lax.top_k's order on ties
                C = pool_pts.shape[1]
                u = prng.uniform(prng.fold_in(POOL_KEY, age), (prev_pts.shape[1],))
                allk = torch.cat([pool_key, torch.where(prev_ok, u, -math.inf)], dim=1)
                allp = torch.cat([pool_pts, prev_local], dim=1)
                order = torch.sort(allk, dim=1, descending=True, stable=True)
                pool_key, topi = order.values[:, :C], order.indices[:, :C]
                pool_pts = torch.gather(allp, 1, topi[..., None].expand(B, C, 3))
                # descending keys put the valid points first: a prefix mask
                template = _select_fixed(pool_pts, pool_key > -math.inf, t_size, mode=resample)
            else:  # firstandprevious: the first crop and the previous one
                template = _select_fixed(torch.cat([first_pts, prev_local], dim=1),
                                         torch.cat([first_valid, prev_ok], dim=1), t_size,
                                         mode=resample)

        # the search area: around the carried box, or the gt anchor in the gt modes
        if gt_mode:
            search_ref, ref_wlh = xs[4], xs[5]
            s_half_wlh = torch.stack([ref_wlh[:, 1], ref_wlh[:, 0], ref_wlh[:, 2]], dim=-1) / 2.0
        else:
            search_ref, s_half_wlh = ref_box, half_wlh
        s_half = s_half_wlh * s_scale + s_offset
        this_local, this_ok = crop_local(this_pts, this_valid, search_ref, s_half)
        search = _select_fixed(this_local, this_ok, s_size, mode=resample)

        with torch.no_grad():
            if is_bat:
                # the template BoxCloud against the canonical box with the carried dims
                bc = rigid.box_cloud(template, template.new_zeros(B, 4), carry_wlh)
                boxes = net(template, search, bc)["estimation_boxes"]
            else:
                boxes = net(template, search)["estimation_boxes"]  # (B, K, 5)
        best = torch.argmax(boxes[:, :, 4], dim=1)  # the first maximal proposal
        est = torch.gather(boxes, 1, best[:, None, None].expand(B, 1, boxes.shape[2]))[:, 0, :4]
        theta = est[:, 3] * (math.pi / 180.0) if degrees else est[:, 3]
        dz = est[:, 2] if use_z else torch.zeros_like(est[:, 2])
        offset = torch.stack([est[:, 0], est[:, 1], dz, theta], dim=-1)
        if limit_box:  # reference points_utils.py:70-76
            redraw = None
            if lb_uniform:  # keyed on the age before this step's increment
                redraw = prng.uniform(prng.fold_in(LIMIT_BOX_KEY, age), (2,), -1.0, 1.0)
            offset = rigid.limit_box_offset(offset, ref_wlh if gt_mode else carry_wlh, use_z,
                                            redraw=redraw)
        # composed onto the search reference box, whose wlh the prediction inherits
        new_ref = rigid.get_offset_box(search_ref, offset, A=A)
        new_wlh = ref_wlh if gt_mode else carry_wlh
        if agg_mode == "all":
            return (new_ref, new_wlh, pool_pts, pool_key, age + 1), new_ref
        if need_age:
            return (new_ref, new_wlh, age + 1), new_ref
        return (new_ref, new_wlh), new_ref

    return step


class _MatchStepGraph(_CapturedStep):
    """The matching step for a (B, P, P1[, C]) shape over its static
    buffers: a frame pair's points (B, 2, P, 3) and counts (B, 2), the first
    crop (B, P1, 3) and its count (B,), the carry (its first entry the box),
    which the graph updates in place, and the gt anchor in the gt modes;
    `launches` holds (K3, K4) of one replay."""

    def __init__(self, step, B: int, P: int, P1: int, carry0: tuple, gt_mode: bool,
                 device: torch.device):
        from open3dsot_tpu_torch.ops import sa_fused, sampling

        self.step = step
        self.pts = torch.zeros(B, 2, P, 3, device=device)
        self.counts = torch.zeros(B, 2, dtype=torch.int32, device=device)
        self.first_pts = torch.zeros(B, P1, 3, device=device)
        self.first_count = torch.zeros(B, dtype=torch.int32, device=device)
        self.carry = [torch.zeros_like(c) for c in carry0]
        self.gt = [torch.zeros(B, 4, device=device), torch.ones(B, 3, device=device)] \
            if gt_mode else []
        super().__init__(device, (sampling.furthest_point_sample, sa_fused.fused_sa_apply))

    def _body(self) -> None:
        valid = _expand_counts(self.counts, self.pts.shape[2])
        first_valid = _expand_counts(self.first_count, self.first_pts.shape[1])
        xs = (self.pts[:, 0], valid[:, 0], self.pts[:, 1], valid[:, 1], *self.gt)
        new, _ = self.step(self.first_pts, first_valid, tuple(self.carry), xs)
        for buf, value in zip(self.carry, new):
            buf.copy_(value)


class MatchScanTracker(_ScanTracker):
    """Batched tracker for P2B/BAT (B tracklets per batch) on the model's
    device, or split over `devices` (JAX `mesh=`; scan_tracker._ScanTracker),
    in every shape_aggregation and reference_BB mode. `cuda_graph` (the
    default) replays a captured step on the card; False runs the eager loop
    there too. A capture that fails raises."""

    def __init__(self, model, config, max_points: int = 4096, first_crop_points: int = 1024,
                 frame_bucket: int = 16, transfer_dtype=None, template_pool: int = 4096,
                 cuda_graph: bool = True, devices: Optional[Sequence] = None):
        self._agg_mode = parse_agg_mode(config.shape_aggregation)
        self._ref_mode = parse_ref_mode(config.reference_BB)
        self.gt_inputs = self._ref_mode != "previous_result"
        # the gt anchor of step t: frame t's box (previous_gt) or frame t + 1's (current_gt)
        self._gt_shift = int(self._ref_mode == "current_gt")
        self._lb_uniform = redraws_uniform(config)
        self.first_crop_points = first_crop_points
        self.template_pool = int(getattr(config, "template_pool", template_pool))
        self.is_bat = model.name == "bat"
        part_kw = dict(max_points=max_points, first_crop_points=first_crop_points,
                       frame_bucket=frame_bucket, transfer_dtype=transfer_dtype,
                       template_pool=template_pool, cuda_graph=cuda_graph)
        super().__init__(model, config, max_points, frame_bucket, transfer_dtype, cuda_graph,
                         devices, part_kw)

    def _make_step(self, model):
        return make_match_step(model.net, self.config, self._A, self.is_bat, self._agg_mode,
                               self.gt_inputs)

    def _extra_inputs(self, sequences) -> tuple:
        """The first frame's template crop around its gt box (constant per
        tracklet), cut to first_crop_points: (first_pts, first_count)."""
        cfg, P1 = self.config, self.first_crop_points
        first_pts = np.zeros((len(sequences), P1, 3), np.float32)
        first_count = np.zeros((len(sequences),), np.int32)
        for b, seq in enumerate(sequences):
            crop, _ = points_utils.cropAndCenterPC(seq[0]["pc"], seq[0]["3d_bbox"],
                                                   scale=cfg.model_bb_scale,
                                                   offset=cfg.model_bb_offset)
            fp = crop.points.T.astype(np.float32)[:P1]
            first_pts[b, : len(fp)] = fp
            first_count[b] = len(fp)
        return first_pts, first_count

    def _carry0(self, init: torch.Tensor, wlh: torch.Tensor) -> tuple:
        """The carry before the first step; the 'all' reservoir starts empty."""
        B = init.shape[0]
        if self._agg_mode == "all":
            C = self.template_pool
            return (init, wlh, init.new_zeros(B, C, 3),
                    torch.full((B, C), -math.inf, device=init.device),
                    torch.zeros(B, dtype=torch.int32, device=init.device))
        if self._lb_uniform:
            return init, wlh, torch.zeros(B, dtype=torch.int32, device=init.device)
        return init, wlh

    # --- the frame loop (device) --------------------------------------------
    def _graph_for(self, B: int, P: int, P1: int, carry0: tuple) -> _MatchStepGraph:
        """The captured step for (B, P, P1), and the pool's C under 'all'."""
        shape = (B, P, P1) + ((self.template_pool,) if self._agg_mode == "all" else ())
        return self._captured(shape, lambda: _MatchStepGraph(self._step, B, P, P1, carry0,
                                                             self.gt_inputs, self.device))

    def track_frames(self, pts: torch.Tensor, counts: torch.Tensor, wlh: torch.Tensor,
                     init: torch.Tensor, first_pts: torch.Tensor, first_count: torch.Tensor,
                     gt_params: Optional[torch.Tensor] = None,
                     gt_wlh: Optional[torch.Tensor] = None) -> torch.Tensor:
        """pts (B, T, P, 3) f32, counts (B, T) int32 valid-prefix lengths,
        wlh (B, 3), init (B, 4), the first crop (B, P1, 3) and its count (B,),
        and in the gt modes the gt boxes (B, T, 4) and wlh (B, T, 3), all on
        the device -> predicted world boxes (B, T - 1, 4) on the device. No
        host sync."""
        B, T, P, _ = pts.shape
        with profiling.annotate("scan.frame_loop", card=self.device.index, B=B, T=T):
            boxes = pts.new_empty(B, T - 1, 4)
            carry = self._carry0(init, wlh)
            sh = self._gt_shift
            if self.cuda_graph:
                g = self._graph_for(B, P, first_pts.shape[1], carry)
                g.first_pts.copy_(first_pts)
                g.first_count.copy_(first_count)
                for buf, value in zip(g.carry, carry):
                    buf.copy_(value)
                for t in range(T - 1):
                    g.pts.copy_(pts[:, t:t + 2])
                    g.counts.copy_(counts[:, t:t + 2])
                    if g.gt:
                        g.gt[0].copy_(gt_params[:, t + sh])
                        g.gt[1].copy_(gt_wlh[:, t + sh])
                    with profiling.annotate("graph.replay"):
                        g.graph.replay()
                    boxes[:, t].copy_(g.carry[0])
                self.replays += T - 1
                return boxes
            valid = _expand_counts(counts, P)
            first_valid = _expand_counts(first_count, first_pts.shape[1])
            for t in range(T - 1):
                xs = (pts[:, t], valid[:, t], pts[:, t + 1], valid[:, t + 1])
                if self.gt_inputs:
                    xs += (gt_params[:, t + sh], gt_wlh[:, t + sh])
                carry, boxes[:, t] = self._step(first_pts, first_valid, carry, xs)
            return boxes

    # --- scoring ------------------------------------------------------------
    def _pred_wlh(self, wlh: torch.Tensor, gt_wlh: torch.Tensor) -> torch.Tensor:
        """Frame 0 keeps the first box's wlh; in the gt modes each prediction
        takes its gt anchor's (B, T, 3)."""
        if not self.gt_inputs:
            return wlh
        anchors = gt_wlh[:, :-1] if self._ref_mode == "previous_gt" else gt_wlh[:, 1:]
        return torch.cat([wlh[:, None], anchors], dim=1)

    def _frame_wlh(self, sequence) -> list:
        if not self.gt_inputs:
            return super()._frame_wlh(sequence)
        return [sequence[t + self._gt_shift]["3d_bbox"].wlh for t in range(len(sequence) - 1)]


def evaluate_dataset_scan_matching(model, test_sampler, config, max_points: int = 4096,
                                   batch_tracklets: int = 8, max_tracklets: Optional[int] = None,
                                   tracker: Optional[MatchScanTracker] = None,
                                   device_metrics: bool = True, pipeline_depth: int = 3,
                                   prep_cache: Optional[dict] = None,
                                   prep_store_path: Optional[str] = None, results_writer=None,
                                   shard_across_processes: bool = False):
    """Scan-tracker dataset evaluation of P2B/BAT; returns (success,
    precision). Arguments as scan_tracker.evaluate_dataset_scan's. A config
    the scan tracker cannot serve (an unknown reference_BB or
    shape_aggregation, an unsupported up_axis) raises, naming the setting,
    where the JAX package falls back to its host loop: run
    tracking/eval.py (`--tracker host`) for it."""
    if tracker is None:
        tracker = MatchScanTracker(model, config, max_points=max_points)
    return evaluate_with_tracker(tracker, model, test_sampler, config, batch_tracklets,
                                 max_tracklets, device_metrics, pipeline_depth, prep_cache,
                                 prep_store_path, results_writer, shard_across_processes)
