"""Batched, device-resident M2-Track tracker, port of
`open3dsot_tpu/tracking/scan_tracker.py` (M2 part).

The host loop (tracking/eval.py) builds each frame's input in numpy and
runs a batch-of-1 forward per frame. Here B tracklets move through their
frames together and every step of a frame stays on the device:

  crop (strict AABB in each ref-box frame)  ->  fixed-size resample
  ->  prior-targetness / timestamp channels (+ BoxCloud)  ->  forward (B)
  ->  4-DoF box composition  (the carry, one box per tracklet)

A batch's padded points and per-frame point counts go to the card once
(from pinned host memory, without blocking), and the loop over its frames
makes no host sync: the carry stays on the device and each frame's boxes
are written into a (B, T - 1, 4) device tensor. On the card the loop
replays one captured CUDA graph of the step per (B, P, n) shape; the eager
loop is what the graph is held to, and what the CPU runs. Scoring
(geometry/iou_device.py) runs on the device too, and `pipelined_scores`
keeps `depth` batches in flight while the host bins earlier ones.

The JAX package runs the frames as one `lax.scan`. Its limit-box redraw
'uniform' draws from `jax.random`, which utils/prng.py reproduces bit for
bit on the device. Resampling is the deterministic `_select_fixed`, so
trajectories differ from the host loop's seeded `np.random.choice` at the
decimal level, as on the JAX side. `_ScanTracker` and `_CapturedStep` hold
what this tracker shares with the matching one (tracking/scan_matching.py).
`M2ScanTracker(compute_dtype=torch.bfloat16)` tracks with a copy of the net
whose parameters and statistics are rounded to bf16 (JAX casts the whole
variable tree, scan_tracker.py:365-374) and which computes in bf16; the
step's batch goes in as bf16, and box composition and scoring stay f32.
The dataset loop takes the disk prep store (`prep_store_path`,
tracking/prep_store.py), the results writer (`results_writer`,
tracking/results.py) and `shard_across_processes` (each rank of the process
group tracks its stripe of the tracklets, and the metric states are summed
over the ranks, as the JAX package's).

`devices=[card, ...]` (the JAX scan trackers' `mesh=`) splits each batch
over several cards in one process: one part a card, each a tracker of its
own class on its card with its own model copy (`model_on`), bf16 copy and
captured graphs. A batch is padded to a multiple of the card count by
repeating its last tracklet (the padding's boxes are dropped), each part's
rows go to its card, and every card's frame loop is launched before
anything is fetched; the boxes (and `dispatch_scored`'s scores) come back on
the first card. A part at B / n gives an unsplit tracker's boxes at B / n bit
for bit. A multi-card eval can also run one rank a card (main.py
--num_devices).
"""

from __future__ import annotations

import contextlib
import copy
from collections import defaultdict, deque
from typing import List, Optional, Sequence

import numpy as np
import torch

from open3dsot_tpu_torch.geometry import rigid
from open3dsot_tpu_torch.geometry.data_classes import Box
from open3dsot_tpu_torch.geometry.iou import estimateAccuracy, estimateOverlap
from open3dsot_tpu_torch.geometry.quaternion import Quaternion
from open3dsot_tpu_torch.models.layers import set_compute_dtype, to_f32
from open3dsot_tpu_torch.models.pointnet import weights_key
from open3dsot_tpu_torch.ops.chain_fused import BF16, is_bf16
from open3dsot_tpu_torch.utils import prng, profiling
from open3dsot_tpu_torch.utils.quant import dequantize, quantize_per_sample

# The limit-box redraw's key, jax.random.PRNGKey(2) in the JAX package's scan steps
LIMIT_BOX_KEY = prng.prng_key(2)


def redraws_uniform(config) -> bool:
    """Whether limit_box redraws an overshooting x/y offset from U(-1, 1)
    (limit_box_redraw 'uniform', the default) rather than setting it to 0."""
    return bool(getattr(config, "limit_box", False)) and str(
        getattr(config, "limit_box_redraw", "uniform")) == "uniform"


def _select_fixed(points: torch.Tensor, valid: torch.Tensor, n: int,
                  mode: str = "strided") -> torch.Tensor:
    """Pick exactly n rows from the valid subset of (B, P, C) points, with
    the JAX package's indices.

    - 'strided' (default): downsampling takes evenly spaced valid rows in
      index order, upsampling cycles evenly through them. The k-th valid
      row is #{p : cs[p] <= k} for the running count cs of valid rows, which
      a binary search over the non-decreasing cs gives without the
      (B, P, n) compare that the JAX package reduces.
    - 'first': the first n valid rows, cyclic fill (a stable sort of the
      validity keys puts the valid rows first, in index order).

    Returns (B, n, C); an all-invalid row returns zeros.
    """
    B, P, C = points.shape
    count = valid.sum(dim=1, keepdim=True, dtype=torch.int32)  # (B, 1)
    capped = count.clamp(1, P)
    ar = torch.arange(n, dtype=torch.int32, device=points.device)[None, :]
    if mode == "strided":
        vpos = torch.where(capped >= n, (ar * capped) // n, ar % capped)
        cs = torch.cumsum(valid, dim=1, dtype=torch.int32)  # (B, P)
        idx = torch.searchsorted(cs, vpos, right=True).clamp(max=P - 1)
    else:
        iota = torch.arange(P, dtype=torch.int32, device=points.device)[None, :]
        key = torch.where(valid, iota, iota + P)
        order = torch.sort(key, dim=1, stable=True).values[:, : min(n, P)]
        pick = torch.clamp(ar % capped, max=order.shape[1] - 1)
        idx = torch.gather(order, 1, pick.long())
        idx = torch.where(idx < P, idx, 0)
    out = torch.gather(points, 1, idx.long()[..., None].expand(B, n, C))
    return torch.where(count[..., None] > 0, out, 0.0)


def nearest(d: np.ndarray, P: int) -> np.ndarray:
    """np.argsort(d, kind="stable")[:P] for P < len(d): the P smallest d,
    the lower index first among equal ones, in that order. A partition finds
    the P-th smallest value and only the P picked are sorted: 2-3 ms instead
    of 19 for the 120000 points of a LiDAR sweep."""
    t = d[np.argpartition(d, P - 1)[P - 1]]
    if np.isnan(t):
        return np.argsort(d, kind="stable")[:P]
    below = np.flatnonzero(d < t)
    sel = np.concatenate([below, np.flatnonzero(d == t)[: P - len(below)]])
    return sel[np.lexsort((sel, d[sel]))]


def pad_frame(p: np.ndarray, P: int):
    """Pad/truncate one frame's (N, 3) points to (P, 3) + validity mask.
    Frames larger than P keep the P points closest (L-inf) to the median."""
    p = np.asarray(p, np.float32).reshape(-1, 3)
    if len(p) > P:
        # the median and the L-inf distance of JAX's pad_frame, by contiguous columns
        cols = np.ascontiguousarray(p.T)
        center = np.median(cols, axis=1)
        d = np.abs(cols[0] - center[0])
        for k in (1, 2):
            np.maximum(d, np.abs(cols[k] - center[k]), out=d)
        p = p[nearest(d, P)]
    out = np.zeros((P, 3), np.float32)
    valid = np.zeros((P,), bool)
    out[: len(p)] = p
    valid[: len(p)] = True
    return out, valid


def _pack_transfer(transfer_dtype, pts, valid):
    """Host-side transfer packing of padded frame points: (pts,) as f32, or
    the ('int16') per-sample fixed-point triple (scale, off, q)."""
    if transfer_dtype is None:
        return (np.asarray(pts, np.float32),)
    q, scale, off = quantize_per_sample(pts, valid)
    return (scale, off, q)


def _counts(valid: np.ndarray) -> np.ndarray:
    """Per-frame valid-point counts of a PREFIX mask (what `pad_frame`
    writes); the device expands them back (`_expand_counts`). A non-prefix
    mask would come back as another valid set, so it is refused."""
    v = np.asarray(valid, bool)
    if v.shape[-1] > 1 and np.any(v[..., 1:] & ~v[..., :-1]):
        raise ValueError(
            "_counts: validity mask is not a prefix mask; the count encoding "
            "would change the valid set on device")
    return np.ascontiguousarray(v.sum(axis=-1, dtype=np.int32))


def _expand_counts(counts: torch.Tensor, P: int) -> torch.Tensor:
    """Inverse of `_counts` on the device: (...,) int32 -> (..., P) prefix mask."""
    return torch.arange(P, dtype=torch.int32, device=counts.device) < counts[..., None]


def _gt_arrays(sequences, T_pad: int, A_np):
    """Ground-truth (B, T_pad, 4) params + (B, T_pad, 3) wlh for scoring;
    padded frames repeat the last gt box."""
    B = len(sequences)
    gt_params = np.zeros((B, T_pad, 4), np.float32)
    gt_wlh = np.ones((B, T_pad, 3), np.float32)
    for b, seq in enumerate(sequences):
        for t, frame in enumerate(seq):
            gt = frame["3d_bbox"]
            theta = rigid.theta_from_rotation(gt.rotation_matrix, A_np)
            gt_params[b, t] = np.append(gt.center, theta)
            gt_wlh[b, t] = gt.wlh
        if len(seq) < T_pad:
            gt_params[b, len(seq):] = gt_params[b, len(seq) - 1]
            gt_wlh[b, len(seq):] = gt_wlh[b, len(seq) - 1]
    return gt_params, gt_wlh


def _make_scorer(config):
    """Whole-trajectory scorer on the device: (boxes (B, T-1, 4), init
    (B, 4), wlh (B, 3), gt_params (B, T, 4), gt_wlh (B, T, 3)) -> (iou,
    dist) (B, T). Frame 0 scores the first gt box against itself."""
    from open3dsot_tpu_torch.geometry.iou_device import overlap_accuracy, up_index

    dim = int(config.IoU_space)
    up_idx = up_index(config.up_axis)

    def score(boxes, init, wlh, gt_params, gt_wlh):
        preds = torch.cat([init[:, None, :], boxes], dim=1)
        pred_wlh = wlh if wlh.dim() == 3 else wlh[:, None, :].expand_as(gt_wlh)
        return overlap_accuracy(gt_params, gt_wlh, preds, pred_wlh, dim=dim, up_idx=up_idx)

    return score


def on_card(device: torch.device):
    """A context with `device` current where it is a card; nothing on the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def canonical_device(device) -> torch.device:
    """`device` as a torch.device, a card with its index ('cuda' is the
    current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def model_on(model, device):
    """The model wrapper with its net on `device`: itself where it is there,
    else a copy (the wrapper's attributes shared, the net copied)."""
    device = canonical_device(device)
    if canonical_device(model.device) == device:
        return model
    moved = copy.copy(model)
    moved.net = copy.deepcopy(model.net).to(device)
    moved.device = device
    return moved


def _fetch_async(*tensors: torch.Tensor):
    """Start copies of device tensors into pinned host buffers without
    blocking; returns the host tensors and an event recorded behind the
    copies (None for tensors already on the CPU)."""
    if tensors[0].device.type != "cuda":
        return (*tensors, None)
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    with on_card(tensors[0].device):
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
    return (*host, ready)


def pipelined_scores(tracker, batches, depth: int = 3, prep_cache=None):
    """Yield per-tracklet (ious, distances) with `depth` batches in flight:
    the host pads batch j and bins batch j - depth while the card tracks.
    A batch's (B, T) scores come back by non-blocking copies into pinned
    buffers, read only after their event has completed.

    prep_cache: optional dict; the packed host tensors of batch j are kept
    under ("prep", j) and reused on later calls over the same batches.
    """
    q: deque = deque()

    def drain():
        seqs, iou_h, dist_h, ready = q.popleft()
        if ready is not None:
            with profiling.annotate("scan.wait"):
                ready.synchronize()
        iou, dist = iou_h.numpy(), dist_h.numpy()
        for b, seq in enumerate(seqs):
            T = len(seq)
            yield iou[b, :T], dist[b, :T]

    for j, seqs in enumerate(batches):
        key = None if prep_cache is None else ("prep", j)
        q.append((list(seqs), *_fetch_async(*tracker.dispatch_scored(seqs, prep_cache, key))))
        if len(q) > depth:
            yield from drain()
    while q:
        yield from drain()


def make_m2_step(net, config, A, box_aware: bool, compute_dtype=None):
    """The single-frame M2-Track step on tensors (JAX make_m2_step):

        step(wlh, ref_box, prev_pts, prev_valid, this_pts, this_valid, step_idx) -> new_ref

    wlh (B, 3), ref_box (B, 4) world frame, points (B, P, 3) with (B, P)
    validity, step_idx a 0-d device tensor (the first step uses the hard
    prior-targetness, later ones the soft 0.8 / 0.2; it also keys the
    'uniform' limit-box redraw). Mirrors MotionBaseModel.build_input_dict +
    evaluate_one_sample (reference base_model.py:255-303, 44-57). `net` is
    the M2TrackNet, called directly. `compute_dtype` bf16: the forward's
    batch goes in as bf16 (JAX scan_tracker.py:321-323; `net` computes in
    bf16, see `rounded_net`) and its boxes come back f32.
    """
    cdt = BF16 if is_bf16(compute_dtype) else None
    resample = getattr(config, "scan_resample", "strided")
    n = config.point_sample_size
    scale, offset = float(config.bb_scale), float(config.bb_offset)
    use_z = bool(getattr(config, "use_z", True))
    limit_box = bool(getattr(config, "limit_box", False))
    lb_uniform = redraws_uniform(config)

    def step(wlh, ref_box, prev_pts, prev_valid, this_pts, this_valid, step_idx):
        B = ref_box.shape[0]
        # canonicalize both frames into each ref-box frame (generate_subwindow)
        half = (torch.stack([wlh[:, 1], wlh[:, 0], wlh[:, 2]], dim=-1) * (scale / 2.0)
                + offset)[:, None, :]

        def crop(pts, pad_valid):
            local = rigid.remove_transform_points(pts, ref_box, A=A)
            inside = ((local < half) & (local > -half)).all(dim=-1)
            return local, inside & pad_valid

        prev_sel = _select_fixed(*crop(prev_pts, prev_valid), n, mode=resample)  # (B, n, 3)
        this_sel = _select_fixed(*crop(this_pts, this_valid), n, mode=resample)

        canonical = prev_sel.new_zeros(B, 4)
        seg_mask_prev = rigid.points_in_box(prev_sel, canonical, wlh, 1.25).to(prev_sel.dtype)
        # soft prior-targetness after the first tracked frame (base_model.py:282-284)
        soft = torch.where(seg_mask_prev > 0.5, 0.8, 0.2).to(prev_sel.dtype)
        seg_mask_prev = torch.where(step_idx == 0, seg_mask_prev, soft)
        prev_stack = torch.cat([prev_sel, prev_sel.new_zeros(B, n, 1), seg_mask_prev[..., None]],
                               dim=-1)
        this_stack = torch.cat([this_sel, this_sel.new_full((B, n, 1), 0.1),
                                this_sel.new_full((B, n, 1), 0.5)], dim=-1)
        points = torch.cat([prev_stack, this_stack], dim=1)  # (B, 2n, 5)
        bc = None
        if box_aware:
            bc_prev = rigid.box_cloud(prev_sel, canonical, wlh)  # (B, n, 9)
            bc = torch.cat([bc_prev, torch.zeros_like(bc_prev)], dim=1)
        if cdt is not None:
            points, bc = points.to(cdt), None if bc is None else bc.to(cdt)
        with torch.no_grad():
            # box composition stays f32 whatever the compute dtype
            pred = to_f32(net(points, bc)["estimation_boxes"])
        if limit_box:  # reference points_utils.py:70-76
            # an overshooting x/y is redrawn from U(-1, 1) keyed on the step
            # ('uniform'), or set to 0 ('zero')
            redraw = None
            if lb_uniform:
                key = prng.fold_in(LIMIT_BOX_KEY, step_idx.reshape(-1).expand(B))
                redraw = prng.uniform(key, (2,), -1.0, 1.0)
            pred = rigid.limit_box_offset(pred, wlh, use_z, redraw=redraw)
        return rigid.get_offset_box(ref_box, pred, A=A)

    return step


class _CapturedStep:
    """One captured CUDA graph of `self._body()`, a step that reads and
    writes only the static buffers a subclass makes before calling this
    constructor. Warmed up twice on a side stream first, as torch.cuda.graph
    requires (and so that the kernels' first-use setup and the folded
    weights are done outside the capture), then captured on that stream,
    with `device` current (torch.cuda.graph's own capture stream is made
    once, on the card current at its first use). The kernel wrappers count
    their launches at capture: `launches` holds, for each wrapper of
    `counted`, its launches in one replay."""

    def __init__(self, device: torch.device, counted: Sequence) -> None:
        with profiling.annotate("graph.capture"), torch.cuda.device(device):
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                for _ in range(2):
                    self._body()
            torch.cuda.current_stream(device).wait_stream(side)
            before = [f.launches for f in counted]
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=side):
                self._body()
        self.launches = tuple(f.launches - b for f, b in zip(counted, before))

    def _body(self) -> None:
        raise NotImplementedError


class _StepGraph(_CapturedStep):
    """The M2 step for a (B, P) shape over its static buffers: a frame
    pair's points (B, 2, P, 3) and counts (B, 2), wlh, the step index, and
    the carry `ref`, which the graph updates in place; `launches` holds
    (K1, K2) of one replay."""

    def __init__(self, step, B: int, P: int, device: torch.device):
        from open3dsot_tpu_torch.ops import chain_fused as cf

        self.step = step
        self.pts = torch.zeros(B, 2, P, 3, device=device)
        self.counts = torch.zeros(B, 2, dtype=torch.int32, device=device)
        self.wlh = torch.ones(B, 3, device=device)
        self.ref = torch.zeros(B, 4, device=device)
        self.step_idx = torch.zeros((), dtype=torch.int64, device=device)
        super().__init__(device, (cf.fused_pointnet_encoder, cf.fused_seg_head))

    def _body(self) -> None:
        valid = _expand_counts(self.counts, self.pts.shape[2])
        new = self.step(self.wlh, self.ref, self.pts[:, 0], valid[:, 0], self.pts[:, 1],
                        valid[:, 1], self.step_idx)
        self.ref.copy_(new)


def _score(sequence, box_params, wlhs, config, A_np):
    """Host scoring of one tracklet: results_bbs is the first gt box, then
    each predicted (T - 1, 4) box with its wlh (`wlhs[t]`) -> (ious,
    distances, results_bbs)."""
    results_bbs = [sequence[0]["3d_bbox"]]
    for t in range(len(sequence) - 1):
        cx, cy, cz, th = (float(v) for v in box_params[t])
        results_bbs.append(
            Box([cx, cy, cz], np.asarray(wlhs[t]).tolist(),
                Quaternion(matrix=rigid.rotation_from_theta(th, A_np))))
    ious, distances = [], []
    for t, frame in enumerate(sequence):
        gt = frame["3d_bbox"]
        ious.append(estimateOverlap(gt, results_bbs[t], dim=config.IoU_space,
                                    up_axis=config.up_axis))
        distances.append(estimateAccuracy(gt, results_bbs[t], dim=config.IoU_space,
                                          up_axis=config.up_axis))
    return ious, distances, results_bbs


class _DeviceTracker:
    """What the scan trackers and the online ones (tracking/online.py) share:
    the transfer codec, the model's device and up frame, pinned host tensors,
    and captured graphs keyed on the weights. A subclass gives
    `_make_step(model)`. A tracker runs on `device` where it is given, else
    on its model's; a tracker with no model (a loaded serving bundle) keys
    its graphs on nothing: its weights never change."""

    def __init__(self, model, config, transfer_dtype, cuda_graph: bool, device=None):
        # 'int16' ships fixed-point frame points (half the H2D bytes,
        # dequantized on the device); None ships exact f32. Falls back to
        # config.transfer_quant when not given.
        if transfer_dtype is None:
            transfer_dtype = getattr(config, "transfer_quant", None)
        if transfer_dtype not in (None, "int16"):
            raise ValueError(f"transfer_dtype must be None or 'int16', got {transfer_dtype!r}")
        self.transfer_dtype = transfer_dtype
        self.config = config
        self.device = torch.device(device) if device is not None else model.device
        self._A = rigid.up_frame(config.up_axis, device=self.device)
        self._A_np = None if self._A is None else self._A.cpu().numpy()
        self.cuda_graph = cuda_graph and self.device.type == "cuda"
        self.model = None
        self.reset_graphs()
        if model is not None:
            self.set_model(model)

    def set_model(self, model) -> None:
        """Track with `model`'s net from now on (dropping captured graphs)."""
        self.model = model
        self._step = self._make_step(model)
        self.reset_graphs()

    def reset_graphs(self) -> None:
        self._graphs = {}
        self._graphs_weights = None
        self.replays = 0  # graph replays since the graphs were (re)captured

    def _captured(self, shape: tuple, make):
        """The captured step for `shape` (made by make()), captured anew after
        the weights changed (a graph keeps the folded weights it was captured
        with)."""
        key = None if self.model is None else weights_key(self.model.net)
        if key != self._graphs_weights:
            self.reset_graphs()
            self._graphs_weights = key
        if shape not in self._graphs:
            self._graphs[shape] = make()
        return self._graphs[shape]

    def graph_launches(self) -> dict:
        """The kernels' launches of the captured graphs: captured per replay x replays."""
        per = [g.launches for g in self._graphs.values()]
        return {"captured_per_replay": per, "replays": self.replays}

    def _host(self, *arrays) -> list:
        """numpy arrays as CPU tensors, in pinned memory when the tracker runs
        on the card (so that their copies to it need not block)."""
        out = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        return [t.pin_memory() for t in out] if self.device.type == "cuda" else out


class _ScanTracker(_DeviceTracker):
    """The host plumbing of the scan trackers (M2 here, BAT/P2B in
    tracking/scan_matching.py): padding and packing a batch into pinned
    host tensors, their copies to the device, the captured graphs keyed on
    the weights, on-device or host scoring.

    A subclass gives `_make_step(model)`, `track_frames(pts, counts, wlh,
    init, *extra[, gt_params, gt_wlh])` (the gt arrays when `gt_inputs`),
    `_extra_inputs(sequences)` (host arrays shipped after init) and
    `_frame_wlh(sequence)` (each predicted box's wlh, host scoring).

    `devices`: one device runs the tracker there; several split each batch
    over them (`parts`: a tracker of the subclass on each device, made with
    `part_kw`, the subclass's own arguments). A split tracker tracks
    through `track_batch` / `dispatch_scored` / the dataset loop; each part
    runs its own frame loop (`track_frames`) on its rows."""

    gt_inputs = False  # whether tracking reads the per-frame gt boxes

    def __init__(self, model, config, max_points: int, frame_bucket: int, transfer_dtype,
                 cuda_graph: bool, devices: Optional[Sequence] = None,
                 part_kw: Optional[dict] = None):
        self.max_points = max_points
        self.frame_bucket = frame_bucket
        self._scorer = None  # built lazily by dispatch_scored
        devices = [canonical_device(d) for d in devices or ()]
        # the devices a batch is split over (none: unsplit); set_model makes the
        # parts. One device other than the model's is a split into one part, so
        # that the tracker keeps the caller's model (the dataset loop's check).
        split = len(devices) > 1 or devices[:1] not in ([], [canonical_device(model.device)])
        self.devices, self._part_kw = (devices if split else []), part_kw
        self.parts = []
        super().__init__(model, config, transfer_dtype, cuda_graph,
                         self.devices[0] if self.devices else None)

    @property
    def cards(self) -> int:
        """The number of parts a batch is split into (1: unsplit)."""
        return max(1, len(self.parts))

    def set_model(self, model) -> None:
        """Track with `model`'s net from now on; a split tracker makes its
        parts anew, each with the model on its device."""
        if not self.devices:
            super().set_model(model)
            return
        self.model = model
        self.parts = [type(self)(model_on(model, d), self.config, **self._part_kw)
                      for d in self.devices]
        self._parts_key = weights_key(model.net)
        self.reset_graphs()

    def graph_launches(self) -> dict:
        """As _DeviceTracker's; a split tracker's over all its parts, with
        each part's own under "parts"."""
        if not self.parts:
            return super().graph_launches()
        parts = [p.graph_launches() for p in self.parts]
        return {"captured_per_replay": [c for p in parts for c in p["captured_per_replay"]],
                "replays": sum(p["replays"] for p in parts), "parts": parts}

    # --- host-side driver -------------------------------------------------
    def _bucket_len(self, T: int) -> int:
        return max(2, -(-T // self.frame_bucket) * self.frame_bucket)

    def _extra_inputs(self, sequences) -> tuple:
        return ()

    def _prepare(self, sequences: Sequence[list]):
        """Pad a tracklet batch and pack it for the transfer: (sequences,
        T_pad, host tensors [*packed points, counts, wlh, init, *extra]). A
        split tracker's batch is padded to a multiple of its card count by
        repeating the last tracklet (JAX scan_tracker.py:442-446)."""
        with profiling.annotate("scan.prepare"):
            sequences = list(sequences)
            sequences += sequences[-1:] * (-len(sequences) % self.cards)
            B = len(sequences)
            T_pad = max(self._bucket_len(len(s)) for s in sequences)
            P = self.max_points
            pts = np.zeros((B, T_pad, P, 3), np.float32)
            valid = np.zeros((B, T_pad, P), bool)
            wlh = np.zeros((B, 3), np.float32)
            init = np.zeros((B, 4), np.float32)
            for b, seq in enumerate(sequences):
                for t, frame in enumerate(seq):
                    pts[b, t], valid[b, t] = pad_frame(frame["pc"].points.T, P)
                first_box = seq[0]["3d_bbox"]
                wlh[b] = first_box.wlh
                theta0 = rigid.theta_from_rotation(first_box.rotation_matrix, self._A_np)
                init[b] = np.append(first_box.center, theta0)
            host = self._host(*_pack_transfer(self.transfer_dtype, pts, valid), _counts(valid),
                              wlh, init, *self._extra_inputs(sequences))
            return sequences, T_pad, host

    def _on_device(self, host: list) -> list:
        """A batch's host tensors -> [pts f32, counts, wlh, init, *extra] on
        the device, by non-blocking copies; int16 points are dequantized there."""
        dev = [t.to(self.device, non_blocking=True) for t in host]
        if self.transfer_dtype is None:
            return dev
        scale, off, q, *rest = dev
        return [dequantize(q, scale, off), *rest]

    def _dispatch(self, host: list, gt: list):
        """Copy a batch to the device and track it: -> (boxes, wlh, init,
        gt on the device). A split tracker hands each part its rows and
        brings the boxes back to the first card."""
        if self.parts:
            k = 1 if self.transfer_dtype is None else 3  # host: [*packed points, counts, wlh, init, ...]
            wlh, init, *gt_dev = (t.to(self.device, non_blocking=True)
                                  for t in (host[k + 1], host[k + 2], *gt))
            return self._track_split(host, gt if self.gt_inputs else []), wlh, init, gt_dev
        with on_card(self.device):
            pts, counts, wlh, init, *extra = self._on_device(host)
            gt_dev = [t.to(self.device, non_blocking=True) for t in gt]
            boxes = self.track_frames(pts, counts, wlh, init, *extra,
                                      *(gt_dev if self.gt_inputs else ()))
        return boxes, wlh, init, gt_dev

    def _track_split(self, host: list, gt: list) -> torch.Tensor:
        """Each part's rows of the batch copied to its card and tracked there,
        every part's frame loop launched before any box is fetched; -> the
        (B, T - 1, 4) boxes on the first card. The parts are made anew
        first where the model's weights have changed (a part with a copy of
        the model would keep the old ones)."""
        if weights_key(self.model.net) != self._parts_key:
            self.set_model(self.model)
        b = host[0].shape[0] // len(self.parts)
        boxes = []
        for i, part in enumerate(self.parts):
            rows = slice(i * b, (i + 1) * b)
            boxes.append(part._dispatch([t[rows] for t in host], [t[rows] for t in gt])[0])
        return torch.cat([x.to(self.device, non_blocking=True) for x in boxes])

    def _gt_host(self, sequences, T_pad: int) -> list:
        return self._host(*_gt_arrays(sequences, T_pad, self._A_np))

    def track_batch(self, sequences: Sequence[list]) -> List[np.ndarray]:
        """Run B tracklets (same padded length bucket) as one batch.

        Returns a list of (T_i - 1, 4) world-frame box parameter arrays.
        """
        n = len(sequences)
        sequences, T_pad, host = self._prepare(sequences)
        gt = self._gt_host(sequences, T_pad) if self.gt_inputs else []
        boxes = self._dispatch(host, gt)[0].cpu().numpy()
        return [boxes[b, : len(seq) - 1] for b, seq in enumerate(sequences[:n])]

    def _pred_wlh(self, wlh: torch.Tensor, gt_wlh: torch.Tensor) -> torch.Tensor:
        """The predicted boxes' wlh for the scorer: (B, 3), or (B, T, 3)."""
        return wlh

    def dispatch_scored(self, sequences: Sequence[list], prep_cache=None, cache_key=None):
        """Track AND score a batch on the device; no host sync.

        Returns (iou, dist) (B, T_pad) device tensors (slice [b, :len(seq)]
        per tracklet; a split tracker's B is padded, its scores on the first
        card). prep_cache/cache_key: optional dict + key caching the packed
        host tensors across calls (the caller owns invalidation).
        """
        if prep_cache is not None and cache_key in prep_cache:
            host, gt = prep_cache[cache_key]
        else:
            sequences, T_pad, host = self._prepare(sequences)
            gt = self._gt_host(sequences, T_pad)
            if prep_cache is not None:
                prep_cache[cache_key] = (host, gt)
        boxes, wlh, init, (gt_params, gt_wlh) = self._dispatch(host, gt)
        if self._scorer is None:
            self._scorer = _make_scorer(self.config)
        with profiling.annotate("scan.score"):
            return self._scorer(boxes, init, self._pred_wlh(wlh, gt_wlh), gt_params, gt_wlh)

    def _frame_wlh(self, sequence) -> list:
        """Each predicted box's wlh: the first box's (getOffsetBB copies the
        anchor's wlh, and the chain's anchor keeps the first box's)."""
        return [sequence[0]["3d_bbox"].wlh] * (len(sequence) - 1)

    def evaluate_one_sequence(self, sequence, config):
        return self.evaluate_sequences([sequence], config)[0]

    def evaluate_sequences(self, sequences, config):
        """Batched tracking + host scoring; returns list of (ious, distances, boxes)."""
        all_boxes = self.track_batch(sequences)
        return [_score(seq, boxes, self._frame_wlh(seq), config, self._A_np)
                for seq, boxes in zip(sequences, all_boxes)]


def rounded_net(net: torch.nn.Module, dtype) -> torch.nn.Module:
    """A copy of `net` in eval mode with its parameters and buffers rounded
    to `dtype` (bf16), computing in it: JAX's scan tracker casts the whole
    variable tree, BatchNorm statistics too."""
    copied = copy.deepcopy(net).eval()
    with torch.no_grad():
        copied.to(dtype)
    return set_compute_dtype(copied, dtype)


class M2ScanTracker(_ScanTracker):
    """Batched tracker for M2-Track (B tracklets per batch) on the model's
    device, or split over `devices` (JAX `mesh=`; _ScanTracker). `cuda_graph`
    (the default) replays a captured step on the card; False runs the eager
    loop there too. A capture that fails raises. `compute_dtype`
    torch.bfloat16 tracks with `rounded_net(model.net)`, made again whenever
    the model's weights change (by each part of a split tracker: a part
    keeps its own rounded copy)."""

    def __init__(self, model, config, max_points: int = 4096, frame_bucket: int = 16,
                 compute_dtype=None, transfer_dtype=None, cuda_graph: bool = True,
                 devices: Optional[Sequence] = None):
        self.compute_dtype = BF16 if is_bf16(compute_dtype) else None
        self.box_aware = bool(getattr(config, "box_aware", False))
        part_kw = dict(max_points=max_points, frame_bucket=frame_bucket,
                       compute_dtype=compute_dtype, transfer_dtype=transfer_dtype,
                       cuda_graph=cuda_graph)
        super().__init__(model, config, max_points, frame_bucket, transfer_dtype, cuda_graph,
                         devices, part_kw)

    def _make_step(self, model):
        net = model.net
        if self.compute_dtype is not None:
            self._rounded_key = weights_key(model.net)
            net = rounded_net(model.net, self.compute_dtype)
        return make_m2_step(net, self.config, self._A, self.box_aware, self.compute_dtype)

    def _refresh_rounded(self) -> None:
        """Round the weights again after the model's changed (the captured
        graphs are dropped then too: they key on the same weights)."""
        if self.compute_dtype is not None and weights_key(self.model.net) != self._rounded_key:
            self._step = self._make_step(self.model)

    # --- the frame loop (device) --------------------------------------------
    def _graph_for(self, B: int, P: int) -> _StepGraph:
        """The captured step for (B, P)."""
        return self._captured((B, P), lambda: _StepGraph(self._step, B, P, self.device))

    def track_frames(self, pts: torch.Tensor, counts: torch.Tensor, wlh: torch.Tensor,
                     init: torch.Tensor) -> torch.Tensor:
        """pts (B, T, P, 3) f32, counts (B, T) int32 valid-prefix lengths,
        wlh (B, 3), init (B, 4), all on the device -> predicted world boxes
        (B, T - 1, 4) on the device. No host sync."""
        self._refresh_rounded()
        B, T, P, _ = pts.shape
        with profiling.annotate("scan.frame_loop", card=self.device.index, B=B, T=T):
            boxes = pts.new_empty(B, T - 1, 4)
            steps = torch.arange(T - 1, device=pts.device)
            if self.cuda_graph:
                g = self._graph_for(B, P)
                g.ref.copy_(init)
                g.wlh.copy_(wlh)
                for t in range(T - 1):
                    g.pts.copy_(pts[:, t:t + 2])
                    g.counts.copy_(counts[:, t:t + 2])
                    g.step_idx.copy_(steps[t])
                    with profiling.annotate("graph.replay"):
                        g.graph.replay()
                    boxes[:, t].copy_(g.ref)
                self.replays += T - 1
                return boxes
            valid = _expand_counts(counts, P)
            ref = init
            for t in range(T - 1):
                ref = self._step(wlh, ref, pts[:, t], valid[:, t], pts[:, t + 1], valid[:, t + 1],
                                 steps[t])
                boxes[:, t] = ref
            return boxes


def evaluate_dataset_scan(model, test_sampler, config, max_points: int = 4096,
                          batch_tracklets: int = 16, max_tracklets: Optional[int] = None,
                          tracker: Optional[M2ScanTracker] = None, device_metrics: bool = True,
                          pipeline_depth: int = 3, prep_cache: Optional[dict] = None,
                          prep_store_path: Optional[str] = None, results_writer=None,
                          shard_across_processes: bool = False):
    """Scan-tracker dataset evaluation; returns (success, precision).

    Tracklets are grouped into same-length-bucket batches of up to
    `batch_tracklets`. Pass a prebuilt `tracker` to reuse its captured
    graphs across calls; it tracks with `model` from then on.
    device_metrics=True (default) scores on the device with
    `pipeline_depth` batches in flight; False is the serial host-scored loop
    (fetch boxes, clip polygons per frame). prep_cache: optional dict (the
    same one with the same sampler and arguments each call) caching the
    batching and the packed host tensors.

    prep_store_path: optional directory of a disk-backed packed prep cache
    (tracking/prep_store.py): later evals, in any process, skip dataset
    decode and padding; fingerprint-checked against the config, tracker
    and batching. Ignored when prep_cache is given.

    results_writer: optional tracking.results.ResultsWriter; each
    tracklet's trajectory and per-frame scores are written (host-scored,
    in tracklet order; the prep store is not used then).

    shard_across_processes: each rank of the process group tracks
    tracklets rank, rank + world, ... (tracking/eval.py::tracklet_stripe),
    its prep store in a directory of its own, and the metric states are
    summed over the ranks at the end.
    """
    if tracker is None:
        tracker = M2ScanTracker(model, config, max_points=max_points)
    return evaluate_with_tracker(tracker, model, test_sampler, config, batch_tracklets,
                                 max_tracklets, device_metrics, pipeline_depth, prep_cache,
                                 prep_store_path, results_writer, shard_across_processes)


def evaluate_with_tracker(tracker: _ScanTracker, model, test_sampler, config,
                          batch_tracklets: int, max_tracklets: Optional[int],
                          device_metrics: bool, pipeline_depth: int, prep_cache: Optional[dict],
                          prep_store_path: Optional[str] = None, results_writer=None,
                          shard_across_processes: bool = False):
    """The dataset loop of evaluate_dataset_scan and
    scan_matching.evaluate_dataset_scan_matching on a built tracker, which
    tracks with `model` from then on; -> (success, precision)."""
    from open3dsot_tpu_torch.tracking.eval import merge_process_metrics
    from open3dsot_tpu_torch.utils.metrics import Precision, Success

    if tracker.model is not model:
        tracker.set_model(model)
    success, precision = Success(), Precision()
    n = len(test_sampler)
    if max_tracklets is not None:
        n = min(n, max_tracklets)
    if results_writer is not None:
        # results-saving mode: order-preserving index batches, host-scored
        # (the writer needs the Box trajectories on the host anyway)
        if prep_store_path is not None:
            print("[scan eval] --eval_prep_cache is ignored with "
                  "--save_results: the writer path needs real host frames, "
                  "which a warm PackedPrepStore does not hold")
        _scan_eval_with_writer(tracker, test_sampler, config, n, batch_tracklets,
                               results_writer, success, precision, shard_across_processes)
        merge_process_metrics(success, precision, shard_across_processes, tracker.device)
        return success.compute(), precision.compute()
    if prep_cache is None and prep_store_path is not None:
        from open3dsot_tpu_torch.tracking.prep_store import eval_store

        prep_cache = eval_store(prep_store_path, config, tracker, n, batch_tracklets,
                                shard_across_processes)
    if not device_metrics and getattr(prep_cache, "stub_sequences", False):
        # host-scored paths need real frames; a warm PackedPrepStore only
        # has length stubs: ignore it rather than crash on stub access
        prep_cache = None
    if prep_cache is not None and "batches" in prep_cache:
        batches = prep_cache["batches"]
    else:
        batches = _bucketed_batches(test_sampler, n, tracker, batch_tracklets,
                                    shard_across_processes)
        if prep_cache is not None:
            prep_cache["batches"] = batches
    if device_metrics:
        for ious, distances in pipelined_scores(tracker, batches, depth=pipeline_depth,
                                                prep_cache=prep_cache):
            success.update(ious)
            precision.update(distances)
    else:
        for batch in batches:
            for ious, distances, _ in tracker.evaluate_sequences(batch, config):
                success.update(ious)
                precision.update(distances)
    merge_process_metrics(success, precision, shard_across_processes, tracker.device)
    return success.compute(), precision.compute()


def _bucketed_batches(test_sampler, n, tracker, batch_tracklets, shard_across_processes=False):
    """Group this rank's tracklets below n into same-length-bucket batches."""
    from open3dsot_tpu_torch.tracking.eval import tracklet_stripe

    buckets = defaultdict(list)
    for i in tracklet_stripe(n, shard_across_processes):
        seq = test_sampler[i]
        buckets[tracker._bucket_len(len(seq))].append(seq)
    return [
        seqs[j: j + batch_tracklets]
        for _, seqs in sorted(buckets.items())
        for j in range(0, len(seqs), batch_tracklets)
    ]


def _scan_eval_with_writer(tracker, test_sampler, config, n, batch_tracklets, results_writer,
                           success, precision, shard_across_processes=False) -> None:
    """The results-saving loop of both scan trackers: consecutive batches of
    this rank's tracklet indices (true tracklet ids in the records),
    host-scored via tracker.evaluate_sequences so that the Box trajectories
    exist on the host."""
    from open3dsot_tpu_torch.tracking.eval import tracklet_stripe

    idxs = list(tracklet_stripe(n, shard_across_processes))
    for j in range(0, len(idxs), batch_tracklets):
        ids = idxs[j:j + batch_tracklets]
        batch = [test_sampler[i] for i in ids]
        for i, (ious, distances, bbs) in zip(ids, tracker.evaluate_sequences(batch, config)):
            results_writer.add(i, bbs, ious, distances)
            success.update(ious)
            precision.update(distances)
