"""Online (streaming) tracking, port of `open3dsot_tpu/tracking/online.py`:
the serving-side counterpart of the scan trackers.

A deployed tracker receives frames one at a time, for many objects at once.
Here:

- a fixed pool of `max_streams` slots, so that one step of a static
  (B, P, 3) shape advances every active stream;
- the recurrent state (carried box, previous frame, per-slot frame counter
  or age, template buffers) stays on the device; a `step()` ships only
  each slot's new frame (padded, with its point count) and returns 4 floats
  a slot;
- the step is the one the scan trackers run (`make_m2_step`,
  `make_match_step`), so online trajectories equal the scan trackers' bit
  for bit at the same B and P;
- on the card, the step replays one captured CUDA graph of the advance
  over the state buffers, updated in place, and the static input buffers
  (`cuda_graph`, the default; False runs the same body eagerly, which the
  graph is held to and which the CPU runs). A capture that fails raises.
- a slot's reset is eager in-place writes of its rows (no graph, no
  program).

`make_online_tracker(..., devices=[card, ...])` (JAX `mesh=`, the slot
axis sharded over a device mesh) splits the pool into one sub-pool a card,
each a tracker of max_streams / n slots with its own state, model copy and
captured graph (`SplitOnlineTracker`); `step()` launches every card's
advance before it fetches any box. The slot count must divide by the
number of cards, as the mesh's device count must in JAX. A tracker runs its
advance (the graph's capture and replay, or the eager kernels) with its
own card current.

Matching models online take reference_BB 'previous_result' only (the gt
modes need per-frame ground truth, which does not exist at serving time);
all four shape_aggregation modes run ('all' keeps its per-slot key
reservoir as state).

A bf16 model (`bf16: true`, or a net set to bf16 by
layers.py::set_compute_dtype) serves in its bf16 mode: the advance runs the
net as the scan trackers run it (K1/K2 in their bf16 mode for M2, K3 and K4
bf16 for BAT/P2B), in one captured graph as in f32, so its boxes equal the
scan trackers' with the same model at the same B bit for bit; the state
and the boxes stay f32. `compute_mode` says which mode a tracker serves
in ('float32' or 'bfloat16').
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from open3dsot_tpu_torch.geometry import points_utils, rigid
from open3dsot_tpu_torch.geometry.data_classes import PointCloud
from open3dsot_tpu_torch.models.layers import computes_in_bf16
from open3dsot_tpu_torch.ops import chain_fused, sa_fused, sampling
from open3dsot_tpu_torch.tracking.scan_matching import (
    make_match_step,
    parse_agg_mode,
    parse_ref_mode,
)
from open3dsot_tpu_torch.tracking.scan_tracker import (
    _CapturedStep,
    _DeviceTracker,
    _counts,
    _expand_counts,
    _pack_transfer,
    make_m2_step,
    model_on,
    on_card,
    pad_frame,
    redraws_uniform,
)
from open3dsot_tpu_torch.utils import profiling
from open3dsot_tpu_torch.utils.quant import dequantize

# The wrappers whose launches a captured advance counts: K1, K2, K3, K4
COUNTED = (chain_fused.fused_pointnet_encoder, chain_fused.fused_seg_head,
           sampling.furthest_point_sample, sa_fused.fused_sa_apply)


def input_buffers(B: int, P: int, transfer_dtype, device) -> list:
    """A step's inputs as the advance takes them, zeroed: (points (B, P, 3),
    counts (B,)), or ('int16') (scale (B,), off (B, 3), q (B, P, 3) int16,
    counts (B,))."""
    counts = torch.zeros(B, dtype=torch.int32, device=device)
    if transfer_dtype is None:
        return [torch.zeros(B, P, 3, device=device), counts]
    return [torch.ones(B, device=device), torch.zeros(B, 3, device=device),
            torch.zeros(B, P, 3, dtype=torch.int16, device=device), counts]


def _dequantizing(advance):
    """The int16 advance: (*state, scale, off, q, counts), dequantized on the
    device (utils/quant.py), then `advance`."""

    def advance_q(*args):
        *state, scale, off, q, counts = args
        return advance(*state, dequantize(q, scale, off), counts)

    return advance_q


class _SlotStepGraph(_CapturedStep):
    """One captured CUDA graph of a tracker's advance over its state (which
    the graph updates in place) and its static inputs. The warm-up steps'
    writes to the state are undone before the first replay; `launches`
    holds (K1, K2, K3, K4) of one replay."""

    def __init__(self, tracker: "_OnlineBase"):
        self.tracker = tracker
        saved = [t.clone() for t in tracker._state.values()]
        super().__init__(tracker.device, COUNTED)
        for t, s in zip(tracker._state.values(), saved):
            t.copy_(s)

    def _body(self) -> None:
        self.tracker._advance_body()


def compute_mode(model) -> str:
    """'bfloat16' where the model's net computes in bf16, else 'float32'."""
    return "bfloat16" if computes_in_bf16(model.net) else "float32"


class _OnlineBase(_DeviceTracker):
    """The slot pool and device state shared by both model families.

    `_step` is the pair (advance, advance_q): the step over (*state values,
    points, counts) and over (*state values, scale, off, q, counts), each
    returning the new state values in `_state`'s order. The live trackers
    build them from the model; a loaded bundle gets them as exported
    programs (tracking/serving_export.py)."""

    def __init__(self, model, config, max_streams: int, max_points: int, transfer_dtype,
                 cuda_graph: bool, device=None):
        self.max_streams = int(max_streams)
        self.max_points = int(max_points)
        self._active = np.zeros((self.max_streams,), bool)
        self._state: Dict[str, torch.Tensor] = {}  # built by the subclass
        super().__init__(model, config, transfer_dtype, cuda_graph, device)
        self._inputs = input_buffers(self.max_streams, self.max_points, self.transfer_dtype,
                                     self.device)

    def set_model(self, model) -> None:
        super().set_model(model)
        self.compute_mode = compute_mode(model)

    def _make_step(self, model):
        advance = self._make_advance(model)
        return advance, _dequantizing(advance)

    def _zero_state(self, shapes: Dict[str, tuple]) -> None:
        """The state pool from (shape, dtype) by name: 'wlh' ones, the
        reservoir keys 'pool_key' -inf (an empty slot), everything else
        zeros; a slot is reset before it is used either way."""
        fill = {"wlh": 1.0, "pool_key": -math.inf}
        self._state = {k: torch.full(shape, fill.get(k, 0), dtype=dtype, device=self.device)
                       for k, (shape, dtype) in shapes.items()}

    # -- slot bookkeeping ---------------------------------------------------
    def _check_slot(self, slot) -> None:
        # a negative slot would alias another stream by negative indexing
        if not (isinstance(slot, (int, np.integer)) and 0 <= slot < self.max_streams):
            raise ValueError(f"slot must be an int in [0, {self.max_streams}) — got {slot!r}")

    def free_slots(self) -> list:
        return [i for i in range(self.max_streams) if not self._active[i]]

    def stop(self, slot: int) -> None:
        """Release a slot (its state is left in place but ignored)."""
        self._check_slot(slot)
        self._active[slot] = False

    def _init_params(self, box) -> np.ndarray:
        theta0 = rigid.theta_from_rotation(box.rotation_matrix, self._A_np)
        return np.append(box.center, theta0).astype(np.float32)

    def _write_slot(self, slot: int, **rows) -> None:
        """Eager in-place writes of one slot's rows of the state."""
        for k, v in rows.items():
            t = self._state[k]
            t[slot].copy_(torch.as_tensor(np.asarray(v), dtype=t.dtype))
        self._active[slot] = True

    # -- the step -------------------------------------------------------------
    def _pack(self, frames: Dict[int, np.ndarray]) -> list:
        """Check and pad a step's frames and pack them for the transfer:
        host tensors (pinned on the card) in `_inputs`' order. Slots that get
        no frame get an empty one; their results are ignored."""
        missing = [s for s in range(self.max_streams) if self._active[s] and s not in frames]
        if missing:
            raise ValueError(f"active slots {missing} got no frame")
        B, P = self.max_streams, self.max_points
        pts = np.zeros((B, P, 3), np.float32)
        valid = np.zeros((B, P), bool)
        for slot, p in frames.items():
            self._check_slot(slot)
            if not self._active[slot]:
                raise ValueError(f"slot {slot} is not active; call reset()")
            pts[slot], valid[slot] = pad_frame(p, P)
        return self._host(*_pack_transfer(self.transfer_dtype, pts, valid), _counts(valid))

    def _upload(self, host: list) -> None:
        """Copy packed host tensors into the static inputs, without blocking."""
        for buf, h in zip(self._inputs, host):
            buf.copy_(h, non_blocking=True)

    def _advance_body(self) -> None:
        """One step over the state and the static inputs, the state updated
        in place: the body of the captured graph, and the eager step."""
        advance = self._step[self.transfer_dtype is not None]
        with torch.no_grad():
            new = advance(*self._state.values(), *self._inputs)
            for buf, value in zip(self._state.values(), new):
                if value is not buf:
                    buf.copy_(value)

    def _advance(self) -> None:
        """Advance every slot: a graph replay on the card, else the eager body,
        with the tracker's card current (a graph captures, and the kernels
        launch, on the current card's streams)."""
        with on_card(self.device):
            if not self.cuda_graph:
                self._advance_body()
                return
            graph = self._captured((self.max_streams, self.max_points),
                                   lambda: _SlotStepGraph(self))
            with profiling.annotate("graph.replay"):
                graph.graph.replay()
        self.replays += 1

    def step(self, frames: Dict[int, np.ndarray]) -> Dict[int, np.ndarray]:
        """Advance every active stream by one frame.

        frames maps slot -> (N_i, 3) world-frame points of that stream's new
        frame; every active slot must be fed (a missed sensor frame is sent
        as an empty array). Returns slot -> the predicted world-frame (cx,
        cy, cz, theta) for the new frame, (4,) float32.
        """
        with profiling.annotate("online.pack"):
            self._upload(self._pack(frames))
        self._advance()
        with profiling.annotate("online.fetch"):
            boxes = self._state["ref"].cpu().numpy().copy()
        return {slot: boxes[slot] for slot in frames}

    def current_box(self, slot: int) -> np.ndarray:
        """Last predicted (or initial) world-frame params of a slot."""
        self._check_slot(slot)
        return self._state["ref"][slot].cpu().numpy().copy()


class OnlineM2Tracker(_OnlineBase):
    """Streaming M2-Track: `reset(slot, first_points, first_box)` then one
    `step({slot: new_points})` per incoming frame. State: the carried box
    `ref` (B, 4), the previous frame `prev_pts` (B, P, 3) with its point
    count `prev_count` (B,), the per-slot step counter `idx` (B,) and `wlh`
    (B, 3)."""

    def __init__(self, model, config, max_streams: int = 8, max_points: int = 1024,
                 transfer_dtype=None, cuda_graph: bool = True):
        super().__init__(model, config, max_streams, max_points, transfer_dtype, cuda_graph)
        B, P = self.max_streams, self.max_points
        f32, i32 = torch.float32, torch.int32
        self._zero_state({"ref": ((B, 4), f32), "prev_pts": ((B, P, 3), f32),
                          "prev_count": ((B,), i32), "idx": ((B,), i32), "wlh": ((B, 3), f32)})

    def _make_advance(self, model):
        step = make_m2_step(model.net, self.config, self._A,
                            bool(getattr(self.config, "box_aware", False)))

        def advance(ref, prev_pts, prev_count, idx, wlh, pts, counts):
            P = pts.shape[1]
            # the per-slot counter as a (B, 1) column: each row's own first step
            new_ref = step(wlh, ref, prev_pts, _expand_counts(prev_count, P), pts,
                           _expand_counts(counts, P), idx[:, None])
            return new_ref, pts, counts, idx + 1, wlh

        return advance

    def reset(self, slot: int, points: np.ndarray, box) -> None:
        """Start tracking in `slot`: `points` is the first frame's (N, 3)
        cloud, `box` the first-frame geometry Box."""
        self._check_slot(slot)
        with profiling.annotate("online.reset"):
            pts, valid = pad_frame(points, self.max_points)
            self._write_slot(slot, ref=self._init_params(box), prev_pts=pts,
                             prev_count=valid.sum(), idx=0, wlh=box.wlh)


class OnlineMatchTracker(_OnlineBase):
    """Streaming P2B/BAT. The first-frame template crop is taken once at
    `reset` (on the host, as the scan tracker does) and carried on the
    device: `first_pts` (B, P1, 3) with its count `first_count`; under
    'all' the reservoir `pool_pts` (B, C, 3) / `pool_key` (B, C), and
    `age` (B,) wherever the reservoir or the 'uniform' limit-box redraw
    keys on it."""

    def __init__(self, model, config, max_streams: int = 8, max_points: int = 1024,
                 first_crop_points: int = 1024, transfer_dtype=None, template_pool: int = 4096,
                 cuda_graph: bool = True):
        if parse_ref_mode(config.reference_BB) != "previous_result":
            raise ValueError(
                f"online tracking requires reference_BB='previous_result' (got "
                f"{config.reference_BB!r}): the gt modes need per-frame ground truth, which "
                f"does not exist at serving time")
        self._agg_mode = parse_agg_mode(config.shape_aggregation)
        pooled = self._agg_mode == "all"
        aged = pooled or redraws_uniform(config)
        self.first_crop_points = int(first_crop_points)
        B, P, P1 = int(max_streams), int(max_points), self.first_crop_points
        f32, i32 = torch.float32, torch.int32
        shapes = {"ref": ((B, 4), f32), "wlh": ((B, 3), f32), "prev_pts": ((B, P, 3), f32),
                  "prev_count": ((B,), i32), "first_pts": ((B, P1, 3), f32),
                  "first_count": ((B,), i32)}
        if pooled:
            C = int(getattr(config, "template_pool", template_pool))
            shapes.update(pool_pts=((B, C, 3), f32), pool_key=((B, C), f32))
        if aged:
            shapes["age"] = ((B,), i32)
        self._keys = tuple(shapes)
        super().__init__(model, config, max_streams, max_points, transfer_dtype, cuda_graph)
        self._zero_state(shapes)

    def _make_advance(self, model):
        keys, pooled = self._keys, self._agg_mode == "all"
        step = make_match_step(model.net, self.config, self._A, model.name == "bat",
                               self._agg_mode, gt_mode=False)

        def advance(*args):
            s = dict(zip(keys, args))
            pts, counts = args[len(keys):]
            P, P1 = pts.shape[1], s["first_pts"].shape[1]
            xs = (s["prev_pts"], _expand_counts(s["prev_count"], P), pts,
                  _expand_counts(counts, P))
            carry = (s["ref"], s["wlh"])
            if pooled:
                carry += (s["pool_pts"], s["pool_key"], s["age"])
            elif "age" in s:
                carry += (s["age"],)
            new_carry, _ = step(s["first_pts"], _expand_counts(s["first_count"], P1), carry, xs)
            new = dict(s, ref=new_carry[0], wlh=new_carry[1], prev_pts=pts, prev_count=counts)
            if pooled:
                new.update(pool_pts=new_carry[2], pool_key=new_carry[3], age=new_carry[4])
            elif "age" in s:
                new.update(age=new_carry[2])
            return tuple(new[k] for k in keys)

        return advance

    def reset(self, slot: int, pc, box) -> None:
        """Start tracking in `slot`: `pc` is the first frame's PointCloud (or
        (N, 3) array), `box` the first-frame geometry Box. Takes the
        first-frame template crop as the scan tracker does
        (MatchScanTracker._extra_inputs); a fresh stream starts with an
        empty reservoir and age 0."""
        self._check_slot(slot)
        with profiling.annotate("online.reset"):
            cfg = self.config
            if not isinstance(pc, PointCloud):
                pc = PointCloud(np.asarray(pc, np.float32).reshape(-1, 3).T)
            crop, _ = points_utils.cropAndCenterPC(pc, box, scale=cfg.model_bb_scale,
                                                   offset=cfg.model_bb_offset)
            P1 = self.first_crop_points
            fp = crop.points.T.astype(np.float32)[:P1]
            first = np.zeros((P1, 3), np.float32)
            first[: len(fp)] = fp
            pts, valid = pad_frame(pc.points.T, self.max_points)
            rows = dict(ref=self._init_params(box), wlh=box.wlh, prev_pts=pts,
                        prev_count=valid.sum(), first_pts=first, first_count=len(fp))
            if "pool_key" in self._state:
                rows["pool_key"] = -math.inf
            if "age" in self._state:
                rows["age"] = 0
            self._write_slot(slot, **rows)


class SplitOnlineTracker:
    """An online tracker's slot pool split over several cards (`devices`;
    JAX `mesh=`): card i serves slots [i * b, (i + 1) * b) of b =
    max_streams / n as a tracker of class `cls` of b slots on that card
    (`parts[i]`: its own state, model copy and captured graph). The
    tracker's API (reset, step, stop, free_slots, current_box, set_model)
    with global slot numbers; `step` packs and uploads each card's frames
    and launches each card's advance before it fetches the first box."""

    def __init__(self, cls, devices: Sequence, model, config, max_streams: int = 8, **kw):
        n, B = len(devices), int(max_streams)
        if B % n:
            raise ValueError(f"max_streams {B} does not divide over {n} devices")
        self.devices = [torch.device(d) for d in devices]
        self.per = B // n
        self.max_streams = B
        self.parts = [cls(model_on(model, d), config, max_streams=self.per, **kw)
                      for d in self.devices]
        self.config, self.max_points = config, self.parts[0].max_points
        self.compute_mode = self.parts[0].compute_mode

    def _part(self, slot):
        if not (isinstance(slot, (int, np.integer)) and 0 <= slot < self.max_streams):
            raise ValueError(f"slot must be an int in [0, {self.max_streams}) — got {slot!r}")
        return self.parts[slot // self.per], int(slot) % self.per

    def reset(self, slot: int, *args, **kw) -> None:
        part, local = self._part(slot)
        part.reset(local, *args, **kw)

    def stop(self, slot: int) -> None:
        part, local = self._part(slot)
        part.stop(local)

    def free_slots(self) -> list:
        return [i * self.per + s for i, p in enumerate(self.parts) for s in p.free_slots()]

    def current_box(self, slot: int) -> np.ndarray:
        part, local = self._part(slot)
        return part.current_box(local)

    def set_model(self, model) -> None:
        for part, d in zip(self.parts, self.devices):
            part.set_model(model_on(model, d))

    def step(self, frames: Dict[int, np.ndarray]) -> Dict[int, np.ndarray]:
        """As the unsplit tracker's step: every card's advance is launched
        before any box is fetched."""
        split = [{} for _ in self.parts]
        for slot, pts in frames.items():
            self._part(slot)
            split[slot // self.per][slot % self.per] = pts
        for part, own in zip(self.parts, split):
            with profiling.annotate("online.pack", card=part.device.index):
                part._upload(part._pack(own))
            part._advance()
        out = {}
        for i, (part, own) in enumerate(zip(self.parts, split)):
            with profiling.annotate("online.fetch", card=part.device.index):
                boxes = part._state["ref"].cpu().numpy().copy()
            out.update({i * self.per + s: boxes[s] for s in own})
        return out


def make_online_tracker(model, config, devices: Optional[Sequence] = None, **kw):
    """The online tracker for the config's model family: on the model's
    device, on `devices[0]` where one device is given, or split over
    `devices` (a `SplitOnlineTracker`) where several are."""
    m2 = getattr(model, "name", "") == "m2track" or not hasattr(config, "search_size")
    cls = OnlineM2Tracker if m2 else OnlineMatchTracker
    if devices is not None and len(devices) > 1:
        return SplitOnlineTracker(cls, devices, model, config, **kw)
    if devices:
        model = model_on(model, devices[0])
    return cls(model, config, **kw)
