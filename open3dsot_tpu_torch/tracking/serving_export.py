"""Serving bundles for the online trackers, port of
`open3dsot_tpu/tracking/serving_export.py`, with torch.export in place of
StableHLO.

`save_serving_bundle` writes a directory that a serving host loads without
the model code or the training config:

- `advance.pt2`: the online tracker's advance over (state tensors,
  points, counts), exported by `torch.export` and saved with
  `torch.export.save`. The program carries its weights as its own
  buffers: the net's parameters and buffers, and the fold caches' folded
  and packed weights, folded once before the export
  (models/pointnet.py::folds_as_buffers), since those are what the
  kernels read. The kernels appear in the program as the operators
  `open3dsot::fused_pointnet_encoder`, `::fused_seg_head`,
  `::furthest_point_sample` and `::fused_sa_apply` (ops/), which run the
  hand-written kernel on a CUDA tensor and the plain version on a CPU one.
  An int16 tracker's loader wraps the same program in the dequantization
  (tracking/online.py::_dequantizing), which its graph captures with it:
  the bundle holds one copy of the weights.
- `meta.json`: what the slot-pool API needs (pool shape, up axis, transfer
  codec, template-crop settings) and what the loader checks (format
  version, torch version, the device type the program was exported on),
  with the state's shapes and dtypes and the compute mode ('float32' or
  'bfloat16'). A bf16 tracker's program holds the bf16 mode's packed weights
  and calls the operators in their bf16 mode, so its bundle serves in bf16
  as the live tracker did, and the loaded tracker's `compute_mode` says so.

A tracker split over several cards (tracking/online.py::SplitOnlineTracker,
JAX `mesh=`) is refused, as the JAX package refuses a sharded one: export
one unsplit tracker, and split the loaded pool by loading one bundle a card.

Where the JAX bundle also exports the slot `reset`, this one does not: a
reset is a few per-slot writes of the state, which the loaded tracker makes
itself from `state_shapes` (tracking/online.py::_OnlineBase._write_slot).

`load_serving_bundle` returns the same OnlineM2Tracker / OnlineMatchTracker
class the live constructor builds (the same `reset` / `step` / `stop`
API), with no model built and no config read. On the card it captures its
advance in a CUDA graph as the live tracker does. A bundle exported on the
card loads only where a card is present: it does not run on the CPU
instead.
"""

from __future__ import annotations

import json
import pathlib
from types import SimpleNamespace

import torch
import torch.nn as nn

from open3dsot_tpu_torch.models.pointnet import folds_as_buffers
from open3dsot_tpu_torch.tracking.online import (
    OnlineM2Tracker,
    OnlineMatchTracker,
    SplitOnlineTracker,
    _OnlineBase,
    _dequantizing,
    input_buffers,
)

FORMAT_VERSION = 1
PROGRAM = "advance.pt2"


class _Program(nn.Module):
    """An advance as a module for torch.export: the net is its submodule, so
    that the net's parameters and buffers become the program's."""

    def __init__(self, net: nn.Module, advance):
        super().__init__()
        self.net = net
        self.advance = advance

    def forward(self, *args):
        return self.advance(*args)


def save_serving_bundle(tracker: _OnlineBase, path) -> None:
    """Write a serving bundle of a live online tracker (built on a model)
    into the directory `path`. The program runs on the device type the
    tracker runs on."""
    if isinstance(tracker, SplitOnlineTracker):
        raise ValueError("a tracker split over several devices cannot be exported: export an "
                         "unsplit one (the JAX package refuses a sharded tracker alike)")
    if tracker.model is None:
        raise ValueError("the tracker has no model (a loaded bundle): save from the live tracker")
    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    B, P, dev = tracker.max_streams, tracker.max_points, tracker.device
    net = tracker.model.net
    state = tuple(tracker._state.values())
    with folds_as_buffers(net), torch.no_grad():
        program = torch.export.export(
            _Program(net, tracker._step[0]), state + tuple(input_buffers(B, P, None, dev)),
            strict=False)
    torch.export.save(program, path / PROGRAM)
    cfg = tracker.config
    meta = {
        "format_version": FORMAT_VERSION,
        "family": "match" if isinstance(tracker, OnlineMatchTracker) else "m2track",
        "max_streams": B,
        "max_points": P,
        "transfer_dtype": tracker.transfer_dtype,
        "up_axis": [float(v) for v in cfg.up_axis],
        "torch_version": torch.__version__,
        "device": dev.type,
        "compute_mode": tracker.compute_mode,
        # the loader rebuilds the state pool from these ('wlh' ones, the
        # reservoir keys -inf, everything else zeros)
        "state_shapes": {k: [list(v.shape), str(v.dtype).removeprefix("torch.")]
                         for k, v in tracker._state.items()},
    }
    if isinstance(tracker, OnlineMatchTracker):
        meta["first_crop_points"] = tracker.first_crop_points
        meta["model_bb_scale"] = float(cfg.model_bb_scale)
        meta["model_bb_offset"] = float(cfg.model_bb_offset)
    (path / "meta.json").write_text(json.dumps(meta, indent=1))


def load_serving_bundle(path) -> _OnlineBase:
    """Load a bundle into a ready-to-serve online tracker, on the device type
    it was exported on. No model is constructed and no config read: the
    advance comes back as the exported program, which calls the kernels'
    operators (registered by importing open3dsot_tpu_torch.ops)."""
    import open3dsot_tpu_torch.ops  # noqa: F401  registers the operators the program calls

    path = pathlib.Path(path)
    meta = json.loads((path / "meta.json").read_text())
    if meta.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"bundle format {meta.get('format_version')!r} != {FORMAT_VERSION}")
    device = torch.device(meta["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"the bundle {path} was exported for device '{meta['device']}', and "
                           f"no CUDA device is available here")
    try:
        advance = torch.export.load(path / PROGRAM).module()
    except Exception as e:  # a boundary: say which versions, then re-raise
        raise RuntimeError(
            f"cannot load {path / PROGRAM}, exported with torch {meta['torch_version']}, with "
            f"torch {torch.__version__}: {e}") from e
    cfg = SimpleNamespace(up_axis=meta["up_axis"])
    match = meta["family"] == "match"
    self = object.__new__(OnlineMatchTracker if match else OnlineM2Tracker)
    if match:
        self.first_crop_points = int(meta["first_crop_points"])
        cfg.model_bb_scale = meta["model_bb_scale"]
        cfg.model_bb_offset = meta["model_bb_offset"]
    _OnlineBase.__init__(self, None, cfg, meta["max_streams"], meta["max_points"],
                         meta["transfer_dtype"], cuda_graph=True, device=device)
    self._zero_state({k: (tuple(shape), getattr(torch, dtype))
                      for k, (shape, dtype) in meta["state_shapes"].items()})
    self._step = (advance, _dequantizing(advance))
    self.compute_mode = meta.get("compute_mode", "float32")
    return self
