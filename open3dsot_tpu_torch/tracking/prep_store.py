"""Disk-backed packed-record cache for scan-tracker dataset evaluation, port
of `open3dsot_tpu/tracking/prep_store.py`.

A one-shot scan eval spends its host time decoding the dataset and padding
each batch, although the padded/packed arrays do not depend on the weights.
The in-memory `prep_cache` dict (tracking/scan_tracker.py) only helps
repeated evals inside one process; this store persists the packed transfer
form to disk so every later eval (another process, another weights file)
neither decodes the dataset nor pads a single frame: the host's only
per-batch work on a warm store is one npz read.

Drop-in: `PackedPrepStore` implements the mapping protocol the trackers'
`dispatch_scored` and the dataset loop already use (the `"batches"` key and
`("prep", j)` keys), so `evaluate_dataset_scan(..., prep_cache=
PackedPrepStore(path, meta))` works unchanged. On a warm store the
"batches" entry is rebuilt as length-only stubs (`_StubSeq`): enough for
the device-metrics pipeline, which only takes `len(seq)` of them.
Host-scored paths (results_writer / device_metrics=False) need real frames;
the eval loop skips a store there (`stub_sequences`).

The port's cached value of batch j is `(host, gt)`: two lists of CPU
tensors, as `_ScanTracker.dispatch_scored` packs them. They are written as
numpy arrays and read back as tensors, in pinned memory when the tracker
runs on the card (`pin`), so the copies to it need not block. Nested
tuples, lists and None are kept.

Integrity: `meta` (a dataset/config fingerprint chosen by the caller) is
written to meta.json on first use and must match exactly afterwards; a
mismatching store raises instead of silently serving stale crops.
`eval_store`'s fingerprint carries `"package": "open3dsot_tpu_torch"`, which
a store the JAX package wrote (its own packing) lacks: such a store is
refused too.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

PACKAGE = "open3dsot_tpu_torch"


class _StubSeq:
    """Length-only stand-in for a tracklet on the warm path."""

    __slots__ = ("_n",)

    def __init__(self, n: int):
        self._n = int(n)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i):
        raise RuntimeError(
            "PackedPrepStore stub sequence: frame data was not loaded "
            "(warm store). Host-scored paths need the real sampler.")


def _flatten(obj, prefix, out):
    if isinstance(obj, (tuple, list)):
        kind = "tuple" if isinstance(obj, tuple) else "list"
        out[f"{prefix}:{kind}"] = np.int64(len(obj))
        for i, el in enumerate(obj):
            _flatten(el, f"{prefix}.{i}", out)
    elif obj is None:
        out[f"{prefix}:none"] = np.int64(0)
    elif isinstance(obj, torch.Tensor):
        out[f"{prefix}:tensor"] = obj.detach().cpu().numpy()
    else:
        out[f"{prefix}:leaf"] = np.asarray(obj)


def _unflatten(files, prefix, get, pin: bool):
    for kind, make in (("tuple", tuple), ("list", list)):
        if f"{prefix}:{kind}" in files:
            n = int(get(f"{prefix}:{kind}"))
            return make(_unflatten(files, f"{prefix}.{i}", get, pin) for i in range(n))
    if f"{prefix}:none" in files:
        return None
    if f"{prefix}:tensor" in files:
        t = torch.from_numpy(np.ascontiguousarray(get(f"{prefix}:tensor")))
        return t.pin_memory() if pin else t
    leaf = get(f"{prefix}:leaf")
    return leaf[()] if leaf.ndim == 0 else leaf


class PackedPrepStore:
    """Mapping-protocol persistent prep cache (see module docstring).

    meta: caller-chosen fingerprint dict (dataset name/category/split, n,
    batch_tracklets, max_points, frame_bucket, transfer dtype, tracker
    kind, ...). JSON-serializable values only. pin: read tensors back into
    pinned memory.
    """

    stub_sequences = True  # eval loops: batches from this cache lack frames

    def __init__(self, path: str, meta: dict, pin: bool = False):
        self.path = path
        self.pin = pin
        os.makedirs(path, exist_ok=True)
        self._meta_path = os.path.join(path, "meta.json")
        canonical = json.loads(json.dumps(meta))
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                existing = json.load(f)
            if existing.get("fingerprint") != canonical:
                raise ValueError(
                    f"PackedPrepStore at {path} was built with a different "
                    f"fingerprint:\n  stored: {existing.get('fingerprint')}\n"
                    f"  requested: {canonical}\n"
                    "Delete the directory or use a different path.")
            self._batch_lengths = existing.get("batch_lengths")
        else:
            self._batch_lengths = None
            self._write_meta(canonical)
        self._fingerprint = canonical
        self._mem: dict = {}  # in-process layer over the files

    # -- internals ----------------------------------------------------------
    def _write_meta(self, fingerprint):
        tmp = self._meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"fingerprint": fingerprint,
                       "batch_lengths": self._batch_lengths}, f)
        os.replace(tmp, self._meta_path)

    def _prep_path(self, j: int) -> str:
        return os.path.join(self.path, f"prep_{j:05d}.npz")

    def _complete(self) -> bool:
        return self._batch_lengths is not None and all(
            os.path.exists(self._prep_path(j))
            for j in range(len(self._batch_lengths)))

    # -- mapping protocol (matches the trackers' prep_cache usage) ----------
    def __contains__(self, key) -> bool:
        if key == "batches":
            return self._complete()
        if key in self._mem:
            return True
        return (isinstance(key, tuple) and key[0] == "prep"
                and os.path.exists(self._prep_path(key[1])))

    def __getitem__(self, key):
        if key == "batches":
            if not self._complete():
                raise KeyError(key)
            return [[_StubSeq(n) for n in lens]
                    for lens in self._batch_lengths]
        if key in self._mem:
            return self._mem[key]
        if not isinstance(key, tuple) or key[0] != "prep":
            raise KeyError(key)
        fpath = self._prep_path(key[1])
        if not os.path.exists(fpath):
            raise KeyError(key)
        with np.load(fpath) as z:
            value = _unflatten(set(z.files), "t", z.__getitem__, self.pin)
        self._mem[key] = value
        return value

    def __setitem__(self, key, value):
        if key == "batches":
            self._batch_lengths = [[len(s) for s in batch] for batch in value]
            self._write_meta(self._fingerprint)
            return
        if not isinstance(key, tuple) or key[0] != "prep":
            raise KeyError(f"unsupported prep-store key: {key!r}")
        out = {}
        _flatten(value, "t", out)
        fpath = self._prep_path(key[1])
        tmp = fpath + ".tmp.npz"
        np.savez(tmp, **out)
        os.replace(tmp, fpath)
        self._mem[key] = value

    def get(self, key, default=None):
        return self[key] if key in self else default


def eval_store(path: str, config, tracker, n: int, batch_tracklets: int,
               shard_across_processes: bool = False,
               extra: Optional[dict] = None) -> PackedPrepStore:
    """Build a PackedPrepStore whose fingerprint pins everything that shapes
    the packed arrays: the package that packed them, dataset identity
    (including the content-determining config: data path, synthetic
    seed/size, tiny/preload crops, up axis), batching, padding and the
    transfer codec, and (for a sharded eval) this rank's stripe. Sharded
    ranks write disjoint subdirectories of `path` (`shard_{r}_of_{n}`), so
    one --eval_prep_cache directory serves all of them."""
    from open3dsot_tpu_torch.parallel import distributed

    shard = ([distributed.rank(), distributed.world_size()]
             if shard_across_processes else [0, 1])
    if shard != [0, 1]:
        # one meta.json per stripe: ranks must not share a store directory
        path = os.path.join(path, f"shard_{shard[0]}_of_{shard[1]}")
    fp = {
        "package": PACKAGE,
        "dataset": str(getattr(config, "dataset", "?")),
        "category": str(getattr(config, "category_name", "?")),
        # content-determining dataset config (data/__init__.py factory
        # args): a warm store must never serve another dataset's frames
        "path": str(getattr(config, "path", "")),
        "tiny": bool(getattr(config, "tiny", False)),
        "preload_offset": int(getattr(config, "preload_offset", -1)),
        "seed": int(getattr(config, "seed", 42)),
        "syn": [int(getattr(config, "syn_num_tracklets", 4)),
                int(getattr(config, "syn_tracklet_len", 8))],
        "up_axis": [float(v) for v in getattr(config, "up_axis", (0, 0, 1))],
        "coordinate_mode": str(getattr(config, "coordinate_mode", "velodyne")),
        "split": str(getattr(config, "test_split", "test")),
        "tracker": type(tracker).__name__,
        "n": int(n),
        "batch_tracklets": int(batch_tracklets),
        "max_points": int(tracker.max_points),
        "frame_bucket": int(tracker.frame_bucket),
        # the matching tracker's cached first-frame template crop is shaped
        # by model_bb_scale/offset: two evals differing only in these must
        # not share a store
        "model_bb": [float(getattr(config, "model_bb_scale", 1.0)),
                     float(getattr(config, "model_bb_offset", 0.0))],
        "transfer": str(tracker.transfer_dtype or "f32"),
        "shard": shard,
        "first_crop": int(getattr(tracker, "first_crop_points", 0)),
        # a split tracker's batches are padded to a multiple of its card count
        "cards": int(getattr(tracker, "cards", 1)),
    }
    if extra:
        fp.update(extra)
    return PackedPrepStore(path, fp, pin=tracker.device.type == "cuda")
