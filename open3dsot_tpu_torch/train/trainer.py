"""Training loop, port of `open3dsot_tpu/train/trainer.py`, for M2-Track and
the matching trackers (BAT, P2B) on one device or data-parallel over the
ranks of a process group, in f32 or in bf16 compute
(`bf16: true`: the model's layers compute in bf16; parameters, gradients and
the Adam state stay f32).

- `train_step`: the training forward, the model's loss, backward, the
  optimizer and schedule steps. The loss terms come back as floats only
  when asked (at log steps), so the other steps never wait for the device.
- `Trainer.fit`: batches from `data/loader.py::BatchLoader`, whose
  background thread builds the next batches on the host while the device
  trains; validation every `check_val_every_n_epoch` epochs on the scan
  tracker (`tracking/scan_tracker.py::M2ScanTracker` for M2-Track,
  `tracking/scan_matching.py::MatchScanTracker` for BAT and P2B), or on the
  host eval loop (`tracking/eval.py`) with `val_tracker: host`;
  `ckpt_best.pt` (best validation precision), `ckpt_last.pt`,
  `ckpt_ep{epoch:03d}.pt` (the `save_top_k` best validated epochs: -1 keeps
  all, 0 none), `ckpt_meta.json` (best metric, top-k table) and
  `history.jsonl` in the work directory; `fit(resume_from=ckpt)` restores
  the net, the optimizer, the LR schedule's position, the step and
  `ckpt_meta.json`, and goes on from epoch step // steps_per_epoch.
- `device_sampler: true` (train_motion, train_siamese): the loader makes
  raw padded frames (data/device_sampler.py's raw samplers; int16-packed
  under `transfer_quant: int16`), copied to the device from pinned memory,
  and the sample build runs there before each step, keyed by
  fold_in(PRNGKey(seed + 1), step) with `step` the updates made before it,
  as JAX's `state.step`. So loader shuffling (seed + epoch) and the build
  (seed, step) key off the restored position: a resumed run repeats an
  uninterrupted one.
- `bn_decay_step` truthy: the BatchNorm momentum follows
  train/bn_momentum.py's schedule by epoch (`bn_momentum`, `bn_decay_rate`).

`config.tensorboard: false` keeps the scalars in `scalars.jsonl` only. The
loss terms are logged under `loss/`, the accuracies (`acc_*`, M2-Track's)
under `train/`, as the JAX trainer logs them.
Each epoch's record also holds `data_wait_s`, the time the loop waited for
the loader, against `time_s`, the epoch's time.

Data parallelism (parallel/distributed.py; one rank per card, main.py's
`--num_devices` or torchrun): `batch_size` is the global batch, and each
rank takes its rows of it (the loader's `rows`, as JAX's `shard_batch`
splits it over the mesh). The gradients are averaged over the ranks before
the clip and the optimizer (one all_reduce), and so are the logged losses.
Two modes, as JAX's `make_train_step`:

- `dp_shard_map: false` (the default, JAX's GSPMD step): the BatchNorm
  statistics, K6's included (staged, ops/sa_fused_train.py), and the losses
  are those of the global batch (`distributed.global_batch`; the losses on
  the ranks' outputs gathered), and the device sampler draws for the global
  batch and keeps the rank's rows, so a step equals the one-process step
  on the global batch;
- `dp_shard_map: true`: each rank's own statistics and losses, the blended
  running statistics averaged over the ranks after the step, and the
  device sampler keyed by fold_in(key, rank).

Rank 0 validates and writes the checkpoints, logs and history; the others
wait at a barrier. A global batch that does not divide over the ranks is
refused here, naming both numbers (main.py's own launch takes the gcd, as
JAX's Trainer shrinks its mesh). `mesh_shape` is accepted and ignored, as
in JAX, which reads it nowhere.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

from open3dsot_tpu_torch.data.loader import BatchLoader
from open3dsot_tpu_torch.parallel import distributed
from open3dsot_tpu_torch.train.bn_momentum import BN_MOMENTUM, bn_momentum_schedule, set_bn_momentum
from open3dsot_tpu_torch.train.optim import clip_gradients, make_optimizer
from open3dsot_tpu_torch.utils import prng


# Config keys the JAX trainer honours and this one does not yet: key ->
# (its default, the ROADMAP item that ports it). A value other than the
# default is refused. None is left.
UNPORTED_KEYS: dict = {}


def refuse_unported_keys(config) -> None:
    for key, (default, item) in UNPORTED_KEYS.items():
        value = getattr(config, key, default)
        if value != default:
            raise NotImplementedError(f"config.{key}={value!r} is not ported yet ({item}); "
                                      f"leave it at {default!r}")


def _gathered(tensors: dict, rows: int) -> dict:
    """The ranks' rows of each (rows, ...) tensor concatenated (differentiably)."""
    return {k: distributed.gather_rows(v) if torch.is_tensor(v) and v.dim() and
            v.shape[0] == rows else v for k, v in tensors.items()}


def _average_over_ranks(tensors) -> None:
    """Each tensor averaged over the ranks, in place, with one all_reduce."""
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    distributed.all_reduce_mean(flat)
    for t, v in zip(tensors, torch.split(flat, [t.numel() for t in tensors])):
        t.copy_(v.view_as(t))


def train_step(model, optimizer, batch: dict, scheduler=None, fetch: bool = False,
               per_device_stats: bool = False):
    """One update from a `model.device_batch`; -> the loss terms as floats
    when `fetch`, else None. On several ranks `batch` is this rank's rows of
    the global batch, and `per_device_stats` chooses the mode (the module
    docstring): False takes statistics and losses over the global batch."""
    with distributed.global_batch(not per_device_stats):
        output = model.apply_train(batch)
        if distributed.in_global_batch():
            rows = next(iter(batch.values())).shape[0]
            loss_dict = model.loss(_gathered(batch, rows), _gathered(output, rows))
        else:
            loss_dict = model.loss(batch, output)
    optimizer.zero_grad(set_to_none=True)
    loss_dict["loss_total"].backward()
    params = list(model.net.parameters())
    if distributed.world_size() > 1:
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        with torch.no_grad():
            _average_over_ranks(p.grad for p in params)
            if per_device_stats:  # the blend was each rank's: average it
                _average_over_ranks(b for n, b in model.net.named_buffers() if "running" in n)
    clip_gradients(model.config, params)
    optimizer.step()
    if scheduler is not None:
        scheduler.step()
    if fetch:
        scalars = {k: float(v.detach()) for k, v in loss_dict.items()}
        return distributed.mean_of_floats(scalars, model.device)
    return None


class Trainer:
    """Epoch loop, validation and checkpoints."""

    def __init__(self, model, config, work_dir: Optional[str] = None, log_every: int = 50):
        refuse_unported_keys(config)
        self.model = model
        self.config = config
        self.work_dir = work_dir or getattr(config, "log_dir", None) or "./runs"
        os.makedirs(self.work_dir, exist_ok=True)
        self.log_every = log_every
        self.best_metric = -np.inf
        self.save_top_k = int(getattr(config, "save_top_k", -1))
        self._topk: list = []  # (precision, path), best first
        self.history = []
        self._val_scan = None  # the scan tracker of validation, built on first use
        self._val_prep_cache, self._val_prep_cache_for = None, None
        self.rank, self.world = distributed.rank(), distributed.world_size()
        self.per_device_stats = bool(getattr(config, "dp_shard_map", False))
        if config.batch_size % self.world:
            raise ValueError(f"batch_size {config.batch_size} does not divide over "
                             f"{self.world} ranks; give a multiple of {self.world}, or launch "
                             f"with main.py --num_devices, which takes the gcd")
        from open3dsot_tpu_torch.utils.logging import ScalarLogger

        self.logger = (ScalarLogger(self.work_dir,
                                    enable_tensorboard=getattr(config, "tensorboard", True))
                       if self.rank == 0 else None)

    def fit(self, train_sampler, val_sampler=None, epochs: Optional[int] = None,
            steps_per_epoch: Optional[int] = None, resume_from: Optional[str] = None):
        """Train for `epochs` (the config's by default) of at most
        `steps_per_epoch` steps (the loader's length by default), from the
        checkpoint `resume_from` when given; -> history."""
        cfg = self.config
        epochs = epochs if epochs is not None else cfg.epoch
        builder, transform = None, None
        if getattr(cfg, "device_sampler", False):
            train_sampler, builder, transform = self._device_sampler(train_sampler)
        rows = cfg.batch_size // self.world
        loader = BatchLoader(train_sampler, cfg.batch_size, shuffle=True, drop_last=True,
                             seed=cfg.seed, workers=getattr(cfg, "workers", 0) or 0,
                             transform=transform,
                             rows=(self.rank * rows, (self.rank + 1) * rows))
        spe = steps_per_epoch or max(len(loader), 1)
        optimizer, scheduler = make_optimizer(cfg, self.model.net.parameters(), spe)
        step = 0
        if resume_from is not None:
            step = self._resume(resume_from, optimizer, scheduler)
        bn_sched = None
        if getattr(cfg, "bn_decay_step", None):
            bn_sched = bn_momentum_schedule(initial=getattr(cfg, "bn_momentum", 0.1),
                                            decay=getattr(cfg, "bn_decay_rate", 0.5),
                                            step_size=int(cfg.bn_decay_step))
        sampler_key = prng.prng_key(int(cfg.seed) + 1)
        for epoch in range(step // spe, epochs):
            loader.set_epoch(epoch)
            set_bn_momentum(self.model.net, bn_sched(epoch) if bn_sched else BN_MOMENTUM)
            t0 = time.perf_counter()
            wait, losses = 0.0, []
            batches = iter(loader)
            for i in range(spe):
                t_wait = time.perf_counter()
                batch = next(batches, None)
                wait += time.perf_counter() - t_wait
                if batch is None:
                    break
                if builder is not None:
                    raw = {k: v.to(self.model.device, non_blocking=True) for k, v in batch.items()}
                    key = prng.fold_in(sampler_key, step)
                    if self.per_device_stats and self.world > 1:
                        key = prng.fold_in(key, self.rank)  # JAX's fold_in(key, axis_index)
                    batch = builder(raw, key)
                else:
                    batch = self.model.device_batch(batch)
                fetch = (i + 1) % self.log_every == 0 or i == 0
                scalars = train_step(self.model, optimizer, batch, scheduler, fetch=fetch,
                                     per_device_stats=self.per_device_stats)
                step += 1
                if scalars is not None and self.logger is not None:
                    losses.append(scalars["loss_total"])
                    accs = {k: v for k, v in scalars.items() if k.startswith("acc_")}
                    self.logger.log_scalars({k: v for k, v in scalars.items() if k not in accs},
                                            step=step, prefix="loss/")
                    if accs:
                        self.logger.log_scalars(accs, step=step, prefix="train/")
            batches.close()  # ends the loader's background thread
            if self.model.device.type == "cuda":
                torch.cuda.synchronize(self.model.device)
            info = {"epoch": epoch, "steps": step,
                    "loss": float(np.mean(losses)) if losses else float("nan"),
                    "time_s": time.perf_counter() - t0, "data_wait_s": wait}
            if self.rank == 0:
                self._end_epoch(info, val_sampler, (optimizer, scheduler, step, epoch))
            distributed.barrier(self.model.device)  # the other ranks wait for rank 0's writes
            self.history.append(info)
        loader.close()
        if self.logger is not None:
            self.logger.close()
        return self.history

    def _end_epoch(self, info: dict, val_sampler, ckpt: tuple) -> None:
        """Validation, checkpoints and the epoch's record (rank 0's)."""
        epoch, step = ckpt[3], ckpt[2]
        if val_sampler is not None and (
                (epoch + 1) % getattr(self.config, "check_val_every_n_epoch", 1) == 0):
            succ, prec = self.validate(val_sampler)
            info.update(success=succ, precision=prec)
            self.logger.log_scalars({"success/test": succ, "precision/test": prec}, step=step)
            if prec > self.best_metric:
                self.best_metric = prec
                self.save_checkpoint(*ckpt, "best")
            self.save_topk_checkpoint(*ckpt, prec)
            self._save_ckpt_meta()
        self.save_checkpoint(*ckpt, "last")
        self._log(info)

    def _device_sampler(self, train_sampler):
        """(the raw twin of `train_sampler`, its device builder, the loader's
        transform: the int16 pack under transfer_quant and, for a model on
        the card, pinned tensors)."""
        from open3dsot_tpu_torch.data import device_sampler as ds
        from open3dsot_tpu_torch.geometry.rigid import up_frame

        cfg = self.config
        raw_type = {"train_motion": ds.RawMotionSampler, "train_siamese": ds.RawSiameseSampler}
        ttype = getattr(cfg, "train_type", None)
        if ttype not in raw_type or not hasattr(train_sampler, "dataset"):
            raise ValueError("device_sampler: true needs train_type train_motion or train_siamese "
                             f"and a sampler over a dataset; got {ttype!r}, "
                             f"{type(train_sampler).__name__}")
        raw = raw_type[ttype](train_sampler.dataset, cfg,
                              max_raw_points=int(getattr(cfg, "max_raw_points", 2048)))
        pack = ds.pack_raw_batch if getattr(cfg, "transfer_quant", None) else None
        pin = self.model.device.type == "cuda"

        def transform(batch):
            batch = {k: torch.from_numpy(v) for k, v in (pack(batch) if pack else batch).items()}
            return {k: v.pin_memory() for k, v in batch.items()} if pin else batch

        shard = None if self.per_device_stats or self.world == 1 else (self.rank, self.world)
        build = ds.make_builder(cfg, ttype, A=up_frame(cfg.up_axis, device=self.model.device),
                                shard=shard)
        return raw, build, transform

    def _resume(self, path: str, optimizer, scheduler) -> int:
        """Load a `save_checkpoint` file into the net, the optimizer and the
        schedule, and the work directory's ckpt_meta.json; -> its step."""
        ckpt = torch.load(path, map_location=self.model.device, weights_only=True)
        self.model.net.load_state_dict(ckpt["state_dict"], strict=True)
        optimizer.load_state_dict(ckpt["optimizer"])
        scheduler.load_state_dict(ckpt["scheduler"])
        self._load_ckpt_meta()
        return int(ckpt["step"])

    def validate(self, val_sampler):
        """Success/Precision of the current weights on `val_sampler`.

        `config.val_tracker` 'host' runs the host eval loop
        (tracking/eval.py); 'auto' (the default) and 'scan' run the batched
        scan tracker (the model's `scan_tracker`: tracking/scan_tracker.py for
        M2-Track, tracking/scan_matching.py for BAT and P2B), built on the first call and
        kept with its captured graphs, which it captures again when the
        weights have changed, and with its prep cache of the padded batches,
        kept while the sampler is the same object (`val_prep_cache: false`
        pads them anew each time).
        """
        cfg = self.config
        mode = getattr(cfg, "val_tracker", "auto")
        if mode not in ("auto", "scan", "host"):
            raise ValueError(f"val_tracker must be 'auto', 'scan' or 'host', got {mode!r}")
        self.model.net.eval()  # the scan step calls the net directly
        try:
            if mode == "host":
                from open3dsot_tpu_torch.tracking.eval import evaluate_dataset

                return evaluate_dataset(self.model, val_sampler, cfg)
            if self._val_scan is None:
                self._val_scan = self.model.scan_tracker(cfg)
            if getattr(cfg, "val_prep_cache", True) is False:
                self._val_prep_cache = None  # large validation splits: pad every time
            elif self._val_prep_cache_for is not val_sampler:
                self._val_prep_cache, self._val_prep_cache_for = {}, val_sampler
            return self.model.evaluate_scan(val_sampler, cfg, tracker=self._val_scan,
                                            prep_cache=self._val_prep_cache)
        finally:
            self.model.net.train()

    def save_checkpoint(self, optimizer, scheduler, step: int, epoch: int, name: str) -> str:
        """`ckpt_{name}.pt`: the net's state_dict, the optimizer's, the LR
        schedule's, step and epoch."""
        path = os.path.join(self.work_dir, f"ckpt_{name}.pt")
        torch.save({"state_dict": self.model.net.state_dict(), "optimizer": optimizer.state_dict(),
                    "scheduler": scheduler.state_dict(), "step": step, "epoch": epoch}, path)
        return path

    def save_topk_checkpoint(self, optimizer, scheduler, step: int, epoch: int,
                             precision: float) -> None:
        """Keep the `save_top_k` best epochs by validation precision
        (reference ModelCheckpoint(monitor='precision/test', mode='max',
        save_top_k)): -1 keeps every validated epoch, 0 none; a checkpoint
        that would be evicted at once is not written."""
        k = self.save_top_k
        if k == 0 or (k > 0 and len(self._topk) >= k and precision <= self._topk[-1][0]):
            return
        path = self.save_checkpoint(optimizer, scheduler, step, epoch, f"ep{epoch:03d}")
        # an epoch validated again (a run resumed from an earlier checkpoint)
        # replaces its entry
        self._topk = [(p, pth) for p, pth in self._topk if pth != path]
        self._topk.append((precision, path))
        self._topk.sort(key=lambda t: -t[0])
        if k > 0:
            for _, stale in self._topk[k:]:
                if os.path.exists(stale):
                    os.remove(stale)
            self._topk = self._topk[:k]

    def _save_ckpt_meta(self) -> None:
        """ckpt_meta.json: the best metric and the top-k table, written
        atomically, so that a resumed Trainer keeps them."""
        meta_path = os.path.join(self.work_dir, "ckpt_meta.json")
        tmp = meta_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({"best_metric": float(self.best_metric),
                       "topk": [[float(p), path] for p, path in self._topk]}, fh)
        os.replace(tmp, meta_path)

    def _load_ckpt_meta(self) -> None:
        path = os.path.join(self.work_dir, "ckpt_meta.json")
        if not os.path.exists(path):
            return
        try:
            with open(path) as fh:
                meta = json.load(fh)
        except (json.JSONDecodeError, OSError) as e:
            # a truncated file counts as missing: best_metric restarts at -inf
            print(f"WARNING: ignoring corrupt {path}: {e}", flush=True)
            return
        self.best_metric = float(meta.get("best_metric", -np.inf))
        self._topk = [(float(p), pth) for p, pth in meta.get("topk", []) if os.path.isfile(pth)]

    def _log(self, info: dict) -> None:
        print(json.dumps({k: (round(v, 5) if isinstance(v, float) else v)
                          for k, v in info.items()}), flush=True)
        with open(os.path.join(self.work_dir, "history.jsonl"), "a") as f:
            f.write(json.dumps(info) + "\n")


RELEASED_CKPT = ("a Lightning checkpoint of the reference (its weights under 'state_dict' "
                 "with the reference's keys, no 'step'): evaluate it with `python -m "
                 "open3dsot_tpu_torch.eval_released_ckpt --cfg ... --ckpt ... --data ...`, or "
                 "import it with open3dsot_tpu_torch.import_torch.import_checkpoint")


def state_dict_of_checkpoint(payload) -> dict:
    """The net's state_dict from a `Trainer` checkpoint or a bare state_dict.
    A Lightning checkpoint (a 'state_dict' and no 'step') raises, naming the
    entry point that imports one."""
    if isinstance(payload, dict) and "state_dict" in payload:
        if "step" not in payload:
            raise ValueError(f"--checkpoint is {RELEASED_CKPT}")
        return payload["state_dict"]
    return payload
