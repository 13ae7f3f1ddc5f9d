"""Training loop, port of `open3dsot_tpu/train/trainer.py` for the matching
trackers (BAT, P2B) on one device.

- `train_step`: the training forward, the model's loss, backward, the
  optimizer and schedule steps. The loss terms come back as floats only
  when asked (at log steps), so the other steps never wait for the device.
- `Trainer.fit`: batches from `data/loader.py::BatchLoader`, whose
  background thread builds the next batches on the host while the device
  trains; validation every `check_val_every_n_epoch` epochs on the host
  eval loop (`tracking/eval.py`, the JAX package's `val_tracker: host`);
  `ckpt_best.pt` (best validation precision), `ckpt_last.pt`,
  `ckpt_meta.json` and `history.jsonl` in the work directory.

`config.tensorboard: false` keeps the scalars in `scalars.jsonl` only.
Each epoch's record also holds `data_wait_s`, the time the loop waited for
the loader, against `time_s`, the epoch's time.

Not ported yet (ROADMAP.md): resume, top-k checkpoints, the BN-momentum
schedule, the on-device sampler (`device_sampler`), meshes.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

from open3dsot_tpu_torch.data.loader import BatchLoader
from open3dsot_tpu_torch.train.optim import clip_gradients, make_optimizer


def train_step(model, optimizer, batch: dict, scheduler=None, fetch: bool = False):
    """One update from a `model.device_batch`; -> the loss terms as floats
    when `fetch`, else None."""
    output = model.apply_train(batch)
    loss_dict = model.loss(batch, output)
    optimizer.zero_grad(set_to_none=True)
    loss_dict["loss_total"].backward()
    clip_gradients(model.config, model.net.parameters())
    optimizer.step()
    if scheduler is not None:
        scheduler.step()
    if fetch:
        return {k: float(v.detach()) for k, v in loss_dict.items()}
    return None


class Trainer:
    """Epoch loop, validation and checkpoints."""

    def __init__(self, model, config, work_dir: Optional[str] = None, log_every: int = 50):
        self.model = model
        self.config = config
        self.work_dir = work_dir or getattr(config, "log_dir", None) or "./runs"
        os.makedirs(self.work_dir, exist_ok=True)
        self.log_every = log_every
        self.best_metric = -np.inf
        self.history = []
        from open3dsot_tpu_torch.utils.logging import ScalarLogger

        self.logger = ScalarLogger(self.work_dir,
                                   enable_tensorboard=getattr(config, "tensorboard", True))

    def fit(self, train_sampler, val_sampler=None, epochs: Optional[int] = None,
            steps_per_epoch: Optional[int] = None):
        """Train for `epochs` (the config's by default) of at most
        `steps_per_epoch` steps (the loader's length by default); -> history."""
        cfg = self.config
        epochs = epochs if epochs is not None else cfg.epoch
        loader = BatchLoader(train_sampler, cfg.batch_size, shuffle=True, drop_last=True,
                             seed=cfg.seed, workers=getattr(cfg, "workers", 0) or 0)
        spe = steps_per_epoch or max(len(loader), 1)
        optimizer, scheduler = make_optimizer(cfg, self.model.net.parameters(), spe)
        step = 0
        for epoch in range(epochs):
            loader.set_epoch(epoch)
            t0 = time.perf_counter()
            wait, losses = 0.0, []
            batches = iter(loader)
            for i in range(spe):
                t_wait = time.perf_counter()
                batch = next(batches, None)
                wait += time.perf_counter() - t_wait
                if batch is None:
                    break
                fetch = (i + 1) % self.log_every == 0 or i == 0
                scalars = train_step(self.model, optimizer, self.model.device_batch(batch),
                                     scheduler, fetch=fetch)
                step += 1
                if scalars is not None:
                    losses.append(scalars["loss_total"])
                    self.logger.log_scalars(scalars, step=step, prefix="loss/")
            batches.close()  # ends the loader's background thread
            if self.model.device.type == "cuda":
                torch.cuda.synchronize(self.model.device)
            info = {"epoch": epoch, "steps": step,
                    "loss": float(np.mean(losses)) if losses else float("nan"),
                    "time_s": time.perf_counter() - t0, "data_wait_s": wait}
            if val_sampler is not None and (
                    (epoch + 1) % getattr(cfg, "check_val_every_n_epoch", 1) == 0):
                from open3dsot_tpu_torch.tracking.eval import evaluate_dataset

                succ, prec = evaluate_dataset(self.model, val_sampler, cfg)
                info.update(success=succ, precision=prec)
                self.logger.log_scalars({"success/test": succ, "precision/test": prec}, step=step)
                if prec > self.best_metric:
                    self.best_metric = prec
                    self.save_checkpoint(optimizer, step, epoch, "best")
                self._save_ckpt_meta()
            self.save_checkpoint(optimizer, step, epoch, "last")
            self.history.append(info)
            self._log(info)
        loader.close()
        self.logger.close()
        return self.history

    def save_checkpoint(self, optimizer, step: int, epoch: int, name: str) -> str:
        """`ckpt_{name}.pt`: the net's state_dict, the optimizer's, step and epoch."""
        path = os.path.join(self.work_dir, f"ckpt_{name}.pt")
        torch.save({"state_dict": self.model.net.state_dict(),
                    "optimizer": optimizer.state_dict(), "step": step, "epoch": epoch}, path)
        return path

    def _save_ckpt_meta(self) -> None:
        meta_path = os.path.join(self.work_dir, "ckpt_meta.json")
        tmp = meta_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({"best_metric": float(self.best_metric)}, fh)
        os.replace(tmp, meta_path)

    def _log(self, info: dict) -> None:
        print(json.dumps({k: (round(v, 5) if isinstance(v, float) else v)
                          for k, v in info.items()}), flush=True)
        with open(os.path.join(self.work_dir, "history.jsonl"), "a") as f:
            f.write(json.dumps(info) + "\n")


def state_dict_of_checkpoint(payload) -> dict:
    """The net's state_dict from a `Trainer` checkpoint or a bare state_dict."""
    if isinstance(payload, dict) and "state_dict" in payload and "step" in payload:
        return payload["state_dict"]
    return payload
