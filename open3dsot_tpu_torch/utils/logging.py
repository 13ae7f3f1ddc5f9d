"""Scalar logging, copy of `open3dsot_tpu/utils/logging.py`: always appends
JSONL (`scalars.jsonl`) and mirrors to TensorBoard when
`torch.utils.tensorboard` can be imported.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class ScalarLogger:
    def __init__(self, log_dir: str, enable_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self.jsonl_path = os.path.join(log_dir, "scalars.jsonl")
        self._tb = None
        if enable_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=log_dir)
            except Exception as e:
                print(
                    f"[logging] TensorBoard unavailable ({type(e).__name__}); "
                    "scalars go to scalars.jsonl only"
                )
                self._tb = None

    def log_scalars(self, scalars: Dict[str, float], step: int, prefix: str = ""):
        record = {"step": step, "time": time.time()}
        for k, v in scalars.items():
            key = f"{prefix}{k}" if prefix else k
            v = float(v)
            record[key] = v
            if self._tb is not None:
                self._tb.add_scalar(key, v, step)
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def flush(self):
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
