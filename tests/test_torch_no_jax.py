"""The port imports neither jax nor flax. Checked in a fresh interpreter,
because this test process has jax loaded (conftest.py)."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

MODULES = [
    "open3dsot_tpu_torch",
    "open3dsot_tpu_torch.config",
    "open3dsot_tpu_torch.geometry.points_utils",
    "open3dsot_tpu_torch.geometry.iou",
    "open3dsot_tpu_torch.geometry.rigid",
    "open3dsot_tpu_torch.utils.metrics",
    "open3dsot_tpu_torch.data",
    "open3dsot_tpu_torch.data.sampler",
    "open3dsot_tpu_torch.data.synthetic",
    "open3dsot_tpu_torch.ops._build",
    "open3dsot_tpu_torch.ops._launch",
    "open3dsot_tpu_torch.ops.chain_fused",
    "open3dsot_tpu_torch.ops.grouping",
    "open3dsot_tpu_torch.ops.neighbors",
    "open3dsot_tpu_torch.ops.sampling",
    "open3dsot_tpu_torch.ops.sa_fused",
    "open3dsot_tpu_torch.models",
    "open3dsot_tpu_torch.models.layers",
    "open3dsot_tpu_torch.models.pointnet",
    "open3dsot_tpu_torch.models.m2track",
    "open3dsot_tpu_torch.models.xcorr",
    "open3dsot_tpu_torch.models.rpn",
    "open3dsot_tpu_torch.models.matching_base",
    "open3dsot_tpu_torch.models.bat",
    "open3dsot_tpu_torch.models.p2b",
    "open3dsot_tpu_torch.weights",
    "open3dsot_tpu_torch.tracking.eval",
    "open3dsot_tpu_torch.main",
]

SCRIPT = f"""
import importlib, sys
for m in {MODULES!r}:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'open3dsot_tpu'))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_slice_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "[]"


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py drives the port only; its source names no jax module."""
    src = (ROOT / "chip_smoke.py").read_text()
    for word in ("import jax", "from jax", "import flax", "from flax", "open3dsot_tpu."):
        assert word not in src, word
