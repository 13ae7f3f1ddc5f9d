"""The port imports neither jax nor flax. Checked in a fresh interpreter,
because this test process has jax loaded (conftest.py), over every module
of the package as pkgutil.walk_packages finds them."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SCRIPT = """
import importlib, pkgutil, sys
import open3dsot_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in names:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'open3dsot_tpu'))
print(','.join(names))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_slice_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    names, bad = proc.stdout.strip().splitlines()[-2:]
    assert bad == "[]"
    # the walk reaches every subpackage: modules the hand-kept list of earlier
    # versions of this test had left out, and the probes
    for m in ("ops.sa_fused_train", "train.optim", "train.trainer", "data.loader",
              "models.losses", "utils.logging", "probes.gather", "probes.gather_bf16"):
        assert f"open3dsot_tpu_torch.{m}" in names.split(","), m


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py drives the port only; its source names no jax module."""
    src = (ROOT / "chip_smoke.py").read_text()
    for word in ("import jax", "from jax", "import flax", "from flax", "open3dsot_tpu."):
        assert word not in src, word
