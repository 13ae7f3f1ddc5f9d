"""No JAX in a run: the whole-top-level-name rule, the harness's own
imports, and a run that finds no card."""

import os
import subprocess
import sys

import pytest

from portbench import harness


@pytest.mark.parametrize("modules, found", [
    (["open3dsot_tpu_torch", "open3dsot_tpu_torch.ops"], []),
    (["open3dsot_tpu", "numpy"], ["open3dsot_tpu"]),
    (["open3dsot_tpu.models.bat"], ["open3dsot_tpu"]),
    (["jax._src.core", "jaxlib"], ["jax", "jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["jaxtyping", "flaxen", "open3dsot_tpu_torchx"], [])])
def test_forbidden_by_whole_top_level_name(modules, found):
    assert harness.forbidden_modules(modules) == found


def test_the_harness_and_runners_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.harness, portbench.calibrate\n"
            "import portbench.traffic.scan_eval, portbench.traffic.online\n"
            "import portbench.reference.m2track, portbench.reference.bat\n"
            "import portbench.work.m2track, portbench.work.bat\n"
            "from portbench.harness import forbidden_modules\n"
            "assert forbidden_modules() == [], forbidden_modules()\n" % str(harness.ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_a_run_without_a_card_exits_nonzero_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card path is not reachable here")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "m2track_kitti_car.scan_eval_b16", "--seed", str(2**33 + 1),
                        "--seconds", "1", "--trace", "0"], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr
