"""Readings that a cell's limits are set from, on the card, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,13 [--seconds 2]
    python3 portbench/calibrate.py --workload <cell> --seeds 21,22,23 --control

Without --control: for each seed, a whole run of the cell (set-up, a short
window, the check) and its numbers compared, each as it reads. With
--control: the cell's control, the plain reference put in the program's
place in the nearest precision below the configuration's (float32 -> TF32),
compared by the same check; with --fault as well, a fault planted in that
reference instead (the training runner's 'half': each loss over half the
batch). Each seed prints one JSON line
{"seed", "control", "checks": {name: value}}; `--out FILE` also appends
them there. A limit lies above the program's largest reading and below the
control's smallest (README.md, "Limits").
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import cell_threads  # noqa: E402

cell_threads(sys.argv[1:])

from portbench import harness  # noqa: E402


def readings(name: str, seed: int, seconds: float, control: bool, devices, overrides=None,
             fault: str = None):
    run = harness.Run(name, seed, seconds, False, devices=devices, overrides=overrides)
    t0 = time.perf_counter()
    if control:
        runner = importlib.import_module(f"portbench.traffic.{run.cell['runner']}")
        runner.control(run, fault=fault) if fault else runner.control(run)
    else:
        harness.execute(run, harness.load_json(harness.ROOT / "BENCHMARK.json"), 0.0)
    return {"seed": seed, "control": control, "fault": fault,
            "seconds": time.perf_counter() - t0,
            "checks": {n: v for n, v, _ in run.checks},
            "counters": {k: v for k, v in run.counters.items()
                         if isinstance(v, (int, float, str))}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None,
                   help="with --control: a fault planted in the reference put in the "
                        "program's place instead of the lower precision (train: 'half')")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = harness.load_json(harness.HERE / "workloads" / f"{args.workload}.json")
    # the control runs the reference alone, which needs one card whatever the cell's
    devices = harness.require_cards(1 if args.control else int(cell["chips"]))
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps(readings(args.workload, seed, args.seconds, args.control, devices,
                                   fault=args.fault))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
