"""The highest step rate an online cell sustains, found once on the card.

    python3 portbench/sweep.py --workload bat_kitti_car.online_32 --seed 5 \\
        --rates 100,120,140,160,180,200 --seconds 5

One set-up, then a window at each rate in turn (the schedule goes on from
one to the next); each prints a JSON line: the rate, the latency's median
and 95th percentile (ms, from the due time), the mean service time, and
how late the last step started (ms): a rate is sustained where that stays
within a period or two, and not where it grows with the window. The cell's
`rate` is the sensor's; the sweep tells how far below capacity it lies.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import cell_threads  # noqa: E402

cell_threads(sys.argv[1:])

from portbench import harness, stats  # noqa: E402
from portbench.traffic import online  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", required=True, help="steps a second, comma-separated")
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    run = harness.Run(args.workload, args.seed, args.seconds, False)
    run.devices = harness.require_cards(int(run.cell["chips"]))
    online.setup(run)
    for rate in (float(r) for r in args.rates.split(",")):
        w = online.window(run, args.seconds, rate)
        print(json.dumps({
            "rate": rate, "steps": len(w["latency"]),
            "latency_ms_p50": 1e3 * stats.percentile(w["latency"], 50),
            "latency_ms_p95": 1e3 * stats.percentile(w["latency"], 95),
            "service_ms_mean": 1e3 * statistics.fmean(w["service"]),
            "service_ms_p95": 1e3 * stats.percentile(w["service"], 95),
            "late_ms_last": run.counters["late_ms_last"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
