"""The spreads that the end-to-end bounds are set from.

    python3 portbench/bounds.py <dir>/<cell>.jsonl [...]

Each file holds one cell's runs, one JSON object a line: {"set": "A" | "B"
| "T", "seed", "trace", "line": the run's result line}; sets A and B are
six untraced runs each on the same six seeds. For every end-to-end metric
it prints each set's median and spread (the distance between the first and
third quartiles, statistics.quantiles, as a share of the median), the wider
of the two, and five times it: a bound is set near that, never under 1% nor
over 25%. setup_s leaves out each set's first run (the one that builds the
kernels) and is held by its medians only. Every run's `correct` is counted.
"""

from __future__ import annotations

import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.stats import spread  # noqa: E402


def main(paths) -> int:
    for path in paths:
        runs = [json.loads(x) for x in open(path) if x.strip()]
        bad = [r for r in runs if not (r.get("line") or {}).get("correct")]
        print(f"{path}: {len(runs)} runs, {len(bad)} not correct")
        sets = {s: [r["line"] for r in runs if r["set"] == s and r.get("line")] for s in "AB"}
        names = sets["A"][0]["metrics"] if sets["A"] else {}
        for name in names:
            out = {}
            for s, lines in sets.items():
                vals = [x["metrics"][name]["value"] for x in lines]
                if name == "setup_s":
                    vals = vals[1:] if s == "A" else vals
                out[s] = (statistics.median(vals), spread(vals), vals)
            widest = max(v[1] for v in out.values())
            print(f"  {name}: " + "; ".join(f"{s} median {m!r} spread {sp:.4f}"
                                            for s, (m, sp, _) in out.items())
                  + f"; widest {widest:.4f}, x5 {5 * widest:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
