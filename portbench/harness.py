"""One run of one cell: set-up, warm-up, a measured (or traced) window, the
check against the plain reference, one result line.

Everything a cell needs is found by name: the cell's file
`portbench/workloads/<cell>.json` names its configuration
(`portbench/configs/<config>.json`), its traffic runner
(`portbench/traffic/<runner>.py`) with the traffic's parameters, its chips
and its limits; `BENCHMARK.json` at the root names the metrics, and a
per-layer metric is read by `portbench/metrics/<metric>.py` (or the reader
of its longest dotted prefix, `reader_path`). A runner
module gives

    setup(run)    build the program's objects, make weights and traffic from
                  the seed, warm up every shape the window will use;
    window(run, seconds)   drive the program for that long, recording spans
                  and counters, and put the end-to-end metrics it measures
                  into run.e2e;
    release(run)  drop the program's objects (device memory freed);
    check(run)    compare what the window produced with the plain
                  reference: run.check(name, value, limit) for each number.

The measured path (the port, `open3dsot_tpu_torch`) is the only program
imported; the JAX package is never loaded, and a run that finds it, or
jax, jaxlib or flax, in sys.modules after its window, or again before its
result line, fails.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

from portbench import stats, trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "open3dsot_tpu")
PORT = "open3dsot_tpu_torch"
# keys of a configuration file that describe it rather than set it
META_KEYS = ("source", "reduced", "assumed", "reference", "notes")


class RunFailed(RuntimeError):
    """A run that prints no result: exit code and reason."""

    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.code = code


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: `open3dsot_tpu_torch` is not
    `open3dsot_tpu`."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def refuse_forbidden() -> None:
    """Fail the run (exit code 5, no result) where a forbidden module is loaded."""
    found = forbidden_modules()
    if found:
        raise RunFailed(5, "forbidden modules loaded: " + ", ".join(found))


def applies(metric: dict, cell: str) -> bool:
    """Whether `cell` reports `metric`: listed in its `workloads`, or every
    cell where it has no such key (`setup_s`)."""
    return cell in metric.get("workloads", [cell])


def process_age_s() -> float:
    """Seconds since this process started (the kernel's record of it)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


class Run:
    """What one run knows: the cell, its configuration and traffic, the seed
    and window, the devices, and what the runner records."""

    def __init__(self, name: str, seed: int, seconds: float, trace_on: bool,
                 devices=None, overrides: dict = None, started: float = None):
        self.name, self.seed, self.seconds, self.trace = name, int(seed), float(seconds), trace_on
        self.cell = load_json(HERE / "workloads" / f"{name}.json")
        overrides = overrides or {}
        self.cell.update(overrides.get("cell", {}))
        conf = load_json(HERE / "configs" / f"{self.cell['config']}.json")
        self.source = conf
        self.cfg = {k: v for k, v in conf.items() if k not in META_KEYS}
        self.cfg.update(conf.get("assumed", {}))
        self.cfg.update(self.cell.get("config_overrides", {}))
        self.cfg.update(overrides.get("config", {}))
        self.mix = dict(self.cell["traffic"], **overrides.get("traffic", {}))
        self.limits = dict(self.cell.get("limits", {}), **overrides.get("limits", {}))
        self.devices = devices
        self.started = time.perf_counter() if started is None else started
        self.spans = trace.Spans()
        self.counters: dict = {}
        self.e2e: dict = {}
        self.checks: list = []  # (name, value, limit)
        self.attempted = 0
        self.failed = 0
        self.state = None  # the runner's objects
        self.setup_s = None
        self.memory_peak_bytes = 0
        self.phases: list = []  # (set-up phase, seconds)
        self._phase_t = self.started

    def phase(self, name: str) -> None:
        """Close the set-up phase `name` (its seconds since the last one)."""
        now = time.perf_counter()
        self.phases.append((name, now - self._phase_t))
        self._phase_t = now

    def port_config(self):
        """The configuration as the port takes it (its defaults below it)."""
        from open3dsot_tpu_torch.config import make_config

        return make_config(dict(self.cfg))

    def reference(self):
        """The configuration's plain reference, portbench/reference/<name>.py."""
        return importlib.import_module(f"portbench.reference.{self.source['reference']}")

    def check(self, name: str, value: float, limit: float) -> None:
        """A number compared: correct while value <= limit."""
        self.checks.append((name, float(value), float(limit)))

    def synchronize(self) -> None:
        import torch

        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def mark_setup_done(self, process_age: float) -> None:
        """setup_s: from process start to the first timed step."""
        self.setup_s = process_age + (time.perf_counter() - self.started)


def require_cards(chips: int) -> list:
    import torch

    if not torch.cuda.is_available():
        raise RunFailed(3, "no CUDA device: this benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise RunFailed(3, f"the cell needs {chips} cards, {torch.cuda.device_count()} present")
    return [torch.device("cuda", i) for i in range(chips)]


def reader_path(metric: str) -> Path:
    """The per-layer metric's reader, portbench/metrics/<metric>.py, or else
    that of its longest dotted prefix that has one (`device.idle_share.scan`
    is read by `device.idle_share.py`)."""
    parts = metric.split(".")
    for n in range(len(parts), 0, -1):
        path = HERE / "metrics" / (".".join(parts[:n]) + ".py")
        if path.is_file():
            return path
    raise FileNotFoundError(f"no reader for the metric {metric} under {HERE / 'metrics'}")


def reader(metric: str):
    """The per-layer metric's reader module (reader_path)."""
    path = reader_path(metric)
    spec = importlib.util.spec_from_file_location("portbench_metric_" + metric.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def execute(run: Run, bench: dict, age0: float) -> dict:
    """Set-up, window, check; -> the result line (a dict). `age0`: the
    process's age when `run.started` was taken."""
    import torch

    name = run.name
    e2e = [m for m in bench["end_to_end"] if applies(m, name)]
    per_layer = [m for m in bench["per_layer"] if applies(m, name)]
    runner = importlib.import_module(f"portbench.traffic.{run.cell['runner']}")
    run.phase("imports")
    runner.setup(run)
    run.synchronize()
    # the set-up's objects (frames, boxes, the program's graphs) leave the
    # collector's young generations, so that no collection in the window
    # walks them
    gc.collect()
    gc.freeze()
    run.mark_setup_done(age0)
    out = {}
    if run.trace:
        seconds = min(run.seconds, float(run.cell.get("trace_seconds", run.seconds)))
        with trace.traced(run.spans, out):
            runner.window(run, seconds)
    else:
        runner.window(run, run.seconds)
    run.synchronize()
    refuse_forbidden()
    if any(d.type == "cuda" for d in run.devices):
        run.memory_peak_bytes = max(torch.cuda.max_memory_allocated(d) for d in run.devices
                                    if d.type == "cuda")
    runner.release(run)
    gc.collect()
    if any(d.type == "cuda" for d in run.devices):
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    runner.check(run)
    run.counters["check_s"] = time.perf_counter() - t_check
    phases = ", ".join(f"{k} {v:.3f}" for k, v in run.phases)
    print(f"portbench: setup {run.setup_s:.3f} s ({phases}), check "
          f"{run.counters['check_s']:.3f} s", file=sys.stderr)

    metrics = {}
    if run.trace:
        timeline = out["timeline"]
        run.counters["timeline"] = timeline
        for m in per_layer:
            value = reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": stats.gate(m["name"], m["unit"], float(value)),
                                      "unit": m["unit"]}
    else:
        for m in e2e:
            value = run.setup_s if m["name"] == "setup_s" else run.e2e.get(m["name"])
            if value is None:
                raise RunFailed(6, f"the runner measured no {m['name']}")
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    cuda = [d for d in run.devices if d.type == "cuda"]
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(cuda[0]) if cuda else "cpu",
              "count": len(run.devices), "memory_peak_bytes": int(run.memory_peak_bytes)}
    line = {"correct": bool(run.checks) and all(v <= lim for _, v, lim in run.checks),
            "attempted": int(run.attempted), "failed": int(run.failed), "metrics": metrics,
            "device": device}
    if run.trace:
        timeline = out["timeline"]
        device.update(busy_s=timeline.busy_s(), window_s=timeline.window_s)
        line["breakdown"] = {"device_ops": timeline.top_ops(), "idle_gaps": timeline.idle_gaps()}
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in run.checks}
    refuse_forbidden()  # again: the check and the readers ran after the window
    return line


def main(argv=None, started: float = None) -> int:
    import argparse

    started = time.perf_counter() if started is None else started
    age0 = max(0.0, process_age_s() - (time.perf_counter() - started))  # at `started`
    p = argparse.ArgumentParser(description="Run one benchmark cell of the port on the card.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        bench = load_json(ROOT / "BENCHMARK.json")
        run = Run(args.workload, args.seed, args.seconds, bool(args.trace), started=started)
        run.phases.append(("interpreter", age0))
        run.devices = require_cards(int(run.cell["chips"]))
        run.phase("card")
        if importlib.util.find_spec(PORT) is None:
            raise RunFailed(4, f"the program under test ({PORT}) is not in this checkout")
        line = execute(run, bench, age0)
    except RunFailed as e:
        print(f"portbench: {e}", file=sys.stderr)
        return e.code
    except stats.ShareAbovePeak as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 7
    for n, c in line["checks"].items():
        print(f"check {n} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
