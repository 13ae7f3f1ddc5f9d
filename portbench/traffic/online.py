"""Traffic runner `online`: a serving node advancing every stream it holds
by one LiDAR frame a step, at the sensor's rate.

Set-up makes the configuration's weights and a pool of streams (the mix's
tracklets, frames an ROI crop of `points` points around the object) from
the seed, and an online tracker of `slots` slots (the port's
`make_online_tracker`). Slot b starts with stream b of the pool; when a
stream ends, the next stream of the pool (cyclically) is reset into its
slot before the next step, so streams start and end all through the window.
A step is the resets of the streams that start at it, then `step()` with
every slot's next frame. Steps are offered at the mix's `rate` a second:
10, the sweep rate of the LiDAR a stream comes from (KITTI's Velodyne
HDL-64E turns at 10 Hz), so one step advances every stream by its next
sweep as it arrives. The rate is fixed in the cell and lies far below the
highest the system sustains (`portbench/sweep.py`, PERF.md), so that a
step's latency is its own service and not a queue's. Each step is timed
from its due time to its boxes on the host (a step that starts late
because the one before overran counts its wait). Warm-up runs `warmup`
steps (the graph's capture among them) back to back; the window continues
the schedule. `online_step_ms_p95` is the 95th percentile of every step
of the window.

The check draws `sample` steps of the window from the seed, with the step
whose slot is deepest into its stream among them, and holds each slot's
box to the plain reference step by step from the program's own state: the
reference takes the program's box of that stream's previous step (its
first box after a reset), the stream's raw frames and its first crop, and
computes every proposal; the program's box is matched to the nearest
proposal, whose centre's gap and whose objectness below the reference's
best are the numbers compared. The control (`control`) is the reference in the
program's place in TF32.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import stats, weights
from portbench.reference import common
from portbench.traffic import tracklets


SPIN_S = 0.002  # the last part of a wait for a step's due time, spent spinning


class Schedule:
    """Which stream and frame each slot serves at each step."""

    def __init__(self, lengths: list, slots: int):
        self.lengths, self.slots = lengths, slots
        self.stream = list(range(slots))  # the stream in each slot
        self.frame = [0] * slots  # the frame last fed (0: just reset)
        self.next = slots % len(lengths)

    def advance(self):
        """-> (resets [(slot, stream)], feed [(slot, stream, frame)]) of the next step."""
        resets = []
        for b in range(self.slots):
            if self.frame[b] + 1 >= self.lengths[self.stream[b]]:
                self.stream[b], self.frame[b] = self.next, 0
                self.next = (self.next + 1) % len(self.lengths)
                resets.append((b, self.stream[b]))
        feed = []
        for b in range(self.slots):
            self.frame[b] += 1
            feed.append((b, self.stream[b], self.frame[b]))
        return resets, feed


def setup(run) -> None:
    from open3dsot_tpu_torch.geometry import Box, PointCloud, Quaternion
    from open3dsot_tpu_torch.models import get_model
    from open3dsot_tpu_torch.tracking.online import make_online_tracker

    cfg = run.port_config()
    dev = run.devices[0]
    sd = weights.make(run.reference().param_specs(run.cfg), run.seed, dev)
    model = get_model(run.cfg["net_model"])(cfg, device=dev)
    model.net.load_state_dict(sd)
    run.phase("model")
    data = tracklets.generate(run.mix, run.seed)
    first = [(PointCloud(tr["points"][0].T),
              Box(tr["center"][0], tr["wlh"],
                  Quaternion(axis=[0.0, 0.0, 1.0], radians=float(tr["theta"][0]))))
             for tr in data]
    slots = int(run.mix["slots"])
    devices = run.devices if len(run.devices) > 1 else None
    tracker = make_online_tracker(model, cfg, devices=devices, max_streams=slots,
                                  max_points=int(run.mix["max_points"]),
                                  first_crop_points=int(run.mix["first_crop_points"]))
    sched = Schedule([len(tr["points"]) for tr in data], slots)
    run.phase("traffic")
    for b in range(slots):
        tracker.reset(b, *first[b])
    run.state = {"sd": sd, "data": data, "first": first, "tracker": tracker, "model": model,
                 "sched": sched, "steps": [], "window_from": None}
    for _ in range(int(run.mix["warmup"])):
        _step(run)
    run.synchronize()
    run.phase("warmup")


def _step(run) -> float:
    """One step of the schedule; records what was fed and returned."""
    st = run.state
    tracker, data = st["tracker"], st["data"]
    resets, feed = st["sched"].advance()
    t0 = time.perf_counter()
    with run.spans.span("online.step"):
        for b, k in resets:
            tracker.reset(b, *st["first"][k])
        out = tracker.step({b: data[k]["points"][f] for b, k, f in feed})
    dt = time.perf_counter() - t0
    st["steps"].append({"feed": np.array(feed), "boxes": np.stack([out[b] for b, _, _ in feed]),
                        "s": dt})
    return dt


def window(run, seconds: float, rate: float = None) -> dict:
    """Steps offered at `rate` a second (the mix's): step i is due at
    t0 + i / rate, starts then or as soon as the one before has ended, and
    its latency runs from its due time to its boxes on the host, so a late
    step's wait counts. -> the window's latencies and service times."""
    st = run.state
    rate = float(run.mix["rate"] if rate is None else rate)
    st["window_from"] = len(st["steps"])
    run.spans.records.clear()
    n = max(1, int(round(seconds * rate)))
    latency = []
    t0 = time.perf_counter()
    for i in range(n):
        due = t0 + i / rate
        wait = due - time.perf_counter()
        if wait > SPIN_S:  # sleep most of the wait, spin the rest: a wake-up can be late
            time.sleep(wait - SPIN_S)
        while time.perf_counter() < due:
            pass
        _step(run)
        latency.append(time.perf_counter() - due)
    elapsed = time.perf_counter() - t0
    service = [s["s"] for s in st["steps"][st["window_from"]:]]
    run.e2e["online_step_ms_p95"] = 1e3 * stats.percentile(latency, 95)
    run.counters.update(steps=n, window_s=elapsed, slots=int(run.mix["slots"]), cfg=run.cfg,
                        late_ms_last=1e3 * (latency[-1] - service[-1]))
    run.attempted = n * int(run.mix["slots"])
    return {"rate": rate, "latency": latency, "service": service, "elapsed": elapsed}


def release(run) -> None:
    st = run.state
    run.state = {k: st[k] for k in ("sd", "data", "steps", "window_from")}


def _sample(run) -> list:
    """Step indices to check: `sample` drawn from the seed among the
    window's, and the one whose slot is deepest into its stream."""
    st = run.state
    lo, hi = st["window_from"], len(st["steps"])
    rng = np.random.default_rng([run.seed & 0xFFFFFFFF, run.seed >> 32, 9])
    picks = set(int(i) for i in rng.choice(np.arange(lo, hi), size=min(int(run.mix["sample"]),
                                                                        hi - lo), replace=False))
    picks.add(max(range(lo, hi), key=lambda i: max(f for _, _, f in st["steps"][i]["feed"])))
    return sorted(picks)


def _prev_box(run, steps: list, i: int, b: int):
    """The box that slot b's stream carried into step i: the program's box
    of the step before, or its first box after a reset."""
    _, k, f = steps[i]["feed"][b]
    if f == 1:
        tr = run.state["data"][k]
        th = float(tr["theta"][0])
        return np.append(tr["center"][0], np.arctan2(np.sin(th), np.cos(th))).astype(np.float32)
    return steps[i - 1]["boxes"][b]


def _inputs(run, steps, i: int, device):
    """The reference step's rows for step i: every slot's frames, first crop,
    carried box and sizes, on `device`."""
    import torch

    data, cfg = run.state["data"], run.cfg
    P, P1 = int(run.mix["max_points"]), int(run.mix["first_crop_points"])
    rows = {k: [] for k in ("wlh", "ref", "first", "first_ok", "prev", "prev_ok", "this",
                            "this_ok")}
    for b, (_, k, f) in enumerate(steps[i]["feed"]):
        tr = data[k]
        fp, n1 = run.reference().first_crop(tr["points"][0], tr["center"][0],
                                            float(tr["theta"][0]), tr["wlh"], cfg, P1)
        prev, prev_ok = common.pad_frame(tr["points"][f - 1], P)
        this, this_ok = common.pad_frame(tr["points"][f], P)
        for key, val in (("wlh", tr["wlh"]), ("ref", _prev_box(run, steps, i, b)),
                         ("first", fp), ("first_ok", np.arange(P1) < n1), ("prev", prev),
                         ("prev_ok", prev_ok), ("this", this), ("this_ok", this_ok)):
            rows[key].append(val)
    out = {k: torch.from_numpy(np.stack(v)).to(device) for k, v in rows.items()}
    out["wlh"], out["ref"] = out["wlh"].float(), out["ref"].float()
    return out


def _compare(run, steps: list, picks: list, device) -> None:
    ref = run.reference()
    # the angle is matched on but not compared: its gap reads about as low under
    # TF32 as in float32 (PERF.md), near the rounding of the composed angle
    gaps = {"box_center_gap_ulp": 0.0, "objectness_gap": 0.0}
    checked = 0
    for i in picks:
        x = _inputs(run, steps, i, device)
        cand, score = ref.step(run.state["sd"], run.cfg, x["wlh"], x["ref"], x["first"],
                               x["first_ok"], x["prev"], x["prev_ok"], x["this"], x["this_ok"])
        cand, score = cand.cpu().numpy().astype(np.float64), score.cpu().numpy()
        got = np.asarray(steps[i]["boxes"], np.float64)
        if not np.isfinite(got).all():
            run.failed += int((~np.isfinite(got).all(axis=1)).sum())
        for b in range(got.shape[0]):
            dc = common.ulp_gap(cand[b, :, :3], got[b, None, :3]).max(axis=1)
            da = common.ulp_gap(cand[b, :, 3], got[b, 3], angle=True)
            j = int(np.argmin(np.maximum(dc, da)))
            gaps["box_center_gap_ulp"] = max(gaps["box_center_gap_ulp"], float(np.nan_to_num(
                dc[j], nan=np.inf)))
            gaps["objectness_gap"] = max(gaps["objectness_gap"], float(score[b].max() - score[b, j]))
            checked += 1
    run.counters["checked_rows"] = checked
    for name, value in gaps.items():
        run.check(name, value, float(run.limits[name]))


def check(run) -> None:
    common.plain_precision()
    _compare(run, run.state["steps"], _sample(run), run.devices[0])


def control(run) -> None:
    """The reference in the program's place in TF32: the schedule's first
    `sample` + 1 steps served by the reference's own boxes (its best
    proposal each step), held to the reference in float32 like the
    program's."""
    import torch

    data = tracklets.generate(run.mix, run.seed)
    dev = run.devices[0]
    sd = weights.make(run.reference().param_specs(run.cfg), run.seed, dev)
    run.state = {"sd": sd, "data": data, "steps": [], "window_from": 0}
    sched = Schedule([len(tr["points"]) for tr in data], int(run.mix["slots"]))
    ref = run.reference()
    common.tf32_precision()
    steps = run.state["steps"]
    for i in range(int(run.mix["sample"]) + 1):
        _, feed = sched.advance()
        steps.append({"feed": feed, "boxes": None})
        x = _inputs(run, steps, i, dev)
        cand, score = ref.step(sd, run.cfg, x["wlh"], x["ref"], x["first"], x["first_ok"],
                               x["prev"], x["prev_ok"], x["this"], x["this_ok"])
        best = torch.argmax(score, dim=1)
        steps[-1]["boxes"] = cand[torch.arange(len(feed)), best].cpu().numpy()
    common.plain_precision()
    _compare(run, steps, list(range(len(steps))), dev)
