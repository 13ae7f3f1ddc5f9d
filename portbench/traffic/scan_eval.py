"""Traffic runner `scan_eval`: a test-split evaluation on the port's scan
tracker, repeated over the same tracklets for the window.

Set-up makes the configuration's weights and the mix's tracklets from the
seed, builds the scan tracker (`M2ScanTracker`; split over every card the
cell asks for when it asks for more than one, the JAX package's `mesh=`),
and runs two passes of `evaluate_with_tracker` with an in-memory prep cache:
every batch shape is captured as a graph, every batch is padded and packed
into pinned memory, as a user's re-run of an eval with `--eval_prep_cache`.
The window then runs whole passes (batches of `batch` tracklets, scores on
the card, `depth` batches in flight) while the next one is expected to end
inside `--seconds`, and at least one. `eval_frames_per_s` is the real
tracked frames (T - 1 a tracklet, no padding) of the passes run, over the
window's length, every batch's scores on the host by its end.

The check takes one pass drawn from the seed and holds every frame of it to
the plain reference (portbench/reference/<model>.py), step by step from the
program's own boxes: step t gets the program's box of frame t - 1 as its
reference box (the tracklet's first box at t = 0), crops and resamples the
frames itself from the raw points, runs the plain net, and its box is
compared with the program's box of frame t, in float32 units in the last
place (`common.ulp_gap`). The scores on the card are held
to float64 scores of the program's boxes. The batches checked are drawn
from the seed (`_choose`), the one with the longest tracklet among them,
as many as the cell's `check_steps` allow. The control (`control`) puts
the reference in the program's place in TF32, its scores in bfloat16.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np

from portbench import stats, weights
from portbench.reference import common
from portbench.traffic import tracklets


def _frames(data: list) -> list:
    """The tracklets as the port's datasets give them: per frame a dict of
    its PointCloud (3, N) and ground-truth Box, tagged with the tracklet's
    index (`bench_id`), which the program ignores."""
    from open3dsot_tpu_torch.geometry import Box, PointCloud, Quaternion

    seqs = []
    for i, tr in enumerate(data):
        seqs.append([{"pc": PointCloud(p.T), "meta": None, "bench_id": i,
                      "3d_bbox": Box(tr["center"][t], tr["wlh"],
                                     Quaternion(axis=[0.0, 0.0, 1.0], radians=float(tr["theta"][t])))}
                     for t, p in enumerate(tr["points"])])
    return seqs


def setup(run) -> None:
    import torch
    from open3dsot_tpu_torch.models import get_model
    from open3dsot_tpu_torch.tracking.scan_tracker import M2ScanTracker

    cfg = run.port_config()
    dev = run.devices[0]
    sd = weights.make(run.reference().param_specs(), run.seed, dev)
    model = get_model(run.cfg["net_model"])(cfg, device=dev)
    model.net.load_state_dict(sd)
    run.phase("model")
    data = tracklets.generate(run.mix, run.seed)
    seqs = _frames(data)
    run.phase("traffic")
    devices = run.devices if len(run.devices) > 1 else None
    tracker = M2ScanTracker(model, cfg, max_points=int(run.mix["max_points"]),
                            frame_bucket=int(run.mix["frame_bucket"]), devices=devices)
    st = run.state = {"sd": sd, "data": data, "seqs": seqs, "model": model, "cfg": cfg,
                      "tracker": tracker, "prep": {}, "records": [], "current": None, "pass": -1}
    for i in range(2):  # capture every batch shape, fill the prep cache, run warm
        _pass(run)
        run.synchronize()
        run.phase(f"pass{i}")
    st["records"].clear()
    _spy(run)
    del torch


def _pass(run) -> None:
    from open3dsot_tpu_torch.tracking.scan_tracker import evaluate_with_tracker

    st = run.state
    st["pass"] += 1
    evaluate_with_tracker(st["tracker"], st["model"], st["seqs"], st["cfg"],
                          int(run.mix["batch"]), None, True, int(run.mix["depth"]), st["prep"])


def _spy(run) -> None:
    """Record each batch's dispatch: a span around it, its tracklets, the
    boxes the tracker hands its scorer (gathered on the first card where it
    is split) and the scores; and each frame loop's shape. The wrappers sit
    on the instances."""
    st = run.state
    tracker = st["tracker"]
    dispatch_scored, dispatch = tracker.dispatch_scored, tracker._dispatch

    def spy_dispatch_scored(seqs, prep_cache=None, cache_key=None):
        rec = {"pass": st["pass"], "ids": [s[0]["bench_id"] for s in seqs], "loops": []}
        st["current"] = rec
        with run.spans.span("scan.dispatch_scored"):
            iou, dist = dispatch_scored(seqs, prep_cache, cache_key)
        rec["iou"], rec["dist"] = iou, dist
        st["records"].append(rec)
        return iou, dist

    def spy_dispatch(host, gt):
        out = dispatch(host, gt)
        st["current"]["boxes"] = out[0]
        return out

    tracker.dispatch_scored, tracker._dispatch = spy_dispatch_scored, spy_dispatch
    for part in tracker.parts or [tracker]:
        def track_frames(pts, *args, _orig=part.track_frames):
            st["current"]["loops"].append((int(pts.shape[0]), int(pts.shape[1])))
            return _orig(pts, *args)

        part.track_frames = track_frames


def window(run, seconds: float) -> None:
    st = run.state
    frames_per_pass = sum(len(s) - 1 for s in st["seqs"])
    t0 = time.perf_counter()
    passes = 0
    while True:
        _pass(run)
        passes += 1
        elapsed = time.perf_counter() - t0
        if elapsed + elapsed / passes > seconds:
            break
    run.e2e["eval_frames_per_s"] = stats.rate(frames_per_pass * passes, elapsed)
    run.counters.update(passes=passes, frames=frames_per_pass * passes, window_s=elapsed,
                        batches=len(st["records"]), loops=[x for r in st["records"]
                                                           for x in r["loops"]],
                        cfg=run.cfg)
    run.attempted = frames_per_pass * passes


def release(run) -> None:
    """Keep the checked batches' outputs on the host; drop the program."""
    st = run.state
    passes = run.counters["passes"]
    pick = int(np.random.default_rng([run.seed & 0xFFFFFFFF, run.seed >> 32, 7]).integers(passes))
    first = st["records"][0]["pass"]
    recs = [r for r in st["records"] if r["pass"] == first + pick]
    sample = [{"ids": r["ids"], "boxes": r["boxes"].cpu().numpy(), "iou": r["iou"].cpu().numpy(),
               "dist": r["dist"].cpu().numpy()}
              for r in _choose(run, st["data"], recs, lambda r: r["ids"])]
    run.state = {"sd": st["sd"], "data": st["data"], "sample": sample}


def _choose(run, data, batches: list, ids_of) -> list:
    """The batches to check, drawn from the seed: the one that holds the
    longest tracklet, then others in a seeded order while their steps fit
    the cell's `check_steps` (the reference's time)."""
    steps = [max(len(data[i]["points"]) for i in ids_of(b)) - 1 for b in batches]
    longest = int(np.argmax(steps))
    rng = np.random.default_rng([run.seed & 0xFFFFFFFF, run.seed >> 32, 8])
    order = [longest] + [int(i) for i in rng.permutation(len(batches)) if i != longest]
    chosen, used = [], 0
    for i in order:
        if not chosen or used + steps[i] <= int(run.mix["check_steps"]):
            chosen.append(batches[i])
            used += steps[i]
    return chosen


def _rows(ids: list, cards: int) -> list:
    """A batch's rows as the tracker pads them: the last repeated up to a
    multiple of the cards."""
    return list(ids) + ids[-1:] * (-len(ids) % cards)


def _batch_arrays(data, ids, T_pad, P):
    """The batch's frames padded (pad_frame) into (B, T_pad, P, 3) and
    (B, T_pad, P) validity, its init boxes (B, 4) and sizes (B, 3)."""
    B = len(ids)
    pts = np.zeros((B, T_pad, P, 3), np.float32)
    valid = np.zeros((B, T_pad, P), bool)
    init = np.zeros((B, 4), np.float32)
    wlh = np.zeros((B, 3), np.float32)
    for b, i in enumerate(ids):
        tr = data[i]
        for t, p in enumerate(tr["points"]):
            pts[b, t], valid[b, t] = common.pad_frame(p, P)
        th = float(tr["theta"][0])
        init[b] = np.append(tr["center"][0], np.arctan2(np.sin(th), np.cos(th)))
        wlh[b] = tr["wlh"]
    return pts, valid, init, wlh


def _ref_steps(run, sd, ids, boxes_in, device, T_steps, follow: bool):
    """The reference over a batch, step by step: with `follow`, step t takes
    boxes_in[:, t - 1] (the program's) as its reference box; else its own
    previous box (the control). -> (B, T_steps, 4) numpy."""
    import torch

    ref = run.reference()
    P = int(run.mix["max_points"])
    pts, valid, init, wlh = _batch_arrays(run.state["data"], ids, T_steps + 1, P)
    pts_d, valid_d = torch.from_numpy(pts).to(device), torch.from_numpy(valid).to(device)
    wlh_d, box = torch.from_numpy(wlh).to(device), torch.from_numpy(init).to(device)
    out = np.zeros((len(ids), T_steps, 4), np.float32)
    for t in range(T_steps):
        if follow and t > 0:
            box = torch.from_numpy(np.ascontiguousarray(boxes_in[:, t - 1])).to(device)
        first = torch.full((len(ids), 1), t == 0, device=device)
        box = ref.step(sd, run.cfg, wlh_d, box, pts_d[:, t], valid_d[:, t], pts_d[:, t + 1],
                       valid_d[:, t + 1], first)
        out[:, t] = box.cpu().numpy()
    return out, init, wlh


def _compare(run, sample, device) -> None:
    """Hold each sampled batch's boxes and scores to the reference."""
    data = run.state["data"]
    cards = max(1, len(run.devices))
    gaps = defaultdict(float)
    checked = 0
    for rec in sample:
        ids = _rows(rec["ids"], cards)
        lens = [len(data[i]["points"]) for i in ids]
        T_steps = max(lens) - 1
        prog = rec["boxes"][:, :T_steps]
        want, init, wlh = _ref_steps(run, run.state["sd"], ids, prog, device, T_steps, True)
        for b in range(len(rec["ids"])):
            n = lens[b] - 1
            got, exp = prog[b, :n].astype(np.float64), want[b, :n].astype(np.float64)
            if not np.isfinite(got).all():
                run.failed += int((~np.isfinite(got).all(axis=1)).sum())
            gaps["box_center_gap_ulp"] = max(gaps["box_center_gap_ulp"], float(np.nan_to_num(
                common.ulp_gap(got[:, :3], exp[:, :3]), nan=np.inf).max()))
            gaps["box_angle_gap_ulp"] = max(gaps["box_angle_gap_ulp"], float(np.nan_to_num(
                common.ulp_gap(got[:, 3], exp[:, 3], angle=True), nan=np.inf).max()))
            checked += n
            if rec.get("iou") is None:
                continue
            tr = data[ids[b]]
            th = np.arctan2(np.sin(tr["theta"]), np.cos(tr["theta"]))
            for t in range(lens[b]):
                pred = init[b] if t == 0 else got[t - 1]
                gt = np.append(tr["center"][t], th[t])
                iou, dist = common.overlap_accuracy(gt, tr["wlh"], pred, wlh[b])
                gaps["iou_gap"] = max(gaps["iou_gap"], abs(float(rec["iou"][b, t]) - iou))
                gaps["distance_gap_m"] = max(gaps["distance_gap_m"],
                                             abs(float(rec["dist"][b, t]) - dist))
    run.counters["checked_frames"] = checked
    for name in ("box_center_gap_ulp", "box_angle_gap_ulp", "iou_gap", "distance_gap_m"):
        if name in gaps:
            run.check(name, gaps[name], float(run.limits[name]))


def check(run) -> None:
    common.plain_precision()
    _compare(run, run.state["sample"], run.devices[0])


def batches(run, lengths: list) -> list:
    """The tracker's batching of tracklets by length bucket (the control's)."""
    bucket = int(run.mix["frame_bucket"])
    by = defaultdict(list)
    for i, T in enumerate(lengths):
        by[max(2, -(-T // bucket) * bucket)].append(i)
    B = int(run.mix["batch"])
    return [ids[j:j + B] for _, ids in sorted(by.items()) for j in range(0, len(ids), B)]


def _bf16(x) -> np.ndarray:
    import torch

    return torch.tensor(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def control(run) -> None:
    """The reference in the program's place in the nearest precision below
    float32: its steps in TF32 from its own boxes, its scores of them in
    bfloat16; the batches a run checks, held to the reference as the
    program's are."""
    data = tracklets.generate(run.mix, run.seed)
    dev = run.devices[0]
    sd = weights.make(run.reference().param_specs(), run.seed, dev)
    run.state = {"sd": sd, "data": data}
    cards = max(1, len(run.devices))
    sample = []
    for ids in _choose(run, data, batches(run, [len(t["points"]) for t in data]), lambda b: b):
        rows = _rows(ids, cards)
        lens = [len(data[i]["points"]) for i in rows]
        common.tf32_precision()
        boxes, init, wlh = _ref_steps(run, sd, rows, None, dev, max(lens) - 1, False)
        iou, dist = np.zeros((len(rows), max(lens))), np.zeros((len(rows), max(lens)))
        for b, i in enumerate(ids):
            tr = data[i]
            th = np.arctan2(np.sin(tr["theta"]), np.cos(tr["theta"]))
            for t in range(lens[b]):
                pred = init[b] if t == 0 else boxes[b, t - 1]
                iou[b, t], dist[b, t] = common.overlap_accuracy(
                    _bf16(np.append(tr["center"][t], th[t])), _bf16(tr["wlh"]), _bf16(pred),
                    _bf16(wlh[b]))
        sample.append({"ids": ids, "boxes": boxes, "iou": iou, "dist": dist})
    common.plain_precision()
    _compare(run, sample, dev)
