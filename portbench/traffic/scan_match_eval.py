"""Traffic runner `scan_match_eval`: a test-split evaluation on the port's
scan tracker of the matching models (`MatchScanTracker`, BAT here),
repeated over the same tracklets for the window.

Set-up, window and release are `scan_eval`'s (portbench/traffic/
scan_eval.py): the configuration's weights and the mix's tracklets from
the seed, two warm passes of `evaluate_with_tracker` with an in-memory prep
cache (every batch shape captured as a graph), then whole passes for the
window, `eval_frames_per_s` over the real tracked frames, the same spans
(`scan.dispatch_scored`) and counters (`frames`, `loops`, ...). The tracker
is built with the mix's `max_points` and `first_crop_points`, each at least
the largest frame and first crop the mix makes, so that no frame and no
crop is cut.

The check takes one pass drawn from the seed and holds every real frame of
its checked batches (drawn from the seed, the one with the longest
tracklet among them, while their steps fit the cell's `check_steps`) to
the plain reference (portbench/reference/bat.py::step) from the program's
own boxes: step t of a tracklet takes the program's box of frame t - 1 as
its reference box (the first box at t = 0), the tracklet's first crop and
its raw frames t and t + 1, and computes every proposal composed onto that
box. The program's box is matched to the nearest proposal (centre and
angle in float32 ulps, `common.ulp_gap`); its centre's gap and its
objectness below the reference's best are compared, as in the online cell.
Since every step starts from the program's box, the reference runs the
steps of many frames side by side, `BLOCK` rows a call. The distances the
card scores are held to float64 distances of the program's boxes; the
IoUs' gap is recorded (`iou_gap`) and not compared: with the seed's
weights BAT soon loses the object, the IoUs are then 0 on both sides, and
the control's IoUs read as close as the program's on some seeds (PERF.md).
The control (`control`) puts the reference in the program's place in
TF32, stepping from its own best proposals, its scores in bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import weights
from portbench.reference import common
from portbench.traffic import scan_eval as se
from portbench.traffic import tracklets

BLOCK = 128  # reference rows a call: its ball queries' dense (rows, S, N) matrices fit in a few GB

window, release = se.window, se.release


def setup(run) -> None:
    from open3dsot_tpu_torch.models import get_model
    from open3dsot_tpu_torch.tracking.scan_matching import MatchScanTracker

    cfg = run.port_config()
    dev = run.devices[0]
    sd = weights.make(run.reference().param_specs(run.cfg), run.seed, dev)
    model = get_model(run.cfg["net_model"])(cfg, device=dev)
    model.net.load_state_dict(sd)
    run.phase("model")
    data = tracklets.generate(run.mix, run.seed)
    seqs = se._frames(data)
    run.phase("traffic")
    devices = run.devices if len(run.devices) > 1 else None
    tracker = MatchScanTracker(model, cfg, max_points=int(run.mix["max_points"]),
                               first_crop_points=int(run.mix["first_crop_points"]),
                               frame_bucket=int(run.mix["frame_bucket"]), devices=devices)
    run.state = {"sd": sd, "data": data, "seqs": seqs, "model": model, "cfg": cfg,
                 "tracker": tracker, "prep": {}, "records": [], "current": None, "pass": -1}
    for i in range(2):  # capture every batch shape, fill the prep cache, run warm
        se._pass(run)
        run.synchronize()
        run.phase(f"pass{i}")
    run.state["records"].clear()
    se._spy(run)


def _init(tr) -> np.ndarray:
    th = float(tr["theta"][0])
    return np.append(tr["center"][0], np.arctan2(np.sin(th), np.cos(th))).astype(np.float32)


def _reference(run, sd, rows: list, device):
    """The reference step of each row (tracklet k, step t, reference box):
    -> every proposal (n, P, 4) float64 and its objectness (n, P)."""
    ref, data = run.reference(), run.state["data"]
    P, P1 = int(run.mix["max_points"]), int(run.mix["first_crop_points"])
    firsts, cands, scores = {}, [], []
    for lo in range(0, len(rows), BLOCK):
        x = {k: [] for k in ("wlh", "ref", "first", "first_ok", "prev", "prev_ok", "this",
                             "this_ok")}
        for k, t, box in rows[lo:lo + BLOCK]:
            tr = data[k]
            if k not in firsts:
                firsts[k] = ref.first_crop(tr["points"][0], tr["center"][0],
                                           float(tr["theta"][0]), tr["wlh"], run.cfg, P1)
            fp, n1 = firsts[k]
            for key, val in zip(x, (np.asarray(tr["wlh"], np.float32), box, fp, np.arange(P1) < n1,
                                    *common.pad_frame(tr["points"][t], P),
                                    *common.pad_frame(tr["points"][t + 1], P))):
                x[key].append(val)
        x = {k: torch.from_numpy(np.stack(v)).to(device) for k, v in x.items()}
        cand, score = ref.step(sd, run.cfg, x["wlh"], x["ref"].float(), x["first"], x["first_ok"],
                               x["prev"], x["prev_ok"], x["this"], x["this_ok"])
        cands.append(cand.cpu().numpy().astype(np.float64))
        scores.append(score.cpu().numpy())
    return np.concatenate(cands), np.concatenate(scores)


def _compare(run, sample: list, device) -> None:
    """Hold every real frame of the sampled batches to the reference."""
    data = run.state["data"]
    cards = max(1, len(run.devices))
    rows, where = [], []
    for r, rec in enumerate(sample):
        ids = se._rows(rec["ids"], cards)
        for b in range(len(rec["ids"])):
            tr = data[ids[b]]
            for t in range(len(tr["points"]) - 1):
                rows.append((ids[b], t, _init(tr) if t == 0 else rec["boxes"][b, t - 1]))
                where.append((r, b, t))
    cand, score = _reference(run, run.state["sd"], rows, device)
    got = np.stack([sample[r]["boxes"][b, t] for r, b, t in where]).astype(np.float64)
    bad = ~np.isfinite(got).all(axis=1)
    run.failed += int(bad.sum())
    dc = common.ulp_gap(cand[..., :3], got[:, None, :3]).max(axis=2)
    da = common.ulp_gap(cand[..., 3], got[:, None, 3], angle=True)
    j = np.argmin(np.nan_to_num(np.maximum(dc, da), nan=np.inf), axis=1)
    n = np.arange(len(where))
    gaps = {"box_center_gap_ulp": float(np.nan_to_num(dc[n, j], nan=np.inf).max()),
            "objectness_gap": float((score.max(axis=1) - score[n, j]).max()),
            "iou_gap": 0.0, "distance_gap_m": 0.0}
    if bad.any():
        gaps["box_center_gap_ulp"] = np.inf
    # the angle is matched on but not compared, as in the online cell (PERF.md)
    run.counters.update(checked_frames=len(where), matched_angle_gap_ulp=float(
        np.nan_to_num(da[n, j], nan=np.inf).max()))
    for rec in sample:
        ids = se._rows(rec["ids"], cards)
        for b in range(len(rec["ids"])):
            tr = data[ids[b]]
            th = np.arctan2(np.sin(tr["theta"]), np.cos(tr["theta"]))
            wlh = np.asarray(tr["wlh"], np.float32)
            for t in range(len(tr["points"])):
                pred = _init(tr) if t == 0 else rec["boxes"][b, t - 1]
                iou, dist = common.overlap_accuracy(np.append(tr["center"][t], th[t]), tr["wlh"],
                                                    pred, wlh)
                gaps["iou_gap"] = max(gaps["iou_gap"], abs(float(rec["iou"][b, t]) - iou))
                gaps["distance_gap_m"] = max(gaps["distance_gap_m"],
                                             abs(float(rec["dist"][b, t]) - dist))
    run.counters["iou_gap"] = gaps.pop("iou_gap")
    for name, value in gaps.items():
        run.check(name, value, float(run.limits[name]))


def check(run) -> None:
    common.plain_precision()
    _compare(run, run.state["sample"], run.devices[0])


def control(run) -> None:
    """The reference in the program's place in the nearest precision below
    float32: the batches a run checks, every row stepped in TF32 from its
    own best proposal, its scores of those boxes in bfloat16; held to the
    float32 reference as the program's are."""
    data = tracklets.generate(run.mix, run.seed)
    dev = run.devices[0]
    sd = weights.make(run.reference().param_specs(run.cfg), run.seed, dev)
    run.state = {"sd": sd, "data": data}
    cards = max(1, len(run.devices))
    chosen = se._choose(run, data, se.batches(run, [len(t["points"]) for t in data]),
                        lambda b: b)
    rows = [(r, b, k) for r, ids in enumerate(chosen) for b, k in enumerate(se._rows(ids, cards))]
    T = max(len(data[k]["points"]) for _, _, k in rows)
    boxes = np.zeros((len(rows), T - 1, 4), np.float32)
    carry = np.stack([_init(data[k]) for _, _, k in rows])
    common.tf32_precision()
    for t in range(T - 1):
        alive = [i for i, (_, _, k) in enumerate(rows) if t < len(data[k]["points"]) - 1]
        cand, score = _reference(run, sd, [(rows[i][2], t, carry[i]) for i in alive], dev)
        carry[alive] = cand[np.arange(len(alive)), np.argmax(score, axis=1)]
        boxes[alive, t] = carry[alive]
    common.plain_precision()
    sample = []
    for r, ids in enumerate(chosen):
        mine = [i for i, row in enumerate(rows) if row[0] == r]
        iou, dist = np.zeros((len(mine), T)), np.zeros((len(mine), T))
        for b, i in enumerate(mine):
            tr = data[rows[i][2]]
            th = np.arctan2(np.sin(tr["theta"]), np.cos(tr["theta"]))
            for t in range(len(tr["points"])):
                pred = _init(tr) if t == 0 else boxes[i, t - 1]
                iou[b, t], dist[b, t] = common.overlap_accuracy(
                    se._bf16(np.append(tr["center"][t], th[t])), se._bf16(tr["wlh"]),
                    se._bf16(pred), se._bf16(np.asarray(tr["wlh"], np.float32)))
        sample.append({"ids": ids, "boxes": boxes[mine], "iou": iou, "dist": dist})
    _compare(run, sample, dev)
