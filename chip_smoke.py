#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (open3dsot_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --chain-times   # phases 1-3 only (K1/K2), no result line
    python3 chip_smoke.py --k6-times      # phases 1, 2 and 11 only (K6), no result line
    python3 chip_smoke.py --k4-times      # phases 1, 2 and 7 only (K4/K5), no result line
    python3 chip_smoke.py --k3-times      # phases 1, 2 and 6 only (K3), no result line
    python3 chip_smoke.py --scan-times    # phases 1, 2 and 15 only (M2 scan), no result line
    python3 chip_smoke.py --match-scan-times  # phases 1, 2 and 16 only (BAT/P2B scan), no result
    python3 chip_smoke.py --online-times  # phases 1, 2 and 17 only (online trackers), no result
    python3 chip_smoke.py --eager-rates   # phases 1, 2 and the eager paths' frames/s, no result
    python3 chip_smoke.py --bf16-times    # phases 1, 2 and 18 only (the bf16 mode), no result
    python3 chip_smoke.py --bf16-breakdown  # phases 1, 2, the bf16 K1/K2/K4 breakdown, no result
    python3 chip_smoke.py --k6-bf16-times # phases 1, 2 and 19 only (K6 in bf16), no result
    python3 chip_smoke.py --train-times   # phases 1, 2 and 19-21 (bf16 and M2 training), no result
    python3 chip_smoke.py --device-sampler-times  # phases 1, 2 and 22 (device sampler), no result

Phases, one line or a few each; any failure exits non-zero:
  1. environment: torch / CUDA versions, the card's name and power limit;
     fails without a CUDA device.
  2. build: the kernels of csrc/ with nvcc, one process per source, side by
     side (seconds, registers, spills, ptxas's notes on wgmma).
  3. kernels K1/K2 (3xTF32 on the tensor cores) against their plain f32
     PyTorch versions at the M2 path's four calls (seg mlp1 with its tap,
     mini, mini2, seg head) at B = 1 and 16, N = 2048, and at B = 3, a
     ragged N = 2000 and N = 40; event and device times at B = 1 and 16
     beside the plain versions, the plain stack through cuBLAS in TF32 and
     both bounds (f32 CUDA cores, 3xTF32 tensor cores); the HMMA/HGMMA count
     of each kernel in the library's SASS (fails if K1/K2's kernels have none).
  4. the M2-Track forward on the card: kernel path vs plain path (seg
     logits) and vs the plain path in float64 (boxes), and the launch counts
     of one forward (K1 = 3, K2 = 1).
  5. the M2 slice through its entry points: tracking.eval.evaluate_dataset
     on the synthetic dataset at point_sample_size 1024, and the CLI in a
     subprocess; Success/Precision, frames/s, launch counts, a short
     profiler window.
  6. K3 (FPS) against its plain version, index for index, in both winner
     forms: at the BAT path's shapes (B = 1, 16 and 50, N 1024 -> 512 and
     512 -> 256) on a continuous cloud and on one with duplicated points
     (ties), and on an all-identical cloud, ragged N = 1000 and 33, N =
     8192 -> 2048 and npoint = N; times at BAT's shapes against bound_ms
     and, at B = 1, against the skeleton floor of the v1 and of the v2
     design (each design's serial step skeleton alone on its block for
     npoint - 1 steps, probes/fps_floor.py, csrc/fps_floor.cu); K3's
     launches against the profiler's records of them in a window that
     opens on K3 and in one that opens on a sleep kernel; the block sweep
     (every T from 32 to 1024 with PPT <= 32, both winner forms, at N =
     512 to 16384, each checked).
  7. K4 (3xTF32 on the tensor cores) against sa_eval_plain at each of the
     seven SA calls of a BAT forward at cfgs/BAT_Car.yaml widths, on the
     inputs that forward gives them (B = 1 and 16); K5 (indices from the
     plain ball query) against K4; two ragged centroid counts; K5 with an
     index out of range (its centroid's output NaN, the others unchanged);
     times by events and by profiler device time over one forward's seven
     calls, device time by kernel name, both bounds (f32 CUDA cores, 3xTF32
     tensor cores) and the share; each call again in both gather forms
     (16-byte loads, cp.async) forced, against the plain version and timed;
     weights of a wrong shape refused before the kernel; the HMMA/HGMMA
     count of K4's product kernels (fails if one has none).
  8. the BAT forward, kernel path vs plain path (B = 1 and 16), with the
     launches of one forward (K3 = 2, K4 = 7); P2B once (K4 = 7).
  9. the BAT slice through its entry points: evaluate_dataset on the
     synthetic dataset at BAT_Car widths (both paths), a profiler window
     (K3's launches in it beside the profiler's records of them), and the
     CLI on cfgs/BAT_synthetic.yaml.
 10. printed last, after phase 22: one JSON line of the kernels K1-K6 and
     the probes P1/P2, then K1/K2/K4/K5 and K6 (forward, backward) in the
     bf16 mode (each with its bound from this run's shapes), the card line,
     then the result line.
 11. K6 (training-mode SA, 3xTF32 on the tensor cores) forward and backward
     against their plain versions at the four K6 calls of a BAT train step at
     BAT_Car widths, on the inputs that step gives them (B = 16 and 50, and a
     ragged S); times by events and by profiler device time, both bounds (f32
     CUDA cores, 3xTF32 tensor cores) and the share; device time by kernel
     name over the four calls at B = 50, forward and backward apart; the
     HMMA/HGMMA count of K6's product kernels (fails if one has none).
 12. a BAT train step, kernel path vs plain path, both held against the plain
     path in float64: losses, every gradient, the running statistics, and
     the launches of one step (K3 = 2, K6 forward = 4, backward = 4); P2B
     once (K3 = 0, K6 = 4 / 4).
 13. BAT training through its entry points: Trainer.fit at BAT_Car widths,
     B = 50, on the synthetic dataset with validation on one tracklet
     (steps/s, host sample building against the step, a profiler idle
     share), then the training CLI on cfgs/BAT_synthetic.yaml in a
     subprocess.
 14. the probes P1 and P2 through their entry points (probes/gather.py,
     probes/gather_bf16.py): every gather form against its plain version
     (exact, the one-hot form by allclose), the per-element gather, the
     one-hot's row sums and the bf16 gather (max |diff| 0), at P1's and P2's
     own shapes and at K4's gather shapes (B = 1 and 16), with times by
     events (host included) and by events behind a queued sleep (device
     only), beside the plain versions and torch.gather.
 15. the M2 scan tracker (tracking/scan_tracker.py) at bench.py's
     configuration (16 tracklets x 64 frames, max_points 1024,
     frame_bucket 64, N = 2048, box_aware) at B = 1, 8 and 16: the graph
     path's boxes bit-identical to the eager path's (B = 1 and 16); no host
     sync in the frame loop (torch.cuda.set_sync_debug_mode "error");
     frames/s of both paths with the batch on the card, device busy per
     frame and idle share (profiler), H2D of a batch from pinned memory;
     K1/K2's kernels per step in a profiler window of replays against the
     eager steps' (K1 x3, K2 x1 by the wrappers); at B = 16 the first-step
     boxes against the plain path run in float64 and the scorer's time; then
     evaluate_dataset_scan from launch counts of 0 on a fresh tracker (K1/K2
     captured per replay x replays), its on-device scoring against host
     scoring (every frame within 3e-4; Success/Precision equal but for the
     frame-0 self-IoUs, which round to 1.0 or just below it on either side),
     the plain path's Success/Precision, the graph captured again after new
     weights (equal to eager), and the CLI with --tracker scan.
 16. the matching scan tracker (tracking/scan_matching.py) at bench.py's
     matching configuration (BAT_Car widths, 16 tracklets x 64 frames,
     max_points 1024, frame_bucket 64, first_crop_points 1024,
     firstandprevious, previous_result, use_z and limit_box off) at B = 1, 8
     and 16: the graph path's boxes bit-identical to the eager path's; no
     host sync in the frame loop; frames/s of both paths with the batch on
     the card, device busy per frame and idle share, H2D of a batch; K3 x2
     and K4 x7 a step by the wrappers (captured per replay, and over the
     eager steps) and by the profiler's records of their kernels in windows
     of replays and of eager steps; at B = 16 the first-step boxes against
     the plain path run in float64 (BOX_ATOL) and the scorer's time; P2B_Car
     (camera basis, limit_box 'uniform', no FPS: K4 x7, K3 x0) at B = 8,
     BAT_Pedestrian's limit_box 'uniform' and shape_aggregation 'all' at B
     = 8, each graph against eager; evaluate_dataset_scan_matching from
     launch counts of 0 on a fresh tracker, its on-device scoring against
     host scoring (phase 15's rule), the plain path's Success/Precision, and
     the CLI with --tracker scan on cfgs/BAT_synthetic.yaml.
 17. the online trackers (tracking/online.py) at scripts/bench_online.py's
     configurations (M2 point_sample_size 1024 box_aware; BAT_Car and
     P2B_Car widths, firstandprevious, previous_result, use_z and limit_box
     off; max_points 1024, first_crop_points 512) on synthetic tracklets of
     17 frames, M2 and BAT at B = 8, 16 and 32 slots, P2B at B = 16: the
     graph path's boxes bit-identical to the scan tracker's at the same B
     and to the eager advance's, and its first step held to the plain path
     run in float64 at every B (M2 by `compare`, BAT/P2B at BOX_ATOL, as
     phases 15 and 16 hold theirs); a stream started mid-flight against the
     same stream alone (bit-identical at the same B; alone at B = 1 the
     first step held at 1e-4 and the whole trajectory at BOX_ATOL, the
     recurrence compounding the first step's rounding); launches a replay by the wrappers
     (M2 K1 3 / K2 1, BAT K3 2 / K4 7, P2B K4 7) and by the profiler's
     records; no host sync in the uploads and replays; wall time a step
     (median of 50 `step()` calls) and its split (padding / H2D / replay and
     fetch), device time a step and idle share (profiler, one step),
     frames/s; the eager advance's at B = 16; the int16 path against the
     f32 path fed the dequantized rows; serving bundles of the M2 and BAT
     trackers (B = 16) saved with torch.export and loaded in the same
     process: 16 steps against the live tracker's, their launches, and the
     loaded graph's replay time against the live graph's; the host time a
     call of K1, K3 and K4 through their wrappers, through their operators
     and through their CUDA kernel functions called directly. Then the host
     loops' and eager scans' frames/s of this run (phases 5, 9, 15, 16)
     beside this script's last run before the kernels became operators.
     `--eager-rates` measures those frames/s alone, through entry points an
     older tree has too, to compare two trees in one call.
 18. the bf16 compute mode of eval (`bf16: true`): the M2 and BAT host loops
     under bf16, kernel path against plain path on one forward (B = 1 and
     16; the kernel path's distance from the f32 path between 0.5x and 1.5x
     the plain bf16 path's; launches a forward K1 3 / K2 1, K3 2 / K4 7),
     then evaluate_dataset from launch counts of 0 (the bf16 rows'
     launches); K1 at M2's three calls and K2 (B = 1 and 16, N = 2048) and
     K4/K5 at the seven SA calls of a bf16 BAT forward (B = 1 and 16)
     against their plain bf16 versions (max error within 2^-6 and mean
     within 2^-14 of max|plain|, K2's seg argmax on > 99% of points; the f32
     plain versions on the same inputs must fall outside those limits),
     event and device times beside the plain versions, K1/K2's plain stack
     through cuBLAS in bf16, and the bound at
     989 TFLOP/s dense bf16; M2ScanTracker(compute_dtype=bf16) and
     MatchScanTracker on a bf16 BAT at B = 8: graph == eager bit for bit,
     launches a replay, frames/s.
 19. K6 in the bf16 mode (csrc/sa_fused_train_bf16.cu), forward and
     backward, against its plain bf16 version at the four K6 calls of a BAT
     train step (B = 16 and 50) and at one SA layer 3 cut to widths 512 (B =
     16): each output and the grids h1, h2 within 2^-6 (max) and 2^-14
     (mean) of max|plain|, the f32 plain version outside those limits
     (printed only for the batch statistics), the backward of both at the
     kernel forward's grids; times beside the 3xTF32 K6 on the same inputs
     in this call and the same products as cuBLAS bf16 GEMMs, device time by
     events behind a queued sleep, the bound at 989 TFLOP/s bf16; device
     time by kernel of each pass of both modes at B = 50; the HMMA and
     HGMMA counts of the 17 bf16 product kernels (wgmma alone).
 20. training under bf16: a BAT bf16 train step (K6 in bf16; K3 2, K6 4 / 4
     launches) and the plain bf16 path, both against the plain path in
     float64 (B = 16), the f32 path's distance beside them; the K6 layers'
     18 leaves of the kernel path within 2^-8 (max) / 2^-12 (mean) of the
     plain bf16 K6 backward at the step's own K6 inputs, cotangents and
     kernel-forward grids, the plain f32 K6 outside; parameters and
     gradients f32; the B = 50 step's time against the f32 step's in this
     call (wall, device busy, idle share); then Trainer.fit in bf16 (two
     epochs of three steps, validation on the bf16 scan tracker) from launch
     counts of 0: K6 bf16 24 / 24.
 21. M2-Track training at cfgs/M2_track_kitti.yaml's widths (1024 points,
     box_aware) on the synthetic motion sampler, f32 and bf16: the B = 16
     step against the plain path in float64 (f32 held: loss terms 1e-3,
     gradients 5e-2; bf16 printed), the B = 100 step's time on a prebuilt
     batch (wall, device busy, idle share), and Trainer.fit validating on
     M2ScanTracker (steps/s, the loader's wait, train/acc_* logged).
 22. training with samples built on the card (data/device_sampler.py): (a)
     the threefry draws (split, bits, randint with a per-row maxval,
     bernoulli, uniform, normal) on the card against the CPU, bit for bit
     (normal within prng.NORMAL_ULPS); (b) one raw batch built on the card
     and on the CPU with one key, M2 at cfgs/M2_track_kitti.yaml's widths (B
     = 100, also int16-packed) and BAT at cfgs/BAT_Car.yaml's (B = 50, 4
     candidates): within 1e-5, labels equal but on their box's faces, no
     host sync in the pinned copy and the build, the raw batch's host ms
     and the build's device ms; (c) BAT Trainer.fit with device_sampler in
     f32 and bf16 (no validation): steps/s, samples/s, the loader's wait
     beside phase 13's / 20's host-sampler steps/s, K3 2 and K6 4 + 4
     launches a step, bf16 again with the loader's one thread (workers 0);
     (d) M2 Trainer.fit with device_sampler, f32, int16 transfer and
     workers 0, beside phase 21's; (e) resume on the card: M2 2 + 2 epochs
     against 4 under torch's deterministic algorithms (step, epoch, LR go
     on; weights bit for bit), save_top_k 1 leaves one ckpt_ep*.pt. Its
     lines also go to chiprun_out/phase22.txt.

Weights are random, made with numpy from a seed in the JAX tree's shape
(open3dsot_tpu_torch.weights). Needs one card; no network.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 7
N_POINTS = 1024  # point_sample_size of cfgs/M2_track_kitti.yaml; N = 2 frames

# Tolerance of a kernel against its plain version: |k - p| <= ATOL_REL *
# max|p| + RTOL * |p|. Both sides accumulate in f32 and differ in summation
# order (a kernel's FMA chain or tensor-core sums; cuBLAS: blocked partial
# sums). That error grows like sqrt(K) * 2^-24 of the terms' size, about 1e-6
# relative at K <= 1088 over five layers; K1/K2's 3xTF32 products drop a
# further 2^-22 of each product (ops/chain_fused.py::TOL_3XTF32, the same
# bound, which the CPU tests hold an emulation of that arithmetic to against
# float64). 1e-4 leaves two orders of magnitude of margin, while a wrong
# index, a masked row in the pool or a missed tile gives errors of order one.
RTOL = 1e-4
ATOL_REL = 1e-4
BOX_ATOL = 1e-3  # M2: two argmax gates and the rigid math; BAT/P2B: three SA layers,
                 # the xcorr and the vote SA before the proposal regression. M2's
                 # boxes are held to the plain path in float64: the second
                 # MiniPointNet and its box head amplify rounding some twenty-fold,
                 # so the plain path's own float32 boxes sit up to 7e-4 from float64
                 # and two float32 paths can differ by more than 1e-3 (phase 4
                 # prints all three distances)
MATCHING_CFG = {"bat": "cfgs/BAT_Car.yaml", "p2b": "cfgs/P2B_Car.yaml"}
TRAIN_B = 50  # batch_size of cfgs/BAT_Car.yaml
K6_BATCHES = (16, TRAIN_B)  # phase 11's batch sizes; the last one is TRAIN_B
# Published peaks of one H100 SXM (NVIDIA's data sheet, at 700 W): float32
# outside the tensor cores, and HBM3. A kernel's bound is the larger of its
# operations over the first and its bytes (each input read once, each output
# written once) over the second.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# Dense TF32 on the tensor cores (the same data sheet). K1/K2 take three TF32
# products per multiply-add (3xTF32), so their bound counts 3x their FLOP at
# this rate.
PEAK_TF32_FLOPS = 494.7e12
# Frames/s of the paths that call the kernels' operators eagerly, filled by
# phases 5, 9, 15 and 16 and printed after phase 17 beside BEFORE_OPERATORS:
# the same phases in this script's last run on an NVIDIA H100 80GB HBM3 at
# 700 W before the wrappers called the kernels through operators (they
# launched them through ctypes directly then; PERF.md keeps that run).
EAGER_RATES: dict = {}
BEFORE_OPERATORS = {"M2 host loop": 144.88, "BAT host loop": 109.69,
             "M2 eager scan B=1": 121.81, "M2 eager scan B=8": 1313.51,
             "M2 eager scan B=16": 1815.32, "BAT eager scan B=1": 150.43,
             "BAT eager scan B=8": 973.71, "BAT eager scan B=16": 1778.91}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def compare(name: str, got, want) -> float:
    import torch

    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite values")
    err = (got - want).abs()
    scale = want.abs().max().item()
    bad = err > ATOL_REL * scale + RTOL * want.abs()
    max_abs = err.max().item()
    max_rel = (err / want.abs().clamp_min(1e-6 * max(scale, 1e-30))).max().item()
    print(f"  {name}: max_abs_err {max_abs:.3e} max_rel_err {max_rel:.3e} "
          f"(max|ref| {scale:.3e}) {'FAIL' if bad.any() else 'ok'}", flush=True)
    if bad.any():
        fail(f"{name}: {int(bad.sum())} values outside tolerance")
    return max_abs


def time_ms(fn, iters: int = 20, repeats: int = 7) -> float:
    """Median over `repeats` of the mean time of `iters` back-to-back calls,
    from CUDA events around the run."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def dev_us(e) -> float:
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


LEAD_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel


def device_rows(fn) -> list:
    """Key averages of the device work that fn() runs, from a profiler trace.
    A window that opens on fn's first kernel can lose that kernel's record
    (phase 6 counts them), so a short sleep kernel opens it, and its row is
    left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(100)
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA")
            and dev_us(e) > 0 and LEAD_KERNEL not in e.key]


def device_ms(fn, iters: int = 10):
    """Device time per call: the kernels and copies of `iters` calls, summed
    from a profiler trace, without the time the device waits for the host
    between them (which time_ms counts). A trace now and then holds no device
    event at all, so up to three are taken; None if none of them has one."""
    fn()
    for _ in range(3):
        total = sum(dev_us(e) for e in device_rows(lambda: [fn() for _ in range(iters)]))
        if total > 0:
            return total / iters / 1e3
    return None


def queued_ms(fn, iters: int = 20, repeats: int = 5, sleep: int = 2_000_000) -> float:
    """Device time per call by CUDA events, without the host's time: a queued
    sleep (`sleep` cycles; the default about a millisecond) keeps the device
    busy while the host enqueues `iters` calls, which then run back to back.
    For kernels of a few microseconds, where a profiler trace of a quick
    burst of launches has come back short of records; median over `repeats`."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def bound_of(nbytes: float, flops: float, peak: float = PEAK_F32_FLOPS):
    """(least time in ms, "bytes" or "operations") for this much work at a
    peak rate of `peak` operations per second."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tc_bound_of(nbytes: float, flops: float):
    """The bound of a 3xTF32 kernel: three TF32 products per multiply-add."""
    return bound_of(nbytes, 3 * flops, PEAK_TF32_FLOPS)


def kernel_entry(name: str, source: str, replaces: str, launches: int, err: float,
                 ms: float, plain_ms: float, work, library_ms=None, tensor_core: bool = False,
                 peak: float = PEAK_F32_FLOPS, **_) -> dict:
    """One entry of the kernels line; work = (bytes, operations) of the timed
    call; its operations at `peak`, or in 3xTF32 with tensor_core."""
    bound_ms, bound_by = tc_bound_of(*work) if tensor_core else bound_of(*work, peak)
    return {"name": name, "route": "cuda", "source": "open3dsot_tpu_torch/csrc/" + source,
            "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def chain_work(chain, B: int, N: int, c_in: int, out_elems: int):
    """(bytes, operations) of a per-point Dense chain over B * N points."""
    weights = sum(w.numel() + b.numel() for w, b in chain.layers)
    flops = 2 * B * N * sum(w.shape[0] * w.shape[1] for w, _ in chain.layers)
    return 4 * (B * N * c_in + weights + out_elems), flops


def k1_work(chain, B: int, N: int, tap_at):
    tap = 0 if tap_at is None else B * N * chain.widths[tap_at + 1]
    return chain_work(chain, B, N, chain.widths[0], tap + B * chain.widths[-1])


def k2_work(chain, B: int, N: int):
    """K2 on (B, N, C_tap) taps and (B, C_pool) pooled rows: the per-point
    chain from W_tap on, and the GEMV of W_pool once per batch element."""
    c_tap, first = chain.split, chain.weights[0].shape[1]
    c_pool = chain.widths[0] - c_tap
    weights = sum(w.numel() + b.numel() for w, b in chain.layers)
    nbytes = 4 * (B * N * c_tap + B * c_pool + weights + B * N * chain.widths[-1])
    flops = (2 * B * N * (c_tap * first + sum(w.shape[0] * w.shape[1] for w in chain.weights[1:]))
             + 2 * B * c_pool * first)
    return nbytes, flops


def kernel_name(mangled: str) -> str:
    """A kernel's name with its integer template arguments, from its mangled
    name (`_ZN12_GLOBAL__N_112rowmm_kernelILi0ELi0EEEv...` -> rowmm_kernel<0,0>; a bool
    argument as 0 or 1):
    the first length-prefixed identifier that ends in `_kernel`."""
    import re

    for m in re.finditer(r"\d+", mangled):
        digits = m.group()
        for i in range(len(digits)):  # a namespace tag's digits may run into the length
            name = mangled[m.end():m.end() + int(digits[i:])]
            if name.endswith("_kernel") and re.fullmatch(r"[A-Za-z_]\w*", name):
                t = re.match(r"I((?:L[ib]-?\d+E)+)E", mangled[m.end() + len(name):])
                args = re.findall(r"L[ib](-?\d+)E", t.group(1)) if t else []
                return name + (f"<{','.join(args)}>" if args else "")
    return mangled


def sass_tensor_ops(lib_path, split: bool = False) -> dict:
    """Tensor-core instructions (HMMA and HGMMA together, or with split a
    pair (HMMA, HGMMA): mma.sync and wgmma) per kernel in a library's SASS."""
    import re

    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump -sass {lib_path} failed: {out.stderr.strip()[-2000:]}")
    counts, fn = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = kernel_name(m.group(1))
            counts[fn] = [0, 0]
        elif fn is not None and re.search(r"\bHG?MMA\b", line):
            counts[fn][1 if re.search(r"\bHGMMA\b", line) else 0] += 1
    return {fn: tuple(c) if split else sum(c) for fn, c in counts.items()}


def time_call(kernel, plain, work, card: str, what: str) -> dict:
    """Event and device times of a kernel call and its plain version (plain,
    kernel, plain), the plain stack in TF32 through cuBLAS as a yardstick, and
    both bounds of the call's work."""
    import torch

    t_p = time_ms(plain)
    t_k = time_ms(kernel)
    t_p2 = time_ms(plain)
    d_k, d_p = device_ms(kernel), device_ms(plain)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        t_lib = time_ms(plain)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    b32, _ = bound_of(*work)
    btc, _ = tc_bound_of(*work)
    share = "not measured" if d_k is None else f"{btc / d_k:.1%}"
    print(f"  time {what}: kernel ev {t_k:.4f} ms dev {fmt_ms(d_k)}; plain ev {min(t_p, t_p2):.4f} "
          f"ms dev {fmt_ms(d_p)}; cuBLAS TF32 stack ev {t_lib:.4f} ms; bound f32 {b32:.5f} ms, "
          f"3xTF32 {btc:.5f} ms (kernel dev at {share} of it) [{card}]", flush=True)
    return dict(ms=t_k, plain_ms=min(t_p, t_p2), dev_ms=d_k, plain_dev_ms=d_p, library_ms=t_lib,
                work=work, tensor_core=True)


def check_chains(model, card: str, lib, strict: bool = True) -> dict:
    """Phase 3: K1 at its three calls (seg mlp1 with its tap, mini, mini2) and
    K2 against their plain versions, on (B, N) = (1, 2048), (16, 2048) (the
    main path's, timed), (3, 2048), a ragged (2, 2000) and (3, 40), smaller
    than a point tile; the tensor-core instructions of the library's kernels."""
    import torch

    from open3dsot_tpu_torch.ops import chain_fused as cf

    if getattr(cf, "TOL_3XTF32", RTOL) != RTOL:
        fail(f"the port states a kernel tolerance of {cf.TOL_3XTF32}, this run holds {RTOL}")
    counts = sass_tensor_ops(lib.path)
    for fn, c in counts.items():
        print(f"  sass: {fn}: {c} HMMA/HGMMA", flush=True)
    chain_kernels = [fn for fn in counts if fn.startswith("chain_tc_kernel")]
    if strict and (not chain_kernels or not all(counts[fn] for fn in chain_kernels)):
        fail(f"K1/K2's kernels hold no tensor-core instruction: {counts}")

    net = model.net
    chain1, chain2 = net.seg_pointnet.folded_chains()
    k1_cases = [("K1 seg mlp1 tap", chain1, 1), ("K1 mini", net.mini_pointnet.folded_chains(), None),
                ("K1 mini2", net.mini_pointnet2.folded_chains(), None)]
    dev = chain1.packed.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    errs = {"K1": 0.0, "K2": 0.0}
    rows = {}
    n = 2 * N_POINTS
    for B, N in ((1, n), (16, n), (3, n), (2, 2000), (3, 40)):
        timed = N == n and B in (1, 16)
        for name, chain, tap_at in k1_cases:
            x = torch.randn(B, N, chain.widths[0], device=dev, generator=gen)
            k_tap, k_pool = cf.fused_pointnet_encoder(x, chain, tap_at=tap_at)
            p_tap, p_pool = cf.pointnet_encoder_plain(x, chain, tap_at)
            torch.cuda.synchronize()
            errs["K1"] = max(errs["K1"], compare(f"{name} B={B} N={N} pooled", k_pool, p_pool))
            if tap_at is not None:
                errs["K1"] = max(errs["K1"], compare(f"{name} B={B} N={N} tap", k_tap, p_tap))
                tap, pooled = p_tap, p_pool
            if timed:
                rows[(name, B)] = time_call(
                    lambda: cf.fused_pointnet_encoder(x, chain, tap_at=tap_at),
                    lambda: cf.pointnet_encoder_plain(x, chain, tap_at),
                    k1_work(chain, B, N, tap_at), card, f"{name} B={B} N={N}")
        k_out = cf.fused_seg_head(tap, pooled, chain2)
        p_out = cf.seg_head_plain(tap, pooled, chain2)
        torch.cuda.synchronize()
        errs["K2"] = max(errs["K2"], compare(f"K2 seg head B={B} N={N}", k_out, p_out))
        if timed:
            rows[("K2 seg head", B)] = time_call(lambda: cf.fused_seg_head(tap, pooled, chain2),
                                                 lambda: cf.seg_head_plain(tap, pooled, chain2),
                                                 k2_work(chain2, B, N), card, f"K2 seg head B={B} N={N}")
    for B in (1, 16):
        calls = [r for (name, b), r in rows.items() if b == B]
        tot = {k: None if any(r[k] is None for r in calls) else sum(r[k] for r in calls)
               for k in ("ms", "plain_ms", "dev_ms", "plain_dev_ms", "library_ms")}
        b32 = sum(bound_of(*r["work"])[0] for r in calls)
        btc = sum(tc_bound_of(*r["work"])[0] for r in calls)
        print(f"  one M2 forward's four K1/K2 calls, B={B} N={n}: kernel ev {tot['ms']:.4f} ms dev "
              f"{fmt_ms(tot['dev_ms'])}; plain ev {tot['plain_ms']:.4f} ms dev "
              f"{fmt_ms(tot['plain_dev_ms'])}; cuBLAS TF32 stack ev {tot['library_ms']:.4f} ms; "
              f"bound f32 {b32:.5f} ms, 3xTF32 {btc:.5f} ms [{card}]", flush=True)
    print("phase 3 ok: K1 and K2 within tolerance of their plain versions", flush=True)
    return {"errs": errs, "rows": rows}


def fmt_ms(t) -> str:
    return "not measured" if t is None else f"{t:.4f} ms"


def bench_cfg(**kw):
    """The configuration bench.py builds for M2-Track (box_aware, N = 1024)."""
    from open3dsot_tpu_torch.config import make_config

    d = dict(dataset="synthetic", net_model="m2track", category_name="Car", bb_scale=1.25,
             bb_offset=2, point_sample_size=N_POINTS, degrees=False, up_axis=[0, 0, 1],
             box_aware=True, use_z=True, limit_box=False, IoU_space=3, motion_threshold=0.15,
             train_type="train_motion", syn_num_tracklets=4, syn_tracklet_len=16, seed=SEED)
    d.update(kw)
    return make_config(d)


def matching_cfg(name: str, **kw):
    """BAT_Car / P2B_Car at their full widths on the synthetic dataset
    (template 512, search 1024, every channel 256, 64 proposals)."""
    from open3dsot_tpu_torch.config import load_config

    over = dict(dataset="synthetic", syn_num_tracklets=4, syn_tracklet_len=16, seed=SEED)
    over.update(kw)
    return load_config(str(ROOT / MATCHING_CFG[name]), over)


def make_model(cfg, fused_eval: bool, variables=None):
    """The model on the card; `fused_eval` False is the plain path (BAT/P2B:
    no kernel in eval or in training)."""
    from open3dsot_tpu_torch.models import get_model
    from open3dsot_tpu_torch.weights import random_variables, state_dict_from_jax

    kw = {} if cfg.net_model.lower() == "m2track" else {"fused_train": fused_eval}
    model = get_model(cfg.net_model)(cfg, device="cuda", fused_eval=fused_eval, **kw)
    if variables is None:
        variables = random_variables(model.net, SEED)
    model.net.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model, variables


def m2_float64(plain_model, batch: dict) -> dict:
    """The M2 forward on the plain path in float64 (the net converted and back)."""
    import torch

    net = plain_model.net.double()
    try:
        with torch.no_grad():
            def dev(k):
                return torch.as_tensor(batch[k], dtype=torch.float64, device=plain_model.device)
            return net(dev("points"), dev("candidate_bc") if net.box_aware else None)
    finally:
        net.float()


def main(argv=None) -> None:
    import numpy as np
    import torch

    args = sys.argv[1:] if argv is None else argv
    chain_only, k6_only = "--chain-times" in args, "--k6-times" in args
    k4_only, k3_only = "--k4-times" in args, "--k3-times" in args
    scan_only, match_only = "--scan-times" in args, "--match-scan-times" in args
    online_only, rates_only = "--online-times" in args, "--eager-rates" in args
    bf16_only = "--bf16-times" in args
    breakdown_only = "--bf16-breakdown" in args
    k6_bf16_only = "--k6-bf16-times" in args
    train_only = "--train-times" in args
    sampler_only = "--device-sampler-times" in args
    # --- 1. environment ---------------------------------------------------
    print(f"env: python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA device")
    card = card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(ROOT))
    from open3dsot_tpu_torch.ops import chain_fused as cf
    from open3dsot_tpu_torch.ops._build import SIGNATURES, load_libraries

    # --- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    bf16_eval = ["chain_fused", "chain_fused_bf16", "fps", "sa_fused", "sa_fused_bf16"]
    libs = load_libraries(["chain_fused"] if chain_only or scan_only else
                          ["fps", "sa_fused"] if match_only else
                          ["chain_fused", "fps", "sa_fused"] if online_only or rates_only else
                          bf16_eval if bf16_only else
                          [n for n in bf16_eval if n in SIGNATURES] if breakdown_only else
                          ["sa_fused_train"] if k6_only else
                          ["sa_fused_train", "sa_fused_train_bf16"] if k6_bf16_only else
                          ["fps", "sa_fused", "sa_fused_train", "sa_fused_train_bf16"]
                          if sampler_only else
                          bf16_eval + ["sa_fused_train", "sa_fused_train_bf16"] if train_only else
                          ["sa_fused"] if k4_only else ["fps", "fps_floor"] if k3_only else
                          bf16_eval + ["sa_fused_train", "sa_fused_train_bf16", "gather_probe",
                                       "fps_floor"])
    print(f"build: {len(libs)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)
    for lib in libs.values():
        print(f"  {lib.path.relative_to(ROOT)} in {lib.build_seconds:.1f} s "
              f"({'reused' if lib.build_seconds == 0 else 'nvcc sm_90a'})", flush=True)
        for line in lib.build_log.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry", "Performance Loss",
                                       "(C75")):
                print(f"  ptxas: {line.strip()}")

    if k6_only:
        training_phases(card, libs["sa_fused_train"], k6_only=True)
        print("k6 times done: phases 1, 2 and 11 only", flush=True)
        return
    if k6_bf16_only or train_only:
        check_k6_bf16(bat_k6_calls(), card, libs["sa_fused_train_bf16"])
        if train_only:
            bf16_train_phase(card)
            m2_train_phase(card)
        print(f"{'train' if train_only else 'k6 bf16'} times done: phases 1, 2 and "
              f"{'19-21' if train_only else '19'} only", flush=True)
        return
    if sampler_only:
        device_sampler_phase(card)
        print("device sampler times done: phases 1, 2 and 22 only", flush=True)
        return
    if k4_only:
        matching_phases(card, libs["sa_fused"], k4_only=True)
        print("k4 times done: phases 1, 2 and 7 only", flush=True)
        return
    if k3_only:
        check_k3(card)
        print("k3 times done: phases 1, 2 and 6 only", flush=True)
        return
    if scan_only:
        scan_phase(card)
        print("scan times done: phases 1, 2 and 15 only", flush=True)
        return
    if match_only:
        match_scan_phase(card)
        print("match scan times done: phases 1, 2 and 16 only", flush=True)
        return
    if online_only:
        online_phase(card)
        print("online times done: phases 1, 2 and 17 only", flush=True)
        return
    if rates_only:
        eager_rates(card)
        print("eager rates done: phases 1 and 2 and the eager paths' frames/s only", flush=True)
        return
    if bf16_only:
        bf16_phase(card)
        print("bf16 times done: phases 1, 2 and 18 only", flush=True)
        return
    if breakdown_only:
        bf16_breakdown(card)
        print("bf16 breakdown done: phases 1, 2 and the bf16 kernels' breakdown only", flush=True)
        return

    # --- 3. kernels vs plain at the main path's shapes --------------------
    cfg = bench_cfg()
    model, variables = make_model(cfg, fused_eval=True)
    chains = check_chains(model, card, libs["chain_fused"], strict=not chain_only)
    if chain_only:
        print("chain times done: phases 1-3 only", flush=True)
        return

    # --- 4. the M2 forward: kernel path vs plain path ---------------------
    from open3dsot_tpu_torch.data import get_dataset

    plain_model, _ = make_model(cfg, fused_eval=False, variables=variables)
    sampler = get_dataset(cfg, "test", "test")
    # 16 real frames: inputs built around the ground truth of the frame before
    frames = [model.build_input_dict(seq, f, [seq[f - 1]["3d_bbox"]])[0]
              for seq in (sampler[0], sampler[1]) for f in range(1, 9)]
    batch16 = {k: np.concatenate([f[k] for f in frames]) for k in frames[0]}
    for B, batch in ((1, frames[0]), (16, batch16)):
        cf.reset_launch_counts()
        got = model.apply(batch)
        torch.cuda.synchronize()
        launches = (cf.fused_pointnet_encoder.launches, cf.fused_seg_head.launches)
        if launches != (3, 1):
            fail(f"one forward launched K1 {launches[0]} and K2 {launches[1]} times, expected 3 and 1")
        want = plain_model.apply(batch)
        for k in ("seg_logits", "pred_bc"):
            compare(f"M2 B={B} {k}", got[k], want[k])
        # the argmax of the seg logits picks the points the MiniPointNets see
        flips = got["seg_logits"].argmax(-1) != want["seg_logits"].argmax(-1)
        margin = (want["seg_logits"][..., 0] - want["seg_logits"][..., 1]).abs()
        print(f"  M2 B={B}: {int(flips.sum())} of {flips.numel()} points change side in the seg "
              f"mask; smallest plain-path logit margin {margin.min().item():.3e}")
        gate = got["motion_cls"].argmax(-1) != want["motion_cls"].argmax(-1)
        print(f"  M2 B={B}: {int(gate.sum())} of {gate.numel()} frames change their motion state")
        truth = m2_float64(plain_model, batch)
        bad = []
        for k in ("estimation_boxes", "aux_estimation_boxes", "estimation_boxes_prev", "motion_pred"):
            e = (got[k].double() - truth[k]).abs().max().item()
            e_kp = (got[k] - want[k]).abs().max().item()
            e_p = (want[k].double() - truth[k]).abs().max().item()
            print(f"  M2 B={B} {k}: max_abs_err from float64 {e:.3e} (atol {BOX_ATOL}); "
                  f"from the plain path {e_kp:.3e}; plain path from float64 {e_p:.3e}")
            if not e <= BOX_ATOL:
                bad.append(f"{k} by {e}")
        if bad:
            fail(f"M2 B={B}: {', '.join(bad)} from the plain path in float64")
        t_k = time_ms(lambda: model.apply(batch), iters=10, repeats=5)
        t_p = time_ms(lambda: plain_model.apply(batch), iters=10, repeats=5)
        print(f"  time M2 forward B={B}: kernel path {t_k:.4f} ms plain path {t_p:.4f} ms [{card}]")
    print("phase 4 ok: M2 forward kernel path == plain path; K1 x3, K2 x1 per forward", flush=True)

    # --- 5. the slice through its entry points ----------------------------
    from open3dsot_tpu_torch.tracking.eval import evaluate_dataset

    n_frames = sum(len(sampler[i]) - 1 for i in range(len(sampler)))
    evaluate_dataset(model, sampler, cfg, max_tracklets=1)  # warm-up (allocator, caches)
    cf.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    succ, prec = evaluate_dataset(model, sampler, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    k1_launches, k2_launches = cf.fused_pointnet_encoder.launches, cf.fused_seg_head.launches
    print(f"eval: {len(sampler)} tracklets x {cfg.syn_tracklet_len} frames, point_sample_size "
          f"{N_POINTS}: success {succ:.4f} precision {prec:.4f}; {n_frames} forwards in "
          f"{dt:.4f} s = {n_frames / dt:.2f} frames/s (host loop) [{card}]", flush=True)
    print(f"launches in the eval run: K1 {k1_launches} K2 {k2_launches}", flush=True)
    EAGER_RATES["M2 host loop"] = n_frames / dt
    if not (succ == succ and prec == prec and 0 <= succ <= 100 and 0 <= prec <= 100):
        fail(f"Success/Precision not finite in [0, 100]: {succ}, {prec}")
    if (k1_launches, k2_launches) != (3 * n_frames, n_frames):
        fail(f"expected K1 {3 * n_frames} and K2 {n_frames} launches in the eval run")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_succ, p_prec = evaluate_dataset(plain_model, sampler, cfg)
    torch.cuda.synchronize()
    p_dt = time.perf_counter() - t0
    print(f"eval plain path: success {p_succ:.4f} precision {p_prec:.4f}; "
          f"{n_frames / p_dt:.2f} frames/s (host loop) [{card}]", flush=True)
    profile_window(model, sampler, cfg, card, wall_us_per_frame=dt * 1e6 / n_frames)
    host_breakdown(model, sampler, card)

    cli = [sys.executable, "-m", "open3dsot_tpu_torch.main", "--cfg", "cfgs/M2_track_synthetic.yaml",
           "--test", "--max_tracklets", "2", "--device", "cuda"]
    proc = subprocess.run(cli, cwd=ROOT, capture_output=True, text=True, timeout=600)
    last = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    print(f"cli: exit {proc.returncode}: {last}", flush=True)
    if proc.returncode != 0 or not last.startswith("success/test:"):
        fail(f"CLI eval failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    print("phase 5 ok", flush=True)

    # --- 6.-9. the BAT/P2B matching path ----------------------------------
    matching_kernels = matching_phases(card, libs["sa_fused"])

    # --- 11.-13. BAT/P2B training -----------------------------------------
    training_kernels = training_phases(card, libs["sa_fused_train"])

    # --- 14. the probes P1/P2 -----------------------------------------------
    probe_kernels = probe_phase(card)

    # --- 15. the M2 scan tracker ------------------------------------------
    scan_phase(card)

    # --- 16. the matching scan tracker (BAT/P2B) ----------------------------
    match_scan_phase(card)

    # --- 17. the online trackers and their serving bundles ------------------
    online_phase(card)
    for k, before in BEFORE_OPERATORS.items():
        print(f"dispatch: {k} {EAGER_RATES[k]:.2f} frames/s in this run, {before:.2f} before the "
              f"kernels became operators [{card}]", flush=True)

    # --- 18. the bf16 compute mode of eval ------------------------------------
    bf16_kernels = bf16_phase(card)

    # --- 19.-21. K6 in bf16, training under bf16, M2-Track training -----------
    k6b = check_k6_bf16(bat_k6_calls(), card, libs["sa_fused_train_bf16"])
    k6b_launches = bf16_train_phase(card)
    m2_train_phase(card)

    # --- 22. training with samples built on the card ---------------------------
    device_sampler_phase(card)
    replaces = "open3dsot_tpu/ops/sa_fused_train.py:608-776 (cdt bfloat16)"
    for what in ("fwd", "bwd"):
        bf16_kernels.append(kernel_entry(
            f"K6 fused_sa_train_apply ({'forward' if what == 'fwd' else 'backward'}, bf16)",
            "sa_fused_train_bf16.cu", replaces, k6b_launches[what], k6b["errs"][what],
            k6b["sums"][TRAIN_B][what], k6b["sums"][TRAIN_B][what + "_plain"],
            k6b["work"][TRAIN_B][0 if what == "fwd" else 1],
            library_ms=k6b["sums"][TRAIN_B][what + "_cublas"], peak=PEAK_BF16_FLOPS))

    # --- 10. results ------------------------------------------------------
    kernels = [
        kernel_entry("K1 fused_pointnet_encoder", "chain_fused.cu",
                     "open3dsot_tpu/ops/chain_fused.py:150", k1_launches, chains["errs"]["K1"],
                     **chains["rows"][("K1 seg mlp1 tap", 1)]),
        kernel_entry("K2 fused_seg_head", "chain_fused.cu", "open3dsot_tpu/ops/chain_fused.py:217",
                     k2_launches, chains["errs"]["K2"], **chains["rows"][("K2 seg head", 1)]),
    ] + matching_kernels + training_kernels + probe_kernels + bf16_kernels
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


def matching_frames(model, sampler, n: int):
    """Inputs of the first n frames, each built around the ground truth
    of the frames before it."""
    frames = []
    for i in range(len(sampler)):
        seq = sampler[i]
        for f in range(1, len(seq)):
            frames.append(model.build_input_dict(seq, f, [seq[j]["3d_bbox"] for j in range(f)])[0])
            if len(frames) == n:
                return frames
    return frames


K3_SHAPES = ((1024, 512), (512, 256))  # BAT's two FPS calls: search and template, N -> npoint
K3_BATCHES = (1, 16, TRAIN_B)  # the eval loop, a batched forward, the train step
K3_SWEEP_N = (512, 1024, 1000, 2048, 4096, 8192, 16384)  # the block sweep's clouds (1000: ragged)
K3_SWEEP_T = (32, 64, 128, 256, 512, 1024)


def k3_work(B: int, N: int, S: int):
    """(bytes, operations) of one K3 call: the clouds read and the indices
    written once; per step and point 3 sub, 3 mul, 2 add and a min."""
    return 4 * B * (N * 3 + S), 9 * B * (S - 1) * N


def k3_profiler_records(card: str) -> None:
    """K3's launches against the profiler's records of its kernel and their
    device time: in a window that opens on a K3 launch, and in one that
    opens on a sleep kernel (device_rows)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from open3dsot_tpu_torch.ops import sampling as smp

    x = torch.randn(1, 512, 3, device="cuda")
    n = 8
    runs = lambda: [smp.furthest_point_sample(x, 256) for _ in range(n)]  # noqa: E731
    runs()

    def k3(rows):
        rows = [e for e in rows if "fps_kernel" in e.key]
        return f"{sum(e.count for e in rows)} records, {sum(dev_us(e) for e in rows):.1f} us"

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        runs()
        torch.cuda.synchronize()
    t = time_ms(runs, iters=1, repeats=5)
    print(f"  profiler records of {n} K3 launches ({t * 1e3:.1f} us by events): window opening on "
          f"K3: {k3(prof.key_averages())}; opening on a sleep kernel (device_rows): "
          f"{k3(device_rows(runs))} [{card}]", flush=True)


def check_k3(card: str) -> dict:
    """Phase 6: K3 against furthest_point_sample_plain, index for index, at
    BAT's shapes and edge shapes; times against the bound and both skeleton
    floors; the block sweep. On a tree from before K3's redesign (no
    fps_block: a parent run with --k3-times) only what that tree has."""
    import torch

    from open3dsot_tpu_torch.ops import sampling as smp
    from open3dsot_tpu_torch.probes import fps_floor

    redesigned = hasattr(smp, "fps_block")
    forms = smp.WINNERS if redesigned else (None,)
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def cloud(B, N, distinct=None):
        x = torch.randn(B, N, 3, device="cuda", generator=gen) * 3
        if distinct is None:
            return x
        return x[:, torch.randint(0, distinct, (N,), device="cuda", generator=gen)].contiguous()

    def same(label, x, S, want=None):
        want = smp.furthest_point_sample_plain(x, S) if want is None else want
        for form in forms:
            kw = {} if form is None else {"winner": form}
            n_diff = int((smp.furthest_point_sample(x, S, **kw) != want).sum())
            what = f"K3 {label}" + ("" if form is None else f" ({form})")
            print(f"  {what}: {'indices equal' if n_diff == 0 else f'{n_diff} indices differ'}",
                  flush=True)
            if n_diff:
                fail(f"{what}: {n_diff} indices differ from the plain version")
        return want

    times = {}
    sink = torch.empty(1, device="cuda")
    for B in K3_BATCHES:
        for N, S in K3_SHAPES:
            x = cloud(B, N)
            same(f"B={B} N={N}->{S} continuous", x, S)
            same(f"B={B} N={N}->{S} duplicated points", cloud(B, N, N // 8), S)
            t_p = time_ms(lambda: smp.furthest_point_sample_plain(x, S), iters=2, repeats=3)
            t_k = time_ms(lambda: smp.furthest_point_sample(x, S))
            t_p2 = time_ms(lambda: smp.furthest_point_sample_plain(x, S), iters=2, repeats=3)
            d_k = device_ms(lambda: smp.furthest_point_sample(x, S))
            bound, by = bound_of(*k3_work(B, N, S))
            times[(B, N)] = (t_k, min(t_p, t_p2))
            block = f" block T={smp.fps_block(N)[0]} {smp.fps_winner(N)}" if redesigned else ""
            print(f"  time K3 B={B} N={N}->{S}{block}: kernel {t_k:.4f} ms plain "
                  f"{min(t_p, t_p2):.4f} ms; device time kernel {fmt_ms(d_k)} "
                  f"({'not measured' if d_k is None else f'{d_k / (S - 1) * 1e3:.4f} us a step'}); "
                  f"bound_ms {bound:.6f} ({by}; {bound / t_k:.3%} of the kernel's event time) "
                  f"[{card}]", flush=True)
            if B != 1:
                continue
            # the skeleton floors: S - 1 serial steps of each design's step alone, no points
            for design in fps_floor.DESIGNS if redesigned else (1,):
                kw = {"design": design} if redesigned else {}
                floor = time_ms(lambda: fps_floor.fps_chain_floor(S - 1, N, sink, **kw))
                T = fps_floor.design_threads(design, N) if redesigned else min(1024, N)
                if d_k is None:
                    rel = "K3's device time not measured"
                elif floor <= d_k:
                    rel = f"K3's device time {d_k - floor:.4f} ms above it, the floor {floor / d_k:.1%} of it"
                else:
                    rel = f"K3's device time {floor - d_k:.4f} ms below it (a floor of another design)"
                print(f"  K3 B=1 N={N}->{S}: skeleton floor of the v{design} design ({T} threads): "
                      f"{S - 1} steps x {floor / (S - 1) * 1e3:.4f} us = {floor:.4f} ms; {rel} "
                      f"[{card}]", flush=True)
    if redesigned:
        same("B=2 N=1024->512 all points identical",
             cloud(2, 1, None).expand(2, 1024, 3).contiguous(), 512)
        same("B=4 N=1000->500 ragged", cloud(4, 1000, 300), 500)
        same("B=4 N=33->16 ragged", cloud(4, 33), 16)
        same("B=2 N=8192->2048", cloud(2, 8192), 2048)
        same("B=4 N=512->512 npoint = N", cloud(4, 512, 64), 512)
        same("B=4 N=100->100 npoint = N", cloud(4, 100), 100)
    k3_profiler_records(card)
    if redesigned:
        k3_sweep(card, cloud, same)
    print("phase 6 ok: K3 indices equal to the plain version's", flush=True)
    return times


def k3_sweep(card: str, cloud, same) -> None:
    """K3 at every block T (PPT <= 32) and winner form on one cloud of each
    sweep size, index for index against the plain version; time by events
    over back-to-back calls (each call is far longer than its launch)."""
    from open3dsot_tpu_torch.ops import sampling as smp

    for N in K3_SWEEP_N:
        S = min(N // 2, 2048)
        x = cloud(1, N)
        want = same(f"sweep B=1 N={N}->{S} at fps_block's T", x, S)
        row = []
        for T in K3_SWEEP_T:
            if T * smp.MAX_PPT < N:
                continue
            for form in smp.WINNERS:
                if form == "shared" and smp.fps_winner(N) != "shared":
                    continue
                got = smp.furthest_point_sample(x, S, threads=T, winner=form)
                if not bool((got == want).all()):
                    fail(f"K3 sweep N={N} T={T} {form}: indices differ from the plain version")
                t = time_ms(lambda: smp.furthest_point_sample(x, S, threads=T, winner=form),
                            iters=10, repeats=5)
                row.append(f"T={T} {form} {t / (S - 1) * 1e3:.4f}")
        T, ppt = smp.fps_block(N)
        print(f"  K3 sweep N={N}->{S}, us a step (indices equal at each): " + ", ".join(row)
              + f"; fps_block: T={T} PPT={ppt} {smp.fps_winner(N)} [{card}]", flush=True)


def sa_calls(plain_model, batch) -> list:
    """(label, layer, xyz, features, new_xyz) of each SA call of one plain forward."""
    from open3dsot_tpu_torch.models.pointnet import SetAbstraction

    calls, hooks = [], []

    def record(mod, args, out):
        n = len(calls)
        label = f"template SA{n}" if n < 3 else f"search SA{n - 3}" if n < 6 else "vote SA"
        calls.append((label, mod, args[0].contiguous(), args[1], out[0]))

    for mod in plain_model.net.modules():
        if isinstance(mod, SetAbstraction):
            hooks.append(mod.register_forward_hook(record))
    plain_model.apply(batch)
    for h in hooks:
        h.remove()
    if len(calls) != 7:
        fail(f"a BAT forward made {len(calls)} SA calls, expected 7")
    return calls


def bq_walked(xyz, new, radius: float, K: int) -> int:
    """Points K4's ball query tests on these inputs: each centroid's warp walks
    the points 32 at a time until K lie in the ball, or to the end
    (csrc/sa_fused.cu::bq_kernel)."""
    import torch

    from open3dsot_tpu_torch.ops.neighbors import radius_sq

    N = xyz.shape[1]
    d = new[:, :, None, :] - xyz[:, None, :, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    count = (d2 < radius_sq(radius)).int().cumsum(-1)  # (B, S, N)
    kth = torch.argmax((count >= K).int(), dim=-1)  # where the K-th point is found
    walked = torch.where(count[..., -1] >= K, torch.clamp((kth // 32 + 1) * 32, max=N),
                         torch.full_like(kth, N))
    return int(walked.sum())


def sa_work(xyz, feats, new, folded, K: int, walked: int):
    """(bytes, operations) of one K4 call: xyz, features and centroids read,
    the weights read, (B, S, C3) written; layer 1's A-form matmul over the
    points, layers 2-3 over the (B, S, K) grid, 8 operations per point the
    ball query tests (walked)."""
    B, N, S = xyz.shape[0], xyz.shape[1], new.shape[1]
    C = 0 if feats is None else feats.shape[2]
    (w1, _), (w2, _), (w3, _) = folded
    c1, c2, c3 = w1.shape[1], w2.shape[1], w3.shape[1]
    nbytes = 4 * (B * (N * (3 + C) + S * 3 + S * c3) + sum(w.numel() + b.numel() for w, b in folded))
    flops = 2 * B * N * w1.shape[0] * c1 + 2 * B * S * K * (c1 * c2 + c2 * c3)
    return nbytes, flops + 8 * walked


def check_k4_k5(calls, card: str, lib, strict: bool = True):
    """Phase 7: K4 against sa_eval_plain and K5 against K4 at each SA call's
    inputs; times by call and over one forward's seven calls, device time by
    kernel name, both bounds; the tensor-core instructions of K4's products."""
    import torch

    from open3dsot_tpu_torch.ops import sa_fused as saf
    from open3dsot_tpu_torch.ops.neighbors import ball_query

    counts = sass_tensor_ops(lib.path)
    for fn, c in counts.items():
        print(f"  sass: {fn}: {c} HMMA/HGMMA", flush=True)
    products = [fn for fn in counts if fn.startswith("sa_tc_kernel")]
    if strict and (not products or not all(counts[fn] for fn in products)):
        fail(f"K4's product kernel holds no tensor-core instruction: {counts}")
    errs = {"K4": 0.0, "K5": 0.0}
    batches = (1, 16)
    work = {B: {"K4": [0, 0], "K5": [0, 0]} for B in batches}  # over one forward's calls
    sums = {B: [0.0, 0.0, 0.0] for B in batches}  # K4, K5, plain over one forward's calls
    dev_sums = {B: [0.0, 0.0, 0.0] for B in batches}  # the same in device time
    forward = {B: [] for B in batches}  # one forward's K4 calls
    # one forward's K4 calls with each gather form forced, and their device times
    forms = {B: {f: [] for f in saf.GATHER_FORMS} for B in batches}
    form_dev = {B: {f: [] for f in saf.GATHER_FORMS} for B in batches}
    for label, mod, xyz16, feats16, new16 in calls:
        kw = dict(radius=mod.radius, normalize_xyz=mod.normalize_xyz, use_xyz=mod.use_xyz)
        K, folded = mod.nsample, mod.folded_chains()
        for B in batches:
            xyz, new = xyz16[:B].contiguous(), new16[:B].contiguous()
            feats = None if feats16 is None else feats16[:B].contiguous()
            shape = (f"{label} B={B} S={new.shape[1]} K={K} N={xyz.shape[1]} "
                     f"C={0 if feats is None else feats.shape[2]}->{folded[-1][0].shape[1]}")
            nbytes, flops = sa_work(xyz, feats, new, folded, K, 0)
            work[B]["K4"][0] += nbytes
            work[B]["K4"][1] += flops + 8 * bq_walked(xyz, new, mod.radius, K)
            work[B]["K5"][0] += nbytes + 4 * B * new.shape[1] * K  # the indices
            work[B]["K5"][1] += flops

            def k4(xyz=xyz, feats=feats, new=new, folded=folded, K=K, kw=kw, gather=None):
                return saf.fused_sa_apply(xyz, feats, new, None, folded, nsample=K, gather=gather,
                                          **kw)

            def plain(xyz=xyz, feats=feats, new=new, folded=folded, K=K, kw=kw):
                return saf.sa_eval_plain(xyz, feats, new, None, folded, nsample=K, **kw)

            forward[B].append(k4)
            idx = ball_query(mod.radius, K, xyz, new)
            k5 = lambda: saf.fused_sa_apply(xyz, feats, new, idx, folded, **kw)  # noqa: E731
            got4, want, got5 = k4(), plain(), k5()
            torch.cuda.synchronize()
            errs["K4"] = max(errs["K4"], compare(f"K4 {shape}", got4, want))
            errs["K5"] = max(errs["K5"], compare(f"K5 {shape}", got5, want))
            compare(f"K5 vs K4 {shape}", got5, got4)
            t_p, t_4, t_5, t_p2 = time_ms(plain), time_ms(k4), time_ms(k5), time_ms(plain)
            d = (device_ms(k4), device_ms(k5), device_ms(plain))
            for i, v in enumerate((t_4, t_5, min(t_p, t_p2))):
                sums[B][i] += v
            for i, v in enumerate(d):
                dev_sums[B][i] = None if v is None or dev_sums[B][i] is None else dev_sums[B][i] + v
            print(f"  time {shape}: K4 {t_4:.4f} ms K5 {t_5:.4f} ms plain {min(t_p, t_p2):.4f} ms; "
                  f"device time K4 {fmt_ms(d[0])} K5 {fmt_ms(d[1])} plain {fmt_ms(d[2])} [{card}]",
                  flush=True)
            for form in saf.GATHER_FORMS:
                def forced(k4=k4, form=form):
                    return k4(gather=form)

                compare(f"K4 gather {form} {shape}", forced(), want)
                forms[B][form].append(forced)
                form_dev[B][form].append(device_ms(forced))
            print(f"  K4 gather forms {shape}, device time: " + ", ".join(
                f"{f} {fmt_ms(form_dev[B][f][-1])}" for f in saf.GATHER_FORMS) + f" [{card}]",
                flush=True)
    # ragged centroid counts: no tile divides them (the kernel masks the last tile)
    for label, mod, xyz, feats, new in (c for c in calls if c[0] in ("search SA0", "vote SA")):
        S = new.shape[1] - 3
        kw = dict(radius=mod.radius, normalize_xyz=mod.normalize_xyz, use_xyz=mod.use_xyz,
                  nsample=mod.nsample)
        k4 = saf.fused_sa_apply(xyz, feats, new[:, :S].contiguous(), None, mod.folded_chains(), **kw)
        want = saf.sa_eval_plain(xyz, feats, new[:, :S].contiguous(), None, mod.folded_chains(), **kw)
        errs["K4"] = max(errs["K4"], compare(f"K4 {label} B=16 ragged S={S}", k4, want))
    for B in batches:
        t_4, t_5, t_p = sums[B]
        d_4, d_5, d_p = dev_sums[B]
        print(f"  time of one BAT forward's 7 SA calls, B={B}: K4 {t_4:.4f} ms K5 {t_5:.4f} ms "
              f"plain {t_p:.4f} ms; device time K4 {fmt_ms(d_4)} K5 {fmt_ms(d_5)} plain "
              f"{fmt_ms(d_p)} [{card}]", flush=True)
        run = lambda: [f() for f in forward[B]]  # noqa: E731
        t_ev = time_ms(run, iters=10, repeats=5)
        by_name = {}
        for e in device_rows(lambda: [run() for _ in range(10)]):
            by_name[e.key] = by_name.get(e.key, 0.0) + dev_us(e) / 10 / 1e3
        total = sum(by_name.values())
        b32, btc = bound_of(*work[B]["K4"])[0], tc_bound_of(*work[B]["K4"])[0]
        share = f"{btc / total:.1%}" if total > 0 else "not measured"
        print(f"  one BAT forward's 7 K4 calls back to back, B={B}: ev {t_ev:.4f} ms, device "
              f"{fmt_ms(total if total > 0 else None)}; bound f32 {b32:.5f} ms, 3xTF32 "
              f"{btc:.5f} ms (device time at {share} of the 3xTF32 bound) [{card}]", flush=True)
        for key, v in sorted(by_name.items(), key=lambda kv: -kv[1]):
            print(f"    {v:.4f} ms  {key[:100]}")
        for form in saf.GATHER_FORMS:
            calls_f = forms[B][form]
            rows = device_rows(lambda: [[f() for f in calls_f] for _ in range(10)])
            tot = sum(dev_us(e) for e in rows) / 10 / 1e3
            per_call = [v for v in form_dev[B][form] if v is not None]
            print(f"  gather {form} forced, the 7 K4 calls back to back, B={B}: device "
                  f"{fmt_ms(tot if tot > 0 else None)}; summed per call "
                  f"{fmt_ms(sum(per_call) if len(per_call) == len(calls_f) else None)} [{card}]",
                  flush=True)
    # an index outside [0, N) in K5's idx: its centroid's output is NaN, the rest as before
    label, mod, xyz, feats, new = calls[3]
    kw = dict(radius=mod.radius, normalize_xyz=mod.normalize_xyz, use_xyz=mod.use_xyz)
    idx = ball_query(mod.radius, mod.nsample, xyz, new)
    good = saf.fused_sa_apply(xyz, feats, new, idx, mod.folded_chains(), **kw)
    idx[1, 5, 7] = xyz.shape[1]
    bad = saf.fused_sa_apply(xyz, feats, new, idx, mod.folded_chains(), **kw)
    keep = torch.ones(bad.shape[:2], dtype=torch.bool, device=bad.device)
    keep[1, 5] = False
    nan_ok = bool(torch.isnan(bad[1, 5]).all()) and torch.equal(bad[keep], good[keep])
    print(f"  K5 {label} B=16, index {xyz.shape[1]} at centroid 5 of cloud 1: its output "
          f"{'NaN' if torch.isnan(bad[1, 5]).all() else 'not NaN'}, the others "
          f"{'unchanged' if torch.equal(bad[keep], good[keep]) else 'changed'}", flush=True)
    if strict and not nan_ok:
        fail("K5: an index outside [0, N) did not give its centroid NaN alone")
    # weights of the wrong shape are refused before the kernel runs
    (w1, b1), (w2, b2), (w3, b3) = mod.folded_chains()
    for what, bad_folded in (("w2 with 4 inputs fewer", ((w1, b1), (w2[:-4], b2), (w3, b3))),
                             ("b2 one too long", ((w1, b1), (w2, torch.cat([b2, b2[:1]])), (w3, b3))),
                             ("b3 one too short", ((w1, b1), (w2, b2), (w3, b3[:-1])))):
        try:
            saf.fused_sa_apply(xyz, feats, new, idx, [(w.contiguous(), b) for w, b in bad_folded],
                               **kw)
        except ValueError as e:
            print(f"  K5 with {what}: refused ({e})", flush=True)
        else:
            fail(f"K5 took folded weights with {what}")
    print("phase 7 ok: K4 and K5 within tolerance at every SA call of the BAT path", flush=True)
    return errs, sums, work[1]


def reset_matching_counts() -> None:
    from open3dsot_tpu_torch.ops import sa_fused, sampling

    sampling.reset_launch_counts()
    sa_fused.reset_launch_counts()


def matching_counts():
    from open3dsot_tpu_torch.ops import sa_fused, sampling

    return (sampling.furthest_point_sample.launches, sa_fused.fused_sa_apply.launches,
            sa_fused.fused_sa_apply.idx_launches)


def check_matching_forward(model, plain_model, batch, what: str, want_launches, card: str,
                           timed: bool = True) -> None:
    """One forward on each path: launches, outputs, times."""
    import torch

    reset_matching_counts()
    got = model.apply(batch)
    torch.cuda.synchronize()
    launches = matching_counts()
    print(f"  {what}: one forward launched K3 {launches[0]}, K4 {launches[1]}, K5 {launches[2]}")
    if launches != want_launches:
        fail(f"{what}: launches {launches}, expected K3/K4/K5 = {want_launches}")
    want = plain_model.apply(batch)
    for k in ("estimation_cla", "vote_xyz", "pred_search_bc"):
        if k in want:
            compare(f"{what} {k}", got[k], want[k])
    if not torch.equal(got["sample_idxs"], want["sample_idxs"]):
        fail(f"{what}: sample_idxs differ between the kernel and the plain path")
    e = (got["estimation_boxes"] - want["estimation_boxes"]).abs().max().item()
    print(f"  {what} estimation_boxes: max_abs_err {e:.3e} (atol {BOX_ATOL})")
    if not e <= BOX_ATOL:
        fail(f"{what} estimation_boxes differ from the plain path by {e}")
    if timed:
        t_k = time_ms(lambda: model.apply(batch), iters=10, repeats=5)
        t_p = time_ms(lambda: plain_model.apply(batch), iters=3, repeats=3)
        print(f"  time {what} forward: kernel path {t_k:.4f} ms plain path {t_p:.4f} ms [{card}]",
              flush=True)


def matching_phases(card: str, lib, k4_only: bool = False) -> list:
    """Phases 6-9 (7 alone with k4_only); returns the K3-K5 entries of the
    kernels line."""
    import numpy as np
    import torch

    from open3dsot_tpu_torch.data import get_dataset
    from open3dsot_tpu_torch.tracking.eval import evaluate_dataset

    k3_times = None if k4_only else check_k3(card)

    cfg = matching_cfg("bat")
    model, variables = make_model(cfg, fused_eval=True)
    plain_model, _ = make_model(cfg, fused_eval=False, variables=variables)
    sampler = get_dataset(cfg, "test", "test")
    frames = matching_frames(model, sampler, 16)
    batch16 = {k: np.concatenate([f[k] for f in frames]) for k in frames[0]}
    errs, sa_sums, sa_work = check_k4_k5(sa_calls(plain_model, batch16), card, lib,
                                         strict=not k4_only)
    if k4_only:
        return []

    for B, batch in ((1, frames[0]), (16, batch16)):
        check_matching_forward(model, plain_model, batch, f"BAT B={B}", (2, 7, 0), card)
    p2b_cfg = matching_cfg("p2b")
    p2b, p2b_vars = make_model(p2b_cfg, fused_eval=True)
    p2b_plain, _ = make_model(p2b_cfg, fused_eval=False, variables=p2b_vars)
    p2b_batch = matching_frames(p2b, get_dataset(p2b_cfg, "test", "test"), 1)[0]
    check_matching_forward(p2b, p2b_plain, p2b_batch, "P2B B=1", (0, 7, 0), card, timed=False)
    print("phase 8 ok: BAT/P2B forward kernel path == plain path; BAT K3 x2, K4 x7 per forward",
          flush=True)

    n_frames = sum(len(sampler[i]) - 1 for i in range(len(sampler)))
    evaluate_dataset(model, sampler, cfg, max_tracklets=1)  # warm-up
    reset_matching_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    succ, prec = evaluate_dataset(model, sampler, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = matching_counts()
    print(f"BAT eval: {len(sampler)} tracklets x {cfg.syn_tracklet_len} frames, template "
          f"{cfg.template_size} search {cfg.search_size}: success {succ:.4f} precision {prec:.4f}; "
          f"{n_frames} forwards in {dt:.4f} s = {n_frames / dt:.2f} frames/s (host loop) [{card}]",
          flush=True)
    print(f"launches in the BAT eval run: K3 {launches[0]} K4 {launches[1]} K5 {launches[2]}",
          flush=True)
    EAGER_RATES["BAT host loop"] = n_frames / dt
    if not (np.isfinite([succ, prec]).all() and 0 <= succ <= 100 and 0 <= prec <= 100):
        fail(f"BAT Success/Precision not finite in [0, 100]: {succ}, {prec}")
    if launches != (2 * n_frames, 7 * n_frames, 0):
        fail(f"expected K3 {2 * n_frames} and K4 {7 * n_frames} launches in the BAT eval run")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_succ, p_prec = evaluate_dataset(plain_model, sampler, cfg)
    torch.cuda.synchronize()
    p_dt = time.perf_counter() - t0
    print(f"BAT eval plain path: success {p_succ:.4f} precision {p_prec:.4f}; "
          f"{n_frames / p_dt:.2f} frames/s (host loop) [{card}]", flush=True)
    profile_window(model, sampler, cfg, card, wall_us_per_frame=dt * 1e6 / n_frames,
                   k3_count=lambda: matching_counts()[0])
    host_breakdown(model, sampler, card)

    cli = [sys.executable, "-m", "open3dsot_tpu_torch.main", "--cfg", "cfgs/BAT_synthetic.yaml",
           "--test", "--max_tracklets", "2", "--device", "cuda"]
    proc = subprocess.run(cli, cwd=ROOT, capture_output=True, text=True, timeout=600)
    last = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    print(f"cli (BAT): exit {proc.returncode}: {last}", flush=True)
    if proc.returncode != 0 or not last.startswith("success/test:"):
        fail(f"BAT CLI eval failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    print("phase 9 ok", flush=True)

    return [
        kernel_entry("K3 furthest_point_sample", "fps.cu", "open3dsot_tpu/ops/fps_pallas.py:69",
                     launches[0], 0.0, *k3_times[(1, 1024)], k3_work(1, 1024, 512)),
        kernel_entry("K4 fused_sa_apply (ball query)", "sa_fused.cu",
                     "open3dsot_tpu/ops/sa_fused.py:384", launches[1], errs["K4"], sa_sums[1][0],
                     sa_sums[1][2], sa_work["K4"], tensor_core=True),
        kernel_entry("K5 fused_sa_apply (idx given)", "sa_fused.cu",
                     "open3dsot_tpu/ops/sa_fused.py:415", launches[2], errs["K5"], sa_sums[1][1],
                     sa_sums[1][2], sa_work["K5"], tensor_core=True),
    ]


def train_batch(cfg, B: int, seed: int) -> dict:
    """B samples of the siamese training sampler, collated (numpy)."""
    import numpy as np

    from open3dsot_tpu_torch.data import get_dataset
    from open3dsot_tpu_torch.data.loader import collate

    np.random.seed(seed)
    sampler = get_dataset(cfg, "train_siamese", "train")
    return collate([sampler[i] for i in range(B)])


def training_counts():
    from open3dsot_tpu_torch.ops import sa_fused, sa_fused_train, sampling

    k6 = sa_fused_train.fused_sa_train_apply
    return (sampling.furthest_point_sample.launches, k6.fwd_launches, k6.bwd_launches,
            sa_fused.fused_sa_apply.launches)


def reset_training_counts() -> None:
    from open3dsot_tpu_torch.ops import sa_fused_train

    reset_matching_counts()
    sa_fused_train.reset_launch_counts()


def k6_calls(plain_model, batch) -> list:
    """(label, layer, xyz, features, new_xyz) of each K6 call of one training
    forward: SA layers 2-3 of the backbone, template then search."""
    import torch

    backbone = plain_model.net.backbone
    calls, hooks = [], []

    def record(mod, args, out):
        cloud = "template" if len(calls) < 2 else "search"
        label = f"{cloud} SA{1 if mod is backbone.sa1 else 2}"
        calls.append((label, mod, args[0].detach().contiguous(), args[1].detach().contiguous(),
                      out[0].detach().contiguous()))

    for mod in (backbone.sa1, backbone.sa2):
        hooks.append(mod.register_forward_hook(record))
    with torch.no_grad():
        plain_model.apply_train(plain_model.device_batch(batch))
    for h in hooks:
        h.remove()
    if len(calls) != 4:
        fail(f"a BAT training forward made {len(calls)} K6-eligible SA calls, expected 4")
    return calls


def pass_breakdown(what: str, fns, card: str) -> float:
    """Device time by kernel name of fns run once each back to back (a
    profiler window opened on a sleep kernel), the passes of a K6 call in
    the order of their time; returns the total in ms."""
    rows = device_rows(lambda: [f() for f in fns])
    total = sum(dev_us(e) for e in rows)
    print(f"  {what}, the four calls at B={TRAIN_B}, device time by kernel: "
          f"{total / 1e3:.4f} ms in all [{card}]", flush=True)
    for e in sorted(rows, key=lambda e: -dev_us(e)):
        name = e.key.replace("(anonymous namespace)::", "")
        print(f"    {dev_us(e) / 1e3:9.4f} ms {e.count:4d}x  {name[:100]}")
    return total / 1e3


def k6_work(B: int, N: int, S: int, K: int, c1: int, c2: int, c3: int, bf16: bool = False):
    """((bytes, operations) forward, (bytes, operations) backward) of one K6
    call. The forward writes the grids that the backward reads (two of B * S *
    K rows); both read a, ct and idx (y1 = a[idx] + ct is gathered where it is
    read). The f32 mode's grids are y2, y3 (C2 + C3 channels a row, 4 bytes a
    value). The bf16 mode's are h1, h2 (C1 + C2 channels a row), and its W2,
    W3, output and output cotangent are bf16 too, 2 bytes a value, as JAX's
    bf16 kernel stores its grids, its weights and its output in cdt
    (sa_fused_train.py:338, :420, :429); a, ct, the statistics and the
    gradients stay 4."""
    e = 2 if bf16 else 4
    R, cs = B * S * K, c1 + c2 + c3
    weights = e * (c1 * c2 + c2 * c3) + 4 * (c2 + c3 + 2 * cs)
    inputs = 4 * (B * N * c1 + B * S * c1 + B * S * K)  # a, ct, idx
    grids = e * R * (c1 + c2 if bf16 else c2 + c3)
    fwd = (inputs + weights + e * B * S * c3 + 4 * 2 * cs + grids,
           2 * R * (c1 * c2 + c2 * c3) + 6 * R * cs + R * (c1 + c3))
    bwd = (e * B * S * c3 + inputs + grids + 4 * 2 * cs + weights
           + 4 * (B * N * c1 + B * S * c1 + c1 * c2 + c2 * c3 + 2 * cs),
           4 * R * (c1 * c2 + c2 * c3) + 12 * R * cs)
    return fwd, bwd


def check_k6(calls, card: str, lib, strict: bool = True):
    """K6 forward and backward against their plain versions at each call's
    inputs; the backward of both takes the plain forward's grids and
    statistics, so both see the same maxima, ties and ReLU masks. Then device
    time by kernel over the four calls at B = TRAIN_B, and the tensor-core
    instructions of K6's product kernels."""
    import torch

    from open3dsot_tpu_torch.ops import sa_fused_train as k6
    from open3dsot_tpu_torch.ops.neighbors import ball_query
    from open3dsot_tpu_torch.ops.sa_fused import a_form

    counts = sass_tensor_ops(lib.path)
    for fn, c in counts.items():
        print(f"  sass: {fn}: {c} HMMA/HGMMA", flush=True)
    products = [fn for fn in counts if fn.startswith(("rowmm_kernel", "dw_kernel"))]
    if strict and (len(products) < 6 or not all(counts[fn] for fn in products)):
        fail(f"K6's product kernels hold no tensor-core instruction: {counts}")

    gen = torch.Generator(device=calls[0][2].device).manual_seed(SEED)
    errs = {"fwd": 0.0, "bwd": 0.0}
    sums = {B: [0.0] * 4 for B in K6_BATCHES}  # events: fwd kernel, plain, bwd kernel, plain
    dev = {B: [0.0] * 4 for B in K6_BATCHES}  # the same in device time
    work = {B: [[0, 0], [0, 0]] for B in K6_BATCHES}
    per_pass = {"forward": [], "backward": []}  # the kernel calls at B = TRAIN_B

    def one(label, mod, xyz, feats, new, B, timed=True, k_cut=None):
        layers = list(mod.mlp_shared.children())
        w2, w3 = (l.dense.weight.detach().t().contiguous() for l in layers[1:])
        b2, b3 = (l.dense.bias.detach() for l in layers[1:])
        bn = [p.detach() for l in layers for p in (l.bn.weight, l.bn.bias)]
        idx = ball_query(mod.radius, mod.nsample, xyz, new)
        if k_cut:  # fewer neighbours: R = B * S * K not a multiple of 32
            idx = idx[..., :k_cut].contiguous()
        inv_r = 1.0 / mod.radius if mod.normalize_xyz else 1.0
        a, ct = a_form(xyz, feats, new, layers[0].dense.weight.detach().t(),
                       layers[0].dense.bias.detach(), inv_r=inv_r, use_xyz=mod.use_xyz)
        N, S, K = xyz.shape[1], new.shape[1], idx.shape[2]
        c1, c2, c3 = a.shape[2], w2.shape[1], w3.shape[1]
        shape = f"{label} B={B} N={N} S={S} K={K} C={c1},{c2},{c3}"
        packs = k6.Packs(w2, w3, False)  # once, as the SA layer holds them
        out_k, st_k, _ = k6.sa_train_fwd_kernel(a, ct, idx, w2, b2, w3, b3, bn, packs)
        out_p, st_p, grids = k6.sa_train_fwd_plain(a, ct, idx, w2, b2, w3, b3, bn)
        g = torch.randn(B, S, c3, device=a.device, generator=gen)
        bargs = (g, a, ct, idx, grids, st_p, w2, b2, w3, b3, bn)
        bwd_k = k6.sa_train_bwd_kernel(*bargs, packs)
        bwd_p = k6.sa_train_bwd_plain(*bargs)
        torch.cuda.synchronize()
        errs["fwd"] = max(errs["fwd"], compare(f"K6 fwd {shape} out", out_k, out_p))
        for i, (x, y) in enumerate(zip(st_k, st_p)):
            what = ("mean", "var")[i % 2]
            errs["fwd"] = max(errs["fwd"], compare(f"K6 fwd {shape} {what}{i // 2 + 1}", x, y))
        for name, x, y in (("da", bwd_k[0], bwd_p[0]), ("dct", bwd_k[1], bwd_p[1]),
                           ("dW2", bwd_k[2], bwd_p[2]), ("dW3", bwd_k[3], bwd_p[3]),
                           ("dgamma,dbeta", torch.cat(bwd_k[4]), torch.cat(bwd_p[4]))):
            errs["bwd"] = max(errs["bwd"], compare(f"K6 bwd {shape} {name}", x, y))
        if not timed:
            return
        fns = (lambda: k6.sa_train_fwd_kernel(a, ct, idx, w2, b2, w3, b3, bn, packs),
               lambda: k6.sa_train_fwd_plain(a, ct, idx, w2, b2, w3, b3, bn),
               lambda: k6.sa_train_bwd_kernel(*bargs, packs),
               lambda: k6.sa_train_bwd_plain(*bargs))
        if B == TRAIN_B:
            per_pass["forward"].append(fns[0])
            per_pass["backward"].append(fns[2])
        t = [time_ms(f, iters=5, repeats=5) for f in fns]
        t2 = [time_ms(f, iters=5, repeats=5) for f in reversed(fns)][::-1]
        t = [min(x, y) for x, y in zip(t, t2)]
        d = [device_ms(f, iters=3) for f in fns]
        for i in range(4):
            sums[B][i] += t[i]
            dev[B][i] = None if d[i] is None or dev[B][i] is None else dev[B][i] + d[i]
        for i, w in enumerate(k6_work(B, N, S, K, c1, c2, c3)):
            work[B][i][0] += w[0]
            work[B][i][1] += w[1]
        print(f"  time {shape}: fwd kernel {t[0]:.4f} ms plain {t[1]:.4f} ms, bwd kernel "
              f"{t[2]:.4f} ms plain {t[3]:.4f} ms; device time fwd {fmt_ms(d[0])} / "
              f"{fmt_ms(d[1])}, bwd {fmt_ms(d[2])} / {fmt_ms(d[3])} [{card}]", flush=True)

    with torch.no_grad():
        for label, mod, xyz_all, feats_all, new_all in calls:
            for B in K6_BATCHES:
                one(label, mod, xyz_all[:B].contiguous(), feats_all[:B].contiguous(),
                    new_all[:B].contiguous(), B)
        # a ragged centroid count; B = 1 with an odd one (R not a multiple of 64),
        # and with 20 neighbours (R not a multiple of 32)
        label, mod, xyz, feats, new = calls[2]
        B = K6_BATCHES[0]
        one(f"{label} ragged", mod, xyz[:B].contiguous(), feats[:B].contiguous(),
            new[:B, :new.shape[1] - 3].contiguous(), B, timed=False)
        for k_cut in (None, 20):
            one(f"{label} ragged", mod, xyz[:1].contiguous(), feats[:1].contiguous(),
                new[:1, :new.shape[1] - 5].contiguous(), 1, timed=False, k_cut=k_cut)
        for what, fns in per_pass.items():
            pass_breakdown(f"K6 {what}", fns, card)
    for B in K6_BATCHES:
        line = []
        for i, what in ((0, "fwd"), (2, "bwd")):
            b32, by = bound_of(*work[B][i // 2])
            btc, _ = tc_bound_of(*work[B][i // 2])
            d = dev[B][i]
            share = "not measured" if d is None else f"{btc / d:.1%}"
            line.append(f"{what} kernel {sums[B][i]:.4f} ms plain {sums[B][i + 1]:.4f} ms (device "
                        f"{fmt_ms(d)} / {fmt_ms(dev[B][i + 1])}; bound f32 {b32:.4f} ms by {by}, "
                        f"3xTF32 {btc:.4f} ms, device at {share} of it)")
        print(f"  K6 over one BAT train step's 4 calls, B={B}: {'; '.join(line)} [{card}]",
              flush=True)
    print("phase 11 ok: K6 forward and backward within tolerance at every K6 call of a BAT "
          "train step", flush=True)
    return errs, sums, work


def rel_err(x, want, floor: float = 0.0) -> float:
    """|x - want| / max(|want|, floor, 1e-6 per element) over a whole tensor."""
    import torch

    floor = max(floor, 1e-6 * want.numel() ** 0.5)
    return (torch.linalg.vector_norm(x - want) / max(torch.linalg.vector_norm(want).item(),
                                                      floor)).item()


def train_step_state(model, batch, state):
    """Activations (the backbone's features, the xcorr's output), loss terms,
    gradients and running statistics of one train step from `state`."""
    import torch

    model.net.load_state_dict(state)
    model.net.zero_grad(set_to_none=True)
    acts = {}

    def keep(name):
        def hook(mod, args, out):
            out = out[1] if isinstance(out, tuple) else out
            acts[f"act {name} {len(acts)}"] = out.detach().double()
        return hook

    hooks = [model.net.backbone.register_forward_hook(keep("backbone features")),
             model.net.xcorr.register_forward_hook(keep("xcorr"))]
    losses = model.loss(batch, model.apply_train(batch))
    for h in hooks:
        h.remove()
    losses["loss_total"].backward()
    torch.cuda.synchronize()
    out = dict(acts)
    out.update({f"loss {k}": v.detach().double().reshape(1) for k, v in losses.items()})
    out.update({f"grad {k}": p.grad.detach().double() for k, p in model.net.named_parameters()})
    out.update({f"stat {k}": b.detach().double() for k, b in model.net.named_buffers()
                if "running" in k})
    return out


def backbone_grads(model, batch, state, weights):
    """Gradients of the backbone's parameters for sum(features * w) over both
    clouds, from `state`: a smooth objective through the four K6 calls."""
    model.net.load_state_dict(state)
    model.net.train()
    model.net.zero_grad(set_to_none=True)
    total = 0.0
    for key, w in weights.items():
        n = batch[key].shape[1]
        _, feats, _ = model.net.backbone(batch[key], [n // 2, n // 4, n // 8])
        total = total + (feats * w.to(feats.dtype)).sum()
    total.backward()
    return {f"backbone grad {k}": p.grad.detach().double()
            for k, p in model.net.backbone.named_parameters()}


def check_train_step(name: str, B: int, want_launches, card: str, timed: bool) -> None:
    """One train step on the kernel path and on the plain path, both held
    against the plain path in float64 (same weights and batch; FPS and the
    ball queries take float32 distances on every path, so the same points).

    The backbone's features, the xcorr's output, the loss terms and the
    running statistics are continuous in the weights: each must stay within
    4x the plain float32 path's relative error from float64, or 1e-3.

    Gradients are far less well conditioned on this data: the synthetic
    search crops hold about 180 distinct points, so regularize_pc repeats
    most of the 1024 (seen: 836-844 repeats per cloud), and the SA maxima
    and BatchNorms see masses of exact and near ties. The backbone's
    gradients of a smooth objective (sum(features * w), through the four K6
    calls) came out 8.6e-4 to 4.8e-3 from float64, all together, on the
    float32 paths with and without the kernel (BAT and P2B at B = 16 on an
    H100), and up to 1.1e-2 for one tensor; each must stay within 4x the
    plain path's error or 2e-2, all together within 4x or 1e-2. The loss's gradients add
    discontinuities: the vote layer's ball query on computed vote positions
    and the max over the template (P2B: 64 points) resolve near-ties either
    way, each flip sending a row's gradient elsewhere (seen: 6.5e-2 on one
    path, 6.1e-3 on the other, every activation within 1e-5 of float64). So
    the loss's whole gradient must stay within 4x the plain path's or 0.1.
    """
    import torch

    cfg = matching_cfg(name)
    kern, variables = make_model(cfg, fused_eval=True)
    plain, _ = make_model(cfg, fused_eval=False, variables=variables)
    state = {k: v.clone() for k, v in kern.net.state_dict().items()}
    batch = kern.device_batch(train_batch(cfg, B, SEED))
    n = batch["search_points"].shape[1]
    repeats = [n - torch.unique(c, dim=0).shape[0] for c in batch["search_points"][:4]]
    print(f"  {name.upper()} B={B}: repeated search points in the first clouds: {repeats} of {n}")
    reset_training_counts()
    got = train_step_state(kern, batch, state)
    launches = training_counts()
    print(f"  {name.upper()} B={B}: one train step launched K3 {launches[0]}, K6 forward "
          f"{launches[1]}, backward {launches[2]}, K4 {launches[3]}", flush=True)
    if launches != want_launches:
        fail(f"{name} train step: launches {launches}, expected K3/K6 fwd/K6 bwd/K4 = "
             f"{want_launches}")
    ref = train_step_state(plain, batch, state)
    plain.net.double()
    truth = train_step_state(plain, {k: v.double() for k, v in batch.items()}, state)
    plain.net.float()
    dev = batch["search_points"].device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    weights = {k: torch.randn(B, batch[k].shape[1] // 8, 256, device=dev, generator=gen)
               for k in ("template_points", "search_points")}
    reset_training_counts()
    got.update(backbone_grads(kern, batch, state, weights))
    if training_counts()[1:3] != (4, 4):
        fail(f"{name}: the backbone alone launched K6 {training_counts()[1:3]}, expected 4 / 4")
    ref.update(backbone_grads(plain, batch, state, weights))
    plain.net.double()
    truth.update(backbone_grads(plain, {k: v.double() for k, v in batch.items()}, state, weights))
    plain.net.float()
    for k, v in got.items():
        if not torch.isfinite(v).all():
            fail(f"{name} train step: {k} not finite on the kernel path")
    grads = [k for k in truth if k.startswith("grad ")]
    e_k = rel_err(torch.cat([got[k].reshape(-1) for k in grads]),
                  torch.cat([truth[k].reshape(-1) for k in grads]))
    e_p = rel_err(torch.cat([ref[k].reshape(-1) for k in grads]),
                  torch.cat([truth[k].reshape(-1) for k in grads]))
    # a gradient is measured against at least 1e-3 of the largest one of its
    # objective: the Dense biases that feed a BatchNorm have gradient 0 in
    # exact arithmetic, and float32 leaves noise there on every path
    def group(k):
        return k.split(" ")[0] if k.startswith("grad ") else " ".join(k.split(" ")[:2])

    floors = {}
    for k in truth:
        if "grad" in k:
            floors[group(k)] = max(floors.get(group(k), 0.0),
                                   1e-3 * torch.linalg.vector_norm(truth[k]).item())
    rows = sorted(((rel_err(got[k], truth[k], floors.get(group(k), 0.0)),
                    rel_err(ref[k], truth[k], floors.get(group(k), 0.0)), k) for k in truth),
                  reverse=True)
    def limit(k, ep):
        return max(4 * ep, 2e-2 if k.startswith("backbone grad ") else 1e-3)

    bad = [k for ek, ep, k in rows if not k.startswith("grad ") and ek > limit(k, ep)]
    bb = [k for k in truth if k.startswith("backbone grad ")]
    b_k, b_p = (rel_err(torch.cat([x[k].reshape(-1) for k in bb]),
                        torch.cat([truth[k].reshape(-1) for k in bb])) for x in (got, ref))
    for ek, ep, k in rows[:4]:
        print(f"  {name.upper()} B={B} {k}: rel err vs float64 kernel path {ek:.3e} plain path "
              f"{ep:.3e}")
    for what in ("backbone grad", "act", "loss", "stat"):
        ek, ep, k = next(r for r in rows if r[2].startswith(what))
        print(f"  {name.upper()} B={B} worst {what}: {k} kernel path {ek:.3e} plain path {ep:.3e}")
    print(f"  {name.upper()} B={B}: rel err vs float64 of all backbone gradients together: "
          f"kernel path {b_k:.3e} plain path {b_p:.3e}; of the loss's gradients together: "
          f"kernel path {e_k:.3e} plain path {e_p:.3e}; {len(rows)} tensors", flush=True)
    if bad:
        fail(f"{name} train step: {bad[:5]} further from float64 than their bounds")
    if b_k > max(4 * b_p, 1e-2):
        fail(f"{name} train step: the backbone gradient is {b_k:.3e} from float64 (plain path "
             f"{b_p:.3e})")
    if e_k > max(4 * e_p, 0.1):
        fail(f"{name} train step: the gradient is {e_k:.3e} from float64 (plain path {e_p:.3e})")
    if timed:
        def step(model):
            model.net.zero_grad(set_to_none=True)
            model.loss(batch, model.apply_train(batch))["loss_total"].backward()

        t_k = time_ms(lambda: step(kern), iters=3, repeats=3)
        t_p = time_ms(lambda: step(plain), iters=2, repeats=2)
        print(f"  time {name.upper()} B={B} forward+backward: kernel path {t_k:.4f} ms plain path "
              f"{t_p:.4f} ms [{card}]", flush=True)


def check_trainer(card: str) -> tuple:
    """Trainer.fit at BAT_Car widths, B = 50, two epochs of four steps with
    validation on one tracklet; returns the launches of the fit run."""
    import numpy as np
    import torch

    from open3dsot_tpu_torch.data import get_dataset
    from open3dsot_tpu_torch.train.optim import make_optimizer
    from open3dsot_tpu_torch.train.trainer import Trainer

    cfg = matching_cfg("bat", syn_num_tracklets=8, tensorboard=False)
    model, _ = make_model(cfg, fused_eval=True)
    sampler = get_dataset(cfg, "train_siamese", "train")
    t0 = time.perf_counter()
    host = train_batch(cfg, TRAIN_B, SEED)
    host_s = time.perf_counter() - t0
    optimizer, scheduler = make_optimizer(cfg, model.net.parameters(), 100)
    t = step_time(model, model.device_batch(host), optimizer, scheduler, card,
                  f"B={TRAIN_B} at BAT_Car widths, prebuilt batch")
    print(f"train step B={TRAIN_B} at BAT_Car widths: {TRAIN_B * 1e3 / t['ms']:.2f} samples/s "
          f"on a prebuilt batch; host sample building {host_s * 1e3:.4f} ms per batch of "
          f"{TRAIN_B} [{card}]", flush=True)

    val = get_dataset(matching_cfg("bat", syn_num_tracklets=1), "test", "test")
    work_dir = ROOT / "runs" / "chip_smoke_fit"
    reset_training_counts()
    history = Trainer(model, cfg, work_dir=str(work_dir)).fit(sampler, val, epochs=2,
                                                               steps_per_epoch=4)
    torch.cuda.synchronize()
    launches = training_counts()
    last = history[-1]
    n2 = last["steps"] - history[0]["steps"]  # steps of epoch 2
    FIT_RATES["BAT f32"] = n2 / last["time_s"]
    print(f"fit: {last['steps']} steps of B={TRAIN_B}, losses {[h['loss'] for h in history]}; "
          f"epoch 2: {n2 / last['time_s']:.3f} steps/s, {n2 * TRAIN_B / last['time_s']:.2f} "
          f"samples/s, waiting for the loader {last['data_wait_s']:.4f} of {last['time_s']:.4f} s; "
          f"validation success {last['success']:.4f} precision {last['precision']:.4f} [{card}]",
          flush=True)
    print(f"launches in the fit run: K3 {launches[0]} K6 forward {launches[1]} backward "
          f"{launches[2]} K4 {launches[3]}", flush=True)
    if not all(np.isfinite(h["loss"]) for h in history):
        fail("fit: a loss is not finite")
    for f in ("ckpt_best.pt", "ckpt_last.pt", "ckpt_meta.json", "history.jsonl"):
        if not (work_dir / f).is_file():
            fail(f"fit: {f} not written")
    if launches[1] != 4 * 8 or launches[2] != 4 * 8 or launches[0] == 0 or launches[3] == 0:
        fail("fit: expected K6 4 forward and 4 backward launches per step, and K3/K4 launches")
    # the same epoch with the samples built by the loader's one background
    # thread alone: does the thread pool slow the training loop?
    serial = cfg.copy()
    serial.workers = 0
    t_one = Trainer(model, serial, work_dir=str(work_dir / "workers0")).fit(
        sampler, None, epochs=1, steps_per_epoch=4)[-1]
    print(f"fit with workers 0 (one loader thread): {t_one['steps'] / t_one['time_s']:.3f} steps/s, "
          f"waiting for the loader {t_one['data_wait_s']:.4f} of {t_one['time_s']:.4f} s; with "
          f"workers {cfg.workers}: {n2 / last['time_s']:.3f} steps/s [{card}]", flush=True)
    if not np.isfinite(t_one["loss"]):
        fail("fit with workers 0: the loss is not finite")
    return launches


def bat_k6_calls() -> list:
    """k6_calls of a BAT_Car train step at B = TRAIN_B, on the plain path."""
    cfg = matching_cfg("bat")
    _, variables = make_model(cfg, fused_eval=True)
    plain, _ = make_model(cfg, fused_eval=False, variables=variables)
    return k6_calls(plain, train_batch(cfg, TRAIN_B, SEED))


def training_phases(card: str, lib, k6_only: bool = False) -> list:
    """Phases 11-13 (11 alone with k6_only); returns the K6 entries of the
    kernels line."""
    cfg = matching_cfg("bat")
    _, variables = make_model(cfg, fused_eval=True)
    plain, _ = make_model(cfg, fused_eval=False, variables=variables)
    errs, sums, work = check_k6(k6_calls(plain, train_batch(cfg, TRAIN_B, SEED)), card, lib,
                                strict=not k6_only)
    del plain
    if k6_only:
        return []

    check_train_step("bat", 16, (2, 4, 4, 0), card, timed=True)
    check_train_step("p2b", 16, (0, 4, 4, 0), card, timed=False)
    print("phase 12 ok: BAT/P2B train step kernel path within bounds of float64 beside the plain "
          "path; BAT K3 x2, K6 x4 / x4 per step", flush=True)

    launches = check_trainer(card)
    cli = [sys.executable, "-m", "open3dsot_tpu_torch.main", "--cfg", "cfgs/BAT_synthetic.yaml",
           "--epoch", "1", "--device", "cuda", "--log_dir", str(ROOT / "runs" / "chip_smoke_cli")]
    proc = subprocess.run(cli, cwd=ROOT, capture_output=True, text=True, timeout=600)
    last = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    print(f"cli (BAT training): exit {proc.returncode}: {last}", flush=True)
    if proc.returncode != 0 or not last.startswith("trained "):
        fail(f"BAT CLI training failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    print("phase 13 ok", flush=True)

    replaces = "open3dsot_tpu/ops/sa_fused_train.py:608-776"
    return [
        kernel_entry("K6 fused_sa_train_apply (forward)", "sa_fused_train.cu", replaces,
                     launches[1], errs["fwd"], sums[TRAIN_B][0], sums[TRAIN_B][1],
                     work[TRAIN_B][0], tensor_core=True),
        kernel_entry("K6 fused_sa_train_apply (backward)", "sa_fused_train.cu", replaces,
                     launches[2], errs["bwd"], sums[TRAIN_B][2], sums[TRAIN_B][3],
                     work[TRAIN_B][1], tensor_core=True),
    ]


def probe_phase(card: str) -> list:
    """Phase 14: P1 and P2 through the probes' own run (probes/gather.py,
    probes/gather_bf16.py); returns their entries of the kernels line, timed
    at K4's largest gather (search SA0, B = 16) and, for the per-element
    gather and the one-hot's row sums, at P1's own shape."""
    from open3dsot_tpu_torch.probes import gather as pg
    from open3dsot_tpu_torch.probes import gather_bf16 as pb

    pg.reset_launch_counts()
    pb.reset_launch_counts()
    rows = (pg.run(time_fn=time_ms, device_fn=queued_ms)
            + pb.run(time_fn=time_ms, device_fn=queued_ms))
    launches = {**pg.launch_counts(), "gather_bf16_rows": pb.gather_bf16_rows.launches}
    for r in rows:
        print(f"  {pg.line(r)} [{card}]", flush=True)
    print(f"  probe launches: {launches}", flush=True)
    for B in (1, 16):
        tot = pg.fastest_exact(rows, B)
        print(f"  K4's seven gathers at B={B}, device time: "
              + ", ".join(f"{f} {t:.4f} ms" for f, t in tot.items())
              + f"; fastest exact form: {min(tot, key=tot.get)} [{card}]", flush=True)
    bad = [f"{r['what']} {r['label']} B={r['B']}" for r in rows if not r["ok"]]
    if bad:
        fail(f"probes differ from their plain versions: {bad}")
    if not all(launches.values()):
        fail(f"a probe kernel was not launched: {launches}")
    print("phase 14 ok: P1's forms and P2 equal to their plain versions (P1's one-hot by allclose)",
          flush=True)

    def entry(what, label, B, source_line, key):
        r = next(r for r in rows if r["what"] == what and r["label"] == label and r["B"] == B)
        return kernel_entry(f"{source_line[0]} {what} ({label}, B={B})", "gather_probe.cu",
                            source_line[1], launches[key], r["err"], r["ms"], r["plain_ms"],
                            (r["nbytes"], r["ops"]), library_ms=r["library_ms"],
                            peak=PEAK_TF32_FLOPS)

    p1, p2 = ("P1", "scripts/probe_gather.py:24"), ("P2", "scripts/probe_pallas_int8.py:51")
    return ([entry(f"gather_rows {f}", "search SA0", 16, p1, f"gather_rows {f}")
             for f in pg.FORMS]
            + [entry("gather_elems", "P1", 1, p1, "gather_elems"),
               entry("onehot_rowsums", "P1", 1, p1, "onehot_rowsums"),
               entry("gather_bf16_rows", "search SA0", 16, p2, "gather_bf16_rows")])


SCAN_T = 64  # bench.py's M2 scan: 16 tracklets x 64 frames, max_points 1024, frame_bucket 64
SCAN_MAX_POINTS = 1024
SCAN_BATCHES = (1, 8, 16)

def scan_host(tracker, seqs) -> list:
    """A batch's host tensors (pinned) as the tracker ships them: packed
    points, counts, wlh, init."""
    return tracker._prepare(seqs)[2]


def to_card(host: list) -> list:
    return [t.to("cuda", non_blocking=True) for t in host]


def wall_ms(fn, repeats: int = 5) -> float:
    """Median host wall time of fn() up to a device synchronize, in ms."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def chain_records(rows) -> tuple:
    """Profiler records of K1/K2's kernels: (chain_tc_kernel, pool_bias_kernel);
    K2 launches pool_bias_kernel once, each K1/K2 call chain_tc_kernel once a stage."""
    return (sum(e.count for e in rows if "chain_tc_kernel" in e.key),
            sum(e.count for e in rows if "pool_bias_kernel" in e.key))


SCORE_ATOL = 3e-4  # device (float32) against host (float64) scoring, tests/test_iou_device.py's


def check_scores(tracker, seqs, cfg, device_sp, host_sp) -> None:
    """On-device scoring against host scoring: every frame's IoU and distance
    within SCORE_ATOL, Precision equal, and Success equal up to the frame-0
    self-IoU of each tracklet, which lands on 1.0 or a hair below it by the
    rounding of each side (geometry/iou_device.py's docstring): each such frame
    moves Success by 100 * (1/40) / frames, the trapezoid weight of the
    threshold 1.0."""
    import numpy as np

    iou_d, dist_d = (t.cpu().numpy() for t in tracker.dispatch_scored(seqs))
    host = tracker.evaluate_sequences(seqs, cfg)
    iou_h, dist_h = np.array([h[0] for h in host]), np.array([h[1] for h in host])
    e_iou, e_dist = np.abs(iou_d - iou_h).max(), np.abs(dist_d - dist_h).max()
    flips = int(((iou_d[:, 0] >= 1.0) != (iou_h[:, 0] >= 1.0)).sum())
    bound = flips * 100 * (1 / 40) / iou_h.size
    print(f"  scoring on the card against the host: max |iou diff| {e_iou:.3e}, max |distance "
          f"diff| {e_dist:.3e} (atol {SCORE_ATOL}); {flips} of {len(seqs)} frame-0 self-IoUs "
          f"on the other side of 1.0, Success may differ by {bound:.6f}: it differs by "
          f"{abs(device_sp[0] - host_sp[0]):.6f}, Precision by {abs(device_sp[1] - host_sp[1]):.6f}",
          flush=True)
    if not (e_iou <= SCORE_ATOL and e_dist <= SCORE_ATOL):
        fail(f"on-device scores differ from the host's by {e_iou}, {e_dist}")
    if device_sp[1] != host_sp[1] or abs(device_sp[0] - host_sp[0]) > bound + 1e-9:
        fail(f"on-device scoring {device_sp} != host scoring {host_sp} beyond the frame-0 flips")


def first_step_float64(plain, plain_model, dev):
    """The first step's boxes (B, 4) of the plain path in float64 (the net
    converted and back), on a batch's device tensors (pts, counts, wlh, init).

    Phase 15 holds the kernel path's first step to it by `compare` (the
    kernels' tolerance, relative to the boxes' size), not to the plain
    float32 path at an absolute 5e-4: on random weights the boxes reach tens
    of metres and radians and the second MiniPointNet amplifies rounding, so
    the plain float32 path is itself 1.5e-3 from float64 at B = 16 on the
    card. A fault (a wrong index, a missed tile) gives errors of order one."""
    import torch

    from open3dsot_tpu_torch.tracking.scan_tracker import _expand_counts

    pts, counts, wlh, init = dev
    valid = _expand_counts(counts[:, :2], pts.shape[2])
    net = plain_model.net.double()
    try:
        return plain._step(wlh.double(), init.double(), pts[:, 0].double(), valid[:, 0],
                           pts[:, 1].double(), valid[:, 1],
                           torch.zeros((), dtype=torch.int64, device=pts.device))
    finally:
        net.float()


def scan_phase(card: str) -> None:
    """Phase 15: the M2 scan tracker (tracking/scan_tracker.py) on the card at
    bench.py's configuration; see the module docstring."""
    import torch

    from open3dsot_tpu_torch.data import get_dataset
    from open3dsot_tpu_torch.ops import chain_fused as cf
    from open3dsot_tpu_torch.tracking import scan_tracker as st

    cfg = bench_cfg(syn_num_tracklets=16, syn_tracklet_len=SCAN_T)
    model, variables = make_model(cfg, fused_eval=True)
    plain_model, _ = make_model(cfg, fused_eval=False, variables=variables)
    sampler = get_dataset(cfg, "test", "test")
    seqs = [sampler[i] for i in range(len(sampler))]
    kw = dict(max_points=SCAN_MAX_POINTS, frame_bucket=SCAN_T)
    graph = st.M2ScanTracker(model, cfg, **kw)
    eager = st.M2ScanTracker(model, cfg, cuda_graph=False, **kw)
    plain = st.M2ScanTracker(plain_model, cfg, cuda_graph=False, **kw)
    steps = SCAN_T - 1
    for B in SCAN_BATCHES:
        host = scan_host(graph, seqs[:B])
        mb = sum(t.numel() * t.element_size() for t in host) / 1e6
        h2d = time_ms(lambda: to_card(host), iters=5, repeats=5)
        dev = to_card(host)
        t0 = time.perf_counter()
        g_boxes = graph.track_frames(*dev)  # captures the step for (B, P) here
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        e_boxes = eager.track_frames(*dev)
        torch.cuda.synchronize()
        same = torch.equal(g_boxes, e_boxes)
        diff = (g_boxes - e_boxes).abs().max().item()
        print(f"  scan B={B}: graph boxes {'bit-identical to' if same else 'DIFFER from'} the eager "
              f"path's (max |diff| {diff:.3e}); first call with the capture {capture_s:.3f} s",
              flush=True)
        if B in (1, 16) and not same:
            fail(f"scan B={B}: the graph path's boxes differ from the eager path's by {diff}")
        if not torch.isfinite(g_boxes).all():
            fail(f"scan B={B}: non-finite boxes")
        # the frame loop makes no host sync: a synchronizing call raises in this mode
        torch.cuda.set_sync_debug_mode("error")
        try:
            graph.track_frames(*dev)
            eager.track_frames(*dev)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        t_g = wall_ms(lambda: graph.track_frames(*dev))
        t_e = wall_ms(lambda: eager.track_frames(*dev))
        frames = B * steps
        # A window can lose records (ROADMAP §3; once a whole replay's, 5 + 1 of 315 + 63,
        # measured on one H100): a lost record only lowers a count, so up to three windows
        # are taken until the replays' and the eager steps' records agree.
        for window in range(3):
            rows_g = device_rows(lambda: graph.track_frames(*dev))
            cf.reset_launch_counts()
            rows_e = device_rows(lambda: eager.track_frames(*dev))
            wrapped = (cf.fused_pointnet_encoder.launches, cf.fused_seg_head.launches)
            rec_g, rec_e = chain_records(rows_g), chain_records(rows_e)
            if rec_g == rec_e and rec_g[1] == steps:
                break
            print(f"  scan B={B}: profiler window {window + 1} short of records: replays "
                  f"{rec_g}, eager steps {rec_e} (chain_tc_kernel, pool_bias_kernel) over {steps} "
                  f"steps", flush=True)
        busy_g = sum(dev_us(e) for e in rows_g) / frames
        busy_e = sum(dev_us(e) for e in rows_e) / frames
        wall_g, wall_e = t_g * 1e3 / frames, t_e * 1e3 / frames
        EAGER_RATES[f"M2 eager scan B={B}"] = frames / t_e * 1e3
        print(f"  scan B={B}: {frames} frames a batch; frames/s graph {frames / t_g * 1e3:.2f} "
              f"eager {frames / t_e * 1e3:.2f} (batch on the card, to a synchronize); device busy "
              f"per frame graph {busy_g:.2f} us eager {busy_e:.2f} us; wall per frame graph "
              f"{wall_g:.2f} us eager {wall_e:.2f} us; idle share graph {1 - busy_g / wall_g:.3f} "
              f"eager {1 - busy_e / wall_e:.3f}; H2D of the batch {h2d:.4f} ms for {mb:.2f} MB "
              f"[{card}]", flush=True)
        per_replay = graph.graph_launches()["captured_per_replay"]
        print(f"  scan B={B}: profiler records over {steps} steps (windows opened on a sleep kernel): "
              f"graph chain_tc_kernel {rec_g[0]} pool_bias_kernel {rec_g[1]}; eager {rec_e[0]} / "
              f"{rec_e[1]}; eager wrapper launches K1 {wrapped[0]} K2 {wrapped[1]}; the graph "
              f"captured K1/K2 {per_replay} per replay (wrappers count at capture)", flush=True)
        if wrapped != (3 * steps, steps) or (3, 1) not in per_replay:
            fail(f"scan B={B}: expected K1 x3 and K2 x1 per step, got eager {wrapped} over {steps} "
                 f"steps and {per_replay} captured per replay")
        if rec_g != rec_e or rec_g[1] != steps or rec_g[0] < 4 * steps:
            fail(f"scan B={B}: the replays ran K1/K2's kernels {rec_g}, the eager steps {rec_e} "
                 f"(expected equal, pool_bias_kernel once a step)")
        print(f"  scan B={B}: graph device time by kernel, us a step (launches a step), "
              f"{sum(e.count for e in rows_g) / steps:.1f} launches a step in all:", flush=True)
        for e in sorted(rows_g, key=lambda e: -dev_us(e))[:10]:
            print(f"    {dev_us(e) / steps:9.2f} us ({e.count / steps:5.2f})  {e.key[:100]}")
        if B == 16:
            p_boxes = plain.track_frames(*dev)
            truth = first_step_float64(plain, plain_model, dev)
            e_p = (p_boxes[:, 0].double() - truth).abs().max().item()
            e_kp = (g_boxes[:, 0] - p_boxes[:, 0]).abs().max().item()
            e_all = (g_boxes - p_boxes).abs().max().item()
            compare("scan B=16 first-step boxes, kernel path against the plain path in float64",
                    g_boxes[:, 0].double(), truth)
            print(f"  scan B=16: first-step boxes, the plain float32 path from float64 {e_p:.3e}, "
                  f"the kernel path from the plain float32 path {e_kp:.3e}; over the whole "
                  f"trajectories {e_all:.3e} (argmax gates part them on random weights)", flush=True)
            gp, gw = (torch.from_numpy(a).cuda() for a in st._gt_arrays(seqs[:16], SCAN_T, None))
            score = st._make_scorer(cfg)
            t_score = time_ms(lambda: score(g_boxes, dev[-1], dev[-2], gp, gw), iters=5, repeats=5)
            print(f"  scan B=16: scorer (IoU + distance of 16 x {SCAN_T} boxes on the card) "
                  f"{t_score:.4f} ms by events [{card}]", flush=True)

    # the scan slice through its entry points: counts from 0, a fresh tracker
    n_frames = sum(len(s) - 1 for s in seqs)
    cf.reset_launch_counts()
    fresh = st.M2ScanTracker(model, cfg, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    succ, prec = st.evaluate_dataset_scan(model, sampler, cfg, tracker=fresh)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    k1, k2 = cf.fused_pointnet_encoder.launches, cf.fused_seg_head.launches
    gl = fresh.graph_launches()
    print(f"scan eval: {len(seqs)} tracklets x {SCAN_T} frames, on-device scoring: success "
          f"{succ:.4f} precision {prec:.4f}; {n_frames} frames in {dt:.4f} s = {n_frames / dt:.2f} "
          f"frames/s (the first batch captures the graph) [{card}]", flush=True)
    print(f"launches in the scan eval run: K1 {k1} K2 {k2} by the wrappers (warm-up and capture; "
          f"a graph counts at capture); the graphs launched K1/K2 {gl['captured_per_replay']} per "
          f"replay x {gl['replays']} replays", flush=True)
    if not (k1 and k2) or gl["captured_per_replay"] != [(3, 1)] or gl["replays"] != steps:
        fail(f"the scan eval run did not go through K1/K2 in a graph: {k1}, {k2}, {gl}")
    t0 = time.perf_counter()
    h_succ, h_prec = st.evaluate_dataset_scan(model, sampler, cfg, tracker=fresh,
                                              device_metrics=False)
    h_dt = time.perf_counter() - t0
    print(f"scan eval, host scoring: success {h_succ:.4f} precision {h_prec:.4f}; "
          f"{n_frames / h_dt:.2f} frames/s [{card}]", flush=True)
    check_scores(fresh, seqs, cfg, (succ, prec), (h_succ, h_prec))
    p_succ, p_prec = st.evaluate_dataset_scan(plain_model, sampler, cfg, tracker=plain)
    print(f"scan eval, plain path (eager): success {p_succ:.4f} precision {p_prec:.4f}", flush=True)
    for v in (succ, prec, p_succ, p_prec):
        if not 0 <= v <= 100:
            fail(f"Success/Precision not finite in [0, 100]: {succ, prec, p_succ, p_prec}")

    # new weights loaded in place: the graph is captured again and follows them
    from open3dsot_tpu_torch.weights import random_variables, state_dict_from_jax

    before = graph.track_frames(*dev)
    model.net.load_state_dict(state_dict_from_jax(random_variables(model.net, SEED + 1)))
    after, want = graph.track_frames(*dev), eager.track_frames(*dev)
    torch.cuda.synchronize()
    print(f"  scan B=16, new weights: graph boxes {'equal' if torch.equal(after, want) else 'DIFFER'} "
          f"to the eager path's, max change from the old weights' boxes "
          f"{(after - before).abs().max().item():.3e}", flush=True)
    if not torch.equal(after, want) or torch.equal(after, before):
        fail("the graph did not follow new weights")

    cli = [sys.executable, "-m", "open3dsot_tpu_torch.main", "--cfg", "cfgs/M2_track_synthetic.yaml",
           "--test", "--tracker", "scan", "--device", "cuda"]
    proc = subprocess.run(cli, cwd=ROOT, capture_output=True, text=True, timeout=600)
    last = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    print(f"cli --tracker scan: exit {proc.returncode}: {last}", flush=True)
    if proc.returncode != 0 or not last.startswith("success/test:"):
        fail(f"CLI scan eval failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    print("phase 15 ok: graph == eager bit for bit, K1 x3 and K2 x1 a replay, device scores == "
          "host scores (frame-0 self-IoUs aside)", flush=True)


MATCH_T = 64  # bench.py's matching scan: 64-frame tracklets, max_points 1024, frame_bucket 64
MATCH_KW = dict(max_points=1024, frame_bucket=MATCH_T, first_crop_points=1024)
K34_RECORDS = (("fps_kernel", 2), ("bq_kernel", 7), ("sa_tc_kernel", 7))  # BAT, a step


def match_cfg(name: str, path=None, **kw):
    """bench.py's matching scan configuration (bench.py:209-262) at the
    shipped widths: 16 tracklets x 64 frames, firstandprevious,
    previous_result, use_z and limit_box off; `path` loads another config
    file with its own settings instead."""
    from open3dsot_tpu_torch.config import load_config

    over = dict(dataset="synthetic", syn_num_tracklets=16, syn_tracklet_len=MATCH_T, seed=SEED,
                tensorboard=False)
    if path is None:
        over.update(use_z=False, limit_box=False, shape_aggregation="firstandprevious",
                    reference_BB="previous_result")
        path = ROOT / MATCHING_CFG[name]
    over.update(kw)
    return load_config(str(path), over)


def k34_records(rows) -> tuple:
    """Profiler records of K3's and K4's kernels: (fps_kernel, bq_kernel,
    sa_tc_kernel); K3 launches fps_kernel once, K4 bq_kernel and sa_tc_kernel."""
    return tuple(sum(e.count for e in rows if name in e.key) for name, _ in K34_RECORDS)


def match_first_step_float64(plain, plain_model, dev):
    """The first step's boxes (B, 4) of the plain matching path in float64
    (the net converted and back), on a batch's device tensors."""
    import torch

    from open3dsot_tpu_torch.tracking.scan_tracker import _expand_counts

    pts, counts, wlh, init, first_pts, first_count = dev
    valid = _expand_counts(counts[:, :2], pts.shape[2])
    first_valid = _expand_counts(first_count, first_pts.shape[1])
    carry = tuple(c.double() if c.is_floating_point() else c for c in plain._carry0(init, wlh))
    net = plain_model.net.double()
    try:
        return plain._step(first_pts.double(), first_valid, carry,
                           (pts[:, 0].double(), valid[:, 0], pts[:, 1].double(), valid[:, 1]))[1]
    finally:
        net.float()


def graph_equals_eager(graph, eager, dev, what: str) -> None:
    """Fails unless the graph path's boxes are bit-identical to the eager path's."""
    import torch

    g, e = graph.track_frames(*dev), eager.track_frames(*dev)
    torch.cuda.synchronize()
    same = torch.equal(g, e)
    print(f"  {what}: graph boxes {'bit-identical to' if same else 'DIFFER from'} the eager "
          f"path's (max |diff| {(g - e).abs().max().item():.3e})", flush=True)
    if not same or not torch.isfinite(g).all():
        fail(f"{what}: the graph path's boxes differ from the eager path's, or are not finite")


def match_scan_phase(card: str) -> None:
    """Phase 16: the matching scan tracker (tracking/scan_matching.py) on the
    card at bench.py's matching configuration; see the module docstring."""
    import torch

    from open3dsot_tpu_torch.data import get_dataset
    from open3dsot_tpu_torch.ops import sa_fused, sampling
    from open3dsot_tpu_torch.tracking import scan_matching as sm

    cfg = match_cfg("bat")
    model, variables = make_model(cfg, fused_eval=True)
    plain_model, _ = make_model(cfg, fused_eval=False, variables=variables)
    sampler = get_dataset(cfg, "test", "test")
    seqs = [sampler[i] for i in range(len(sampler))]
    graph = sm.MatchScanTracker(model, cfg, **MATCH_KW)
    eager = sm.MatchScanTracker(model, cfg, cuda_graph=False, **MATCH_KW)
    plain = sm.MatchScanTracker(plain_model, cfg, cuda_graph=False, **MATCH_KW)
    steps = MATCH_T - 1
    want_records = tuple(n * steps for _, n in K34_RECORDS)
    for B in SCAN_BATCHES:
        host = scan_host(graph, seqs[:B])
        mb = sum(t.numel() * t.element_size() for t in host) / 1e6
        h2d = time_ms(lambda: to_card(host), iters=5, repeats=5)
        dev = to_card(host)
        t0 = time.perf_counter()
        g_boxes = graph.track_frames(*dev)  # captures the step for (B, P, P1) here
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        e_boxes = eager.track_frames(*dev)
        torch.cuda.synchronize()
        same = torch.equal(g_boxes, e_boxes)
        print(f"  match scan BAT B={B}: graph boxes "
              f"{'bit-identical to' if same else 'DIFFER from'} the eager path's (max |diff| {(g_boxes - e_boxes).abs().max().item():.3e}); first "
              f"call with the capture {capture_s:.3f} s", flush=True)
        if not same or not torch.isfinite(g_boxes).all():
            fail(f"match scan B={B}: the graph path's boxes differ from the eager path's, or are "
                 f"not finite")
        # the frame loop makes no host sync: a synchronizing call raises in this mode
        torch.cuda.set_sync_debug_mode("error")
        try:
            graph.track_frames(*dev)
            eager.track_frames(*dev)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        t_g = wall_ms(lambda: graph.track_frames(*dev))
        t_e = wall_ms(lambda: eager.track_frames(*dev), repeats=3)
        frames = B * steps
        # a window can lose records (ROADMAP §3): up to three windows are taken
        for window in range(3):
            rows_g = device_rows(lambda: graph.track_frames(*dev))
            reset_matching_counts()
            rows_e = device_rows(lambda: eager.track_frames(*dev))
            wrapped = matching_counts()[:2]
            rec_g, rec_e = k34_records(rows_g), k34_records(rows_e)
            if rec_g == rec_e == want_records:
                break
            print(f"  match scan B={B}: profiler window {window + 1} short of records: replays "
                  f"{rec_g}, eager steps {rec_e} (fps_kernel, bq_kernel, sa_tc_kernel) over "
                  f"{steps} steps", flush=True)
        busy_g = sum(dev_us(e) for e in rows_g) / frames
        busy_e = sum(dev_us(e) for e in rows_e) / frames
        wall_g, wall_e = t_g * 1e3 / frames, t_e * 1e3 / frames
        EAGER_RATES[f"BAT eager scan B={B}"] = frames / t_e * 1e3
        print(f"  match scan BAT B={B}: {frames} frames a batch; frames/s graph "
              f"{frames / t_g * 1e3:.2f} eager {frames / t_e * 1e3:.2f} (batch on the card, to a "
              f"synchronize); device busy per frame graph {busy_g:.2f} us eager {busy_e:.2f} us; "
              f"wall per frame graph {wall_g:.2f} us eager {wall_e:.2f} us; idle share graph "
              f"{1 - busy_g / wall_g:.3f} eager {1 - busy_e / wall_e:.3f}; H2D of the batch "
              f"{h2d:.4f} ms for {mb:.2f} MB [{card}]", flush=True)
        per_replay = graph.graph_launches()["captured_per_replay"]
        print(f"  match scan BAT B={B}: profiler records over {steps} steps (windows opened on a "
              f"sleep kernel), fps_kernel / bq_kernel / sa_tc_kernel: graph {rec_g}, eager "
              f"{rec_e}; eager wrapper launches K3 {wrapped[0]} K4 {wrapped[1]}; the graph "
              f"captured K3/K4 {per_replay} per replay (wrappers count at capture)", flush=True)
        if wrapped != (2 * steps, 7 * steps) or (2, 7) not in per_replay:
            fail(f"match scan B={B}: expected K3 x2 and K4 x7 per step, got eager {wrapped} over "
                 f"{steps} steps and {per_replay} captured per replay")
        if rec_g != want_records or rec_e != want_records:
            fail(f"match scan B={B}: the replays ran K3/K4's kernels {rec_g}, the eager steps "
                 f"{rec_e}, expected {want_records}")
        print(f"  match scan BAT B={B}: graph device time by kernel, us a step (launches a step), "
              f"{sum(e.count for e in rows_g) / steps:.1f} launches a step in all:", flush=True)
        for e in sorted(rows_g, key=lambda e: -dev_us(e))[:10]:
            print(f"    {dev_us(e) / steps:9.2f} us ({e.count / steps:5.2f})  {e.key[:100]}")
        if B == 16:
            p_boxes = plain.track_frames(*dev)
            truth = match_first_step_float64(plain, plain_model, dev)
            e_k = (g_boxes[:, 0].double() - truth).abs().max().item()
            e_p = (p_boxes[:, 0].double() - truth).abs().max().item()
            e_kp = (g_boxes[:, 0] - p_boxes[:, 0]).abs().max().item()
            e_all = (g_boxes - p_boxes).abs().max().item()
            print(f"  match scan B=16: first-step boxes, the kernel path from the plain path in "
                  f"float64 {e_k:.3e} (atol {BOX_ATOL}); the plain float32 path from float64 "
                  f"{e_p:.3e}; the kernel path from the plain float32 path {e_kp:.3e}; over the "
                  f"whole trajectories {e_all:.3e} (argmax proposals part them on random weights)",
                  flush=True)
            if not e_k <= BOX_ATOL:
                fail(f"match scan B=16: first-step boxes {e_k} from the plain path in float64")
            from open3dsot_tpu_torch.tracking import scan_tracker as st

            gp, gw = (torch.from_numpy(a).cuda() for a in st._gt_arrays(seqs[:16], MATCH_T, None))
            score = st._make_scorer(cfg)
            t_score = time_ms(lambda: score(g_boxes, dev[3], dev[2], gp, gw), iters=5, repeats=5)
            print(f"  match scan B=16: scorer (IoU + distance of 16 x {MATCH_T} boxes on the card) "
                  f"{t_score:.4f} ms by events [{card}]", flush=True)

    # P2B (P2B_Car: camera basis, no FPS, limit_box with the 'uniform' redraw) at B = 8
    p2b_cfg = match_cfg("p2b", path=ROOT / MATCHING_CFG["p2b"])
    p2b, _ = make_model(p2b_cfg, fused_eval=True)
    p2b_seqs = [get_dataset(p2b_cfg, "test", "test")[i] for i in range(8)]
    p2b_graph = sm.MatchScanTracker(p2b, p2b_cfg, **MATCH_KW)
    p2b_eager = sm.MatchScanTracker(p2b, p2b_cfg, cuda_graph=False, **MATCH_KW)
    dev = to_card(scan_host(p2b_graph, p2b_seqs))
    graph_equals_eager(p2b_graph, p2b_eager, dev, "match scan P2B B=8 (camera basis, limit_box)")
    reset_matching_counts()
    p2b_eager.track_frames(*dev)
    torch.cuda.synchronize()
    wrapped, per_replay = matching_counts()[:2], p2b_graph.graph_launches()["captured_per_replay"]
    t_g = wall_ms(lambda: p2b_graph.track_frames(*dev))
    print(f"  match scan P2B B=8: frames/s graph {8 * steps / t_g * 1e3:.2f}; eager wrapper "
          f"launches K3 {wrapped[0]} K4 {wrapped[1]} over {steps} steps; the graph captured K3/K4 "
          f"{per_replay} per replay [{card}]", flush=True)
    if wrapped != (0, 7 * steps) or per_replay != [(0, 7)]:
        fail(f"match scan P2B: expected K3 x0 and K4 x7 per step, got {wrapped}, {per_replay}")

    # BAT_Pedestrian's limit_box 'uniform' redraw, and the 'all' reservoir, at B = 8
    for what, mcfg in (("BAT_Pedestrian (limit_box uniform)",
                        match_cfg("bat", path=ROOT / "cfgs" / "BAT_Pedestrian.yaml")),
                       ("BAT shape_aggregation all", match_cfg("bat", shape_aggregation="all"))):
        m, _ = make_model(mcfg, fused_eval=True, variables=variables)
        mseqs = [get_dataset(mcfg, "test", "test")[i] for i in range(8)]
        g_tr = sm.MatchScanTracker(m, mcfg, **MATCH_KW)
        dev = to_card(scan_host(g_tr, mseqs))
        graph_equals_eager(g_tr, sm.MatchScanTracker(m, mcfg, cuda_graph=False, **MATCH_KW), dev,
                           f"match scan {what} B=8")

    # the matching scan slice through its entry points: counts from 0, a fresh tracker
    n_frames = sum(len(s) - 1 for s in seqs)
    reset_matching_counts()
    fresh = sm.MatchScanTracker(model, cfg, **MATCH_KW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    succ, prec = sm.evaluate_dataset_scan_matching(model, sampler, cfg, tracker=fresh)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    k3, k4 = matching_counts()[:2]
    gl = fresh.graph_launches()
    print(f"match scan eval: {len(seqs)} tracklets x {MATCH_T} frames, batches of 8, on-device "
          f"scoring: success {succ:.4f} precision {prec:.4f}; {n_frames} frames in {dt:.4f} s = "
          f"{n_frames / dt:.2f} frames/s (the first batch captures the graph) [{card}]", flush=True)
    print(f"launches in the match scan eval run: K3 {k3} K4 {k4} by the wrappers (warm-up and "
          f"capture); the graphs launched K3/K4 {gl['captured_per_replay']} per replay x "
          f"{gl['replays']} replays", flush=True)
    if not (k3 and k4) or gl["captured_per_replay"] != [(2, 7)] or gl["replays"] != 2 * steps:
        fail(f"the match scan eval run did not go through K3/K4 in a graph: {k3}, {k4}, {gl}")
    t0 = time.perf_counter()
    h_succ, h_prec = sm.evaluate_dataset_scan_matching(model, sampler, cfg, tracker=fresh,
                                                       device_metrics=False)
    h_dt = time.perf_counter() - t0
    print(f"match scan eval, host scoring: success {h_succ:.4f} precision {h_prec:.4f}; "
          f"{n_frames / h_dt:.2f} frames/s [{card}]", flush=True)
    check_scores(fresh, seqs, cfg, (succ, prec), (h_succ, h_prec))
    p_succ, p_prec = sm.evaluate_dataset_scan_matching(plain_model, sampler, cfg, tracker=plain)
    print(f"match scan eval, plain path (eager): success {p_succ:.4f} precision {p_prec:.4f}",
          flush=True)
    for v in (succ, prec, p_succ, p_prec):
        if not 0 <= v <= 100:
            fail(f"Success/Precision not finite in [0, 100]: {succ, prec, p_succ, p_prec}")

    cli = [sys.executable, "-m", "open3dsot_tpu_torch.main", "--cfg", "cfgs/BAT_synthetic.yaml",
           "--test", "--tracker", "scan", "--device", "cuda"]
    proc = subprocess.run(cli, cwd=ROOT, capture_output=True, text=True, timeout=600)
    last = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    print(f"cli --tracker scan (BAT): exit {proc.returncode}: {last}", flush=True)
    if proc.returncode != 0 or not last.startswith("success/test:"):
        fail(f"BAT CLI scan eval failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    print("phase 16 ok: BAT graph == eager bit for bit, K3 x2 and K4 x7 a replay (P2B K4 x7), "
          "device scores == host scores (frame-0 self-IoUs aside)", flush=True)


ONLINE_T = 17  # frames a synthetic tracklet in phase 17: 16 steps
ONLINE_P, ONLINE_FIRST_CROP = 1024, 512  # scripts/bench_online.py's max_points, first_crop_points
ONLINE_STEPS = 50  # step() calls a wall-time median is taken over
# wrapper launches captured per replay: (K1, K2, K3, K4)
ONLINE_LAUNCHES = {"m2track": (3, 1, 0, 0), "bat": (0, 0, 2, 7), "p2b": (0, 0, 0, 7)}


def online_cfg(name: str):
    """scripts/bench_online.py's configurations with 32 synthetic tracklets
    of ONLINE_T frames: M2 as bench.py builds it, BAT_Car and P2B_Car as
    phase 16's (firstandprevious, previous_result, use_z and limit_box off)."""
    if name == "m2track":
        return bench_cfg(syn_num_tracklets=32, syn_tracklet_len=ONLINE_T)
    return match_cfg(name, syn_num_tracklets=32, syn_tracklet_len=ONLINE_T)


def online_tracker(model, cfg, B: int, **kw):
    from open3dsot_tpu_torch.tracking.online import make_online_tracker

    if cfg.net_model.lower() != "m2track":
        kw["first_crop_points"] = ONLINE_FIRST_CROP
    return make_online_tracker(model, cfg, max_streams=B, max_points=ONLINE_P, **kw)


def online_track(tracker, seqs, frames, slots=None, first: int = 1, steps=None):
    """Reset `slots` (default 0..len(seqs)-1) with the tracklets' first
    frames, feed frames first, first + 1, ... (`steps` of them, default to
    the end); -> boxes (len(seqs), steps, 4)."""
    import numpy as np

    from open3dsot_tpu_torch.tracking.online import OnlineMatchTracker

    slots = list(range(len(seqs))) if slots is None else slots
    match = isinstance(tracker, OnlineMatchTracker)
    for slot, seq, f in zip(slots, seqs, frames):
        tracker.reset(slot, seq[0]["pc"] if match else f[0], seq[0]["3d_bbox"])
    steps = ONLINE_T - first if steps is None else steps
    out = [tracker.step({s: f[first + t] for s, f in zip(slots, frames)}) for t in range(steps)]
    return np.stack([[o[s] for o in out] for s in slots])


def online_step_times(tracker, feeds) -> dict:
    """Per-step wall time (median of the step() calls over `feeds`, host
    padding, H2D, replay and box fetch included) and its split, in ms."""
    import torch

    tracker.step(feeds[0])
    walls = []
    for f in feeds:
        t0 = time.perf_counter()
        tracker.step(f)
        walls.append(time.perf_counter() - t0)
    parts = {"pad": [], "h2d": [], "replay+fetch": []}
    for f in feeds[:20]:
        t0 = time.perf_counter()
        host = tracker._pack(f)
        t1 = time.perf_counter()
        tracker._upload(host)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        tracker._advance()
        tracker._state["ref"].cpu()
        t3 = time.perf_counter()
        for k, d in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[k].append(d)
    out = {k: statistics.median(v) * 1e3 for k, v in parts.items()}
    out["wall"] = statistics.median(walls) * 1e3
    return out


def same(a, b) -> str:
    import numpy as np

    return "bit-identical to" if np.array_equal(a, b) else "DIFFER from"


def online_records(name: str, rows) -> tuple:
    """Profiler records a step of the kernels of `name`'s path: K1/K2's
    (chain_tc_kernel, pool_bias_kernel), or K3/K4's (fps_kernel, bq_kernel,
    sa_tc_kernel)."""
    return chain_records(rows) if name == "m2track" else k34_records(rows)


def online_records_ok(name: str, rec: tuple) -> bool:
    if name == "m2track":
        return rec[1] == 1 and rec[0] >= 4
    return rec == ((2, 7, 7) if name == "bat" else (0, 7, 7))


def online_timed(tracker, name: str, feeds, what: str, card: str) -> dict:
    """Phase 17's timing lines of one tracker: wall and split, device time
    and idle share of one step, frames/s, profiler records; no host sync in
    the upload and the advance."""
    import torch

    B = tracker.max_streams
    t = online_step_times(tracker, feeds)
    host = tracker._pack(feeds[0])
    torch.cuda.set_sync_debug_mode("error")
    try:
        tracker._upload(host)
        tracker._advance()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for window in range(3):
        rows = device_rows(lambda: tracker.step(feeds[0]))
        rec = online_records(name, rows)
        if online_records_ok(name, rec):
            break
        print(f"  {what}: profiler window {window + 1} short of records: {rec}", flush=True)
    busy = sum(dev_us(e) for e in rows)
    wall_us = t["wall"] * 1e3
    print(f"  {what}: wall a step {t['wall']:.4f} ms (median of {len(feeds)} step() calls) = "
          f"{B / t['wall'] * 1e3:.2f} frames/s; split pad {t['pad']:.4f} / H2D {t['h2d']:.4f} / "
          f"replay+fetch {t['replay+fetch']:.4f} ms; device time a step {busy:.2f} us, idle share "
          f"{1 - busy / wall_us:.3f}; profiler records a step {rec} [{card}]", flush=True)
    if not online_records_ok(name, rec):
        fail(f"{what}: profiler records of a step {rec}")
    t["busy_us"] = busy
    return t


def host_us(fn, n: int = 200) -> float:
    """Host time of one call of fn, which enqueues work on the card without
    waiting for it: the mean over n calls back to back, in us."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def dispatch_cost(card: str, m2, bat) -> None:
    """Host time a call of K1, K3 and K4 through their wrappers, through
    their operators (as a loaded serving program calls them) and through
    their CUDA kernel functions called directly, in turns (wrapper,
    operator, direct, direct, operator, wrapper), on inputs small enough
    that each kernel takes less time than its launch: M2's mini PointNet
    chain on 64 points, FPS of 256 points to 64, BAT's first SA layer at 64
    centroids. The wrappers call the CUDA functions directly on an untraced
    CUDA tensor, so wrapper and direct should agree."""
    import torch

    from open3dsot_tpu_torch.ops import chain_fused as cf
    from open3dsot_tpu_torch.ops import sa_fused as saf
    from open3dsot_tpu_torch.ops import sampling as smp

    g = torch.Generator(device="cuda").manual_seed(SEED)
    chain = m2.net.mini_pointnet.folded_chains()
    x = torch.randn(1, 64, chain.widths[0], device="cuda", generator=g)
    xyz = torch.rand(1, 256, 3, device="cuda", generator=g)
    new = xyz[:, :64].contiguous()
    sa = bat.net.backbone.sa0
    folded = sa.folded_chains()
    kw = dict(radius=sa.radius, normalize_xyz=sa.normalize_xyz, use_xyz=sa.use_xyz)
    k1 = (x, chain.packed, chain.weights, chain.biases, chain.packed_widths, -1)
    k3 = (xyz, 64, -1, -1)
    k4 = (xyz, None, new, [t for layer in folded for t in layer], list(folded.packed),
          sa.radius, sa.normalize_xyz, sa.use_xyz, sa.nsample, -1)
    ops = torch.ops.open3dsot
    calls = {
        "K1": (lambda: cf.fused_pointnet_encoder(x, chain),
               lambda: ops.fused_pointnet_encoder.default(*k1), lambda: cf._k1_cuda(*k1)),
        "K3": (lambda: smp.furthest_point_sample(xyz, 64),
               lambda: ops.furthest_point_sample.default(*k3), lambda: smp._k3_cuda(*k3)),
        "K4": (lambda: saf.fused_sa_apply(xyz, None, new, None, folded, nsample=sa.nsample, **kw),
               lambda: ops.fused_sa_apply.default(*k4), lambda: saf._k4_cuda(*k4)),
    }
    parts = []
    for k, fns in calls.items():
        t = {fn: [] for fn in fns}
        for fn in (*fns, *fns[::-1]):
            t[fn].append(host_us(fn))
        w, o, d = (statistics.mean(t[fn]) for fn in fns)
        parts.append(f"{k} {w:.2f} / {o:.2f} / {d:.2f}")
    print(f"dispatch: host us a call through the wrapper / its operator / the CUDA kernel "
          f"function called directly: {'; '.join(parts)} [{card}]", flush=True)


def eager_rates(card: str) -> None:
    """--eager-rates: frames/s of the paths that launch the kernels eagerly,
    through the port's entry points only, so that it runs on an older tree
    as well (copy this script there and run both trees in turns in one
    call): the M2 and BAT host loops (evaluate_dataset at phases 5's and
    9's configurations, the median of three runs after a warm-up) and the
    M2 and BAT scan trackers' eager paths at B = 1, 8 and 16 (phases 15's
    and 16's configurations, the batch on the card, `wall_ms`). One line,
    `eager rates: {json}`."""
    import torch

    from open3dsot_tpu_torch.data import get_dataset
    from open3dsot_tpu_torch.tracking.eval import evaluate_dataset
    from open3dsot_tpu_torch.tracking.scan_matching import MatchScanTracker
    from open3dsot_tpu_torch.tracking.scan_tracker import M2ScanTracker

    rates = {}
    for name, cfg in (("M2", bench_cfg()), ("BAT", matching_cfg("bat"))):
        model, _ = make_model(cfg, fused_eval=True)
        sampler = get_dataset(cfg, "test", "test")
        n_frames = sum(len(sampler[i]) - 1 for i in range(len(sampler)))
        evaluate_dataset(model, sampler, cfg, max_tracklets=1)  # warm-up
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            evaluate_dataset(model, sampler, cfg)
            torch.cuda.synchronize()
            runs.append(n_frames / (time.perf_counter() - t0))
        rates[f"{name} host loop"] = statistics.median(runs)
    scans = (("M2", bench_cfg(syn_num_tracklets=16, syn_tracklet_len=SCAN_T), M2ScanTracker,
              dict(max_points=SCAN_MAX_POINTS, frame_bucket=SCAN_T), SCAN_T),
             ("BAT", match_cfg("bat"), MatchScanTracker, MATCH_KW, MATCH_T))
    for name, cfg, make, kw, T in scans:
        model, _ = make_model(cfg, fused_eval=True)
        sampler = get_dataset(cfg, "test", "test")
        seqs = [sampler[i] for i in range(len(sampler))]
        eager = make(model, cfg, cuda_graph=False, **kw)
        for B in SCAN_BATCHES:
            dev = to_card(scan_host(eager, seqs[:B]))
            t = wall_ms(lambda: eager.track_frames(*dev))
            rates[f"{name} eager scan B={B}"] = B * (T - 1) / t * 1e3
    print(f"eager rates: {json.dumps(rates)} [{card}]", flush=True)


def online_first_step_float64(g, plain, plain_model, scan, seqs, what: str) -> None:
    """Holds the online graph path's first-step boxes g[:, 0] to the plain
    path run in float64 on the same batch, as phases 15 and 16 hold the scan
    trackers' at B = 16: M2 by `compare` (the kernels' tolerance relative to
    the boxes' size), BAT/P2B at BOX_ATOL. This checks K1/K2 or K3/K4 at
    the shapes of this B against their plain versions."""
    import torch

    from open3dsot_tpu_torch.tracking.scan_matching import MatchScanTracker

    dev = to_card(scan_host(scan, seqs))
    got = torch.from_numpy(g[:, 0]).to(dev[0].device, torch.float64)
    label = f"{what} first-step boxes, online graph path against the plain path in float64"
    if not isinstance(plain, MatchScanTracker):
        compare(label, got, first_step_float64(plain, plain_model, dev))
        return
    err = (got - match_first_step_float64(plain, plain_model, dev)).abs().max().item()
    verdict = "ok" if err <= BOX_ATOL else "FAIL"
    print(f"  {label}: max_abs_err {err:.3e} (atol {BOX_ATOL}) {verdict}", flush=True)
    if not err <= BOX_ATOL:
        fail(f"{what}: first-step boxes {err} from the plain path in float64")


def online_phase(card: str) -> None:
    """Phase 17: the online trackers (tracking/online.py) and their serving
    bundles (tracking/serving_export.py) on the card; see the module
    docstring."""
    import numpy as np
    import torch

    from open3dsot_tpu_torch.data import get_dataset
    from open3dsot_tpu_torch.tracking.scan_matching import MatchScanTracker
    from open3dsot_tpu_torch.tracking.scan_tracker import M2ScanTracker
    from open3dsot_tpu_torch.tracking.serving_export import (
        load_serving_bundle,
        save_serving_bundle,
    )
    from open3dsot_tpu_torch.utils.quant import dequantize

    live16 = {}
    for name, batches in (("m2track", (8, 16, 32)), ("bat", (8, 16, 32)), ("p2b", (16,))):
        cfg = online_cfg(name)
        model, variables = make_model(cfg, fused_eval=True)
        plain_model, _ = make_model(cfg, fused_eval=False, variables=variables)
        sampler = get_dataset(cfg, "test", "test")
        seqs = [sampler[i] for i in range(32)]
        frames = [[f["pc"].points.T.astype(np.float32) for f in seq] for seq in seqs]
        scan_kw = dict(max_points=ONLINE_P, frame_bucket=ONLINE_T)
        if name == "m2track":
            scan = M2ScanTracker(model, cfg, **scan_kw)
            plain = M2ScanTracker(plain_model, cfg, cuda_graph=False, **scan_kw)
        else:
            scan_kw["first_crop_points"] = ONLINE_FIRST_CROP
            scan = MatchScanTracker(model, cfg, **scan_kw)
            plain = MatchScanTracker(plain_model, cfg, cuda_graph=False, **scan_kw)
        for B in batches:
            what = f"online {name} B={B}"
            graph = online_tracker(model, cfg, B)
            eager = online_tracker(model, cfg, B, cuda_graph=False)
            t0 = time.perf_counter()
            g = online_track(graph, seqs[:B], frames[:B])  # captures the advance here
            capture_s = time.perf_counter() - t0
            e = online_track(eager, seqs[:B], frames[:B])
            w = np.stack(scan.track_batch(seqs[:B]))
            per_replay = graph.graph_launches()["captured_per_replay"]
            print(f"  {what}: graph boxes {same(g, w)} the scan tracker's (max |diff| "
                  f"{np.abs(g - w).max():.3e}) and {same(g, e)} the eager "
                  f"advance's (max |diff| {np.abs(g - e).max():.3e}) over {ONLINE_T - 1} steps; "
                  f"first {ONLINE_T - 1} steps with the capture {capture_s:.3f} s; launches "
                  f"captured per replay (K1, K2, K3, K4) {per_replay}, {graph.replays} replays "
                  f"[{card}]", flush=True)
            if not (np.array_equal(g, w) and np.array_equal(g, e) and np.isfinite(g).all()):
                fail(f"{what}: the online graph path differs from the scan tracker or the eager "
                     f"advance, or is not finite")
            if per_replay != [ONLINE_LAUNCHES[name]]:
                fail(f"{what}: expected {ONLINE_LAUNCHES[name]} a replay, got {per_replay}")
            online_first_step_float64(g, plain, plain_model, scan, seqs[:B], what)
            feeds = [{s: frames[s][1 + i % (ONLINE_T - 1)] for s in range(B)}
                     for i in range(ONLINE_STEPS)]
            online_timed(graph, name, feeds, f"{what} graph", card)
            if B == 16:
                online_timed(eager, name, feeds, f"{what} eager", card)
                live16[name] = (model, cfg, graph, seqs[:B], frames[:B])
        if name == "p2b":
            continue

        # a stream started mid-flight against the same stream alone, at B = 16 and at B = 1
        B, late, start = 16, 15, 4
        tr = online_tracker(model, cfg, B)
        online_track(tr, seqs[:late], frames[:late], steps=start - 1)
        match = name != "m2track"
        tr.reset(late, seqs[late][0]["pc"] if match else frames[late][0], seqs[late][0]["3d_bbox"])
        got = np.stack([tr.step({**{s: frames[s][t] for s in range(late)},
                                 late: frames[late][t - start + 1]})[late]
                        for t in range(start, ONLINE_T)])
        n = len(got)
        alone = online_track(online_tracker(model, cfg, B), [seqs[late]], [frames[late]],
                             slots=[late], steps=n)[0]
        alone1 = online_track(online_tracker(model, cfg, 1), [seqs[late]], [frames[late]],
                              steps=n)[0]
        d1, d1_all = np.abs(got[0] - alone1[0]).max(), np.abs(got - alone1).max()
        print(f"  online {name}: a stream started at step {start} of 15 running, over {n} steps: "
              f"{same(got, alone)} the stream "
              f"alone at B = 16; alone at B = 1 max |diff| {d1:.3e} at its first step (atol "
              f"1e-4), {d1_all:.3e} over the {n} steps (atol {BOX_ATOL}) [{card}]", flush=True)
        if not np.array_equal(got, alone) or not d1 <= 1e-4 or not d1_all <= BOX_ATOL:
            fail(f"online {name}: a stream started mid-flight differs from the stream alone")

        # int16 against f32 fed the dequantized rows, B = 16
        tq = online_tracker(model, cfg, 16, transfer_dtype="int16")
        tf = online_tracker(model, cfg, 16)
        for tr in (tq, tf):
            online_track(tr, seqs[:16], frames[:16], steps=0)
        worst = 0.0
        for t in range(1, ONLINE_T):
            feed = {s: frames[s][t] for s in range(16)}
            scale, off, q, counts = tq._pack(feed)
            deq = dequantize(q, scale, off).numpy()
            b_q, b_f = tq.step(feed), tf.step({s: deq[s][: int(counts[s])] for s in range(16)})
            worst = max(worst, max(np.abs(b_q[s] - b_f[s]).max() for s in range(16)))
        print(f"  online {name} B=16: int16 path against the f32 path fed the dequantized rows, "
              f"max |diff| {worst:.3e} over {ONLINE_T - 1} steps [{card}]", flush=True)
        if worst != 0.0:
            fail(f"online {name}: the int16 path differs from the f32 path on the same rows")

    # serving bundles of the M2 and BAT trackers at B = 16, saved and loaded here
    with tempfile.TemporaryDirectory(prefix="_bundles-", dir=ROOT) as tmp:
        for name in ("m2track", "bat"):
            model, cfg, live, seqs, frames = live16[name]
            path = Path(tmp) / name
            t0 = time.perf_counter()
            save_serving_bundle(live, path)
            save_s = time.perf_counter() - t0
            mb = sum(f.stat().st_size for f in path.iterdir()) / 1e6
            t0 = time.perf_counter()
            served = load_serving_bundle(path)
            load_s = time.perf_counter() - t0
            want = online_track(live, seqs, frames)
            got = online_track(served, seqs, frames)
            per_replay = served.graph_launches()["captured_per_replay"]
            diff = np.abs(got - want).max()
            print(f"  bundle {name} B=16: saved in {save_s:.2f} s ({mb:.1f} MB), loaded in "
                  f"{load_s:.2f} s; {ONLINE_T - 1} steps {same(got, want)} "
                  f"the live tracker's (max |diff| {diff:.3e}); the loaded graph launched (K1, "
                  f"K2, K3, K4) {per_replay} a replay [{card}]", flush=True)
            if not np.array_equal(got, want):
                fail(f"bundle {name}: the loaded tracker's boxes differ from the live one's by "
                     f"{diff}")
            if per_replay != [ONLINE_LAUNCHES[name]]:
                fail(f"bundle {name}: the loaded graph launched {per_replay} a replay")
            torch.cuda.set_sync_debug_mode("error")
            try:
                served._advance()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            times = {"live": [], "loaded": []}
            for who in ("live", "loaded", "loaded", "live"):
                tr = live if who == "live" else served
                times[who].append(time_ms(tr._advance, iters=20, repeats=5))
            t_live, t_loaded = (statistics.mean(times[k]) for k in ("live", "loaded"))
            print(f"  bundle {name} B=16: replay {t_loaded:.4f} ms loaded against {t_live:.4f} ms "
                  f"live by events (runs live, loaded, loaded, live: {times}); ratio "
                  f"{t_loaded / t_live:.3f} [{card}]", flush=True)
            if abs(t_loaded / t_live - 1) > 0.10:
                fail(f"bundle {name}: the loaded graph's replay is {t_loaded / t_live:.3f}x the "
                     f"live graph's")
            feeds = [{s: frames[s][1 + i % (ONLINE_T - 1)] for s in range(16)}
                     for i in range(ONLINE_STEPS)]
            online_timed(served, name, feeds, f"bundle {name} B=16 loaded graph", card)
    dispatch_cost(card, live16["m2track"][0], live16["bat"][0])
    print("phase 17 ok: online graph == scan tracker == eager advance bit for bit, launches a "
          "replay M2 K1 3 / K2 1, BAT K3 2 / K4 7, P2B K4 7, bundles == live", flush=True)


def profile_window(model, sampler, cfg, card: str, wall_us_per_frame: float,
                   k3_count=None) -> None:
    """Device time by kernel over one tracklet of the host loop, and the
    device's idle share against the unprofiled run's time per frame; with
    k3_count (the wrapper's launch count), K3's launches over the window
    beside the profiler's records of them."""
    from open3dsot_tpu_torch.tracking.eval import evaluate_dataset

    frames = len(sampler[0]) - 1
    run = lambda: evaluate_dataset(model, sampler, cfg, max_tracklets=1)  # noqa: E731
    before = k3_count() if k3_count else 0
    rows = device_rows(run)
    if k3_count:
        import torch
        from torch.profiler import ProfilerActivity, profile

        launched = k3_count() - before
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        bare = sum(e.count for e in prof.key_averages() if "fps_kernel" in e.key)
        print(f"profile: K3 over the window: {launched} launches by the wrapper's count, "
              f"{sum(e.count for e in rows if 'fps_kernel' in e.key)} profiler records "
              f"({bare} in a window without the opening sleep kernel)")
    total = sum(dev_us(e) for e in rows)
    if total <= 0:
        print("profile: no device time recorded (not measured)")
        return
    busy = total / frames
    print(f"profile ({frames} frames): device busy {busy:.1f} us per frame; unprofiled wall "
          f"{wall_us_per_frame:.1f} us per frame; idle share {1 - busy / wall_us_per_frame:.3f} "
          f"[{card}]")
    for e in sorted(rows, key=lambda e: -dev_us(e))[:8]:
        print(f"  {dev_us(e):10.0f} us {e.count:5d}x  {e.key[:90]}")


def host_breakdown(model, sampler, card: str) -> None:
    """Wall time per frame of the host loop's steps, over one tracklet:
    input building (numpy), the forward up to its box on the host, and
    box conversion + scoring."""
    import torch

    from open3dsot_tpu_torch.geometry.iou import estimateAccuracy, estimateOverlap

    cfg = model.config
    seq = sampler[0]
    parts = {"build_input_dict": 0.0, "forward+fetch": 0.0, "extract+score": 0.0}
    boxes = [seq[0]["3d_bbox"]]
    torch.cuda.synchronize()
    for f in range(1, len(seq)):
        t0 = time.perf_counter()
        data, ref = model.build_input_dict(seq, f, boxes)
        t1 = time.perf_counter()
        out = model.apply(data)
        box = out["estimation_boxes"][0].cpu()
        t2 = time.perf_counter()
        boxes.append(model.extract_output_box({"estimation_boxes": box[None]}, ref))
        estimateOverlap(seq[f]["3d_bbox"], boxes[-1], dim=cfg.IoU_space, up_axis=cfg.up_axis)
        estimateAccuracy(seq[f]["3d_bbox"], boxes[-1], dim=cfg.IoU_space, up_axis=cfg.up_axis)
        t3 = time.perf_counter()
        for k, d in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[k] += d
    n = len(seq) - 1
    print("host loop per frame: " + ", ".join(f"{k} {v * 1e6 / n:.1f} us" for k, v in parts.items())
          + f" [{card}]")


# --- phase 18: the bf16 compute mode of eval ------------------------------------

# Dense bf16 on the tensor cores (NVIDIA's H100 SXM data sheet, at 700 W):
# the bound of the bf16 mode's kernels, one product a multiply-add.
PEAK_BF16_FLOPS = 989e12
# A bf16 kernel against its plain version (both round the same operands to
# bf16 and sum in f32, in another order): the sums differ by ~1e-7, which
# now and then moves an activation across a bf16 rounding boundary, one step
# of 2^-8 of it, and that step spreads through the layers after it. Held:
# max |k - p| <= 2^-6 max|p| and mean |k - p| <= 2^-14 max|p| (the bf16
# kernels measured at most 1.1e-5 of max|p| on average); a wrong index, tile
# or weight chunk gives errors of order max|p|. The control: the f32 plain
# version on the same inputs must fall outside these limits, or they could
# not tell a kernel that quietly computed in f32. K2's seg argmax agrees on
# > 99% of points (a point whose two logits lie within a step of each other
# may flip).
BF16_MAX_REL = 2.0 ** -6
BF16_MEAN_REL = 2.0 ** -14
BF16_ARGMAX_AGREE = 0.99
# A whole bf16 forward, kernel path against plain path: the two round at
# other places (the kernels fold BatchNorm in f32 and round only the
# products' operands; the plain layers round the Dense output, the bias sum
# and the BatchNorm output, as flax does), so they are held to the f32 plain
# path instead: the kernel path's mean_rel distance from it (mean |x - f32| /
# max(|f32|, 1), tests/test_sa_fused.py's form) between 0.5x and 1.5x the
# plain bf16 path's + 1e-4. The lower limit is the control: a kernel path
# that quietly computed in f32 would sit near 0.
BF16_B = 8  # the scan trackers' batch in phase 18
# cycles of the sleep queued ahead of phase 18's timed calls (about 20 ms at
# the H100's clocks): longer than the host takes to enqueue them, so that
# `queued_ms` reads device time only, even where the host is the slower side
BF16_SLEEP = 40_000_000


def compare_bf16(name: str, got, want, f32, control: bool = True) -> float:
    """A bf16 kernel's output `got` against its plain bf16 version's `want`,
    within BF16_MAX_REL / BF16_MEAN_REL of max|want|; the f32 plain
    version's `f32` on the same inputs must lie outside them (printed only,
    with control=False: a batch statistic averages the roundings away)."""
    import torch

    got, want, f32 = got.float(), want.float(), f32.float()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite values")
    scale = max(want.abs().max().item(), 1e-30)

    def errs(x):
        err = (x - want).abs()
        return err.max().item(), err.mean().item()

    def within(max_abs, mean_abs):
        return max_abs <= BF16_MAX_REL * scale and mean_abs <= BF16_MEAN_REL * scale

    (max_abs, mean_abs), (f32_max, f32_mean) = errs(got), errs(f32)
    ok, outside = within(max_abs, mean_abs), not within(f32_max, f32_mean)
    print(f"  {name}: max_abs_err {max_abs:.3e} ({max_abs / scale:.2e} of max|ref| {scale:.3e}), "
          f"mean {mean_abs / scale:.2e} of it {'ok' if ok else 'FAIL'}; f32 control max "
          f"{f32_max / scale:.2e} mean {f32_mean / scale:.2e} of it "
          f"{('outside: ok' if outside else 'inside: FAIL') if control else '(not held)'}",
          flush=True)
    if not ok:
        fail(f"{name}: outside the bf16 tolerance (max {BF16_MAX_REL:.2e}, mean {BF16_MEAN_REL:.2e} "
             f"of max|ref|)")
    if control and not outside:
        fail(f"{name}: the f32 plain version is inside the bf16 tolerance, which then cannot "
             "tell bf16 from f32")
    return max_abs


def bf16_bound(work):
    """(least ms, "bytes" or "operations") of a bf16 kernel's work."""
    return bound_of(*work, PEAK_BF16_FLOPS)


def bf16_chain_work(chain, B: int, N: int, out_elems: int, tap_elems: int = 0, pooled_in: int = 0,
                    c_in=None):
    """(bytes, operations) of a chain in the bf16 mode: f32 inputs and outputs,
    bf16 weights with f32 biases; K2's W_pool GEMV once per batch element."""
    c_in = chain.widths[0] if c_in is None else c_in
    weights = sum(2 * w.numel() + 4 * b.numel() for w, b in chain.layers)
    nbytes = 4 * (B * N * c_in + pooled_in + out_elems + tap_elems) + weights
    flops = 2 * B * N * sum(w.shape[0] * w.shape[1] for w in chain.weights)
    if chain.split:  # the pooled rows enter once per batch element, not per point
        c_pool = chain.widths[0] - chain.split
        flops -= 2 * B * (N - 1) * c_pool * chain.weights[0].shape[1]
    return nbytes, flops


def cublas_bf16_chain(chain, seg_head: bool):
    """The plain stack through cuBLAS in bf16 (bf16 in, bf16 out): the
    yardstick of the bf16 chains, timed only here."""
    import torch

    layers = [(w.to(torch.bfloat16), b.to(torch.bfloat16)) for w, b in chain.layers]

    def encoder(x, tap_at):
        h, tap = x.to(torch.bfloat16), None
        for i, (w, b) in enumerate(layers):
            h = torch.relu(h @ w + b)
            tap = h if i == tap_at else tap
        return tap, h.amax(dim=1)

    def head(tap, pooled):
        B, N, _ = tap.shape
        h = torch.cat([tap.to(torch.bfloat16),
                       pooled.to(torch.bfloat16)[:, None, :].expand(B, N, pooled.shape[1])], -1)
        for w, b in layers[:-1]:
            h = torch.relu(h @ w + b)
        return h @ layers[-1][0] + layers[-1][1]

    return head if seg_head else encoder


def time_bf16(kernel, plain, library, work, card: str, what: str) -> dict:
    """Event times of a bf16 kernel call, its plain version and the library
    yardstick (plain, kernel, plain), their device times, and the bf16 bound.
    Device time here is by events behind a queued sleep (`queued_ms`): the
    profiler's records of these short kernels came back short in a run
    (K2 at B = 16 "in" a tenth of its event time)."""
    t_p = time_ms(plain)
    t_k = time_ms(kernel)
    t_p2 = time_ms(plain)
    d_k, d_p = queued_ms(kernel, sleep=BF16_SLEEP), queued_ms(plain, sleep=BF16_SLEEP)
    t_lib = None if library is None else time_ms(library)
    bound, by = bf16_bound(work)
    d_k = d_k if d_k > 0 else None
    share = "not measured" if d_k is None else f"{bound / d_k:.1%}"
    lib = "" if t_lib is None else f"; cuBLAS bf16 stack ev {t_lib:.4f} ms"
    print(f"  time bf16 {what}: kernel ev {t_k:.4f} ms dev {fmt_ms(d_k)}; plain ev "
          f"{min(t_p, t_p2):.4f} ms dev {fmt_ms(d_p)}{lib}; bound {bound:.5f} ms by {by} at "
          f"989 TFLOP/s bf16 (kernel dev at {share} of it) [{card}]", flush=True)
    return dict(ms=t_k, plain_ms=min(t_p, t_p2), dev_ms=d_k, plain_dev_ms=d_p, library_ms=t_lib,
                work=work, peak=PEAK_BF16_FLOPS)


def check_chains_bf16(model, card: str) -> dict:
    """K1 at M2's three calls and K2, bf16 mode, against their plain versions
    at B = 1 and 16, N = 2048; times beside the bound."""
    import torch

    from open3dsot_tpu_torch.ops import chain_fused as cf

    net = model.net
    chain1, chain2 = net.seg_pointnet.folded_chains()
    if chain1.dtype is not torch.bfloat16:
        fail("the bf16 model's chains are not packed for the bf16 mode")
    k1_cases = [("K1 seg mlp1 tap", chain1, 1), ("K1 mini", net.mini_pointnet.folded_chains(), None),
                ("K1 mini2", net.mini_pointnet2.folded_chains(), None)]
    dev = chain1.packed.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    f32 = {id(c): cf.FoldedChain(c.layers, split=c.split)  # the f32 controls
           for c in (chain1, chain2, *(case[1] for case in k1_cases))}
    errs, rows = {"K1": 0.0, "K2": 0.0}, {}
    n = 2 * N_POINTS
    for B in (1, 16):
        for name, chain, tap_at in k1_cases:
            x = torch.randn(B, n, chain.widths[0], device=dev, generator=gen)
            k_tap, k_pool = cf.fused_pointnet_encoder(x, chain, tap_at=tap_at)
            p_tap, p_pool = cf.pointnet_encoder_plain(x, chain, tap_at)
            f_tap, f_pool = cf.pointnet_encoder_plain(x, f32[id(chain)], tap_at)
            torch.cuda.synchronize()
            errs["K1"] = max(errs["K1"], compare_bf16(f"bf16 {name} B={B} pooled", k_pool, p_pool,
                                                      f_pool))
            tap_elems = 0
            if tap_at is not None:
                errs["K1"] = max(errs["K1"], compare_bf16(f"bf16 {name} B={B} tap", k_tap, p_tap,
                                                          f_tap))
                tap, pooled, tap_elems = p_tap, p_pool, p_tap.numel()
            lib = cublas_bf16_chain(chain, False)
            rows[(name, B)] = time_bf16(
                lambda: cf.fused_pointnet_encoder(x, chain, tap_at=tap_at),
                lambda: cf.pointnet_encoder_plain(x, chain, tap_at), lambda: lib(x, tap_at),
                bf16_chain_work(chain, B, n, B * chain.widths[-1], tap_elems), card,
                f"{name} B={B} N={n}")
            rows[(name, B)]["f32_ms"] = time_ms(
                lambda: cf.fused_pointnet_encoder(x, f32[id(chain)], tap_at=tap_at))
        k_out = cf.fused_seg_head(tap, pooled, chain2)
        p_out = cf.seg_head_plain(tap, pooled, chain2)
        f_out = cf.seg_head_plain(tap, pooled, f32[id(chain2)])
        torch.cuda.synchronize()
        errs["K2"] = max(errs["K2"], compare_bf16(f"bf16 K2 seg head B={B}", k_out, p_out, f_out))
        agree = (k_out[..., :2].argmax(-1) == p_out[..., :2].argmax(-1)).float().mean().item()
        print(f"  bf16 K2 seg head B={B}: seg argmax agrees on {agree:.5f} of points "
              f"(> {BF16_ARGMAX_AGREE})", flush=True)
        if agree <= BF16_ARGMAX_AGREE:
            fail(f"bf16 K2 B={B}: the seg argmax agrees on {agree} of points only")
        lib = cublas_bf16_chain(chain2, True)
        rows[("K2 seg head", B)] = time_bf16(
            lambda: cf.fused_seg_head(tap, pooled, chain2),
            lambda: cf.seg_head_plain(tap, pooled, chain2), lambda: lib(tap, pooled),
            bf16_chain_work(chain2, B, n, p_out.numel(), pooled_in=pooled.numel(),
                            c_in=chain2.split), card, f"K2 seg head B={B} N={n}")
        rows[("K2 seg head", B)]["f32_ms"] = time_ms(
            lambda: cf.fused_seg_head(tap, pooled, f32[id(chain2)]))
    for B in (1, 16):
        calls = [r for (name, b), r in rows.items() if b == B]
        ev = sum(r["ms"] for r in calls)
        dev = None if any(r["dev_ms"] is None for r in calls) else sum(r["dev_ms"] for r in calls)
        bound = sum(bf16_bound(r["work"])[0] for r in calls)
        share = "not measured" if dev is None else f"{bound / dev:.1%}"
        print(f"  bf16: one M2 forward's four K1/K2 calls, B={B}: kernel ev {ev:.4f} ms dev "
              f"{fmt_ms(dev)}; plain ev {sum(r['plain_ms'] for r in calls):.4f} ms; cuBLAS bf16 "
              f"stack ev {sum(r['library_ms'] for r in calls):.4f} ms; bound {bound:.5f} ms "
              f"(device time at {share}); the 3xTF32 kernels on the same inputs ev "
              f"{sum(r['f32_ms'] for r in calls):.4f} ms [{card}]", flush=True)
    print("phase 18a ok: K1/K2 bf16 within tolerance of their plain versions", flush=True)
    return {"errs": errs, "rows": rows}


def bf16_sa_work(xyz, feats, new, folded, K: int, walked: int):
    """(bytes, operations) of one bf16 K4 call: as sa_work, with the weights
    of layers 2-3 and the output in bf16 and the features as they come."""
    B, N, S = xyz.shape[0], xyz.shape[1], new.shape[1]
    fbytes = 0 if feats is None else feats.numel() * feats.element_size()
    (w1, b1), (w2, b2), (w3, b3) = folded
    c1, c2, c3 = w1.shape[1], w2.shape[1], w3.shape[1]
    weights = 4 * (w1.numel() + b1.numel() + b2.numel() + b3.numel()) + 2 * (w2.numel() + w3.numel())
    nbytes = 4 * B * (N * 3 + S * 3) + fbytes + 2 * B * S * c3 + weights
    flops = 2 * B * N * w1.shape[0] * c1 + 2 * B * S * K * (c1 * c2 + c2 * c3)
    return nbytes, flops + 8 * walked


def check_sa_bf16(calls, card: str) -> tuple:
    """K4 (ball query) and K5 (idx given) in the bf16 mode against the plain
    bf16 version at the seven SA calls of a bf16 BAT forward, B = 1 and 16;
    times by call and over the seven calls, beside the bf16 bound."""
    import torch

    from open3dsot_tpu_torch.ops import sa_fused as saf
    from open3dsot_tpu_torch.ops.neighbors import ball_query

    errs = {"K4": 0.0, "K5": 0.0}
    sums = {B: dict(k4=0.0, k5=0.0, plain=0.0, lib=0.0, f32=0.0, k4_dev=None, w4=[0, 0], w5=[0, 0])
            for B in (1, 16)}
    forward, forward32 = {1: [], 16: []}, {1: [], 16: []}
    for label, mod, xyz16, feats16, new16 in calls:
        kw = dict(radius=mod.radius, normalize_xyz=mod.normalize_xyz, use_xyz=mod.use_xyz)
        K, folded = mod.nsample, mod.folded_chains()
        if folded.dtype is not torch.bfloat16:
            fail(f"bf16 {label}: the SA layer is not packed for the bf16 mode")
        folded32 = saf.FoldedSA(list(folded))  # the same folded layers, packed for 3xTF32
        for B in (1, 16):
            xyz, new = xyz16[:B].contiguous(), new16[:B].contiguous()
            feats = None if feats16 is None else feats16[:B].contiguous()
            shape = (f"{label} B={B} S={new.shape[1]} K={K} N={xyz.shape[1]} "
                     f"C={0 if feats is None else feats.shape[2]} "
                     f"({'none' if feats is None else str(feats.dtype)[6:]})->{folded[-1][0].shape[1]}")

            def k4(xyz=xyz, feats=feats, new=new, folded=folded, K=K, kw=kw):
                return saf.fused_sa_apply(xyz, feats, new, None, folded, nsample=K, **kw)

            def plain(xyz=xyz, feats=feats, new=new, folded=folded, K=K, kw=kw):
                return saf.sa_eval_plain(xyz, feats, new, None, folded, nsample=K,
                                         dtype=torch.bfloat16, **kw)

            idx = ball_query(mod.radius, K, xyz, new)
            k5 = lambda: saf.fused_sa_apply(xyz, feats, new, idx, folded, **kw)  # noqa: E731
            got4, want, got5 = k4(), plain(), k5()
            control = saf.sa_eval_plain(xyz, feats, new, idx, folded, **kw)  # f32
            torch.cuda.synchronize()
            if got4.dtype != torch.bfloat16 or got5.dtype != torch.bfloat16:
                fail(f"bf16 {shape}: K4/K5 gave {got4.dtype} / {got5.dtype}, expected bfloat16")
            errs["K4"] = max(errs["K4"], compare_bf16(f"bf16 K4 {shape}", got4, want, control))
            errs["K5"] = max(errs["K5"], compare_bf16(f"bf16 K5 {shape}", got5, want, control))
            nbytes, flops = bf16_sa_work(xyz, feats, new, folded, K, 0)
            w4 = (nbytes, flops + 8 * bq_walked(xyz, new, mod.radius, K))
            w5 = (nbytes + 4 * B * new.shape[1] * K, flops)
            lib = cublas_bf16_sa(xyz, feats, new, idx, folded, **kw)
            feats32 = None if feats is None else feats.float()

            def k4_32(xyz=xyz, feats=feats32, new=new, folded=folded32, K=K, kw=kw):
                return saf.fused_sa_apply(xyz, feats, new, None, folded, nsample=K, **kw)

            # the two modes timed alike: twice each, alternating, the least kept
            t32 = time_ms(k4_32)
            r4 = time_bf16(k4, plain, lib, w4, card, f"K4 {shape}")
            t5 = time_ms(k5)
            t32 = min(t32, time_ms(k4_32))
            t16 = min(r4["ms"], time_ms(k4))
            s = sums[B]
            s["k4"] += t16
            s["k5"] += t5
            s["plain"] += r4["plain_ms"]
            s["lib"] += r4["library_ms"]
            s["f32"] += t32
            for i in range(2):
                s["w4"][i] += w4[i]
                s["w5"][i] += w5[i]
            forward[B].append(k4)
            forward32[B].append(k4_32)
    for B in (1, 16):
        s = sums[B]
        run, run32 = (lambda: [f() for f in forward[B]]), (lambda: [f() for f in forward32[B]])
        t32 = queued_ms(run32, iters=10, sleep=BF16_SLEEP)
        total = queued_ms(run, iters=10, sleep=BF16_SLEEP)
        t32 = min(t32, queued_ms(run32, iters=10, sleep=BF16_SLEEP))
        total = min(total, queued_ms(run, iters=10, sleep=BF16_SLEEP))
        bound, by = bf16_bound(s["w4"])
        share = f"{bound / total:.1%}" if total > 0 else "not measured"
        s["k4_dev"] = total if total > 0 else None
        print(f"  bf16: one BAT forward's 7 SA calls, B={B}: K4 ev {s['k4']:.4f} ms (summed, the "
              f"least of two a call, as the 3xTF32 K4's), back to back device {fmt_ms(s['k4_dev'])} "
              f"(the least of two windows, as the 3xTF32 K4's); K5 ev {s['k5']:.4f} ms; "
              f"plain ev {s['plain']:.4f} ms; cuBLAS bf16 yardstick ev {s['lib']:.4f} ms (summed); "
              f"bound {bound:.5f} ms by {by} (device time at {share}); the 3xTF32 K4 on the same "
              f"inputs ev {s['f32']:.4f} ms (summed), back to back device {t32:.4f} ms [{card}]",
              flush=True)
    print("phase 18b ok: K4/K5 bf16 within tolerance at every SA call of the BAT path", flush=True)
    return errs, sums


# --- phase 18: the bf16 kernels' cut cases, yardstick and breakdown --------------

# Phase 18's cut cases (random weights): widths the shipped configs never give
# the bf16 kernels, at B = 16 unless `Bs` says more. SA: C1/C2/C3 24/36/68
# (multiples of 4 but not of 8, each inside one 64-wide k-block or chunk) at K
# = 20 (three centroids a tile, four empty rows) on S = 101 centroids (a
# ragged last tile), 21 input features. Then the widths where the tiles stop
# fitting in shared memory beside a ring of panels, one case for each plan
# after the first of sa_fused_bf16.cu::choose_plan (the breakdown's
# sa_bf16_plan prints which each takes): 640/640/640 at K = 64 (one
# warpgroup) and at K = 16 (a ring of two panels), 704/704/704 at K = 20 and
# 768/768/768 at K = 64 (h1 streamed), and 8/1376/68, the widest h2 the
# earlier design took (streamed). K1: a chain 13-24-40-1028 with its tap at
# 24 over N = 2000 points (a ragged last tile; 1028 ends inside a 64-channel
# chunk); a 2048-input layer mid-chain (too wide for shared memory: streamed,
# then stored for the next stage); a pooled output of 60000 channels (its
# biases do not fit: streamed). K2: M2's seg head widths at a tap of 72 (72 +
# 1028 -> 512 -> 256 -> 128 -> 128 -> 11); a tap of 1600 (layer 0 streamed,
# its g read from device memory) into a 2048-input last layer (streamed
# logits).
BF16_CUT_SA = (dict(c_in=21, widths=(24, 36, 68), K=20, S=101, N=512, radius=0.3, Bs=(16,)),
               dict(c_in=61, widths=(640, 640, 640), K=64, S=64, N=1024, radius=0.3, Bs=(1, 16)),
               dict(c_in=61, widths=(640, 640, 640), K=16, S=128, N=1024, radius=0.3, Bs=(16,)),
               dict(c_in=61, widths=(704, 704, 704), K=20, S=101, N=1024, radius=0.3, Bs=(16,)),
               dict(c_in=61, widths=(768, 768, 768), K=64, S=64, N=1024, radius=0.3, Bs=(1, 16)),
               dict(c_in=5, widths=(8, 1376, 68), K=64, S=64, N=1024, radius=0.3, Bs=(16,)))
BF16_CUT_K1 = (dict(widths=(13, 24, 40, 1028), tap_at=0, N=2000, Bs=(16,)),
               dict(widths=(13, 64, 2048, 256, 128), tap_at=0, N=2000, Bs=(1, 16)),
               dict(widths=(13, 64, 60000), tap_at=0, N=256, Bs=(16,)))
BF16_CUT_K2 = (dict(tap=72, widths=(72 + 1028, 512, 256, 128, 128, 11), N=2000, Bs=(16,)),
               dict(tap=1600, widths=(1600 + 64, 128, 2048, 11), N=500, Bs=(1, 16)))


def random_layers(widths, gen, dev):
    """Dense layers (W (in, out), b) of these widths, He-scaled, on dev."""
    import torch

    return [(torch.randn(k, c, generator=gen, device=dev) * (2.0 / k) ** 0.5,
             0.1 * torch.randn(c, generator=gen, device=dev))
            for k, c in zip(widths[:-1], widths[1:])]


def bf16_cut_cases(card: str) -> dict:
    """The new bf16 kernels at the cut cases' widths (BF16_CUT_*) against
    their plain bf16 versions, the f32 control outside."""
    import torch

    from open3dsot_tpu_torch.ops import chain_fused as cf
    from open3dsot_tpu_torch.ops import sa_fused as saf
    from open3dsot_tpu_torch.ops.neighbors import ball_query

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 180)
    errs = {"K1": 0.0, "K2": 0.0, "K4": 0.0, "K5": 0.0}
    for c in BF16_CUT_SA:
        layers = random_layers((3 + c["c_in"],) + c["widths"], gen, dev)
        folded, f32 = saf.FoldedSA(layers, dtype=torch.bfloat16), saf.FoldedSA(layers)
        for B in c["Bs"]:
            xyz = torch.rand(B, c["N"], 3, generator=gen, device=dev)
            feats = torch.relu(torch.randn(B, c["N"], c["c_in"], generator=gen,
                                           device=dev)).to(torch.bfloat16)
            new = xyz[:, :c["S"]].contiguous()
            kw = dict(radius=c["radius"], normalize_xyz=False, use_xyz=True)
            idx = ball_query(c["radius"], c["K"], xyz, new)
            what = f"cut SA C1/C2/C3 {'/'.join(map(str, c['widths']))} K={c['K']} S={c['S']} B={B}"
            want = saf.sa_eval_plain(xyz, feats, new, None, folded, nsample=c["K"],
                                     dtype=torch.bfloat16, **kw)
            control = saf.sa_eval_plain(xyz, feats, new, idx, f32, **kw)
            got4 = saf.fused_sa_apply(xyz, feats, new, None, folded, nsample=c["K"], **kw)
            got5 = saf.fused_sa_apply(xyz, feats, new, idx, folded, **kw)
            torch.cuda.synchronize()
            errs["K4"] = max(errs["K4"], compare_bf16(f"bf16 K4 {what}", got4, want, control))
            errs["K5"] = max(errs["K5"], compare_bf16(f"bf16 K5 {what}", got5, want, control))
            del want, control, got4, got5

    for c in BF16_CUT_K1:
        layers = random_layers(c["widths"], gen, dev)
        chain, chain32 = cf.FoldedChain(layers, dtype=torch.bfloat16), cf.FoldedChain(layers)
        for B in c["Bs"]:
            x = torch.randn(B, c["N"], c["widths"][0], generator=gen, device=dev)
            k_tap, k_pool = cf.fused_pointnet_encoder(x, chain, tap_at=c["tap_at"])
            p_tap, p_pool = cf.pointnet_encoder_plain(x, chain, c["tap_at"])
            f_tap, f_pool = cf.pointnet_encoder_plain(x, chain32, c["tap_at"])
            torch.cuda.synchronize()
            what = f"cut K1 {'-'.join(map(str, c['widths']))} N={c['N']} B={B}"
            errs["K1"] = max(errs["K1"], compare_bf16(f"bf16 {what} pooled", k_pool, p_pool, f_pool),
                             compare_bf16(f"bf16 {what} tap", k_tap, p_tap, f_tap))

    for c in BF16_CUT_K2:
        layers = random_layers(c["widths"], gen, dev)
        chain = cf.FoldedChain(layers, split=c["tap"], dtype=torch.bfloat16)
        chain32 = cf.FoldedChain(layers, split=c["tap"])
        for B in c["Bs"]:
            tap = torch.relu(torch.randn(B, c["N"], c["tap"], generator=gen, device=dev))
            pooled = torch.relu(torch.randn(B, c["widths"][0] - c["tap"], generator=gen, device=dev))
            k_out = cf.fused_seg_head(tap, pooled, chain)
            p_out = cf.seg_head_plain(tap, pooled, chain)
            f_out = cf.seg_head_plain(tap, pooled, chain32)
            torch.cuda.synchronize()
            errs["K2"] = max(errs["K2"], compare_bf16(
                f"bf16 cut K2 tap {c['tap']} widths {'-'.join(map(str, c['widths']))} N={c['N']} "
                f"B={B}", k_out, p_out, f_out))
    print(f"phase 18e ok: the bf16 kernels at the cut cases [{card}]", flush=True)
    return errs


def cublas_bf16_sa(xyz, feats, new, idx, folded, radius: float, normalize_xyz: bool,
                   use_xyz: bool):
    """K4 bf16's yardstick, timed only here: the A-form rows in bf16 gathered
    at idx (the ball query's indices, given) + ct, then the two products as
    cuBLAS bf16 GEMMs (bf16 in, bf16 out) and the max over K."""
    import torch

    from open3dsot_tpu_torch.ops import sa_fused as saf

    (w1, b1), (w2, b2), (w3, b3) = folded
    bf = torch.bfloat16
    w2b, b2b, w3b, b3b = w2.to(bf), b2.to(bf), w3.to(bf), b3.to(bf)
    f = None if feats is None else feats.float()
    B, S, K = idx.shape
    rows = (torch.arange(B, device=idx.device)[:, None] * xyz.shape[1] + idx.reshape(B, -1)).reshape(-1)

    def run():
        a, ct = saf.a_form(xyz, f, new, w1, b1, inv_r=1.0 / radius if normalize_xyz else 1.0,
                           use_xyz=use_xyz)
        h = a.to(bf).reshape(-1, a.shape[2]).index_select(0, rows).reshape(B, S, K, -1)
        h = torch.relu(h + ct.to(bf)[:, :, None, :])
        h = torch.relu(h @ w2b + b2b)
        return torch.relu(h @ w3b + b3b).amax(dim=2)

    return run


BF16_PHASE_NAMES = {
    "sa_fused_bf16": ("indices and ct", "gather to h1", "layer-2 products", "layer-2 epilogue",
                      "layer-3 products", "layer-3 staging", "max over K", "waits on full"),
    "chain_fused_bf16": ("input tile", "products", "epilogue (next layer, tap, store)",
                         "epilogue (pool, logits)", "waits on full"),
}
BF16_PHASE_ENTRY = {"sa_fused_bf16": "sa_bf16_phases", "chain_fused_bf16": "chain_bf16_phases"}


def phase_build(name: str):
    """csrc/<name>.cu built with -DBF16_PHASES (the clock64() counters of each
    phase of a tile, bf16_layers.cuh) into _build/phases/, loaded with <name>'s
    signatures; None where the source has no counters (an older tree). Only
    this script loads such a build."""
    from open3dsot_tpu_torch.ops import _build

    src = _build.CSRC / f"{name}.cu"
    if not src.is_file() or "BF16_PHASES" not in src.read_text():
        return None
    out = _build.BUILD_DIR / "phases" / f"lib{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DBF16_PHASES", "-o", str(out),
                           str(src)], capture_output=True, text=True, timeout=900)
    if proc.returncode:
        fail(f"the phase build of {src} failed:\n{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    return _build.KernelLibrary(name, out, 0.0, proc.stdout + proc.stderr)


@contextlib.contextmanager
def library_swapped(lib):
    """The wrappers load `lib` in place of the library of its name."""
    from open3dsot_tpu_torch.ops import _build

    real = _build.load_library
    _build.load_library = lambda name: lib if name == lib.name else real(name)
    try:
        yield
    finally:
        _build.load_library = real


def phase_cycles(lib, fn, n: int = 10) -> list:
    """Cycles by phase (summed over the consumer warpgroups' tiles) of n calls
    of fn through the phase build `lib`."""
    import ctypes

    import torch

    read = getattr(lib.lib, BF16_PHASE_ENTRY[lib.name])
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    buf = (ctypes.c_ulonglong * 8)()
    with library_swapped(lib):
        fn()
        torch.cuda.synchronize()
        if read(ctypes.cast(buf, ctypes.c_void_p)):
            fail(f"{lib.name}: reading the phase counters failed")
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    if read(ctypes.cast(buf, ctypes.c_void_p)):
        fail(f"{lib.name}: reading the phase counters failed")
    return [v / n for v in buf]


def print_breakdown(what: str, fn, card: str, phase_lib=None) -> None:
    """One call's device time by kernel (profiler, a window opened on a sleep
    kernel) and, with a phase build, its cycles by phase."""
    rows = sorted(device_rows(lambda: [fn() for _ in range(5)]), key=dev_us, reverse=True)
    total = sum(dev_us(e) for e in rows) / 5
    parts = "; ".join(f"{e.key[:48]} {dev_us(e) / 5:.2f} us x{e.count // 5}" for e in rows)
    print(f"  breakdown {what}: device {total:.2f} us a call: {parts} [{card}]", flush=True)
    if phase_lib is not None:
        cyc = phase_cycles(phase_lib, fn)
        names = BF16_PHASE_NAMES[phase_lib.name]
        spent = sum(cyc[:len(names) - 1])  # the last counter ("waits on full") is within the others
        shares = ", ".join(f"{n} {v / max(spent, 1):.1%}" for n, v in zip(names, cyc))
        print(f"    phases {what}: {spent / 1e6:.3f} Mcycles of warpgroup time a call: {shares}",
              flush=True)


def earlier_sa_bf16_fits(K: int, C1: int, C2: int) -> bool:
    """Whether the earlier K4/K5 bf16 design (sa_tc_kernel<F, true>,
    csrc/sa_fused.cu::make_plan at 9d57012) planned this shape: its shared
    memory in floats, a ring of two 8 KB chunks at least; C3 took none."""
    if C1 % 8 or C2 % 4:
        return False
    ts, nk2, nk3 = 64 // K, -(-((C1 + 7) // 8 * 8) // 32), -(-((C2 + 7) // 8 * 8) // 32)
    s1, s2 = nk2 * 32 + 8, nk3 * 32 + 8
    o_w = (max(32 * s1, 64 * 136) + 32 * s2 + ts * nk2 * 32 + 64 + ts + 31) & ~31
    return (o_w + 2 * 2048 + 2 * 4) * 4 <= 232448


def bf16_plans(sa_lib, chain_lib, card: str) -> None:
    """The plans of the phase build's sa_bf16_plan / chain_bf16_plan: each
    cut case's (BF16_CUT_*), then every shape the earlier bf16 K4 design
    planned, swept (K 1-64; C1 the least multiple of 8 of each 64-wide
    k-block up to 1664; C2 each multiple of 64 up to that design's widest and
    the widest itself; C3 64 and 68, the two chunk widths; the plan does not
    depend on B or S, nor within a k-block on the widths), must plan here."""
    import ctypes

    sa = sa_lib.lib.sa_bf16_plan
    sa.argtypes, sa.restype = [ctypes.c_int] * 6 + [ctypes.c_void_p], ctypes.c_int
    ch = chain_lib.lib.chain_bf16_plan
    ch.argtypes, ch.restype = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p], ctypes.c_int
    out = (ctypes.c_int * 40)()
    ptr = ctypes.cast(out, ctypes.c_void_p)
    for c in BF16_CUT_SA:
        for B in c["Bs"]:
            rc = sa(B, c["S"], c["K"], *c["widths"], ptr)
            print(f"  plan bf16 K4 {'/'.join(map(str, c['widths']))} K={c['K']} S={c['S']} B={B}: "
                  f"rc {rc}, {out[0]} consumer warpgroup(s), h1 {'streamed' if out[1] else 'whole'}, "
                  f"{out[2]} stages{' resident' if out[3] else ''}, {out[4]} B of shared memory",
                  flush=True)
    for name, cases in (("K1", BF16_CUT_K1), ("K2", BF16_CUT_K2)):
        for c in cases:
            widths = (c["tap"],) + c["widths"][1:] if name == "K2" else c["widths"]
            w = (ctypes.c_int * len(widths))(*widths)
            for B in c["Bs"]:
                rc = ch(ctypes.cast(w, ctypes.c_void_p), len(widths) - 1, B, c["N"], ptr)
                stages = ", ".join(f"layers {out[1 + 4 * i]}-{out[2 + 4 * i] - 1} on {out[3 + 4 * i]}"
                                   f"{' streamed' if out[4 + 4 * i] else ''}" for i in range(out[0]))
                print(f"  plan bf16 {name} {'-'.join(map(str, widths))} N={c['N']} B={B}: rc {rc}; "
                      f"{stages}", flush=True)
    t0, checked, missed, tiers = time.perf_counter(), 0, [], {}
    for K in range(1, 65):
        for ka1 in range(64, 1729, 64):
            C1 = ka1 - 56
            widest = max([c2 for c2 in range(4, 2049, 4) if earlier_sa_bf16_fits(K, C1, c2)], default=0)
            for C2 in sorted({*range(64, widest + 1, 64), widest} - {0}):
                for C3 in (64, 68):
                    rc = sa(1, 1, K, C1, C2, C3, ptr)
                    checked += 1
                    if rc:
                        missed.append((K, C1, C2, C3, rc))
                    key = (out[0], out[1], out[2] if not out[3] else "resident")
                    tiers[key] = tiers.get(key, 0) + 1
    print(f"  plan sweep: {checked} shapes the earlier bf16 K4 design planned, {len(missed)} refused "
          f"here {missed[:5]}; plans (warpgroups, h1 streamed, stages): "
          f"{dict(sorted(tiers.items(), key=str))} ({time.perf_counter() - t0:.1f} s) [{card}]",
          flush=True)
    if missed:
        fail(f"the bf16 K4 plan refuses {len(missed)} shapes the earlier design took: {missed[:5]}")


def bf16_breakdown(card: str) -> None:
    """Where a bf16 K1/K2/K4 call's time goes: BAT's search SA0 and SA2 (K4)
    and M2's seg mlp1 with its tap (K1) and seg head (K2), at B = 1 and 16:
    the profiler's device time by kernel, the wrapper's own launches around
    K4 at B = 1 timed alone by events behind a queued sleep (the features'
    f32 copy, a_rows, and the A rows' bf16 cast the earlier design's wrapper made);
    with the phase counters' build (this tree's csrc/ has them), cycles by
    phase. It runs on an older tree too (copy this script there)."""
    import numpy as np
    import torch

    from open3dsot_tpu_torch.data import get_dataset
    from open3dsot_tpu_torch.ops import chain_fused as cf
    from open3dsot_tpu_torch.ops import sa_fused as saf

    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(2) as pool:
        sa_lib, chain_lib = pool.map(phase_build, ["sa_fused_bf16", "chain_fused_bf16"])
    if sa_lib is not None and hasattr(sa_lib.lib, "sa_bf16_plan"):
        bf16_plans(sa_lib, chain_lib, card)
    bcfg = matching_cfg("bat", bf16=True)
    bat, bvars = make_model(bcfg, fused_eval=True)
    bat_plain, _ = make_model(bcfg, fused_eval=False, variables=bvars)
    frames = matching_frames(bat, get_dataset(bcfg, "test", "test"), 16)
    batch = {k: np.concatenate([f[k] for f in frames]) for k in frames[0]}
    calls = {label: rest for label, *rest in sa_calls(bat_plain, batch)}
    for label in ("search SA0", "search SA2"):
        mod, xyz16, feats16, new16 = calls[label]
        folded = mod.folded_chains()
        kw = dict(radius=mod.radius, normalize_xyz=mod.normalize_xyz, use_xyz=mod.use_xyz)
        for B in (1, 16):
            xyz, new = xyz16[:B].contiguous(), new16[:B].contiguous()
            feats = None if feats16 is None else feats16[:B].contiguous()
            print_breakdown(f"K4 bf16 {label} B={B}", lambda: saf.fused_sa_apply(
                xyz, feats, new, None, folded, nsample=mod.nsample, **kw), card, sa_lib)
            if B == 1 and feats is not None:
                f32 = feats.float()
                inv_r = 1.0 / mod.radius if mod.normalize_xyz else 1.0
                a = saf.a_rows(xyz, f32, folded[0][0], inv_r=inv_r, use_xyz=mod.use_xyz)
                t = {"features.float()": queued_ms(lambda: feats.float(), sleep=BF16_SLEEP),
                     "a_rows": queued_ms(lambda: saf.a_rows(xyz, f32, folded[0][0], inv_r=inv_r,
                                                            use_xyz=mod.use_xyz), sleep=BF16_SLEEP),
                     "a.to(bf16)": queued_ms(lambda: a.to(torch.bfloat16), sleep=BF16_SLEEP),
                     "the whole call": queued_ms(lambda: saf.fused_sa_apply(
                         xyz, feats, new, None, folded, nsample=mod.nsample, **kw),
                         sleep=BF16_SLEEP)}
                print(f"  wrapper launches around K4 bf16 {label} B=1 (queued events): "
                      + ", ".join(f"{k} {v * 1e3:.2f} us" for k, v in t.items()) + f" [{card}]",
                      flush=True)
    model, _ = make_model(bench_cfg(bf16=True), fused_eval=True)
    chain1, chain2 = model.net.seg_pointnet.folded_chains()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 181)
    for B in (1, 16):
        x = torch.randn(B, 2 * N_POINTS, chain1.widths[0], generator=gen, device="cuda")
        tap, pooled = cf.fused_pointnet_encoder(x, chain1, tap_at=1)
        print_breakdown(f"K1 bf16 seg mlp1 B={B}",
                        lambda: cf.fused_pointnet_encoder(x, chain1, tap_at=1), card, chain_lib)
        print_breakdown(f"K2 bf16 seg head B={B}", lambda: cf.fused_seg_head(tap, pooled, chain2),
                        card, chain_lib)


def no_worse_than_plain(what: str, got, plain, truth) -> None:
    """The kernel path's bf16 output against the plain bf16 path's, both held
    to the f32 plain path (see BF16_MAX_REL's notes): the kernel path's
    distance from it between 0.5x and 1.5x the plain path's + 1e-4."""
    import torch

    def mean_rel(x):
        return ((x.double() - truth.double()).abs() / truth.double().abs().clamp_min(1.0)).mean().item()

    k, p = mean_rel(got), mean_rel(plain)
    ok = 0.5 * p < k <= 1.5 * p + 1e-4
    print(f"  {what}: mean_rel from the f32 path: kernel path {k:.3e}, plain bf16 path {p:.3e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok or not torch.isfinite(got).all():
        fail(f"{what}: the bf16 kernel path is {k} from f32, the plain bf16 path {p}")


def bf16_host_loops(card: str) -> dict:
    """The M2 and BAT host loops under bf16: true, kernel path against plain
    path on one forward (launches a forward; both held to the f32 plain
    path), then evaluate_dataset from launch counts of 0. Returns the
    launches of those runs."""
    import numpy as np
    import torch

    from open3dsot_tpu_torch.data import get_dataset
    from open3dsot_tpu_torch.ops import chain_fused as cf
    from open3dsot_tpu_torch.tracking.eval import evaluate_dataset

    launches = {}
    cfg = bench_cfg(bf16=True)
    model, variables = make_model(cfg, fused_eval=True)
    plain_model, _ = make_model(cfg, fused_eval=False, variables=variables)
    f32_model, _ = make_model(bench_cfg(), fused_eval=False, variables=variables)
    sampler = get_dataset(cfg, "test", "test")
    frames = [model.build_input_dict(seq, f, [seq[f - 1]["3d_bbox"]])[0]
              for seq in (sampler[0], sampler[1]) for f in range(1, 9)]
    batch16 = {k: np.concatenate([f[k] for f in frames]) for k in frames[0]}
    for B, batch in ((1, frames[0]), (16, batch16)):
        cf.reset_launch_counts()
        got = model.apply(batch)
        torch.cuda.synchronize()
        n = (cf.fused_pointnet_encoder.launches, cf.fused_seg_head.launches)
        want = plain_model.apply(batch)
        if n != (3, 1):
            fail(f"bf16 M2 B={B}: one forward launched K1/K2 {n}, expected (3, 1)")
        if any(v.dtype != torch.float32 for v in got.values()):
            fail(f"bf16 M2 B={B}: an output is not f32")
        no_worse_than_plain(f"bf16 M2 B={B} seg_logits", got["seg_logits"], want["seg_logits"],
                            f32_model.apply(batch)["seg_logits"])
        agree = (got["seg_logits"].argmax(-1) == want["seg_logits"].argmax(-1)).float().mean().item()
        e = (got["estimation_boxes"] - want["estimation_boxes"]).abs().max().item()
        print(f"  bf16 M2 B={B}: K1 x3, K2 x1 a forward; seg mask agrees on {agree:.5f} of points; "
              f"boxes {e:.3e} from the plain bf16 path (argmax gates amplify a bf16 step: "
              f"reported, not held)", flush=True)
        if agree <= BF16_ARGMAX_AGREE or not torch.isfinite(got["estimation_boxes"]).all():
            fail(f"bf16 M2 B={B}: seg mask agrees on {agree} of points, or boxes not finite")
    n_frames = sum(len(sampler[i]) - 1 for i in range(len(sampler)))
    evaluate_dataset(model, sampler, cfg, max_tracklets=1)  # warm-up
    cf.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    succ, prec = evaluate_dataset(model, sampler, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches["K1"], launches["K2"] = cf.fused_pointnet_encoder.launches, cf.fused_seg_head.launches
    print(f"bf16 M2 eval (host loop): success {succ:.4f} precision {prec:.4f}; {n_frames} forwards "
          f"in {dt:.4f} s = {n_frames / dt:.2f} frames/s; launches K1 {launches['K1']} K2 "
          f"{launches['K2']} [{card}]", flush=True)
    if (launches["K1"], launches["K2"]) != (3 * n_frames, n_frames):
        fail(f"bf16 M2 eval: expected K1 {3 * n_frames} and K2 {n_frames} launches")
    if not (np.isfinite([succ, prec]).all() and 0 <= succ <= 100 and 0 <= prec <= 100):
        fail(f"bf16 M2 Success/Precision not finite in [0, 100]: {succ}, {prec}")

    bcfg = matching_cfg("bat", bf16=True)
    bat, bvars = make_model(bcfg, fused_eval=True)
    bat_plain, _ = make_model(bcfg, fused_eval=False, variables=bvars)
    bat_f32, _ = make_model(matching_cfg("bat"), fused_eval=False, variables=bvars)
    bsampler = get_dataset(bcfg, "test", "test")
    bframes = matching_frames(bat, bsampler, 16)
    bbatch16 = {k: np.concatenate([f[k] for f in bframes]) for k in bframes[0]}
    for B, batch in ((1, bframes[0]), (16, bbatch16)):
        reset_matching_counts()
        got = bat.apply(batch)
        torch.cuda.synchronize()
        n = matching_counts()
        want = bat_plain.apply(batch)
        if n != (2, 7, 0):
            fail(f"bf16 BAT B={B}: one forward launched K3/K4/K5 {n}, expected (2, 7, 0)")
        if not torch.equal(got["sample_idxs"], want["sample_idxs"]):
            fail(f"bf16 BAT B={B}: sample_idxs differ between the kernel and the plain path")
        no_worse_than_plain(f"bf16 BAT B={B} estimation_cla", got["estimation_cla"],
                            want["estimation_cla"], bat_f32.apply(batch)["estimation_cla"])
        e = (got["estimation_boxes"] - want["estimation_boxes"]).abs().max().item()
        print(f"  bf16 BAT B={B}: K3 x2, K4 x7 a forward; boxes {e:.3e} from the plain bf16 path "
              f"(reported, not held)", flush=True)
        if not torch.isfinite(got["estimation_boxes"]).all():
            fail(f"bf16 BAT B={B}: boxes not finite")
    calls = sa_calls(bat_plain, bbatch16)
    bn_frames = sum(len(bsampler[i]) - 1 for i in range(len(bsampler)))
    evaluate_dataset(bat, bsampler, bcfg, max_tracklets=1)  # warm-up
    reset_matching_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    succ, prec = evaluate_dataset(bat, bsampler, bcfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches["K3"], launches["K4"], launches["K5"] = matching_counts()
    print(f"bf16 BAT eval (host loop): success {succ:.4f} precision {prec:.4f}; {bn_frames} "
          f"forwards in {dt:.4f} s = {bn_frames / dt:.2f} frames/s; launches K3 {launches['K3']} "
          f"K4 {launches['K4']} K5 {launches['K5']} [{card}]", flush=True)
    if (launches["K3"], launches["K4"]) != (2 * bn_frames, 7 * bn_frames):
        fail(f"bf16 BAT eval: expected K3 {2 * bn_frames} and K4 {7 * bn_frames} launches")
    if not (np.isfinite([succ, prec]).all() and 0 <= succ <= 100 and 0 <= prec <= 100):
        fail(f"bf16 BAT Success/Precision not finite in [0, 100]: {succ}, {prec}")
    print("phase 18c ok: the M2 and BAT host loops under bf16", flush=True)
    return {"launches": launches, "m2": model, "sa_calls": calls}


def bf16_scans(card: str) -> None:
    """M2ScanTracker(compute_dtype=bf16) and MatchScanTracker on a bf16 BAT
    at B = BF16_B: graph == eager bit for bit, launches a replay, frames/s
    beside the f32 trackers' graphs in the same call."""
    import torch

    from open3dsot_tpu_torch.data import get_dataset
    from open3dsot_tpu_torch.ops import chain_fused as cf
    from open3dsot_tpu_torch.tracking import scan_matching as sm
    from open3dsot_tpu_torch.tracking import scan_tracker as st

    B, steps = BF16_B, SCAN_T - 1
    cfg = bench_cfg(syn_num_tracklets=BF16_B, syn_tracklet_len=SCAN_T)
    model, _ = make_model(cfg, fused_eval=True)  # f32 weights: the tracker rounds a copy
    seqs = [get_dataset(cfg, "test", "test")[i] for i in range(B)]
    kw = dict(max_points=SCAN_MAX_POINTS, frame_bucket=SCAN_T, compute_dtype=torch.bfloat16)
    f32 = st.M2ScanTracker(model, cfg, max_points=SCAN_MAX_POINTS, frame_bucket=SCAN_T)
    cases = [("M2 scan bf16", st.M2ScanTracker(model, cfg, **kw),
              st.M2ScanTracker(model, cfg, cuda_graph=False, **kw), f32,
              lambda: (cf.fused_pointnet_encoder.launches, cf.fused_seg_head.launches), (3, 1))]
    bcfg = match_cfg("bat", syn_num_tracklets=BF16_B, bf16=True)
    bat, bvars = make_model(bcfg, fused_eval=True)
    bat32, _ = make_model(match_cfg("bat", syn_num_tracklets=BF16_B), fused_eval=True,
                          variables=bvars)
    bseqs = [get_dataset(bcfg, "test", "test")[i] for i in range(B)]
    cases.append(("BAT scan bf16", sm.MatchScanTracker(bat, bcfg, **MATCH_KW),
                  sm.MatchScanTracker(bat, bcfg, cuda_graph=False, **MATCH_KW),
                  sm.MatchScanTracker(bat32, bcfg, **MATCH_KW), lambda: matching_counts()[:2],
                  (2, 7)))
    for what, graph, eager, ref, counts, want in cases:
        host = scan_host(graph, seqs if what.startswith("M2") else bseqs)
        dev = to_card(host)
        graph_equals_eager(graph, eager, dev, f"{what} B={B}")
        d = (graph.track_frames(*dev) - ref.track_frames(*dev)).abs().max().item()
        print(f"  {what} B={B}: boxes {d:.3e} from the f32 tracker's over {steps} frames "
              f"(argmax flips compound: reported)", flush=True)
        per_replay = graph.graph_launches()["captured_per_replay"]
        if tuple(want) not in [tuple(p) for p in per_replay]:
            fail(f"{what}: captured {per_replay} per replay, expected {want}")
        cf.reset_launch_counts()
        reset_matching_counts()
        eager.track_frames(*dev)
        torch.cuda.synchronize()
        if tuple(counts()) != tuple(n * steps for n in want):
            fail(f"{what}: the eager steps launched {counts()}, expected {want} a step")
        t_f = wall_ms(lambda: ref.track_frames(*dev))
        t_g = wall_ms(lambda: graph.track_frames(*dev))
        t_e = wall_ms(lambda: eager.track_frames(*dev), repeats=3)
        t_f2 = wall_ms(lambda: ref.track_frames(*dev))
        frames = B * steps
        print(f"  {what} B={B}: launches a replay {per_replay}; frames/s graph "
              f"{frames / t_g * 1e3:.2f} eager {frames / t_e * 1e3:.2f}; the f32 tracker's graph "
              f"{frames / t_f * 1e3:.2f} / {frames / t_f2 * 1e3:.2f} before / after (batch on "
              f"the card) [{card}]", flush=True)
    print("phase 18d ok: the scan trackers under bf16, graph == eager", flush=True)


def bf16_phase(card: str) -> list:
    """Phase 18: the bf16 compute mode of eval; returns its kernels' entries."""
    t0 = time.perf_counter()
    loops = bf16_host_loops(card)
    chains = check_chains_bf16(loops["m2"], card)
    sa_errs, sa_sums = check_sa_bf16(loops["sa_calls"], card)
    cut = bf16_cut_cases(card)
    for k in ("K1", "K2"):
        chains["errs"][k] = max(chains["errs"][k], cut[k])
    for k in ("K4", "K5"):
        sa_errs[k] = max(sa_errs[k], cut[k])
    bf16_scans(card)
    print(f"phase 18 ok in {time.perf_counter() - t0:.1f} s", flush=True)
    n = loops["launches"]
    s1 = sa_sums[1]
    return [
        kernel_entry("K1 fused_pointnet_encoder (bf16)", "chain_fused_bf16.cu",
                     "open3dsot_tpu/ops/chain_fused.py:150", n["K1"], chains["errs"]["K1"],
                     **chains["rows"][("K1 seg mlp1 tap", 1)]),
        kernel_entry("K2 fused_seg_head (bf16)", "chain_fused_bf16.cu",
                     "open3dsot_tpu/ops/chain_fused.py:217", n["K2"], chains["errs"]["K2"],
                     **chains["rows"][("K2 seg head", 1)]),
        kernel_entry("K4 fused_sa_apply (ball query, bf16)", "sa_fused_bf16.cu",
                     "open3dsot_tpu/ops/sa_fused.py:384", n["K4"], sa_errs["K4"], s1["k4"],
                     s1["plain"], s1["w4"], library_ms=s1["lib"], peak=PEAK_BF16_FLOPS),
        kernel_entry("K5 fused_sa_apply (idx given, bf16)", "sa_fused_bf16.cu",
                     "open3dsot_tpu/ops/sa_fused.py:415", n["K5"], sa_errs["K5"], s1["k5"],
                     s1["plain"], s1["w5"], peak=PEAK_BF16_FLOPS),
    ]



# --- phase 19: K6 in the bf16 mode ----------------------------------------------

# Phase 19's cases beside the four calls: SA layer 3 of the search cloud with
# random weights at other widths and K, (C1, C2, C3), K or None (the layer's
# 32), what. Width 512: every weight resident at 64-channel slices. Widths
# that are multiples of 4 but not of 8 or 64, at a K that is not a power of
# two: the grids' padded rows, partial 64-input k-blocks, slices that a width
# ends inside, dW tiles of fewer than 128 channels, and the max over K taken
# by scan_kernel. Widths 1540/1028/1284: the passes with 1540 inputs and B3
# (1284 + 1540) stream their weights with the A k-blocks, the others keep
# them resident.
K6_BF16_CUT = (((512, 512, 512), None, "width 512"),
               ((100, 36, 68), 20, "widths 100,36,68 and K 20"),
               ((1540, 1028, 1284), None, "widths 1540,1028,1284"))
# The y3 the max pass keeps, against h2 W3 + b3 from the kernel's own h2 in
# f32 (the same bf16 operands and f32 sums, summed in another order): within
# K6_Y3_REL[0] of max|y3| at any element and K6_Y3_REL[1] on average
# (measured at most 2^-19.6 and 2^-23.9 at the seven shapes); a y3 rounded to
# bf16 would sit near 2^-9, a wrong tile or bias near 1.
K6_Y3_REL = (2.0 ** -16, 2.0 ** -20)


def compare_y3(name: str, got, want) -> float:
    """The kernel's kept y3 against h2 W3 + b3 within K6_Y3_REL."""
    import torch

    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"{name}: shape {tuple(got.shape)} (want {tuple(want.shape)}) or non-finite values")
    scale = max(want.abs().max().item(), 1e-30)
    err = (got - want).abs()
    max_abs, mean_abs = err.max().item(), err.mean().item()
    ok = max_abs <= K6_Y3_REL[0] * scale and mean_abs <= K6_Y3_REL[1] * scale
    print(f"  {name}: max_abs_err {max_abs:.3e} ({max_abs / scale:.2e} of max|ref| {scale:.3e}), "
          f"mean {mean_abs / scale:.2e} of it {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{name}: outside (max {K6_Y3_REL[0]:.2e}, mean {K6_Y3_REL[1]:.2e} of max|ref|)")
    return max_abs


def k6_bf16_inputs(mod, xyz, feats, new, gen, widths=None, nsample=None):
    """The inputs of one K6 bf16 call: the layer's weights, or (widths) random
    ones of those widths made from `gen` (an SA layer cut to other widths),
    the ball query (of `nsample` neighbours where given, else the layer's)
    and the A-form -> dict."""
    import torch

    from open3dsot_tpu_torch.ops.neighbors import ball_query
    from open3dsot_tpu_torch.ops.sa_fused import a_form

    layers = list(mod.mlp_shared.children())
    if widths is None:
        w1, b1 = layers[0].dense.weight.detach().t(), layers[0].dense.bias.detach()
        w2, w3 = (l.dense.weight.detach().t().contiguous() for l in layers[1:])
        b2, b3 = (l.dense.bias.detach() for l in layers[1:])
        bn = [p.detach() for l in layers for p in (l.bn.weight, l.bn.bias)]
    else:
        dev = xyz.device
        c_in = 3 + feats.shape[2]

        def rnd(*shape, scale=1.0):
            return torch.randn(*shape, device=dev, generator=gen) * scale

        w1, b1 = rnd(c_in, widths[0], scale=c_in ** -0.5), rnd(widths[0], scale=0.1)
        w2, b2 = rnd(widths[0], widths[1], scale=widths[0] ** -0.5), rnd(widths[1], scale=0.1)
        w3, b3 = rnd(widths[1], widths[2], scale=widths[1] ** -0.5), rnd(widths[2], scale=0.1)
        bn = [1.0 + rnd(c, scale=0.1) if i == 0 else rnd(c, scale=0.1)
              for c in widths for i in range(2)]
    idx = ball_query(mod.radius, nsample or mod.nsample, xyz, new)
    inv_r = 1.0 / mod.radius if mod.normalize_xyz else 1.0
    a, ct = a_form(xyz, feats.float(), new, w1, b1, inv_r=inv_r, use_xyz=mod.use_xyz)
    return dict(a=a, ab=a.to(torch.bfloat16).float(), ct=ct, idx=idx, w2=w2, b2=b2, w3=w3,
                b3=b3, bn=bn)


def k6_cublas_ms(B, S, K, c1, c2, c3, gen) -> tuple:
    """(forward, backward) ms of the same call's products as cuBLAS bf16
    GEMMs, torch.matmul on bf16 operands: y2 = h1 W2, y3 = h2 W3; dh2 = dy3
    W3^T, dW3 = h2^T dy3, dh1 = dy2 W2^T, dW2 = h1^T dy2. The yardstick of
    K6 bf16's rows in PERF.md; nothing in the port calls it."""
    import torch

    R = B * S * K
    bf = torch.bfloat16

    def rnd(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(bf)

    h1, h2, dy3, dy2 = rnd(R, c1), rnd(R, c2), rnd(R, c3), rnd(R, c2)
    w2, w3 = rnd(c1, c2), rnd(c2, c3)
    fwd = lambda: (h1 @ w2, h2 @ w3)  # noqa: E731
    bwd = lambda: (dy3 @ w3.t(), h2.t() @ dy3, dy2 @ w2.t(), h1.t() @ dy2)  # noqa: E731
    return (queued_ms(fwd, iters=3, repeats=3, sleep=BF16_SLEEP),
            queued_ms(bwd, iters=3, repeats=3, sleep=BF16_SLEEP))


def check_k6_bf16(calls, card: str, lib) -> dict:
    """K6's bf16 mode (csrc/sa_fused_train_bf16.cu), forward and backward,
    against its plain bf16 version at the four K6 calls of a BAT train step
    (B = 16 and TRAIN_B) and, at B = 16 with random weights, at K6_BF16_CUT:
    each output and the forward's grids h1, h2 within BF16_MAX_REL /
    BF16_MEAN_REL of max|plain|, and the f32 plain version on the same inputs
    outside them (compare_bf16); the backward of both takes the kernel
    forward's own grids and statistics and a bf16-valued cotangent, the plain
    one with the y3 that the kernel's max pass took its maxima on (kept for
    the check, and held to h2 W3 + b3 from the kernel's h2 within K6_Y3_REL):
    the kernel's backward computes y3 again, and must get it bit for bit, or
    the ties it routes the gradient by are not its forward's; cuBLAS's y3 at
    the same h2 breaks near-ties of the max another way. The forward without
    the kept y3 must give the same mxt bit for bit. Times by
    events and device time beside the 3xTF32 K6 on the same inputs in this
    call, the same products as cuBLAS bf16 GEMMs, the bound at 989 TFLOP/s
    dense bf16 and 3.35 TB/s (k6_work's bytes, bf16 grids); device time by
    kernel of each pass at B = TRAIN_B, both modes. Device time is by events
    behind a queued sleep (`queued_ms`): late in a whole run the profiler's
    traces of these calls came back short (a third of their event time)."""
    import torch

    from open3dsot_tpu_torch.ops import sa_fused_train as k6

    counts = sass_tensor_ops(lib.path, split=True)
    bf = {fn: c for fn, c in counts.items() if fn.startswith(("rp_kernel", "dw_kernel"))}
    print(f"  sass: K6 bf16's product kernels (HMMA, HGMMA): {bf}", flush=True)
    if len(bf) != 17 or not all(c[1] and not c[0] for c in bf.values()):
        fail(f"K6 bf16's product kernels: not all on wgmma (HGMMA) alone: {bf}")
    gen = torch.Generator(device=calls[0][2].device).manual_seed(SEED)
    errs = {"fwd": 0.0, "bwd": 0.0}
    keys = ("fwd", "fwd_plain", "fwd_tf32", "bwd", "bwd_plain", "bwd_tf32", "fwd_cublas",
            "bwd_cublas")
    sums = {B: dict.fromkeys(keys, 0.0) for B in K6_BATCHES}
    dev = {B: dict.fromkeys(keys, 0.0) for B in K6_BATCHES}
    work = {B: [[0, 0], [0, 0]] for B in K6_BATCHES}
    per_pass = {k: [] for k in ("fwd", "fwd_tf32", "bwd", "bwd_tf32")}  # the calls at TRAIN_B

    def one(label, mod, xyz, feats, new, B, widths=None, nsample=None):
        x = k6_bf16_inputs(mod, xyz, feats, new, gen, widths, nsample)
        a, ab, ct, idx, bn = x["a"], x["ab"], x["ct"], x["idx"], x["bn"]
        w2, b2, w3, b3 = x["w2"], x["b2"], x["w3"], x["b3"]
        N, S, K = xyz.shape[1], new.shape[1], idx.shape[2]
        c1, c2, c3 = a.shape[2], w2.shape[1], w3.shape[1]
        shape = f"{label} B={B} N={N} S={S} K={K} C={c1},{c2},{c3}"
        packs, packs32 = k6.Packs(w2, w3, True), k6.Packs(w2, w3, False)
        wb = (w2, b2, w3, b3, bn)
        fwd_k = lambda: k6.sa_train_fwd_kernel(a, ct, idx, *wb, packs)  # noqa: E731
        fwd_p = lambda: k6.sa_train_fwd_plain(ab, ct, idx, *wb, True)  # noqa: E731
        fwd_t = lambda: k6.sa_train_fwd_kernel(a, ct, idx, *wb, packs32)  # noqa: E731
        y3_k = torch.empty(B, S, K, c3, device=a.device)
        out_k, st_k, grids_k = k6.sa_train_fwd_kernel(a, ct, idx, *wb, packs, y3_out=y3_k)
        mxt_again = fwd_k()[2][2]
        out_p, st_p, grids_p = fwd_p()
        out_f, st_f, grids_f = k6.sa_train_fwd_plain(a, ct, idx, *wb)
        g = torch.randn(B, S, c3, device=a.device, generator=gen).to(torch.bfloat16).float()
        bwd_k = lambda: k6.sa_train_bwd_kernel(g, a, ct, idx, grids_k, st_k, *wb, packs)  # noqa: E731
        bwd_p = lambda: k6.sa_train_bwd_plain(g, ab, ct, idx, grids_k, st_k, *wb, True,  # noqa: E731
                                              y3=y3_k)
        bwd_t = lambda: k6.sa_train_bwd_kernel(g, a, ct, idx, grids_t, st_t, *wb, packs32)  # noqa: E731
        gk, gp = bwd_k(), bwd_p()
        gf = k6.sa_train_bwd_plain(g, a, ct, idx, grids_f, st_f, *wb)
        torch.cuda.synchronize()
        if not torch.equal(mxt_again, grids_k[2]):
            fail(f"K6 bf16 fwd {shape}: mxt without the kept y3 is not the same bit for bit")
        errs["fwd"] = max(errs["fwd"], compare_bf16(f"K6 bf16 fwd {shape} out", out_k, out_p,
                                                    out_f))
        y3_h2 = grids_k[1][..., :c2].float() @ w3.to(torch.bfloat16).float() + b3
        errs["fwd"] = max(errs["fwd"], compare_y3(f"K6 bf16 fwd {shape} y3 of the max pass", y3_k,
                                                  y3_h2))
        for i in range(6):  # y1's: the f32 mode's sums, of bf16 rows
            what = f"K6 bf16 fwd {shape} {('mean', 'var')[i % 2]}{i // 2 + 1}"
            errs["fwd"] = max(errs["fwd"], compare(what, st_k[i], st_p[i]) if i < 2 else
                              compare_bf16(what, st_k[i], st_p[i], st_f[i], control=False))
        # the grids: h1 from y1 and its statistics (no product), h2 from y2
        s1 = [k6._fold(st_f[0], st_f[1], bn[0], bn[1])]
        h1_f = k6._relu_fold(k6._y1(a, ct, idx), *s1[0][:2])
        h2_f = k6._relu_fold(grids_f[0], *k6._fold(st_f[2], st_f[3], bn[2], bn[3])[:2])
        for name, got, want, f32, c in (("h1", grids_k[0], grids_p[0], h1_f, c1),
                                        ("h2", grids_k[1], grids_p[1], h2_f, c2)):
            errs["fwd"] = max(errs["fwd"], compare_bf16(f"K6 bf16 fwd {shape} grid {name}",
                                                        got[..., :c], want, f32))
        for i, name in enumerate(("da", "dct", "dW2", "dW3")):
            errs["bwd"] = max(errs["bwd"], compare_bf16(f"K6 bf16 bwd {shape} {name}",
                                                        gk[i], gp[i], gf[i]))
        errs["bwd"] = max(errs["bwd"], compare_bf16(
            f"K6 bf16 bwd {shape} dgamma,dbeta", torch.cat(gk[4]), torch.cat(gp[4]),
            torch.cat(gf[4])))
        if widths is not None:  # the cut cases are checked, not timed
            return
        _, st_t, grids_t = fwd_t()
        fns = dict(fwd=fwd_k, fwd_plain=fwd_p, fwd_tf32=fwd_t, bwd=bwd_k, bwd_plain=bwd_p,
                   bwd_tf32=bwd_t)
        if B == TRAIN_B:
            for k in ("fwd", "fwd_tf32", "bwd", "bwd_tf32"):
                per_pass[k].append(fns[k])
        t = {k: time_ms(f, iters=5, repeats=5) for k, f in fns.items()}
        t2 = {k: time_ms(f, iters=5, repeats=5) for k, f in reversed(list(fns.items()))}
        d = {k: queued_ms(f, iters=3, repeats=3, sleep=BF16_SLEEP) for k, f in fns.items()}
        d["fwd_cublas"], d["bwd_cublas"] = k6_cublas_ms(B, S, K, c1, c2, c3, gen)
        t["fwd_cublas"], t["bwd_cublas"] = d["fwd_cublas"], d["bwd_cublas"]
        for k in keys:
            sums[B][k] += min(t[k], t2.get(k, t[k]))
            dev[B][k] = None if d[k] is None or dev[B][k] is None else dev[B][k] + d[k]
        for i, w in enumerate(k6_work(B, N, S, K, c1, c2, c3, bf16=True)):
            work[B][i][0] += w[0]
            work[B][i][1] += w[1]
        print(f"  time K6 bf16 {shape}: fwd kernel {min(t['fwd'], t2['fwd']):.4f} ms "
              f"(3xTF32 {min(t['fwd_tf32'], t2['fwd_tf32']):.4f}, plain "
              f"{min(t['fwd_plain'], t2['fwd_plain']):.4f}), bwd kernel "
              f"{min(t['bwd'], t2['bwd']):.4f} ms (3xTF32 "
              f"{min(t['bwd_tf32'], t2['bwd_tf32']):.4f}, plain "
              f"{min(t['bwd_plain'], t2['bwd_plain']):.4f}); device fwd {fmt_ms(d['fwd'])} "
              f"/ {fmt_ms(d['fwd_tf32'])}, bwd {fmt_ms(d['bwd'])} / {fmt_ms(d['bwd_tf32'])}; "
              f"cuBLAS bf16 products fwd {fmt_ms(d['fwd_cublas'])}, bwd "
              f"{fmt_ms(d['bwd_cublas'])} [{card}]", flush=True)

    with torch.no_grad():
        for label, mod, xyz_all, feats_all, new_all in calls:
            for B in K6_BATCHES:
                one(label, mod, *(x[:B].contiguous() for x in (xyz_all, feats_all, new_all)), B)
        # SA layer 3 of the search cloud at other widths and K (random weights)
        label, mod, xyz, feats, new = calls[3]
        B = K6_BATCHES[0]
        for widths, nsample, what in K6_BF16_CUT:
            one(f"{label} at {what}", mod, *(x[:B].contiguous() for x in (xyz, feats, new)), B,
                widths=widths, nsample=nsample)
        for what, fns in per_pass.items():
            pass_breakdown(f"K6 {'3xTF32' if what.endswith('tf32') else 'bf16'} "
                           f"{'forward' if what.startswith('fwd') else 'backward'}", fns, card)
    for B in K6_BATCHES:
        line = []
        for i, what in ((0, "fwd"), (1, "bwd")):
            bound, by = bf16_bound(work[B][i])
            dk = dev[B][what]
            share = "not measured" if dk is None else f"{bound / dk:.1%}"
            ratio = ("not measured" if dk is None or not dev[B][what + "_tf32"]
                     else f"{dk / dev[B][what + '_tf32']:.2f}x")
            line.append(f"{what} bf16 kernel {sums[B][what]:.4f} ms (device {fmt_ms(dk)}, {ratio} "
                        f"of 3xTF32), 3xTF32 {sums[B][what + '_tf32']:.4f} ms (device "
                        f"{fmt_ms(dev[B][what + '_tf32'])}), plain bf16 "
                        f"{sums[B][what + '_plain']:.4f} ms, cuBLAS bf16 products "
                        f"{fmt_ms(dev[B][what + '_cublas'])}; bound {bound:.4f} ms by {by} at 989 "
                        f"TFLOP/s bf16 (device at {share} of it)")
        print(f"  K6 bf16 over one BAT train step's 4 calls, B={B}: {'; '.join(line)} [{card}]",
              flush=True)
    print("phase 19 ok: K6 bf16 forward and backward within the bf16 tolerance at every K6 call "
          "of a BAT train step and at " + ", ".join(c[2] for c in K6_BF16_CUT) + ", the f32 "
          "control outside it", flush=True)
    return dict(errs=errs, sums=sums, dev=dev, work=work)



# --- phases 20-21: training under bf16, and M2-Track training -------------------

# A bf16 train step against float64. Both bf16 paths (K6 in bf16 and the plain
# bf16 layers) round the same values at other places, and the argmax gates,
# ball queries and maxima downstream amplify a flipped bf16 step, so they are
# held to the plain path run in float64, not to each other: each loss term
# within max(2x the plain bf16 path's relative distance, 2e-2), and the
# gradients together within max(2x the plain bf16 path's, 0.2). The f32
# path's distances are printed beside them.
BF16_STEP_FACTOR, BF16_LOSS_FLOOR, BF16_GRAD_FLOOR = 2.0, 2e-2, 0.2
# The gradients of this net are ill-conditioned (the f32 step sits 3e-3 from
# float64), so those bounds hold the bf16 step only as a whole. The K6 layers'
# leaves of the kernel path are held tightly instead: each within
# K6_LEAF_MAX_REL of max|plain| at any element and K6_LEAF_MEAN_REL on
# average of the sum, over the layer's K6 calls in that step, of the plain
# bf16 K6 backward's VJP at the inputs and output cotangent the step gave
# each call and at the grids and statistics of the kernel's forward on them
# (two forwards that each round their own f32 sums to bf16 break near-ties
# of the max apart, and the backward routes the gradient by them), with the
# plain f32 K6 on the same inputs outside them (the control).
K6_LEAF_MAX_REL, K6_LEAF_MEAN_REL = 2.0 ** -8, 2.0 ** -12
M2_CFG = "cfgs/M2_track_kitti.yaml"
M2_TRAIN_B = 100  # batch_size of cfgs/M2_track_kitti.yaml
# M2 against float64 (B = 16): the f32 loss terms within 1e-3 of it and the
# gradients together within 5e-2 (measured 2.491e-2: the seg argmax picks the
# points the MiniPointNets see; a point near the boundary flips with the
# rounding).
M2_LOSS_RTOL, M2_GRAD_RTOL = 1e-3, 5e-2


def step_time(model, batch, optimizer, scheduler, card: str, what: str) -> dict:
    """A train step on a prebuilt batch: wall ms a step (events around 5), the
    device busy ms a step (profiler, 3 steps) and the idle share."""
    import torch

    from open3dsot_tpu_torch.train.trainer import train_step

    for _ in range(2):
        train_step(model, optimizer, batch, scheduler)
    torch.cuda.synchronize()
    steps = 5
    t0 = time.perf_counter()
    for _ in range(steps):
        train_step(model, optimizer, batch, scheduler)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    rows = device_rows(lambda: [train_step(model, optimizer, batch, scheduler) for _ in range(3)])
    busy_s = sum(dev_us(e) for e in rows) / 3 / 1e6
    idle = f"{1 - busy_s / step_s:.3f}" if busy_s > 0 else "not measured"
    print(f"  train step {what}: {step_s * 1e3:.4f} ms per step ({1 / step_s:.3f} steps/s); "
          f"device busy {busy_s * 1e3:.4f} ms per step, idle share {idle} [{card}]", flush=True)
    for e in sorted(rows, key=lambda e: -dev_us(e))[:6]:
        print(f"    {dev_us(e) / 3:10.0f} us per step {e.count // 3:5d}x  {e.key[:80]}")
    return dict(ms=step_s * 1e3, busy_ms=busy_s * 1e3)


@contextlib.contextmanager
def recording_k6(calls: list):
    """Inside: each K6 call of the SA layers appended to `calls` with its
    inputs, its SA layer's MLP and, after the backward, its output's cotangent."""
    from open3dsot_tpu_torch.models import pointnet

    real = pointnet.fused_sa_train_apply

    def recording(xyz, features, new_xyz, idx, mlp, **kw):
        out, stats = real(xyz, features, new_xyz, idx, mlp, **kw)
        rec = dict(inputs=[x.detach().float().clone() for x in (xyz, features, new_xyz)],
                   idx=idx.detach().int().clone(), mlp=mlp, kw=kw, out=out.detach().clone())
        out.register_hook(lambda g: rec.__setitem__("g", g.detach().float().clone()))
        calls.append(rec)
        return out, stats

    pointnet.fused_sa_train_apply = recording
    try:
        yield calls
    finally:
        pointnet.fused_sa_train_apply = real


def k6_plain_leaf_grads(net, calls, bf16: bool) -> dict:
    """{"grad <leaf>": the sum over its layer's K6 calls of the plain K6
    backward's VJP (bf16 or f32) at each call's inputs and cotangent}, on the
    card: the A-form under autograd for W1, the plain backward for the rest,
    with a rounded to bf16 in the bf16 mode as the wrapper rounds it. In the
    bf16 mode the backward takes the grids and statistics of the kernel's
    forward on those inputs (checked to give the step's output bit for bit)
    and the y3 its max pass took, in f32 those of the plain f32 forward."""
    import torch

    from open3dsot_tpu_torch.ops import sa_fused_train as k6
    from open3dsot_tpu_torch.ops.sa_fused import a_form

    names = {id(m): n for n, m in net.named_modules()}
    total = {}
    for rec in calls:
        layers = list(rec["mlp"].children())
        w1 = layers[0].dense.weight.detach().clone().requires_grad_()
        b1 = layers[0].dense.bias.detach().clone().requires_grad_()
        kw = rec["kw"]
        xyz, feats, new = rec["inputs"]
        a, ct = a_form(xyz, feats, new, w1.t(), b1, use_xyz=kw["use_xyz"],
                       inv_r=1.0 / kw["radius"] if kw["normalize_xyz"] else 1.0)
        w2, w3 = (l.dense.weight.detach().t().contiguous() for l in layers[1:])
        b2, b3 = (l.dense.bias.detach() for l in layers[1:])
        bn = [p.detach() for l in layers for p in (l.bn.weight, l.bn.bias)]
        a_in = a.detach().to(torch.bfloat16).float() if bf16 else a.detach()
        y3 = None
        if bf16:  # the kernel rounds a as it reads it
            y3 = torch.empty(*rec["idx"].shape, w3.shape[1], device=a.device)
            out, stats, grids = k6.sa_train_fwd_kernel(a.detach(), ct.detach(), rec["idx"], w2, b2,
                                                       w3, b3, bn, k6.Packs(w2, w3, True),
                                                       y3_out=y3)
            if not torch.equal(out.to(rec["out"].dtype), rec["out"]):
                fail("K6 bf16 forward again on a step's inputs: not the step's output")
        else:
            _, stats, grids = k6.sa_train_fwd_plain(a_in, ct.detach(), rec["idx"], w2, b2, w3,
                                                    b3, bn)
        da, dct, dw2, dw3, dbn = k6.sa_train_bwd_plain(rec["g"], a_in, ct.detach(), rec["idx"],
                                                       grids, stats, w2, b2, w3, b3, bn, bf16,
                                                       y3=y3)
        torch.autograd.backward([a, ct], [da, dct])
        grads = {"layer0.dense.weight": w1.grad, "layer1.dense.weight": dw2.t(),
                 "layer2.dense.weight": dw3.t()}
        for i in range(3):
            grads[f"layer{i}.bn.weight"], grads[f"layer{i}.bn.bias"] = dbn[2 * i], dbn[2 * i + 1]
        for k, v in grads.items():
            key = f"grad {names[id(rec['mlp'])]}.{k}"
            total[key] = total.get(key, 0.0) + v.detach().double()
    return total


def loss_and_grad_errs(got: dict, truth: dict):
    """({loss term: relative error}, relative error of all gradients together)."""
    import torch

    losses = {k: (abs(got[k].item() - truth[k].item()) / max(abs(truth[k].item()), 1e-6))
              for k in truth if k.startswith("loss ")}
    grads = [k for k in truth if k.startswith("grad ")]
    g = rel_err(torch.cat([got[k].reshape(-1) for k in grads]),
                torch.cat([truth[k].reshape(-1) for k in grads]))
    return losses, g


def fit_run(model, cfg, sampler, val, card: str, what: str, steps: int = 3) -> dict:
    """Trainer.fit for two epochs of `steps` steps with validation; steps/s
    of epoch 2 and the time it waited for the loader."""
    import numpy as np
    import torch

    from open3dsot_tpu_torch.train.trainer import Trainer

    work_dir = ROOT / "runs" / f"chip_smoke_fit_{what.replace(' ', '_')}"
    history = Trainer(model, cfg, work_dir=str(work_dir)).fit(sampler, val, epochs=2,
                                                               steps_per_epoch=steps)
    torch.cuda.synchronize()
    last = history[-1]
    n2 = last["steps"] - history[0]["steps"]
    FIT_RATES[what] = n2 / last["time_s"]
    print(f"fit {what}: {last['steps']} steps of B={cfg.batch_size}, losses "
          f"{[h['loss'] for h in history]}; epoch 2: {n2 / last['time_s']:.3f} steps/s, "
          f"{n2 * cfg.batch_size / last['time_s']:.2f} samples/s, waiting for the loader "
          f"{last['data_wait_s']:.4f} of {last['time_s']:.4f} s; validation success "
          f"{last['success']:.4f} precision {last['precision']:.4f} [{card}]", flush=True)
    if not all(np.isfinite(h["loss"]) for h in history) or last["steps"] != 2 * steps:
        fail(f"fit {what}: {history}")
    scalars = (work_dir / "scalars.jsonl").read_text()
    if cfg.net_model == "m2track" and '"train/acc_seg_foreground"' not in scalars:
        fail(f"fit {what}: no train/acc_* scalars logged")
    return last


def bf16_train_phase(card: str) -> dict:
    """Phase 20: a BAT bf16 train step (K6 in bf16) and the plain bf16 path,
    both against the plain path in float64 (B = 16), the f32 path beside
    them; the K6 layers' leaves held to the plain bf16 K6 backward at the
    step's own K6 calls (K6_LEAF_MAX_REL, K6_LEAF_MEAN_REL); step time at B = TRAIN_B against the f32 step in this call; then
    Trainer.fit in bf16 from launch counts of 0, validating on the bf16 scan
    tracker; returns the fit's K6 bf16 launches."""
    import torch

    from open3dsot_tpu_torch.data import get_dataset
    from open3dsot_tpu_torch.models.layers import computes_in_bf16
    from open3dsot_tpu_torch.ops import sa_fused_train
    from open3dsot_tpu_torch.train.optim import make_optimizer

    t0 = time.perf_counter()
    k6 = sa_fused_train.fused_sa_train_apply
    cfg = matching_cfg("bat", bf16=True, tensorboard=False)
    kern, variables = make_model(cfg, fused_eval=True)
    if not computes_in_bf16(kern.net):
        fail("bf16: the BAT net does not compute in bf16")
    plain, _ = make_model(cfg, fused_eval=False, variables=variables)
    plain32, _ = make_model(matching_cfg("bat"), fused_eval=False, variables=variables)
    state = {k: v.clone() for k, v in kern.net.state_dict().items()}
    batch = kern.device_batch(train_batch(cfg, 16, SEED))
    reset_training_counts()
    calls = []
    with recording_k6(calls):
        got = train_step_state(kern, batch, state)
    launches = training_counts() + (k6.bf16_fwd_launches, k6.bf16_bwd_launches)
    print(f"  BAT bf16 B=16: one train step launched K3 {launches[0]}, K6 forward {launches[1]} "
          f"(bf16 {launches[4]}), backward {launches[2]} (bf16 {launches[5]}), K4 {launches[3]}",
          flush=True)
    if launches != (2, 4, 4, 0, 4, 4):
        fail(f"BAT bf16 train step: launches {launches}, expected K3 2, K6 4 / 4 in bf16, K4 0")
    if not all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in kern.net.parameters()):
        fail("BAT bf16 train step: a parameter or gradient is not float32")
    ref = train_step_state(plain, batch, state)
    f32 = train_step_state(plain32, batch, state)
    plain32.net.double()
    truth = train_step_state(plain32, {k: v.double() for k, v in batch.items()}, state)
    plain32.net.float()
    for k, v in got.items():
        if not torch.isfinite(v).all():
            fail(f"BAT bf16 train step: {k} not finite on the kernel path")
    (lk, gk), (lp, gp), (lf, gf) = (loss_and_grad_errs(x, truth) for x in (got, ref, f32))
    bad = []
    for k in lk:
        lim = max(BF16_STEP_FACTOR * lp[k], BF16_LOSS_FLOOR)
        print(f"  BAT bf16 B=16 {k}: rel err vs float64 kernel path {lk[k]:.3e} plain bf16 "
              f"{lp[k]:.3e} f32 {lf[k]:.3e} (limit {lim:.3e})")
        if lk[k] > lim:
            bad.append(k)
    lim = max(BF16_STEP_FACTOR * gp, BF16_GRAD_FLOOR)
    print(f"  BAT bf16 B=16: rel err vs float64 of all gradients together: kernel path {gk:.3e} "
          f"plain bf16 {gp:.3e} f32 {gf:.3e} (limit {lim:.3e})", flush=True)
    if bad or gk > lim:
        fail(f"BAT bf16 train step: {bad or 'the gradients'} further from float64 than the bound")
    if len(calls) != 4 or any("g" not in rec for rec in calls):
        fail(f"BAT bf16 train step: {len(calls)} K6 calls recorded with their cotangents, "
             f"expected 4")
    plain16, plain32 = (k6_plain_leaf_grads(kern.net, calls, m) for m in (True, False))
    worst = [0.0, 0.0]
    for k, want in plain16.items():
        if k.endswith("bn.bias") or k.endswith("bn.weight") or k.endswith("dense.weight"):
            err = (got[k] - want).abs()
            scale = want.abs().max().item()
            e = (err.max().item() / scale, err.mean().item() / scale)
            err32 = (plain32[k] - want).abs()
            c = (err32.max().item() / scale, err32.mean().item() / scale)
            ok = e[0] <= K6_LEAF_MAX_REL and e[1] <= K6_LEAF_MEAN_REL
            control = c[0] > K6_LEAF_MAX_REL or c[1] > K6_LEAF_MEAN_REL
            print(f"  BAT bf16 B=16 {k[5:]}: kernel path against the plain bf16 K6 backward at "
                  f"the step's K6 inputs: max {e[0]:.2e} mean {e[1]:.2e} of max|plain| {scale:.3e} "
                  f"{'ok' if ok else 'OUTSIDE'}; f32 control max {c[0]:.2e} mean {c[1]:.2e} "
                  f"{'outside: ok' if control else 'INSIDE'}")
            worst = [max(worst[0], e[0]), max(worst[1], e[1])]
            if not (ok and control):
                bad.append(k)
    print(f"  BAT bf16 B=16: the K6 layers' 18 leaves within max {worst[0]:.2e} / mean "
          f"{worst[1]:.2e} of max|plain| (limits {K6_LEAF_MAX_REL:.2e} / {K6_LEAF_MEAN_REL:.2e})",
          flush=True)
    if bad:
        fail(f"BAT bf16 train step: K6 leaves {bad} not held to the plain bf16 K6")

    host = kern.device_batch(train_batch(cfg, TRAIN_B, SEED))
    kern32, _ = make_model(matching_cfg("bat"), fused_eval=True, variables=variables)
    times = {}
    for what, model in (("f32", kern32), ("bf16", kern), ("f32 again", kern32)):
        opt, sch = make_optimizer(model.config, model.net.parameters(), 100)
        times[what] = step_time(model, host, opt, sch, card, f"BAT B={TRAIN_B} {what}")
    busy32 = min(times["f32"]["busy_ms"], times["f32 again"]["busy_ms"])
    busy = f"{times['bf16']['busy_ms'] / busy32:.3f}x" if busy32 > 0 else "not measured"
    print(f"  BAT bf16 step against the f32 step (same call): "
          f"{times['bf16']['ms'] / min(times['f32']['ms'], times['f32 again']['ms']):.3f}x wall, "
          f"{busy} device busy [{card}]", flush=True)
    del kern32, plain, plain32

    fcfg = matching_cfg("bat", bf16=True, syn_num_tracklets=8, tensorboard=False)
    val = get_dataset(matching_cfg("bat", syn_num_tracklets=1), "test", "test")
    sampler = get_dataset(fcfg, "train_siamese", "train")
    reset_training_counts()
    fit_run(kern, fcfg, sampler, val, card, "BAT bf16")
    n = (k6.bf16_fwd_launches, k6.bf16_bwd_launches)
    print(f"launches in the bf16 fit run: K6 bf16 forward {n[0]} backward {n[1]}", flush=True)
    if n != (4 * 6, 4 * 6):
        fail(f"bf16 fit: K6 bf16 launches {n}, expected 24 / 24 (4 a step)")
    print(f"phase 20 ok in {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(fwd=n[0], bwd=n[1])


def m2_train_state(model, batch, state) -> dict:
    """Loss terms and gradients of one M2 train step from `state`."""
    import torch

    model.net.load_state_dict(state)
    model.net.zero_grad(set_to_none=True)
    losses = model.loss(batch, model.apply_train(batch))
    losses["loss_total"].backward()
    torch.cuda.synchronize()
    out = {f"loss {k}": v.detach().double().reshape(1) for k, v in losses.items()
           if not k.startswith("acc_")}
    out.update({f"grad {k}": p.grad.detach().double() for k, p in model.net.named_parameters()})
    return out


def m2_train_phase(card: str) -> None:
    """Phase 21: M2-Track training at cfgs/M2_track_kitti.yaml's widths on the
    synthetic dataset, in f32 and in bf16: the B = 16 step against the
    plain path in float64, the B = 100 step's time on a prebuilt batch, and
    Trainer.fit validating on M2ScanTracker."""
    import torch

    from open3dsot_tpu_torch.config import load_config
    from open3dsot_tpu_torch.data import get_dataset
    from open3dsot_tpu_torch.data.loader import collate
    from open3dsot_tpu_torch.train.optim import make_optimizer

    import numpy as np

    t0 = time.perf_counter()
    over = dict(dataset="synthetic", syn_num_tracklets=8, syn_tracklet_len=16, seed=SEED,
                category_name="Car", tensorboard=False)
    cfg32 = load_config(str(ROOT / M2_CFG), over)
    cfg16 = load_config(str(ROOT / M2_CFG), dict(over, bf16=True))
    m32, variables = make_model(cfg32, fused_eval=True)
    m16, _ = make_model(cfg16, fused_eval=True, variables=variables)
    sampler = get_dataset(cfg32, "train_motion", "train")
    np.random.seed(SEED)
    t1 = time.perf_counter()
    host = collate([sampler[i] for i in range(M2_TRAIN_B)])
    host_s = time.perf_counter() - t1
    print(f"  M2 motion samples: {M2_TRAIN_B} built in {host_s * 1e3:.1f} ms; points "
          f"{host['points'].shape}", flush=True)
    b16 = m32.device_batch({k: v[:16] for k, v in host.items()})
    state = {k: v.clone() for k, v in m32.net.state_dict().items()}
    got32 = m2_train_state(m32, b16, state)
    got16 = m2_train_state(m16, b16, state)
    m32.net.double()
    truth = m2_train_state(m32, {k: v.double() if v.is_floating_point() else v
                                 for k, v in b16.items()}, state)
    m32.net.float()
    m32.net.load_state_dict(state)
    (l32, g32), (l16, g16) = (loss_and_grad_errs(x, truth) for x in (got32, got16))
    for k in l32:
        print(f"  M2 B=16 {k}: rel err vs float64 f32 {l32[k]:.3e} bf16 {l16[k]:.3e}")
    print(f"  M2 B=16: rel err vs float64 of all gradients together: f32 {g32:.3e} bf16 "
          f"{g16:.3e} (f32 limits: loss terms {M2_LOSS_RTOL}, gradients {M2_GRAD_RTOL})",
          flush=True)
    if max(l32.values()) > M2_LOSS_RTOL or g32 > M2_GRAD_RTOL:
        fail("M2 f32 train step further from float64 than its bound")
    for x in (got16, got32):
        if not all(torch.isfinite(v).all() for v in x.values()):
            fail("M2 train step: a loss term or gradient is not finite")
    batch = m32.device_batch(host)
    for what, model in (("f32", m32), ("bf16", m16)):
        opt, sch = make_optimizer(model.config, model.net.parameters(), 100)
        step_time(model, batch, opt, sch, card, f"M2 B={M2_TRAIN_B} {what}")
    val = get_dataset(load_config(str(ROOT / M2_CFG), dict(over, syn_num_tracklets=1)), "test",
                      "test")
    for cfg, model, what in ((cfg32, m32, "M2 f32"), (cfg16, m16, "M2 bf16")):
        fit_run(model, cfg, get_dataset(cfg, "train_motion", "train"), val, card, what)
    print(f"phase 21 ok in {time.perf_counter() - t0:.1f} s", flush=True)


# --- 22. training with samples built on the card ------------------------------

# Steps/s of the host-sampler fit runs of phases 13, 20 and 21 in this run,
# printed beside phase 22's device-sampler runs (by fit_run's `what`).
FIT_RATES: dict = {}
BUILD_ATOL = 1e-5  # the card's build against the CPU's (tests/test_torch_device_sampler.py's)
PHASE22_LOG = ROOT / "chiprun_out" / "phase22.txt"
CARD_DEVICE = "cuda"  # phase 22's device ("cpu" in a rehearsal on the CPU)


def say(line: str) -> None:
    """Print a phase 22 line and keep it under chiprun_out/, so that the whole
    of phase 22's report survives when only the end of stdout is kept."""
    print(line, flush=True)
    PHASE22_LOG.parent.mkdir(exist_ok=True)
    with open(PHASE22_LOG, "a") as fh:
        fh.write(line + "\n")


def draws_on_card(card: str) -> None:
    """22a: the threefry draws on the card equal the CPU's (normal within
    prng.NORMAL_ULPS), with a key of Python ints and a (B,) key on the card."""
    import numpy as np
    import torch

    from open3dsot_tpu_torch.utils import prng

    key = prng.fold_in(prng.prng_key(SEED + 1), 12345)
    rows = torch.arange(1, 101).reshape(100, 1) * 700
    for name, draw in (
            ("split", lambda dev: torch.stack([torch.stack(k) for k in prng.split(
                tuple(torch.tensor(w, device=dev) for w in key), 7)])),
            ("bits", lambda dev: prng.bits(key, (100, 1024), device=dev)),
            ("randint per-row maxval", lambda dev: prng.randint(key, (100, 1024), 0, rows.to(dev))),
            ("bernoulli", lambda dev: prng.bernoulli(key, 0.5, (100, 64), device=dev)),
            ("uniform", lambda dev: prng.uniform(key, (100, 2048), -0.3, 0.3, device=dev)),
            ("uniform of (B,) keys", lambda dev: prng.uniform(
                prng.fold_in(prng.prng_key(SEED), torch.arange(100, device=dev)), (64,))),
            ("normal", lambda dev: prng.normal(key, (100, 2048), device=dev))):
        want, got = draw("cpu"), draw(CARD_DEVICE).cpu()
        if got.dtype == torch.float32:
            ulps = (got.view(torch.int32).long() - want.view(torch.int32).long()).abs().max().item()
        else:
            ulps = 0 if torch.equal(got, want) else -1
        bound = prng.NORMAL_ULPS if name == "normal" else 0
        say(f"  22a draw {name} {tuple(got.shape)}: card against CPU, max {ulps} ulps "
            f"(bound {bound})")
        if not 0 <= ulps <= bound:
            fail(f"draw {name} on the card differs from the CPU's")


def build_gaps(ds_mod):
    """Make the builder record, per crop, each row's smallest distance from
    a valid raw point to the crop boundary; -> (the list, restore)."""
    import torch

    margins, crop = [], ds_mod._crop

    def recording(pts, valid, box, half, A=None):
        local, ok = crop(pts, valid, box, half, A=A)
        gap = (local.abs() - half[:, None, :]).abs().amin(dim=-1)
        margins.append(torch.where(valid, gap, float("inf")).amin(dim=-1).cpu())
        return local, ok

    ds_mod._crop = recording
    return margins, lambda: setattr(ds_mod, "_crop", crop)


def face_flips(got, want, points, box4, wlh, factor: float, what: str) -> int:
    """Labels that differ must sit within BUILD_ATOL of their box's faces."""
    from open3dsot_tpu_torch.geometry import rigid

    flips = got != want
    if flips.any():
        local = rigid.remove_transform_points(points, box4)
        half = (wlh[:, [1, 0, 2]] * (factor / 2))[:, None, :]
        gap = (local.abs() - half).abs().amin(dim=-1)[flips].max().item()
        if gap > BUILD_ATOL:
            fail(f"build {what}: a label differs {gap:.3e} from its box's faces")
    return int(flips.sum())


def compare_build(kind: str, cfg, got: dict, want: dict, near) -> str:
    """The card's build (on the CPU now) against the CPU's, rows whose crop
    boundary passes within BUILD_ATOL of a raw point aside."""
    import numpy as np
    import torch

    keep = ~near
    g = {k: v[keep] for k, v in got.items()}
    w = {k: v[keep] for k, v in want.items()}
    rad = (lambda t: t * (np.pi / 180.0)) if cfg.degrees else (lambda t: t)
    flips = 0
    if kind == "motion":
        n = cfg.point_sample_size
        pts = g["points"]
        box = torch.cat([g["box_label"][:, :3], rad(g["box_label"][:, 3:])], -1)
        prev = torch.cat([g["box_label_prev"][:, :3], rad(g["box_label_prev"][:, 3:])], -1)
        flips += face_flips(g["seg_label"][:, :n], w["seg_label"][:, :n], pts[:, :n, :3], prev,
                            g["bbox_size"], 1.25, "seg_label prev")
        flips += face_flips(g["seg_label"][:, n:], w["seg_label"][:, n:], pts[:, n:, :3], box,
                            g["bbox_size"], 1.25, "seg_label this")
        flips += face_flips(pts[:, :n, 4], w["points"][:, :n, 4], pts[:, :n, :3],
                            torch.zeros_like(box), g["bbox_size"], 1.25, "seg_mask_prev")
        if not torch.equal(g["motion_state_label"], w["motion_state_label"]):
            fail("build motion: motion_state_label differs")
        close = {"points xyz": (pts[..., :3], w["points"][..., :3])}
        close.update({k: (g[k], w[k]) for k in ("box_label", "box_label_prev", "motion_label",
                                                 "prev_bc", "this_bc", "candidate_bc")})
    else:
        box = torch.cat([g["box_label"][:, :3], rad(g["box_label"][:, 3:])], -1)
        flips += face_flips(g["seg_label"], w["seg_label"], g["search_points"], box,
                            g["bbox_size"], 1.0, "seg_label")
        close = {k: (g[k], w[k]) for k in ("template_points", "search_points", "box_label",
                                           "points2cc_dist_t", "points2cc_dist_s")}
    for k in got:
        if got[k].dtype != want[k].dtype or got[k].shape != want[k].shape:
            fail(f"build {kind} {k}: {got[k].dtype} {tuple(got[k].shape)} on the card, "
                 f"{want[k].dtype} {tuple(want[k].shape)} on the CPU")
    errs = {k: (a - b).abs().max().item() for k, (a, b) in close.items()}
    worst = max(errs.values())
    if not worst <= BUILD_ATOL:
        fail(f"build {kind}: {errs} from the CPU's (atol {BUILD_ATOL})")
    return (f"max |diff| {worst:.3e} (atol {BUILD_ATOL}); {flips} labels differ, each on its "
            f"box's faces; {int(near.sum())} rows with a raw point within {BUILD_ATOL} of "
            f"the crop boundary set aside")


def build_on_card(kind: str, cfg, B: int, card: str) -> dict:
    """22b: one raw batch built on the card and on the CPU with one key; the
    card's build under torch.cuda.set_sync_debug_mode('error'); host ms of
    the raw batch, device ms of the build (events)."""
    import torch

    from open3dsot_tpu_torch.data import device_sampler as ds
    from open3dsot_tpu_torch.data import get_dataset
    from open3dsot_tpu_torch.data.loader import collate
    from open3dsot_tpu_torch.geometry.rigid import up_frame
    from open3dsot_tpu_torch.utils import prng

    raw_cls = ds.RawMotionSampler if kind == "motion" else ds.RawSiameseSampler
    sampler = raw_cls(get_dataset(cfg, cfg.train_type, "train").dataset, cfg,
                      max_raw_points=int(cfg.max_raw_points))
    idx = [(i * 7) % len(sampler) for i in range(B)]
    t0 = time.perf_counter()
    host = collate([sampler[i] for i in idx])
    if getattr(cfg, "transfer_quant", None):
        host = ds.pack_raw_batch(host)
    host_ms = (time.perf_counter() - t0) * 1e3
    def builder(dev):
        return ds.make_builder(cfg, cfg.train_type, A=up_frame(cfg.up_axis, device=dev))

    key = prng.fold_in(prng.prng_key(SEED + 1), 3)
    cpu_raw = {k: torch.from_numpy(v) for k, v in host.items()}
    margins, restore = build_gaps(ds)
    try:
        want = builder("cpu")(cpu_raw, key)
    finally:
        restore()
    near = torch.stack(margins).amin(dim=0) <= BUILD_ATOL
    pinned = {k: v.pin_memory() for k, v in cpu_raw.items()}
    build = builder(CARD_DEVICE)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # any host sync in the copy or the build raises
    try:
        raw = {k: v.to(CARD_DEVICE, non_blocking=True) for k, v in pinned.items()}
        out = build(raw, key)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = {k: v.cpu() for k, v in out.items()}
    verdict = compare_build(kind, cfg, got, want, near)
    ms = time_ms(lambda: build(raw, key), iters=10, repeats=5)
    what = f"{kind} B={B}{' int16' if getattr(cfg, 'transfer_quant', None) else ''}"
    say(f"  22b build {what} (P={cfg.max_raw_points}): card against CPU {verdict}; no host "
        f"sync; raw batch on the host {host_ms:.4f} ms, build on the card {ms:.4f} ms "
        f"(events) [{card}]")
    return dict(build_ms=ms, host_ms=host_ms)


def device_fit(model, cfg, sampler, card: str, what: str, beside: str, build_ms: float,
               steps: int = 4) -> dict:
    """22c/d: Trainer.fit with device_sampler: true, two epochs of `steps`
    steps, no validation; epoch 2's steps/s beside the host sampler's."""
    import numpy as np
    import torch

    from open3dsot_tpu_torch.train.trainer import Trainer

    work_dir = ROOT / "runs" / f"chip_smoke_device_sampler_{what.replace(' ', '_')}"
    history = Trainer(model, cfg, work_dir=str(work_dir)).fit(sampler, None, epochs=2,
                                                               steps_per_epoch=steps)
    torch.cuda.synchronize()
    last = history[-1]
    n2 = last["steps"] - history[0]["steps"]
    rate = n2 / last["time_s"]
    host = FIT_RATES.get(beside)
    host_s = f"{host:.3f} steps/s" if host else "not measured in this call"
    say(f"  22 fit {what} B={cfg.batch_size} device_sampler: {rate:.3f} steps/s, "
        f"{rate * cfg.batch_size:.2f} samples/s, waiting for the loader {last['data_wait_s']:.4f} "
        f"of {last['time_s']:.4f} s, build {build_ms:.4f} ms a batch on the card; host sampler "
        f"({beside}, this run): {host_s}; losses {[h['loss'] for h in history]} [{card}]")
    if not all(np.isfinite(h["loss"]) for h in history) or last["steps"] != 2 * steps:
        fail(f"device-sampler fit {what}: {history}")
    return last


def resume_on_card(m2_cfg, val, card: str) -> None:
    """22e: M2 f32 with the device sampler, 2 epochs then 2 more from a
    fresh Trainer and model, against 4 uninterrupted epochs, validating on
    the host loop: step, epoch and LR go on (the LR drops after epoch 2);
    under torch's deterministic algorithms (M2 trains through no hand
    kernel; BAT's K6 adds its da rows by float atomics) the weights equal
    the uninterrupted run's bit for bit; save_top_k 1 leaves one
    ckpt_ep*.pt."""
    import shutil

    import torch

    from open3dsot_tpu_torch.data import get_dataset
    from open3dsot_tpu_torch.train.trainer import Trainer

    cfg = m2_cfg.copy()
    cfg.save_top_k, cfg.val_tracker, cfg.lr_decay_step = 1, "host", 2
    sampler = get_dataset(cfg, "train_motion", "train")
    runs = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name, chunks in (("whole", [4]), ("chunked", [2, 4])):
            work_dir = ROOT / "runs" / f"chip_smoke_resume_{name}"
            shutil.rmtree(work_dir, ignore_errors=True)
            for i, epochs in enumerate(chunks):
                model, _ = make_model(cfg, fused_eval=True)
                resume = str(work_dir / "ckpt_last.pt") if i else None
                history = Trainer(model, cfg, work_dir=str(work_dir)).fit(
                    sampler, val, epochs=epochs, steps_per_epoch=2, resume_from=resume)
            runs[name] = (model, history, work_dir)
    finally:
        torch.use_deterministic_algorithms(False)
    (a, ha, da), (b, hb, db) = runs["whole"], runs["chunked"]
    ca = torch.load(da / "ckpt_last.pt", weights_only=True)
    cb = torch.load(db / "ckpt_last.pt", weights_only=True)
    sa, sb = a.net.state_dict(), b.net.state_dict()
    worst = max((sa[k].double() - v.double()).abs().max().item() for k, v in sb.items())
    lr = (ca["optimizer"]["param_groups"][0]["lr"], cb["optimizer"]["param_groups"][0]["lr"])
    tops = sorted(p.name for p in db.glob("ckpt_ep*.pt"))
    say(f"  22e resume M2 B={cfg.batch_size}: epochs {[h['epoch'] for h in hb]} steps "
        f"{[h['steps'] for h in hb]} (uninterrupted {[h['steps'] for h in ha[2:]]}); lr "
        f"{lr[1]:.3e} (uninterrupted {lr[0]:.3e}); weights and statistics against the "
        f"uninterrupted run: max |diff| {worst:.3e} (bound 0); losses "
        f"{[h['loss'] for h in hb]} against {[h['loss'] for h in ha[2:]]}; top-1 checkpoints "
        f"{tops} [{card}]")
    if [h["epoch"] for h in hb] != [2, 3] or [h["steps"] for h in hb] != [6, 8] or \
            (ca["step"], cb["step"]) != (8, 8) or lr[0] != lr[1] or lr[0] >= cfg.lr:
        fail("resume: the step, epoch or learning rate did not go on")
    if worst != 0 or [h["loss"] for h in hb] != [h["loss"] for h in ha[2:]]:
        fail(f"resume: the resumed run is {worst} from the uninterrupted one")
    if len(tops) != 1:
        fail(f"save_top_k 1 left {tops}")


def device_sampler_phase(card: str) -> None:
    """Phase 22: training with samples built on the card."""
    t0 = time.perf_counter()
    if PHASE22_LOG.exists():
        PHASE22_LOG.unlink()
    from open3dsot_tpu_torch.config import load_config
    from open3dsot_tpu_torch.data import get_dataset
    from open3dsot_tpu_torch.ops import sa_fused_train

    draws_on_card(card)
    over = dict(dataset="synthetic", syn_num_tracklets=8, syn_tracklet_len=16, seed=SEED,
                category_name="Car", tensorboard=False, device_sampler=True)
    m2 = load_config(str(ROOT / M2_CFG), over)
    m2q = load_config(str(ROOT / M2_CFG), dict(over, transfer_quant="int16"))
    bat = matching_cfg("bat", syn_num_tracklets=8, tensorboard=False, device_sampler=True)
    bat16 = matching_cfg("bat", syn_num_tracklets=8, tensorboard=False, device_sampler=True,
                         bf16=True)
    builds = {"m2": build_on_card("motion", m2, M2_TRAIN_B, card),
              "m2q": build_on_card("motion", m2q, M2_TRAIN_B, card),
              "bat": build_on_card("siamese", bat, TRAIN_B, card)}

    k6 = sa_fused_train.fused_sa_train_apply
    model, variables = make_model(bat, fused_eval=True)
    sampler = get_dataset(bat, "train_siamese", "train")
    for cfg, what, beside in ((bat, "BAT f32", "BAT f32"), (bat16, "BAT bf16", "BAT bf16")):
        if cfg is bat16:
            model, _ = make_model(bat16, fused_eval=True, variables=variables)
        reset_training_counts()
        device_fit(model, cfg, sampler, card, what, beside, builds["bat"]["build_ms"])
        n = training_counts()
        n16 = (k6.bf16_fwd_launches, k6.bf16_bwd_launches)
        say(f"  22c launches in the {what} fit (8 steps): K3 {n[0]} K6 forward {n[1]} backward "
            f"{n[2]} (bf16 {n16[0]} / {n16[1]}) K4 {n[3]}")
        k6_n = n16 if cfg is bat16 else n[1:3]
        if n[0] != 2 * 8 or tuple(k6_n) != (4 * 8, 4 * 8) or n[3] != 0:
            fail(f"{what} device-sampler fit: expected K3 2, K6 4 + 4 launches per step")
    # the same BAT f32 fit with the raw batches made by the loader's one
    # background thread alone (workers 0, not BAT_Car's 10): its Python
    # contends with the training loop's for the GIL
    serial = bat16.copy()
    serial.workers = 0
    device_fit(model, serial, sampler, card, "BAT bf16 workers 0", "BAT bf16",
               builds["bat"]["build_ms"])
    del model
    for cfg, what, build in ((m2, "M2 f32", "m2"), (m2q, "M2 f32 int16", "m2q")):
        model, _ = make_model(cfg, fused_eval=True)
        device_fit(model, cfg, get_dataset(cfg, "train_motion", "train"), card, what, "M2 f32",
                   builds[build]["build_ms"])
    serial = m2.copy()
    serial.workers = 0
    device_fit(model, serial, get_dataset(serial, "train_motion", "train"), card,
               "M2 f32 workers 0", "M2 f32", builds["m2"]["build_ms"])
    del model
    val = get_dataset(load_config(str(ROOT / M2_CFG), dict(over, syn_num_tracklets=1)), "test",
                      "test")
    resume_on_card(m2, val, card)
    dt = time.perf_counter() - t0
    say(f"phase 22 ok in {dt:.1f} s")


if __name__ == "__main__":
    main()
