#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (open3dsot_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line or a few each; any failure exits non-zero:
  1. environment: torch / CUDA versions, the card's name and power limit;
     fails without a CUDA device.
  2. build: the kernels of csrc/ with nvcc, one process per source, side by
     side (seconds, registers, spills).
  3. kernels K1/K2 against their plain PyTorch versions on the card at the
     M2 path's shapes (B = 1 and 16, N = 2048, f32), with times.
  4. the M2-Track forward on the card: kernel path vs plain path, and the
     launch counts of one forward (K1 = 3, K2 = 1).
  5. the M2 slice through its entry points: tracking.eval.evaluate_dataset
     on the synthetic dataset at point_sample_size 1024, and the CLI in a
     subprocess; Success/Precision, frames/s, launch counts, a short
     profiler window.
  6. K3 (FPS) against its plain version at the BAT path's shapes (B = 1
     and 16, N 1024 -> 512 and 512 -> 256), index for index, on a
     continuous cloud and on one with duplicated points (ties); times.
  7. K4 against sa_eval_plain at each of the seven SA calls of a BAT
     forward at cfgs/BAT_Car.yaml widths, on the inputs that forward gives
     them (B = 1 and 16); K5 (indices from the plain ball query) against
     K4; two ragged centroid counts; times.
  8. the BAT forward, kernel path vs plain path (B = 1 and 16), with the
     launches of one forward (K3 = 2, K4 = 7); P2B once (K4 = 7).
  9. the BAT slice through its entry points: evaluate_dataset on the
     synthetic dataset at BAT_Car widths (both paths), a profiler window,
     and the CLI on cfgs/BAT_synthetic.yaml.
 10. one JSON line of the kernels K1-K5, the card line, then the result line.

Weights are random, made with numpy from a seed in the JAX tree's shape
(open3dsot_tpu_torch.weights). Needs one card; no network.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 7
N_POINTS = 1024  # point_sample_size of cfgs/M2_track_kitti.yaml; N = 2 frames

# Tolerance of a kernel against its plain version: |k - p| <= ATOL_REL *
# max|p| + RTOL * |p|. Both sides are f32 with f32 accumulation and differ
# only in summation order (the kernel: one FMA chain per output over k;
# cuBLAS: blocked partial sums). That error grows like sqrt(K) * 2^-24 of
# the terms' size, about 1e-6 relative at K <= 1088 over five layers, so
# 1e-4 leaves two orders of magnitude of margin, while a wrong index, a
# masked row in the pool or a missed tile gives errors of order one.
RTOL = 1e-4
ATOL_REL = 1e-4
BOX_ATOL = 1e-3  # M2: two argmax gates and the rigid math; BAT/P2B: three SA layers,
                 # the xcorr and the vote SA before the proposal regression
MATCHING_CFG = {"bat": "cfgs/BAT_Car.yaml", "p2b": "cfgs/P2B_Car.yaml"}


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


def device_rows(fn) -> list:
    """Key averages of the device work that fn() runs, from a profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA") and dev_us(e) > 0]


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
    from open3dsot_tpu_torch.models import get_model
    from open3dsot_tpu_torch.weights import random_variables, state_dict_from_jax

    model = get_model(cfg.net_model)(cfg, device="cuda", fused_eval=fused_eval)
    if variables is None:
        variables = random_variables(model.net, SEED)
    model.net.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model, variables


def main() -> None:
    import numpy as np
    import torch

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
    from open3dsot_tpu_torch.ops._build import load_libraries

    # --- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    libs = load_libraries(["chain_fused", "fps", "sa_fused"])
    print(f"build: {len(libs)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)
    for lib in libs.values():
        print(f"  {lib.path.relative_to(ROOT)} in {lib.build_seconds:.1f} s "
              f"({'reused' if lib.build_seconds == 0 else 'nvcc sm_90a'})", flush=True)
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas: {line.strip()}")

    # --- 3. kernels vs plain at the main path's shapes --------------------
    cfg = bench_cfg()
    model, variables = make_model(cfg, fused_eval=True)
    seg, mini, mini2 = model.net.seg_pointnet, model.net.mini_pointnet, model.net.mini_pointnet2
    chain1, chain2 = seg.folded_chains()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    n = 2 * N_POINTS
    errs = {"K1": 0.0, "K2": 0.0}
    times = {}
    for B in (1, 16):
        cases = [("K1 seg mlp1 tap", chain1, 14, 1), ("K1 mini", mini.folded_chains(), 13, None),
                 ("K1 mini2", mini2.folded_chains(), 12, None)]
        for name, chain, c_in, tap_at in cases:
            x = torch.randn(B, n, c_in, device="cuda", generator=gen)
            k_tap, k_pool = cf.fused_pointnet_encoder(x, chain, tap_at=tap_at)
            p_tap, p_pool = cf.pointnet_encoder_plain(x, chain, tap_at)
            torch.cuda.synchronize()
            errs["K1"] = max(errs["K1"], compare(f"{name} B={B} pooled", k_pool, p_pool))
            if tap_at is not None:
                errs["K1"] = max(errs["K1"], compare(f"{name} B={B} tap", k_tap, p_tap))
            t_plain = time_ms(lambda: cf.pointnet_encoder_plain(x, chain, tap_at))
            t_kern = time_ms(lambda: cf.fused_pointnet_encoder(x, chain, tap_at=tap_at))
            t_plain2 = time_ms(lambda: cf.pointnet_encoder_plain(x, chain, tap_at))
            times[(name, B)] = (t_kern, min(t_plain, t_plain2))
            print(f"  time {name} B={B} N={n}: kernel {t_kern:.4f} ms plain "
                  f"{min(t_plain, t_plain2):.4f} ms [{card}]", flush=True)
            if tap_at is not None:
                tap, pooled = p_tap, p_pool
        k_out = cf.fused_seg_head(tap, pooled, chain2)
        p_out = cf.seg_head_plain(tap, pooled, chain2)
        torch.cuda.synchronize()
        errs["K2"] = max(errs["K2"], compare(f"K2 seg head B={B}", k_out, p_out))
        t_plain = time_ms(lambda: cf.seg_head_plain(tap, pooled, chain2))
        t_kern = time_ms(lambda: cf.fused_seg_head(tap, pooled, chain2))
        t_plain2 = time_ms(lambda: cf.seg_head_plain(tap, pooled, chain2))
        times[("K2 seg head", B)] = (t_kern, min(t_plain, t_plain2))
        print(f"  time K2 seg head B={B} N={n}: kernel {t_kern:.4f} ms plain "
              f"{min(t_plain, t_plain2):.4f} ms [{card}]", flush=True)
    # a ragged N (2000 = 31 tiles of 64 + 16): rows past N stay out of the max
    x = torch.randn(2, 2000, 14, device="cuda", generator=gen)
    k_tap, k_pool = cf.fused_pointnet_encoder(x, chain1, tap_at=1)
    p_tap, p_pool = cf.pointnet_encoder_plain(x, chain1, 1)
    errs["K1"] = max(errs["K1"], compare("K1 seg ragged N=2000 pooled", k_pool, p_pool))
    errs["K1"] = max(errs["K1"], compare("K1 seg ragged N=2000 tap", k_tap, p_tap))
    errs["K2"] = max(errs["K2"], compare("K2 ragged N=2000", cf.fused_seg_head(k_tap, k_pool, chain2),
                                         cf.seg_head_plain(p_tap, p_pool, chain2)))
    print("phase 3 ok: K1 and K2 within tolerance of their plain versions", flush=True)

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
        for k in ("estimation_boxes", "aux_estimation_boxes", "estimation_boxes_prev", "motion_pred"):
            e = (got[k] - want[k]).abs().max().item()
            print(f"  M2 B={B} {k}: max_abs_err {e:.3e} (atol {BOX_ATOL})")
            if not e <= BOX_ATOL:
                fail(f"M2 B={B} {k} differs from the plain path by {e}")
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
    matching_kernels = matching_phases(card)

    # --- 10. results ------------------------------------------------------
    kernels = [
        {"name": "K1 fused_pointnet_encoder", "route": "cuda",
         "source": "open3dsot_tpu_torch/csrc/chain_fused.cu",
         "replaces": "open3dsot_tpu/ops/chain_fused.py:150", "launches": k1_launches,
         "max_abs_err": errs["K1"], "ms": times[("K1 seg mlp1 tap", 1)][0],
         "plain_ms": times[("K1 seg mlp1 tap", 1)][1]},
        {"name": "K2 fused_seg_head", "route": "cuda",
         "source": "open3dsot_tpu_torch/csrc/chain_fused.cu",
         "replaces": "open3dsot_tpu/ops/chain_fused.py:217", "launches": k2_launches,
         "max_abs_err": errs["K2"], "ms": times[("K2 seg head", 1)][0],
         "plain_ms": times[("K2 seg head", 1)][1]},
    ] + matching_kernels
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


def check_k3(card: str) -> dict:
    """K3 against furthest_point_sample_plain, index for index."""
    import torch

    from open3dsot_tpu_torch.ops import sampling as smp

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    times = {}
    for B in (1, 16):
        for N, S in ((1024, 512), (512, 256)):
            x = torch.randn(B, N, 3, device="cuda", generator=gen) * 3
            dup = x[:, torch.randint(0, N // 8, (N,), device="cuda", generator=gen)].contiguous()
            for kind, cloud in (("continuous", x), ("duplicated points", dup)):
                got = smp.furthest_point_sample(cloud, S)
                want = smp.furthest_point_sample_plain(cloud, S)
                torch.cuda.synchronize()
                n_diff = int((got != want).sum())
                print(f"  K3 B={B} N={N}->{S} {kind}: "
                      f"{'indices equal' if n_diff == 0 else f'{n_diff} indices differ'}")
                if n_diff:
                    fail(f"K3 B={B} N={N}->{S} {kind}: {n_diff} indices differ from the plain version")
            t_p = time_ms(lambda: smp.furthest_point_sample_plain(x, S), iters=3, repeats=3)
            t_k = time_ms(lambda: smp.furthest_point_sample(x, S))
            t_p2 = time_ms(lambda: smp.furthest_point_sample_plain(x, S), iters=3, repeats=3)
            times[(B, N)] = (t_k, min(t_p, t_p2))
            d_k = device_ms(lambda: smp.furthest_point_sample(x, S))
            d_p = device_ms(lambda: smp.furthest_point_sample_plain(x, S), iters=2)
            print(f"  time K3 B={B} N={N}->{S}: kernel {t_k:.4f} ms plain {min(t_p, t_p2):.4f} ms; "
                  f"device time kernel {fmt_ms(d_k)} plain {fmt_ms(d_p)} [{card}]", flush=True)
    print("phase 6 ok: K3 indices equal to the plain version's", flush=True)
    return times


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


def check_k4_k5(calls, card: str):
    """K4 against sa_eval_plain and K5 against K4 at each SA call's inputs."""
    import torch

    from open3dsot_tpu_torch.ops import sa_fused as saf
    from open3dsot_tpu_torch.ops.neighbors import ball_query

    errs = {"K4": 0.0, "K5": 0.0}
    sums = {1: [0.0, 0.0, 0.0], 16: [0.0, 0.0, 0.0]}  # K4, K5, plain over one forward's calls
    dev_sums = {1: [0.0, 0.0, 0.0], 16: [0.0, 0.0, 0.0]}  # the same in device time
    for label, mod, xyz16, feats16, new16 in calls:
        kw = dict(radius=mod.radius, normalize_xyz=mod.normalize_xyz, use_xyz=mod.use_xyz)
        K, folded = mod.nsample, mod.folded_chains()
        for B in (1, 16):
            xyz, new = xyz16[:B].contiguous(), new16[:B].contiguous()
            feats = None if feats16 is None else feats16[:B].contiguous()
            shape = (f"{label} B={B} S={new.shape[1]} K={K} N={xyz.shape[1]} "
                     f"C={0 if feats is None else feats.shape[2]}->{folded[-1][0].shape[1]}")
            k4 = saf.fused_sa_apply(xyz, feats, new, None, folded, nsample=K, **kw)
            want = saf.sa_eval_plain(xyz, feats, new, None, folded, nsample=K, **kw)
            idx = ball_query(mod.radius, K, xyz, new)
            k5 = saf.fused_sa_apply(xyz, feats, new, idx, folded, **kw)
            torch.cuda.synchronize()
            errs["K4"] = max(errs["K4"], compare(f"K4 {shape}", k4, want))
            errs["K5"] = max(errs["K5"], compare(f"K5 {shape}", k5, want))
            compare(f"K5 vs K4 {shape}", k5, k4)
            t_p = time_ms(lambda: saf.sa_eval_plain(xyz, feats, new, None, folded, nsample=K, **kw))
            t_4 = time_ms(lambda: saf.fused_sa_apply(xyz, feats, new, None, folded, nsample=K, **kw))
            t_5 = time_ms(lambda: saf.fused_sa_apply(xyz, feats, new, idx, folded, **kw))
            t_p2 = time_ms(lambda: saf.sa_eval_plain(xyz, feats, new, None, folded, nsample=K, **kw))
            d = (device_ms(lambda: saf.fused_sa_apply(xyz, feats, new, None, folded, nsample=K, **kw)),
                 device_ms(lambda: saf.fused_sa_apply(xyz, feats, new, idx, folded, **kw)),
                 device_ms(lambda: saf.sa_eval_plain(xyz, feats, new, None, folded, nsample=K, **kw)))
            for i, v in enumerate((t_4, t_5, min(t_p, t_p2))):
                sums[B][i] += v
            for i, v in enumerate(d):
                dev_sums[B][i] = None if v is None or dev_sums[B][i] is None else dev_sums[B][i] + v
            print(f"  time {shape}: K4 {t_4:.4f} ms K5 {t_5:.4f} ms plain {min(t_p, t_p2):.4f} ms; "
                  f"device time K4 {fmt_ms(d[0])} K5 {fmt_ms(d[1])} plain {fmt_ms(d[2])} [{card}]",
                  flush=True)
    # ragged centroid counts: no tile divides them (the kernel masks the last tile)
    for label, mod, xyz, feats, new in (c for c in calls if c[0] in ("search SA0", "vote SA")):
        S = new.shape[1] - 3
        kw = dict(radius=mod.radius, normalize_xyz=mod.normalize_xyz, use_xyz=mod.use_xyz,
                  nsample=mod.nsample)
        k4 = saf.fused_sa_apply(xyz, feats, new[:, :S].contiguous(), None, mod.folded_chains(), **kw)
        want = saf.sa_eval_plain(xyz, feats, new[:, :S].contiguous(), None, mod.folded_chains(), **kw)
        errs["K4"] = max(errs["K4"], compare(f"K4 {label} B=16 ragged S={S}", k4, want))
    for B, (t_4, t_5, t_p) in sums.items():
        d_4, d_5, d_p = dev_sums[B]
        print(f"  time of one BAT forward's 7 SA calls, B={B}: K4 {t_4:.4f} ms K5 {t_5:.4f} ms "
              f"plain {t_p:.4f} ms; device time K4 {fmt_ms(d_4)} K5 {fmt_ms(d_5)} plain "
              f"{fmt_ms(d_p)} [{card}]", flush=True)
    print("phase 7 ok: K4 and K5 within tolerance at every SA call of the BAT path", flush=True)
    return errs, sums


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


def matching_phases(card: str) -> list:
    """Phases 6-9; returns the K3-K5 entries of the kernels line."""
    import numpy as np
    import torch

    from open3dsot_tpu_torch.data import get_dataset
    from open3dsot_tpu_torch.tracking.eval import evaluate_dataset

    k3_times = check_k3(card)

    cfg = matching_cfg("bat")
    model, variables = make_model(cfg, fused_eval=True)
    plain_model, _ = make_model(cfg, fused_eval=False, variables=variables)
    sampler = get_dataset(cfg, "test", "test")
    frames = matching_frames(model, sampler, 16)
    batch16 = {k: np.concatenate([f[k] for f in frames]) for k in frames[0]}
    errs, sa_sums = check_k4_k5(sa_calls(plain_model, batch16), card)

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
    profile_window(model, sampler, cfg, card, wall_us_per_frame=dt * 1e6 / n_frames)
    host_breakdown(model, sampler, card)

    cli = [sys.executable, "-m", "open3dsot_tpu_torch.main", "--cfg", "cfgs/BAT_synthetic.yaml",
           "--test", "--max_tracklets", "2", "--device", "cuda"]
    proc = subprocess.run(cli, cwd=ROOT, capture_output=True, text=True, timeout=600)
    last = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    print(f"cli (BAT): exit {proc.returncode}: {last}", flush=True)
    if proc.returncode != 0 or not last.startswith("success/test:"):
        fail(f"BAT CLI eval failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    print("phase 9 ok", flush=True)

    src = "open3dsot_tpu_torch/csrc/"
    return [
        {"name": "K3 furthest_point_sample", "route": "cuda", "source": src + "fps.cu",
         "replaces": "open3dsot_tpu/ops/fps_pallas.py:69", "launches": launches[0],
         "max_abs_err": 0.0, "ms": k3_times[(1, 1024)][0], "plain_ms": k3_times[(1, 1024)][1]},
        {"name": "K4 fused_sa_apply (ball query)", "route": "cuda", "source": src + "sa_fused.cu",
         "replaces": "open3dsot_tpu/ops/sa_fused.py:384", "launches": launches[1],
         "max_abs_err": errs["K4"], "ms": sa_sums[1][0], "plain_ms": sa_sums[1][2]},
        {"name": "K5 fused_sa_apply (idx given)", "route": "cuda", "source": src + "sa_fused.cu",
         "replaces": "open3dsot_tpu/ops/sa_fused.py:415", "launches": launches[2],
         "max_abs_err": errs["K5"], "ms": sa_sums[1][1], "plain_ms": sa_sums[1][2]},
    ]


def profile_window(model, sampler, cfg, card: str, wall_us_per_frame: float) -> None:
    """Device time by kernel over one tracklet of the host loop, and the
    device's idle share against the unprofiled run's time per frame."""
    from open3dsot_tpu_torch.tracking.eval import evaluate_dataset

    frames = len(sampler[0]) - 1
    rows = device_rows(lambda: evaluate_dataset(model, sampler, cfg, max_tracklets=1))
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


if __name__ == "__main__":
    main()
