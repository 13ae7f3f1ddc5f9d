#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (open3dsot_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --chain-times   # phases 1-3 only (K1/K2), no result line
    python3 chip_smoke.py --k6-times      # phases 1, 2 and 11 only (K6), no result line

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
 10. printed last, after phase 13: one JSON line of the kernels K1-K6 (each
     with its bound from this run's shapes), the card line, then the result
     line.
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

Weights are random, made with numpy from a seed in the JAX tree's shape
(open3dsot_tpu_torch.weights). Needs one card; no network.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
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
                 **_) -> dict:
    """One entry of the kernels line; work = (bytes, operations) of the timed call."""
    bound_ms, bound_by = (tc_bound_of if tensor_core else bound_of)(*work)
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
    name (`_ZN12_GLOBAL__N_112rowmm_kernelILi0ELi0EEEv...` -> rowmm_kernel<0,0>):
    the first length-prefixed identifier that ends in `_kernel`."""
    import re

    for m in re.finditer(r"\d+", mangled):
        digits = m.group()
        for i in range(len(digits)):  # a namespace tag's digits may run into the length
            name = mangled[m.end():m.end() + int(digits[i:])]
            if name.endswith("_kernel") and re.fullmatch(r"[A-Za-z_]\w*", name):
                t = re.match(r"I((?:Li-?\d+E)+)E", mangled[m.end() + len(name):])
                args = re.findall(r"Li(-?\d+)E", t.group(1)) if t else []
                return name + (f"<{','.join(args)}>" if args else "")
    return mangled


def sass_tensor_ops(lib_path) -> dict:
    """Tensor-core instructions (HMMA, HGMMA) per kernel in a library's SASS."""
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
            counts[fn] = 0
        elif fn is not None and re.search(r"\bHG?MMA\b", line):
            counts[fn] += 1
    return counts


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
    libs = load_libraries(["chain_fused"] if chain_only else ["sa_fused_train"] if k6_only else
                          ["chain_fused", "fps", "sa_fused", "sa_fused_train"])
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

    # --- 11.-13. BAT/P2B training -----------------------------------------
    training_kernels = training_phases(card, libs["sa_fused_train"])

    # --- 10. results ------------------------------------------------------
    kernels = [
        kernel_entry("K1 fused_pointnet_encoder", "chain_fused.cu",
                     "open3dsot_tpu/ops/chain_fused.py:150", k1_launches, chains["errs"]["K1"],
                     **chains["rows"][("K1 seg mlp1 tap", 1)]),
        kernel_entry("K2 fused_seg_head", "chain_fused.cu", "open3dsot_tpu/ops/chain_fused.py:217",
                     k2_launches, chains["errs"]["K2"], **chains["rows"][("K2 seg head", 1)]),
    ] + matching_kernels + training_kernels
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
    work = {"K4": [0, 0], "K5": [0, 0]}  # (bytes, operations) of one forward's calls at B = 1
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
            if B == 1:
                N, S, C = xyz.shape[1], new.shape[1], 0 if feats is None else feats.shape[2]
                (w1, _), (w2, _), (w3, _) = folded
                c1, c2, c3 = w1.shape[1], w2.shape[1], w3.shape[1]
                nbytes = 4 * (N * (3 + C) + S * 3 + sum(w.numel() + b.numel() for w, b in folded)
                              + S * c3)
                flops = 2 * N * w1.shape[0] * c1 + 2 * S * K * (c1 * c2 + c2 * c3)
                work["K4"][0] += nbytes
                work["K4"][1] += flops + 8 * S * N  # the ball query's squared distances
                work["K5"][0] += nbytes + 4 * S * K  # the indices
                work["K5"][1] += flops
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
    return errs, sums, work


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
    errs, sa_sums, sa_work = check_k4_k5(sa_calls(plain_model, batch16), card)

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

    n, S = 1024, 512  # K3's timed call: B = 1, N 1024 -> 512
    k3_work = (4 * (n * 3 + S), 9 * (S - 1) * n)  # per step and point: 3 sub, 3 mul, 2 add, min
    return [
        kernel_entry("K3 furthest_point_sample", "fps.cu", "open3dsot_tpu/ops/fps_pallas.py:69",
                     launches[0], 0.0, *k3_times[(1, 1024)], k3_work),
        kernel_entry("K4 fused_sa_apply (ball query)", "sa_fused.cu",
                     "open3dsot_tpu/ops/sa_fused.py:384", launches[1], errs["K4"], sa_sums[1][0],
                     sa_sums[1][2], sa_work["K4"]),
        kernel_entry("K5 fused_sa_apply (idx given)", "sa_fused.cu",
                     "open3dsot_tpu/ops/sa_fused.py:415", launches[2], errs["K5"], sa_sums[1][1],
                     sa_sums[1][2], sa_work["K5"]),
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


def k6_work(B: int, N: int, S: int, K: int, c1: int, c2: int, c3: int):
    """((bytes, operations) forward, (bytes, operations) backward) of one K6
    call. The forward writes the pre-BN grids y2, y3 that the backward reads;
    both read a, ct and idx (y1 = a[idx] + ct is gathered where it is read)."""
    R, cs = B * S * K, c1 + c2 + c3
    params = c1 * c2 + c2 + c2 * c3 + c3 + 2 * cs
    inputs = B * N * c1 + B * S * c1 + B * S * K  # a, ct, idx
    fwd = (4 * (inputs + params + B * S * c3 + 2 * cs + R * (c2 + c3)),
           2 * R * (c1 * c2 + c2 * c3) + 6 * R * cs + R * (c1 + c3))
    bwd = (4 * (B * S * c3 + inputs + R * (c2 + c3) + 2 * cs + params
                + B * N * c1 + B * S * c1 + c1 * c2 + c2 * c3 + 2 * cs),
           4 * R * (c1 * c2 + c2 * c3) + 12 * R * cs)
    return fwd, bwd


def k6_bwd_args(g, a, ct, idx, grids, stats, w2, w3, bn):
    """The backward's arguments. A K6 whose forward keeps y1 among its grids
    (the f32 CUDA-core version, timed by --k6-times on an older tree) takes the
    grids and the point count in place of a and ct."""
    if len(grids) == 3:
        return g, idx, grids, stats, w2, w3, bn, a.shape[1]
    return g, a, ct, idx, grids, stats, w2, w3, bn


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
        out_k, st_k, _ = k6.sa_train_fwd_kernel(a, ct, idx, w2, b2, w3, b3, bn)
        out_p, st_p, grids = k6.sa_train_fwd_plain(a, ct, idx, w2, b2, w3, b3, bn)
        g = torch.randn(B, S, c3, device=a.device, generator=gen)
        bargs = k6_bwd_args(g, a, ct, idx, grids, st_p, w2, w3, bn)
        bwd_k = k6.sa_train_bwd_kernel(*bargs)
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
        fns = (lambda: k6.sa_train_fwd_kernel(a, ct, idx, w2, b2, w3, b3, bn),
               lambda: k6.sa_train_fwd_plain(a, ct, idx, w2, b2, w3, b3, bn),
               lambda: k6.sa_train_bwd_kernel(*bargs),
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
            rows = device_rows(lambda: [f() for f in fns])
            total = sum(dev_us(e) for e in rows)
            print(f"  K6 {what}, the four calls at B={TRAIN_B}, device time by kernel: "
                  f"{total / 1e3:.4f} ms in all [{card}]", flush=True)
            for e in sorted(rows, key=lambda e: -dev_us(e)):
                name = e.key.replace("(anonymous namespace)::", "")
                print(f"    {dev_us(e) / 1e3:9.4f} ms {e.count:4d}x  {name[:100]}")
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
    from open3dsot_tpu_torch.train.trainer import Trainer, train_step

    cfg = matching_cfg("bat", syn_num_tracklets=8, tensorboard=False)
    model, _ = make_model(cfg, fused_eval=True)
    sampler = get_dataset(cfg, "train_siamese", "train")
    t0 = time.perf_counter()
    host = train_batch(cfg, TRAIN_B, SEED)
    host_s = time.perf_counter() - t0
    batch = model.device_batch(host)
    optimizer, scheduler = make_optimizer(cfg, model.net.parameters(), 100)
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
    print(f"train step B={TRAIN_B} at BAT_Car widths: {step_s * 1e3:.4f} ms per step "
          f"({1 / step_s:.3f} steps/s, {TRAIN_B / step_s:.2f} samples/s) on a prebuilt batch; "
          f"host sample building {host_s * 1e3:.4f} ms per batch of {TRAIN_B}; device busy "
          f"{busy_s * 1e3:.4f} ms per step, idle share {idle} [{card}]", flush=True)
    for e in sorted(rows, key=lambda e: -dev_us(e))[:8]:
        print(f"  {dev_us(e) / 3:10.0f} us per step {e.count // 3:5d}x  {e.key[:80]}")

    val = get_dataset(matching_cfg("bat", syn_num_tracklets=1), "test", "test")
    work_dir = ROOT / "runs" / "chip_smoke_fit"
    reset_training_counts()
    history = Trainer(model, cfg, work_dir=str(work_dir)).fit(sampler, val, epochs=2,
                                                               steps_per_epoch=4)
    torch.cuda.synchronize()
    launches = training_counts()
    last = history[-1]
    n2 = last["steps"] - history[0]["steps"]  # steps of epoch 2
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
