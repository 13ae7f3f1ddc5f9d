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
    python3 chip_smoke.py --real-data-times  # phases 1, 2 and 23 (KITTI data, checkpoints), no result
    python3 chip_smoke.py --distributed-times  # phases 1, 2 and 24 (multi-device runs), no result
    python3 chip_smoke.py --split-cards   # phases 1, 2, 24c and 25b over every card present, no result
    python3 chip_smoke.py --scan-split-times  # phases 1, 2 and 25 (split scans, native, layers), no result
    python3 chip_smoke.py --domain-times  # phases 1, 2 and 26 (the kernels' edge shapes), no result

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
     opens on K3 and in one that opens on a sleep kernel; with --k3-times
     the block sweep (every T from 32 to 1024 with PPT <= 32, both winner
     forms, at N = 512 to 16384, each checked).
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
 10. printed last, after phase 26: one JSON line of the kernels K1-K6 and
     the probes P1/P2, then K1/K2/K4/K5 and K6 (forward, backward) in the
     bf16 mode (each with its bound from this run's shapes), the card line,
     then the result line.
 11. K6 (training-mode SA, 3xTF32 on the tensor cores) forward and backward
     against their plain versions at the four K6 calls of a BAT train step at
     BAT_Car widths, on the inputs that step gives them (B = 16 and 50, and a
     ragged S); times by events and by profiler device time, both bounds (f32
     CUDA cores, 3xTF32 tensor cores) and the share; device time by kernel
     name over the four calls at B = 50, forward and backward apart; the
     HMMA/HGMMA count of K6's product kernels (fails if one has none). The
     backward again under torch's deterministic algorithms (da summed in a
     fixed order): two calls equal bit for bit, dct, dW and dgamma/dbeta
     equal to the atomics path's, da within the tolerance of the plain
     version and of the atomics path, and its time at B = 16 and 50.
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
     events behind a queued sleep, the bound at 989 TFLOP/s bf16; the
     ordered da as phase 11 holds it (within the bf16 tolerance); device
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
     on; weights bit for bit), save_top_k 1 leaves one ckpt_ep*.pt; then BAT
     in f32 and in bf16 the same way, f32 also run twice for 8 steps
     (weights bit for bit), every K6 backward with its ordered da (K6's
     `ordered_bwd_launches`). Its lines also go to chiprun_out/phase22.txt.
 23. KITTI-format data and released checkpoints (`--real-data-times` alone):
     a KITTI tracking layout in a temporary directory (velodyne/, label_02/,
     calib/; the test split's scenes 0019 and 0020, 40 HDL-64E sweeps of
     about 120000 points each, three Cars driving through each scene), and
     checkpoints in the reference's Lightning key layout of M2-Track
     (cfgs/M2_track_kitti.yaml, class Car) and BAT (cfgs/BAT_Car.yaml) at
     their widths: the seeded weights with the Dense biases torch suppresses
     at zero, written by export_torch.save_checkpoint against
     reference_layout.lightning_template and imported back bit for bit. In
     subprocesses, as `python -m` runs them: eval_released_ckpt --tracker
     scan (M2; K1/K2 launched) and --tracker host (BAT; K3/K4 launched), each
     held to the same eval in this process on the exported weights; main
     --tracker scan --eval_prep_cache, cold then warm (the same
     Success/Precision; the warm run packs no batch on the host), and
     --save_results (read_results: one record a tracklet, boxes equal to the
     tracker's). Lines: the dataset's load seconds, frames/s of each eval
     (cold and warm), the store's and the results file's MB. Its lines also
     go to chiprun_out/phase23.txt.
 24. multi-device runs (parallel/distributed.py) on the one card: (a) a
     world of one under NCCL (an all_reduce of a card tensor), where K6's
     staged entries (csrc/k6_common.cuh, Staging), f32 and bf16, equal the
     single call bit for bit at the four K6 calls of a BAT train step (B =
     50; the backward with its da in a fixed order), are held to the plain
     versions (phases 11 and 19's tolerances) and timed against the single
     call in turns and against the plain versions, and the host syncs the
     stages add are counted by torch's sync debug mode ('error'); (b) a
     two-rank gloo world with CUDA tensors (this script again,
     `--rank-worker`; the ranks share cuda:0 on a one-card host): the M2
     and BAT scan evals and the M2 host loop sharded over the ranks (4
     tracklets x 8 frames) equal to the one-process evals; a BAT_Car train
     step on 16 samples (8 a rank) with global statistics in f32 and bf16
     and with per-device statistics in f32, K6 launched 4 + 4 times a rank,
     staged in the global modes; the f32 steps against the one-process step
     on the global batch (per-device: the mean of the two half steps): loss
     terms within 1e-3, the whole gradient within 0.1 and the running
     statistics within 1e-3 (norm-relative), the per-device gradient held
     to be more than 0.1 from the global one; the bf16 step held to finite
     losses and a finite, non-zero gradient and read, not held, against the
     one-process bf16 step, that step run again and the f32 step (loss
     terms, gradient by module, the discrete choices that part: ball
     queries, kNN, objectness labels); K6 staged over the two ranks at the
     four calls (16 samples): each rank's statistics the global batch's,
     its rows of out, da and dct the single call's, dW and dgamma / dbeta
     summed over the ranks the single call's, and (read) the maxima whose
     neighbour the ranks' statistics change; (c) the M2 and BAT online
     pools of 16 split over every card (over [cuda:0, cuda:0] on one card)
     against unsplit trackers of their parts' slots, bit for bit, and on
     several cards a tracker put on the last card against cuda:0's
     (`--split-cards` runs this part alone); (d) bf16 online M2 and BAT
     trackers (B = 8) against the bf16 scan trackers and their bundles
     against the live trackers, bit for bit. The kernels line gains the
     staged K6 rows. Its lines also go to chiprun_out/phase24.txt.
 25. the scan trackers split over cards in one process (`devices=`, JAX
     `mesh=`), the native host library and the rest of the layer library:
     (a) M2 at cfgs/M2_track_kitti.yaml's widths in f32 and bf16, BAT_Car
     and P2B_Car (f32), B = 16 tracklets of 16 frames split over [cuda:0,
     cuda:0], graph path: each part's boxes bit for bit those of an
     unsplit tracker of 8 on its rows; the whole batch within 1e-4 at the
     first step and 1e-3 over the trajectory of an unsplit tracker of 16
     (the cross-B bounds); a batch of 15 padded to 16 and 15 trajectories
     back; evaluate_dataset_scan on a fresh split tracker from launch
     counts of 0: Success/Precision equal to the parts' unsplit trackers',
     read against an unsplit tracker of 16, each part's launches a replay
     (M2 K1 3 / K2 1, BAT K3 2 / K4 7, P2B K4 7); no host sync from the
     pinned rows to the boxes; frames/s split and unsplit (a reading); (b)
     with several cards (`--split-cards`), M2 and BAT split over every card,
     16 tracklets a card, each part equal to an unsplit tracker on cuda:0,
     and M2's frames/s over the cards against one card; (c) the native
     library (open3dsot_tpu_torch/native, built with g++ in _build/): its
     int16 encoder bit for bit numpy's on an M2 scan batch and both timed,
     the int16 batch's host packing both ways, and BAT's host loop on the
     KITTI-format sweeps of phase 23 (three tracklets) with
     OPEN3DSOT_TPU_NATIVE 1 and 0 (frames/s, native crops counted,
     Success/Precision); (d) SetAbstractionMSG, SetAbstractionAll,
     FeaturePropagation, FlowEmbedding and PointNetSetUpConv at small
     widths on the card against the CPU, eval and training forward. Its
     lines also go to chiprun_out/phase25.txt.
 26. the shapes beyond the shipped configs that the Pallas kernels take,
     each on a hand kernel against its plain version at its phase's
     tolerance, with the launch counts that show which kernel ran: (a) K6
     forward and backward, f32 and bf16, at widths 512-512-512 and 30-50-70
     (B 4, N 256, S 64, K 32), at 512 in f32 also the ordered da and the
     staged entries in a world of one, and at 8-8-8 with B 2048, S 2100, K
     8 (more partial sums than a grid's y holds; its backward held to
     float64, f32 as phase 12 holds a step, bf16 at 10x the plain bf16
     path's distance); (b) K4 in both modes at nsample 128 (the rows
     path), at 512-512-1024, at 30-50-70 and at 64-1536-128 (the rows path
     in both modes), and K5 past one tile with an index out of range (its
     centroid NaN); (c) K1/K2 in both modes
     with a tap of 60 (K2's first width 36) and a 2048-wide layer, and with
     a 4096-wide layer's input streamed; (d) K3 at N = 65536, npoint 1024, B
     = 2 (a cluster of blocks), index for index; (e) the model-level paths:
     a BAT SetAbstraction in training at width 512 (K6) against its plain
     path, and one in eval at nsample 128 on clouds of 65536 points (K3's
     cluster, K4's rows path), f32 and bf16; (f) K4 at B = 16 over BAT's
     seven SA calls and K6 at B = 50 over a train step's four calls on the
     shipped widths, device time by queued events, beside PERF.md's. One
     line a shape: kernel and plain times, the bound, the card. The kernels
     line gains the rows of these paths. Its lines also go to
     chiprun_out/phase26.txt.

Weights are random, made with numpy from a seed in the JAX tree's shape
(open3dsot_tpu_torch.weights). Needs one card; no network.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
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
# phases 11 and 19: K6's backward with the ordered da, {B: [events ms, device ms]}
# over the four calls, by mode
K6_ORDERED = {}
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
    real_only = "--real-data-times" in args
    dist_only = "--distributed-times" in args
    split_only = "--split-cards" in args
    scan_split_only = "--scan-split-times" in args
    domain_only = "--domain-times" in args
    if "--rank-worker" in args:  # a rank of phase 24's two-rank world
        rank_worker(args[args.index("--rank-worker") + 1])
        return
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
                          ["chain_fused", "fps", "sa_fused"] if online_only or rates_only
                          or split_only else
                          bf16_eval if bf16_only else
                          ["chain_fused", "chain_fused_bf16", "fps", "sa_fused"]
                          if scan_split_only else
                          [n for n in bf16_eval if n in SIGNATURES] if breakdown_only else
                          ["sa_fused_train"] if k6_only else
                          ["sa_fused_train", "sa_fused_train_bf16"] if k6_bf16_only else
                          ["fps", "sa_fused", "sa_fused_train", "sa_fused_train_bf16"]
                          if sampler_only else
                          ["chain_fused", "fps", "sa_fused"] if real_only else
                          bf16_eval + ["sa_fused_train", "sa_fused_train_bf16"]
                          if train_only or dist_only else
                          ["sa_fused"] if k4_only else ["fps", "fps_floor"] if k3_only else
                          bf16_eval + ["sa_fused_train", "sa_fused_train_bf16"]
                          if domain_only else
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
    if real_only:
        real_data_phase(card)
        print("real data times done: phases 1, 2 and 23 only", flush=True)
        return
    if split_only:
        dist_online_split(card)
        scan_split_cards(card)
        print("split cards done: phases 1, 2, 24's online pool and 25's scan trackers over the "
              "cards only", flush=True)
        return
    if scan_split_only:
        scan_split_phase(card)
        print("scan split times done: phases 1, 2 and 25 only", flush=True)
        return
    if domain_only:
        for row in domain_phase(card):
            print(f"  26 kernels line row: {json.dumps(row)}", flush=True)
        print("domain times done: phases 1, 2 and 26 only", flush=True)
        return
    if dist_only:
        for row in distributed_phase(card):
            print(f"  24 kernels line row: {json.dumps(row)}", flush=True)
        print("distributed times done: phases 1, 2 and 24 only", flush=True)
        return
    if k4_only:
        matching_phases(card, libs["sa_fused"], k4_only=True)
        print("k4 times done: phases 1, 2 and 7 only", flush=True)
        return
    if k3_only:
        check_k3(card, sweep=True)
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

    # --- 23. KITTI-format data and Lightning checkpoints ---------------------------
    real_data_phase(card)

    # --- 24. multi-device runs: process groups, the staged K6, the split pool -------
    bf16_kernels.extend(distributed_phase(card))

    # --- 25. split scan trackers, the native host library, the layer library -------
    scan_split_phase(card)

    # --- 26. every shape the Pallas kernels take ----------------------------------------
    bf16_kernels.extend(domain_phase(card))
    replaces = "open3dsot_tpu/ops/sa_fused_train.py:608-776 (cdt bfloat16)"
    for what in ("fwd", "bwd"):
        bf16_kernels.append(kernel_entry(
            f"K6 fused_sa_train_apply ({'forward' if what == 'fwd' else 'backward'}, bf16)",
            "sa_fused_train_bf16.cu", replaces, k6b_launches[what], k6b["errs"][what],
            k6b["sums"][TRAIN_B][what], k6b["sums"][TRAIN_B][what + "_plain"],
            k6b["work"][TRAIN_B][0 if what == "fwd" else 1],
            library_ms=k6b["sums"][TRAIN_B][what + "_cublas"], peak=PEAK_BF16_FLOPS))
    for what, source in (("f32", "sa_fused_train.cu"), ("bf16", "sa_fused_train_bf16.cu")):
        o = K6_ORDERED[what]
        bf16_kernels.append(kernel_entry(
            f"K6 fused_sa_train_apply (backward, {what}, da in a fixed order)", source,
            "open3dsot_tpu/ops/sa_fused_train.py:709-776", o["launches"], o["err"],
            o[TRAIN_B][0], o["plain"], o["work"], tensor_core=what == "f32",
            peak=PEAK_BF16_FLOPS))

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


def check_k3(card: str, sweep: bool = False) -> dict:
    """Phase 6: K3 against furthest_point_sample_plain, index for index, at
    BAT's shapes and edge shapes; times against the bound and both skeleton
    floors; with `sweep` (--k3-times) the block sweep, which fps_block's
    choice comes from. On a tree from before K3's redesign (no fps_block: a
    parent run with --k3-times) only what that tree has."""
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
    if redesigned and sweep:
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


KNN_TIE_REL = 1e-5  # a kNN choice the paths may break either way: d2 gaps below this share


@contextlib.contextmanager
def xcorr_knn(replay=None):
    """Inside: each kNN of BAT's xcorr (models/xcorr.py, in BoxCloud space)
    appended to the yielded list as (query, ref, idx); with `replay` (such a
    list) the indices are taken from it instead of computed."""
    from open3dsot_tpu_torch.models import xcorr

    calls, computed = [], xcorr.knn

    def knn(query, ref, k):
        idx = computed(query, ref, k) if replay is None else replay[len(calls)][2]
        calls.append((query, ref, idx))
        return idx

    xcorr.knn = knn
    try:
        yield calls
    finally:
        xcorr.knn = computed


def knn_ties(what: str, kernel_calls, plain_calls) -> int:
    """The search points whose kNN the two paths chose otherwise; fails
    unless each is a tie at the paths' rounding: both pick k distinct
    points, and in the plain path's own distances every point only one of
    them picks lies within KNN_TIE_REL of its k-th nearest. -> the number of
    such points."""
    flips = 0
    for (_, _, ik), (q, r, ip) in zip(kernel_calls, plain_calls):
        k = ip.shape[-1]
        for b, n in (ik != ip).any(-1).nonzero().tolist():
            d2 = ((q[b, n][None].double() - r[b].double()) ** 2).sum(-1)
            mine, theirs = set(ip[b, n].tolist()), set(ik[b, n].tolist())
            kth = d2[ip[b, n].long()].max().item()
            rel = max(abs(d2[i].item() - kth) for i in mine ^ theirs) / max(kth, 1e-30)
            print(f"  {what}: the xcorr's kNN at search point ({b}, {n}) differs (kernel path "
                  f"{ik[b, n].tolist()}, plain {ip[b, n].tolist()}): the points only one path "
                  f"picks lie within {rel:.3e} of the k-th nearest d2", flush=True)
            if not (len(mine) == len(theirs) == k and rel <= KNN_TIE_REL):
                fail(f"{what}: the kNN choices differ beyond a tie ({rel})")
            flips += 1
    return flips


def check_matching_forward(model, plain_model, batch, what: str, want_launches, card: str,
                           timed: bool = True) -> None:
    """One forward on each path: launches, outputs, times. Where the xcorr's
    kNN breaks a tie otherwise on the two paths (knn_ties), the plain path
    runs again on the kernel path's kNN choices, and is held to it."""
    import torch

    reset_matching_counts()
    with xcorr_knn() as kernel_knn:
        got = model.apply(batch)
    torch.cuda.synchronize()
    launches = matching_counts()
    print(f"  {what}: one forward launched K3 {launches[0]}, K4 {launches[1]}, K5 {launches[2]}")
    if launches != want_launches:
        fail(f"{what}: launches {launches}, expected K3/K4/K5 = {want_launches}")
    with xcorr_knn() as plain_knn:
        want = plain_model.apply(batch)
    if knn_ties(what, kernel_knn, plain_knn):
        with xcorr_knn(replay=kernel_knn):
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


@contextlib.contextmanager
def deterministic():
    """torch.use_deterministic_algorithms(True) inside the block (warn_only:
    a torch op with no deterministic form warns): K6's backward then sums da
    in a fixed order."""
    import torch

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def check_ordered(label: str, bwd, atomic, da_close) -> float:
    """K6's backward under deterministic algorithms (its ordered da) against
    the same call with the flag off (`atomic`, its outputs): two calls give
    the same da bit for bit, every other output equals the atomics path's bit
    for bit, and da_close(name, da_ordered, da_atomic) holds da to the phase's
    tolerance (against the plain version too, by the caller). Returns da."""
    import torch

    from open3dsot_tpu_torch.ops import sa_fused_train as k6

    n0 = k6.fused_sa_train_apply.ordered_bwd_launches
    with deterministic():
        o1, o2 = bwd(), bwd()
    torch.cuda.synchronize()
    if k6.fused_sa_train_apply.ordered_bwd_launches - n0 != 2:
        fail(f"{label}: the backward did not take the ordered path under deterministic algorithms")
    if not torch.equal(o1[0], o2[0]):
        fail(f"{label}: the ordered da differs between two calls by "
             f"{(o1[0] - o2[0]).abs().max().item():.3e}")
    for i, name in enumerate(("dct", "dW2", "dW3")):
        if not torch.equal(o1[i + 1], atomic[i + 1]):
            fail(f"{label}: {name} of the ordered path differs from the atomics path's")
    if not torch.equal(torch.cat(o1[4]), torch.cat(atomic[4])):
        fail(f"{label}: dgamma, dbeta of the ordered path differ from the atomics path's")
    da_close(f"{label} da ordered against atomics", o1[0], atomic[0])
    print(f"  {label}: ordered da the same bit for bit in two calls; dct, dW, dgamma, dbeta "
          f"equal to the atomics path's", flush=True)
    return o1[0]


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
    # the ordered bwd: {B: [events ms, device ms]} over the four calls, its da's error
    ordered = dict({B: [0.0, 0.0] for B in K6_BATCHES}, err=0.0)
    work = {B: [[0, 0], [0, 0]] for B in K6_BATCHES}
    per_pass = {"forward": [], "backward": [], "backward ordered": []}  # kernel calls at TRAIN_B

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
        bwd_o = lambda: k6.sa_train_bwd_kernel(*bargs, packs)  # noqa: E731
        da_o = check_ordered(f"K6 bwd {shape}", bwd_o, bwd_k, compare)
        err_o = compare(f"K6 bwd {shape} da ordered", da_o, bwd_p[0])
        errs["bwd"] = max(errs["bwd"], err_o)
        ordered["err"] = max(ordered["err"], err_o)
        if not timed:
            return
        fns = (lambda: k6.sa_train_fwd_kernel(a, ct, idx, w2, b2, w3, b3, bn, packs),
               lambda: k6.sa_train_fwd_plain(a, ct, idx, w2, b2, w3, b3, bn),
               lambda: k6.sa_train_bwd_kernel(*bargs, packs),
               lambda: k6.sa_train_bwd_plain(*bargs))
        if B == TRAIN_B:
            per_pass["forward"].append(fns[0])
            per_pass["backward"].append(fns[2])
            per_pass["backward ordered"].append(bwd_o)
        with deterministic():
            t_o = min(time_ms(bwd_o, iters=5, repeats=5) for _ in range(2))
            d_o = device_ms(bwd_o, iters=3)
        ordered[B][0] += t_o
        ordered[B][1] = None if d_o is None or ordered[B][1] is None else ordered[B][1] + d_o
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
              f"{t[2]:.4f} ms (ordered da {t_o:.4f} ms) plain {t[3]:.4f} ms; device time fwd "
              f"{fmt_ms(d[0])} / {fmt_ms(d[1])}, bwd {fmt_ms(d[2])} (ordered {fmt_ms(d_o)}) / "
              f"{fmt_ms(d[3])} [{card}]", flush=True)

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
            if what.endswith("ordered"):
                with deterministic():
                    pass_breakdown(f"K6 {what}", fns, card)
            else:
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
        print(f"  K6 over one BAT train step's 4 calls, B={B}: {'; '.join(line)}; bwd with the "
              f"ordered da (deterministic algorithms) {ordered[B][0]:.4f} ms (device "
              f"{fmt_ms(ordered[B][1])}) [{card}]", flush=True)
    K6_ORDERED.setdefault("f32", {}).update(ordered, plain=sums[TRAIN_B][3], work=work[TRAIN_B][1])
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
    match = isinstance(getattr(tracker, "parts", [tracker])[0], OnlineMatchTracker)
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
    ordered = dict({B: [0.0, 0.0] for B in K6_BATCHES}, err=0.0)  # as check_k6's
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
        da_o = check_ordered(f"K6 bf16 bwd {shape}", bwd_k, gk,
                             lambda n, x, y: compare_bf16(n, x, y, gf[0], control=False))
        err_o = compare_bf16(f"K6 bf16 bwd {shape} da ordered", da_o, gp[0], gf[0])
        errs["bwd"] = max(errs["bwd"], err_o)
        ordered["err"] = max(ordered["err"], err_o)
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
        with deterministic():
            t_o = min(time_ms(bwd_k, iters=5, repeats=5) for _ in range(2))
            d_o = queued_ms(bwd_k, iters=3, repeats=3, sleep=BF16_SLEEP)
        ordered[B][0] += t_o
        ordered[B][1] = None if d_o is None or ordered[B][1] is None else ordered[B][1] + d_o
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
              f"{min(t['bwd'], t2['bwd']):.4f} ms (ordered da {t_o:.4f}, 3xTF32 "
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
        print(f"  K6 bf16 over one BAT train step's 4 calls, B={B}: {'; '.join(line)}; bwd with "
              f"the ordered da (deterministic algorithms) {ordered[B][0]:.4f} ms (device "
              f"{fmt_ms(ordered[B][1])}) [{card}]", flush=True)
    K6_ORDERED.setdefault("bf16", {}).update(ordered, plain=sums[TRAIN_B]["bwd_plain"],
                                             work=work[TRAIN_B][1])
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


def say(line: str, log: Path = None) -> None:
    """Print a phase 22 line (or one of the phase `log` names) and keep it
    under chiprun_out/, so that the whole of the phase's report survives when
    only the end of stdout is kept."""
    log = log or PHASE22_LOG
    print(line, flush=True)
    log.parent.mkdir(exist_ok=True)
    with open(log, "a") as fh:
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


def resume_on_card(cfg0, val, card: str, what: str, twice: bool = False) -> None:
    """22e: a model with the device sampler, 2 epochs then 2 more from a
    fresh Trainer and model, against 4 uninterrupted epochs (8 steps),
    validating on the host loop: step, epoch and LR go on (the LR drops after
    epoch 2); under torch's deterministic algorithms the weights equal the
    uninterrupted run's bit for bit (BAT's K6 then sums its da rows in a fixed
    order, not by float atomics), and with `twice` a second uninterrupted run
    equals the first; save_top_k 1 leaves one ckpt_ep*.pt."""
    import shutil

    import torch

    from open3dsot_tpu_torch.data import get_dataset
    from open3dsot_tpu_torch.train.trainer import Trainer

    cfg = cfg0.copy()
    cfg.save_top_k, cfg.val_tracker, cfg.lr_decay_step = 1, "host", 2
    sampler = get_dataset(cfg, cfg.train_type, "train")
    runs = {}
    plan = (("whole", [4]), ("chunked", [2, 4])) + ((("again", [4]),) if twice else ())
    with deterministic():
        for name, chunks in plan:
            work_dir = ROOT / "runs" / f"chip_smoke_resume_{what.replace(' ', '_')}_{name}"
            shutil.rmtree(work_dir, ignore_errors=True)
            for i, epochs in enumerate(chunks):
                model, _ = make_model(cfg, fused_eval=True)
                resume = str(work_dir / "ckpt_last.pt") if i else None
                history = Trainer(model, cfg, work_dir=str(work_dir)).fit(
                    sampler, val, epochs=epochs, steps_per_epoch=2, resume_from=resume)
            runs[name] = (model, history, work_dir)

    def apart(x, y) -> float:
        sx, sy = x.net.state_dict(), y.net.state_dict()
        return max((sx[k].double() - v.double()).abs().max().item() for k, v in sy.items())

    (a, ha, da), (b, hb, db) = runs["whole"], runs["chunked"]
    ca = torch.load(da / "ckpt_last.pt", weights_only=True)
    cb = torch.load(db / "ckpt_last.pt", weights_only=True)
    worst = apart(a, b)
    lr = (ca["optimizer"]["param_groups"][0]["lr"], cb["optimizer"]["param_groups"][0]["lr"])
    tops = sorted(p.name for p in db.glob("ckpt_ep*.pt"))
    say(f"  22e resume {what} B={cfg.batch_size}: epochs {[h['epoch'] for h in hb]} steps "
        f"{[h['steps'] for h in hb]} (uninterrupted {[h['steps'] for h in ha[2:]]}); lr "
        f"{lr[1]:.3e} (uninterrupted {lr[0]:.3e}); weights and statistics against the "
        f"uninterrupted run: max |diff| {worst:.3e} (bound 0); losses "
        f"{[h['loss'] for h in hb]} against {[h['loss'] for h in ha[2:]]}; top-1 checkpoints "
        f"{tops} [{card}]")
    if [h["epoch"] for h in hb] != [2, 3] or [h["steps"] for h in hb] != [6, 8] or \
            (ca["step"], cb["step"]) != (8, 8) or lr[0] != lr[1] or lr[0] >= cfg.lr:
        fail(f"resume {what}: the step, epoch or learning rate did not go on")
    if worst != 0 or [h["loss"] for h in hb] != [h["loss"] for h in ha[2:]]:
        fail(f"resume {what}: the resumed run is {worst} from the uninterrupted one")
    if len(tops) != 1:
        fail(f"save_top_k 1 left {tops}")
    if twice:
        c, hc, _ = runs["again"]
        again = apart(a, c)
        say(f"  22e {what}: two uninterrupted 8-step runs: weights and statistics max |diff| "
            f"{again:.3e} (bound 0); losses {[h['loss'] for h in hc]} against "
            f"{[h['loss'] for h in ha]}")
        if again != 0 or [h["loss"] for h in hc] != [h["loss"] for h in ha]:
            fail(f"{what}: two 8-step runs under deterministic algorithms are {again} apart")


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
    resume_on_card(m2, val, card, "M2")
    bat_val = get_dataset(matching_cfg("bat", syn_num_tracklets=1, tensorboard=False), "test",
                          "test")
    for cfg, what in ((bat, "f32"), (bat16, "bf16")):
        k6.ordered_bwd_launches = 0
        twice = what == "f32"
        resume_on_card(cfg, bat_val, card, f"BAT {what}", twice=twice)
        # two or three runs of 8 steps, 4 K6 backward calls a step, all ordered
        runs = 3 if twice else 2
        K6_ORDERED.setdefault(what, {})["launches"] = k6.ordered_bwd_launches
        say(f"  22e K6 backward launches with the ordered da, BAT {what}: "
            f"{k6.ordered_bwd_launches} (expected {runs * 8 * 4})")
        if k6.ordered_bwd_launches != runs * 8 * 4:
            fail("22e: BAT's K6 backward did not sum da in a fixed order in every step")
    dt = time.perf_counter() - t0
    say(f"phase 22 ok in {dt:.1f} s")


# --- phase 23: real-format data and released checkpoints ---------------------------

PHASE23_LOG = ROOT / "chiprun_out" / "phase23.txt"
REAL_SCENES = ("0019", "0020")  # KITTI's test split (data/kitti.py)
REAL_FRAMES = 40
# An HDL-64E sweep: 64 beams from +2.0 to -24.9 degrees of elevation, 2150
# azimuth steps (0.17 degrees), returns within 80 m: about 120000 points.
REAL_BEAMS, REAL_AZIMUTHS, REAL_RANGE, SENSOR_HEIGHT = 64, 2150, 80.0, 1.73
# velodyne -> camera of a KITTI calibration: the axes' permutation (x forward
# to z, y left to -x, z up to -y) and the sensors' offset
TR_VELO_CAM = ((0.0, -1.0, 0.0, 0.0), (0.0, 0.0, -1.0, -0.08), (1.0, 0.0, 0.0, -0.27))
CAR_WLH = (1.62, 3.88, 1.52)


def say23(line: str) -> None:
    say(line, PHASE23_LOG)


def hdl64_rays():
    """(directions (64 * REAL_AZIMUTHS, 3), the ground's range along each
    (inf for a ray at or above the horizon)), beam-major."""
    import numpy as np

    elev = np.deg2rad(np.linspace(2.0, -24.9, REAL_BEAMS))
    az = np.deg2rad(np.arange(REAL_AZIMUTHS) * (360.0 / REAL_AZIMUTHS))
    E, A = np.meshgrid(elev, az, indexing="ij")
    dirs = np.stack([np.cos(E) * np.cos(A), np.cos(E) * np.sin(A), np.sin(E)], -1).reshape(-1, 3)
    with np.errstate(divide="ignore"):
        ground = np.where(dirs[:, 2] < 0, SENSOR_HEIGHT / -dirs[:, 2], np.inf)
    return dirs, ground


def hdl64_sweep(cars, rng, rays):
    """One sweep from a sensor SENSOR_HEIGHT above flat ground: each ray's
    first return on a car (a box, slab test in its frame, over the azimuths
    that can reach it) or the ground, within REAL_RANGE, 1 cm of range noise;
    (N, 4) float32 with intensity. cars: (centre, yaw) in the velodyne frame."""
    import numpy as np

    dirs, ground = rays
    t = ground.copy()
    w, l, h = CAR_WLH
    half = np.array([l / 2, w / 2, h / 2])
    reach = float(np.linalg.norm(half))
    step = 2 * np.pi / REAL_AZIMUTHS
    beams = np.arange(REAL_BEAMS)[:, None] * REAL_AZIMUTHS
    for centre, yaw in cars:
        dist = float(np.hypot(centre[0], centre[1]))
        spread = np.arcsin(min(1.0, reach / dist)) + step
        mid = np.arctan2(centre[1], centre[0])
        cols = np.round((mid + np.arange(-spread, spread, step)) / step).astype(int)
        idx = (beams + cols[None] % REAL_AZIMUTHS).ravel()
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])  # box -> velodyne
        o, d = -(R.T @ centre), dirs[idx] @ R  # the ray origin and directions in the box frame
        with np.errstate(divide="ignore", invalid="ignore"):
            t1, t2 = (-half - o) / d, (half - o) / d
        near = np.nanmax(np.minimum(t1, t2), axis=1)
        far = np.nanmin(np.maximum(t1, t2), axis=1)
        hit = (far >= near) & (near > 0) & (near < t[idx])
        t[idx[hit]] = near[hit]
    keep = t < REAL_RANGE
    r = t[keep] + rng.normal(0.0, 0.01, int(keep.sum()))
    pts = dirs[keep] * r[:, None]
    return np.concatenate([pts, rng.uniform(0, 1, (len(pts), 1))], 1).astype(np.float32)


def write_real_kitti(root: Path, seed: int = SEED) -> dict:
    """KITTI's tracking layout under root (velodyne/, label_02/, calib/):
    scenes REAL_SCENES of REAL_FRAMES HDL-64E sweeps, three Cars driving
    through each, labelled in camera coordinates as KITTI labels them.
    Returns the points per frame."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rays = hdl64_rays()
    tr = np.array(TR_VELO_CAM)
    velo_to_cam = np.vstack([tr, [0, 0, 0, 1]])
    w, l, h = CAR_WLH
    counts = []
    for d in ("label_02", "calib"):
        (root / d).mkdir(parents=True, exist_ok=True)
    for k, scene in enumerate(REAL_SCENES):
        (root / "velodyne" / scene).mkdir(parents=True, exist_ok=True)
        with open(root / "calib" / f"{scene}.txt", "w") as f:
            f.write("P0: " + " ".join(["0.0"] * 12) + "\n")
            f.write("Tr_velo_cam " + " ".join(f"{v:.6e}" for v in tr.reshape(-1)) + "\n")
        # start (x, y) in m, yaw, speed in m a frame
        starts = [(8.0 + 2 * k, -6.0, 0.5, 0.25), (-12.0, 5.0 - k, -0.2, 0.3),
                  (15.0, 9.0, 3.0 + 0.1 * k, 0.2)]
        rows = []
        for fr in range(REAL_FRAMES):
            cars = []
            for tid, (x0, y0, yaw0, v) in enumerate(starts):
                yaw = yaw0 + 0.004 * fr
                centre = np.array([x0 + v * fr * np.cos(yaw), y0 + v * fr * np.sin(yaw),
                                   h / 2 - SENSOR_HEIGHT])
                cars.append((centre, yaw))
                cam = velo_to_cam @ np.append(centre, 1.0)
                ry = -yaw - np.pi / 2  # data/kitti.py's velodyne orientation inverted
                rows.append(f"{fr} {tid} Car 0 0 {-np.pi / 2:.2f} 100.00 150.00 200.00 250.00 "
                            f"{h:.2f} {w:.2f} {l:.2f} {cam[0]:.6f} {cam[1] + h / 2:.6f} "
                            f"{cam[2]:.6f} {ry:.6f}")
            rows.append(f"{fr} -1 DontCare -1 -1 -10 0 0 10 10 -1 -1 -1 -1000 -1000 -1000 -10")
            sweep = hdl64_sweep(cars, rng, rays)
            counts.append(len(sweep))
            sweep.tofile(root / "velodyne" / scene / f"{fr:06}.bin")
        (root / "label_02" / f"{scene}.txt").write_text("\n".join(rows) + "\n")
    return dict(points=counts)


# The entry points run in a fresh interpreter as `python -m` runs them
# (runpy, run_name "__main__"), several per process: each run's launches of
# K1-K4 by the wrappers' counters, its scan batches packed on the host
# (`_ScanTracker._prepare` calls) and the seconds of its dataset eval.
RUN_SCRIPT = r"""
import json, runpy, sys, time
import torch
from open3dsot_tpu_torch.ops import chain_fused as cf, sa_fused, sampling
from open3dsot_tpu_torch.tracking import eval as ev, scan_tracker as st
prepares, spans = [], []
prepare = st._ScanTracker._prepare
def counted(self, sequences):
    prepares.append(len(sequences))
    return prepare(self, sequences)
def timed(fn):
    def run(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        spans.append(time.perf_counter() - t0)
        return out
    return run
st._ScanTracker._prepare = counted
st.evaluate_with_tracker = timed(st.evaluate_with_tracker)
ev.evaluate_dataset = timed(ev.evaluate_dataset)
kernels = {"K1": cf.fused_pointnet_encoder, "K2": cf.fused_seg_head,
           "K3": sampling.furthest_point_sample, "K4": sa_fused.fused_sa_apply}
for module, argv in json.loads(sys.argv[1]):
    del prepares[:], spans[:]
    for f in kernels.values():
        f.launches = 0
    sys.argv = [module] + argv
    runpy.run_module(module, run_name="__main__", alter_sys=True)
    print("RUN " + json.dumps({"module": module, "prepares": len(prepares), "eval_s": sum(spans),
                               "launches": {k: f.launches for k, f in kernels.items()}}),
          flush=True)
"""


def run_entry_points(runs: list, what: str) -> list:
    """RUN_SCRIPT over [(module, argv)] in one subprocess: per run, its
    printed 'success/test:' line and the RUN record."""
    cmd = [sys.executable, "-c", RUN_SCRIPT, json.dumps(runs)]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"{what}: exit {proc.returncode}\n{proc.stdout[-3000:]}\n{proc.stderr[-4000:]}")
    out, last = [], None
    for line in proc.stdout.splitlines():
        if line.startswith("success/test:"):
            last = line
        elif line.startswith("RUN "):
            out.append(dict(json.loads(line[4:]), line=last))
            last = None
    if len(out) != len(runs) or not all(r["line"] for r in out):
        fail(f"{what}: a run printed no Success/Precision\n{proc.stdout[-3000:]}")
    return out


def real_cfg(name: str, root: Path, data: Path) -> tuple:
    """The config file of phase 23's model: cfgs/M2_track_kitti.yaml for the
    Car class, or cfgs/BAT_Car.yaml, with the data path; (path, config)."""
    import yaml

    from open3dsot_tpu_torch.config import load_config

    src = {"m2": "cfgs/M2_track_kitti.yaml", "bat": "cfgs/BAT_Car.yaml"}[name]
    with open(ROOT / src) as f:
        d = yaml.safe_load(f)
    d.update(path=str(data), category_name="Car", dataset="kitti")
    path = root / f"{name}.yaml"
    path.write_text(yaml.safe_dump(d))
    return path, load_config(str(path))


def released_checkpoint(name: str, cfg, path: Path):
    """A checkpoint in the reference's Lightning key layout of the seeded
    weights (make_model's), the Dense biases torch suppresses set to zero:
    written through export_torch.save_checkpoint against
    reference_layout.lightning_template, then imported back through
    import_torch.import_checkpoint and held to the weights bit for bit.
    Returns the model, on the card with those weights."""
    import torch

    from open3dsot_tpu_torch.export_torch import save_checkpoint
    from open3dsot_tpu_torch.import_torch import import_checkpoint
    from open3dsot_tpu_torch.reference_layout import lightning_template, without_suppressed_biases
    from open3dsot_tpu_torch.weights import state_dict_from_jax, variables_of

    model, _ = make_model(cfg, fused_eval=True)
    template = lightning_template(cfg, variables_of(model.net))
    variables = without_suppressed_biases(variables_of(model.net), cfg, template)
    model.net.load_state_dict(state_dict_from_jax(variables), strict=True)
    save_checkpoint(variables, cfg, template, str(path))
    back = state_dict_from_jax(import_checkpoint(str(path), cfg, model=model))
    want = state_dict_from_jax(variables)
    bad = [k for k in want if not torch.equal(back[k], want[k])]
    n_keys = len(torch.load(str(path), weights_only=False)["state_dict"])
    say23(f"  23 {name}: {path.name}, {n_keys} Lightning keys, {path.stat().st_size / 2**20:.2f} "
          f"MB; imported back: {len(want) - len(bad)} of {len(want)} tensors equal to the "
          f"exported weights bit for bit")
    if bad:
        fail(f"phase 23 {name}: the imported checkpoint differs from the exported weights at {bad[:5]}")
    return model


def mb(path: Path) -> float:
    files = [path] if path.is_file() else [p for p in path.rglob("*") if p.is_file()]
    return sum(p.stat().st_size for p in files) / 2**20


def real_data_phase(card: str) -> None:
    """Phase 23: KITTI-format data and Lightning checkpoints through the
    port's entry points on the card."""
    import shutil

    import torch

    from open3dsot_tpu_torch.data import get_dataset
    from open3dsot_tpu_torch.tracking.eval import evaluate_dataset
    from open3dsot_tpu_torch.tracking.results import ResultsWriter, read_results
    from open3dsot_tpu_torch.tracking.scan_tracker import M2ScanTracker

    t_phase = time.perf_counter()
    if PHASE23_LOG.exists():
        PHASE23_LOG.unlink()
    tmp = Path(tempfile.mkdtemp(prefix="phase23-"))
    try:
        data = tmp / "kitti"
        t0 = time.perf_counter()
        made = write_real_kitti(data)
        say23(f"  23 data: KITTI tracking layout, scenes {', '.join(REAL_SCENES)} x {REAL_FRAMES} "
              f"HDL-64E sweeps ({min(made['points'])}-{max(made['points'])} points, mean "
              f"{sum(made['points']) / len(made['points']):.0f}), 3 Cars each; written in "
              f"{time.perf_counter() - t0:.2f} s, {mb(data):.1f} MB")
        m2_yaml, m2_cfg = real_cfg("m2", tmp, data)
        bat_yaml, bat_cfg = real_cfg("bat", tmp, data)
        t0 = time.perf_counter()
        sampler = get_dataset(m2_cfg, "test", m2_cfg.test_split)
        seqs = [sampler[i] for i in range(len(sampler))]
        load_s = time.perf_counter() - t0
        n_frames = sum(len(s) - 1 for s in seqs)
        say23(f"  23 dataset load: {len(seqs)} tracklets, {n_frames + len(seqs)} frames read and "
              f"decoded in {load_s:.2f} s (host)")
        if len(seqs) != 3 * len(REAL_SCENES) or any(len(s) != REAL_FRAMES for s in seqs):
            fail(f"phase 23: the loader gave tracklets of {[len(s) for s in seqs]}")

        m2 = released_checkpoint("m2", m2_cfg, tmp / "m2.ckpt")
        bat = released_checkpoint("bat", bat_cfg, tmp / "bat.ckpt")
        torch.save(m2.net.state_dict(), tmp / "m2_port.pt")
        # in process, on the original weights: the M2 scan tracker and BAT's host loop
        want_m2 = m2.evaluate_scan(sampler, m2_cfg)
        want_bat = evaluate_dataset(bat, get_dataset(bat_cfg, "test", bat_cfg.test_split), bat_cfg)
        fmt = "success/test: {:.2f}  precision/test: {:.2f}"

        common = ["--data", str(data), "--device", "cuda"]
        store, results = tmp / "prep_store", tmp / "results.jsonl"
        cli = ["--cfg", str(m2_yaml), "--test", "--tracker", "scan", "--checkpoint",
               str(tmp / "m2_port.pt"), "--device", "cuda"]
        # one interpreter for the released checkpoints and the store's cold run,
        # another for its warm run (a store serves later processes) and the results
        m2_run, bat_run, cold = run_entry_points([
            ("open3dsot_tpu_torch.eval_released_ckpt",
             ["--cfg", str(m2_yaml), "--ckpt", str(tmp / "m2.ckpt"), "--tracker", "scan"] + common),
            ("open3dsot_tpu_torch.eval_released_ckpt",
             ["--cfg", str(bat_yaml), "--ckpt", str(tmp / "bat.ckpt"), "--tracker", "host"] + common),
            ("open3dsot_tpu_torch.main", cli + ["--eval_prep_cache", str(store)]),
        ], "eval_released_ckpt, main cold")
        for name, run, want, kernels in (("M2 --tracker scan", m2_run, want_m2, ("K1", "K2")),
                                         ("BAT --tracker host", bat_run, want_bat, ("K3", "K4"))):
            n = run["launches"]
            say23(f"  23 eval_released_ckpt {name}: {run['line']} (in process on the exported "
                  f"weights: {fmt.format(*want)}); {n_frames / run['eval_s']:.1f} frames/s; "
                  f"launches {n} [{card}]")
            if run["line"] != fmt.format(*want):
                fail(f"phase 23 {name}: Success/Precision differ from the in-process eval")
            if not all(n[k] > 0 for k in kernels):
                fail(f"phase 23 {name}: {kernels} were not launched: {n}")

        warm, saved = run_entry_points([
            ("open3dsot_tpu_torch.main", cli + ["--eval_prep_cache", str(store)]),
            ("open3dsot_tpu_torch.main", cli + ["--save_results", str(results)])], "main warm")
        for what, run in (("cold", cold), ("warm", warm), ("--save_results", saved)):
            say23(f"  23 main --tracker scan {what}: {run['line']}; {run['prepares']} packed "
                  f"batches built on the host; eval {run['eval_s']:.3f} s = "
                  f"{n_frames / run['eval_s']:.1f} frames/s; launches {run['launches']} [{card}]")
        say23(f"  23 prep store {mb(store):.2f} MB ({len(list(store.glob('prep_*.npz')))} "
              f"batches); results file {mb(results):.3f} MB")
        if warm["line"] != cold["line"] or cold["line"] != m2_run["line"]:
            fail("phase 23: the warm store's Success/Precision differ from the cold run's")
        if cold["prepares"] == 0 or warm["prepares"] != 0:
            fail(f"phase 23: cold run built {cold['prepares']} batches, warm {warm['prepares']}")
        header, records = read_results(str(results))
        tracker = M2ScanTracker(m2, m2_cfg, max_points=4096)
        worst = 0.0
        for j in range(0, len(seqs), 16):  # the writer loop's batches
            for r, (ious, _, bbs) in zip(records[j:j + 16],
                                         tracker.evaluate_sequences(seqs[j:j + 16], m2_cfg)):
                boxes = [ResultsWriter._encode_box(b) for b in bbs]
                worst = max(worst, max(abs(a - b) for x, y in zip(r["boxes"], boxes)
                                       for a, b in zip(x, y)))
        say23(f"  23 read_results: {len(records)} records ({header['net_model']}, "
              f"{header['category_name']}), boxes against the tracker's in process: max |diff| "
              f"{worst:.3e}")
        if [r["tracklet"] for r in records] != list(range(len(seqs))) or not worst <= 1e-5:
            fail(f"phase 23: the saved results are not the tracker's ({worst})")
        if saved["prepares"] == 0:
            fail("phase 23: the --save_results run packed no batch")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say23(f"phase 23 ok in {time.perf_counter() - t_phase:.1f} s")


# --- 24. multi-device runs ---------------------------------------------------------------

DIST_B = 16  # the global batch of phase 24's two-rank steps and K6 calls: 8 rows a rank
DIST_EVAL = dict(syn_num_tracklets=4, syn_tracklet_len=8)  # phase 24's evals
DIST_SPLIT_B = 16  # the online pool split over [cuda:0, cuda:0]: two sub-pools of 8
DIST_BF16_B = 8  # the bf16 online trackers and bundles
DIST_STEPS = 6  # online steps of phase 24's trackers
K6_GLOBAL = "open3dsot_tpu/ops/sa_fused_train.py:56-61, :383-397, :583-590"
DIST_TRAIN = (("global f32", False, False), ("per-device f32", False, True),
              ("global bf16", True, False))  # (name, bf16, per-device statistics)


def dist_evals(shard: bool) -> dict:
    """Phase 24's evals through their entry points, sharded over the ranks
    or not: the M2 and BAT scan trackers and the M2 host loop on 4
    synthetic tracklets of 8 frames; -> name: (success, precision)."""
    from open3dsot_tpu_torch.data import get_dataset
    from open3dsot_tpu_torch.tracking.eval import evaluate_dataset

    out = {}
    for name, cfg in (("M2", bench_cfg(**DIST_EVAL)), ("BAT", match_cfg("bat", **DIST_EVAL))):
        model, _ = make_model(cfg, fused_eval=True)
        sampler = get_dataset(cfg, "test", "test")
        out[f"{name} scan"] = model.evaluate_scan(sampler, cfg, shard_across_processes=shard)
        if name == "M2":
            out["M2 host loop"] = evaluate_dataset(model, sampler, cfg,
                                                   shard_across_processes=shard)
    return out


class StepChoices:
    """The discrete choices of a BAT train step, in which its gradient is not
    continuous: the seven ball queries' indices (the backbones' and the vote
    aggregation's), the BoxCloud kNN's, and the objectness labels (a
    proposal centre within 0.3 of the box). Inside the context a step's
    choices are kept in `own`, on the CPU."""

    def __init__(self):
        self.own = {"ball query": [], "kNN": [], "labels": []}

    def _keep(self, kind: str, value):
        self.own[kind].append(value.detach().cpu())
        return value

    def __enter__(self):
        import torch

        from open3dsot_tpu_torch.models import bat, pointnet, xcorr

        self._saved = bq, knn, loss = pointnet.ball_query, xcorr.knn, bat.matching_loss

        def matching_loss(config, batch, output):
            d = ((output["center_xyz"] - batch["box_label"][:, None, :3]) ** 2).sum(-1)
            self._keep("labels", torch.sqrt(d + 1e-6) < 0.3)
            return loss(config, batch, output)

        pointnet.ball_query = lambda *a, **k: self._keep("ball query", bq(*a, **k))
        xcorr.knn = lambda *a, **k: self._keep("kNN", knn(*a, **k))
        bat.matching_loss = matching_loss
        return self

    def __exit__(self, *exc) -> None:
        from open3dsot_tpu_torch.models import bat, pointnet, xcorr

        pointnet.ball_query, xcorr.knn, bat.matching_loss = self._saved

    @staticmethod
    def of_ranks(ranks: list) -> dict:
        """The ranks' choices as one run's on the global batch: the indices
        concatenated over the ranks, the labels (the loss's, on rows
        gathered on every rank) rank 0's."""
        import torch

        out = {k: [torch.cat(parts) for parts in zip(*(r[k] for r in ranks))]
               for k in ("ball query", "kNN")}
        out["labels"] = ranks[0]["labels"]
        return out

    @staticmethod
    def flips(a: dict, b: dict) -> str:
        """How far two runs' choices part: entries that differ, by kind."""
        parts = []
        for k in ("ball query", "kNN", "labels"):
            n = sum(int((x != y).sum()) for x, y in zip(a[k], b[k]))
            parts.append(f"{k} {n} of {sum(x.numel() for x in a[k])}")
        pos = [sum(int(x.sum()) for x in r["labels"]) for r in (a, b)]
        return ", ".join(parts) + f" (proposals labelled positive: {pos[0]} / {pos[1]})"


def dist_train_step(bf16: bool, per_device: bool, rows=None, choices=None) -> tuple:
    """One BAT_Car train step from the seeded weights on the first DIST_B
    samples of the training sampler (rows `rows` of them, or all), with SGD
    at learning rate 1, so that the step is minus the gradient, inside
    `choices` (a StepChoices) where given: -> (loss terms, {parameter:
    gradient}, {running statistic}, the K6 launches (forward, backward,
    staged forward, staged backward)), on the CPU."""
    import torch

    from open3dsot_tpu_torch.ops import sa_fused_train as k6
    from open3dsot_tpu_torch.train.trainer import train_step

    cfg = matching_cfg("bat", bf16=bf16)
    model, _ = make_model(cfg, fused_eval=True)
    before = {k: v.detach().clone() for k, v in model.net.named_parameters()}
    batch = model.device_batch(train_batch(cfg, DIST_B, SEED))
    if rows is not None:
        batch = {k: v[rows[0]:rows[1]].contiguous() for k, v in batch.items()}
    opt = torch.optim.SGD(model.net.parameters(), lr=1.0)
    reset_training_counts()
    with choices or contextlib.nullcontext():
        losses = train_step(model, opt, batch, fetch=True, per_device_stats=per_device)
    torch.cuda.synchronize()
    f = k6.fused_sa_train_apply
    launches = (f.fwd_launches, f.bwd_launches, f.staged_fwd_launches, f.staged_bwd_launches)
    grads = {k: (before[k] - p.detach()).float().cpu() for k, p in model.net.named_parameters()}
    stats = {k: b.float().cpu() for k, b in model.net.named_buffers() if "running" in k}
    return losses, grads, stats, launches


_K6_CALLS: list = []


def dist_k6_calls() -> list:
    """bat_k6_calls(), made once in a process."""
    if not _K6_CALLS:
        _K6_CALLS.extend(bat_k6_calls())
    return _K6_CALLS


def dist_k6(rows, bf16: bool, staged: bool) -> list:
    """K6 forward and backward at the four K6 calls of a BAT_Car train step
    on the first DIST_B samples (rows `rows` of them), staged or not, with a
    seeded bf16-valued cotangent; -> per call [out, the 6 statistics, da,
    dct, dW2, dW3, the 6 of dgamma / dbeta, the neighbour each channel's
    maximum comes from (-1 where it is 0)] on the CPU."""
    import torch

    from open3dsot_tpu_torch.ops import sa_fused_train as k6

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    lo, hi = rows
    res = []
    for _, mod, xyz, feats, new in dist_k6_calls():
        x = k6_bf16_inputs(mod, xyz[lo:hi].contiguous(), feats[lo:hi].contiguous(),
                           new[lo:hi].contiguous(), gen)
        c3 = x["w3"].shape[1]
        g = torch.randn(DIST_B, new.shape[1], c3, device="cuda", generator=gen)
        g = g.to(torch.bfloat16).float()[lo:hi].contiguous()
        packs = k6.Packs(x["w2"], x["w3"], bf16)
        wb = (x["w2"], x["b2"], x["w3"], x["b3"], x["bn"])
        y3 = torch.empty(*x["idx"].shape, c3, device="cuda") if bf16 else None
        out, st, grids = k6.sa_train_fwd_kernel(x["a"], x["ct"], x["idx"], *wb, packs,
                                                y3_out=y3, staged=staged)
        grads = k6.sa_train_bwd_kernel(g, x["a"], x["ct"], x["idx"], grids, st, *wb, packs,
                                       staged=staged)
        # BN3 keeps the order of y3 in a channel (reversed where its scale is
        # negative), so its argmax over the neighbours is h3's where h3 > 0
        y3 = y3 if bf16 else grids[1]
        arg = torch.where(out > 0, (y3 * x["bn"][4].sign()).argmax(dim=2), -1)
        res.append([t.float().cpu() for t in (out, *st, *grads[:4], *grads[4], arg)])
    torch.cuda.synchronize()
    return res


def rank_worker(out_path: str) -> None:
    """A rank of phase 24's two-rank gloo world on the one card (started by
    distributed_phase with torchrun's environment): its shard of the evals,
    its rows of the train steps and of the K6 calls; results pickled to
    out_path.<rank>."""
    import pickle

    import torch

    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from open3dsot_tpu_torch.parallel import distributed

    device = distributed.init_from_env("cuda", "gloo")
    r, n = distributed.rank(), distributed.world_size()
    rows = (r * DIST_B // n, (r + 1) * DIST_B // n)
    out = {"device": str(device), "backend": torch.distributed.get_backend(),
           "evals": dist_evals(True)}
    for name, bf16, per_device in DIST_TRAIN:
        choices = StepChoices()
        out[name] = dist_train_step(bf16, per_device, rows, choices)
        out[f"{name} choices"] = choices.own
    for bf16 in (False, True):
        with torch.no_grad():
            out[f"K6 {'bf16' if bf16 else 'f32'}"] = dist_k6(rows, bf16, staged=True)
    with open(f"{out_path}.{r}", "wb") as f:
        pickle.dump(out, f)
    distributed.shutdown()


def staged_world_of_one(card: str) -> dict:
    """The staged K6 (f32 and bf16) in a world of one under NCCL on the card
    at the four K6 calls of a BAT train step at B = TRAIN_B: forward and
    backward equal to the single call bit for bit (the backward with its da
    in a fixed order), held to the plain versions as phases 11 and 19 hold
    the single call, timed against the single call and the plain version;
    the host syncs the stages add, counted by torch's sync debug mode;
    -> {mode: {launch times, errors, work}}."""
    import torch

    from open3dsot_tpu_torch.ops import sa_fused_train as k6
    from open3dsot_tpu_torch.parallel import distributed

    distributed.init(0, 1, "localhost", distributed.free_port(), torch.device("cuda", 0), "nccl")
    try:
        probe = torch.arange(4.0, device="cuda")
        distributed.all_reduce_sum(probe)
        print(f"  24 NCCL world of one: backend {torch.distributed.get_backend()}, all_reduce "
              f"of a card tensor {probe.tolist()}", flush=True)
        calls = dist_k6_calls()
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        res = {}
        for bf16 in (False, True):
            mode = "bf16" if bf16 else "f32"
            t = dict.fromkeys(("fwd", "fwd_staged", "fwd_plain", "bwd", "bwd_staged",
                               "bwd_plain"), 0.0)
            q = dict.fromkeys(("fwd", "fwd_staged", "bwd", "bwd_staged"), 0.0)  # device only
            errs, work = {"fwd": 0.0, "bwd": 0.0}, [[0, 0], [0, 0]]
            for label, mod, xyz, feats, new in calls:
                x = k6_bf16_inputs(mod, xyz, feats, new, gen)
                a, ab, ct, idx = x["a"], x["ab"], x["ct"], x["idx"]
                wb = (x["w2"], x["b2"], x["w3"], x["b3"], x["bn"])
                B, S, K = idx.shape
                c1, c2, c3 = a.shape[2], x["w2"].shape[1], x["w3"].shape[1]
                shape = f"{label} {mode} B={B} S={S} K={K} C={c1},{c2},{c3}"
                packs = k6.Packs(x["w2"], x["w3"], bf16)
                g = torch.randn(B, S, c3, device="cuda", generator=gen).to(torch.bfloat16).float()
                y3 = torch.empty(B, S, K, c3, device="cuda") if bf16 else None
                single = k6.sa_train_fwd_kernel(a, ct, idx, *wb, packs)
                staged = k6.sa_train_fwd_kernel(a, ct, idx, *wb, packs, y3_out=y3, staged=True)
                with deterministic():
                    b_single = k6.sa_train_bwd_kernel(g, a, ct, idx, staged[2], staged[1], *wb,
                                                      packs)
                    b_staged = k6.sa_train_bwd_kernel(g, a, ct, idx, staged[2], staged[1], *wb,
                                                      packs, staged=True)
                torch.cuda.synchronize()
                flat = lambda o: [o[0], *o[1], *o[2]]  # noqa: E731
                same_f = all(torch.equal(u, v) for u, v in zip(flat(single), flat(staged)))
                same_b = all(torch.equal(u, v) for u, v in
                             zip([*b_single[:4], *b_single[4]], [*b_staged[:4], *b_staged[4]]))
                print(f"  24 staged K6 {shape}: forward {'bit-identical to' if same_f else 'DIFFERS from'} "
                      f"the single call, backward (ordered da) {'bit-identical to' if same_b else 'DIFFERS from'} "
                      f"it", flush=True)
                if not (same_f and same_b):
                    fail(f"phase 24: the staged K6 in a world of one differs from the single call "
                         f"({shape})")
                if bf16:
                    out_p, _, _ = k6.sa_train_fwd_plain(ab, ct, idx, *wb, True)
                    bwd_p = k6.sa_train_bwd_plain(g, ab, ct, idx, staged[2], staged[1], *wb, True,
                                                  y3=y3)
                    errs["fwd"] = max(errs["fwd"], compare_bf16(
                        f"24 staged K6 fwd {shape} out", staged[0], out_p, out_p, control=False))
                    errs["bwd"] = max(errs["bwd"], compare_bf16(
                        f"24 staged K6 bwd {shape} da", b_staged[0], bwd_p[0], bwd_p[0],
                        control=False))
                else:
                    out_p, st_p, grids_p = k6.sa_train_fwd_plain(a, ct, idx, *wb)
                    bwd_p = k6.sa_train_bwd_plain(g, a, ct, idx, grids_p, st_p, *wb)
                    errs["fwd"] = max(errs["fwd"], compare(f"24 staged K6 fwd {shape} out",
                                                           staged[0], out_p))
                    b_on_plain = k6.sa_train_bwd_kernel(g, a, ct, idx, grids_p, st_p, *wb, packs,
                                                        staged=True)
                    errs["bwd"] = max(errs["bwd"], compare(f"24 staged K6 bwd {shape} da",
                                                           b_on_plain[0], bwd_p[0]))
                grids, st = staged[2], staged[1]
                fns = {"fwd": lambda: k6.sa_train_fwd_kernel(a, ct, idx, *wb, packs),
                       "fwd_staged": lambda: k6.sa_train_fwd_kernel(a, ct, idx, *wb, packs,
                                                                    staged=True),
                       "fwd_plain": lambda: k6.sa_train_fwd_plain(ab if bf16 else a, ct, idx, *wb,
                                                                  bf16),
                       "bwd": lambda: k6.sa_train_bwd_kernel(g, a, ct, idx, grids, st, *wb, packs),
                       "bwd_staged": lambda: k6.sa_train_bwd_kernel(g, a, ct, idx, grids, st, *wb,
                                                                    packs, staged=True),
                       "bwd_plain": lambda: k6.sa_train_bwd_plain(g, ab if bf16 else a, ct, idx,
                                                                  grids, st, *wb, bf16, y3=y3)
                       if bf16 else k6.sa_train_bwd_plain(g, a, ct, idx, grids_p, st_p, *wb)}
                # single and staged in turns (single, staged, staged, single)
                order = ("fwd", "fwd_staged", "fwd_staged", "fwd", "bwd", "bwd_staged",
                         "bwd_staged", "bwd")
                got = {}
                for key in order:
                    got.setdefault(key, []).append(time_ms(fns[key], iters=5, repeats=5))
                for key in ("fwd_plain", "bwd_plain"):
                    got[key] = [time_ms(fns[key], iters=3, repeats=3)]
                for key, v in got.items():
                    t[key] += min(v)
                for key in q:  # behind a queued sleep: the device's time without the host's
                    q[key] += queued_ms(fns[key], iters=5, repeats=3, sleep=20_000_000)
                for i, w in enumerate(k6_work(B, xyz.shape[1], S, K, c1, c2, c3, bf16)):
                    work[i][0] += w[0]
                    work[i][1] += w[1]
            # the host syncs of a staged forward and backward: torch's sync debug
            # mode raises on any synchronizing call
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                fns["bwd_staged"]()
                fns["fwd_staged"]()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            print(f"  24 staged K6 {mode} over one BAT train step's 4 calls, B={TRAIN_B}, world of "
                  f"one (NCCL): forward {t['fwd_staged']:.4f} ms staged against {t['fwd']:.4f} ms "
                  f"single ({t['fwd_staged'] / t['fwd'] - 1:+.1%}), backward "
                  f"{t['bwd_staged']:.4f} ms against {t['bwd']:.4f} ms "
                  f"({t['bwd_staged'] / t['bwd'] - 1:+.1%}); plain {t['fwd_plain']:.4f} / "
                  f"{t['bwd_plain']:.4f} ms; device alone (events behind a queued sleep) forward "
                  f"{q['fwd_staged']:.4f} / {q['fwd']:.4f} ms, backward {q['bwd_staged']:.4f} / "
                  f"{q['bwd']:.4f} ms; host syncs added by the stages: 0 (sync debug mode "
                  f"'error' raised none; 3 all_reduces a forward, 3 a backward) [{card}]",
                  flush=True)
            res[mode] = dict(t=t, errs=errs, work=work)
        return res
    finally:
        distributed.shutdown()


def held(name: str, got, want, rtol: float) -> float:
    """rel_err of got from want, within rtol, printed; -> the error."""
    e = rel_err(got, want)
    print(f"  {name}: rel err {e:.3e} (within {rtol:.3e}) {'ok' if e <= rtol else 'FAIL'}",
          flush=True)
    if not e <= rtol:
        fail(f"phase 24: {name} {e:.3e} from the one-process reference, above {rtol:.3e}")
    return e


def check_dist_step(name: str, got: tuple, want: tuple) -> None:
    """A rank's f32 train step against the one-process reference: each loss
    term within 1e-3 (relative), the whole gradient within phase 12's rule
    for the loss's gradient (0.1, norm-relative, all parameters together)
    and the running statistics within 1e-3. A zero gradient is 1.0 away;
    the per-device step is held to be further than 0.1 from the global one
    (dist_train_checks)."""
    losses, grads, stats, _ = got
    w_losses, w_grads, w_stats, _ = want
    errs = loss_errs(losses, w_losses)
    worst = max(errs, key=errs.get)
    print(f"  {name}: loss terms within {errs[worst]:.3e} (relative, {worst}) of the "
          f"one-process step", flush=True)
    if not errs[worst] <= 1e-3:
        fail(f"phase 24: {name}'s {worst} {errs[worst]:.3e} from the one-process step (within "
             f"1e-3)")
    held(f"{name} gradient, all parameters", flat_of(grads), flat_of(w_grads), 0.1)
    held(f"{name} running statistics", flat_of(stats), flat_of(w_stats), 1e-3)


def loss_errs(losses: dict, want: dict) -> dict:
    """Each loss term's relative distance from want's."""
    return {k: abs(losses[k] - w) / max(abs(w), 1e-6) for k, w in want.items()}


def flat_of(d: dict):
    """The tensors of a {name: tensor} dict as one vector, by name."""
    import torch

    return torch.cat([d[k].reshape(-1) for k in sorted(d)])


def grad_parts(got: dict, want: dict, top: int = 4) -> str:
    """Where two gradients part: the modules (first two parts of a parameter's
    name) with the largest shares of the squared distance, each with its
    own norm-relative distance."""
    parts = {}
    for k in want:
        parts.setdefault(".".join(k.split(".")[:2]), []).append(k)
    total = float((flat_of(got) - flat_of(want)).square().sum())
    rows = []
    for mod, keys in parts.items():
        g, w = flat_of({k: got[k] for k in keys}), flat_of({k: want[k] for k in keys})
        rows.append((float((g - w).square().sum()) / max(total, 1e-30), mod, rel_err(g, w)))
    rows.sort(reverse=True)
    return ", ".join(f"{m} {share:.1%} (rel {e:.3e})" for share, m, e in rows[:top])


def split_cards() -> list:
    """The cards phase 24 splits the online pool over: every card where
    there are several, else cuda:0 twice."""
    import torch

    n = torch.cuda.device_count()
    return [f"cuda:{i}" for i in range(n)] if n > 1 else ["cuda:0", "cuda:0"]


def dist_online_split(card: str) -> None:
    """The M2 and BAT online pools of DIST_SPLIT_B slots split over
    split_cards() against unsplit trackers of their parts' slots on cuda:0,
    bit for bit; on several cards also one tracker put on the last card
    (`devices=[that card]`) against the same tracker on cuda:0."""
    import numpy as np

    from open3dsot_tpu_torch.data import get_dataset

    devices = split_cards()
    per = DIST_SPLIT_B // len(devices)
    for name in ("m2track", "bat"):
        t0 = time.perf_counter()
        cfg = (bench_cfg(syn_num_tracklets=DIST_SPLIT_B, syn_tracklet_len=ONLINE_T)
               if name == "m2track" else
               match_cfg("bat", syn_num_tracklets=DIST_SPLIT_B, syn_tracklet_len=ONLINE_T))
        model, _ = make_model(cfg, fused_eval=True)
        sampler = get_dataset(cfg, "test", "test")
        seqs = [sampler[i] for i in range(DIST_SPLIT_B)]
        frames = [[f["pc"].points.T.astype(np.float32) for f in seq] for seq in seqs]
        split = online_tracker(model, cfg, DIST_SPLIT_B, devices=devices)
        got = online_track(split, seqs, frames, steps=DIST_STEPS)
        want = np.concatenate([online_track(online_tracker(model, cfg, per), seqs[s:s + per],
                                            frames[s:s + per], steps=DIST_STEPS)
                               for s in range(0, DIST_SPLIT_B, per)])
        on = [str(p._state["ref"].device) for p in split.parts]
        print(f"  24 online {name} pool of {DIST_SPLIT_B} split over {devices}: {same(got, want)} "
              f"{len(devices)} unsplit trackers of {per} on cuda:0 over {DIST_STEPS} steps; parts' "
              f"state on {on}, replays {[p.replays for p in split.parts]}; "
              f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
        if not (np.array_equal(got, want) and np.isfinite(got).all() and on == devices
                and all(p.replays == DIST_STEPS for p in split.parts)):
            fail(f"phase 24: the {name} online pool split over {devices} differs from unsplit "
                 f"trackers")
        if len(set(devices)) > 1:
            last = online_tracker(model, cfg, per, devices=[devices[-1]])
            one = online_track(last, seqs[:per], frames[:per], steps=DIST_STEPS)
            print(f"  24 online {name} tracker of {per} put on {last.device}: {same(one, want[:per])} "
                  f"the tracker on cuda:0; replays {last.replays}", flush=True)
            if not (np.array_equal(one, want[:per]) and str(last.device) == devices[-1]):
                fail(f"phase 24: the {name} online tracker on {devices[-1]} differs from cuda:0's")


def dist_online(card: str) -> None:
    """The online pool split over cards (dist_online_split); bf16 online
    trackers and their bundles against the bf16 scan trackers at the same
    B, bit for bit."""
    import numpy as np

    from open3dsot_tpu_torch.data import get_dataset
    from open3dsot_tpu_torch.tracking.serving_export import load_serving_bundle, save_serving_bundle

    dist_online_split(card)
    tmp = Path(tempfile.mkdtemp(prefix="phase24_bundle_"))
    try:
        for name in ("m2track", "bat"):
            B = DIST_BF16_B
            cfg = (bench_cfg(syn_num_tracklets=B, syn_tracklet_len=ONLINE_T, bf16=True)
                   if name == "m2track" else
                   match_cfg("bat", syn_num_tracklets=B, syn_tracklet_len=ONLINE_T, bf16=True))
            model, _ = make_model(cfg, fused_eval=True)
            sampler = get_dataset(cfg, "test", "test")
            seqs = [sampler[i] for i in range(B)]
            frames = [[f["pc"].points.T.astype(np.float32) for f in seq] for seq in seqs]
            live = online_tracker(model, cfg, B)
            got = online_track(live, seqs, frames)
            scan = model.scan_tracker(cfg, max_points=ONLINE_P, frame_bucket=ONLINE_T,
                                      **({} if name == "m2track" else
                                         {"first_crop_points": ONLINE_FIRST_CROP}))
            want = np.stack(scan.track_batch(seqs))
            t0 = time.perf_counter()
            save_serving_bundle(live, tmp / name)
            served = load_serving_bundle(tmp / name)
            export_s = time.perf_counter() - t0
            loaded = online_track(served, seqs, frames)
            print(f"  24 bf16 online {name} B={B}: mode {live.compute_mode}, graph boxes "
                  f"{same(got, want)} the bf16 scan tracker's over {ONLINE_T - 1} steps; its bundle "
                  f"(mode {served.compute_mode}, saved and loaded in {export_s:.1f} s) "
                  f"{same(loaded, got)} the live tracker [{card}]", flush=True)
            if not (live.compute_mode == served.compute_mode == "bfloat16"
                    and np.array_equal(got, want) and np.array_equal(loaded, got)
                    and np.isfinite(got).all()):
                fail(f"phase 24: the bf16 online {name} tracker or its bundle differs from the "
                     f"bf16 scan tracker")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


PHASE24_LOG = ROOT / "chiprun_out" / "phase24.txt"


class _Tee:
    """A stdout that also writes to an open file."""

    def __init__(self, out, log):
        self.out, self.log = out, log

    def write(self, text: str) -> int:
        self.log.write(text)
        return self.out.write(text)

    def flush(self) -> None:
        self.log.flush()
        self.out.flush()


def distributed_phase(card: str) -> list:
    """Phase 24 (see the module docstring), its lines also in
    chiprun_out/phase24.txt, which each run writes anew; -> the kernels
    line's staged K6 rows."""
    PHASE24_LOG.parent.mkdir(exist_ok=True)
    with open(PHASE24_LOG, "w") as log, contextlib.redirect_stdout(_Tee(sys.stdout, log)):
        return _distributed_phase(card)


def dist_train_checks(ranks: list) -> dict:
    """The two ranks' train steps (DIST_TRAIN) against the one-process
    references on the global batch; -> the K6 launches of each step on rank
    0. The f32 steps are held (check_dist_step). The bf16 step is held to
    run (K6 staged, losses and gradient finite, the gradient not zero) and
    read against the one-process bf16 step, that step run again, and the
    f32 step, not held: its gradient parts from any other bf16 run of the
    step by about as much as from the f32 step (chip_smoke's phase 24
    readings in PERF.md), so the staged bf16 K6 is held per leaf over the
    two ranks instead (_distributed_phase)."""
    launches, refs, own = {}, {}, {}
    for name, bf16, per_device in DIST_TRAIN:
        if per_device:  # each rank's own statistics: the mean of two one-process half steps
            halves = [dist_train_step(bf16, True, (r * DIST_B // 2, (r + 1) * DIST_B // 2))
                      for r in range(2)]
            mean = lambda i: {k: (halves[0][i][k] + halves[1][i][k]) / 2  # noqa: E731
                              for k in halves[0][i]}
            ref = (mean(0), mean(1), mean(2), None)
            sep = rel_err(flat_of(ref[1]), flat_of(refs["global f32"][1]))
            print(f"  24 the per-device f32 step's gradient is {sep:.3e} from the global one's "
                  f"(norm-relative; the limit 0.1 tells them apart)", flush=True)
            if not sep > 0.1:
                fail(f"phase 24: the per-device and global steps' gradients are {sep:.3e} apart, "
                     f"within the limit 0.1 that should tell them apart")
        else:
            ch = StepChoices()
            ref = dist_train_step(bf16, False, choices=ch)
            own[name] = ch.own
            if not bf16:  # bf16_step_readings prints the bf16 step's
                theirs = StepChoices.of_ranks([rank[f"{name} choices"] for rank in ranks])
                print(f"  24 {name} step, choices of the two ranks against one process: "
                      f"{StepChoices.flips(theirs, ch.own)}", flush=True)
        refs[name] = ref
        if bf16:
            bf16_step_readings(name, ranks, ref, dist_train_step(bf16, False), refs["global f32"],
                               own)
        else:
            for r, rank in enumerate(ranks):
                check_dist_step(f"24 {name} step, rank {r}", rank[name], ref)
        launches[name] = ranks[0][name][3]
        staged = 0 if per_device else 4
        print(f"  24 {name} step: K6 launches on each rank (forward, backward, staged forward, "
              f"staged backward) {[rank[name][3] for rank in ranks]}", flush=True)
        if any(rank[name][3] != (4, 4, staged, staged) for rank in ranks):
            fail(f"phase 24: {name} step launched K6 {[rank[name][3] for rank in ranks]}, "
                 f"expected (4, 4, {staged}, {staged}) on each rank")
    return launches


def bf16_step_readings(name: str, ranks: list, one: tuple, again: tuple, f32: tuple,
                       own: dict) -> None:
    """The two-rank bf16 step held to run (finite losses and gradient, the
    gradient not zero) and read, not held, against the one-process bf16
    step `one`, the same step run again (`again`: K6's da sums by atomics,
    in any order) and the one-process f32 step."""
    import torch

    def terms(errs):
        return ", ".join(f"{k} {e:.2e}" for k, e in sorted(errs.items()))

    for r, rank in enumerate(ranks):
        losses, grads = rank[name][:2]
        g = flat_of(grads)
        if not (all(torch.isfinite(torch.tensor(v)) for v in losses.values())
                and torch.isfinite(g).all() and g.norm() > 0):
            fail(f"phase 24: {name} step on rank {r}: losses or gradient not finite, or no gradient")
    theirs = StepChoices.of_ranks([rank[f"{name} choices"] for rank in ranks])
    for who, x, whom, y, flips in (
            ("rank 0", ranks[0][name], "one process", one, StepChoices.flips(theirs, own[name])),
            ("one process, run again,", again, "its first run", one, None),
            ("one process", one, "the global f32 step", f32,
             StepChoices.flips(own[name], own["global f32"]))):
        print(f"  24 {name} step, {who} against {whom} (not held): loss terms "
              f"{terms(loss_errs(x[0], y[0]))}; gradient {rel_err(flat_of(x[1]), flat_of(y[1])):.3e}"
              f", by module {grad_parts(x[1], y[1])}" + (f"; choices {flips}" if flips else ""),
              flush=True)


def _distributed_phase(card: str) -> list:
    import pickle

    import torch

    from open3dsot_tpu_torch.parallel import distributed

    t_phase = time.perf_counter()
    one = staged_world_of_one(card)
    tmp = Path(tempfile.mkdtemp(prefix="phase24_"))
    try:
        t0 = time.perf_counter()
        code = distributed.launch([str(ROOT / "chip_smoke.py"), "--rank-worker",
                                   str(tmp / "out")], 2)
        if code:
            fail(f"phase 24: a rank of the two-rank gloo world exited with {code}")
        ranks = []
        for r in range(2):
            with open(tmp / f"out.{r}", "rb") as f:
                ranks.append(pickle.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  24 two ranks ({ranks[0]['backend']}) on {ranks[0]['device']} and "
          f"{ranks[1]['device']}: {time.perf_counter() - t0:.1f} s with their start [{card}]",
          flush=True)
    # the sharded evals against the one-process evals
    want = dist_evals(False)
    for k, w in want.items():
        for r, rank in enumerate(ranks):
            g = rank["evals"][k]
            print(f"  24 {k} sharded over 2 ranks, rank {r}: success {g[0]:.4f} precision "
                  f"{g[1]:.4f}; one process {w[0]:.4f} / {w[1]:.4f}", flush=True)
            if tuple(g) != tuple(w):
                fail(f"phase 24: the sharded {k} eval differs from the one-process eval")
    launches = dist_train_checks(ranks)
    # K6 staged over the two ranks against the single call on the global batch
    for mode in ("f32", "bf16"):
        single = dist_k6((0, DIST_B), mode == "bf16", staged=False)
        for c, want in enumerate(single):
            got = [rank[f"K6 {mode}"][c] for rank in ranks]
            b = DIST_B // 2
            check = (lambda n, x, y: compare_bf16(n, x, y, y, control=False)) if mode == "bf16" \
                else compare
            for r in range(2):
                for i, what in ((0, "out"), (7, "da"), (8, "dct")):
                    check(f"24 K6 {mode} call {c} rank {r} {what}", got[r][i],
                          want[i][r * b:(r + 1) * b])
                for i in range(1, 7):  # the statistics: the global batch's on every rank
                    compare(f"24 K6 {mode} call {c} rank {r} statistic {i}", got[r][i], want[i])
            for i, what in ((9, "dW2"), (10, "dW3")):
                check(f"24 K6 {mode} call {c} {what} summed over the ranks",
                      got[0][i] + got[1][i], want[i])
            check(f"24 K6 {mode} call {c} dgamma,dbeta summed over the ranks",
                  torch.cat(got[0][11:17]) + torch.cat(got[1][11:17]), torch.cat(want[11:17]))
            # a reading: the maxima whose neighbour the ranks' statistics change
            arg, mine = want[17], torch.cat([got[0][17], got[1][17]])
            print(f"  24 K6 {mode} call {c}: of {int((arg >= 0).sum())} maxima above 0, "
                  f"{int(((mine != arg) & (arg >= 0)).sum())} come from another neighbour over "
                  f"the two ranks than in the single call", flush=True)
    print("  24 staged K6 over two ranks: every rank's statistics are the global batch's, its "
          "rows of out, da and dct the single call's, dW and dgamma / dbeta summed over the "
          "ranks the single call's", flush=True)
    dist_online(card)
    print(f"phase 24 ok in {time.perf_counter() - t_phase:.1f} s", flush=True)
    rows = []
    for mode, key in (("f32", "global f32"), ("bf16", "global bf16")):
        o = one[mode]
        for i, what in enumerate(("fwd", "bwd")):
            rows.append(kernel_entry(
                f"K6 fused_sa_train_apply ({'forward' if what == 'fwd' else 'backward'}, {mode}, "
                f"staged: statistics over a process group)",
                "sa_fused_train.cu" if mode == "f32" else "sa_fused_train_bf16.cu",
                K6_GLOBAL, launches[key][2 + i], o["errs"][what], o["t"][f"{what}_staged"],
                o["t"][f"{what}_plain"], o["work"][i], tensor_core=mode == "f32",
                peak=PEAK_BF16_FLOPS))
    return rows


# --- 25. the scan trackers split over cards, the native host library, the layer library ---

PHASE25_LOG = ROOT / "chiprun_out" / "phase25.txt"
SPLIT_B = 16  # phase 25a's batch: 8 tracklets a part over [cuda:0, cuda:0]
SPLIT_T = 16  # frames a tracklet, frame_bucket 16: 15 steps a batch
SPLIT_KW = dict(max_points=SCAN_MAX_POINTS, frame_bucket=SPLIT_T)
SPLIT_CARD_B = 16  # 25b: tracklets a card
# the kernels' launches captured per replay of a part's graph: (K1, K2) / (K3, K4)
SPLIT_LAUNCHES = {"m2track": (3, 1), "bat": (2, 7), "p2b": (0, 7)}
# a split against an unsplit tracker of the whole batch: ROADMAP §3's cross-B bounds
SPLIT_FIRST_ATOL, SPLIT_TRAJ_ATOL = 1e-4, 1e-3
SPLIT_SCORE_ATOL = 1e-2  # per-frame IoU / distance of the split against the whole batch's
REAL_NATIVE_TRACKLETS = 3  # 25c: BAT's host loop over the first KITTI scene's three Cars
SPLIT_DEVICE = "cuda:0"  # phase 25's card ("cpu" in a rehearsal on the CPU)


def say25(line: str) -> None:
    say(line, PHASE25_LOG)


def split_cfg(name: str, B: int):
    """Phase 15's M2 configuration (M2_track_kitti.yaml's widths) or phase
    16's BAT_Car / P2B_Car one, B tracklets of SPLIT_T frames."""
    if name == "m2track":
        return bench_cfg(syn_num_tracklets=B, syn_tracklet_len=SPLIT_T)
    return match_cfg(name, syn_num_tracklets=B, syn_tracklet_len=SPLIT_T)


def scan_tracker_of(model, cfg, devices=None, **kw):
    """The model's scan tracker at phase 25's sizes, graph path; split over
    `devices` where several are given."""
    if cfg.net_model.lower() != "m2track":
        kw["first_crop_points"] = MATCH_KW["first_crop_points"]
    return model.scan_tracker(cfg, devices=devices, **SPLIT_KW, **kw)


def scan_counts(name: str) -> tuple:
    """The wrappers' launch counts of the model's kernels: (K1, K2) or (K3, K4)."""
    from open3dsot_tpu_torch.ops import chain_fused as cf

    if name == "m2track":
        return cf.fused_pointnet_encoder.launches, cf.fused_seg_head.launches
    return matching_counts()[:2]


def reset_scan_counts() -> None:
    from open3dsot_tpu_torch.ops import chain_fused as cf

    cf.reset_launch_counts()
    reset_matching_counts()


def scores_sp(pieces) -> tuple:
    """Success / Precision of [(seqs, iou (B, T), dist (B, T))] in that
    order, as the dataset loop updates them."""
    from open3dsot_tpu_torch.utils.metrics import Precision, Success

    success, precision = Success(), Precision()
    for seqs, iou, dist in pieces:
        for b, seq in enumerate(seqs):
            success.update(iou[b, :len(seq)])
            precision.update(dist[b, :len(seq)])
    return success.compute(), precision.compute()


def scored(tracker, seqs) -> tuple:
    iou, dist = tracker.dispatch_scored(seqs)
    return iou.cpu().numpy(), dist.cpu().numpy()


def split_case(name: str, label: str, devices: list, card: str, **kw) -> None:
    """25a: one model's scan tracker split over `devices` against unsplit
    trackers on SPLIT_DEVICE (see the module docstring)."""
    import numpy as np
    import torch

    from open3dsot_tpu_torch.data import get_dataset
    from open3dsot_tpu_torch.tracking.scan_tracker import canonical_device

    t0 = time.perf_counter()
    B, n = SPLIT_B, len(devices)
    per, steps = B // n, SPLIT_T - 1
    cfg = split_cfg(name, B)
    model, _ = make_model(cfg, fused_eval=True)
    sampler = get_dataset(cfg, "test", "test")
    seqs = [sampler[i] for i in range(B)]
    split = scan_tracker_of(model, cfg, devices, **kw)
    got = np.stack(split.track_batch(seqs))
    parts = [scan_tracker_of(model, cfg, **kw) for _ in range(n)]
    want = np.concatenate([np.stack(p.track_batch(seqs[i * per:(i + 1) * per]))
                           for i, p in enumerate(parts)])
    whole = scan_tracker_of(model, cfg, **kw)
    full = np.stack(whole.track_batch(seqs))
    e_first, e_traj = np.abs(got[:, 0] - full[:, 0]).max(), np.abs(got - full).max()
    on = [str(canonical_device(p.device)) for p in split.parts]
    say25(f"  25 {label} B={B} split over {devices} (parts on {on}): {same(got, want)} {n} "
          f"unsplit trackers of {per} on their rows; from an unsplit tracker of {B}: first "
          f"step {e_first:.3e} (atol {SPLIT_FIRST_ATOL}), trajectory {e_traj:.3e} (atol "
          f"{SPLIT_TRAJ_ATOL}) [{card}]")
    if not (np.array_equal(got, want) and np.isfinite(got).all() and len(on) == n):
        fail(f"phase 25: the {label} split tracker's parts differ from unsplit trackers of {per}")
    if not (e_first <= SPLIT_FIRST_ATOL and e_traj <= SPLIT_TRAJ_ATOL):
        fail(f"phase 25: the {label} split tracker is {e_first} / {e_traj} from the unsplit one")
    # an odd batch: padded by its last tracklet, the padding's boxes dropped
    odd = split.track_batch(seqs[:B - 1])
    padded = seqs[:B - 1] + seqs[B - 2:B - 1]
    want_odd = np.concatenate([np.stack(p.track_batch(padded[i * per:(i + 1) * per]))
                               for i, p in enumerate(parts)])[:B - 1]
    say25(f"  25 {label} B={B - 1}: padded to {B}, {len(odd)} trajectories back, "
          f"{same(np.stack(odd), want_odd)} the parts' unsplit trackers on the padded rows")
    if len(odd) != B - 1 or not np.array_equal(np.stack(odd), want_odd):
        fail(f"phase 25: the {label} split tracker's batch of {B - 1} came back wrong")
    # the dataset loop from launch counts of 0 on a fresh split tracker
    fresh = scan_tracker_of(model, cfg, devices, **kw)
    reset_scan_counts()
    got_sp = model.evaluate_scan(sampler, cfg, tracker=fresh, batch_tracklets=B)
    sync_card()
    counted = scan_counts(name)
    launches = fresh.graph_launches()
    want_sp = scores_sp([(seqs[i * per:(i + 1) * per], *scored(p, seqs[i * per:(i + 1) * per]))
                         for i, p in enumerate(parts)])
    whole_sp = model.evaluate_scan(sampler, cfg, tracker=whole, batch_tracklets=B)
    (iou_s, dist_s), (iou_w, dist_w) = scored(split, seqs), scored(whole, seqs)
    e_iou, e_dist = np.abs(iou_s[:B] - iou_w).max(), np.abs(dist_s[:B] - dist_w).max()
    per_replay = [p["captured_per_replay"] for p in launches["parts"]]
    say25(f"  25 {label} evaluate_dataset_scan split: success {got_sp[0]:.4f} precision "
          f"{got_sp[1]:.4f}; the parts' unsplit trackers {want_sp[0]:.4f} / {want_sp[1]:.4f}; "
          f"an unsplit tracker of {B} {whole_sp[0]:.4f} / {whole_sp[1]:.4f} (per frame max "
          f"|iou diff| {e_iou:.3e}, |distance diff| {e_dist:.3e}); launches from 0 "
          f"{counted} (warm-ups and captures); captured per replay by part {per_replay}, "
          f"replays {[p['replays'] for p in launches['parts']]}")
    if tuple(got_sp) != tuple(want_sp):
        fail(f"phase 25: the {label} split eval's Success/Precision {got_sp} differ from its "
             f"parts' unsplit trackers' {want_sp}")
    if not (e_iou <= SPLIT_SCORE_ATOL and e_dist <= SPLIT_SCORE_ATOL):
        fail(f"phase 25: the {label} split eval's scores are {e_iou} / {e_dist} from the unsplit")
    kernels = [k for k, c in enumerate(SPLIT_LAUNCHES[name]) if c]
    if (per_replay != [[SPLIT_LAUNCHES[name]]] * n
            or any(p["replays"] != steps for p in launches["parts"])
            or not all(counted[k] > 0 for k in kernels)):
        fail(f"phase 25: the {label} split eval's launches {counted} / {per_replay} are not "
             f"{SPLIT_LAUNCHES[name]} a replay of each part")
    # the frame loops, no host sync between the batch's upload and its boxes
    host, host_w = split._prepare(seqs)[2], whole._prepare(seqs)[2]
    torch.cuda.set_sync_debug_mode("error")
    try:
        split._dispatch(host, [])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    t_s = wall_ms(lambda: split._dispatch(host, []))
    t_w = wall_ms(lambda: whole._dispatch(host_w, []))
    frames = B * steps
    say25(f"  25 {label} frames/s from pinned host rows to boxes on the card: split "
          f"{frames / t_s * 1e3:.2f}, unsplit {frames / t_w * 1e3:.2f} (a reading); "
          f"{time.perf_counter() - t0:.1f} s [{card}]")


def scan_split_cards(card: str) -> None:
    """25b: the M2 and BAT scan trackers split over every card present,
    SPLIT_CARD_B tracklets a card, each part bit for bit against an unsplit
    tracker of its rows on the first card; M2's frames/s over the cards
    against one card."""
    import numpy as np

    from open3dsot_tpu_torch.data import get_dataset
    from open3dsot_tpu_torch.tracking.scan_tracker import canonical_device

    devices = split_cards()
    n = len(set(devices))
    if n < 2:
        say25(f"  25 split over several cards: one card present, 25a's [cuda:0, cuda:0] only")
        return
    B = SPLIT_CARD_B * n
    for name in ("m2track", "bat"):
        t0 = time.perf_counter()
        cfg = split_cfg(name, B)
        model, _ = make_model(cfg, fused_eval=True)
        sampler = get_dataset(cfg, "test", "test")
        seqs = [sampler[i] for i in range(B)]
        split = scan_tracker_of(model, cfg, devices)
        got = np.stack(split.track_batch(seqs))
        one = scan_tracker_of(model, cfg)
        rows = [seqs[i:i + SPLIT_CARD_B] for i in range(0, B, SPLIT_CARD_B)]
        want = np.concatenate([np.stack(one.track_batch(r)) for r in rows])
        on = [str(canonical_device(p.device)) for p in split.parts]
        line = (f"  25 {name} B={B} split over {devices} (parts on {on}): {same(got, want)} an "
                f"unsplit tracker of {SPLIT_CARD_B} on cuda:0 on each part's rows")
        if name == "m2track":
            host, host_1 = split._prepare(seqs)[2], one._prepare(rows[0])[2]
            t_n = wall_ms(lambda: split._dispatch(host, []))
            t_1 = wall_ms(lambda: one._dispatch(host_1, []))
            q_n = enqueue_ms(lambda: split._dispatch(host, []))
            q_1 = enqueue_ms(lambda: one._dispatch(host_1, []))
            steps = SPLIT_T - 1
            line += (f"; frames/s {B * steps / t_n * 1e3:.2f} over {n} cards, "
                     f"{SPLIT_CARD_B * steps / t_1 * 1e3:.2f} on one card "
                     f"({SPLIT_CARD_B} tracklets a card); a batch {t_n:.2f} / {t_1:.2f} ms to "
                     f"its boxes, of which the host's enqueueing {q_n:.2f} / {q_1:.2f} ms")
        say25(line + f"; {time.perf_counter() - t0:.1f} s [{card}]")
        if not (np.array_equal(got, want) and np.isfinite(got).all() and on == devices):
            fail(f"phase 25: the {name} scan tracker split over {devices} differs from cuda:0's")


def native_phase(card: str) -> None:
    """25c: the native host library (open3dsot_tpu_torch/native) built in
    _build/, its int16 encoder against numpy on an M2 scan batch, the int16
    scan batch's host packing both ways, and BAT's host loop on KITTI-format
    sweeps with OPEN3DSOT_TPU_NATIVE 1 and 0."""
    import numpy as np

    from open3dsot_tpu_torch import native
    from open3dsot_tpu_torch.data import get_dataset
    from open3dsot_tpu_torch.tracking.eval import evaluate_dataset
    from open3dsot_tpu_torch.utils import quant

    before = os.environ.get("OPEN3DSOT_TPU_NATIVE")
    os.environ.pop("OPEN3DSOT_TPU_NATIVE", None)
    tmp = Path(tempfile.mkdtemp(prefix="phase25-"))
    try:
        t0 = time.perf_counter()
        ok = native.available()
        path = Path(native.library()._name)
        say25(f"  25 native: available() {ok} after {time.perf_counter() - t0:.2f} s, "
              f"{path.relative_to(ROOT)}")
        if not (ok and path.parent == ROOT / "open3dsot_tpu_torch" / "_build"):
            fail(f"phase 25: the native library is not built in open3dsot_tpu_torch/_build: {path}")
        cfg = split_cfg("m2track", SPLIT_B)
        model, _ = make_model(cfg, fused_eval=True)
        sampler = get_dataset(cfg, "test", "test")
        seqs = [sampler[i] for i in range(SPLIT_B)]
        host = scan_tracker_of(model, cfg)._prepare(seqs)[2]
        pts, counts = host[0].numpy(), host[1].numpy()
        valid = np.arange(pts.shape[2]) < counts[..., None]
        got = native.quantize_per_sample_native(pts, valid)
        want = quant._quantize_per_sample_numpy(pts, valid)
        equal = all(np.array_equal(a, b) for a, b in zip(got, want))
        t_n = host_ms(lambda: native.quantize_per_sample_native(pts, valid))
        t_p = host_ms(lambda: quant._quantize_per_sample_numpy(pts, valid))
        int16 = scan_tracker_of(model, cfg, transfer_dtype="int16")
        packing = {}
        for switch in ("1", "0"):
            os.environ["OPEN3DSOT_TPU_NATIVE"] = switch
            packing[switch] = host_ms(lambda: int16._prepare(seqs), repeats=3)
        say25(f"  25 native int16 encoder on an M2 scan batch {tuple(pts.shape)}: "
              f"{'bit-identical to' if equal else 'DIFFERS from'} numpy; {t_n:.2f} ms against "
              f"{t_p:.2f}; the int16 scan batch's host packing (_prepare) {packing['1']:.2f} ms "
              f"native, {packing['0']:.2f} ms numpy (host)")
        if not equal:
            fail("phase 25: the native int16 encoder differs from numpy")
        data = tmp / "kitti"
        write_real_kitti(data)
        _, bat_cfg = real_cfg("bat", tmp, data)
        bat, _ = make_model(bat_cfg, fused_eval=True)
        kitti = get_dataset(bat_cfg, "test", bat_cfg.test_split)
        n = REAL_NATIVE_TRACKLETS
        frames = sum(len(kitti[i]) - 1 for i in range(n))
        seq = kitti[0]
        bbs = [f["3d_bbox"] for f in seq]
        parts = {}
        for switch in ("1", "0"):  # the host's input building a frame, by part
            os.environ["OPEN3DSOT_TPU_NATIVE"] = switch
            parts[switch] = [statistics.median(
                host_ms(lambda: fn(seq, f, bbs[:f]), repeats=1) for f in range(1, len(seq)))
                for fn in (bat.generate_search_area, bat.generate_template,
                           bat.build_input_dict)]
        say25(f"  25 BAT input building a frame on the sweeps (median over {len(seq) - 1} "
              f"frames, host ms): search area {parts['1'][0]:.2f} native / {parts['0'][0]:.2f} "
              f"numpy, template {parts['1'][1]:.2f} / {parts['0'][1]:.2f}, build_input_dict "
              f"{parts['1'][2]:.2f} / {parts['0'][2]:.2f}")
        evaluate_dataset(bat, kitti, bat_cfg, max_tracklets=1)  # warm-up
        runs = {}
        for switch in ("1", "0"):
            os.environ["OPEN3DSOT_TPU_NATIVE"] = switch
            native.reset_call_counts()
            sync_card()
            t0 = time.perf_counter()
            sp = evaluate_dataset(bat, kitti, bat_cfg, max_tracklets=n)
            sync_card()
            runs[switch] = (sp, frames / (time.perf_counter() - t0), native.crop_canonical.calls)
        (sp1, r1, c1), (sp0, r0, c0) = runs["1"], runs["0"]
        say25(f"  25 BAT host loop on KITTI-format sweeps ({n} tracklets, {frames} frames): "
              f"OPEN3DSOT_TPU_NATIVE=1 {r1:.1f} frames/s, {c1} native crops, success "
              f"{sp1[0]:.4f} precision {sp1[1]:.4f}; =0 {r0:.1f} frames/s, {c0} native crops, "
              f"success {sp0[0]:.4f} precision {sp0[1]:.4f} [{card}]")
        if not (c1 > 0 and c0 == 0 and np.isfinite(sp1 + sp0).all()):
            fail(f"phase 25: the host loop's crops did not follow OPEN3DSOT_TPU_NATIVE ({c1}, {c0})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if before is None:
            os.environ.pop("OPEN3DSOT_TPU_NATIVE", None)
        else:
            os.environ["OPEN3DSOT_TPU_NATIVE"] = before


def enqueue_ms(fn, repeats: int = 5) -> float:
    """Median host time of fn() from idle cards until it returns (its work
    queued, not done), in ms; every card synchronized between calls."""
    import torch

    def sync_all():
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)

    fn()
    times = []
    for _ in range(repeats):
        sync_all()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    sync_all()
    return statistics.median(times)


def host_ms(fn, repeats: int = 5) -> float:
    """Median host wall time of fn(), in ms (no device work)."""
    fn()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def sync_card() -> None:
    import torch

    if torch.device(SPLIT_DEVICE).type == "cuda":
        torch.cuda.synchronize()


def layer_library_on_card(card: str) -> None:
    """25d: SetAbstractionMSG (FPS: K3 on the card), SetAbstractionAll,
    FeaturePropagation, FlowEmbedding and PointNetSetUpConv at small widths
    on the card against the same modules on the CPU (seeded weights and
    inputs), forward in eval and in training mode."""
    import copy

    import torch

    from open3dsot_tpu_torch.models import flow, pointnet
    from open3dsot_tpu_torch.weights import random_variables, state_dict_from_jax

    gen = torch.Generator().manual_seed(SEED)
    B, C = 4, 16
    xyz, feats = torch.rand(B, 512, 3, generator=gen) * 2 - 1, torch.randn(B, 512, C, generator=gen)
    xyz2, feats2 = torch.rand(B, 128, 3, generator=gen) * 2 - 1, torch.randn(B, 128, C,
                                                                             generator=gen)
    cases = (
        ("SetAbstractionMSG", pointnet.SetAbstractionMSG(
            C, [[32, 64], [32, 48, 64]], [0.2, 0.4], [16, 32], use_fps=True),
         (xyz, feats, 128), 1),
        ("SetAbstractionAll", pointnet.SetAbstractionAll(C, [32, 64]), (xyz, feats), 1),
        ("FeaturePropagation", pointnet.FeaturePropagation(2 * C, [64, 32]),
         (xyz, xyz2, feats, feats2), None),
        ("FlowEmbedding", flow.FlowEmbedding(0.5, 16, C, [32, 32]), (xyz, xyz2, feats, feats2), 1),
        ("PointNetSetUpConv", flow.PointNetSetUpConv(16, 0.6, C, C, [32], [32], use_knn=False),
         (xyz, xyz2, feats, feats2), None),
    )
    for name, cpu, args, i in cases:
        cpu.load_state_dict(state_dict_from_jax(random_variables(cpu, SEED)), strict=True)
        card_mod = copy.deepcopy(cpu).to(SPLIT_DEVICE)
        on_card = [a.to(SPLIT_DEVICE) if isinstance(a, torch.Tensor) else a for a in args]
        for mode in ("eval", "train"):
            for m in (cpu, card_mod):
                m.train(mode == "train")
            with torch.no_grad():
                want, got = cpu(*args), card_mod(*on_card)
            want, got = (w if i is None else w[i] for w in (want, got))
            compare(f"25 layer {name} {mode} on {SPLIT_DEVICE} against the CPU", got.cpu(), want)
        stats = [(b.cpu().flatten(), a.flatten()) for (k, a), b in
                 zip(cpu.named_buffers(), card_mod.buffers()) if "running" in k]
        compare(f"25 layer {name} running statistics after the training forward",
                torch.cat([g for g, _ in stats]), torch.cat([w for _, w in stats]))


def scan_split_phase(card: str) -> None:
    """Phase 25 (see the module docstring), its lines also in
    chiprun_out/phase25.txt, which each run writes anew."""
    import torch

    t_phase = time.perf_counter()
    PHASE25_LOG.parent.mkdir(exist_ok=True)
    if PHASE25_LOG.exists():
        PHASE25_LOG.unlink()
    devices = [SPLIT_DEVICE, SPLIT_DEVICE]
    for name, label, kw in (("m2track", "M2 f32", {}),
                            ("m2track", "M2 bf16", {"compute_dtype": torch.bfloat16}),
                            ("bat", "BAT_Car", {}), ("p2b", "P2B_Car", {})):
        split_case(name, label, devices, card, **kw)
    scan_split_cards(card)
    native_phase(card)
    layer_library_on_card(card)
    say25(f"phase 25 ok in {time.perf_counter() - t_phase:.1f} s")


# --- 26. every shape the Pallas kernels take ------------------------------------
# K6 forward and backward: (C1, C2, C3), (B, N, S, K), timed. The last has more
# than 65535 partials of y1's statistics (R > 65535 x 512 rows) and of the max
# gradient's (B S > 65535 x 64 centroids): more than a grid's y holds
DOMAIN_K6 = (((512, 512, 512), (4, 256, 64, 32), True), ((30, 50, 70), (4, 256, 64, 32), True),
             ((8, 8, 8), (2048, 64, 2100, 8), False))
# K4: (label, widths, nsample) on B clouds of N points with 13 feature channels, S centroids
DOMAIN_K4 = (("nsample 128", (64, 64, 128), 128), ("wide", (512, 512, 1024), 32),
             ("ragged", (30, 50, 70), 20), ("wider than a bf16 h2 tile", (64, 1536, 128), 32))
DOMAIN_K4_SHAPE = (4, 4096, 256)
# K1 (label, widths, tap_at) on (B, N); a tap is followed by K2 (its first width 36)
DOMAIN_CHAINS = (("a tap of 60 and a 2048-wide layer", [13, 60, 2048, 256], 0),
                 ("a 4096-wide layer's input streamed", [13, 64, 4096, 128], None))
DOMAIN_CHAIN_SHAPE = (2, 4096)
DOMAIN_K3 = (2, 65536, 1024)  # B, N, npoint
PHASE26_LOG = ROOT / "chiprun_out" / "phase26.txt"


def say26(line: str) -> None:
    say(line, PHASE26_LOG)


def domain_time(kernel, plain, bound, card: str, what: str) -> tuple:
    """Event times of a kernel call and its plain version (plain, kernel,
    plain), printed with the bound (ms, what bounds it) -> (ms, plain ms)."""
    t_p = time_ms(plain, iters=3, repeats=3)
    t_k = time_ms(kernel, iters=3, repeats=3)
    t_p = min(t_p, time_ms(plain, iters=3, repeats=3))
    say26(f"  time {what}: kernel {t_k:.4f} ms plain {t_p:.4f} ms; bound {bound[0]:.5f} ms "
          f"by {bound[1]} [{card}]")
    return t_k, t_p


def domain_k6(card: str, rows: dict) -> None:
    """26a: K6 forward and backward, f32 (3xTF32) and bf16, at DOMAIN_K6 on
    random inputs against the plain versions (phases 11 and 19's tolerances
    and checks); at 512 in f32 also the ordered da and the staged entries in
    a world of one."""
    import torch

    from open3dsot_tpu_torch.ops import sa_fused_train as k6
    from open3dsot_tpu_torch.ops.chain_fused import pad_to, round4

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    for widths, (B, N, S, K), timed in DOMAIN_K6:
        first = widths == DOMAIN_K6[0][0]
        c1, c2, c3 = widths
        P = [round4(c) for c in widths]
        a, ct = rnd(B, N, c1), rnd(B, S, c1, scale=0.1)
        ab = a.to(torch.bfloat16).float()
        idx = torch.randint(0, N, (B, S, K), device="cuda", generator=gen, dtype=torch.int32)
        w2, w3 = rnd(c1, c2, scale=c1 ** -0.5), rnd(c2, c3, scale=c2 ** -0.5)
        b2, b3 = rnd(c2, scale=0.1), rnd(c3, scale=0.1)
        bn = [1.0 + rnd(c, scale=0.1) if i == 0 else rnd(c, scale=0.1)
              for c in widths for i in range(2)]
        wb = (w2, b2, w3, b3, bn)
        g = rnd(B, S, c3).to(torch.bfloat16).float()
        shape = f"B={B} N={N} S={S} K={K} C={c1},{c2},{c3}"
        work = k6_work(B, N, S, K, c1, c2, c3)
        # f32
        packs = k6.Packs(w2, w3, False)
        k6.reset_launch_counts()
        out_k, st_k, _ = k6.sa_train_fwd_kernel(a, ct, idx, *wb, packs)
        out_p, st_p, grids = k6.sa_train_fwd_plain(a, ct, idx, *wb)
        grids_k = tuple(pad_to(y, p) for y, p in zip(grids, P[1:]))  # the kernel's widths
        bargs = (g, a, ct, idx)
        bwd_k = lambda: k6.sa_train_bwd_kernel(*bargs, grids_k, st_p, *wb, packs)  # noqa: E731
        gk = bwd_k()
        gp = k6.sa_train_bwd_plain(*bargs, grids, st_p, *wb)
        torch.cuda.synchronize()
        launches = (k6.fused_sa_train_apply.fwd_launches, k6.fused_sa_train_apply.bwd_launches)
        say26(f"  26a K6 f32 {shape}: launches (fwd, bwd) {launches}")
        if launches != (1, 1):
            fail(f"K6 f32 {shape}: launched {launches}, expected one forward and one backward")
        e_f = max([compare(f"26a K6 f32 fwd {shape} out", out_k, out_p)] +
                  [compare(f"26a K6 f32 fwd {shape} stat {i}", x, y)
                   for i, (x, y) in enumerate(zip(st_k, st_p))])
        names = ("da", "dct", "dW2", "dW3", "dgamma,dbeta")
        pairs = [(gk[i], gp[i]) for i in range(4)] + [(torch.cat(gk[4]), torch.cat(gp[4]))]
        if timed:
            e_b = max(compare(f"26a K6 f32 bwd {shape} {n}", x, y) for n, (x, y) in
                      zip(names, pairs))
        else:  # sums over 34M rows in f32 part from float64 by ~1e-4 on both paths (the
            # plain one's cuBLAS too): each held to at most 4x the plain path's distance
            # from the float64 backward on the same inputs (phase 12's rule)
            d = lambda t: t.double()  # noqa: E731
            t64 = k6.sa_train_bwd_plain(d(g), d(a), d(ct), idx, tuple(map(d, grids)),
                                        [d(x) for x in st_p], d(w2), d(b2), d(w3), d(b3),
                                        [d(x) for x in bn])
            e_b = 0.0
            for n, (x, y), w in zip(names, pairs, [t64[i] for i in range(4)] + [torch.cat(t64[4])]):
                e_k, e_p = rel_err(d(x), w), rel_err(d(y), w)
                e_b = max(e_b, (x - y).abs().max().item())
                say26(f"  26a K6 f32 bwd {shape} {n}: rel err vs float64 kernel {e_k:.3e} plain "
                      f"{e_p:.3e}")
                if e_k > max(4 * e_p, 1e-4):
                    fail(f"26a K6 f32 bwd {shape} {n}: {e_k:.3e} from float64, plain {e_p:.3e}")
            del t64
        if first:
            da_o = check_ordered(f"26a K6 f32 bwd {shape}", bwd_k, gk, compare)
            e_b = max(e_b, compare(f"26a K6 f32 bwd {shape} da ordered", da_o, gp[0]))
            k6.reset_launch_counts()
            out_s, st_s, grids_s = k6.sa_train_fwd_kernel(a, ct, idx, *wb, packs, staged=True)
            gs = k6.sa_train_bwd_kernel(*bargs, grids_k, st_p, *wb, packs, staged=True)
            torch.cuda.synchronize()
            staged = (k6.fused_sa_train_apply.staged_fwd_launches,
                      k6.fused_sa_train_apply.staged_bwd_launches)
            if staged != (1, 1):
                fail(f"26a K6 staged {shape}: launched {staged}, expected (1, 1)")
            if not (torch.equal(out_s, out_k) and all(map(torch.equal, st_s, st_k))):
                fail(f"26a K6 staged forward {shape}: not the single call's bit for bit")
            for i, name in enumerate(("dct", "dW2", "dW3")):
                e_b = max(e_b, compare(f"26a K6 f32 staged bwd {shape} {name}", gs[i + 1],
                                       gp[i + 1]))
            e_b = max(e_b, compare(f"26a K6 f32 staged bwd {shape} da", gs[0], gp[0]))
            say26(f"  26a K6 staged {shape} in a world of one: forward the single call's bit for "
                  f"bit; backward within tolerance of the plain version")
        fns = (lambda: k6.sa_train_fwd_kernel(a, ct, idx, *wb, packs),
               lambda: k6.sa_train_fwd_plain(a, ct, idx, *wb), bwd_k,
               lambda: k6.sa_train_bwd_plain(*bargs, grids, st_p, *wb))
        if timed:
            t_f = domain_time(fns[0], fns[1], tc_bound_of(*work[0]), card,
                              f"26a K6 f32 fwd {shape}")
            t_b = domain_time(fns[2], fns[3], tc_bound_of(*work[1]), card,
                              f"26a K6 f32 bwd {shape}")
        if first:
            rows["k6"] = dict(err=(e_f, e_b), fwd=t_f, bwd=t_b, work=work)
        # bf16
        packs_b = k6.Packs(w2, w3, True)
        y3_k = torch.empty(B, S, K, c3, device="cuda")
        k6.reset_launch_counts()
        out_k, st_k, grids_k = k6.sa_train_fwd_kernel(a, ct, idx, *wb, packs_b, y3_out=y3_k)
        out_p, st_p, grids_p = k6.sa_train_fwd_plain(ab, ct, idx, *wb, True)
        out_f, st_f, grids_f = k6.sa_train_fwd_plain(a, ct, idx, *wb)
        gk = k6.sa_train_bwd_kernel(*bargs, grids_k, st_k, *wb, packs_b)
        gp = k6.sa_train_bwd_plain(g, ab, ct, idx, grids_k, st_k, *wb, True, y3=y3_k)
        gf = k6.sa_train_bwd_plain(*bargs, grids_f, st_f, *wb)
        torch.cuda.synchronize()
        launches = (k6.fused_sa_train_apply.bf16_fwd_launches,
                    k6.fused_sa_train_apply.bf16_bwd_launches)
        say26(f"  26a K6 bf16 {shape}: launches (fwd, bwd) {launches}")
        if launches != (1, 1):
            fail(f"K6 bf16 {shape}: launched {launches}, expected one forward and one backward")
        compare_bf16(f"26a K6 bf16 fwd {shape} out", out_k, out_p, out_f)
        y3_h2 = grids_k[1][..., :c2].float() @ w3.to(torch.bfloat16).float() + b3
        compare_y3(f"26a K6 bf16 fwd {shape} y3 of the max pass", y3_k, y3_h2)
        cat = lambda x: [x[i] for i in range(4)] + [torch.cat(x[4])]  # noqa: E731
        if not timed:
            # 34M rows: the bf16 products' f32 sums part from float64 as the f32 mode's do
            # (the f32 case above); each held to 10x the plain bf16 path's distance from the
            # same function summed in float64 (tests/test_torch_train_bf16.py's factor for a
            # bf16 step's distance from float64)
            d = lambda t: t.double()  # noqa: E731
            t64 = k6.sa_train_bwd_plain(d(g), d(ab), d(ct), idx, grids_k, [d(x) for x in st_k],
                                        d(w2), d(b2), d(w3), d(b3), [d(x) for x in bn], True,
                                        y3=d(y3_k))
            for name, x, y, w in zip(names, cat(gk), cat(gp), cat(t64)):
                e_k, e_p = rel_err(d(x), w), rel_err(d(y), w)
                say26(f"  26a K6 bf16 bwd {shape} {name}: rel err vs float64 kernel {e_k:.3e} "
                      f"plain {e_p:.3e}")
                if e_k > max(10 * e_p, 1e-4):
                    fail(f"26a K6 bf16 bwd {shape} {name}: {e_k:.3e} from float64, plain "
                         f"{e_p:.3e}")
            continue
        for name, x, y, f in zip(names, cat(gk), cat(gp), cat(gf)):
            compare_bf16(f"26a K6 bf16 bwd {shape} {name}", x, y, f)
        work_b = k6_work(B, N, S, K, c1, c2, c3, bf16=True)
        domain_time(lambda: k6.sa_train_fwd_kernel(a, ct, idx, *wb, packs_b),
                    lambda: k6.sa_train_fwd_plain(ab, ct, idx, *wb, True), bf16_bound(work_b[0]),
                    card, f"26a K6 bf16 fwd {shape}")
        domain_time(lambda: k6.sa_train_bwd_kernel(*bargs, grids_k, st_k, *wb, packs_b),
                    lambda: k6.sa_train_bwd_plain(g, ab, ct, idx, grids_k, st_k, *wb, True,
                                                  y3=y3_k),
                    bf16_bound(work_b[1]), card, f"26a K6 bf16 bwd {shape}")


def domain_k4(card: str, rows: dict) -> None:
    """26b: K4 (ball query in the kernel) in both modes at DOMAIN_K4 against
    sa_eval_plain; which path took each shape (the rows path where K > 64 or
    the tiles do not fit); K5 past one tile with an index out of range (its
    centroid NaN, the others unchanged)."""
    import torch

    from open3dsot_tpu_torch.ops import sa_fused as saf

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    B, N, S = DOMAIN_K4_SHAPE
    xyz = torch.rand(B, N, 3, device="cuda", generator=gen)
    feats = torch.randn(B, N, 13, device="cuda", generator=gen)
    new = xyz[:, :S].contiguous()
    kw = dict(radius=0.3, normalize_xyz=True, use_xyz=True)
    for label, widths, K in DOMAIN_K4:
        dims = (16,) + widths
        layers = [(torch.randn(k, c, device="cuda", generator=gen) * k ** -0.5,
                   torch.randn(c, device="cuda", generator=gen) * 0.1)
                  for k, c in zip(dims[:-1], dims[1:])]
        walked = bq_walked(xyz, new, kw["radius"], K)
        for bf16 in (False, True):
            mode = "bf16" if bf16 else "f32"
            folded = saf.FoldedSA(layers, dtype=torch.bfloat16 if bf16 else None)
            shape = f"{label} B={B} N={N} S={S} K={K} C={','.join(map(str, widths))} {mode}"
            k4 = lambda: saf.fused_sa_apply(xyz, feats, new, None, folded, nsample=K, **kw)  # noqa: E731
            plain = lambda: saf.sa_eval_plain(xyz, feats, new, None, folded, nsample=K,  # noqa: E731
                                              dtype=folded.dtype, **kw)
            saf.reset_launch_counts()
            got = k4()
            torch.cuda.synchronize()
            launches = (saf.fused_sa_apply.launches, saf.fused_sa_apply.rows_launches)
            want = plain()
            if bf16:
                f32 = saf.sa_eval_plain(xyz, feats, new, None, layers, nsample=K, **kw)
                err = compare_bf16(f"26b K4 {shape}", got, want, f32)
            else:
                err = compare(f"26b K4 {shape}", got, want)
            rows_path = launches[1] == 1
            say26(f"  26b K4 {shape}: launches {launches[0]}, on the "
                  f"{'rows path' if rows_path else 'tile kernel'}")
            if launches[0] != 1 or (K > saf.TILE_K and not rows_path):
                fail(f"26b K4 {shape}: launches {launches}; K > {saf.TILE_K} takes the rows path")
            work = (bf16_sa_work if bf16 else sa_work)(xyz, feats, new, folded, K, walked)
            bound = bf16_bound(work) if bf16 else tc_bound_of(*work)
            t = domain_time(k4, plain, bound, card, f"26b K4 {shape}")
            if label == "nsample 128":
                rows[f"k4 {mode}"] = dict(err=err, t=t, work=work, bf16=bf16)
    # K5 past one tile: an index outside [0, N) makes its centroid NaN alone
    folded = saf.FoldedSA(layers)
    K = DOMAIN_K4[0][2]
    from open3dsot_tpu_torch.ops.neighbors import ball_query

    idx = ball_query(kw["radius"], K, xyz, new)
    good = saf.fused_sa_apply(xyz, feats, new, idx, folded, **kw)
    idx[1, 5, 100] = N
    bad = saf.fused_sa_apply(xyz, feats, new, idx, folded, **kw)
    keep = torch.ones(bad.shape[:2], dtype=torch.bool, device=bad.device)
    keep[1, 5] = False
    ok = bool(torch.isnan(bad[1, 5]).all()) and torch.equal(bad[keep], good[keep])
    say26(f"  26b K5 K={K}, index {N} at centroid 5 of cloud 1 (rows path): its output "
          f"{'NaN' if torch.isnan(bad[1, 5]).all() else 'not NaN'}, the others "
          f"{'unchanged' if torch.equal(bad[keep], good[keep]) else 'changed'}")
    if not ok:
        fail("26b K5 past one tile: an index outside [0, N) did not give its centroid NaN alone")


def domain_chains(card: str, rows: dict) -> None:
    """26c: K1 (and K2 after a tap) in both modes at DOMAIN_CHAINS against
    their plain versions: a ragged tap of 60 with K2's first width 36, and a
    layer whose input (4096 channels) is streamed from device memory."""
    import torch

    from open3dsot_tpu_torch.ops import chain_fused as cf

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    B, N = DOMAIN_CHAIN_SHAPE

    def layers_of(widths):
        return [(torch.randn(k, c, device="cuda", generator=gen) * (2.0 / k) ** 0.5,
                 torch.randn(c, device="cuda", generator=gen) * 0.1)
                for k, c in zip(widths[:-1], widths[1:])]

    x = torch.randn(B, N, 13, device="cuda", generator=gen)
    for label, widths, tap_at in DOMAIN_CHAINS:
        layers = layers_of(widths)
        head = None
        if tap_at is not None:
            head = layers_of([widths[tap_at + 1] + widths[-1], 36, 11])
        for bf16 in (False, True):
            mode = "bf16" if bf16 else "f32"
            dtype = torch.bfloat16 if bf16 else None
            chain = cf.FoldedChain(layers, dtype=dtype)
            shape = f"{label} B={B} N={N} widths {'-'.join(map(str, widths))} {mode}"
            cf.reset_launch_counts()
            tap, pooled = cf.fused_pointnet_encoder(x, chain, tap_at=tap_at)
            torch.cuda.synchronize()
            launches = cf.fused_pointnet_encoder.launches
            p_tap, p_pooled = cf.pointnet_encoder_plain(x, chain, tap_at=tap_at)
            f_tap, f_pooled = cf.pointnet_encoder_plain(x, cf.FoldedChain(layers), tap_at=tap_at)
            cmp = ((lambda n, a, b, f: compare_bf16(n, a, b, f, control=False)) if bf16 else
                   (lambda n, a, b, f: compare(n, a, b)))
            err = cmp(f"26c K1 {shape} pooled", pooled, p_pooled, f_pooled)
            if tap_at is not None:
                err = max(err, cmp(f"26c K1 {shape} tap", tap, p_tap, f_tap))
                hchain = cf.FoldedChain(head, split=widths[tap_at + 1], dtype=dtype)
                cf.reset_launch_counts()
                out = cf.fused_seg_head(tap, pooled, hchain)
                torch.cuda.synchronize()
                launches = (launches, cf.fused_seg_head.launches)
                cmp(f"26c K2 {shape} logits (first width 36)", out,
                    cf.seg_head_plain(tap, pooled, hchain),
                    cf.seg_head_plain(tap, pooled, cf.FoldedChain(head, split=widths[tap_at + 1])))
            say26(f"  26c {shape}: launches (K1, K2) {launches}")
            if launches not in (1, (1, 1)):
                fail(f"26c {shape}: launches {launches}, expected one of each")
            k1 = lambda: cf.fused_pointnet_encoder(x, chain, tap_at=tap_at)  # noqa: E731
            pl = lambda: cf.pointnet_encoder_plain(x, chain, tap_at=tap_at)  # noqa: E731
            tap_elems = 0 if tap_at is None else B * N * widths[tap_at + 1]
            work = (bf16_chain_work(chain, B, N, B * widths[-1], tap_elems) if bf16 else
                    k1_work(chain, B, N, tap_at))
            bound = bf16_bound(work) if bf16 else tc_bound_of(*work)
            t = domain_time(k1, pl, bound, card, f"26c K1 {shape}")
            if tap_at is None and not bf16:
                rows["k1"] = dict(err=err, t=t, work=work)


def domain_k3(card: str, rows: dict) -> None:
    """26d: K3 past 32768 points (a cluster of blocks) against its plain
    version, index for index."""
    import torch

    from open3dsot_tpu_torch.ops import sampling

    B, N, npoint = DOMAIN_K3
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    xyz = torch.randn(B, N, 3, device="cuda", generator=gen)
    sampling.reset_launch_counts()
    got = sampling.furthest_point_sample(xyz, npoint)
    torch.cuda.synchronize()
    launches = (sampling.furthest_point_sample.launches,
                sampling.furthest_point_sample.cluster_launches)
    want = sampling.furthest_point_sample_plain(xyz, npoint)
    same = int((got != want).sum())
    say26(f"  26d K3 B={B} N={N} npoint={npoint}: launches (all, cluster) {launches}; "
          f"{same} of {got.numel()} indices differ from the plain version's")
    if launches != (1, 1) or same:
        fail(f"26d K3 N={N}: launches {launches}, {same} indices differ")
    k3 = lambda: sampling.furthest_point_sample(xyz, npoint)  # noqa: E731
    pl = lambda: sampling.furthest_point_sample_plain(xyz, npoint)  # noqa: E731
    work = k3_work(B, N, npoint)
    rows["k3"] = dict(t=domain_time(k3, pl, bound_of(*work), card,
                                    f"26d K3 B={B} N={N} npoint={npoint}"), work=work)


def domain_layers(card: str, rows: dict) -> None:
    """26e: the model-level paths, counts set to 0 before each and read after:
    a BAT SetAbstraction in training at width 512 (K6 forward and backward)
    against the same layer's plain path, and one in eval at nsample 128 on
    clouds of 65536 points (K3 over a cluster, K4 on the rows path) in f32
    and bf16 against its plain path."""
    import copy

    import torch

    from open3dsot_tpu_torch.models.layers import set_compute_dtype
    from open3dsot_tpu_torch.models.pointnet import SetAbstraction
    from open3dsot_tpu_torch.ops import sa_fused as saf
    from open3dsot_tpu_torch.ops import sa_fused_train as k6
    from open3dsot_tpu_torch.ops import sampling

    torch.manual_seed(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    # training, width 512: BAT's SA2 with its MLP widened
    B, N, S = 4, 1024, 128
    xyz = torch.rand(B, N, 3, device="cuda", generator=gen)
    feats = torch.randn(B, N, 128, device="cuda", generator=gen)
    sa = SetAbstraction(128, [512, 512, 512], 0.3, 32, use_fps=True, normalize_xyz=True,
                        fused_train=True).cuda().train()
    plain = copy.deepcopy(sa)
    plain.fused_train = False
    truth = copy.deepcopy(plain).double()
    truth.fused_eval = False  # the plain FPS (K3 takes f32): the same indices
    g = torch.randn(B, S, 512, device="cuda", generator=gen)
    res = {}
    for name, mod in (("kernel", sa), ("plain", plain), ("float64", truth)):
        dt = torch.float64 if name == "float64" else torch.float32
        tx, tf = (t.to(dt).clone().requires_grad_() for t in (xyz, feats))
        k6.reset_launch_counts()
        _, out, _ = mod(tx, tf, S)
        (out * g.to(dt)).sum().backward()
        torch.cuda.synchronize()
        res[name] = dict({"out": out.detach(), "grad xyz": tx.grad, "grad features": tf.grad},
                         **{f"grad {n}": p.grad for n, p in mod.named_parameters()},
                         **{n: b for n, b in mod.named_buffers() if "running" in n})
        if name == "kernel":
            rows["k6 launches"] = (k6.fused_sa_train_apply.fwd_launches,
                                   k6.fused_sa_train_apply.bwd_launches)
    say26(f"  26e SA training at width 512 (B={B} N={N} S={S} K=32): K6 launches (fwd, bwd) "
          f"{rows['k6 launches']}")
    if rows["k6 launches"] != (1, 1):
        fail(f"26e SA training at width 512: K6 launched {rows['k6 launches']}, expected (1, 1)")
    got, ref, f64 = res["kernel"], res["plain"], res["float64"]
    compare("26e SA train 512 out", got["out"], ref["out"])
    for k in got:
        if "running" in k:
            compare(f"26e SA train 512 {k}", got[k], ref[k])
    # the gradients against the float64 path, as phase 12 holds a train step's: a near-tie
    # of the max that the two f32 paths break apart routes one share of a gradient to
    # another neighbour, so each is held to at most 4x the plain f32 path's distance
    # each against at least 1e-3 of the largest gradient (phase 12's floor): every Dense
    # bias here feeds a BatchNorm, so its gradient is 0 in exact arithmetic
    floor = 1e-3 * max(torch.linalg.vector_norm(v).item() for k, v in f64.items()
                       if k.startswith("grad "))
    for k in (k for k in got if k.startswith("grad ")):
        if k.endswith(("layer1.dense.bias", "layer2.dense.bias")):
            if got[k].any():  # K6 returns these two as exact zeros
                fail(f"26e SA train 512: {k} is not 0")
            continue
        e_k, e_p = (rel_err(x[k].double(), f64[k], floor) for x in (got, ref))
        limit = max(4 * e_p, 1e-4)
        if e_k > limit:
            fail(f"26e SA train 512 {k}: {e_k:.3e} from float64, the plain path {e_p:.3e}")
        say26(f"  26e SA train 512 {k}: rel err vs float64 kernel path {e_k:.3e} plain path "
              f"{e_p:.3e} ok")
    # eval, nsample 128, 65536 points a cloud
    B, N, S = DOMAIN_K3[0], DOMAIN_K3[1], DOMAIN_K3[2]
    xyz = torch.rand(B, N, 3, device="cuda", generator=gen)
    feats = torch.randn(B, N, 32, device="cuda", generator=gen)
    sa = SetAbstraction(32, [64, 64, 128], 0.1, 128, use_fps=True, normalize_xyz=True).cuda().eval()
    for mode in ("f32", "bf16"):
        if mode == "bf16":
            set_compute_dtype(sa, torch.bfloat16)
        sa.fused_eval = True
        saf.reset_launch_counts()
        sampling.reset_launch_counts()
        with torch.no_grad():
            new_k, out_k, _ = sa(xyz, feats, S)
        torch.cuda.synchronize()
        launches = (sampling.furthest_point_sample.cluster_launches,
                    saf.fused_sa_apply.launches, saf.fused_sa_apply.rows_launches)
        rows[f"eval launches {mode}"] = launches
        sa.fused_eval = False
        with torch.no_grad():
            new_p, out_p, _ = sa(xyz, feats, S)
        torch.cuda.synchronize()
        say26(f"  26e SA eval at nsample 128 ({mode}, B={B} N={N} S={S}): launches (K3 cluster, "
              f"K4, K4 rows path) {launches}; centroids "
              f"{'equal' if torch.equal(new_k, new_p) else 'DIFFER'}")
        if launches != (1, 1, 1) or not torch.equal(new_k, new_p):
            fail(f"26e SA eval at nsample 128 ({mode}): launches {launches}, or centroids differ")
        if mode == "bf16":  # against the plain bf16 version in A-form, the f32 one outside
            kw = dict(radius=sa.radius, normalize_xyz=sa.normalize_xyz, use_xyz=sa.use_xyz,
                      nsample=sa.nsample)
            want = saf.sa_eval_plain(xyz, feats, new_k, None, sa.folded_chains(),
                                     dtype=torch.bfloat16, **kw)
            set_compute_dtype(sa, None)
            f32 = saf.sa_eval_plain(xyz, feats, new_k, None, sa.folded_chains(), **kw)
            compare_bf16("26e SA eval nsample 128 bf16 out", out_k, want, f32)
        else:
            compare("26e SA eval nsample 128 out", out_k, out_p)


def domain_shipped(card: str) -> None:
    """26f: K4 at B = 16 (the 7 SA calls of a BAT forward back to back) and
    K6 at B = TRAIN_B (the 4 calls of a BAT train step) on the shipped widths,
    device time, to set beside PERF.md's (1.3141 ms; 3.3756 / 9.2754 ms). By
    events behind a queued sleep (`queued_ms`), as phase 19 times: late in a
    whole run the profiler's windows here came back short (a K6 backward of
    3.07 ms against 9.2 in my chip call 12, PR 19)."""
    import numpy as np
    import torch

    from open3dsot_tpu_torch.data import get_dataset
    from open3dsot_tpu_torch.ops import sa_fused as saf
    from open3dsot_tpu_torch.ops import sa_fused_train as k6
    from open3dsot_tpu_torch.ops.neighbors import ball_query
    from open3dsot_tpu_torch.ops.sa_fused import a_form

    cfg = matching_cfg("bat")
    model, variables = make_model(cfg, fused_eval=True)
    plain_model, _ = make_model(cfg, fused_eval=False, variables=variables)
    frames = matching_frames(model, get_dataset(cfg, "test", "test"), 16)
    batch16 = {k: np.concatenate([f[k] for f in frames]) for k in frames[0]}
    calls = []
    for label, mod, xyz, feats, new in sa_calls(plain_model, batch16):
        kw = dict(radius=mod.radius, normalize_xyz=mod.normalize_xyz, use_xyz=mod.use_xyz,
                  nsample=mod.nsample)
        calls.append(lambda xyz=xyz, feats=feats, new=new, f=mod.folded_chains(), kw=kw:
                     saf.fused_sa_apply(xyz, feats, new, None, f, **kw))
    # a sleep of about 10 ms: the host enqueues the 70 calls (each with a_rows' matmuls and
    # allocations) before the card reaches them; behind the default 1 ms it set the pace
    # (1.6198 ms against the profiler's 1.3143 in phase 7, my chip call 13, PR 19)
    total = queued_ms(lambda: [f() for f in calls], iters=10, sleep=20_000_000)
    say26(f"  26f K4, the 7 SA calls of a BAT forward back to back, B=16: device (queued "
          f"events) {total:.4f} ms (PERF.md: 1.3141 ms, PR 6) [{card}]")
    sums = [0.0, 0.0]
    for label, mod, xyz, feats, new in bat_k6_calls():
        layers = list(mod.mlp_shared.children())
        w2, w3 = (l.dense.weight.detach().t().contiguous() for l in layers[1:])
        b2, b3 = (l.dense.bias.detach() for l in layers[1:])
        bn = [p.detach() for l in layers for p in (l.bn.weight, l.bn.bias)]
        idx = ball_query(mod.radius, mod.nsample, xyz, new)
        inv_r = 1.0 / mod.radius if mod.normalize_xyz else 1.0
        a, ct = a_form(xyz, feats, new, layers[0].dense.weight.detach().t(),
                       layers[0].dense.bias.detach(), inv_r=inv_r, use_xyz=mod.use_xyz)
        packs = k6.Packs(w2, w3, False)
        with torch.no_grad():
            out, st, grids = k6.sa_train_fwd_kernel(a, ct, idx, w2, b2, w3, b3, bn, packs)
            g = torch.randn_like(out)
            d_f = queued_ms(lambda: k6.sa_train_fwd_kernel(a, ct, idx, w2, b2, w3, b3, bn, packs),
                            iters=5)
            d_b = queued_ms(lambda: k6.sa_train_bwd_kernel(g, a, ct, idx, grids, st, w2, b2, w3,
                                                           b3, bn, packs), iters=5)
        sums = [sums[0] + d_f, sums[1] + d_b]
    say26(f"  26f K6, the 4 calls of a BAT train step, B={TRAIN_B}: device (queued events) "
          f"forward {sums[0]:.4f} ms, backward {sums[1]:.4f} ms (PERF.md: 3.3756 / 9.2754 ms, "
          f"PR 12) [{card}]")


def domain_phase(card: str) -> list:
    """Phase 26 (see the module docstring); its lines also in
    chiprun_out/phase26.txt. Returns the kernels line's rows of the paths
    this phase adds."""
    import torch

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()  # 26a's 34M-row K6 case holds about 43 GB at its peak
    PHASE26_LOG.parent.mkdir(exist_ok=True)
    if PHASE26_LOG.exists():
        PHASE26_LOG.unlink()
    say26(f"phase 26 on {card}")
    rows = {}
    domain_layers(card, rows)
    domain_k6(card, rows)
    domain_k4(card, rows)
    domain_chains(card, rows)
    domain_k3(card, rows)
    domain_shipped(card)
    k6r = rows["k6"]
    entries = [
        kernel_entry("K6 fused_sa_train_apply (forward, width 512: vectors in device memory)",
                     "sa_fused_train.cu", "open3dsot_tpu/ops/sa_fused_train.py:608-668",
                     rows["k6 launches"][0], k6r["err"][0], *k6r["fwd"], k6r["work"][0],
                     tensor_core=True),
        kernel_entry("K6 fused_sa_train_apply (backward, width 512: vectors in device memory)",
                     "sa_fused_train.cu", "open3dsot_tpu/ops/sa_fused_train.py:709-776",
                     rows["k6 launches"][1], k6r["err"][1], *k6r["bwd"], k6r["work"][1],
                     tensor_core=True),
        kernel_entry("K3 furthest_point_sample (a cluster of 8 blocks, N > 32768)", "fps.cu",
                     "open3dsot_tpu/ops/fps_pallas.py:69", rows["eval launches f32"][0], 0.0,
                     *rows["k3"]["t"], rows["k3"]["work"]),
        kernel_entry("K1 fused_pointnet_encoder (a layer's input streamed, 4096 wide)",
                     "chain_fused.cu", "open3dsot_tpu/ops/chain_fused.py:150", 1,
                     rows["k1"]["err"], *rows["k1"]["t"], rows["k1"]["work"], tensor_core=True),
    ]
    for mode in ("f32", "bf16"):
        r = rows[f"k4 {mode}"]
        entries.append(kernel_entry(
            f"K4/K5 fused_sa_apply, the rows path (K > 64 or wide tiles, {mode})",
            "sa_fused_train.cu", "open3dsot_tpu/ops/sa_fused.py:384, 415",
            rows[f"eval launches {mode}"][2], r["err"], *r["t"], r["work"],
            tensor_core=not r["bf16"], peak=PEAK_BF16_FLOPS))
    say26(f"phase 26 ok in {time.perf_counter() - t_phase:.1f} s: every edge shape on a hand "
          f"kernel within its tolerance")
    return entries


if __name__ == "__main__":
    main()
