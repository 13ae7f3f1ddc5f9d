"""CLI entry point of the port, for M2-Track, BAT and P2B.

    python -m open3dsot_tpu_torch.main --cfg cfgs/BAT_synthetic.yaml \
        [--epoch N] [--batch_size B] [--seed S] [--log_dir DIR] [--workers W] \
        [--check_val_every_n_epoch E] [--save_top_k K] [--device_sampler \
        [--transfer_quant int16]] [--device cuda]                           # train
    python -m open3dsot_tpu_torch.main --cfg cfgs/M2_track_synthetic.yaml --test \
        [--checkpoint ckpt_best.pt] [--max_tracklets N] [--device cuda] [--bf16] \
        [--save_results R.jsonl] [--tracker scan [--host_metrics] \
        [--transfer_quant int16] [--eval_prep_cache DIR]]                   # eval
    ... [--num_devices N [--dist_backend gloo]]                      # N ranks

Flags keep the JAX CLI's names (main.py); a flag given overrides the YAML,
and `--preloading` and `--save_top_k` override it even at their defaults
(False and -1), as in the JAX CLI and the reference. `--fused_sa` /
`--fused_sa_train` (true / false / auto; the config keys of the same names)
choose the kernels of eval (K1/K2, K3/K4) and of training (K6): `auto` is
on, the card being the accelerator; `false` is the plain path, by the
user's choice. `--category_name` names the class (the synthetic dataset
makes one class whatever its name).
Eval runs the host loop (`--tracker host`, tracking/eval.py) for every
model, or the batched device-resident scan tracker (`--tracker scan`:
tracking/scan_tracker.py for M2-Track, tracking/scan_matching.py for BAT
and P2B): on-device scoring by default, host scoring with
`--host_metrics`, frame points shipped as int16 with `--transfer_quant
int16`. `--bf16` (or `bf16: true` in the YAML) computes in bf16, in eval on
either path and in training (the kernels in their bf16 mode); parameters,
gradients, the Adam state and the statistics stay f32. `--save_results`
writes each tracklet's trajectory and per-frame scores as JSONL
(tracking/results.py); `--eval_prep_cache DIR` keeps the scan tracker's
packed batches on disk (tracking/prep_store.py), so a later eval of the same
data and settings neither decodes the dataset nor pads a frame (ignored
with `--save_results`, whose host-scored loop needs the frames).
`--num_devices N` runs N ranks, one card each (parallel/distributed.py):
without `RANK` in the environment this command starts them itself, as
torchrun would (`python -m torch.distributed.run --nproc_per_node N -m
open3dsot_tpu_torch.main ...` runs the same ranks, and then N, where given,
must equal the world size). The backend is NCCL on cards and gloo on the
CPU; `--dist_backend gloo` lets ranks share a card. Eval spreads the
tracklets over the ranks (`shard_across_processes`, on every eval path) and
sums the metrics; with `--save_results R.jsonl` rank r > 0 writes its
tracklets to `R.rank{r}.jsonl`. Training is data-parallel
(train/trainer.py): the global batch `batch_size` is split over the ranks;
where it does not divide, this command starts gcd(batch_size, N) ranks, as
JAX's Trainer shrinks its mesh.
Training runs every model through `train/trainer.py`: M2-Track on the
motion sampler (`train_motion`), BAT and P2B on the siamese one
(`train_siamese`), starting from random weights made from the seed
(weights.random_variables). `--checkpoint` is a trainer checkpoint
(`ckpt_best.pt`, `ckpt_last.pt`) or a file written by
`torch.save(model.net.state_dict(), path)`; without one the weights are
random, made from the seed. A released Lightning `.ckpt` of the reference
is refused here: `python -m open3dsot_tpu_torch.eval_released_ckpt` imports
and evaluates one. `--device_sampler` builds the training
samples on the device (data/device_sampler.py); `--transfer_quant int16`
then ships the raw frames as int16.
"""

from __future__ import annotations

import argparse

_OVERRIDES = ("epoch", "batch_size", "seed", "log_dir", "workers", "check_val_every_n_epoch",
              "transfer_quant", "bf16", "category_name", "device_sampler")
_TRI_STATE = {"true": True, "false": False, "auto": "auto"}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="open3dsot_tpu_torch")
    parser.add_argument("--cfg", type=str, required=True, help="the config_file")
    parser.add_argument("--test", action="store_true", default=False, help="test mode")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="trainer checkpoint or state_dict saved with torch.save")
    parser.add_argument("--max_tracklets", type=int, default=None,
                        help="cap eval tracklets (debug)")
    parser.add_argument("--log_dir", type=str, default=None, help="log/work dir")
    parser.add_argument("--epoch", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--workers", type=int, default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--check_val_every_n_epoch", type=int, default=None)
    parser.add_argument("--category_name", type=str, default=None)
    # as the reference (main.py:44,47): default False, and it always overrides the YAML
    parser.add_argument("--preloading", action="store_true", default=False)
    parser.add_argument("--save_top_k", type=int, default=-1,
                        help="keep k best checkpoints by precision (-1 = all)")
    parser.add_argument("--device_sampler", action="store_true", default=None,
                        help="build training samples on the device (data/device_sampler.py)")
    parser.add_argument("--fused_sa", type=str, default=None, choices=["auto", "true", "false"],
                        help="the eval kernels (K1/K2, K3/K4); auto = on")
    parser.add_argument("--fused_sa_train", type=str, default=None,
                        choices=["auto", "true", "false"],
                        help="the training kernel K6; auto = on")
    parser.add_argument("--bf16", action="store_true", default=None,
                        help="bf16 compute (params/BN stats stay f32)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (cuda or cpu)")
    parser.add_argument("--tracker", type=str, default="host", choices=["host", "scan"],
                        help="eval path: 'host' = per-frame loop, 'scan' = batched "
                             "device-resident tracker")
    parser.add_argument("--host_metrics", action="store_true",
                        help="with --tracker scan: score trajectories on the host "
                             "(geometry/iou.py) instead of on the device (geometry/iou_device.py)")
    parser.add_argument("--save_results", type=str, default=None,
                        help="write per-tracklet predicted trajectories + per-frame "
                             "IoU/distance to this JSONL path (tracking/results.py)")
    parser.add_argument("--eval_prep_cache", type=str, default=None,
                        help="directory for a disk-backed packed eval prep cache "
                             "(tracking/prep_store.py): with --tracker scan, repeated "
                             "evaluations skip dataset decode and padding "
                             "(fingerprint-checked)")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="ranks (one card each): started here, or checked against torchrun's "
                             "WORLD_SIZE")
    parser.add_argument("--dist_backend", type=str, default=None, choices=["nccl", "gloo"],
                        help="process-group backend: nccl on cards, gloo on the CPU by default; "
                             "gloo lets ranks share a card")
    parser.add_argument("--transfer_quant", type=str, default=None, choices=["int16"],
                        help="ship frame points to the device as per-sample fixed-point "
                             "int16 (utils/quant.py): --tracker scan eval, and training "
                             "with --device_sampler")
    return parser.parse_args(argv)


def config_of(args):
    """The config of the parsed flags: defaults < YAML < flags."""
    from open3dsot_tpu_torch.config import load_config

    over = {k: getattr(args, k) for k in _OVERRIDES if getattr(args, k) is not None}
    over.update(preloading=args.preloading, save_top_k=args.save_top_k)
    for k in ("fused_sa", "fused_sa_train"):
        if getattr(args, k) is not None:
            over[k] = _TRI_STATE[getattr(args, k)]
    return load_config(args.cfg, over)


def kernel_options(cfg, net_model: str) -> dict:
    """The model's kernel switches from the config: `fused_sa` ->
    fused_eval, `fused_sa_train` -> fused_train (BAT, P2B); on unless False."""
    opts = {"fused_eval": getattr(cfg, "fused_sa", "auto") not in (False, "false")}
    if net_model.lower() != "m2track":
        opts["fused_train"] = getattr(cfg, "fused_sa_train", "auto") not in (False, "false")
    return opts


def ranks_to_launch(args, cfg) -> int:
    """How many ranks `--num_devices` starts: N, or gcd(batch_size, N) for
    training where the global batch does not divide over N."""
    import math

    n = args.num_devices
    if not args.test and cfg.batch_size % n:
        usable = math.gcd(cfg.batch_size, n)
        print(f"[main] batch_size {cfg.batch_size} not divisible by {n} devices; "
              f"starting {usable} ranks")
        return usable
    return n


def results_path(path: str, rank: int) -> str:
    """--save_results of a rank: rank 0 writes `path`, rank r > 0 its own file."""
    if rank == 0:
        return path
    stem, dot, ext = path.rpartition(".")
    return f"{stem}.rank{rank}.{ext}" if dot else f"{path}.rank{rank}"


def main(argv=None):
    import os
    import sys

    args = parse_args(argv)
    from open3dsot_tpu_torch.parallel import distributed

    cfg = config_of(args)
    if args.num_devices is not None and args.num_devices < 1:
        raise ValueError(f"--num_devices must be >= 1, got {args.num_devices}")
    if args.num_devices and args.num_devices > 1 and "RANK" not in os.environ:
        n = ranks_to_launch(args, cfg)
        if (args.dist_backend or distributed.default_backend(args.device)) == "nccl":
            distributed.local_devices(n)  # a card a rank, or refuse before starting any
        argv = sys.argv[1:] if argv is None else list(argv)
        code = distributed.launch(["-m", "open3dsot_tpu_torch.main", *argv], n)
        if code:
            raise SystemExit(code)
        return
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.num_devices is not None and "RANK" in os.environ and world != args.num_devices:
        raise ValueError(f"--num_devices {args.num_devices} but the launcher started {world} "
                         f"ranks (WORLD_SIZE)")
    if not args.test and cfg.batch_size % world:
        raise ValueError(f"batch_size {cfg.batch_size} does not divide over the launcher's "
                         f"{world} ranks")
    device = distributed.init_from_env(args.device, args.dist_backend)
    try:
        _run(args, cfg, device)
    finally:
        distributed.shutdown()


def _run(args, cfg, device):
    import torch

    from open3dsot_tpu_torch.data import get_dataset
    from open3dsot_tpu_torch.models import get_model
    from open3dsot_tpu_torch.parallel import distributed
    from open3dsot_tpu_torch.weights import random_variables, state_dict_from_jax

    model = get_model(cfg.net_model)(cfg, device=device, **kernel_options(cfg, cfg.net_model))
    if args.checkpoint:
        import pickle

        from open3dsot_tpu_torch.train.trainer import RELEASED_CKPT, state_dict_of_checkpoint

        try:
            payload = torch.load(args.checkpoint, map_location=model.device, weights_only=True)
        except pickle.UnpicklingError as e:
            raise ValueError(f"--checkpoint {args.checkpoint} holds more than weights; if it is "
                             f"{RELEASED_CKPT}") from e
        sd = state_dict_of_checkpoint(payload)
    else:
        print("WARNING: no --checkpoint given; starting from random weights from the seed")
        sd = state_dict_from_jax(random_variables(model.net, cfg.seed))
    model.net.load_state_dict(sd, strict=True)

    if args.test:
        sharded = distributed.world_size() > 1
        test_sampler = get_dataset(cfg, "test", cfg.test_split)
        writer = None
        if args.save_results:
            from open3dsot_tpu_torch.tracking.results import ResultsWriter

            writer = ResultsWriter(results_path(args.save_results, distributed.rank()), cfg)
        if args.tracker == "scan":
            succ, prec = model.evaluate_scan(test_sampler, cfg, max_tracklets=args.max_tracklets,
                                             device_metrics=not args.host_metrics,
                                             prep_store_path=args.eval_prep_cache,
                                             results_writer=writer,
                                             shard_across_processes=sharded)
        else:
            from open3dsot_tpu_torch.tracking.eval import evaluate_dataset

            succ, prec = evaluate_dataset(model, test_sampler, cfg,
                                          max_tracklets=args.max_tracklets, verbose=True,
                                          shard_across_processes=sharded, results_writer=writer)
        if writer is not None:
            writer.close()
            print(f"saved {writer.n_written} tracklet trajectories to {writer.path}")
        if distributed.rank() == 0:
            print(f"success/test: {succ:.2f}  precision/test: {prec:.2f}")
        return

    from open3dsot_tpu_torch.train.trainer import Trainer

    torch.manual_seed(cfg.seed)
    train_sampler = get_dataset(cfg, cfg.train_type, cfg.train_split)
    val_sampler = get_dataset(cfg, "test", cfg.val_split)
    history = Trainer(model, cfg, work_dir=args.log_dir).fit(train_sampler, val_sampler)
    last = history[-1] if history else {}
    if distributed.rank() == 0:
        print(f"trained {last.get('steps', 0)} steps; loss {last.get('loss', float('nan')):.4f}")


if __name__ == "__main__":
    main()
