"""CLI entry point of the port, for M2-Track, BAT and P2B.

    python -m open3dsot_tpu_torch.main --cfg cfgs/BAT_synthetic.yaml \
        [--epoch N] [--batch_size B] [--seed S] [--log_dir DIR] [--workers W] \
        [--check_val_every_n_epoch E] [--save_top_k K] [--device_sampler \
        [--transfer_quant int16]] [--device cuda]                           # train
    python -m open3dsot_tpu_torch.main --cfg cfgs/M2_track_synthetic.yaml --test \
        [--checkpoint ckpt_best.pt] [--max_tracklets N] [--device cuda] [--bf16] \
        [--save_results R.jsonl] [--tracker scan [--host_metrics] \
        [--transfer_quant int16] [--eval_prep_cache DIR]]                   # eval

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
with `--save_results`, whose host-scored loop needs the frames). Not
ported yet: process sharding (ROADMAP.md §1 item 6).
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


def main(argv=None):
    args = parse_args(argv)
    import torch

    from open3dsot_tpu_torch.data import get_dataset
    from open3dsot_tpu_torch.models import get_model
    from open3dsot_tpu_torch.weights import random_variables, state_dict_from_jax

    cfg = config_of(args)
    model = get_model(cfg.net_model)(cfg, device=args.device, **kernel_options(cfg, cfg.net_model))
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
        test_sampler = get_dataset(cfg, "test", cfg.test_split)
        writer = None
        if args.save_results:
            from open3dsot_tpu_torch.tracking.results import ResultsWriter

            writer = ResultsWriter(args.save_results, cfg)
        if args.tracker == "scan":
            succ, prec = model.evaluate_scan(test_sampler, cfg, max_tracklets=args.max_tracklets,
                                             device_metrics=not args.host_metrics,
                                             prep_store_path=args.eval_prep_cache,
                                             results_writer=writer)
        else:
            from open3dsot_tpu_torch.tracking.eval import evaluate_dataset

            succ, prec = evaluate_dataset(model, test_sampler, cfg,
                                          max_tracklets=args.max_tracklets, verbose=True,
                                          results_writer=writer)
        if writer is not None:
            writer.close()
            print(f"saved {writer.n_written} tracklet trajectories to {writer.path}")
        print(f"success/test: {succ:.2f}  precision/test: {prec:.2f}")
        return

    from open3dsot_tpu_torch.train.trainer import Trainer

    torch.manual_seed(cfg.seed)
    train_sampler = get_dataset(cfg, cfg.train_type, cfg.train_split)
    val_sampler = get_dataset(cfg, "test", cfg.val_split)
    history = Trainer(model, cfg, work_dir=args.log_dir).fit(train_sampler, val_sampler)
    last = history[-1] if history else {}
    print(f"trained {last.get('steps', 0)} steps; loss {last.get('loss', float('nan')):.4f}")


if __name__ == "__main__":
    main()
