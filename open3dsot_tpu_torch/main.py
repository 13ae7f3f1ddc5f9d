"""CLI entry point of the port, for M2-Track, BAT and P2B.

    python -m open3dsot_tpu_torch.main --cfg cfgs/BAT_synthetic.yaml \
        [--epoch N] [--batch_size B] [--seed S] [--log_dir DIR] [--workers W] \
        [--check_val_every_n_epoch E] [--device cuda]                        # train
    python -m open3dsot_tpu_torch.main --cfg cfgs/M2_track_synthetic.yaml --test \
        [--checkpoint ckpt_best.pt] [--max_tracklets N] [--device cuda]      # eval

Flags keep the JAX CLI's names (main.py); a flag given overrides the YAML.
Training runs the matching trackers (BAT, P2B; `train_siamese`) through
`train/trainer.py`, starting from random weights made from the seed
(weights.random_variables); M2-Track training (`train_motion`) is not
ported yet and is refused, as the models refuse `bf16`. `--checkpoint` is a trainer checkpoint
(`ckpt_best.pt`, `ckpt_last.pt`) or a file written by
`torch.save(model.net.state_dict(), path)`; without one the weights are
random, made from the seed.
"""

from __future__ import annotations

import argparse
import sys

_OVERRIDES = ("epoch", "batch_size", "seed", "log_dir", "workers", "check_val_every_n_epoch")


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
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (cuda or cpu)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from open3dsot_tpu_torch.config import load_config
    from open3dsot_tpu_torch.data import get_dataset
    from open3dsot_tpu_torch.models import get_model
    from open3dsot_tpu_torch.weights import random_variables, state_dict_from_jax

    cfg = load_config(args.cfg, {k: getattr(args, k) for k in _OVERRIDES
                                 if getattr(args, k) is not None})
    if not args.test and getattr(cfg, "train_type", "") != "train_siamese":
        sys.exit(f"{cfg.net_model} ({getattr(cfg, 'train_type', None)}): training is not "
                 "ported yet (ROADMAP.md, modules to port); the port trains BAT and P2B")
    model = get_model(cfg.net_model)(cfg, device=args.device)  # refuses bf16
    if args.checkpoint:
        from open3dsot_tpu_torch.train.trainer import state_dict_of_checkpoint

        sd = state_dict_of_checkpoint(
            torch.load(args.checkpoint, map_location=model.device, weights_only=True))
    else:
        print("WARNING: no --checkpoint given; starting from random weights from the seed")
        sd = state_dict_from_jax(random_variables(model.net, cfg.seed))
    model.net.load_state_dict(sd, strict=True)

    if args.test:
        from open3dsot_tpu_torch.tracking.eval import evaluate_dataset

        test_sampler = get_dataset(cfg, "test", cfg.test_split)
        succ, prec = evaluate_dataset(model, test_sampler, cfg,
                                      max_tracklets=args.max_tracklets, verbose=True)
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
