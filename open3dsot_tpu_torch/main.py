"""CLI entry point of the port (eval only so far), for M2-Track, BAT and P2B.

    python -m open3dsot_tpu_torch.main --cfg cfgs/M2_track_synthetic.yaml --test \
        [--checkpoint port.pt] [--max_tracklets N] [--device cuda]
    python -m open3dsot_tpu_torch.main --cfg cfgs/BAT_synthetic.yaml --test --device cuda

Flags keep the JAX CLI's names (main.py). `--checkpoint` is a file written
by `torch.save(model.net.state_dict(), path)`; without one the weights are
random, made from the config's seed (weights.random_variables). Training is
not ported yet and is refused.
"""

from __future__ import annotations

import argparse
import sys


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="open3dsot_tpu_torch")
    parser.add_argument("--cfg", type=str, required=True, help="the config_file")
    parser.add_argument("--test", action="store_true", default=False, help="test mode")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="state_dict saved with torch.save")
    parser.add_argument("--max_tracklets", type=int, default=None,
                        help="cap eval tracklets (debug)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the forward (cuda or cpu)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if not args.test:
        sys.exit("training is not ported yet (ROADMAP.md, modules to port: training); "
                 "run with --test, or train with the JAX package's main.py")
    import torch

    from open3dsot_tpu_torch.config import load_config
    from open3dsot_tpu_torch.data import get_dataset
    from open3dsot_tpu_torch.models import get_model
    from open3dsot_tpu_torch.tracking.eval import evaluate_dataset
    from open3dsot_tpu_torch.weights import random_variables, state_dict_from_jax

    cfg = load_config(args.cfg)
    model = get_model(cfg.net_model)(cfg, device=args.device)
    if args.checkpoint:
        sd = torch.load(args.checkpoint, map_location=model.device, weights_only=True)
    else:
        print("WARNING: no --checkpoint given; evaluating random weights from the seed")
        sd = state_dict_from_jax(random_variables(model.net, cfg.seed))
    model.net.load_state_dict(sd, strict=True)
    test_sampler = get_dataset(cfg, "test", cfg.test_split)
    succ, prec = evaluate_dataset(model, test_sampler, cfg, max_tracklets=args.max_tracklets,
                                  verbose=True)
    print(f"success/test: {succ:.2f}  precision/test: {prec:.2f}")


if __name__ == "__main__":
    main()
