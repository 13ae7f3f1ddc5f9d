"""Evaluate a released Lightning checkpoint with the port, the counterpart of
`scripts/eval_released_ckpt.py`:

    python -m open3dsot_tpu_torch.eval_released_ckpt \
        --cfg cfgs/BAT_Car.yaml --ckpt bat_kitti_car.ckpt \
        --data /path/to/kitti [--tracker host|scan] [--max_tracklets N] \
        [--device cuda]

The checkpoint's state dict goes through `import_torch.import_checkpoint`
(checked against the model's own weights, leaf by leaf) into the port's
modules, then the host loop (`--tracker host`, tracking/eval.py) or the
device-resident scan tracker (`--tracker scan`: M2-Track's or the matching
one) runs the config's test split and prints Success/Precision, to hold
against BASELINE.md. The `.ckpt` is loaded with `weights_only=False`: it
pickles its hyper-parameters, so this runs the file's pickle code.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="evaluate a released Lightning checkpoint")
    parser.add_argument("--cfg", required=True)
    parser.add_argument("--ckpt", required=True, help="released torch .ckpt")
    parser.add_argument("--data", required=True, help="dataset root")
    parser.add_argument("--tracker", default="host", choices=["host", "scan"])
    parser.add_argument("--max_tracklets", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from open3dsot_tpu_torch.config import load_config
    from open3dsot_tpu_torch.data import get_dataset
    from open3dsot_tpu_torch.import_torch import import_checkpoint
    from open3dsot_tpu_torch.main import kernel_options
    from open3dsot_tpu_torch.models import get_model
    from open3dsot_tpu_torch.weights import state_dict_from_jax

    cfg = load_config(args.cfg, {"path": args.data})
    model = get_model(cfg.net_model)(cfg, device=args.device,
                                     **kernel_options(cfg, cfg.net_model))
    variables = import_checkpoint(args.ckpt, cfg, model=model)
    model.net.load_state_dict(state_dict_from_jax(variables), strict=True)
    print(f"imported {args.ckpt} into {cfg.net_model}")

    test_sampler = get_dataset(cfg, "test", cfg.test_split)
    if args.tracker == "scan":
        succ, prec = model.evaluate_scan(test_sampler, cfg, max_tracklets=args.max_tracklets)
    else:
        from open3dsot_tpu_torch.tracking.eval import evaluate_dataset

        succ, prec = evaluate_dataset(model, test_sampler, cfg,
                                      max_tracklets=args.max_tracklets, verbose=True)
    print(f"success/test: {succ:.2f}  precision/test: {prec:.2f}")
    print("compare against BASELINE.md (reference README reproduction table)")


if __name__ == "__main__":
    main()
