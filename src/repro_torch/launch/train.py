"""CLI trainer of the port, on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --seq 2048 --batch 4 --steps 200 --ckpt-dir /tmp/ck

Reference: ``repro/launch/train.py``.  ``--tiny`` runs the reduced smoke
config of any arch.  Runs on the GPU (``--device cpu`` for the CPU) and
raises without CUDA unless given the CPU.  The data is the reference's
synthetic Zipf stream from the job's seed.  Training on a mesh is not
ported (ROADMAP Queue A item 10): ``--devices`` > 1, ``--data`` or
``--model`` > 1 and ``--layout auto`` exit with code 2, and so does
``--impl pallas``: the kernels, like the reference's Pallas calls, have
no backward.
"""
from __future__ import annotations

import argparse
import sys


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny-100m")
    ap.add_argument("--tiny", action="store_true",
                    help="use the reduced smoke config of --arch")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--metrics", default=None)
    ap.add_argument("--impl", default=None,
                    help="ref | blocked (the config's default)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu for the CPU)")
    ap.add_argument("--devices", type=int, default=0,
                    help="mesh positions (not ported: only 0 or 1)")
    ap.add_argument("--layout", default="manual", choices=["manual", "auto"])
    ap.add_argument("--link-mode", default="circuit",
                    choices=["circuit", "packet"])
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    return ap


def _usage_error(msg):
    print(f"error: {msg}", file=sys.stderr)
    raise SystemExit(2)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.devices > 1 or args.data * args.model > 1 \
            or args.layout == "auto":
        _usage_error("--devices > 1, --data / --model > 1 and --layout auto "
                     "train on a device mesh, which is not ported to the "
                     "PyTorch trainer yet (see ROADMAP.md Queue A item 10); "
                     "it trains on one device")
    if args.impl == "pallas":
        _usage_error("--impl pallas: the kernels have no backward (neither "
                     "have the reference's Pallas calls); train with "
                     "--impl blocked")

    from repro_torch.configs import get_config, get_tiny_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.runtime import train_loop

    cfg = get_tiny_config(args.arch) if args.tiny else get_config(args.arch)
    if args.impl is not None:
        cfg = cfg.replace(impl=args.impl)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    job = train_loop.TrainJobConfig(
        steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, peak_lr=args.lr,
        metrics_path=args.metrics)
    out = train_loop.run(cfg, shape, job=job, device=args.device)
    print("final:", {k: v for k, v in out["final_metrics"].items()})


if __name__ == "__main__":
    main()
