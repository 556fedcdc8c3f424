"""CLI trainer of the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --seq 2048 --batch 4 --steps 200 --ckpt-dir /tmp/ck

Reference: ``repro/launch/train.py``.  ``--tiny`` runs the reduced smoke
config of any arch.  Runs on the GPU (``--device cpu`` for the CPU) and
raises without CUDA unless given the CPU.  The data is the reference's
synthetic Zipf stream from the job's seed.

``--data D --model M`` trains on a D x M mesh of positions (one torch
device a position, round-robin over the visible cards, or all on the
CPU with ``--device cpu``; one card may hold every position), ``--devices
N`` says how many positions there are (default D x M), and ``--layout
auto`` lets the cost engine pick (data, model) for N positions, printing
the reference's ``[cost-engine]`` lines (they price a TPU v5e-class
chip, not the card).  Every family trains on a mesh (MoE, MLA, RG-LRU
and RWKV-6 included); a model axis that does not divide what it splits
(the heads, the FFN width, the RG-LRU lanes, the experts' FFN width)
exits with code 2, and so does ``--impl pallas``: the kernels, like the
reference's Pallas calls, have no backward.
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
                    help="mesh positions (default --data x --model), "
                         "round-robin over the visible cards or on the CPU")
    ap.add_argument("--layout", default="manual", choices=["manual", "auto"],
                    help="auto: let the cost engine pick (data, model)")
    ap.add_argument("--link-mode", default="circuit",
                    choices=["circuit", "packet"],
                    help="interconnect model used by --layout auto")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    return ap


def _usage_error(msg):
    print(f"error: {msg}", file=sys.stderr)
    raise SystemExit(2)


def _mesh(args, cfg, shape):
    """(mesh or None, the cost engine's chosen estimate or None)."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel.sharding import (autotune_layout,
                                               make_layout_mesh)
    devices = "cpu" if args.device == "cpu" else None
    if args.layout == "auto":
        n = args.devices or 1
        best, ranked = autotune_layout(cfg, shape, n_chips=n,
                                       mode=args.link_mode)
        print(f"[cost-engine] {len(ranked)} candidate layouts for "
              f"{best.layout.n_chips} mesh positions ({args.link_mode} "
              "mode; the reference's TPU v5e-class prices):")
        for est in ranked:
            tag = " <= chosen" if est is ranked[0] else ""
            print(f"[cost-engine]   {est.describe()}{tag}")
        print(f"[cost-engine] predicted step time "
              f"{best.step_time_s * 1e3:.3f} ms "
              f"({best.tokens_per_s:.0f} tok/s)")
        return make_layout_mesh(best.layout, devices), best
    n = args.data * args.model
    if args.devices and args.devices < n:
        _usage_error(f"--data {args.data} x --model {args.model} needs {n} "
                     f"mesh positions, --devices gives {args.devices}")
    return (make_test_mesh(args.data, args.model, devices=devices)
            if n > 1 else None), None


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.impl == "pallas":
        _usage_error("--impl pallas: the kernels have no backward (neither "
                     "have the reference's Pallas calls); train with "
                     "--impl blocked")

    from repro_torch import steps
    from repro_torch.configs import get_config, get_tiny_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.runtime import train_loop

    cfg = get_tiny_config(args.arch) if args.tiny else get_config(args.arch)
    if args.impl is not None:
        cfg = cfg.replace(impl=args.impl)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    mesh, predicted = _mesh(args, cfg, shape)
    try:
        steps.check_mesh(cfg, mesh)
    except NotImplementedError as e:
        _usage_error(str(e))
    if mesh is not None:
        print(f"mesh {dict(mesh.shape)}: {len(mesh.devices)} positions on "
              f"{mesh.distinct_devices} distinct device(s)")
    job = train_loop.TrainJobConfig(
        steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, peak_lr=args.lr,
        metrics_path=args.metrics)
    out = train_loop.run(cfg, shape, mesh=mesh, job=job, device=args.device)
    print("final:", {k: v for k, v in out["final_metrics"].items()})
    if predicted is not None:
        measured = out["final_metrics"].get("sec_per_step")
        if measured:
            print(f"[cost-engine] predicted {predicted.step_time_s:.4f}s "
                  f"vs measured {measured:.4f}s per step (ratio "
                  f"{measured / predicted.step_time_s:.2f}x; the engine "
                  f"models TPU v5e-class chips, not this host)")
    return out


if __name__ == "__main__":
    main()
