"""End-to-end driver on the PyTorch port: train the ~100M-parameter LM
with checkpointing, restart safety and metrics logging.

The counterpart of ``examples/train_lm.py``.  Interrupt and re-run with
the same --ckpt-dir to resume from the last checkpoint.

Run:  PYTHONPATH=src python examples/torch_train_lm.py --steps 200
          [--device cpu] [--tiny]
(--tiny trains the reduced config; --steps 20 for a quick pass.)
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default="build/torch_train_lm_ckpt")
    ap.add_argument("--metrics",
                    default="build/torch_train_lm_metrics.json")
    ap.add_argument("--tiny", action="store_true",
                    help="train the reduced tiny-100m config")
    ap.add_argument("--device", default=None,
                    help="default cuda; cpu to run on the host")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_tiny_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.runtime import train_loop

    cfg = (get_tiny_config if args.tiny else get_config)("tiny-100m")
    print(f"training {cfg.name}: {cfg.n_params()/1e6:.1f}M params, "
          f"{args.steps} steps x {args.batch}x{args.seq} tokens")
    shape = ShapeConfig("train_lm", args.seq, args.batch, "train")
    job = train_loop.TrainJobConfig(
        steps=args.steps, log_every=10, ckpt_every=50,
        ckpt_dir=args.ckpt_dir, peak_lr=6e-4, warmup=20,
        metrics_path=args.metrics)
    out = train_loop.run(cfg, shape, job=job, device=args.device)
    hist = out["history"]
    print(f"done in {out['wall_s']:.0f}s; "
          f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")
    return out


if __name__ == "__main__":
    main()
