"""Quickstart on the PyTorch port: train a tiny LM, then generate
greedily.

The counterpart of ``examples/quickstart.py``: the reduced qwen3-14b
config trains for 30 steps through ``runtime/train_loop.run`` (the
synthetic Zipf stream from seed 0), then ``lm.prefill`` and
``lm.decode_step`` continue a prompt greedily with the trained weights.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default cuda; cpu to run on the host")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_tiny_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import lm
    from repro_torch.runtime import train_loop
    from repro_torch.weights import resolve_device

    device = resolve_device(args.device)
    cfg = get_tiny_config("qwen3-14b")
    print(f"config: {cfg.name} (reduced) — {cfg.n_params()/1e6:.2f}M params")

    shape = ShapeConfig("quickstart", seq_len=64, global_batch=4,
                        kind="train")
    job = train_loop.TrainJobConfig(steps=30, log_every=10, peak_lr=2e-3,
                                    warmup=5)
    out = train_loop.run(cfg, shape, job=job, device=device)
    print(f"trained 30 steps in {out['wall_s']:.1f}s; "
          f"loss {out['history'][0]['loss']:.3f} -> "
          f"{out['final_metrics']['loss']:.3f}")

    params = out["params"]
    prompt = torch.tensor([[5, 17, 42, 100, 7, 23, 88, 3]],
                          dtype=torch.int32, device=device)
    with torch.no_grad():
        logits, caches = lm.prefill(params, cfg, prompt, max_len=24)
        tok = logits.argmax(-1).to(torch.int32)
        gen = [int(tok[0, 0])]
        for i in range(8):
            logits, caches = lm.decode_step(params, cfg, tok, caches,
                                            prompt.shape[1] + i)
            tok = logits.argmax(-1).to(torch.int32)
            gen.append(int(tok[0, 0]))
    print("greedy continuation token ids:", gen)
    return out, gen


if __name__ == "__main__":
    main()
