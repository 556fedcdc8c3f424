"""Batched serving example on the PyTorch port: fixed-batch prefill +
decode over a request queue (the farmer-worker paradigm applied to
inference), on one device or on a device mesh.

The counterpart of ``examples/serve_batch.py``: the reduced qwen3-14b
config, 12 requests of 32 tokens served 4 at a time, 16 greedy tokens
each, through ``steps.make_prefill_step`` and ``make_serve_step``.
``--mesh DATAxMODEL`` serves on a mesh of that many positions (round-
robin over the visible cards, or the CPU with ``--device cpu``): the
batch rows split over the data groups, each model group's positions
holding their heads, FFN columns and time blocks of the KV cache.
``--fp32`` runs the activations in fp32 (the config's are bf16, where a
mesh's sums in another order can flip a near-tie).

Run:  PYTHONPATH=src python examples/torch_serve_batch.py \\
          [--device cpu] [--mesh 1x2] [--fp32]
"""
import argparse
import contextlib
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default cuda; cpu to run on the host")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="serve on a device mesh, e.g. 1x2 or 2x2")
    ap.add_argument("--fp32", action="store_true",
                    help="fp32 activations (default: the config's bf16)")
    args = ap.parse_args(argv)

    from repro_torch import steps, weights
    from repro_torch.configs import get_tiny_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel.sharding import use_sharding

    device = weights.resolve_device(args.device)
    cfg = get_tiny_config("qwen3-14b")
    if args.fp32:
        cfg = cfg.replace(activation_dtype="float32")
    params = weights.init_params(cfg, torch.Generator(device).manual_seed(0),
                                 device)
    B, prompt_len, gen = 4, 32, 16
    max_len = prompt_len + gen
    mesh, ctx = None, contextlib.nullcontext()
    if args.mesh:
        data, model = (int(n) for n in args.mesh.split("x"))
        mesh = make_test_mesh(data, model, devices="cpu"
                              if device.type == "cpu" else None)
        ctx = use_sharding(mesh)
        device = mesh.devices[0]
    rng = np.random.default_rng(0)
    requests = [rng.integers(2, cfg.vocab_size, prompt_len, dtype=np.int32)
                for _ in range(12)]
    outputs = []
    with ctx:
        if mesh is not None:
            params = weights.shard_params(params, cfg, mesh, consume=True)
        prefill = steps.make_prefill_step(cfg, max_len=max_len, mesh=mesh)
        serve = steps.make_serve_step(cfg, mesh=mesh)
        served = 0
        t0 = time.time()
        while requests:
            batch = [requests.pop(0) for _ in range(min(B, len(requests)))]
            n = len(batch)
            batch += [batch[-1]] * (B - n)       # pad the worker pool
            logits, caches = prefill(params, torch.tensor(np.stack(batch),
                                                          device=device))
            tok = logits.argmax(-1).to(torch.int32)
            toks = [tok]
            for i in range(gen - 1):
                tok, logits, caches = serve(params, tok, caches,
                                            prompt_len + i)
                toks.append(tok)
            outputs += torch.cat(toks, -1)[:n].tolist()
            served += n
        dt = time.time() - t0
    where = f"a {args.mesh} mesh" if mesh is not None else str(device)
    print(f"served {served} requests x {gen} tokens in {dt:.2f}s "
          f"({served * gen / dt:.1f} tok/s on {where})")
    return outputs


if __name__ == "__main__":
    main()
