"""The mesh trainer's backward with one position a card, under
``torch.utils.checkpoint`` and under the port's own checkpoint.

    python3 scripts/remat_cards_probe.py [--arch qwen3-1.7b] [--mesh 1x2] \
        [--layers 2] [--repeats 3] [--vocab V] [--d-ff-expert F]

Builds ``--arch`` at its published widths (``--vocab`` and
``--d-ff-expert`` cut them), ``--layers`` deep, fp32, on a mesh of
``--mesh`` positions, one a card, and runs ``steps.mesh_loss_and_grads``
(the forward, then ``torch.autograd.grad`` through every checkpointed
cycle) ``--repeats`` times with each checkpoint: ``torch`` replaces the
train forward's ``lm.checkpoint`` by
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, as the port
ran before ``models/remat.py``; ``port`` keeps ``remat.checkpoint``.
Prints one line a checkpoint: how many runs raised, the first error,
and the losses; the last line is a JSON record.  Needs as many CUDA
cards as the mesh has positions (``--device cpu``: every position on the
CPU, a rehearsal).  Imports nothing of JAX.
"""
import argparse
import dataclasses
import functools
import json
import sys
import time
from pathlib import Path

import torch
import torch.utils.checkpoint as torch_checkpoint

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import steps, weights  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline as data  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.parallel.sharding import use_sharding  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--mesh", default="1x2")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--vocab", type=int, default=None)
    ap.add_argument("--d-ff-expert", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cpu: every position on the CPU (a rehearsal)")
    args = ap.parse_args(argv)
    d, m = (int(v) for v in args.mesh.split("x"))
    cuda = args.device == "cuda"
    if cuda and torch.cuda.device_count() < d * m:
        raise SystemExit(f"{d * m} cards needed, "
                         f"{torch.cuda.device_count()} visible")
    devices = [f"cuda:{i}" for i in range(d * m)] if cuda \
        else [args.device] * (d * m)
    cfg = get_config(args.arch).replace(
        n_layers=args.layers, activation_dtype="float32",
        param_dtype="float32", impl="blocked")
    if args.vocab:
        cfg = cfg.replace(vocab_size=args.vocab)
    if args.d_ff_expert:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, d_ff_expert=args.d_ff_expert))
    mesh = make_test_mesh(d, m, devices=devices)
    params = weights.init_params(
        cfg, torch.Generator(devices[0]).manual_seed(0), devices[0])
    src = data.SyntheticLM(data.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=0))
    batch = {k: torch.from_numpy(v).to(devices[0])
             for k, v in src.batch(0).items()}
    with use_sharding(mesh):
        placed = weights.shard_params(params, cfg, mesh, consume=True)
    del params
    out = {"arch": args.arch, "mesh": args.mesh, "layers": args.layers,
           "cards": mesh.distinct_devices}
    original = lm.checkpoint
    for name, ck in (("torch", functools.partial(
            torch_checkpoint.checkpoint, use_reentrant=False)),
                     ("port", original)):
        lm.checkpoint = ck
        errors, losses = [], []
        t0 = time.time()
        try:
            for _ in range(args.repeats):
                try:
                    with use_sharding(mesh):
                        metrics, grads = steps.mesh_loss_and_grads(
                            cfg, placed, batch)
                    losses.append(float(metrics["loss"]))
                    del grads
                except Exception as e:      # noqa: the result is the error
                    errors.append(f"{type(e).__name__}: {e}")
                for i in range(d * m if cuda else 0):
                    torch.cuda.synchronize(i)
        finally:
            lm.checkpoint = original
        out[name] = dict(raised=len(errors), runs=args.repeats,
                         first_error=errors[0][:300] if errors else None,
                         losses=losses, seconds=time.time() - t0)
        print(f"[{name} checkpoint] {args.arch} {args.mesh} on "
              f"{mesh.distinct_devices} cards, {args.layers} layers: "
              f"{len(errors)} of {args.repeats} backward runs raised"
              + (f" (first: {errors[0][:200]})" if errors else "")
              + f"; losses {losses}", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
