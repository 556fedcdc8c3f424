"""``pipeline_apply`` with one stage a card, against the stages in order.

    python3 scripts/pipeline_cards_probe.py [--src DIR] [--trials N] \
        [--uneven]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout's) and
runs ``parallel/pipeline.pipeline_apply`` on a ("stage",) mesh with one
position a card (every visible card; two or more), its stages kept busy
on their cards (``--steps`` fp32 products of ``--width`` x ``--width``,
each through tanh; with ``--uneven`` stage i runs i + 1 times as many,
so a stage's hand-on waits behind a busier next stage while its own
card runs on), against the same stages run in order on the first card.  Prints, per trial, whether the two outputs are equal bit for bit
and their largest difference: an activation handed on before its stage
has written it shows as a difference.  Imports nothing of JAX.
"""
import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--micro", type=int, default=8)
    ap.add_argument("--width", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--uneven", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve() / "src"))
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.pipeline import pipeline_apply
    from repro_torch.parallel.sharding import use_sharding

    n = torch.cuda.device_count()
    if n < 2:
        raise SystemExit(f"{n} card(s) visible: the probe needs two or more")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda:0").manual_seed(0)
    W = args.width
    ws = [torch.randn(W, W, generator=g, device="cuda:0") * W ** -0.5
          for _ in range(n)]
    x = torch.randn(args.micro * 512, W, generator=g, device="cuda:0")

    def stage(p, h):
        i, w = p
        for _ in range(args.steps * (i + 1 if args.uneven else 1)):
            h = torch.tanh(h @ w)
        return h

    def in_order(h):
        for p in enumerate(ws):
            h = stage(p, h)
        return h
    # microbatch by microbatch, as the pipeline runs them
    want = torch.cat([in_order(h) for h in x.chunk(args.micro, 0)], 0)
    mesh = make_mesh((n,), ("stage",), [f"cuda:{i}" for i in range(n)])
    out = {"src": args.src, "cards": n, "uneven": args.uneven,
           "trials": []}
    for _ in range(args.trials):
        for i in range(n):
            torch.cuda.synchronize(i)
        t0 = time.time()
        with torch.no_grad(), use_sharding(mesh):
            got = pipeline_apply(stage, list(enumerate(ws)), x,
                                 n_micro=args.micro)
        for i in range(n):
            torch.cuda.synchronize(i)
        out["trials"].append(dict(
            equal=bool(torch.equal(got, want)),
            max_abs_diff=float((got - want).abs().max()),
            s=time.time() - t0))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
