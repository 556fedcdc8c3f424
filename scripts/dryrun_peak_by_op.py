"""The dry run's data-group peak of one cell, by what made each byte.

    PYTHONPATH=src python scripts/dryrun_peak_by_op.py --arch A --shape S \
        [--multi] [--cycles C] [--top N]

Runs the first data group's window of ``launch/dryrun.py`` on the
cell's production mesh of meta positions (``dryrun.peak_by_op``), with
the longest scanned segment cut to ``--cycles`` cycles as the dry run
cuts it (``cycle_cut``; default: the first of its two counts).  The run
is made twice: the first finds the number of the storage born at the
window's peak, the second lists the storages alive when that storage is
born, summed by the op that made each and its output's shape and dtype
(the step's arguments under "argument").
Prints the window's bytes above the arguments, the mesh's live bytes at
the peak, and the largest entries by op and shape, then by op.  Host
time is about twice the dry run's cut run (DeepSeek-V3 x prefill_32k x
16x16 at 2 cycles: about 45 minutes on one core).  Imports nothing of
JAX.
"""
import argparse
import sys
import time
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi", action="store_true",
                    help="the 2x16x16 mesh (default 16x16)")
    ap.add_argument("--cycles", type=int, default=None)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    cfg, shape = get_config(args.arch), SHAPES[args.shape]
    mesh = make_production_mesh(multi_pod=args.multi)
    cut = dryrun.cycle_cut(cfg, mesh)
    if cut is not None:
        cfg = cut[3](args.cycles or cut[2][0])
    print(f"{args.arch} x {args.shape}: {cfg.n_layers} layers", flush=True)
    t0 = time.time()
    run, first, (live, by) = dryrun.peak_by_op(cfg, shape, mesh)
    _, above = run["groups"]
    print(f"{time.time() - t0:.1f} s: bytes above the arguments {above} "
          f"(those at positions outside the group left out), arguments "
          f"{run['arg_mesh']}; live at the peak {live}", flush=True)
    total = sum(by.values())
    for w, n in by.most_common(args.top):
        print(f"{n:16d}  {100 * n / total:5.1f}%  {w}")
    by_op = Counter()
    for w, n in by.items():
        by_op[w if w == "argument" else w[0]] += n
    print("by op:")
    for w, n in by_op.most_common(args.top):
        print(f"{n:16d}  {100 * n / total:5.1f}%  {w}")


if __name__ == "__main__":
    main()
