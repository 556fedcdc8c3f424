"""The dry run's data-group peak of one cell, by what made each byte.

    PYTHONPATH=src python scripts/dryrun_peak_by_op.py --arch A --shape S \
        [--multi] [--cycles C] [--top N]

Runs the first data group's window of ``launch/dryrun.py`` (``_run``
with ``groups_run=1``, no optimizer) on the cell's production mesh of
meta positions, with the longest scanned segment cut to ``--cycles``
cycles as the dry run cuts it (``cycle_cut``; default: the first of its
two counts).  The run is made twice: the first finds the number of the
storage born at the window's peak, the second lists the storages alive
when that storage is born, summed by the op that made each and its
output's shape and dtype (the step's arguments under "argument").
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

import torch
from torch.utils._pytree import tree_leaves

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402


class _ByOp(dryrun._Tally):
    """The dry run's tally, which also notes the (op, shape, dtype) that
    made each storage, and lists the live ones when the storage numbered
    ``target`` is born."""
    made = []
    target = None
    at_target = None

    def __init__(self):
        super().__init__()
        self.what = {}
        self.cur = "argument"
        _ByOp.made.append(self)

    def _add(self, s):
        before = self._n
        super()._add(s)
        if self._n == before:
            return
        self.what[s._cdata] = (self.cur, s.nbytes())
        if self._n == _ByOp.target:
            live = Counter()
            for key, (w, n) in self.what.items():
                if key in self._born:
                    live[w] += n
            _ByOp.at_target = (self.live, live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = dryrun._pointwise(func, args, kwargs)
        if out is None:
            out = func(*args, **kwargs)
        ins = None
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            s = t.untyped_storage()
            if s._cdata in self._born:
                continue
            if ins is None:       # an output that is an input's view
                ins = {x.untyped_storage()._cdata
                       for x in tree_leaves((args, kwargs))
                       if isinstance(x, torch.Tensor)}
            if s._cdata not in ins:
                self.cur = (str(func), tuple(t.shape), str(t.dtype))
                self._add(s)
        return out


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
    dryrun._Tally = _ByOp
    t0 = time.time()
    run = dryrun._run(cfg, shape, mesh, None, 1, optimizer=False)
    first = _ByOp.made[-1]
    _, above, outside = run["groups"]
    print(f"run 1 {time.time() - t0:.1f} s: bytes above the arguments "
          f"{above}, outside the group {outside}, arguments "
          f"{run['arg_mesh']}, peak {first.peak}", flush=True)
    _ByOp.target = first.peak_at
    dryrun._run(cfg, shape, mesh, None, 1, optimizer=False)
    live, by = _ByOp.at_target
    print(f"run 2: live at the peak {live}")
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
