"""Production cells of the dry run held against their full-depth run.

    PYTHONPATH=src python scripts/dryrun_full_depth.py \
        [--cell ARCH:SHAPE ...] [--multi] [--out FILE]

For each cell (default: qwen3-1.7b x decode_32k and minitron-8b x
train_4k, on 16x16) runs ``launch/dryrun.dry_step`` twice on the
production mesh of meta positions: as the dry run records it (one data
group, the longest segment at two cut depths, every point of the
window extrapolated to the full depth) and with the data-group symmetry
kept but every cycle run (``cut=False``).  Prints each run's seconds
and a position's temp by phase, and exits 1 unless the two records'
memory, FLOPs, wire by site and dry calls are equal (the temp to the
byte).  Imports nothing of JAX.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402

CELLS = ("qwen3-1.7b:decode_32k", "minitron-8b:train_4k")
SAME = ("argument_size_in_bytes", "temp_size_in_bytes", "temp_by_phase",
        "output_size_in_bytes", "alias_size_in_bytes")


def check(arch: str, shape_name: str, multi: bool) -> dict:
    cfg, shape = get_config(arch), SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi)
    rules = dryrun.cell_rules(shape, mesh)
    out = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi else "16x16"}
    recs = {}
    for name, cut in (("cut", True), ("full_depth", False)):
        t0 = time.time()
        recs[name] = dryrun.dry_step(cfg, shape, mesh, rules, cut=cut)
        out[name] = {"s": round(time.time() - t0, 1),
                     "cycles": recs[name]["symmetry"]["cycles"] and
                     recs[name]["symmetry"]["cycles"]["runs_at"],
                     **{k: recs[name]["memory"][k] for k in SAME}}
        print(f"[{arch} x {shape_name}] {name}: {json.dumps(out[name])}",
              flush=True)
    a, b = recs["cut"], recs["full_depth"]
    out["equal"] = {
        "memory": all(a["memory"][k] == b["memory"][k] for k in SAME),
        "kernel_dry_calls": a["kernel_dry_calls"] == b["kernel_dry_calls"],
        # sums of floats in another order: equal to 1e-9 of the largest
        "flops": abs(a["cost_analysis"]["flops"]
                     - b["cost_analysis"]["flops"])
        <= 1e-9 * max(b["cost_analysis"]["flops"], 1.0),
        "wire_bytes_by_site": a["wire_bytes_by_site"].keys()
        == b["wire_bytes_by_site"].keys() and all(
            abs(v - b["wire_bytes_by_site"][k]) <= 1e-9 * max(abs(v), 1.0)
            for k, v in a["wire_bytes_by_site"].items())}
    print(f"[{arch} x {shape_name}] equal: {out['equal']}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", action="append", default=None,
                    help="ARCH:SHAPE (repeatable)")
    ap.add_argument("--multi", action="store_true",
                    help="the 2x16x16 mesh (default 16x16)")
    ap.add_argument("--out", default=None, help="write the records (JSON)")
    args = ap.parse_args(argv)
    res = [check(*c.split(":"), args.multi) for c in args.cell or CELLS]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    raise SystemExit(0 if all(all(r["equal"].values()) for r in res) else 1)


if __name__ == "__main__":
    main()
