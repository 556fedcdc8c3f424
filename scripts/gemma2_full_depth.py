"""gemma2-27b at every one of its 46 layers through the dense engine on
one card: decode step, prefill, peak memory and the decode steps'
conversions of a weight to another dtype, measured as ``chip_smoke.py``'s
phase 3 measures its 6-layer cut (``serve_dense``: the DENSE_RUNS
traffic, 8 requests of 4200 prompt tokens and 32 generated, batch 4,
bf16, impl="pallas", seed-0 weights; its launch-count and finite-logit
gates hold).

    python3 scripts/gemma2_full_depth.py [--src DIR]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout's; an
unpacked older tree measures that tree, its kernels built under
``DIR/build``) and ``chip_smoke.py`` from this checkout.  Prints the
card's name and power limit, then one JSON line.  Needs one 80 GB card
(46 layers hold about 54 GB of bf16 parameters); imports nothing of JAX.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve() / "src"))
    sys.path.insert(1, str(ROOT))
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops
    from repro_torch.weights import init_params

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("gemma2-27b").replace(impl="pallas")
    g = torch.Generator(device=cs.DEVICE).manual_seed(cs.SEED)
    params = init_params(cfg, g, cs.DEVICE)
    st, _, line = cs.serve_dense(ops, cfg, params)
    print(line)
    print(cs.gpu_info())
    prof = st.pop("profile")
    print(json.dumps(dict(
        src=args.src, **st,
        decode_busy=prof["decode"]["busy_share"],
        decode_launches_per_step=prof["decode"]["launches_per_step"],
        prefill_busy=prof["prefill"]["busy_share"],
        decode_top=prof["decode"]["top"], prefill_top=prof["prefill"]["top"],
        weight_conversions=prof["decode"]["weight_conversions"])))


if __name__ == "__main__":
    main()
