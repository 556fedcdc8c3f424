"""The attention einsums' share of the device time in two runs of the port
on one card, measured as ``chip_smoke.py`` measures them: phase 6's
trainer (qwen3-1.7b at full width, ``TRAIN_DEPTH`` layers, B=4, S=2048,
fp32 parameters, bf16 activations, remat; six steps of
``train_loop.run`` with no checkpoint written, then one profiled step)
and phase 3's DeepSeek-V3 (five layers at full width through the dense
engine, ``serve_dense``: its DENSE_RUNS traffic, a profiled prefill and
decode steps, the decode's conversions of a weight, of ``kv_b``'s views
or of the latent cache).  The einsums' device time is
``chip_smoke._profile(..., einsums=True)``'s: every call of
``attention._einsum32`` in a named span, its backward nodes by their
forward op's sequence number.

    python3 scripts/einsum_share.py [--src DIR]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout's; an
unpacked older tree measures that tree, its kernels built under
``DIR/build``) and ``chip_smoke.py`` from this checkout.  Prints the
card's name and power limit, a line for each model, then one JSON line.
Needs one 80 GB card; imports nothing of JAX.
"""
import argparse
import json
import shutil
import sys
import tempfile
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
    from repro_torch.kernels import build, ops

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    build.build_all()
    build.check_device(torch.device("cuda"))
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.gpu_info())
    out = dict(src=args.src)

    cfg = cs._trainer_cfg()
    tmp = tempfile.mkdtemp(prefix="einsum_share_")
    try:
        run, peak, _ = cs._train(cfg, tmp, "float32",
                                 cs.TRAIN_RUN["steps"], skip_final=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec = cs._run_record(run, peak)
    prof = cs._profile_train_step(cfg, run, "float32")
    del run
    torch.cuda.empty_cache()
    out["trainer"] = dict(step_ms=rec["step_s"] * 1e3, peak_gb=peak,
                          losses=rec["losses"], profile=prof)
    print(f"{cs.TRAIN_ARCH} trainer ({cfg.n_layers} layers, B="
          f"{cs.TRAIN_RUN['batch']}, S={cs.TRAIN_RUN['seq']}): step "
          f"{rec['step_s'] * 1e3:.1f} ms (median), peak {peak:.2f} GB; a "
          f"profiled step {prof['wall_ms']:.1f} ms, busy "
          f"{prof['busy_share']:.3f}, attention einsums "
          f"{prof['einsum_ms']:.1f} ms of device time "
          f"({prof['einsum_share']:.4f})")

    cfg, params = cs.full_width_params("deepseek-v3-671b")
    st, _, line = cs.serve_dense(ops, cfg, params)
    print(line)
    del params
    prof = st.pop("profile")
    out["deepseek"] = dict(
        decode_step_ms=st["decode_step_ms"], prefill_ms=st["prefill_ms"],
        tok_per_s=st["tok_per_s"], peak_gb=st["peak_gb"],
        prefill_profile=prof["prefill"],
        decode_busy=prof["decode"]["busy_share"],
        weight_conversions=prof["decode"]["weight_conversions"],
        latent_conversions=prof["decode"].get("latent_conversions"))
    print(json.dumps(out, default=str))


if __name__ == "__main__":
    main()
