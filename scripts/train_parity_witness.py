"""How far rounding alone moves the train-step parity of chip_smoke.py.

``chip_smoke.py`` phase 6 holds three ``make_train_step`` steps of
qwen3-1.7b (full width, cut to 2 layers, fp32 activations, B=2, S=256,
weight decay 0.1) on the card against the same steps on the CPU.  This
script runs the same steps in pairs that differ in nothing but rounding,
at the trainer's lr 3e-4 and at the parity's lr, and prints what the
parity reads between each pair (``chip_smoke.parity_gaps``):

* ``blas``: the card against itself with the GEMMs of the other BLAS
  library (``torch.backends.cuda.preferred_blas_library``, cuBLAS and
  cuBLASLt);
* ``ulp``: the card against itself from weights moved by one unit in the
  last place (every element times 1 +- 2**-23, the signs drawn from a
  seed);
* ``repeat``: the CPU against itself, run again as it was (its
  multi-threaded embedding gradient is not bit-reproducible), and
  ``threads``: the CPU at its full thread count against the CPU at half
  of it (fp32 moments, lr 3e-4);
* ``card-cpu``: the card against the CPU at lr 3e-4 (what the parity
  would read at the trainer's lr).

fp32 moments at the full vocabulary and int8 ones at the parity's cut
vocabulary, as in ``chip_smoke.py``.

    python3 scripts/train_parity_witness.py

Needs one CUDA card; writes chiprun_out/train_parity_witness.json.
"""
import json
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402

TRAINER_LR = 3e-4


def _ulp(params, seed):
    """Every element times 1 +- 2**-23, the sign drawn from ``seed``."""
    from repro_torch import weights
    g = torch.Generator(device=cs.DEVICE).manual_seed(seed)

    def nudge(t):
        sign = torch.randint(0, 2, t.shape, generator=g, device=t.device,
                             dtype=torch.int8).float() * 2 - 1
        return (t.float() * (1 + sign * 2.0 ** -23)).to(t.dtype)
    return weights._tree(nudge, params)


def _row(what, state_dtype, lr, a, b, gaps):
    losses = lambda r: [round(h["loss"], 5) for h in r[2]]
    rec = dict(pair=what, state_dtype=state_dtype, lr=lr,
               losses_a=losses(a), losses_b=losses(b),
               bit_equal=all(torch.equal(x, y.to(x.device))
                             for x, y in zip(a[0], b[0])), **gaps)
    print(f"{what:9s} {state_dtype:7s} lr {lr:<7g}: params "
          f"{gaps['param_share_off']:.3g} of a leaf off (worst "
          f"{gaps['param_share_leaf']}), largest "
          f"gap {gaps['param_max_abs']:.3g}; moments m "
          f"{gaps['m_rel_err']:.3g} v {gaps['v_rel_err']:.3g}; int8 codes "
          f"{gaps['code_max_dist']:.0f} apart on "
          f"{gaps['code_share_off']:.3g}; metrics "
          f"{gaps['metric_rel_err']:.3g}; bit-equal {rec['bit_equal']}",
          flush=True)
    return rec


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from repro_torch import weights
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.gpu_info(), flush=True)
    t0 = time.time()
    rows = []
    for state_dtype in ("float32", "int8"):
        cfg = cs.parity_cfg_for(state_dtype)
        cpu = weights.init_params(cfg, torch.Generator().manual_seed(cs.SEED),
                                  "cpu")
        card = weights._tree(lambda t: t.to(cs.DEVICE), cpu)
        run = lambda p, lr: cs.parity_run(cfg, state_dtype, lr, p)
        for lr in (TRAINER_LR, cs.STEP_PARITY["lr"]):
            base = run(card, lr)
            torch.backends.cuda.preferred_blas_library("cublaslt")
            other = run(card, lr)
            torch.backends.cuda.preferred_blas_library("cublas")
            rows.append(_row("blas", state_dtype, lr, base, other,
                             cs.parity_gaps(cfg, base, other)))
            nudged = run(_ulp(card, cs.SEED + 1), lr)
            rows.append(_row("ulp", state_dtype, lr, base, nudged,
                             cs.parity_gaps(cfg, base, nudged)))
            if lr != TRAINER_LR:
                continue
            full = torch.get_num_threads()
            on_cpu = run(cpu, lr)
            rows.append(_row("card-cpu", state_dtype, lr, on_cpu, base,
                             cs.parity_gaps(cfg, on_cpu, base)))
            if state_dtype == "float32":
                again = run(cpu, lr)
                rows.append(_row("repeat", state_dtype, lr, on_cpu, again,
                                 cs.parity_gaps(cfg, on_cpu, again)))
                torch.set_num_threads(max(full // 2, 1))
                half = run(cpu, lr)
                torch.set_num_threads(full)
                rows.append(_row("threads", state_dtype, lr, on_cpu, half,
                                 cs.parity_gaps(cfg, on_cpu, half)))
                rows[-1]["threads"] = [full, max(full // 2, 1)]
        del cpu, card
        torch.cuda.empty_cache()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "train_parity_witness.json").write_text(json.dumps(
        dict(gpu=cs.gpu_info(), torch=torch.__version__, rows=rows,
             seconds=time.time() - t0), indent=1))
    print(f"took {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
