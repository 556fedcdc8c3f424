"""CLI serving driver of the port: dense fixed batches or the paged
continuous-batching engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
      --requests 16 --prompt-len 512 --gen 64 --batch 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --engine paged --requests 16 --prompt-len 512 --gen 64 --batch 8

Reference: ``repro/launch/serve.py``.  ``--engine dense`` (the default) is
the fixed-size-batch loop: one batched prefill, then ``gen - 1`` decode
steps at a shared position; it serves every ported config, the recurrent
families included.  ``--engine paged`` is the paged continuous-batching
engine, for global-attention configs only.  Runs on the GPU (``--device
cpu`` for the CPU) with ``impl="pallas"``, so every kernel of the path
goes through ``kernels/ops.py``.  Weights are random, from ``--seed``;
prompts are drawn with numpy from the same seed.  Flags of engine
features this port does not have yet are rejected with exit code 2.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

# flag -> the value that means "feature off"; anything else is rejected
_UNPORTED_FLAGS = {"layout": "manual", "prefix_cache": "off",
                   "spec_decode": "off", "chunk_prefill": "off",
                   "fault_plan": "off", "trace_out": None, "devices": 0}


def make_prompts(n_requests: int, prompt_len: int, vocab_size: int,
                 seed: int = 0):
    """``n_requests`` int32 prompts of ``prompt_len`` tokens in
    [2, vocab_size), drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab_size, prompt_len, dtype=np.int32)
            for _ in range(n_requests)]


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_dense(args, cfg, params=None, device=None):
    """Fixed-batch loop.  Requests are served ``args.batch`` at a time; a
    short last batch is padded by repeating its last prompt.  Each batch
    runs one batched prefill, then ``args.gen - 1`` greedy decode steps at
    the shared position ``prompt_len + i``.  A warmup prefill and decode
    step run before the clock starts.  Returns (request id -> token list,
    stats)."""
    import torch
    from repro_torch import steps
    from repro_torch.weights import init_params, resolve_device

    device = resolve_device(device)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = init_params(cfg, gen, device)
    max_len = args.prompt_len + args.gen
    prefill = steps.make_prefill_step(cfg, max_len=max_len)
    serve = steps.make_serve_step(cfg)
    prompts = make_prompts(args.requests, args.prompt_len, cfg.vocab_size,
                           args.seed)

    def tokens_of(batch):
        return torch.tensor(np.stack(batch), device=device)

    wl, wc = prefill(params, tokens_of([prompts[0]] * args.batch))
    serve(params, wl.argmax(-1).to(torch.int32), wc, args.prompt_len)
    del wl, wc
    _sync(device)

    pending = list(enumerate(prompts))
    outputs = {}
    prefills, decode_steps, prefill_s, decode_s = 0, 0, 0.0, 0.0
    t0 = time.time()
    while pending:
        batch = pending[:args.batch]
        pending = pending[args.batch:]
        rows = [p for _, p in batch]
        rows += [rows[-1]] * (args.batch - len(rows))   # pad the last batch
        tp = time.time()
        logits, caches = prefill(params, tokens_of(rows))
        tok = logits.argmax(-1).to(torch.int32)
        outs = [tok]
        _sync(device)
        td = time.time()
        prefill_s += td - tp
        prefills += 1
        for i in range(args.gen - 1):
            tok, logits, caches = serve(params, tok, caches,
                                        args.prompt_len + i)
            outs.append(tok)
            decode_steps += 1
        seq = torch.cat(outs, -1).cpu()          # (batch, gen); syncs
        decode_s += time.time() - td
        for row, (rid, _) in enumerate(batch):
            outputs[rid] = [int(t) for t in seq[row]]
        del caches
    dt = time.time() - t0
    tokens = sum(len(t) for t in outputs.values())
    stats = dict(requests=len(outputs), tokens=tokens, seconds=dt,
                 prefills=prefills, prefill_s=prefill_s / max(prefills, 1),
                 decode_steps=decode_steps,
                 step_s=decode_s / max(decode_steps, 1))
    return outputs, stats


def run_paged(args, cfg, params=None, device=None):
    """Paged continuous-batching path.  Returns (tokens, stats, engine)."""
    import torch
    from repro_torch.serving.engine import PagedEngine
    from repro_torch.weights import init_params, resolve_device

    device = resolve_device(device)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = init_params(cfg, gen, device)
    max_len = args.prompt_len + args.gen
    # auto pool: exact worst-case demand of a full batch + the null page
    n_pages = args.pages or (
        args.batch * (-(-max_len // args.page_size)) + 1)
    eng = PagedEngine(cfg, params, max_batch=args.batch,
                      page_size=args.page_size, n_pages=n_pages,
                      max_len=max_len, prefill_budget=args.prefill_budget,
                      fused=args.fused, max_window=args.window,
                      device=device)
    prompts = make_prompts(args.requests, args.prompt_len, cfg.vocab_size,
                           args.seed)
    # warmup: every window bucket and one prefill, then reset the clocks
    eng.warmup_windows()
    eng.submit(prompts[0], min(2, args.gen), rid="warmup")
    eng.run()
    eng.reset_metrics()
    for i, p in enumerate(prompts):
        eng.submit(p, args.gen, rid=f"req{i}", slo=args.slo)
    t0 = time.time()
    finished = eng.run()
    _sync(device)
    dt = time.time() - t0
    outputs = {int(r.rid[3:]): r.tokens for r in finished}
    m = eng.metrics()
    m.update(seconds=dt, step_s=m["decode_step_s"])
    return outputs, m, eng


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny-100m")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--engine", default="dense", choices=["dense", "paged"])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu for the CPU)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the prompts")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page")
    ap.add_argument("--pages", type=int, default=0,
                    help="pool size incl. null page (0=auto)")
    ap.add_argument("--prefill-budget", type=float, default=2.0,
                    help="prefill seconds admitted per step, in units of "
                         "one decode step (cost-engine priced)")
    ap.add_argument("--fused", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="fused multi-token decode windows (--no-fused = "
                         "per-step host loop)")
    ap.add_argument("--window", type=int, default=8,
                    help="max fused window (tokens per device call)")
    ap.add_argument("--slo", default="standard",
                    choices=["interactive", "standard", "batch"])
    # features of the reference CLI that this port does not have yet
    ap.add_argument("--layout", default="manual", choices=["manual", "auto"])
    ap.add_argument("--prefix-cache", default="off", choices=["on", "off"])
    ap.add_argument("--spec-decode", default="off", choices=["on", "off"])
    ap.add_argument("--chunk-prefill", default="off", choices=["on", "off"])
    ap.add_argument("--fault-plan", default="off", choices=["off", "chaos"])
    ap.add_argument("--trace-out", default=None)
    ap.add_argument("--devices", type=int, default=0)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    for flag, off in _UNPORTED_FLAGS.items():
        if getattr(args, flag) != off:
            print(f"error: --{flag.replace('_', '-')} is not ported to the "
                  "PyTorch engine yet (see ROADMAP.md Queue A)",
                  file=sys.stderr)
            raise SystemExit(2)
    if args.prompt_len < 1:
        print(f"error: --prompt-len must be >= 1 (got {args.prompt_len})",
              file=sys.stderr)
        raise SystemExit(2)
    from repro_torch.configs import get_config, get_tiny_config
    from repro_torch.models import lm

    cfg = get_tiny_config(args.arch) if args.tiny else get_config(args.arch)
    cfg = cfg.replace(impl="pallas")
    if args.engine == "dense":
        outputs, m = run_dense(args, cfg, device=args.device)
        print(f"[dense] {cfg.name}: served {m['requests']} requests, "
              f"{m['tokens']} tokens in {m['seconds']:.2f}s "
              f"({m['tokens'] / max(m['seconds'], 1e-9):.1f} tok/s); "
              f"prefill {m['prefill_s'] * 1e3:.2f} ms, decode step "
              f"{m['step_s'] * 1e3:.2f} ms over {m['decode_steps']} steps")
        return
    if not lm.paged_decodable(cfg):
        print(f"error: --engine paged serves global-attention configs only; "
              f"{cfg.name} has layer kinds {sorted(set(cfg.layer_kinds))} "
              "(use --engine dense)", file=sys.stderr)
        raise SystemExit(2)
    outputs, m, eng = run_paged(args, cfg, device=args.device)
    tokens = sum(len(t) for t in outputs.values())
    print(f"[paged] {eng.device}: served {m['finished']} requests, {tokens} "
          f"tokens in {m['seconds']:.2f}s "
          f"({tokens / max(m['seconds'], 1e-9):.1f} tok/s, "
          f"{m['steps']} engine steps)")
    print(f"[paged] TTFT mean {m['ttft_steps_mean']:.1f} / p95 "
          f"{m['ttft_steps_p95']:.1f} steps; peak pages {m['peak_pages']} "
          f"({m['page_occupancy'] * 100:.0f}% of pool); "
          f"{m['preemptions']} preemptions")
    mode = "fused" if args.fused else "per-step"
    print(f"[paged] {mode}: {m['windows']} device calls for {m['steps']} "
          f"scheduler steps; host<->device syncs {m['h2d_syncs']} h2d + "
          f"{m['d2h_syncs']} d2h ({m['syncs_per_token']:.2f} per token); "
          f"decode {m['decode_tok_per_s']:.1f} tok/s")


if __name__ == "__main__":
    main()
