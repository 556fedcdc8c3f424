"""CLI serving driver of the port: dense fixed batches or the paged
continuous-batching engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
      --requests 16 --prompt-len 512 --gen 64 --batch 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --engine paged --requests 16 --prompt-len 512 --gen 64 --batch 8

Reference: ``repro/launch/serve.py``.  ``--engine dense`` (the default) is
the fixed-size-batch loop: one batched prefill, then ``gen - 1`` decode
steps at a shared position; it serves every config that decodes token
prompts, the recurrent, MLA and local-attention families included (the
encoder-only hubert-xlarge and the embedding-input qwen2-vl-7b exit with
code 2: ``lm.forward``, ``lm.prefill`` and ``lm.decode_step`` take them).
``--engine paged`` is the paged continuous-batching engine, for
global-attention configs only, with the reference's
``--prefix-cache`` (and ``--shared-prefix`` to give the prompts a common
system prompt), ``--spec-decode`` (``--spec-k``), ``--chunk-prefill``
(``--chunk-tokens``) and ``--slo``.  ``--model N`` stripes the paged
engine's page pool over N nodes.  With ``--devices D`` (D >= data x
model mesh positions, spread round-robin over the visible cards, or the
CPU with ``--device cpu``) the striping is literal: a ``--data`` x
``--model`` mesh whose "model" axis holds each pool's stripes, every
decode attention run once per stripe and merged; without enough
positions it stays host-side (the allocator's, the pools on one device),
as in the reference.  ``--layout auto`` ranks the (data, model) layouts
of the D positions on the reference's cost model, stripe traffic
included, and serves the best.  ``--fault-plan chaos`` then arms a
seeded fault schedule (node failures and re-joins, a straggler,
transient admission errors) after the warmup and prints the recovery
report.  ``--trace-out T.json`` arms
the flight recorder and exports the run as Chrome trace-event JSON, with
the per-phase model error: the cost engine's predictions (the
reference's TPU v5e-class model, not this device) beside the spans'
host-clock times.  ``--metrics-out M.json`` writes the metrics
registry's snapshot.  The nOS fleet view closes every paged run.  Runs
on the GPU (``--device cpu`` for the CPU) with ``impl="pallas"``, so
every kernel of the path goes through ``kernels/ops.py``.  Weights are
random, from ``--seed``; prompts are drawn with numpy from the same
seed.

With ``--engine dense``, ``--data D --model M`` (D x M > 1) serves on a
device mesh of D x M positions (round-robin over the visible cards, or
the CPU with ``--device cpu``), as the reference's dense engine does:
the batch rows split over the D data groups, each model group's
positions holding their blocks of the weights (tensor parallelism: the
heads, FFN columns, RG-LRU lanes, RWKV-6 heads, the experts' FFN
columns or, under EP, the experts) and their time blocks of the
attention and MLA caches (split-T decode).  ``--layout auto`` picks (D,
M) for the ``--devices`` positions with the reference's cost model.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

def make_prompts(n_requests: int, prompt_len: int, vocab_size: int,
                 seed: int = 0, shared_prefix: int = 0):
    """``n_requests`` int32 prompts of ``prompt_len`` tokens in
    [2, vocab_size), drawn with numpy from ``seed``.  ``shared_prefix``
    gives every request the same leading tokens (a system prompt, drawn
    first) so ``--prefix-cache on`` has something to share."""
    rng = np.random.default_rng(seed)
    # clamp so an over-long system prompt never yields a negative tail
    shared_prefix = max(0, min(shared_prefix, prompt_len))
    base = rng.integers(2, vocab_size, shared_prefix, dtype=np.int32)
    return [np.concatenate([base, rng.integers(
        2, vocab_size, prompt_len - shared_prefix, dtype=np.int32)])
            for _ in range(n_requests)]


def _sync(devices):
    """Wait for each CUDA device of ``devices`` (a mesh's positions may
    lie on several cards)."""
    import torch
    for d in {torch.device(d) for d in devices}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def run_dense(args, cfg, params=None, device=None, mesh=None,
              rules=None):
    """Fixed-batch loop.  Requests are served ``args.batch`` at a time; a
    short last batch is padded by repeating its last prompt.  Each batch
    runs one batched prefill, then ``args.gen - 1`` greedy decode steps at
    the shared position ``prompt_len + i``.  A warmup prefill and decode
    step run before the clock starts.  With ``mesh`` the weights (the
    port's nesting, on one device) are placed on it by the reference's
    specs under ``rules`` (``weights.shard_params``; weights it made
    itself are consumed as they are placed), unless they already are (a
    tree of Sharded leaves), and every step runs on it
    (``steps.make_prefill_step(mesh=)``); the tokens come back to its
    first device.  Returns (request id -> token list, stats)."""
    import torch
    from repro_torch import steps, weights
    from repro_torch.parallel.sharding import Sharded, use_sharding
    from repro_torch.weights import init_params, resolve_device

    device = mesh.devices[0] if mesh is not None else resolve_device(device)
    own = params is None
    if own:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = init_params(cfg, gen, device)
    max_len = args.prompt_len + args.gen
    if mesh is not None:
        with use_sharding(mesh, rules):
            if not isinstance(weights.tree_leaves(params)[0], Sharded):
                params = weights.shard_params(params, cfg, mesh,
                                              consume=own)
            return _dense_loop(
                args, cfg, params,
                steps.make_prefill_step(cfg, max_len=max_len, mesh=mesh),
                steps.make_serve_step(cfg, mesh=mesh), device,
                mesh.devices)
    return _dense_loop(args, cfg, params,
                       steps.make_prefill_step(cfg, max_len=max_len),
                       steps.make_serve_step(cfg), device, (device,))


def _dense_loop(args, cfg, params, prefill, serve, device, clock):
    """The fixed-batch loop on ``device``; each clock reading waits for
    every device in ``clock``."""
    import torch
    prompts = make_prompts(args.requests, args.prompt_len, cfg.vocab_size,
                           args.seed)

    def tokens_of(batch):
        return torch.tensor(np.stack(batch), device=device)

    wl, wc = prefill(params, tokens_of([prompts[0]] * args.batch))
    serve(params, wl.argmax(-1).to(torch.int32), wc, args.prompt_len)
    del wl, wc
    _sync(clock)

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
        _sync(clock)
        td = time.time()
        prefill_s += td - tp
        prefills += 1
        for i in range(args.gen - 1):
            tok, logits, caches = serve(params, tok, caches,
                                        args.prompt_len + i)
            outs.append(tok)
            decode_steps += 1
        seq = torch.cat(outs, -1).cpu()          # (batch, gen)
        _sync(clock)
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


def run_paged(args, cfg, params=None, device=None, n_nodes: int = 1,
              mesh=None):
    """Paged continuous-batching path.  Returns (tokens, stats, engine).

    ``n_nodes`` stripes the page pool over that many nodes (the
    allocator's free lists and the cost engine's layout); with ``mesh``
    the striping is literal: each pool's stripes on the devices of the
    mesh's "model" axis, decode merged across them.  With
    ``args.fault_plan == "chaos"`` the seeded fault schedule is armed
    after the warmup and the metrics reset, so plan step 0 is the first
    measured step."""
    import torch
    from repro_torch.serving.engine import PagedEngine
    from repro_torch.serving.faults import FaultPlan
    from repro_torch.weights import init_params, resolve_device

    device = resolve_device(device)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = init_params(cfg, gen, device)
    max_len = args.prompt_len + args.gen
    # auto pool: exact worst-case demand of a full batch + the null page
    n_pages = args.pages or (
        args.batch * (-(-max_len // args.page_size)) + 1)
    if n_pages % n_nodes:
        n_pages += n_nodes - n_pages % n_nodes   # stripe divisibility
    eng = PagedEngine(cfg, params, max_batch=args.batch,
                      page_size=args.page_size, n_pages=n_pages,
                      max_len=max_len, n_nodes=n_nodes, mesh=mesh,
                      link_mode=args.link_mode,
                      prefill_budget=args.prefill_budget,
                      fused=args.fused, max_window=args.window,
                      prefix_cache=args.prefix_cache == "on",
                      spec_decode=args.spec_decode == "on",
                      spec_k=args.spec_k,
                      chunked_prefill=args.chunk_prefill == "on",
                      chunk_tokens=args.chunk_tokens,
                      trace=bool(args.trace_out),
                      trace_capacity=args.trace_capacity, device=device)
    prompts = make_prompts(args.requests, args.prompt_len, cfg.vocab_size,
                           args.seed, args.shared_prefix)
    # warmup: every window (and verify) bucket, one prefill and, with the
    # cache on, one hit; then reset the clocks and start the tree cold
    eng.warmup_windows()
    eng.submit(prompts[0], min(2, args.gen), rid="warmup")
    eng.run()
    eng.warmup_prefix(args.prompt_len, args.shared_prefix)
    eng.reset_metrics()
    if eng.cache is not None:
        eng.cache.clear()
    if args.fault_plan == "chaos":
        eng.install_faults(FaultPlan.seeded(
            args.fault_seed, n_nodes=n_nodes, horizon=args.fault_horizon))
    for i, p in enumerate(prompts):
        eng.submit(p, args.gen, rid=f"req{i}", slo=args.slo)
    t0 = time.time()
    finished = eng.run()
    _sync(mesh.devices if mesh is not None else (device,))
    dt = time.time() - t0
    outputs = {int(r.rid[3:]): r.tokens for r in finished}
    m = eng.metrics()
    m.update(seconds=dt, step_s=m["decode_step_s"])
    return outputs, m, eng


def report_fleet(args, cfg, eng, tokens_out: int):
    """Register the serve job with the cost-aware nOS and print the fleet
    serving view (per-job pages, energy, queue latency) and, for a traced
    run, the predicted-vs-measured attribution.  Seconds and joules that
    the cost engine prices are the reference's TPU v5e-class model's."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.nos import NOS
    from repro_torch.serving.slo import get_slo

    pod = NOS(data_rows=4, model_cols=max(args.devices or 1, 1))
    shape = ShapeConfig("serve", args.prompt_len + args.gen, args.batch,
                        "decode")
    pod.submit(cfg, name="serve", shape=shape, steps=eng.steps_run,
               mode=args.link_mode, max_rows=1)
    est = pod.jobs["serve"].estimate
    m = eng.metrics()
    slo = get_slo(args.slo)
    met_tokens = sum(len(r.tokens) for r in eng.sched.finished
                     if r.first_token_step <= r.deadline_step)
    model_error = None
    pred_s = meas_s = pred_j = 0.0
    if eng.tracer is not None:
        model_error = eng.tracer.model_error_report()
        pred_s = sum(r["predicted_s"] for r in model_error.values())
        meas_s = sum(r["measured_s"] for r in model_error.values())
        pred_j = sum(r["predicted_j"] for r in model_error.values())
    pod.update_serving(
        "serve", pages_held=eng.alloc.pages_in_use,
        peak_pages=m["peak_pages"], tokens_out=tokens_out,
        queue_latency_s=m["ttft_steps_mean"] * est.step_time_s,
        preemptions=m["preemptions"],
        energy_j=eng.steps_run * est.energy.total_j * est.layout.n_chips,
        shared_pages=m.get("shared_pages"),
        prefix_hit_rate=m.get("prefix_hit_rate"),
        bytes_deduped=m.get("bytes_deduped"),
        accept_rate=m.get("accept_rate"),
        dispatches_per_token=m.get("dispatches_per_token"),
        spec_k=m.get("spec_k_mean"),
        ttft_p99_s=m["ttft_steps_p99"] * est.step_time_s,
        ttft_target_s=slo.ttft_steps * est.step_time_s,
        goodput_frac=met_tokens / max(tokens_out, 1),
        pages_quarantined=m.get("pages_quarantined"),
        requests_recovered=m.get("requests_recovered"),
        tokens_recomputed=m.get("tokens_recomputed"),
        recovery_steps_p99=m.get("recovery_steps_p99"),
        predicted_s=pred_s, measured_s=meas_s, predicted_j=pred_j,
        model_error=model_error)
    print("[nOS] fleet serving view (queue latency, TTFT and energy priced "
          "by the reference's TPU v5e-class cost model):")
    print(pod.serving_table())
    if model_error:
        print(f"[nOS] predicted-vs-measured attribution (predicted: the "
              f"reference's TPU v5e-class cost model; measured: host wall "
              f"time on {eng.device}):")
        print(pod.attribution_table())


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
    ap.add_argument("--prefix-cache", default="off", choices=["on", "off"],
                    help="paged engine: radix-tree prefix sharing with "
                         "copy-on-write on the page store")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="give every request the same leading N tokens "
                         "(a system prompt) so the prefix cache has "
                         "something to share")
    ap.add_argument("--spec-decode", default="off", choices=["on", "off"],
                    help="paged engine: n-gram speculative decoding — "
                         "draft from each sequence's own history, verify "
                         "K+1 positions in one pass, roll back rejected "
                         "pages")
    ap.add_argument("--spec-k", default="auto",
                    help="max draft tokens per verify: an integer for a "
                         "fixed depth, or 'auto' (default) for the "
                         "per-tenant acceptance-EWMA controller")
    ap.add_argument("--chunk-prefill", default="off", choices=["on", "off"],
                    help="paged engine: split prefills into page-aligned "
                         "chunks co-scheduled with decode windows under "
                         "SLO-aware EDF admission")
    ap.add_argument("--chunk-tokens", type=int, default=0,
                    help="tokens per prefill chunk (0 = 2 pages)")
    ap.add_argument("--slo", default="standard",
                    choices=["interactive", "standard", "batch"],
                    help="SLO class stamped on every submitted request "
                         "(TTFT deadline + tolerable prefill stall; "
                         "drives the chunked scheduler)")
    ap.add_argument("--link-mode", default="circuit",
                    choices=["circuit", "packet"],
                    help="interconnect mode the cost engine prices")
    ap.add_argument("--data", type=int, default=1,
                    help="paged engine: the mesh's data degree (replicas "
                         "of the engine's work; needs --devices)")
    ap.add_argument("--model", type=int, default=1,
                    help="paged engine: stripe the page pool over N nodes "
                         "(on the mesh's devices with enough --devices, "
                         "else host-side)")
    ap.add_argument("--fault-plan", default="off", choices=["off", "chaos"],
                    help="paged engine: arm a seeded deterministic fault "
                         "schedule (node failures quarantining their page "
                         "stripe, transient admission rejections under "
                         "capped backoff, a straggler) and print the "
                         "recovery report; needs --model >= 2")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed for the chaos fault schedule")
    ap.add_argument("--fault-horizon", type=int, default=48,
                    help="steps the chaos fault schedule spans")
    ap.add_argument("--trace-out", default=None, metavar="TRACE.json",
                    help="paged engine: arm the step-clock flight recorder "
                         "and export the run as Chrome trace-event JSON")
    ap.add_argument("--metrics-out", default=None, metavar="METRICS.json",
                    help="paged engine: write the metrics registry's "
                         "snapshot (counters, gauges, percentile digests)")
    ap.add_argument("--trace-capacity", type=int, default=4096,
                    help="flight-recorder ring size (spans kept; oldest "
                         "evicted first)")
    ap.add_argument("--layout", default="manual", choices=["manual", "auto"],
                    help="paged engine: 'auto' ranks the (data, model) "
                         "layouts of the mesh positions on the cost "
                         "model and serves the best")
    ap.add_argument("--devices", type=int, default=0,
                    help="paged engine: mesh positions, spread round-robin "
                         "over the visible cards (the CPU with --device "
                         "cpu); default one per visible card")
    return ap


def _layout_mesh(args, cfg, paged):
    """(mesh or None, the cost engine's chosen estimate or None), as the
    reference CLI builds them.  The positions lie on the CPU only with
    ``--device cpu``; with no ``--device`` and no card it raises, as the
    one-device runs do.  ``--layout auto`` ranks the (data, model)
    layouts of the mesh positions (``--devices``, else one per visible
    card, else 1) for the decode shape, pricing the paged engine's
    striped-KV traffic on top of the transformer collectives, and prints
    them.  Otherwise a ``--data`` x ``--model`` mesh of more than one
    position: the paged engine's only when there are that many positions
    (else it stripes host-side over ``--model`` nodes), the dense
    engine's always (its positions may share a card)."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel.sharding import (autotune_layout,
                                               make_layout_mesh)
    from repro_torch.weights import resolve_device
    on_cpu = resolve_device(args.device).type == "cpu"
    devices = "cpu" if on_cpu else None
    n_pos = args.devices or (1 if on_cpu else torch.cuda.device_count())
    if args.layout == "auto":
        shape = ShapeConfig("serve", args.prompt_len + args.gen, args.batch,
                            "decode")
        best, ranked = autotune_layout(cfg, shape, n_chips=n_pos,
                                       mode=args.link_mode, serving=paged)
        print(f"[cost-engine] {len(ranked)} candidate layouts for "
              f"{best.layout.n_chips} mesh positions ({args.link_mode} "
              "mode; the reference's TPU v5e-class prices):")
        for est in ranked:
            tag = " <= chosen" if est is ranked[0] else ""
            print(f"[cost-engine]   {est.describe()}{tag}")
        print(f"[cost-engine] predicted decode step "
              f"{best.step_time_s * 1e3:.3f} ms "
              f"({best.tokens_per_s:.0f} tok/s)")
        return make_layout_mesh(best.layout, devices), best
    n = args.data * args.model
    if n > 1 and (not paged or n_pos >= n):
        return make_test_mesh(args.data, args.model, devices=devices), None
    return None, None


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.prompt_len < 1:
        print(f"error: --prompt-len must be >= 1 (got {args.prompt_len})",
              file=sys.stderr)
        raise SystemExit(2)
    if args.spec_k != "auto":
        args.spec_k = int(args.spec_k)
    from repro_torch.configs import get_config, get_tiny_config
    from repro_torch.models import lm

    cfg = get_tiny_config(args.arch) if args.tiny else get_config(args.arch)
    cfg = cfg.replace(impl="pallas")
    if not cfg.supports_decode:
        print(f"error: {cfg.name} is encoder-only: nothing to decode "
              "(lm.forward runs it)", file=sys.stderr)
        raise SystemExit(2)
    if not cfg.embed_inputs:
        print(f"error: {cfg.name} takes embeddings from a stub frontend, "
              "and the CLI draws token prompts (lm.prefill and "
              "lm.decode_step take embeddings and positions)",
              file=sys.stderr)
        raise SystemExit(2)
    if args.engine == "dense":
        from repro_torch import steps
        mesh, predicted = _layout_mesh(args, cfg, paged=False)
        if mesh is not None:
            groups = len(mesh.devices) // mesh.shape.get("model", 1)
            try:
                steps.check_mesh(cfg, mesh)
                if args.batch % groups:
                    raise ValueError(f"--batch {args.batch} does not split "
                                     f"over {groups} data groups")
            except (NotImplementedError, ValueError) as e:
                print(f"error: {e}", file=sys.stderr)
                raise SystemExit(2)
            where = ", ".join(sorted(set(map(str, mesh.devices))))
            print(f"[dense] mesh {dict(mesh.shape)}: {len(mesh.devices)} "
                  f"positions on {mesh.distinct_devices} distinct "
                  f"device(s) ({where})")
        outputs, m = run_dense(args, cfg, device=args.device, mesh=mesh)
        print(f"[dense] {cfg.name}: served {m['requests']} requests, "
              f"{m['tokens']} tokens in {m['seconds']:.2f}s "
              f"({m['tokens'] / max(m['seconds'], 1e-9):.1f} tok/s); "
              f"prefill {m['prefill_s'] * 1e3:.2f} ms, decode step "
              f"{m['step_s'] * 1e3:.2f} ms over {m['decode_steps']} steps")
        if predicted is not None:
            print(f"[cost-engine] predicted {predicted.step_time_s * 1e3:.3f}"
                  f" ms vs measured {m['step_s'] * 1e3:.3f} ms per decode "
                  f"step (warmup excluded; the cost engine models the "
                  f"reference's TPU v5e-class chips, not this device)")
        return
    if not lm.paged_decodable(cfg):
        print(f"error: --engine paged serves global-attention configs only; "
              f"{cfg.name} has layer kinds {sorted(set(cfg.layer_kinds))} "
              "(use --engine dense)", file=sys.stderr)
        raise SystemExit(2)
    mesh, predicted = _layout_mesh(args, cfg, paged=True)
    n_nodes = (predicted.layout.model if predicted is not None
               else max(args.model, 1))
    if args.fault_plan == "chaos" and n_nodes < 2:
        print("error: --fault-plan chaos needs a striped pool (--model N "
              ">= 2): node 0 never fails, so a 1-node pool has nothing to "
              "quarantine", file=sys.stderr)
        raise SystemExit(2)
    outputs, m, eng = run_paged(args, cfg, device=args.device,
                                n_nodes=n_nodes, mesh=mesh)
    tokens = sum(len(t) for t in outputs.values())
    print(f"[paged] {eng.device}: served {m['finished']} requests, {tokens} "
          f"tokens in {m['seconds']:.2f}s "
          f"({tokens / max(m['seconds'], 1e-9):.1f} tok/s, "
          f"{m['steps']} engine steps)")
    if mesh is not None and eng._stripe > 1:
        print(f"[paged] mesh {dict(mesh.shape)}: each pool in "
              f"{eng._stripe} stripes over "
              f"{', '.join(str(d) for d in mesh.axis_devices('model'))} "
              f"({mesh.distinct_devices} distinct device(s) in the mesh)")
    elif mesh is not None:
        print(f"[paged] mesh {dict(mesh.shape)}: no model axis to stripe "
              f"over, the pools on {eng.device} (the data axis replicates)")
    else:
        print(f"[paged] no mesh: the pools on {eng.device}, the allocator "
              f"striped over {n_nodes} node(s)")
    print(f"[paged] TTFT mean {m['ttft_steps_mean']:.1f} / p95 "
          f"{m['ttft_steps_p95']:.1f} steps; peak pages {m['peak_pages']} "
          f"({m['page_occupancy'] * 100:.0f}% of pool); "
          f"{m['preemptions']} preemptions")
    mode = "fused" if args.fused else "per-step"
    print(f"[paged] {mode}: {m['windows']} device calls for {m['steps']} "
          f"scheduler steps; host<->device syncs {m['h2d_syncs']} h2d + "
          f"{m['d2h_syncs']} d2h ({m['syncs_per_token']:.2f} per token); "
          f"decode {m['decode_tok_per_s']:.1f} tok/s")
    if eng.spec is not None:
        print(f"[paged] spec decode: {m['model_passes']} model passes "
              f"for {m['tokens_out']} tokens "
              f"({m['dispatches_per_token']:.2f} dispatches/token); "
              f"accept rate {m['accept_rate'] * 100:.0f}% "
              f"({m['spec_accepted']}/{m['spec_drafted']} drafts over "
              f"{m['spec_verifies']} verifies, "
              f"{m['spec_rollbacks']} page rollbacks)")
        if eng.spec.adaptive:
            print(f"[paged] spec depth: adaptive, mean K "
                  f"{m['spec_k_mean']:.1f}; draft+verify "
                  f"{m['spec_verify_s']:.3f}s of {m['decode_s']:.3f}s "
                  f"decode")
    if eng.sched.chunked:
        print(f"[paged] chunked prefill: {m['chunk_tasks']} chunks in "
              f"{m['chunk_rounds']} rounds "
              f"({m['chunk_dispatches']} dispatches, "
              f"{m['chunk_preemptions']} mid-prefill preemptions); "
              f"SLO class {args.slo}, p99 TTFT "
              f"{m['ttft_steps_p99']:.1f} steps")
    if eng.cache is not None:
        print(f"[paged] prefix cache: {m['prefix_hit_rate'] * 100:.0f}%"
              f" hit rate ({m['prefix_hits']}/{m['prefix_lookups']}), "
              f"{m['prefill_tokens_cached']} prefill tokens served "
              f"from shared pages ({m['prefill_tokens']} computed), "
              f"{m['cow_copies']} COW copies, {m['shared_pages']} tree "
              f"pages, {m['prefix_evictions']} evictions, "
              f"{m['bytes_deduped'] / 1024:.0f} KiB deduped")
    if eng.faults is not None:
        print(f"[paged] fault plane: {m['node_failures']} node "
              f"failures / {m['node_joins']} re-joins, "
              f"{m['pages_quarantined']} pages quarantined, "
              f"{m['requests_recovered']} requests recovered "
              f"({m['tokens_recomputed']} tokens recomputed), "
              f"{m['requests_shed']} shed, "
              f"{m['transient_rejections']} transient rejections; "
              f"recovery p99 {m['recovery_steps_p99']:.1f} steps, "
              f"{m['quarantined_served']} stale reads")
    if eng.tracer is not None:
        from repro_torch.serving.telemetry import format_model_error
        eng.tracer.finalize(eng.sched.step_idx)
        report = eng.tracer.model_error_report()
        if report:
            print(f"[trace] per-phase model error (predicted by the "
                  f"reference's TPU v5e-class cost model vs measured host "
                  f"wall time on {eng.device}):")
            print(format_model_error(report))
        eng.tracer.write_chrome(args.trace_out)
        n = len(eng.tracer.chrome_trace()["traceEvents"])
        print(f"[trace] wrote {n} trace events to {args.trace_out} (load "
              f"in Perfetto / chrome://tracing; {eng.tracer.recorded} spans "
              f"recorded, {eng.tracer.dropped} evicted)")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(eng.registry.snapshot(), f, indent=2, sort_keys=True)
        print(f"[metrics] wrote registry snapshot to {args.metrics_out}")
    report_fleet(args, cfg, eng, tokens)
    if predicted is not None:
        # warmup ran before the clock: this ratio is steady-state only
        print(f"[cost-engine] predicted {predicted.step_time_s * 1e3:.3f} "
              f"ms vs measured {m['step_s'] * 1e3:.3f} ms per decode step "
              f"(warmup excluded; ratio "
              f"{m['step_s'] / predicted.step_time_s:.2f}x: the cost "
              f"engine models the reference's TPU v5e-class chips, not "
              f"{eng.device})")


if __name__ == "__main__":
    main()
