"""The port's serving layer against the JAX reference on the CPU.

* the host copies (page allocator, scheduler) make the same decisions as
  the reference's on seeded op sequences and arrival traces;
* the port's ``PagedEngine(device="cpu")``, fused and per-step, including
  a pool small enough to force preemption, emits greedy tokens identical
  to the reference's dense oracle and to the reference ``PagedEngine``,
  with the same scheduler and transfer counters;
* the engine takes the fault plane and tracing, and raises for a mesh;
  the serve CLI's chaos, trace and metrics flags run, and its flags that
  need a mesh exit 2 (the prefix cache, speculative decoding and chunked
  prefill are held against the reference in ``test_torch_prefix_spec.py``
  and ``test_torch_flag_cube.py``; the fault plane in
  ``test_torch_faults.py`` and ``test_torch_chaos_cube.py``).
"""
import numpy as np
import pytest

from conftest import dense_oracle, get_tiny_model, seeded_prompts
from repro.serving import (ContinuousBatchScheduler as JSched,
                           PageAllocator as JAlloc, PagedEngine as JEngine,
                           Request as JRequest)
from repro_torch.configs import get_tiny_config
from repro_torch.launch import serve
from repro_torch.serving.engine import PagedEngine
from repro_torch.serving.faults import FaultEvent, FaultPlan
from repro_torch.serving.paged_kv import NULL_PAGE, PageAllocator
from repro_torch.serving.scheduler import ContinuousBatchScheduler, Request
from repro_torch.weights import from_reference

COUNTERS = ("steps", "windows", "preemptions", "peak_pages", "h2d_syncs",
            "d2h_syncs", "tokens_out", "block_row_writes", "model_passes",
            "prefill_tokens")


def _alloc_state(a):
    return (sorted(a.held.items()), sorted(a.refcount.items()),
            [list(f) for f in a._free_by_node])


def _apply(a, shared, op):
    """One allocator op (template: tests/test_property_serving.py)."""
    code, r, n = op
    rid = f"r{r}"
    held = a.held.get(rid)
    if code == 0 and held is None:
        return a.alloc(rid, n % 5 + 1)
    if code == 1 and held is not None:
        return a.grow(rid, n % 3 + 1)
    if code == 2 and held is not None:
        return a.free(rid)
    if code == 3 and held:
        page = held[n % len(held)]
        a.share(page)
        shared.append(page)
    elif code == 4 and shared:
        return a.release_page(shared.pop(n % len(shared)))
    elif code == 5 and held is not None:
        return a.reserve(rid, n * a.page_size // 2)
    elif code == 6 and held is not None:
        return a.truncate_to(rid, n * a.page_size // 2)
    return None


@pytest.mark.parametrize("seed", range(4))
def test_allocator_decisions_match_reference(seed):
    rng = np.random.default_rng(seed)
    ops = [tuple(int(v) for v in rng.integers(0, (7, 4, 10)))
           for _ in range(80)]
    mine, ref = PageAllocator(17, 4, n_nodes=3), JAlloc(17, 4, n_nodes=3)
    sm, sr = [], []
    for op in ops:
        assert _apply(mine, sm, op) == _apply(ref, sr, op), op
        assert _alloc_state(mine) == _alloc_state(ref), op
        assert mine.check_conservation()
        assert NULL_PAGE not in mine.refcount


@pytest.mark.parametrize("seed", range(3))
def test_scheduler_decisions_match_reference(seed):
    """The same arrival trace drives both schedulers step by step: same
    admissions, preemptions, page holdings and finish order."""
    rng = np.random.default_rng(seed)
    reqs = [(int(p), int(g)) for p, g in zip(rng.integers(1, 9, 10),
                                             rng.integers(1, 7, 10))]
    cost = dict(prefill_cost_s=lambda n: 0.1 * n, decode_cost_s=0.5,
                prefill_budget=2.0)
    scheds = []
    for alloc_cls, sched_cls, req_cls in ((PageAllocator,
                                           ContinuousBatchScheduler,
                                           Request),
                                          (JAlloc, JSched, JRequest)):
        a = alloc_cls(n_pages=12, page_size=4, n_nodes=2)
        s = sched_cls(a, max_batch=3, **cost)
        for i, (plen, gen) in enumerate(reqs):
            s.submit(req_cls(rid=f"q{i}", prompt_len=plen, gen=gen))
        scheds.append((a, s))
    for step in range(300):
        if not any(s.waiting or s.running for _, s in scheds):
            break
        seen = []
        for a, s in scheds:
            plan = s.plan_step()
            for req in plan.admitted:
                s.note_first_token(req, token=1)
            horizon = s.safe_horizon(4)
            s.complete_step({slot: 1 for slot in list(s.running)})
            seen.append(([r.rid for r in plan.admitted],
                         [r.rid for r in plan.preempted], horizon,
                         sorted((sl, r.rid) for sl, r in s.running.items()),
                         _alloc_state(a)))
        assert seen[0] == seen[1], step
    assert [r.rid for r in scheds[0][1].finished] == \
        [r.rid for r in scheds[1][1].finished]
    assert scheds[0][1].conserved(len(reqs))


@pytest.fixture(scope="module")
def tiny():
    """(reference cfg, reference params, port cfg, port params), fp32."""
    import jax
    cfg, params = get_tiny_model()
    cfg = cfg.replace(activation_dtype="float32")
    tcfg = get_tiny_config("tiny-100m").replace(activation_dtype="float32")
    tparams = from_reference(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return cfg, params, tcfg, tparams


def _serve(engine_cls, cfg, params, prompts, gens, **kw):
    eng = engine_cls(cfg, params, **kw)
    for i, (p, g) in enumerate(zip(prompts, gens)):
        eng.submit(np.asarray(p), g, rid=f"r{i}")
    toks = {r.rid: list(r.tokens) for r in eng.run()}
    m = eng.metrics()
    return toks, {k: m[k] for k in COUNTERS}, eng


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("impl", ["blocked", "pallas"])
def test_engine_matches_dense_oracle_and_reference_under_preemption(
        tiny, fused, impl):
    """Tight pool + unthrottled admission forces preemption; varied gens
    cut windows mid-trace (tests/test_serving.py's preemption and fused
    gates).  ``impl="pallas"`` routes the port through the kernel
    wrappers (their plain versions on the CPU)."""
    cfg, params, tcfg, tparams = tiny
    S, gens = 12, [6, 3, 6, 5, 2, 6]
    max_len = S + max(gens)
    prompts = seeded_prompts(cfg, len(gens), S)
    dense = dense_oracle(cfg, params, prompts, gens, max_len)
    kw = dict(max_batch=3, page_size=4, n_pages=14, max_len=max_len,
              prefill_budget=0.0, fused=fused, max_window=8)
    toks, counters, eng = _serve(PagedEngine, tcfg.replace(impl=impl),
                                 tparams, prompts, gens, device="cpu", **kw)
    ref_toks, ref_counters, _ = _serve(JEngine, cfg, params, prompts, gens,
                                       **kw)
    assert toks == dense == ref_toks
    assert counters == ref_counters
    assert counters["preemptions"] >= 1, "pool was sized to force preemption"
    assert eng.alloc.pages_in_use == 0
    if fused:
        assert counters["windows"] < counters["steps"]


def test_engine_transfer_counters_per_window(tiny):
    """O(1) syncs per token per-step vs O(1) per window fused — the
    reference's transfer-counter gate, on the port's engine."""
    cfg, params, tcfg, tparams = tiny
    S, gen = 8, 9
    prompts = seeded_prompts(cfg, 2, S)
    kw = dict(max_batch=2, page_size=4, n_pages=24, max_len=S + gen,
              max_window=8, prefill_budget=0.0, device="cpu")
    toks_f, c_f, _ = _serve(PagedEngine, tcfg, tparams, prompts, [gen] * 2,
                            fused=True, **kw)
    toks_p, c_p, eng_p = _serve(PagedEngine, tcfg, tparams, prompts,
                                [gen] * 2, fused=False, **kw)
    assert toks_f == toks_p
    assert eng_p.decode_steps == 8
    assert c_p["d2h_syncs"] == 8 + 2 and c_p["h2d_syncs"] == 8 + 2
    assert c_f["windows"] == 1 and c_f["d2h_syncs"] == 1 + 2


def test_engine_warmup_and_cli_on_cpu(tiny, capsys):
    """``warmup_windows`` leaves the tokens unchanged; the serve CLI runs
    the tiny model end to end on the CPU."""
    _, _, tcfg, tparams = tiny
    prompts = seeded_prompts(tcfg, 2, 8)
    base, _, _ = _serve(PagedEngine, tcfg, tparams, prompts, [5, 5],
                        device="cpu", max_batch=2, page_size=4, n_pages=12,
                        max_len=16)
    eng = PagedEngine(tcfg, tparams, device="cpu", max_batch=2, page_size=4,
                      n_pages=12, max_len=16)
    eng.warmup_windows()
    for i, p in enumerate(prompts):
        eng.submit(p, 5, rid=f"r{i}")
    assert {r.rid: r.tokens for r in eng.run()} == base
    serve.main(["--tiny", "--device", "cpu", "--engine", "paged",
                "--requests", "3", "--prompt-len", "8", "--gen", "4",
                "--batch", "2"])
    assert "[paged] cpu: served 3 requests, 12 tokens" in \
        capsys.readouterr().out


@pytest.mark.parametrize("flag", ["trace", "fault_plan"])
def test_engine_rejects_unported_features(tiny, flag):
    """The fault plane and tracing are ported: the engine takes them and
    serves; only mesh-striped pools still raise."""
    _, _, tcfg, tparams = tiny
    kw = dict(trace=True) if flag == "trace" else dict(
        fault_plan=FaultPlan([FaultEvent(1, "fail", 1),
                              FaultEvent(3, "join", 1)]), n_nodes=2)
    eng = PagedEngine(tcfg, tparams, device="cpu", max_batch=2, page_size=4,
                      n_pages=16, max_len=16, **kw)
    for i, p in enumerate(seeded_prompts(tcfg, 2, 8)):
        eng.submit(p, 5, rid=f"r{i}")
    assert len(eng.run()) == 2
    assert (eng.tracer is not None) == (flag == "trace")
    assert (eng.faults is not None) == (flag == "fault_plan")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PagedEngine(tcfg, tparams, device="cpu", mesh=object(), **kw)


@pytest.mark.parametrize("argv", [["--layout", "auto"],
                                  ["--engine", "paged", "--fault-plan",
                                   "chaos"],
                                  ["--engine", "dense", "--model", "2"],
                                  ["--devices", "4"],
                                  ["--prompt-len", "0"],
                                  ["--data", "2"]])
def test_serve_cli_rejects_unported_flags_with_exit_2(argv, capsys):
    """Flags that need a device mesh, a chaos plan on a 1-node pool (node
    0 never fails, as in the reference) and an empty prompt exit 2."""
    with pytest.raises(SystemExit) as e:
        serve.main(["--tiny", "--device", "cpu"] + argv)
    assert e.value.code == 2
    assert argv[-2] in capsys.readouterr().err


CHAOS_ARGV = ["--tiny", "--engine", "paged", "--model", "3", "--fault-plan",
              "chaos", "--requests", "6", "--prompt-len", "16", "--gen", "12",
              "--batch", "3"]


def _keys(snap):
    return {k: sorted(v) for k, v in snap.items()}


def test_serve_cli_chaos_trace_and_metrics_match_reference(tmp_path, capsys,
                                                           monkeypatch):
    """``--model 3 --fault-plan chaos --trace-out T --metrics-out M``: the
    fault-plane line, the trace rollup and the nOS fleet view print, the
    Chrome trace validates, and the registry snapshot has the reference
    CLI's keys on the same arguments."""
    import json
    from repro.launch import serve as jserve
    from repro_torch.serving.telemetry import validate_chrome_trace
    trace, metrics = tmp_path / "t.json", tmp_path / "m.json"
    serve.main(CHAOS_ARGV + ["--device", "cpu", "--trace-out", str(trace),
                             "--metrics-out", str(metrics)])
    out = capsys.readouterr().out
    for line in ("[paged] fault plane: ", "[trace] per-phase model error",
                 "[trace] wrote ", "[metrics] wrote registry snapshot",
                 "[nOS] fleet serving view", "[nOS] predicted-vs-measured"):
        assert line in out, line
    assert " 0 stale reads" in out
    assert validate_chrome_trace(json.loads(trace.read_text())) == []
    ref_metrics = tmp_path / "ref_m.json"
    monkeypatch.setattr("sys.argv", ["serve"] + CHAOS_ARGV + [
        "--trace-out", str(tmp_path / "ref_t.json"),
        "--metrics-out", str(ref_metrics)])
    jserve.main()
    mine, ref = (json.loads(f.read_text()) for f in (metrics, ref_metrics))
    assert _keys(mine) == _keys(ref)
    assert mine["counters"]["node_failures"] >= 2
