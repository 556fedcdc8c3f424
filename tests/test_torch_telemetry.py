"""The port's step tracing and nOS against the JAX reference on the CPU.

* the engine cases of ``tests/test_telemetry.py`` (tracing leaves the
  tokens unchanged, the trace reconstructs every request's lifecycle and
  the per-phase attribution, ``reset_metrics`` zeroes the registry, its
  digests and the tracer, the quarantine invariant dumps the flight
  recorder before it raises, an untraced engine never prices a span,
  the registry snapshot is JSON) run against the port's
  ``PagedEngine(device="cpu")`` at float32 activations;
* span parity: on the flag cube's trace, at points without faults and
  at chaos points, the port's dispatch and lifecycle spans equal the
  reference engine's in order, name, kind, lane, steps, predicted
  seconds and joules and extra arguments (all but ``measured_s``, a host
  time), its per-node occupancy samples equal the reference's, and its
  Chrome export validates;
* the port's ``NOS`` (a copy of ``repro/core/nos.py``) prints the
  reference's serving, attribution and placement tables and reports its
  power and energy on the same inputs.

Tokens, spans and tables are compared exactly.
"""
import glob
import json
import os

import pytest

from conftest import dense_oracle, seeded_prompts
from repro.configs import get_config as jget_config
from repro.configs.base import ShapeConfig as JShape
from repro.core import nos as jnos
from repro.serving import PagedEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import nos
from repro_torch.serving.engine import PagedEngine
from repro_torch.serving.telemetry import validate_chrome_trace
from test_torch_chaos_cube import chaos_replay
from test_torch_flag_cube import _models, _replay

GEN = 6


def _engine(**kw):
    """``conftest.make_engine``'s defaults, on the port at fp32."""
    _, _, tcfg, tparams = _models("float32")
    defaults = dict(max_batch=3, page_size=4, n_pages=48, max_len=32)
    defaults.update(kw)
    return PagedEngine(tcfg, tparams, device="cpu", **defaults)


def _run_traced(**kw):
    cfg, _, _, _ = _models("float32")
    eng = _engine(trace=True, **kw)
    for i, p in enumerate(seeded_prompts(cfg, 4, 8)):
        eng.submit(p, GEN, rid=f"r{i}")
    fin = eng.run()
    return eng, {r.rid: list(r.tokens) for r in fin}


def test_tracing_does_not_change_tokens():
    cfg, params, _, _ = _models("float32")
    prompts = seeded_prompts(cfg, 4, 8)
    eng_off = _engine()
    for i, p in enumerate(prompts):
        eng_off.submit(p, GEN, rid=f"r{i}")
    off = {r.rid: list(r.tokens) for r in eng_off.run()}
    _, on = _run_traced()
    assert on == off == dense_oracle(cfg, params, prompts, GEN, 32)


def test_engine_trace_reconstructs_lifecycle_and_attribution():
    eng, _ = _run_traced()
    eng.tracer.finalize(eng.sched.step_idx)
    doc = eng.tracer.chrome_trace()
    assert validate_chrome_trace(doc) == []
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    states = {e["name"] for e in spans if e["cat"] in ("request", "marker")}
    assert {"queued", "prefilling", "running", "finished"} <= states
    dispatch = [e for e in spans if e["cat"] == "dispatch"]
    assert {e["name"] for e in dispatch} >= {"prefill", "scan"}
    for e in dispatch:
        assert e["args"]["predicted_s"] > 0.0
        assert e["args"]["predicted_j"] > 0.0
        assert e["args"]["measured_s"] >= 0.0
    assert any(e.get("ph") == "C" for e in doc["traceEvents"])
    assert {"prefill", "scan"} <= set(eng.tracer.model_error_report())


def test_reset_metrics_zeroes_registry_digests_and_tracer():
    eng, _ = _run_traced()
    assert eng.steps_run > 0 and eng.tokens_emitted > 0
    assert eng.tracer.recorded > 0
    eng.registry.observe("recovery_steps", 5.0)
    eng.sched.recovery_steps.append(5)
    eng.reset_metrics()
    assert all(v == 0 for v in eng.registry.counters.values())
    assert eng.steps_run == 0 and eng.tokens_emitted == 0
    assert eng.tracer.recorded == 0 and not eng.tracer.spans
    assert not eng.tracer.open_spans
    assert eng.registry.hists["recovery_steps"].count == 0
    assert not eng.sched.recovery_steps and not eng.sched.shed
    assert eng.metrics()["recovery_steps_p99"] == 0.0
    # live gauge callables keep reporting pool truth through a reset
    assert eng.registry.gauge("free_pages") > 0


def test_quarantine_invariant_dumps_flight_recorder(tmp_path):
    cfg, _, _, _ = _models("float32")
    eng = _engine(n_nodes=2, trace=True)
    eng.tracer.dump_dir = str(tmp_path)
    eng.submit(seeded_prompts(cfg, 1, 8)[0], GEN, rid="victim")
    eng.step()                                  # prefill: victim holds pages
    held = next(iter(eng.alloc.held["victim"]))
    eng.alloc.quarantined.add(held)             # corrupt: fake a stale page
    with pytest.raises(RuntimeError, match="quarantined"):
        eng._assert_no_quarantined()
    assert eng.quarantined_served == 1
    dumps = glob.glob(os.path.join(str(tmp_path), "flight-*.json"))
    assert len(dumps) == 1
    doc = json.load(open(dumps[0]))
    assert doc["reason"] == "quarantined-served"
    assert doc["spans"]
    assert doc["metrics"]["counters"]["quarantined_served"] == 1


def test_untraced_engine_pays_no_tracer_and_skips_dump():
    eng = _engine()
    assert eng.tracer is None
    assert eng._flight_dump("whatever") is None
    # the span fast path never calls the pricing function
    with eng._span("scan", lambda: 1 / 0):
        pass


def test_registry_snapshot_is_json_serializable():
    eng, _ = _run_traced()
    rt = json.loads(json.dumps(eng.registry.snapshot()))
    assert rt["counters"]["steps_run"] == eng.steps_run
    assert "pages_in_use" in rt["gauges"]


# --- span parity with the reference engine ----------------------------------
def _spans(eng):
    """Every span but its host times, and the occupancy samples."""
    eng.tracer.finalize(eng.sched.step_idx)
    assert eng.tracer.dropped == 0
    spans = [(s.name, s.cat, s.group, s.track, s.start_step, s.end_step,
              {k: v for k, v in s.args.items() if k != "measured_s"})
             for s in eng.tracer.spans]
    return spans, [(step, vals) for step, _, vals in eng.tracer.samples]


# (prefix cache, fused, spec decode, chunked prefill), without and with
# the chaos plan on the 3-node pool
SPAN_POINTS = [((False, True, False, False), False),
               ((True, True, True, True), False),
               ((False, True, False, False), True),
               ((True, False, True, True), True)]


@pytest.mark.parametrize("point,chaos", SPAN_POINTS,
                         ids=["plain", "features", "chaos",
                              "chaos-features"])
def test_spans_equal_the_reference_engines(point, chaos):
    cfg, params, tcfg, tparams = _models("float32")
    runs = []
    for engine_cls, c, p, kw in ((PagedEngine, tcfg, tparams,
                                  dict(device="cpu")),
                                 (JEngine, cfg, params, {})):
        if chaos:
            eng, toks = chaos_replay(engine_cls, c, p, point, trace=True,
                                     **kw)
        else:
            pc, fz, sp, ck = point
            eng, toks = _replay(engine_cls, c, p, (pc, fz, sp, False, ck),
                                trace=True, **kw)
        runs.append((eng, toks))
    (eng, toks), (ref, ref_toks) = runs
    assert toks == ref_toks
    spans, samples = _spans(eng)
    ref_spans, ref_samples = _spans(ref)
    assert spans == ref_spans
    assert samples == ref_samples
    names = {s[0] for s in spans if s[1] == "dispatch"}
    assert {"prefill" if not point[3] else "chunk_prefill", "scan"} <= names
    if point[2]:
        assert "draft_verify" in names
    if chaos:
        assert eng.metrics()["requests_recovered"] >= 1
    assert validate_chrome_trace(eng.tracer.chrome_trace()) == []


# --- nOS ----------------------------------------------------------------------
def _drive_nos(nos_mod, get_cfg, shape_cls, mode):
    """A costed serving job, two row jobs, a row failure and its
    re-join, a finished job and the serving telemetry of a traced run;
    returns everything the pod prints or reports."""
    pod = nos_mod.NOS(data_rows=8, model_cols=4)
    out = [pod.submit(get_cfg("qwen3-1.7b"), name="serve",
                      shape=shape_cls("serve", 576, 8, "decode"), steps=40,
                      mode=mode, max_rows=2)]
    out.append(pod.submit(nos_mod.Job("batch", rows_needed=4)))
    out.append(pod.submit(nos_mod.Job("late", rows_needed=4)))
    out.append(pod.fail_rows([5]))
    out.append(pod.restore_rows([5]))
    pod.finish("batch")
    est = pod.jobs["serve"].estimate
    report = {"prefill": dict(count=16, predicted_s=0.013, measured_s=0.67,
                              predicted_j=1.5, err_ratio=51.5,
                              comms_s=0.0),
              "scan": dict(count=20, predicted_s=0.18, measured_s=0.9,
                           predicted_j=11.0, err_ratio=5.0, comms_s=0.0)}
    pod.update_serving(
        "serve", pages_held=12, peak_pages=288, tokens_out=1024,
        queue_latency_s=3.5 * est.step_time_s, preemptions=2,
        energy_j=40 * est.energy.total_j * est.layout.n_chips,
        shared_pages=None, prefix_hit_rate=None, bytes_deduped=None,
        accept_rate=None, dispatches_per_token=0.15, spec_k=None,
        ttft_p99_s=9.0 * est.step_time_s, ttft_target_s=8 * est.step_time_s,
        goodput_frac=0.75, pages_quarantined=145, requests_recovered=5,
        tokens_recomputed=210, recovery_steps_p99=7.5,
        predicted_s=0.193, measured_s=1.57, predicted_j=12.5,
        model_error=report)
    out += [pod.serving_table(), pod.attribution_table(),
            pod.placement_table(), pod.power_estimate_w(),
            pod.energy_account(), pod.utilisation(),
            (est.step_time_s, est.energy.total_j, est.layout.n_chips)]
    return out


@pytest.mark.parametrize("mode", ["circuit", "packet"])
def test_nos_tables_equal_the_reference(mode):
    mine = _drive_nos(nos, get_config, ShapeConfig, mode)
    ref = _drive_nos(jnos, jget_config, JShape, mode)
    assert mine == ref
    assert "serve" in mine[-7] and "prefill" in mine[-6]
