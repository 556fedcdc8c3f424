"""The port's fault plane against the JAX reference on the CPU.

* ``FaultPlan.seeded`` draws the reference's events for a range of seeds,
  pool sizes and horizons;
* ``FaultPlane``, driven on ``tests/test_faults.py``'s fake engine, makes
  the reference plane's fail/join transitions at the same steps and
  spends the same transient budget;
* the page allocator's quarantine lifecycle (``fail_node`` /
  ``restore_node``) makes the reference's decisions on seeded op
  sequences;
* the port's ``PagedEngine(device="cpu")`` at float32 activations, with
  a manual mid-stream fail and re-join (``tests/test_faults.py``'s
  engine case), emits the dense oracle's and the reference engine's
  tokens with the reference engine's fault and transfer counters;
* the host guards: ``_block_row`` raises and counts on a quarantined
  page, and no dispatch after a failure reads a block table that names
  a quarantined page (the device copy is rewritten before the next
  dispatch; the speculative history row is pushed again);
* with faults installed and the tracer armed, a dropped engine is freed
  without the cycle collector.

Tokens are compared exactly; counters exactly.
"""
import dataclasses
import gc
import glob
import os
import weakref

import numpy as np
import pytest

from conftest import dense_oracle, seeded_prompts
from repro.serving import FaultEvent as JEvent, FaultPlan as JPlan
from repro.serving import FaultPlane as JPlane, PageAllocator as JAlloc
from repro.serving import PagedEngine as JEngine
from repro_torch.serving.engine import PagedEngine
from repro_torch.serving.faults import FaultEvent, FaultPlan, FaultPlane
from repro_torch.serving.paged_kv import PageAllocator
from test_torch_chaos_cube import FAULT_KEYS
from test_torch_flag_cube import _models

COUNTERS = ("steps", "windows", "preemptions", "peak_pages", "h2d_syncs",
            "d2h_syncs", "tokens_out", "block_row_writes", "model_passes",
            "prefill_tokens")


def _events(plan):
    return [dataclasses.astuple(e) for e in plan.events]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("n_nodes,horizon", [(2, 16), (3, 48), (4, 40),
                                             (6, 120)])
def test_seeded_plan_matches_reference(seed, n_nodes, horizon):
    mine = FaultPlan.seeded(seed, n_nodes=n_nodes, horizon=horizon)
    ref = JPlan.seeded(seed, n_nodes=n_nodes, horizon=horizon)
    assert _events(mine) == _events(ref)
    assert mine.horizon == ref.horizon
    assert mine.n_node_failures == ref.n_node_failures == 2


class _FakeEngine:
    """``tests/test_faults.py``'s fake: a step clock and the recorded
    fail/join transitions."""

    def __init__(self):
        class _S:
            step_idx = 0
        self.sched = _S()
        self.failed = []
        self.joined = []

    def fail_node(self, node):
        self.failed.append((self.sched.step_idx, node))

    def join_node(self, node):
        self.joined.append((self.sched.step_idx, node))


PLANS = {
    "kill": [(2, "fail", 1), (8, "join", 1)],
    "straggler": [(1, "slow", 2, 1, 6, 4.0)],
    "chaos": [(2, "transient", -1, 2), (3, "slow", 2, 1, 4, 4.0),
              (4, "fail", 1), (10, "join", 1), (14, "fail", 2),
              (20, "join", 2)],
    "overlap": [(1, "fail", 1), (2, "slow", 2, 1, 9, 2.0), (3, "fail", 2),
                (5, "transient", -1, 3), (9, "join", 2), (12, "join", 1)],
}


@pytest.mark.parametrize("name", sorted(PLANS) + ["seeded"])
def test_watchdog_transitions_match_reference(name):
    """Both planes, each on its own fake engine, over 40 steps with an
    epoch of 5: the same fail/join steps, the same transient verdicts
    at every step and the same summary."""
    planes = []
    for ev_cls, plan_cls, plane_cls in ((FaultEvent, FaultPlan, FaultPlane),
                                        (JEvent, JPlan, JPlane)):
        if name == "seeded":
            plan = plan_cls.seeded(3, n_nodes=3, horizon=30)
        else:
            plan = plan_cls([ev_cls(*e) for e in PLANS[name]])
        planes.append((plane_cls(plan, n_nodes=3, epoch=5), _FakeEngine()))
    seen = []
    for plane, eng in planes:
        gates = []
        for s in range(40):
            eng.sched.step_idx = s
            plane.on_step(eng)
            gates.append(plane.transient_gate(None, s))
        seen.append((eng.failed, eng.joined, gates, plane.summary()))
    assert seen[0] == seen[1]
    assert seen[0][0], "the plan never failed a node"


def _alloc_state(a):
    return (sorted(a.held.items()), sorted(a.refcount.items()),
            [list(f) for f in a._free_by_node], sorted(a.quarantined),
            sorted(a.failed_nodes))


def _fault_op(a, op):
    """One allocator op, fault ops included (fail/restore a node)."""
    code, r, n = op
    rid = f"r{r}"
    held = a.held.get(rid)
    if code == 0 and held is None:
        return a.alloc(rid, n % 4 + 1)
    if code == 1 and held is not None:
        return a.grow(rid, n % 2 + 1)
    if code == 2 and held is not None:
        return a.free(rid)
    if code == 3:
        return sorted(a.fail_node(1 + n % 2))
    if code == 4:
        return a.restore_node(1 + n % 2)
    return None


@pytest.mark.parametrize("seed", range(4))
def test_allocator_quarantine_decisions_match_reference(seed):
    rng = np.random.default_rng(100 + seed)
    ops = [tuple(int(v) for v in rng.integers(0, (5, 4, 10)))
           for _ in range(80)]
    mine, ref = PageAllocator(19, 4, n_nodes=3), JAlloc(19, 4, n_nodes=3)
    for op in ops:
        assert _fault_op(mine, op) == _fault_op(ref, op), op
        assert _alloc_state(mine) == _alloc_state(ref), op
        assert mine.allocatable_pages == ref.allocatable_pages
        assert mine.check_conservation()


def _manual_fail_join(engine_cls, cfg, params, prompts, gens, before,
                      **kw):
    """``tests/test_faults.py``'s manual mid-stream fail/join, the node
    failing after ``before`` steps."""
    max_len = max(p.shape[0] + g for p, g in zip(prompts, gens))
    eng = engine_cls(cfg, params, max_batch=4, page_size=4, n_pages=31,
                     max_len=max_len, n_nodes=3, **kw)
    for i, (p, g) in enumerate(zip(prompts, gens)):
        eng.submit(np.asarray(p), g, rid=f"r{i}")
    for _ in range(before):
        eng.step()
    quar = eng.fail_node(1)
    assert quar and eng.alloc.check_conservation()
    eng.step()
    assert eng.alloc.check_conservation()
    rejoined = eng.join_node(1)
    eng.run()
    toks = {r.rid: list(r.tokens) for r in eng.sched.finished}
    return eng, toks, sorted(quar), rejoined


# (features, steps before the failure): with all three features on the
# speculated loops finish every request by step 4, so the node fails
# earlier there
@pytest.mark.parametrize("features,before", [
    ({}, 4), (dict(fused=False), 4),
    (dict(prefix_cache=True, spec_decode=True, spec_k="auto",
          chunked_prefill=True), 2)], ids=["fused", "per-step", "features"])
def test_engine_manual_fail_join_matches_reference(features, before):
    cfg, params, tcfg, tparams = _models("float32")
    prompts = seeded_prompts(cfg, 4, 12, seed=11)
    gens = [8, 6, 7, 5]
    max_len = max(p.shape[0] + g for p, g in zip(prompts, gens))
    dense = dense_oracle(cfg, params, prompts, gens, max_len)
    eng, toks, quar, rejoined = _manual_fail_join(
        PagedEngine, tcfg, tparams, prompts, gens, before, device="cpu",
        **features)
    ref, ref_toks, ref_quar, ref_rejoined = _manual_fail_join(
        JEngine, cfg, params, prompts, gens, before, **features)
    assert toks == dense == ref_toks
    assert (quar, rejoined) == (ref_quar, ref_rejoined)
    m, ref_m = eng.metrics(), ref.metrics()
    keys = FAULT_KEYS + COUNTERS
    assert {k: m[k] for k in keys} == {k: ref_m[k] for k in keys}
    assert set(m) == set(ref_m)
    assert m["node_failures"] == m["node_joins"] == 1
    assert m["requests_recovered"] >= 1 and m["tokens_recomputed"] >= 1
    assert m["pages_quarantined"] == len(quar)
    assert m["pages_quarantined_now"] == m["quarantined_served"] == 0
    assert eng.sched.conserved(eng._n_submitted)
    if not features.get("prefix_cache"):
        assert eng.alloc.pages_in_use == 0


def test_block_row_guard_raises_counts_and_dumps(tmp_path):
    _, _, tcfg, tparams = _models("float32")
    eng = PagedEngine(tcfg, tparams, device="cpu", max_batch=2, page_size=4,
                      n_pages=24, max_len=24, n_nodes=2, trace=True)
    eng.tracer.dump_dir = str(tmp_path)
    eng.submit(seeded_prompts(tcfg, 1, 8)[0], 6, rid="victim")
    eng.step()
    page = eng.alloc.held["victim"][0]
    eng.alloc.quarantined.add(page)             # corrupt: a stale page
    with pytest.raises(RuntimeError, match="quarantined"):
        eng._block_row("victim")
    assert eng.quarantined_served == 1
    assert eng.metrics()["quarantined_served"] == 1
    dumps = glob.glob(os.path.join(str(tmp_path), "flight-*.json"))
    assert [os.path.basename(d).split("-")[1:3] for d in dumps] == \
        [["stale", "block"]]
    # untraced: the guard still raises, without a dump
    eng.tracer = None
    with pytest.raises(RuntimeError, match="quarantined"):
        eng._block_row("victim")
    assert eng.quarantined_served == 2


_DISPATCHES = ("_prefill", "_serve", "_scan", "_suffix", "_chunk",
               "_verify", "_spec_step")


@pytest.mark.parametrize("features", [
    {}, dict(fused=False), dict(spec_decode=True, spec_k=4),
    dict(spec_decode=True, spec_k=4, spec_proposer="host"),
    dict(chunked_prefill=True, chunk_tokens=4, prefix_cache=True)],
    ids=["fused", "per-step", "spec-device", "spec-host", "chunk-cache"])
def test_no_dispatch_reads_a_quarantined_page(features):
    """Fail a node mid-stream, then record the block table every later
    dispatch reads while pages are quarantined: no row names one.  The
    reset victims' slots are rewritten before the next dispatch, and with
    speculation on their history rows are pushed again under the new
    ``(rid, preemptions)`` key.  Tokens stay the dense oracle's."""
    cfg, params, tcfg, tparams = _models("float32")
    prompts = seeded_prompts(cfg, 4, 12, motif=4, seed=5)
    gens = [9, 7, 8, 6]
    max_len = 12 + max(gens)
    dense = dense_oracle(cfg, params, prompts, gens, max_len)
    eng = PagedEngine(tcfg, tparams, device="cpu", max_batch=3, page_size=4,
                      n_pages=31, max_len=max_len, n_nodes=3, max_window=4,
                      **features)
    tables = []

    def spy(name, fn):
        def wrapped(*args, **kw):
            if eng.alloc.quarantined:
                for a in args:
                    if hasattr(a, "dtype") and str(a.dtype) == "torch.int32" \
                            and a.dim() in (1, 2) and a.shape[-1] == eng.nmax:
                        tables.append((name, a.cpu().numpy().copy()))
            return fn(*args, **kw)
        return wrapped

    for name in _DISPATCHES:
        setattr(eng, name, spy(name, getattr(eng, name)))
    for i, (p, g) in enumerate(zip(prompts, gens)):
        eng.submit(np.asarray(p), g, rid=f"r{i}")
    for _ in range(3):
        eng.step()
    victims = [r for r in list(eng.sched.running.values())
               + list(eng.sched.prefilling.values())
               if any(eng.alloc.owner(p) == 1
                      for p in eng.alloc.held[r.rid])]
    assert victims, "no live request held a page of node 1"
    quar = eng.fail_node(1)
    assert quar and all(r.preemptions >= 1 for r in victims)
    for _ in range(4):
        eng.step()
    assert tables, "no dispatch ran while the node was down"
    for name, t in tables:
        assert not quar & set(t.ravel().tolist()), name
    if features.get("spec_decode") and features.get("spec_proposer") != \
            "host":
        keys = {st[0] for st in eng._hist_state if st is not None}
        live = {(r.rid, r.preemptions) for r in eng.sched.running.values()}
        assert keys <= live
    eng.join_node(1)
    eng.run()
    assert {r.rid: list(r.tokens) for r in eng.sched.finished} == dense
    assert eng.metrics()["quarantined_served"] == 0


def test_engine_with_faults_and_tracer_freed_without_cycle_collector():
    """The plane holds the engine's registry, not the engine, and the
    scheduler's transient gate is the plane's method: a dropped engine
    still frees its pools when its last reference goes."""
    _, _, tcfg, tparams = _models("float32")
    plan = FaultPlan([FaultEvent(1, "transient", count=1),
                      FaultEvent(2, "fail", 1), FaultEvent(5, "join", 1)])
    eng = PagedEngine(tcfg, tparams, device="cpu", max_batch=2, page_size=4,
                      n_pages=25, max_len=24, n_nodes=3, fault_plan=plan,
                      trace=True, prefix_cache=True, spec_decode=True,
                      chunked_prefill=True)
    for i, p in enumerate(seeded_prompts(tcfg, 3, 10, shared=6)):
        eng.submit(p, 5, rid=f"r{i}")
    eng.run()
    assert eng.metrics()["node_failures"] >= 1 and eng.tracer.recorded
    gone, block = weakref.ref(eng), weakref.ref(eng.d_block)
    gc.disable()
    try:
        del eng
        assert gone() is None and block() is None
    finally:
        gc.enable()
