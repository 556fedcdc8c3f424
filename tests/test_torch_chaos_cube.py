"""The port's paged engine on the chaos rung of the reference's oracle
ladder, at float32 activations (bfloat16 in
``test_torch_chaos_cube_bf16.py``, on a worker of its own).

``tests/test_serving_fuzz.py``'s chaos axis, replayed through the port's
``PagedEngine(device="cpu")``: the flag cube's trace (copied in
``test_torch_flag_cube.py``) on a 3-node striped pool under the
reference's pinned fault plan (a transient-rejection burst, a straggler
window, two node failures with their re-joins; copied here, not
imported), at the 16 points of {prefix-cache} x {fused} x {spec-decode}
x {chunked prefill}.  At every point the port emits the dense oracle's
tokens and the reference engine's, its metric keys equal the reference
engine's, its fault counters and the flag cube's counters equal the
reference engine's values, and the reference's engagement asserts hold.
Tokens and counters are compared exactly.  The oracle and the reference
engine's runs are memoized per process.
"""
import pytest

from repro.serving import FaultEvent as JEvent, FaultPlan as JPlan
from repro.serving import PagedEngine as JEngine
from repro_torch.serving.engine import PagedEngine
from repro_torch.serving.faults import FaultEvent, FaultPlan
from test_torch_flag_cube import COUNTERS, _MEMO, _models, _oracle, _replay

CHAOS_CUBE = [(pc, fz, sp, ck)
              for pc in (False, True) for fz in (False, True)
              for sp in (False, True) for ck in (False, True)]
FAULT_KEYS = ("node_failures", "node_joins", "pages_quarantined",
              "pages_quarantined_now", "requests_recovered",
              "requests_shed", "tokens_recomputed", "transient_rejections",
              "quarantined_served", "recovery_steps_p50",
              "recovery_steps_p99")
# the pinned plan of test_serving_fuzz._chaos_plan
CHAOS_EVENTS = ((2, "transient", -1, 2), (3, "slow", 2, 1, 4, 4.0),
                (4, "fail", 1), (10, "join", 1), (14, "fail", 2),
                (20, "join", 2))


def chaos_plan(event_cls, plan_cls):
    return plan_cls([event_cls(*e) for e in CHAOS_EVENTS])


def chaos_replay(engine_cls, cfg, params, point, **kw):
    """``_replay`` on the 3-node pool with the pinned plan armed."""
    prefix_cache, fused, spec, chunked = point
    plan = chaos_plan(*((JEvent, JPlan) if engine_cls is JEngine
                        else (FaultEvent, FaultPlan)))
    return _replay(engine_cls, cfg, params,
                   (prefix_cache, fused, spec, False, chunked), n_nodes=3,
                   fault_plan=plan, **kw)


def _reference(dtype, point):
    key = ("chaos", dtype, point)
    if key not in _MEMO:
        cfg, params, _, _ = _models(dtype)
        eng, toks = chaos_replay(JEngine, cfg, params, point)
        _MEMO[key] = (toks, eng.metrics())
    return _MEMO[key]


def check_chaos_point(point, dtype):
    _, _, tcfg, tparams = _models(dtype)
    eng, toks = chaos_replay(PagedEngine, tcfg, tparams, point,
                             device="cpu")
    ref_toks, ref_m = _reference(dtype, point)
    assert toks.keys() == _oracle(dtype).keys(), "a request was shed or lost"
    assert toks == _oracle(dtype) == ref_toks, point
    m = eng.metrics()
    assert set(m) == set(ref_m)
    keys = FAULT_KEYS + COUNTERS
    assert {k: m.get(k) for k in keys} == {k: ref_m.get(k) for k in keys}, \
        point
    # the reference's engagement asserts
    assert m["node_failures"] >= 2, "the watchdog missed a failure"
    assert m["requests_recovered"] >= 1, "no live request was hit"
    assert m["quarantined_served"] == 0
    assert m["transient_rejections"] >= 1
    assert eng.sched.conserved(eng._n_submitted)


@pytest.mark.parametrize("prefix_cache,fused,spec,chunked", CHAOS_CUBE)
def test_chaos_cube_matches_dense_oracle_and_reference(prefix_cache, fused,
                                                       spec, chunked):
    check_chaos_point((prefix_cache, fused, spec, chunked), "float32")
