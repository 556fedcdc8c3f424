"""The port's paged engine across the reference's serving flag cube.

The trace of ``tests/test_serving_fuzz.py`` (copied, not imported:
shared prefixes that diverge mid-page, motif-tiled prompts whose greedy
continuations loop, staggered arrivals, a pool small enough for growth
pressure) is replayed through the port's ``PagedEngine(device="cpu")``
at all 32 points of {prefix-cache} x {fused} x {spec-decode} x
{adaptive K} x {chunked prefill}, at float32 activations (the parity
harness's dtype) here and at bfloat16 (the reference cube's own dtype)
in ``test_torch_flag_cube_bf16.py``.
At every point the port emits the reference's dense-oracle tokens, and
its feature counters equal the reference ``PagedEngine``'s on the same
point: the corner where the reference verifies twice and accepts
nothing included.  The oracle and the reference engine's runs are
memoized per process.
"""
import jax
import numpy as np
import pytest

from conftest import dense_oracle, get_tiny_model, seeded_prompts
from repro.serving import PagedEngine as JEngine
from repro_torch.configs import get_tiny_config
from repro_torch.serving.engine import PagedEngine
from repro_torch.weights import from_reference

PAGE = 4
MAX_BATCH = 2
N_PAGES = 26
CUBE = [(pc, fz, sp, ak, ck)
        for pc in (False, True) for fz in (False, True)
        for sp in (False, True) for ak in (False, True)
        for ck in (False, True)]
COUNTERS = ("prefix_hits", "cow_copies", "spec_verifies", "spec_drafted",
            "spec_accepted", "spec_rollbacks", "accept_rate", "spec_k_mean",
            "chunk_dispatches", "chunk_tasks", "model_passes", "h2d_syncs",
            "d2h_syncs", "steps", "windows", "prefill_tokens")

_MEMO = {}


def _models(dtype):
    """(reference cfg, reference params, port cfg, port params)."""
    if dtype not in _MEMO:
        cfg, params = get_tiny_model()
        cfg = cfg.replace(activation_dtype=dtype)
        tcfg = get_tiny_config("tiny-100m").replace(activation_dtype=dtype)
        tparams = from_reference(jax.tree.map(np.asarray, params), tcfg,
                                 "cpu")
        _MEMO[dtype] = (cfg, params, tcfg, tparams)
    return _MEMO[dtype]


def _trace():
    """(prompts, gens, arrival steps): ``test_serving_fuzz._trace``."""
    cfg, _ = get_tiny_model()
    shared = seeded_prompts(cfg, 2, 12, shared=9, seed=21)   # mid-page COW
    loops = seeded_prompts(cfg, 2, 12, motif=4, seed=33)     # spec fodder
    plain = seeded_prompts(cfg, 2, 12, seed=45)
    prompts = [shared[0], loops[0], plain[0], shared[1], loops[1],
               plain[1]]
    gens = [6, 9, 4, 7, 8, 5]
    arrivals = [0, 0, 1, 3, 5, 9]
    return prompts, gens, arrivals


def _replay(engine_cls, cfg, params, point, **kw):
    """Drive the engine like the trace benchmark: submissions land when
    the scheduler clock reaches their arrival step, windows never decode
    past the next arrival."""
    prefix_cache, fused, spec, adaptive, chunked = point
    prompts, gens, arrivals = _trace()
    max_len = max(p.shape[0] + g for p, g in zip(prompts, gens))
    eng = engine_cls(cfg, params, max_batch=MAX_BATCH, page_size=PAGE,
                     n_pages=N_PAGES, max_len=max_len, fused=fused,
                     prefix_cache=prefix_cache, spec_decode=spec,
                     spec_k="auto" if adaptive else 4, max_window=4,
                     chunked_prefill=chunked, **kw)
    pending = sorted(zip(arrivals, range(len(prompts))))
    while pending or eng.sched.waiting or eng.sched.prefilling \
            or eng.sched.running:
        while pending and pending[0][0] <= eng.sched.step_idx:
            _, i = pending.pop(0)
            eng.submit(np.asarray(prompts[i]), gens[i], rid=f"r{i}",
                       slo="interactive" if i % 2 else "batch")
        if eng.sched.waiting or eng.sched.prefilling or eng.sched.running:
            cap = pending[0][0] - eng.sched.step_idx if pending else None
            eng.step(max_window=cap)
        else:
            eng.sched.step_idx += 1
    assert eng.alloc.check_conservation()
    if eng.cache is None:
        assert eng.alloc.pages_in_use == 0
    return eng, {r.rid: list(r.tokens) for r in eng.sched.finished}


def _oracle(dtype):
    key = ("oracle", dtype)
    if key not in _MEMO:
        cfg, params, _, _ = _models(dtype)
        prompts, gens, _ = _trace()
        max_len = max(p.shape[0] + g for p, g in zip(prompts, gens))
        _MEMO[key] = dense_oracle(cfg, params, prompts, gens, max_len)
    return _MEMO[key]


def _reference(dtype, point):
    key = ("ref", dtype, point)
    if key not in _MEMO:
        cfg, params, _, _ = _models(dtype)
        eng, toks = _replay(JEngine, cfg, params, point)
        _MEMO[key] = (toks, eng.metrics())
    return _MEMO[key]


def check_point(point, dtype):
    """The port at one cube point: the dense oracle's tokens, the
    reference engine's counters and metric keys, each feature engaged."""
    prefix_cache, fused, spec, adaptive, chunked = point
    _, _, tcfg, tparams = _models(dtype)
    eng, toks = _replay(PagedEngine, tcfg, tparams, point, device="cpu")
    ref_toks, ref_m = _reference(dtype, point)
    assert toks == _oracle(dtype) == ref_toks, point
    m = eng.metrics()
    assert {k: m.get(k) for k in COUNTERS} == \
        {k: ref_m.get(k) for k in COUNTERS}, point
    # every metric key of the reference, the fault plane's included
    assert set(m) == set(ref_m)
    # the features engaged on their trigger configs
    if prefix_cache:
        assert m["prefix_hits"] >= 1 and m["cow_copies"] >= 1
    if spec:
        assert m["spec_verifies"] >= 1
        assert eng.spec.adaptive == adaptive
        if adaptive:
            assert m["spec_k_mean"] > 0.0
    else:
        assert eng.spec is None and "accept_rate" not in m
    if chunked:
        assert m["chunk_dispatches"] >= len(toks)
        assert m["chunk_tasks"] >= len(toks)
    else:
        assert not eng.sched.chunked and "chunk_tasks" not in m


def check_corner(dtype):
    """prefix-cache on, fused off, spec on, adaptive K on, chunked on:
    the reference's tokens equal its dense oracle, and it runs 2
    verifies that accept nothing (``accept_rate`` 0.0); the port
    reproduces exactly that."""
    point = (True, False, True, True, True)
    _, _, tcfg, tparams = _models(dtype)
    eng, toks = _replay(PagedEngine, tcfg, tparams, point, device="cpu")
    m = eng.metrics()
    assert toks == _oracle(dtype) == _reference(dtype, point)[0]
    assert (m["spec_verifies"], m["accept_rate"]) == (2, 0.0)
    assert _reference(dtype, point)[1]["accept_rate"] == 0.0


# float32 here; bfloat16 in test_torch_flag_cube_bf16.py, on a worker of
# its own
@pytest.mark.parametrize("prefix_cache,fused,spec,adaptive,chunked", CUBE)
def test_flag_cube_matches_dense_oracle_and_reference(
        prefix_cache, fused, spec, adaptive, chunked):
    check_point((prefix_cache, fused, spec, adaptive, chunked), "float32")


def test_flag_cube_corner_reproduces_the_reference_verdicts():
    check_corner("float32")
