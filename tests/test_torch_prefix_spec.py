"""The port's prefix cache and speculative decoding against the JAX
reference on the CPU.

* proposer: the port's ``device_propose`` (torch ops over a device row)
  is token-identical to the reference's jitted ``device_propose`` and to
  the host ``propose_ngram`` on random junk-padded histories (a
  hypothesis property, template ``tests/test_property_serving.py``) and
  on the reference's named cases; the reference's ``AdaptiveK`` /
  ``NGramSpec`` / ``propose_ngram`` unit cases run against the port's
  copies and the reference's alike;
* engine: the engine cases of ``tests/test_prefix_cache.py`` (forced
  COW, a donated partial tail, preemption and eviction, a preempted
  request recomputed through the cache, the cache off by default) and of
  ``tests/test_spec_decode.py`` (with both ``spec_proposer`` values)
  replayed through the port's ``PagedEngine(device="cpu")`` at float32
  activations: tokens equal to the reference's dense oracle and to the
  reference ``PagedEngine``, COW, refcount, verify, acceptance and
  model-pass counters equal to the reference engine's;
* the serve CLI with every new flag.
"""
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import dense_oracle, get_tiny_model, seeded_prompts
from hypothesis_compat import given, settings, st
from repro.serving import PagedEngine as JEngine
from repro.serving import spec_decode as jspec
from repro_torch.configs import get_tiny_config
from repro_torch.launch import serve
from repro_torch.serving import spec_decode as tspec
from repro_torch.serving.engine import PagedEngine
from repro_torch.serving.spec_decode import device_propose, propose_ngram
from repro_torch.weights import from_reference

SPEC = [tspec, jspec]          # the port's host half, and the reference's
SPEC_IDS = ["port", "reference"]
COUNTERS = ("steps", "windows", "preemptions", "peak_pages", "h2d_syncs",
            "d2h_syncs", "tokens_out", "block_row_writes", "model_passes",
            "prefill_tokens")
CACHE_COUNTERS = ("prefix_hits", "prefix_lookups", "cow_copies",
                  "prefill_tokens_cached", "prefix_evictions",
                  "shared_pages", "bytes_deduped")
SPEC_COUNTERS = ("spec_verifies", "spec_drafted", "spec_accepted",
                 "spec_rollbacks", "accept_rate", "spec_k_mean")

_MODEL = {}


def _model():
    """(reference cfg, reference params, port cfg, port params), fp32."""
    if not _MODEL:
        cfg, params = get_tiny_model()
        cfg = cfg.replace(activation_dtype="float32")
        tcfg = get_tiny_config("tiny-100m").replace(
            activation_dtype="float32")
        tparams = from_reference(jax.tree.map(np.asarray, params), tcfg,
                                 "cpu")
        _MODEL["m"] = (cfg, params, tcfg, tparams)
    return _MODEL["m"]


# --- proposer ---------------------------------------------------------------
def _dev(history, k, *, max_n=3, min_n=1, H=16, k_max=9, pad=()):
    """The port's device proposer over a padded row, as a list."""
    buf = np.zeros((H,), np.int32)
    buf[:len(history)] = history
    buf[len(history):len(history) + len(pad)] = list(pad)[:H - len(history)]
    draft, m = device_propose(torch.tensor(buf),
                              torch.tensor(len(history), dtype=torch.int32),
                              torch.tensor(k, dtype=torch.int32),
                              k_max=k_max, max_n=max_n, min_n=min_n)
    assert draft.shape == (k_max,) and draft.dtype == torch.int32
    assert m.shape == () and m.dtype == torch.int32
    assert all(int(t) == 0 for t in draft[int(m):])   # zero-masked past m
    return [int(t) for t in draft[:int(m)]]


@pytest.mark.parametrize("history,k,kw", [
    ([1, 2, 3, 9, 1, 2, 3, 9], 4, {}),      # period-4 loop
    ([1, 2, 3, 9, 1, 2, 3, 9], 99, {}),     # k clipped at history end
    ([5, 1, 2, 7, 7, 1, 2], 3, {}),         # n=2 earliest match
    ([4, 8, 4], 2, {}),                     # n=1 fallback
    ([], 4, {}),                            # empty history
    ([7], 4, {}),                           # no earlier history
    ([1, 2, 3], 0, {}),                     # k = 0
    ([1, 2, 3], 4, {}),                     # aperiodic: no match
    ([1, 5, 2, 5], 2, {"min_n": 2}),        # min_n refuses unigram
])
def test_device_propose_matches_host_on_reference_cases(history, k, kw):
    want = propose_ngram(history, min(k, 9), max_n=3, **kw)
    assert want == jspec.propose_ngram(history, min(k, 9), max_n=3, **kw)
    assert _dev(history, k, **kw) == want


def test_device_propose_ignores_padding_past_hist_len():
    """Tokens past ``hist_len`` never take part in a match, and a draft
    clipped at the history end does not read on into the padding."""
    assert propose_ngram([1, 2, 3], 4, max_n=3) == []
    assert _dev([1, 2, 3], 4, pad=[2, 3, 9, 9]) == []
    assert propose_ngram([4, 6, 4, 6, 4], 4, max_n=3) == [6, 4]
    assert _dev([4, 6, 4, 6, 4], 4, pad=[6, 4, 6, 4]) == [6, 4]


def test_device_propose_takes_host_ints():
    buf = torch.tensor([1, 2, 3, 9, 1, 2, 3, 9, 0, 0], dtype=torch.int32)
    draft, m = device_propose(buf, 8, 4, k_max=5)
    assert [int(t) for t in draft[:int(m)]] == [1, 2, 3, 9]


@settings(max_examples=100, deadline=None)
@given(st.lists(st.integers(0, 6), min_size=0, max_size=28),
       st.integers(0, 9), st.integers(1, 3),
       st.lists(st.integers(0, 6), min_size=0, max_size=4),
       st.data())
def test_device_propose_matches_reference_and_host(history, k, max_n,
                                                   junk, data):
    """The differential proposer oracle on the port: over a fixed-width,
    junk-padded row (the padding repeats the history's own tail, the
    case a missing validity mask would false-match) the port's
    ``device_propose`` drafts exactly what the reference's jitted
    ``device_propose`` and the host ``propose_ngram`` draft."""
    H, k_max = 32, 9
    min_n = data.draw(st.integers(1, max_n))
    buf = np.zeros((H,), np.int32)
    buf[:len(history)] = history
    pad = junk + list(history[-3:])
    buf[len(history):len(history) + len(pad)] = pad[:H - len(history)]
    fn = jax.jit(jspec.device_propose,
                 static_argnames=("k_max", "max_n", "min_n"))
    dj, mj = fn(jnp.asarray(buf), jnp.int32(len(history)), jnp.int32(k),
                k_max=k_max, max_n=max_n, min_n=min_n)
    dt, mt = device_propose(torch.tensor(buf),
                            torch.tensor(len(history), dtype=torch.int32),
                            torch.tensor(k, dtype=torch.int32), k_max=k_max,
                            max_n=max_n, min_n=min_n)
    assert np.array_equal(np.asarray(dj), dt.numpy())
    assert int(mj) == int(mt)
    ref = propose_ngram(history, min(k, k_max), max_n=max_n, min_n=min_n)
    assert [int(t) for t in dt[:int(mt)]] == ref


# --- host half: the reference's unit cases, on both copies ------------------
@pytest.mark.parametrize("spec", SPEC, ids=SPEC_IDS)
def test_propose_ngram_prefers_longest_ngram_and_earliest_match(spec):
    history = [1, 2, 3, 9, 1, 2, 3, 9]
    assert spec.propose_ngram(history, 4, max_n=3) == [1, 2, 3, 9]
    assert spec.propose_ngram(history, 99, max_n=3) == [1, 2, 3, 9]
    assert spec.propose_ngram([5, 1, 2, 7, 7, 1, 2], 3, max_n=3) == [7, 7, 1]
    assert spec.propose_ngram([4, 8, 4], 2, max_n=3) == [8, 4]


@pytest.mark.parametrize("spec", SPEC, ids=SPEC_IDS)
def test_propose_ngram_empty_cases(spec):
    assert spec.propose_ngram([], 4) == []
    assert spec.propose_ngram([7], 4) == []
    assert spec.propose_ngram([1, 2, 3], 0) == []
    assert spec.propose_ngram([1, 2, 3], 4) == []
    assert spec.propose_ngram([1, 5, 2, 5], 2, max_n=3, min_n=2) == []


@pytest.mark.parametrize("spec", SPEC, ids=SPEC_IDS)
def test_ngram_spec_accept_rule_is_greedy_exact(spec):
    ng = spec.NGramSpec(k=8)
    assert ng.accept([4, 5, 6], [4, 5, 6, 7]) == [4, 5, 6, 7]
    assert ng.accept([4, 9, 6], [4, 5, 6, 7]) == [4, 5]
    assert ng.accept([9], [4, 5]) == [4]
    s = ng.stats
    assert (s.drafted, s.accepted, s.verifies) == (7, 4, 3)
    assert s.accept_rate == pytest.approx(4 / 7)


@pytest.mark.parametrize("spec", SPEC, ids=SPEC_IDS)
def test_adaptive_k_ewma_update_algebra(spec):
    ak = spec.AdaptiveK(alpha=0.5, rate=0.75)
    ak.observe(4, 4)
    assert ak.rate == pytest.approx(0.875)
    ak.observe(4, 0)
    assert ak.rate == pytest.approx(0.4375)
    r = ak.rate
    ak.observe(0, 0)                  # no-draft verify teaches nothing
    assert ak.rate == r
    ak.observe(2, 1)
    assert ak.rate == pytest.approx(r + 0.5 * (0.5 - r))


@pytest.mark.parametrize("spec", SPEC, ids=SPEC_IDS)
def test_adaptive_k_target_is_expected_accept_run_length(spec):
    assert spec.AdaptiveK(rate=0.75).target(k_max=16) == 3
    assert spec.AdaptiveK(rate=0.9).target(k_max=16) == 9
    assert spec.AdaptiveK(rate=0.999).target(k_max=16) == 16
    assert spec.AdaptiveK(rate=1.5).target(k_max=16) == 16
    assert spec.AdaptiveK(rate=0.4).target(k_max=16) == 0


@pytest.mark.parametrize("spec", SPEC, ids=SPEC_IDS)
def test_adaptive_k_collapses_then_probes(spec):
    ak = spec.AdaptiveK(alpha=0.5, rate=0.75, probe_every=3)
    for _ in range(4):
        ak.observe(3, 0)
    assert ak.rate < 0.1
    assert [ak.target(8) for _ in range(7)] == [0, 0, 1, 0, 0, 1, 0]
    ak.observe(1, 1)
    assert ak.target(8) >= 1


@pytest.mark.parametrize("spec", SPEC, ids=SPEC_IDS)
def test_draft_k_clamps_to_horizon_and_pow2_buckets(spec):
    ng = spec.NGramSpec(k=15, adaptive=True)
    assert ng.draft_k("r", horizon=16) == 3
    assert ng.draft_k("r", horizon=3) == 1
    assert ng.draft_k("r", horizon=2) == 1
    assert ng.draft_k("r", horizon=1) == 0
    ng.state("hot").rate = 0.97
    assert ng.draft_k("hot", horizon=16) == 15
    assert ng.draft_k("hot", horizon=9) == 7
    for hz in range(1, 17):
        K = ng.draft_k("hot", horizon=hz)
        if K:
            assert (K + 1) & K == 0 and K + 1 <= hz


@pytest.mark.parametrize("spec", SPEC, ids=SPEC_IDS)
def test_draft_k_sustained_rejection_disables_speculation(spec):
    ng = spec.NGramSpec(k=8, adaptive=True, probe_every=4)
    for _ in range(6):
        ng.observe("r", 4, 0)
    ks = [ng.draft_k("r", horizon=9) for _ in range(8)]
    assert ks.count(0) == 6 and ks.count(1) == 2
    ng.forget("r")
    assert ng.draft_k("r", horizon=9) == 3


# --- engines: the port against the reference engine and dense oracle -------
def _run(engine_cls, cfg, params, prompts, gens, *, proposer=None,
         hook=None, **kw):
    defaults = dict(max_batch=3, page_size=4, n_pages=48,
                    max_len=max(p.shape[0] + g for p, g in zip(prompts,
                                                                gens)))
    defaults.update(kw)
    if proposer is not None:
        defaults["spec_proposer"] = proposer
    if engine_cls is PagedEngine:
        defaults["device"] = "cpu"
    eng = engine_cls(cfg, params, **defaults)
    if hook is not None:
        hook(eng)
    for i, (p, g) in enumerate(zip(prompts, gens)):
        eng.submit(np.asarray(p), g, rid=f"r{i}")
    fin = eng.run()
    return eng, {r.rid: list(r.tokens) for r in fin}


def _both(prompts, gens, **kw):
    """(port engine, its tokens, reference engine's metrics, its tokens)
    on the same trace and arguments."""
    cfg, params, tcfg, tparams = _model()
    eng, toks = _run(PagedEngine, tcfg, tparams, prompts, gens, **kw)
    ref, ref_toks = _run(JEngine, cfg, params, prompts, gens, **kw)
    return eng, toks, ref, ref_toks


def _same_counters(eng, ref, keys):
    m, rm = eng.metrics(), ref.metrics()
    assert {k: m[k] for k in keys} == {k: rm[k] for k in keys}
    assert sorted(eng.alloc.refcount.items()) == \
        sorted(ref.alloc.refcount.items())
    return m


def _oracle(prompts, gens):
    cfg, params, _, _ = _model()
    if isinstance(gens, int):
        gens = [gens] * len(prompts)
    max_len = max(p.shape[0] + g for p, g in zip(prompts, gens))
    return dense_oracle(cfg, params, prompts, gens, max_len)


def _shared_prefix_prompts(n, total=14, shared=10, seed=0):
    """``test_prefix_cache._shared_prefix_prompts``: n prompts sharing a
    prefix that ends mid-page (page_size 4), so every hit copies."""
    cfg, _ = get_tiny_model()
    base = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (shared,),
                                         2, cfg.vocab_size), np.int32)
    out = []
    for i in range(n):
        tail = np.asarray(jax.random.randint(jax.random.PRNGKey(seed + 50 + i),
                                             (total - shared,), 2,
                                             cfg.vocab_size), np.int32)
        out.append(np.concatenate([base, tail]))
    return out


def test_prefix_cache_tokens_identical_with_forced_cow():
    prompts = _shared_prefix_prompts(4)
    gens = [5, 4, 6, 3]
    eng, toks, ref, ref_toks = _both(prompts, gens, prefix_cache=True)
    cfg, params, tcfg, tparams = _model()
    off, toks_off = _run(PagedEngine, tcfg, tparams, prompts, gens)
    assert toks == toks_off == ref_toks == _oracle(prompts, gens)
    m = _same_counters(eng, ref, COUNTERS + CACHE_COUNTERS)
    assert m["prefix_hits"] == 3 and m["cow_copies"] >= 3
    assert m["prefill_tokens_cached"] > 0 and m["bytes_deduped"] > 0
    assert m["prefill_tokens"] < off.metrics()["prefill_tokens"]
    assert eng.alloc.check_conservation()


def test_prefix_cache_hits_donated_partial_tail():
    """A follow-up prompt extending a finished request's sequence hits the
    donated pages, with a COW off the partially filled tail page."""
    cfg, params, tcfg, tparams = _model()
    p0 = np.asarray(jax.random.randint(jax.random.PRNGKey(9), (9,), 2,
                                       cfg.vocab_size), np.int32)
    kw = dict(max_batch=2, page_size=4, n_pages=48, max_len=24,
              prefix_cache=True)
    engines = []
    for cls, c, p in ((PagedEngine, tcfg, tparams), (JEngine, cfg, params)):
        extra = dict(device="cpu") if cls is PagedEngine else {}
        eng = cls(c, p, **kw, **extra)
        eng.submit(p0, 5, rid="a")
        a_tokens = list(eng.run()[0].tokens)
        p1 = np.concatenate([p0, np.asarray(a_tokens[:-1], np.int32),
                             np.asarray([5, 7, 11], np.int32)])
        eng.submit(p1, 3, rid="b")
        b = {r.rid: list(r.tokens) for r in eng.run()}["b"]
        engines.append((eng, a_tokens, b, p1))
    (eng, a, b, p1), (ref, ra, rb, _) = engines
    assert (a, b) == (ra, rb)
    assert b == _oracle([p1], [3])["r0"]
    m = _same_counters(eng, ref, COUNTERS + CACHE_COUNTERS)
    assert m["prefix_hits"] >= 1 and m["prefill_tokens_cached"] >= 9 + 5 - 1


def test_prefix_cache_tokens_identical_under_preemption_and_eviction():
    cfg, _ = get_tiny_model()
    prompts = [np.asarray(jax.random.randint(jax.random.PRNGKey(70 + i),
                                             (12,), 2, cfg.vocab_size),
               np.int32) for i in range(6)]
    gens = [6] * 6
    kw = dict(n_pages=14, prefill_budget=0.0)
    eng, toks, ref, ref_toks = _both(prompts, gens, prefix_cache=True, **kw)
    off, toks_off, ref_off, _ = _both(prompts, gens, **kw)
    assert toks == toks_off == ref_toks == _oracle(prompts, gens)
    m = _same_counters(eng, ref, COUNTERS + CACHE_COUNTERS)
    _same_counters(off, ref_off, COUNTERS)
    assert m["prefix_evictions"] >= 1
    assert off.metrics()["preemptions"] >= 1
    assert eng.alloc.check_conservation()


def test_prefix_cache_preempted_request_recomputes_exactly():
    prompts = _shared_prefix_prompts(6, total=12, shared=9, seed=7)
    gens = [8] * 6
    kw = dict(n_pages=14, prefill_budget=0.0)
    eng, toks, ref, ref_toks = _both(prompts, gens, prefix_cache=True, **kw)
    assert toks == ref_toks == _oracle(prompts, gens)
    m = _same_counters(eng, ref, COUNTERS + CACHE_COUNTERS)
    assert m["preemptions"] >= 1 and m["prefix_hits"] >= 1
    assert eng.alloc.check_conservation()


def test_prefix_cache_off_by_default_and_metrics_gated():
    _, _, tcfg, tparams = _model()
    eng = PagedEngine(tcfg, tparams, device="cpu", max_batch=2, page_size=4,
                      n_pages=16, max_len=16)
    assert eng.cache is None and eng.spec is None
    m = eng.metrics()
    assert "prefix_hit_rate" not in m and "accept_rate" not in m
    assert "chunk_tasks" not in m
    assert "model_passes" in m and "dispatches_per_token" in m
    with pytest.raises(ValueError, match="spec_proposer"):
        PagedEngine(tcfg, tparams, device="cpu", spec_decode=True,
                    spec_proposer="gpu")


@pytest.mark.parametrize("features", [{}, dict(prefix_cache=True,
                                                spec_decode=True,
                                                spec_k="auto",
                                                chunked_prefill=True)],
                         ids=["plain", "all_features"])
def test_engine_freed_without_cycle_collector(features):
    """A dropped engine frees its pools and parameters when its last
    reference goes: nothing it owns refers back to it."""
    prompts = _shared_prefix_prompts(3)
    _, _, tcfg, tparams = _model()
    eng, _ = _run(PagedEngine, tcfg, tparams, prompts, [4, 5, 3], **features)
    gone, block = weakref.ref(eng), weakref.ref(eng.d_block)
    gc.disable()
    try:
        del eng
        assert gone() is None and block() is None
    finally:
        gc.enable()


PROPOSERS = ["device", "host"]


@pytest.mark.parametrize("proposer", PROPOSERS)
def test_spec_tokens_identical_and_dispatches_drop(proposer):
    cfg, _ = get_tiny_model()
    gens = [14, 12, 16, 10]
    prompts = seeded_prompts(cfg, len(gens), 12, motif=4)
    eng, toks, ref, ref_toks = _both(prompts, gens, spec_decode=True,
                                     spec_k=6, proposer=proposer)
    off, toks_off = _run(PagedEngine, *_model()[2:], prompts, gens)
    assert toks == toks_off == ref_toks == _oracle(prompts, gens)
    m = _same_counters(eng, ref, COUNTERS + SPEC_COUNTERS)
    assert m["spec_verifies"] >= 1 and m["accept_rate"] > 0.0
    assert m["model_passes"] < off.metrics()["model_passes"]
    assert eng.alloc.check_conservation() and eng.alloc.pages_in_use == 0


@pytest.mark.parametrize("proposer", PROPOSERS)
def test_spec_tokens_identical_under_forced_preemption(proposer):
    cfg, _ = get_tiny_model()
    prompts = seeded_prompts(cfg, 6, 12)
    gens = [6] * 6
    eng, toks, ref, ref_toks = _both(prompts, gens, n_pages=14,
                                     prefill_budget=0.0, spec_decode=True,
                                     spec_k=6, proposer=proposer)
    assert toks == ref_toks == _oracle(prompts, gens)
    m = _same_counters(eng, ref, COUNTERS + SPEC_COUNTERS)
    assert m["preemptions"] >= 1
    assert eng.alloc.check_conservation() and eng.alloc.pages_in_use == 0


@pytest.mark.parametrize("proposer", PROPOSERS)
def test_spec_tokens_identical_with_prefix_cache_hits(proposer):
    cfg, _ = get_tiny_model()
    gens = [10, 9, 11, 8]
    prompts = seeded_prompts(cfg, len(gens), 14, shared=10, seed=3)
    eng, toks, ref, ref_toks = _both(prompts, gens, spec_decode=True,
                                     spec_k=6, prefix_cache=True,
                                     proposer=proposer)
    assert toks == ref_toks == _oracle(prompts, gens)
    m = _same_counters(eng, ref, COUNTERS + SPEC_COUNTERS + CACHE_COUNTERS)
    assert m["prefix_hits"] >= 1 and m["spec_verifies"] >= 1
    assert eng.alloc.pages_in_use == eng.cache.shared_pages


@pytest.mark.parametrize("proposer", PROPOSERS)
def test_spec_rollback_releases_pages_and_stays_exact(proposer):
    cfg, _ = get_tiny_model()
    gens = [18, 16]
    prompts = seeded_prompts(cfg, len(gens), 12, motif=3, seed=11)
    eng, toks, ref, ref_toks = _both(prompts, gens, spec_decode=True,
                                     spec_k=8, max_batch=2,
                                     proposer=proposer)
    assert toks == ref_toks == _oracle(prompts, gens)
    m = _same_counters(eng, ref, COUNTERS + SPEC_COUNTERS)
    assert m["spec_rollbacks"] >= 1, "trace never exercised rollback"
    assert eng.alloc.check_conservation() and eng.alloc.pages_in_use == 0


def test_spec_forced_rejection_invalidates_row_signature_and_stays_exact():
    """Adversarial host proposer: every draft is wrong, every verify
    rejects and rolls pages back, and the slot signature is forgotten on
    the rollback window; the port steps in lockstep with the reference
    engine under the same proposer."""
    cfg, params, tcfg, tparams = _model()
    prompts = seeded_prompts(cfg, 3, 8, seed=5)
    gen = 8

    def wrong(prompt, tokens, k_cap):
        if k_cap < 1 or not tokens:
            return []
        return [(int(tokens[-1]) + 1) % cfg.vocab_size] * min(3, k_cap)

    engines = []
    for cls, c, p in ((PagedEngine, tcfg, tparams), (JEngine, cfg, params)):
        extra = dict(device="cpu") if cls is PagedEngine else {}
        eng = cls(c, p, max_batch=2, page_size=4, n_pages=13, max_len=16,
                  prefill_budget=0.0, spec_decode=True, spec_k=4,
                  spec_proposer="host", **extra)
        eng.spec.propose = wrong
        for i, pr in enumerate(prompts):
            eng.submit(np.asarray(pr), gen, rid=f"r{i}")
        engines.append(eng)
    eng, ref = engines
    saw_invalidation = False
    while eng.sched.waiting or eng.sched.running:
        before = eng.spec.stats.verifies
        eng.step()
        ref.step()
        assert eng._slot_sig == ref._slot_sig
        if eng.spec.stats.verifies > before and eng.sched.running:
            saw_invalidation |= any(
                eng._slot_sig[s] is None for s in eng.sched.running)
    assert not (ref.sched.waiting or ref.sched.running)
    assert saw_invalidation
    assert eng.spec.stats.accepted == 0 and eng.spec.stats.rollbacks >= 1
    toks = {r.rid: list(r.tokens) for r in eng.sched.finished}
    assert toks == {r.rid: list(r.tokens) for r in ref.sched.finished} \
        == _oracle(prompts, gen)
    _same_counters(eng, ref, COUNTERS + SPEC_COUNTERS)
    assert eng.alloc.check_conservation() and eng.alloc.pages_in_use == 0


@pytest.mark.parametrize("proposer", PROPOSERS)
def test_spec_shallow_drafts_never_cost_passes_at_wide_batch(proposer):
    cfg, _ = get_tiny_model()
    prompts = seeded_prompts(cfg, 3, 12, motif=4, seed=2)
    gens = [12] * 3
    eng, toks, ref, ref_toks = _both(prompts, gens, spec_decode=True,
                                     spec_k=2, proposer=proposer)
    off, toks_off = _run(PagedEngine, *_model()[2:], prompts, gens)
    assert toks == toks_off == ref_toks == _oracle(prompts, gens)
    m = _same_counters(eng, ref, COUNTERS + SPEC_COUNTERS)
    assert m["model_passes"] <= off.metrics()["model_passes"]


@pytest.mark.parametrize("proposer", PROPOSERS)
def test_spec_warmup_leaves_tokens_unchanged(proposer):
    """``warmup_windows`` with speculation on runs every verify width
    against null rows and marks every history row stale: the served
    tokens are those of a cold engine."""
    cfg, _ = get_tiny_model()
    gens = [10, 12]
    prompts = seeded_prompts(cfg, 2, 12, motif=4, seed=8)
    _, cold = _run(PagedEngine, *_model()[2:], prompts, gens,
                   spec_decode=True, spec_k="auto", proposer=proposer)
    eng, warm = _run(PagedEngine, *_model()[2:], prompts, gens,
                     spec_decode=True, spec_k="auto", proposer=proposer,
                     hook=PagedEngine.warmup_windows)
    assert eng.verify_buckets() == [2, 4, 8, 16]
    assert warm == cold == _oracle(prompts, gens)


def test_serve_cli_runs_every_feature(capsys):
    serve.main(["--tiny", "--device", "cpu", "--engine", "paged",
                "--requests", "6", "--prompt-len", "24", "--gen", "12",
                "--batch", "3", "--prefix-cache", "on", "--shared-prefix",
                "10", "--spec-decode", "on", "--spec-k", "auto",
                "--chunk-prefill", "on", "--chunk-tokens", "8", "--slo",
                "interactive"])
    out = capsys.readouterr().out
    assert "[paged] cpu: served 6 requests, 72 tokens" in out
    assert "[paged] spec decode:" in out
    assert "[paged] spec depth: adaptive" in out
    assert "[paged] chunked prefill:" in out and "SLO class interactive" in out
    assert "[paged] prefix cache:" in out and "COW copies" in out


def test_serve_cli_shared_prefix_prompts():
    a = serve.make_prompts(3, 12, 500, seed=4, shared_prefix=5)
    assert all(np.array_equal(p[:5], a[0][:5]) for p in a)
    assert not np.array_equal(a[0][5:], a[1][5:])
    assert [len(p) for p in a] == [12] * 3
    assert len(serve.make_prompts(2, 4, 500, shared_prefix=9)[0]) == 4
