"""The port's paged suffix prefill against the JAX reference on the CPU
(the tiny dense config; ``test_torch_suffix_moe.py`` runs the same
checks on the tiny grok config).

The body shared by the prefix-cache hit, the prefill chunk and the
speculative verify window (``lm._suffix_forward_paged``), its attention
and KV scatter, and the copy-on-write page copy, each held against the
reference function at float32 activations on the same inputs: the tiny
dense config and the tiny grok config (MoE FFN), parameters from the
reference's ``lm.init_params(PRNGKey(0))`` through
``weights.from_reference``, every other input from numpy seeds.  Cases
cover ``start`` mid-page and ``n_valid < W``.  Logits within 1e-5 abs
plus four fp32 units in the last place of the largest logit (the tiny
dense config's logits reach 65, where one unit is 7.6e-6 and the two
frameworks' summation orders differ by up to two), pools within 1e-6;
the scatter and the page copy are exact, and chunks
composed at page-aligned offsets (a 1-token chunk among them) write the
same pools and end in the same logits, bit for bit, as one suffix pass.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import get_tiny_model, seeded_prompts
from repro import steps as jsteps
from repro.configs import get_tiny_config as jtiny
from repro.models import attention as jattn, lm as jlm
from repro_torch import steps
from repro_torch.configs import get_tiny_config
from repro_torch.models import attention, lm
from repro_torch.weights import from_reference

LOGIT_TOL = 1e-5
LOGIT_ULPS = 4 * 2.0 ** -23      # four fp32 units of the largest logit
POOL_TOL = 1e-6
PS, NMAX, N_PAGES = 4, 6, 9
# (start, n_valid, W): from position 0, start mid-page, n_valid < W,
# W = 1, a page-aligned start
CASES = [(0, 5, 8), (6, 8, 8), (9, 3, 4), (13, 7, 8), (4, 4, 4),
         (10, 1, 1), (3, 2, 8)]

_MODELS = {}


def _model(arch):
    """(reference cfg, reference params, port cfg, port params), fp32."""
    if arch not in _MODELS:
        if arch == "tiny-100m":
            cfg, params = get_tiny_model()
        else:
            cfg = jtiny(arch)
            params = jlm.init_params(jax.random.PRNGKey(0), cfg)
        cfg = cfg.replace(activation_dtype="float32")
        tcfg = get_tiny_config(arch).replace(activation_dtype="float32")
        tparams = from_reference(jax.tree.map(np.asarray, params), tcfg,
                                 "cpu")
        _MODELS[arch] = (cfg, params, tcfg, tparams)
    return _MODELS[arch]


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _err(j, t):
    return float(np.abs(_np(j) - _np(t)).max())


def _pool_pairs(cfg, pools_j, pools_t):
    """(reference leaf, port leaf) of every layer's k and v pool, real
    pages only (the null page holds the padding's garbage)."""
    for si, seg in enumerate(lm.make_segments(cfg)):
        for c in range(seg.n_cycles):
            for j in range(len(seg.kinds)):
                for a, b in zip(pools_j[si][j], pools_t[si][c][j]):
                    yield (a[c] if seg.scanned else a)[1:], b[1:]


def _leaves(pools):
    """Every port pool leaf, real pages only."""
    if isinstance(pools, torch.Tensor):
        yield pools[1:]
    else:
        for p in pools:
            yield from _leaves(p)


def _block_row():
    # a shuffled page order, so logical and physical pages differ
    return np.random.default_rng(5).permutation(
        np.arange(1, N_PAGES, dtype=np.int32))[:NMAX]


def _prefilled(arch, start, seed=7):
    """Both sides' pools holding a ``start``-token prompt's KV (the
    reference's paged prefill on both), the block row and the prompt."""
    cfg, params, tcfg, tparams = _model(arch)
    row = _block_row()
    toks = seeded_prompts(cfg, 1, NMAX * PS, seed=seed)[0]
    pools_j = jlm.init_paged_caches(cfg, N_PAGES, PS)
    pools_t = lm.init_paged_caches(tcfg, N_PAGES, PS, "cpu")
    if start > 0:
        _, pools_j = jsteps.make_paged_prefill_step(cfg)(
            params, jnp.asarray(toks[None, :start]), pools_j,
            jnp.asarray(row))
        _, pools_t = steps.make_paged_prefill_step(tcfg)(
            tparams, torch.tensor(toks[None, :start]), pools_t,
            torch.tensor(row))
    return row, toks, pools_j, pools_t


def _suffix_tokens(toks, start, n_valid, W):
    padded = np.zeros((1, W), np.int32)
    padded[0, :n_valid] = toks[start:start + n_valid]
    return padded


@pytest.mark.parametrize("start,n_valid,W", CASES)
def test_scatter_suffix_matches_reference_exactly(start, n_valid, W):
    rng = np.random.default_rng(start * 31 + W)
    Kv, hd = 2, 8
    pool = rng.standard_normal((N_PAGES, PS, Kv * hd)).astype(np.float32)
    k, v = (rng.standard_normal((1, W, Kv, hd)).astype(np.float32)
            for _ in range(2))
    row = _block_row()
    got = attention.paged_cache_scatter_suffix(
        attention.PagedAttnCache(torch.tensor(pool), torch.tensor(pool)),
        torch.tensor(k), torch.tensor(v), torch.tensor(row), start, n_valid)
    want = jattn.paged_cache_scatter_suffix(
        jattn.PagedAttnCache(jnp.asarray(pool), jnp.asarray(pool)),
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(row), jnp.int32(start),
        jnp.int32(n_valid))
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a)[1:], b.numpy()[1:])
    # the padding reached no real page: pages outside the suffix's span
    # keep the pool's values
    touched = {int(row[t // PS]) for t in range(start, start + n_valid)}
    for p in set(range(1, N_PAGES)) - touched:
        assert np.array_equal(got.k[p].numpy(), pool[p])


@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("start,W", [(0, 8), (6, 8), (13, 4), (9, 1)])
def test_attend_prefill_paged_matches_reference(start, W, softcap):
    rng = np.random.default_rng(start + W)
    H, Kv, hd = 4, 2, 8
    q = rng.standard_normal((1, W, H, hd)).astype(np.float32)
    pool = [rng.standard_normal((N_PAGES, PS, Kv * hd)).astype(np.float32)
            for _ in range(2)]
    row = _block_row()
    kw = dict(scale=hd ** -0.5, softcap=softcap, n_kv=Kv)
    got = attention.attend_prefill_paged(
        torch.tensor(q), attention.PagedAttnCache(*map(torch.tensor, pool)),
        torch.tensor(row), start, **kw)
    want = jattn.attend_prefill_paged(
        jnp.asarray(q), jattn.PagedAttnCache(*map(jnp.asarray, pool)),
        jnp.asarray(row), jnp.int32(start), **kw)
    assert _err(want, got) < POOL_TOL


def check_suffix_function(fn, start, n_valid, W, arch):
    """``lm.<fn>`` against the reference's on the same pools and suffix."""
    cfg, params, tcfg, tparams = _model(arch)
    row, toks, pools_j, pools_t = _prefilled(arch, start)
    tok = _suffix_tokens(toks, start, n_valid, W)
    lj, pools_j = getattr(jlm, fn)(params, cfg, jnp.asarray(tok), pools_j,
                                   jnp.asarray(row), jnp.int32(start),
                                   jnp.int32(n_valid))
    lt, pools_t = getattr(lm, fn)(tparams, tcfg, torch.tensor(tok), pools_t,
                                  torch.tensor(row), start, n_valid)
    assert lt.shape == lj.shape
    if fn == "verify_window_paged":      # padded rows score garbage
        lj, lt = lj[:, :n_valid], lt[:, :n_valid]
    assert _err(lj, lt) < LOGIT_TOL + LOGIT_ULPS * np.abs(_np(lj)).max()
    assert np.array_equal(np.asarray(jnp.argmax(lj, -1)),
                          lt.argmax(-1).numpy())
    for a, b in _pool_pairs(tcfg, pools_j, pools_t):
        assert _err(a, b) < POOL_TOL


def test_verify_takes_device_scalars_like_ints():
    """``start`` and ``n_valid`` as 0-d tensors (the speculative chain's
    form) give the same bits as host ints."""
    _, _, tcfg, tparams = _model("tiny-100m")
    start, n_valid, W = 6, 5, 8
    outs = []
    for as_tensor in (False, True):
        row, toks, _, pools = _prefilled("tiny-100m", start)
        tok = torch.tensor(_suffix_tokens(toks, start, n_valid, W))
        s, n = ((torch.tensor(start, dtype=torch.int32),
                 torch.tensor(n_valid, dtype=torch.int32)) if as_tensor
                else (start, n_valid))
        logits, pools = lm.verify_window_paged(
            tparams, tcfg, tok, pools, torch.tensor(row), s, n)
        outs.append((logits, list(_leaves(pools))))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))


def _random_pools(arch, seed=3):
    """The same random values in both sides' pools."""
    cfg, _, tcfg, _ = _model(arch)
    rng = np.random.default_rng(seed)
    pools_j = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype),
        jlm.init_paged_caches(cfg, N_PAGES, PS))
    pools_t = lm.init_paged_caches(tcfg, N_PAGES, PS, "cpu")
    for a, b in _pool_pairs(tcfg, pools_j, pools_t):
        b.copy_(torch.tensor(np.asarray(a)))
    return pools_j, pools_t


def check_page_copy(arch):
    """``make_page_copy`` against the reference's on the same pools."""
    _, _, tcfg, _ = _model(arch)
    pools_j, pools_t = _random_pools(arch)
    pools_j = jsteps.make_page_copy()(pools_j, jnp.int32(3), jnp.int32(7))
    pools_t = steps.make_page_copy()(pools_t, 3, 7)
    for a, b in _pool_pairs(tcfg, pools_j, pools_t):
        assert np.array_equal(np.asarray(a), b.numpy())
        assert np.array_equal(b.numpy()[6], b.numpy()[2])   # pages 7, 3


# (cached prefix, chunk tokens, prompt end): chunks end on page
# boundaries, so a prefix ending mid-page gives a short first chunk; a
# prompt end one past a page boundary gives a 1-token final chunk when
# the chunk before it ends on that boundary (the last case)
CHUNKS = [(0, 4, 20), (4, 8, 22), (2, 4, 22), (0, 8, 21), (6, 4, 21)]


def check_chunks_compose(arch, start, chunk, end):
    """Chunks at page-aligned offsets after a cached prefix of ``start``
    tokens write the KV one ``prefill_suffix_paged`` of the whole suffix
    writes, bit for bit, at every position, and the final chunk's logits
    are that pass's: a 1-token chunk too (it runs as a 2-row window, so
    its projections sum in the order of a multi-row one; the reference,
    whose compiled programs sum alike, pins bit-identity through its
    engine's tokens)."""
    _, _, tcfg, tparams = _model(arch)
    row, toks, _, one = _prefilled(arch, start)
    n = end - start
    W = 1 << max(n - 1, 0).bit_length()
    l_one, one = lm.prefill_suffix_paged(
        tparams, tcfg, torch.tensor(_suffix_tokens(toks, start, n, W)), one,
        torch.tensor(row), start, n)
    _, _, _, many = _prefilled(arch, start)
    s = start
    while s < end:
        nxt = min(end, s // PS * PS + chunk)
        w = 1 << max(nxt - s - 1, 0).bit_length()
        l_many, many = lm.chunk_prefill_paged(
            tparams, tcfg, torch.tensor(_suffix_tokens(toks, s, nxt - s, w)),
            many, torch.tensor(row), s, nxt - s)
        s = nxt
    for a, b in zip(_leaves(one), _leaves(many)):
        for t in range(start, end):
            ra, rb = a[row[t // PS] - 1, t % PS], b[row[t // PS] - 1, t % PS]
            assert torch.equal(ra, rb), t
    assert torch.equal(l_one, l_many)


# the tiny dense config here; the tiny grok config (MoE FFN) in
# test_torch_suffix_moe.py, on a worker of its own
FNS = ["prefill_suffix_paged", "chunk_prefill_paged", "verify_window_paged"]


@pytest.mark.parametrize("start,n_valid,W", CASES)
@pytest.mark.parametrize("fn", FNS)
def test_suffix_functions_match_reference(fn, start, n_valid, W):
    check_suffix_function(fn, start, n_valid, W, "tiny-100m")


def test_page_copy_matches_reference_exactly():
    check_page_copy("tiny-100m")


@pytest.mark.parametrize("start,chunk,end", CHUNKS)
def test_chunks_compose_to_one_suffix_pass(start, chunk, end):
    check_chunks_compose("tiny-100m", start, chunk, end)
