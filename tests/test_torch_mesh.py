"""The port's striped KV pools (the paged engine on a mesh) against the
JAX reference on the CPU.

The port's mesh is a list of ``"cpu"`` devices (``make_test_mesh(...,
devices="cpu")``): one controller holds every stripe, so everything runs
in this process.  The reference's own striped engine cannot run here (its
``paged_cache_from_prefill`` scatter fails under explicit sharding on the
installed jax), so the oracles are the ones that do:

* the plain ``paged_decode_attention`` with ``page_mask`` and
  ``partials=True`` against the reference kernel in interpret mode, on
  the same numpy inputs: masks of 2 and 4 stripes, a sequence owning no
  page on a stripe, ``pos`` on a page boundary, NaN in every stripe's
  unowned local row 0; fp32 within 1e-6 + 1e-6 |ref| (the unnormalized
  l and acc reach the number of slots attended, and the reference
  rescales its sums a page at a time, the plain version in one pass),
  bf16 within 2e-2;
* the port's ``attend_decode_paged_sharded`` (plain body and the
  kernel's wrapper) against the reference kernel per stripe merged with
  its ``pmax``/``psum`` arithmetic written out in jnp, and against the
  reference's unstriped ``attend_decode_paged``: fp32 within 1e-5;
* the reference's mesh-axis trace (``tests/test_serving_fuzz.py``) at
  1x1, 1x2 and 2x2, fp32 and bf16: tokens equal to the reference's dense
  oracle, with a COW copy, a prefix hit and a preemption engaged,
  allocator conservation, and host syncs equal to the 1x1 engine's;
* the dispatch spans' ``predicted_comms_s`` / ``comms_bytes`` equal to
  the reference's ``costs.serving_comm_cost`` (exact);
* the serve CLI's paged mesh flags, and the engine's stripe checks with
  the reference's messages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import dense_oracle, get_tiny_model, seeded_prompts
from repro.core import costs as jcosts
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro_torch.configs import get_tiny_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import attention
from repro_torch.serving.engine import PagedEngine
from repro_torch.weights import from_reference

TOL = {"float32": 1e-6, "bfloat16": 2e-2}   # abs, and rel for fp32 partials
MERGE_TOL = 1e-5
B, H, KV, HD, PS, NMAX = 3, 4, 2, 16, 4, 6
LAYOUTS = [(1, 1), (1, 2), (2, 2)]

_MEMO = {}


def _pages(n_stripes, dtype, seed):
    """q, k/v pages (P,ps,Kv,hd) of n_stripes * L rows, a block table of
    distinct rows none of which is a stripe's local row 0 (those hold NaN:
    only an unowned entry's safe index names them), and pos: the last
    slot of a page, the first slot of one, and 0.  Sequence 2 owns
    nothing on every stripe but one."""
    rng = np.random.default_rng(seed)
    L = B * NMAX // n_stripes + NMAX + 1
    P = n_stripes * L
    q = rng.standard_normal((B, H, HD)).astype(np.float32)
    kp = rng.standard_normal((P, PS, KV, HD)).astype(np.float32)
    vp = rng.standard_normal((P, PS, KV, HD)).astype(np.float32)
    kp[::L] = np.nan
    vp[::L] = np.nan
    rows = [r for r in range(P) if r % L]
    rng.shuffle(rows)
    bt = np.asarray(rows[:B * NMAX], np.int32).reshape(B, NMAX)
    bt[2] = rng.choice([r for r in range(L) if r][:NMAX], NMAX,
                       replace=False)                 # stripe 0 only
    pos = np.asarray([4 * PS - 1, 3 * PS, 0], np.int32)
    cast = (lambda a: a) if dtype == "float32" else (
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(
            jnp.float32)))
    return cast(q), cast(kp), cast(vp), bt, pos, L


def _t(a, dtype):
    return torch.tensor(np.asarray(a, np.float32)).to(getattr(torch, dtype))


def _stripe_inputs(bt, j, L):
    local = bt - j * L
    mine = (local >= 0) & (local < L)
    return np.where(mine, local, 0).astype(np.int32), mine.astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_stripes", [2, 4])
def test_plain_masked_partials_match_reference_kernel(n_stripes, dtype):
    """Each stripe's (acc, m, l) and its masked normalized output from the
    port's plain version against the reference kernel (interpret mode)
    on the same inputs; the merged stripes equal the unstriped plain
    version.  The empty stripes (sequence 2 beyond stripe 0) give m =
    NEG_INF, l = 0, acc = 0 on both sides."""
    q, kp, vp, bt, pos, L = _pages(n_stripes, dtype, seed=n_stripes)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tol = TOL[dtype]
    parts = []
    for j in range(n_stripes):
        safe, mine = _stripe_inputs(bt, j, L)
        sl = slice(j * L, (j + 1) * L)
        jout = jops.paged_decode_attention(
            jnp.asarray(q, jdt), jnp.asarray(kp[sl], jdt),
            jnp.asarray(vp[sl], jdt), jnp.asarray(safe), jnp.asarray(pos),
            page_mask=jnp.asarray(mine), partials=True)
        tout = ops.paged_decode_attention(
            _t(q, dtype), _t(kp[sl], dtype), _t(vp[sl], dtype),
            torch.tensor(safe), torch.tensor(pos),
            page_mask=torch.tensor(mine), partials=True)
        for a, b in zip(jout, tout):
            assert b.dtype == torch.float32
            a = np.asarray(a, np.float32)
            rel = TOL["float32"] * np.abs(a)
            assert (np.abs(a - b.numpy()) <= tol + rel).all()
        if j:
            acc, m, l = tout
            assert (m[2] == attention.NEG_INF).all() and (l[2] == 0).all()
            assert (acc[2] == 0).all()
        o = ops.paged_decode_attention(
            _t(q, dtype), _t(kp[sl], dtype), _t(vp[sl], dtype),
            torch.tensor(safe), torch.tensor(pos),
            page_mask=torch.tensor(mine))
        jo = jops.paged_decode_attention(
            jnp.asarray(q, jdt), jnp.asarray(kp[sl], jdt),
            jnp.asarray(vp[sl], jdt), jnp.asarray(safe), jnp.asarray(pos),
            page_mask=jnp.asarray(mine))
        assert np.abs(np.asarray(jo, np.float32) - o.float().numpy()).max() \
            <= tol
        parts.append(tout)
    m_g = torch.stack([m for _, m, _ in parts]).amax(0)
    l_g = sum(l * torch.exp(m - m_g) for _, m, l in parts)
    acc_g = sum(a * torch.exp(m - m_g)[..., None] for a, m, _ in parts)
    merged = (acc_g / l_g[..., None]).reshape(B, H, HD)
    whole = ops.paged_decode_attention(
        _t(q, "float32"), _t(kp, "float32"), _t(vp, "float32"),
        torch.tensor(bt), torch.tensor(pos))
    assert torch.isfinite(merged).all()
    assert (merged - whole).abs().max() <= (MERGE_TOL if dtype == "float32"
                                            else TOL[dtype])


def _striped_pool(kp, vp, n_stripes, L):
    """The port's StripedPagedCache of the same pages (flat features),
    each stripe with its sink row."""
    flat = torch.tensor(kp).reshape(kp.shape[0], PS, KV * HD)
    flat_v = torch.tensor(vp).reshape(vp.shape[0], PS, KV * HD)
    sink = torch.zeros(1, PS, KV * HD)
    return attention.StripedPagedCache(
        k=tuple(torch.cat([flat[j * L:(j + 1) * L], sink])
                for j in range(n_stripes)),
        v=tuple(torch.cat([flat_v[j * L:(j + 1) * L], sink])
                for j in range(n_stripes)))


@pytest.mark.parametrize("impl", [None, "pallas"])
@pytest.mark.parametrize("n_stripes", [2, 4])
def test_sharded_decode_matches_reference_math(n_stripes, impl):
    """The port's striped decode (plain body, or the kernel's wrapper
    in its masked partials mode) against the reference kernel per stripe
    merged as the reference's shard_map body merges (pmax, then psums of
    the rescaled partials), and against the reference's unstriped
    ``attend_decode_paged``: fp32 within 1e-5.  Row 0 of every stripe
    holds finite values here (the engine's pools never hold NaN)."""
    q, kp, vp, bt, pos, L = _pages(n_stripes, "float32", seed=7)
    kp[::L] = 0.5
    vp[::L] = -0.5
    ms, ls, accs = [], [], []
    for j in range(n_stripes):
        safe, mine = _stripe_inputs(bt, j, L)
        sl = slice(j * L, (j + 1) * L)
        acc, m, l = jops.paged_decode_attention(
            jnp.asarray(q), jnp.asarray(kp[sl]), jnp.asarray(vp[sl]),
            jnp.asarray(safe), jnp.asarray(pos),
            page_mask=jnp.asarray(mine), partials=True)
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    m_g = jnp.max(jnp.stack(ms), 0)
    corr = [jnp.exp(m - m_g) for m in ms]
    l_g = sum(l * c for l, c in zip(ls, corr))
    acc_g = sum(a * c[..., None] for a, c in zip(accs, corr))
    want = np.asarray((acc_g / jnp.maximum(l_g[..., None], 1e-37))
                      .reshape(B, 1, H * HD))
    pool = _striped_pool(kp, vp, n_stripes, L)
    got = attention.attend_decode_paged(
        torch.tensor(q).reshape(B, 1, H, HD), pool, torch.tensor(bt),
        torch.tensor(pos), scale=HD ** -0.5, softcap=None, n_kv=KV,
        impl=impl).numpy()
    assert np.abs(got - want).max() <= MERGE_TOL
    jpool = jattn.PagedAttnCache(
        k=jnp.asarray(kp.reshape(kp.shape[0], PS, KV * HD)),
        v=jnp.asarray(vp.reshape(vp.shape[0], PS, KV * HD)))
    unstriped = np.asarray(jattn.attend_decode_paged(
        jnp.asarray(q).reshape(B, 1, H, HD), jpool, jnp.asarray(bt),
        jnp.asarray(pos), scale=HD ** -0.5, softcap=None, n_kv=KV))
    assert np.abs(got - unstriped).max() <= MERGE_TOL


# ---------------------------------------------------------------------------
# the mesh axis of the serving cube
# ---------------------------------------------------------------------------
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
    """``test_serving_fuzz.test_mesh_axis_matches_dense_oracle``'s trace."""
    cfg, _ = get_tiny_model()
    shared = seeded_prompts(cfg, 2, 12, shared=9, seed=21)
    loops = seeded_prompts(cfg, 2, 12, motif=4, seed=33)
    plain = seeded_prompts(cfg, 2, 12, seed=45)
    prompts = [shared[0], loops[0], plain[0], shared[1], loops[1],
               plain[1]]
    gens = [10, 14, 8, 11, 13, 9]
    return prompts, gens, max(p.shape[0] + g for p, g in zip(prompts, gens))


def _oracle(dtype):
    key = ("oracle", dtype)
    if key not in _MEMO:
        cfg, params, _, _ = _models(dtype)
        _MEMO[key] = dense_oracle(cfg, params, *_trace())
    return _MEMO[key]


def _replay(dtype, layout, n_pages, **kw):
    _, _, tcfg, tparams = _models(dtype)
    prompts, gens, max_len = _trace()
    mesh = make_test_mesh(*layout, devices="cpu")
    eng = PagedEngine(tcfg, tparams, device="cpu", max_batch=2, page_size=4,
                      n_pages=n_pages, max_len=max_len, max_window=4,
                      mesh=mesh, **kw)
    for i, (p, g) in enumerate(zip(prompts, gens)):
        eng.submit(np.asarray(p), g, rid=f"r{i}")
    eng.run()
    return eng, {r.rid: list(r.tokens) for r in eng.sched.finished}


def _replays(dtype, layout):
    """(prefix-cache run, forced-preemption run), memoized per layout."""
    key = ("replay", dtype, layout)
    if key not in _MEMO:
        _MEMO[key] = (_replay(dtype, layout, 26, prefix_cache=True),
                      _replay(dtype, layout, 12, prefill_budget=0.0))
    return _MEMO[key]


SYNCS = ("h2d_syncs", "d2h_syncs", "steps", "windows", "model_passes")


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: f"{l[0]}x{l[1]}")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mesh_axis_matches_dense_oracle(dtype, layout):
    """The reference's mesh rung: the pinned trace at 1x1, 1x2 and 2x2
    emits the dense oracle's tokens with the prefix cache's COW copy on
    striped pools, and on a 12-page pool that forces a preemption; the
    allocator conserves its pages; the host syncs and passes equal the
    1x1 engine's (no routing decision waits for the host)."""
    (pc, pc_toks), (pre, pre_toks) = _replays(dtype, layout)
    (pc1, _), (pre1, _) = _replays(dtype, (1, 1))
    stripes = layout[1]
    for eng in (pc, pre):
        pool = eng.pools[0][0][0]
        assert isinstance(pool, attention.StripedPagedCache) == \
            (stripes > 1)
        if stripes > 1:
            assert len(pool.k) == stripes and eng.n_nodes == stripes
    assert pc_toks == _oracle(dtype), (layout, "prefix")
    m = pc.metrics()
    assert pc.cache.stats.cow_copies >= 1 and m["prefix_hits"] >= 1
    assert pre_toks == _oracle(dtype), (layout, "preempt")
    mp = pre.metrics()
    assert mp["preemptions"] >= 1
    assert pre.alloc.check_conservation() and pre.alloc.pages_in_use == 0
    for eng, base in ((pc, pc1), (pre, pre1)):
        assert {k: eng.metrics()[k] for k in SYNCS} == \
            {k: base.metrics()[k] for k in SYNCS}


def test_striped_engine_under_the_kernel_impl_on_cpu():
    """impl="pallas" routes every striped decode through the kernel's
    wrapper in its masked partials mode; on CPU tensors the wrapper takes
    the plain version and counts no launch.  The tokens equal the plain
    striped engine's and the dense oracle's."""
    _, _, tcfg, tparams = _models("float32")
    prompts, gens, max_len = _trace()
    out = []
    for impl in (tcfg.impl, "pallas"):
        eng = PagedEngine(tcfg.replace(impl=impl), tparams, device="cpu",
                          max_batch=2, page_size=4, n_pages=28,
                          max_len=max_len, max_window=4,
                          mesh=make_test_mesh(1, 4, devices="cpu"))
        ops.reset_launches()
        for i, (p, g) in enumerate(zip(prompts, gens)):
            eng.submit(np.asarray(p), g, rid=f"r{i}")
        out.append({r.rid: list(r.tokens) for r in eng.run()})
        assert ops.paged_decode_attention.launches == 0
        assert ops.paged_decode_attention.masked_launches == 0
    assert out[0] == out[1] == _oracle("float32")


# ---------------------------------------------------------------------------
# predicted stripe traffic on the dispatch spans
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("features", [
    dict(prefix_cache=True, spec_decode=True, spec_k="auto"),
    dict(chunked_prefill=True)], ids=["prefix-spec", "chunked"])
@pytest.mark.parametrize("link_mode", ["circuit", "packet"])
def test_spans_carry_the_reference_comms(features, link_mode):
    """Every prefill-shaped and scan span of a traced 1x2 engine carries
    the reference's ``serving_comm_cost`` for its width (a scan: K times
    the cost of one step over ``max_batch`` tokens with one merge); a
    page copy carries none, and neither does any span of a 1x1 engine."""
    cfg, _, tcfg, tparams = _models("float32")
    prompts, gens, max_len = _trace()
    engines = {}
    for model in (1, 2):
        eng = PagedEngine(tcfg, tparams, device="cpu", max_batch=2,
                          page_size=4, n_pages=26, max_len=max_len,
                          max_window=4, trace=True, link_mode=link_mode,
                          mesh=make_test_mesh(1, model, devices="cpu"),
                          **features)
        for i, (p, g) in enumerate(zip(prompts, gens)):
            eng.submit(np.asarray(p), g, rid=f"r{i}")
        eng.run()
        engines[model] = [s for s in eng.tracer.spans
                          if s.cat == "dispatch"]
    assert not any("comms_bytes" in s.args for s in engines[1])

    def want(n_tokens, n_merges):
        return jcosts.serving_comm_cost(
            cfg, jcosts.Layout(data=1, model=2), link_mode,
            n_tokens=n_tokens, n_merges=n_merges)

    phases = set()
    for s in engines[2]:
        a = s.args
        phases.add(s.name)
        if s.name == "cow_copy":
            assert "comms_bytes" not in a
            continue
        if s.name == "scan":
            cs, cb = want(2, 1)
            exp = (a["k"] * cs, a["k"] * cb)
        elif s.name == "draft_verify":
            exp = want(a["width"], 0)
        elif s.name == "prefill":
            exp = want(PagedEngine._pow2_ceil(a["tokens"]) if "cached" in a
                       else a["tokens"], 0)
        else:
            assert s.name == "chunk_prefill", s.name
            exp = want(PagedEngine._pow2_ceil(a["tokens"]), 0)
        assert (a["predicted_comms_s"], a["comms_bytes"]) == exp, s.name
        assert a["comms_bytes"] > 0
    assert {"scan", "prefill"} <= phases or {"scan", "chunk_prefill"} \
        <= phases


# ---------------------------------------------------------------------------
# the engine's stripe checks and the serve CLI
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw,msg", [
    (dict(n_pages=27), "n_pages=27 not divisible by the stripe degree 2"),
    (dict(n_pages=26, n_nodes=3),
     "n_nodes=3 disagrees with the mesh's model degree 2")])
def test_engine_stripe_checks_raise_as_the_reference(kw, msg):
    _, _, tcfg, tparams = _models("float32")
    with pytest.raises(ValueError, match=msg):
        PagedEngine(tcfg, tparams, device="cpu", max_batch=2, page_size=4,
                    max_len=32, mesh=make_test_mesh(2, 2, devices="cpu"),
                    **kw)


def _cli(argv, capsys):
    serve.main(["--tiny", "--device", "cpu", "--requests", "4",
                "--prompt-len", "12", "--gen", "6", "--batch", "2"] + argv)
    return capsys.readouterr().out


def _served(out):
    """The CLI's "served N requests, T tokens" line, up to the time."""
    return [line for line in out.splitlines()
            if line.startswith("[paged] cpu: served")][0].split(" in ")[0]


@pytest.mark.parametrize("argv,stripes", [
    (["--devices", "4", "--model", "4"], 4),
    (["--devices", "4", "--data", "2", "--model", "2"], 2),
    (["--layout", "auto", "--devices", "4"], None)],
    ids=["1x4", "2x2", "auto"])
def test_serve_cli_paged_mesh(argv, stripes, capsys):
    """The paged engine serves every request on a CPU mesh from the CLI
    and reports its stripes; ``--layout auto`` prints the reference's
    ranking of the serving layouts of 4 chips (``autotune_layout(...,
    serving=True)``), line for line, and serves the best."""
    base = _served(_cli(["--engine", "paged"], capsys))
    out = _cli(["--engine", "paged"] + argv, capsys)
    assert _served(out) == base
    if stripes is None:
        from repro.configs import get_tiny_config as jtiny
        from repro.configs.base import ShapeConfig
        from repro.parallel.sharding import autotune_layout
        _, ranked = autotune_layout(
            jtiny("tiny-100m"), ShapeConfig("serve", 18, 2, "decode"),
            n_chips=4, serving=True)
        printed = [line.split("   ", 1)[1].replace(" <= chosen", "")
                   for line in out.splitlines()
                   if line.startswith("[cost-engine]   ")]
        assert printed == [est.describe() for est in ranked]
        best = ranked[0].layout
        assert f"mesh {{'data': {best.data}, 'model': {best.model}}}" in out
    else:
        assert f"each pool in {stripes} stripes over cpu" in out


def test_serve_cli_dense_mesh_still_exits_2(capsys):
    """The dense engine's mesh, which exited 2 while it was not ported,
    now serves: ``--engine dense --model 2`` on a 1x2 mesh of CPU
    positions."""
    out = _cli(["--engine", "dense", "--model", "2"], capsys)
    assert "[dense] mesh {'data': 1, 'model': 2}: 2 positions" in out
    assert "served 4 requests, 24 tokens" in out
