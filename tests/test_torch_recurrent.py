"""The port's recurrent families (RWKV-6, RecurrentGemma) and the dense
serving engine against the JAX reference on the CPU.

Parameters come from the reference's ``lm.init_params`` on the tiny configs
and cross into torch through ``repro_torch.weights.from_reference``; every
other input is made with numpy from a seed.  Parity runs at float32
activations: logits agree within 1e-4 abs and greedy tokens are
identical; layer outputs agree within 1e-4 (5e-4 for the chunked RWKV
scan, whose log-space cumsums round differently from the stepwise loop).
The JAX side runs its own default path and, where the port runs a
kernel wrapper (``impl="pallas"``), the wrapper's plain version on the
CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import steps as jsteps
from repro.configs import get_config as jget, get_tiny_config as jtiny
from repro.models import attention as jattn, lm as jlm, rglru as jrglru
from repro.models import rwkv6 as jrwkv6
from repro_torch import steps
from repro_torch.configs import get_config, get_tiny_config
from repro_torch.kernels import ref as kref
from repro_torch.launch import serve
from repro_torch.models import attention, lm, rglru, rwkv6
from repro_torch.weights import from_reference, init_params

ARCHS = ("rwkv6-1.6b", "recurrentgemma-2b")
LOGIT_TOL = 1e-4
ACT_TOL = 1e-4
IMPLS = ("ref", "blocked", "pallas")
# recurrentgemma: a 32-token window, so that a prompt longer than 32 wraps
# the ring cache, and 5 layers, so that the (rglru, rglru) remainder
# segment after the one full cycle exists
OVERRIDES = {"rwkv6-1.6b": {},
             "recurrentgemma-2b": dict(n_layers=5, sliding_window=32)}


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _close(j, t, tol):
    err = float(np.abs(_np(j) - _np(t)).max())
    assert err < tol, err


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


_MODELS = {}


def _model(arch):
    """(reference cfg, reference params, port cfg, port params), fp32."""
    if arch not in _MODELS:
        kw = dict(OVERRIDES[arch], activation_dtype="float32")
        cfg = jtiny(arch).replace(**kw)
        tcfg = get_tiny_config(arch).replace(**kw)
        params = jlm.init_params(jax.random.PRNGKey(0), cfg)
        tparams = from_reference(jax.tree.map(np.asarray, params), tcfg,
                                 "cpu")
        _MODELS[arch] = (cfg, params, tcfg, tparams)
    return _MODELS[arch]


def _block(arch, kind):
    """The first block of ``kind`` on both sides: (jax params, torch)."""
    cfg, params, tcfg, tparams = _model(arch)
    for si, seg in enumerate(jlm.make_segments(cfg)):
        if kind in seg.kinds:
            j = seg.kinds.index(kind)
            p = params["segments"][si][j]
            if seg.scanned:
                p = jax.tree.map(lambda a: a[0], p)
            return p, tparams["segments"][si][0][j]
    raise KeyError(kind)


# --- configs and the weight bridge ------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_configs_match_reference_field_for_field(arch):
    for mine, theirs in ((get_config(arch), jget(arch)),
                         (get_tiny_config(arch), jtiny(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    with pytest.raises(KeyError, match="ROADMAP"):
        get_config("gemma2-27b")


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_bridge_round_trip(arch):
    cfg, params, tcfg, tparams = _model(arch)
    segs = lm.make_segments(tcfg)
    assert [tuple(s) for s in segs] == [tuple(s) for s in
                                        jlm.make_segments(cfg)]
    assert any(s.scanned for s in segs)
    ref_np = jax.tree.map(np.asarray, params)
    n_leaves = 0
    for seg, seg_p, mine in zip(segs, ref_np["segments"],
                                tparams["segments"]):
        assert len(mine) == seg.n_cycles
        for c in range(seg.n_cycles):
            for j in range(len(seg.kinds)):
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                        seg_p[j])[0]:
                    node = mine[c][j]
                    for k in path:
                        node = node[k.key]
                    want = leaf[c] if seg.scanned else leaf
                    assert np.array_equal(node.numpy(), want), (c, path)
                    n_leaves += 1
    assert n_leaves == sum(
        len(jax.tree.leaves(blk)) * s.n_cycles
        for s, seg_p in zip(segs, ref_np["segments"]) for blk in seg_p)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_layout(arch):
    cfg = jtiny(arch)
    mine = init_params(get_tiny_config(arch),
                       torch.Generator().manual_seed(0), "cpu")
    ref = jlm.init_params(jax.random.PRNGKey(0), cfg)
    for seg, seg_p, seg_t in zip(jlm.make_segments(cfg), ref["segments"],
                                 mine["segments"]):
        for j in range(len(seg.kinds)):
            rblk = seg_p[j]
            if seg.scanned:
                rblk = jax.tree.map(lambda a: a[0], rblk)
            want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), rblk)
            got = jax.tree.map(lambda t: (tuple(t.shape),
                                          str(t.dtype)[6:]), seg_t[0][j])
            assert got == want, seg.kinds[j]
    assert set(mine) == set(ref)


# --- RWKV-6 layer ------------------------------------------------------------
def _rwkv_cache(rng, tcfg, B):
    H, hd, D = tcfg.n_heads, tcfg.head_dim, tcfg.d_model
    return (_randn(rng, B, H, hd, hd), _randn(rng, B, D), _randn(rng, B, D))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("S", [1, 13])
def test_rwkv_time_mix_and_channel_mix_match_reference(impl, S):
    """From a nonzero cache (state and both token shifts), over a prompt
    (S=13, not a multiple of the chunk) and a decode step (S=1)."""
    cfg, _, tcfg, _ = _model("rwkv6-1.6b")
    p_j, p_t = _block("rwkv6-1.6b", "rwkv6")
    p_j, p_t = p_j["rwkv"], p_t["rwkv"]
    rng = np.random.default_rng(20 + S)
    x = _randn(rng, 2, S, cfg.d_model)
    c = _rwkv_cache(rng, tcfg, 2)
    cj = jrwkv6.RWKVCache(*(jnp.asarray(a) for a in c))
    ct = rwkv6.RWKVCache(*(torch.tensor(a) for a in c))
    oj, cj1 = jrwkv6.time_mix(p_j, cfg, jnp.asarray(x), cj)
    ot, ct1 = rwkv6.time_mix(p_t, tcfg.replace(impl=impl), torch.tensor(x),
                             ct)
    _close(oj, ot, 5e-4)
    for a, b in zip(cj1, ct1):
        _close(a, b, 5e-4)
    oj, cj2 = jrwkv6.channel_mix(p_j, cfg, jnp.asarray(x), cj1)
    ot, ct2 = rwkv6.channel_mix(p_t, tcfg, torch.tensor(x), ct1)
    _close(oj, ot, ACT_TOL)
    _close(cj2.x_cm, ct2.x_cm, ACT_TOL)


def test_rwkv_chunked_matches_loop_at_a_prime_length():
    rng = np.random.default_rng(21)
    B, S, H, K = 2, 37, 2, 16
    r, k, v = (torch.tensor(_randn(rng, B, S, H, K)) for _ in range(3))
    lw = -torch.exp(torch.tensor(_randn(rng, B, S, H, K)) - 1.0)
    u = torch.tensor(_randn(rng, H, K)) * 0.1
    S0 = torch.tensor(_randn(rng, B, H, K, K))
    o1, s1 = kref.rwkv6_scan(r, k, v, lw, u, S0)
    o2, s2 = rwkv6._wkv_chunked(r, k, v, lw, u, S0)
    assert float((o1 - o2).abs().max()) < 1e-3
    assert float((s1 - s2).abs().max()) < 1e-3


def test_group_norm_uses_the_population_variance():
    p_j, p_t = _block("rwkv6-1.6b", "rwkv6")
    o = _randn(np.random.default_rng(22), 2, 3, 4, 16)
    _close(jrwkv6._group_norm(p_j["rwkv"], jnp.asarray(o)),
           rwkv6._group_norm(p_t["rwkv"], torch.tensor(o)), 1e-5)


# --- RG-LRU layer ------------------------------------------------------------
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("with_cache", [False, True])
def test_rglru_apply_matches_reference(impl, with_cache):
    cfg, _, tcfg, _ = _model("recurrentgemma-2b")
    p_j, p_t = _block("recurrentgemma-2b", "rglru")
    p_j, p_t = p_j["rglru"], p_t["rglru"]
    rng = np.random.default_rng(23)
    W = tcfg.lru_width
    x = _randn(rng, 2, 19, cfg.d_model)
    cj = ct = None
    if with_cache:
        c = (_randn(rng, 2, W), _randn(rng, 2, tcfg.conv1d_width - 1, W))
        cj = jrglru.RGLRUCache(*(jnp.asarray(a) for a in c))
        ct = rglru.RGLRUCache(*(torch.tensor(a) for a in c))
    oj, cj1 = jrglru.apply(p_j, cfg, jnp.asarray(x), cache=cj)
    ot, ct1 = rglru.apply(p_t, tcfg.replace(impl=impl), torch.tensor(x),
                          cache=ct)
    _close(oj, ot, ACT_TOL)
    _close(cj1.h, ct1.h, ACT_TOL)
    _close(cj1.conv, ct1.conv, ACT_TOL)
    # three decode steps carry (h, conv) from the prefill's cache
    for step in range(3):
        xd = _randn(rng, 2, 1, cfg.d_model)
        oj, cj1 = jrglru.apply_decode(p_j, cfg, jnp.asarray(xd), cj1)
        ot, ct1 = rglru.apply_decode(p_t, tcfg, torch.tensor(xd), ct1)
        _close(oj, ot, ACT_TOL)
        _close(cj1.h, ct1.h, ACT_TOL)


def test_rglru_conv_promotes_bf16_against_fp32_weights():
    """bf16 activations times the fp32 conv weights give an fp32 output,
    as in JAX; the returned conv state keeps the activation dtype."""
    p_j, p_t = _block("recurrentgemma-2b", "rglru")
    x = _randn(np.random.default_rng(24), 2, 6, p_t["rglru"]["conv_b"].shape[0])
    uj, sj = jrglru._conv1d(p_j["rglru"], jnp.asarray(x, jnp.bfloat16))
    ut, st = rglru._conv1d(p_t["rglru"], torch.tensor(x).bfloat16())
    assert ut.dtype == torch.float32 and uj.dtype == jnp.float32
    assert st.dtype == torch.bfloat16 and sj.dtype == jnp.bfloat16
    _close(uj, ut, 1e-5)
    assert np.array_equal(_np(sj), _np(st))


def test_rglru_doubling_scan_matches_loop_and_reference():
    rng = np.random.default_rng(25)
    B, S, W = 2, 45, 32
    a = 1 / (1 + np.exp(-_randn(rng, B, S, W))) * 0.2 + 0.79
    b = _randn(rng, B, S, W) * 0.1
    h0 = _randn(rng, B, W)
    at, bt, ht = (torch.tensor(np.asarray(z, np.float32)) for z in (a, b, h0))
    hs1, hT1 = kref.rglru_scan(at, bt, ht)
    hs2, hT2 = rglru._scan_assoc(at, bt, ht)
    assert float((hs1 - hs2).abs().max()) < 1e-5
    assert float((hT1 - hT2).abs().max()) < 1e-5
    hs_j, _ = jrglru._scan_assoc(*(jnp.asarray(z, jnp.float32)
                                   for z in (a, b, h0)))
    _close(hs_j, hs2, 1e-5)


# --- local attention: windowed prefill and the ring cache -------------------
def test_local_blocked_attention_slices_the_window():
    """S > window + block_q takes the windowed fast path; it matches the
    full-scores reference and the JAX blocked path."""
    rng = np.random.default_rng(26)
    q, k, v = (_randn(rng, 2, 64, 3, 16) for _ in range(3))
    kw = dict(causal=True, window=32, scale=0.25, softcap=None)
    o_b = attention.attend_blocked(*(torch.tensor(a) for a in (q, k, v)),
                                   block_q=16, block_kv=32, **kw)
    o_r = attention.attend_ref(*(torch.tensor(a) for a in (q, k, v)), **kw)
    _close(o_r, o_b, 1e-5)
    o_j = jattn.attend_blocked(*(jnp.asarray(a) for a in (q, k, v)),
                               block_q=16, block_kv=32, **kw)
    _close(o_j, o_b, 1e-5)


@pytest.mark.parametrize("Kv", [1, 2])
def test_expand_kv_gives_a_contiguous_tensor(Kv):
    """recurrentgemma's single kv head too: the flash kernel takes only
    contiguous k/v."""
    k = torch.tensor(_randn(np.random.default_rng(30), 2, 5, Kv, 8))
    kh = attention.expand_kv(k, 4)
    assert kh.shape == (2, 5, 4, 8) and kh.is_contiguous()
    assert torch.equal(kh[:, :, 3], k[:, :, -1])


@pytest.mark.parametrize("S", [20, 45])
def test_local_attention_decode_across_a_ring_wrap(S):
    """Prefill S tokens (S < window and S >= window), then decode until
    the 32-slot ring has wrapped: every step and the ring match JAX."""
    cfg, _, tcfg, _ = _model("recurrentgemma-2b")
    p_j, p_t = _block("recurrentgemma-2b", "local")
    p_j, p_t = p_j["attn"], p_t["attn"]
    rng = np.random.default_rng(27)
    max_len = S + 40
    x = _randn(rng, 2, S, cfg.d_model)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    ang_j = jlm._angles(cfg, jnp.asarray(pos))
    ang_t = lm._angles(tcfg, torch.tensor(pos))
    oj, (kj, vj) = jattn.apply(p_j, cfg, jnp.asarray(x), kind="local",
                               angles=ang_j)
    ot, (kt, vt) = attention.apply(p_t, tcfg, torch.tensor(x), kind="local",
                                   angles=ang_t)
    _close(oj, ot, ACT_TOL)
    cj = jattn.cache_from_prefill(kj, vj, cfg.sliding_window, max_len)
    ct = attention.cache_from_prefill(kt, vt, tcfg.sliding_window, max_len)
    assert ct.k.shape[1] == cfg.sliding_window
    _close(cj.k, ct.k, ACT_TOL)
    for t in range(S, S + 40):
        xd = _randn(rng, 2, 1, cfg.d_model)
        pd = np.full((2, 1), t, np.int32)
        oj, cj = jattn.apply_decode(p_j, cfg, jnp.asarray(xd), cj, t,
                                    kind="local",
                                    angles=jlm._angles(cfg, jnp.asarray(pd)))
        ot, ct = attention.apply_decode(p_t, tcfg, torch.tensor(xd), ct, t,
                                        kind="local",
                                        angles=lm._angles(tcfg,
                                                          torch.tensor(pd)))
        _close(oj, ot, ACT_TOL)
    _close(cj.k, ct.k, ACT_TOL)
    _close(cj.v, ct.v, ACT_TOL)


# --- the whole model: prefill + greedy decode against the dense oracle ------
def _prompts(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        2, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_decode_match_dense_oracle(arch, impl):
    """The reference's dense oracle (``steps.make_prefill_step`` /
    ``make_serve_step``) and the port on the same prompts: first-token
    and every decode step's logits within 1e-4, identical tokens.  The
    prompt (40) is longer than recurrentgemma's 32-token window."""
    cfg, params, tcfg, tparams = _model(arch)
    tcfg = tcfg.replace(impl=impl)
    S, gen = 40, 8
    toks = _prompts(cfg, 2, S, 28)
    pre_j = jsteps.make_prefill_step(cfg, max_len=S + gen)
    serve_j = jsteps.make_serve_step(cfg)
    pre_t = steps.make_prefill_step(tcfg, max_len=S + gen)
    serve_t = steps.make_serve_step(tcfg)
    lj, cj = pre_j(params, jnp.asarray(toks))
    lt, ct = pre_t(tparams, torch.tensor(toks))
    _close(lj, lt, LOGIT_TOL)
    tj = jnp.argmax(lj, -1).astype(jnp.int32)
    tt = lt.argmax(-1).to(torch.int32)
    for i in range(gen - 1):
        assert np.array_equal(np.asarray(tj), tt.numpy()), i
        tj, lj, cj = serve_j(params, tj, cj, jnp.int32(S + i))
        tt, lt, ct = serve_t(tparams, tt, ct, S + i)
        _close(lj, lt, LOGIT_TOL)
    assert np.array_equal(np.asarray(tj), tt.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_two_sees_step_one_state(arch):
    """``decode_step`` returns new recurrent states and leaves the caches
    it was given untouched; step two run on step one's caches matches
    the reference, and run on the prefill's caches it does not."""
    cfg, params, tcfg, tparams = _model(arch)
    S = 12
    toks = _prompts(cfg, 2, S, 29)
    _, c0 = lm.prefill(tparams, tcfg, torch.tensor(toks), max_len=S + 4)
    _, cj = jlm.prefill(params, cfg, jnp.asarray(toks), max_len=S + 4)
    rec0 = [t.clone() for kind, _, c, _ in lm._layers(tcfg, tparams, c0)
            if kind in ("rglru", "rwkv6") for t in c]
    t1 = np.full((2, 1), 7, np.int32)
    t2 = np.full((2, 1), 11, np.int32)
    _, c1 = lm.decode_step(tparams, tcfg, torch.tensor(t1), c0, S)
    rec_after = [t for kind, _, c, _ in lm._layers(tcfg, tparams, c0)
                 if kind in ("rglru", "rwkv6") for t in c]
    assert rec0 and all(torch.equal(a, b) for a, b in zip(rec0, rec_after))
    l2, _ = lm.decode_step(tparams, tcfg, torch.tensor(t2), c1, S + 1)
    _, cj = jlm.decode_step(params, cfg, jnp.asarray(t1), cj, S)
    l2j, _ = jlm.decode_step(params, cfg, jnp.asarray(t2), cj, S + 1)
    _close(l2j, l2, LOGIT_TOL)
    _, c0b = lm.prefill(tparams, tcfg, torch.tensor(toks), max_len=S + 4)
    l2_stale, _ = lm.decode_step(tparams, tcfg, torch.tensor(t2), c0b, S + 1)
    assert float((l2 - l2_stale).abs().max()) > 1e-3


# --- the dense serving engine and the CLI ------------------------------------
def _args(**kw):
    argv = ["--device", "cpu"]
    for k, v in kw.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    return serve.build_parser().parse_args(argv)


def test_run_dense_matches_paged_engine_on_tiny_100m():
    """Both engines decode greedily and emit the same tokens on the same
    prompts (the reference pins the same in tests/test_serving.py)."""
    from conftest import get_tiny_model
    cfg, params = get_tiny_model()
    tcfg = get_tiny_config("tiny-100m").replace(activation_dtype="float32")
    tparams = from_reference(jax.tree.map(np.asarray, params), tcfg, "cpu")
    args = _args(requests=5, batch=2, prompt_len=11, gen=6)
    dense, stats = serve.run_dense(args, tcfg, params=tparams, device="cpu")
    paged, _, _ = serve.run_paged(args, tcfg, params=tparams, device="cpu")
    assert dense == paged
    assert sorted(dense) == list(range(5))
    assert all(len(t) == 6 for t in dense.values())
    assert stats["prefills"] == 3 and stats["decode_steps"] == 3 * 5
    assert stats["tokens"] == 30


@pytest.mark.parametrize("arch", ARCHS)
def test_run_dense_pads_the_last_batch_and_matches_the_oracle(arch):
    """Three requests in batches of two: the short last batch is padded
    with its last prompt and every request's tokens equal the reference
    dense oracle's on the same prompt."""
    cfg, params, tcfg, tparams = _model(arch)
    args = _args(requests=3, batch=2, prompt_len=36, gen=5)
    out, stats = serve.run_dense(args, tcfg, params=tparams, device="cpu")
    assert stats["prefills"] == 2 and stats["requests"] == 3
    prompts = serve.make_prompts(3, 36, cfg.vocab_size, 0)
    from conftest import dense_oracle
    assert out == {int(r[1:]): t for r, t in dense_oracle(
        cfg, params, prompts, 5, 36 + 5).items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_dense_runs_the_recurrent_tiny_configs(arch, capsys):
    serve.main(["--arch", arch, "--tiny", "--device", "cpu", "--requests",
                "3", "--prompt-len", "8", "--gen", "4", "--batch", "2"])
    assert f"[dense] {arch}: served 3 requests, 12 tokens" in \
        capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_paged_refuses_recurrent_configs_with_exit_2(arch, capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(["--arch", arch, "--tiny", "--device", "cpu", "--engine",
                    "paged"])
    assert e.value.code == 2
    assert "--engine paged serves global-attention configs only" in \
        capsys.readouterr().err


def test_run_dense_without_device_raises_on_a_host_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.run_dense(_args(), get_tiny_config("rwkv6-1.6b"))
