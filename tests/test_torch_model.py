"""The port's model layers against the JAX reference on the CPU.

Parameters come from the reference's ``lm.init_params`` (the tiny serving
config of ``conftest.get_tiny_model``) and cross into torch through
``repro_torch.weights.from_reference``; every other input is made with
numpy from a seed.  Parity runs at float32 activations; logits agree
within 1e-4 abs, hidden activations within 2e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import get_tiny_model
from repro.models import attention as jattn, lm as jlm, modules as jnn
from repro_torch.configs import get_config, get_tiny_config, list_archs
from repro_torch.models import attention, lm, modules as nn
from repro_torch.weights import from_reference, init_params

LOGIT_TOL = 1e-4
ACT_TOL = 2e-5


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _close(j, t, tol):
    err = float(np.abs(_np(j) - _np(t)).max())
    assert err < tol, err


@pytest.fixture(scope="module")
def model():
    """(reference cfg, reference params, port cfg, port params) at fp32."""
    cfg, params = get_tiny_model()
    cfg = cfg.replace(activation_dtype="float32")
    tcfg = get_tiny_config("tiny-100m").replace(activation_dtype="float32")
    tparams = from_reference(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return cfg, params, tcfg, tparams


def test_configs_match_reference_field_for_field():
    from repro.configs import get_config as jget, get_tiny_config as jtiny
    for name in ("tiny-100m", "qwen3-1.7b"):
        for mine, theirs in ((get_config(name), jget(name)),
                             (get_tiny_config(name), jtiny(name))):
            assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    from repro.configs import list_archs as jlist
    assert list_archs() == jlist()
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


def test_bridge_round_trip(model):
    cfg, params, tcfg, tparams = model
    segs = lm.make_segments(tcfg)
    assert [tuple(s) for s in segs] == [tuple(s) for s in
                                        jlm.make_segments(cfg)]
    ref_np = jax.tree.map(np.asarray, params)
    for seg, seg_p, mine in zip(segs, ref_np["segments"], tparams["segments"]):
        assert len(mine) == seg.n_cycles
        for c in range(seg.n_cycles):
            for j in range(len(seg.kinds)):
                flat_ref = jax.tree_util.tree_flatten_with_path(seg_p[j])[0]
                for path, leaf in flat_ref:
                    node = mine[c][j]
                    for k in path:
                        node = node[k.key]
                    want = leaf[c] if seg.scanned else leaf
                    assert np.array_equal(node.numpy(), want), (c, path)
    assert np.array_equal(tparams["embed"]["embed_table"].numpy(),
                          ref_np["embed"]["embed_table"])


def test_init_params_has_the_reference_layout_and_scales():
    cfg = get_tiny_config("tiny-100m")
    gen = torch.Generator().manual_seed(0)
    mine = init_params(cfg, gen, "cpu")
    from repro.configs import get_tiny_config as jtiny
    ref = jlm.init_params(jax.random.PRNGKey(0), jtiny("tiny-100m"))
    blk = mine["segments"][0][0][0]
    rblk = jax.tree.map(lambda a: a[0], ref["segments"][0][0])
    assert jax.tree.map(np.shape, rblk) == {
        k: {kk: tuple(t.shape) for kk, t in v.items()}
        for k, v in blk.items()}
    # dense_init: std d_in**-0.5; wo/w_down scaled by 1/sqrt(n_layers)
    d = cfg.d_model
    assert abs(float(blk["attn"]["wq"].std()) * d ** 0.5 - 1) < 0.1
    assert abs(float(blk["ffn"]["w_down"].std()) * cfg.d_ff ** 0.5
               * cfg.n_layers ** 0.5 - 1) < 0.1
    assert abs(float(mine["embed"]["embed_table"].std()) - 1) < 0.05


def test_entry_points_refuse_to_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(get_tiny_config("tiny-100m"))


def test_rmsnorm_rope_ffn_match_reference(model):
    cfg, params, tcfg, tparams = model
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    scale = rng.standard_normal(cfg.d_model).astype(np.float32)
    _close(jnn.rmsnorm(jnp.asarray(x), jnp.asarray(scale)),
           nn.rmsnorm(torch.tensor(x), torch.tensor(scale)), ACT_TOL)
    pos = rng.integers(0, 500, (2, 5)).astype(np.int32)
    ang_j = jnn.rope_angles(jnp.asarray(pos), 16, 1e6)
    ang_t = nn.rope_angles(torch.tensor(pos), 16, 1e6)
    _close(ang_j, ang_t, 1e-3)        # angles up to 500 rad
    xh = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    _close(jnn.apply_rope(jnp.asarray(xh), ang_j),
           nn.apply_rope(torch.tensor(xh), ang_t), 1e-4)
    p_ffn = jax.tree.map(lambda a: a[0], params["segments"][0][0]["ffn"])
    _close(jnn.ffn_apply(p_ffn, cfg, jnp.asarray(x)),
           nn.ffn_apply(tparams["segments"][0][0][0]["ffn"], tcfg,
                        torch.tensor(x)), ACT_TOL)
    pos3 = rng.integers(0, 500, (3, 2, 5)).astype(np.int32)   # M-RoPE
    _close(jnn.rope_angles(jnp.asarray(pos3), 16, 1e6, (2, 3, 3)),
           nn.rope_angles(torch.tensor(pos3), 16, 1e6, (2, 3, 3)), 1e-3)


@pytest.mark.parametrize("impl", ["ref", "blocked", "pallas"])
def test_attention_apply_matches_reference(model, impl):
    cfg, params, tcfg, tparams = model
    rng = np.random.default_rng(1)
    S = 48
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    p_j = jax.tree.map(lambda a: a[0], params["segments"][0][0]["attn"])
    o_j, (k_j, v_j) = jattn.apply(
        p_j, cfg.replace(impl=impl), jnp.asarray(x), kind="attn",
        angles=jnn.rope_angles(jnp.asarray(pos), cfg.head_dim,
                               cfg.rope_theta))
    o_t, (k_t, v_t) = attention.apply(
        tparams["segments"][0][0][0]["attn"], tcfg.replace(impl=impl),
        torch.tensor(x), kind="attn",
        angles=nn.rope_angles(torch.tensor(pos), tcfg.head_dim,
                              tcfg.rope_theta))
    _close(o_j, o_t, 1e-4)
    _close(k_j, k_t, 1e-4)
    _close(v_j, v_t, ACT_TOL)


def _prompt(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        2, cfg.vocab_size, (B, S)).astype(np.int32)


def test_prefill_and_dense_decode_match_reference(model):
    cfg, params, tcfg, tparams = model
    S, max_len = 10, 16
    tokens = _prompt(cfg, 2, S, 2)
    lj, cj = jlm.prefill(params, cfg, jnp.asarray(tokens), max_len=max_len)
    lt, ct = lm.prefill(tparams, tcfg, torch.tensor(tokens), max_len=max_len)
    _close(lj, lt, LOGIT_TOL)
    for step in range(3):
        nxt = np.asarray(jnp.argmax(lj, -1), np.int32)
        assert np.array_equal(nxt, lt.argmax(-1).numpy())
        lj, cj = jlm.decode_step(params, cfg, jnp.asarray(nxt), cj, S + step)
        lt, ct = lm.decode_step(tparams, tcfg, torch.tensor(nxt), ct,
                                S + step)
        _close(lj, lt, LOGIT_TOL)


def _paged_setup(cfg, tcfg, params, tparams, S, ps, n_pages, B):
    """Prefill B prompts of length S into fresh pools on both sides."""
    nmax = 4
    bt = (1 + np.arange(B * nmax, dtype=np.int32)).reshape(B, nmax)
    pools_j = jlm.init_paged_caches(cfg, n_pages, ps)
    pools_t = lm.init_paged_caches(tcfg, n_pages, ps, "cpu")
    from repro import steps as jsteps
    from repro_torch import steps
    pre_j = jsteps.make_paged_prefill_step(cfg)
    pre_t = steps.make_paged_prefill_step(tcfg)
    toks = _prompt(cfg, B, S, 3)
    first = []
    for b in range(B):
        lj, pools_j = pre_j(params, jnp.asarray(toks[b:b + 1]), pools_j,
                            jnp.asarray(bt[b]))
        lt, pools_t = pre_t(tparams, torch.tensor(toks[b:b + 1]), pools_t,
                            torch.tensor(bt[b]))
        _close(lj, lt, LOGIT_TOL)
        first.append(int(lt.argmax(-1)[0, 0]))
    return bt, pools_j, pools_t, np.array(first, np.int32)[:, None]


def test_decode_step_paged_matches_reference(model):
    cfg, params, tcfg, tparams = model
    S, ps = 9, 4
    bt, pools_j, pools_t, tok = _paged_setup(cfg, tcfg, params, tparams, S,
                                             ps, 12, 2)
    pos = np.array([S, S], np.int32)
    for _ in range(2):
        lj, pools_j = jlm.decode_step_paged(params, cfg, jnp.asarray(tok),
                                            pools_j, jnp.asarray(bt),
                                            jnp.asarray(pos))
        lt, pools_t = lm.decode_step_paged(tparams, tcfg, torch.tensor(tok),
                                           pools_t, torch.tensor(bt),
                                           torch.tensor(pos))
        _close(lj, lt, LOGIT_TOL)
        tok = lt.argmax(-1).to(torch.int32).numpy()
        pos = pos + 1
    _close(pools_j[0][0].k[1], pools_t[0][1][0].k, ACT_TOL)  # layer 1 pool


@pytest.mark.parametrize("impl", ["blocked", "pallas"])
def test_decode_window_paged_matches_reference(model, impl):
    cfg, params, tcfg, tparams = model
    S, ps, k = 9, 4, 4
    tcfg = tcfg.replace(impl=impl)
    bt, pools_j, pools_t, tok = _paged_setup(cfg, tcfg, params, tparams, S,
                                             ps, 12, 2)
    bt[1] = 0                         # slot 1 inactive: null row, pos 0
    pos = np.array([S, 0], np.int32)
    active = np.array([1, 0], np.int32)
    ej, tj, pj, _ = jlm.decode_window_paged(
        params, cfg, jnp.asarray(tok), pools_j, jnp.asarray(bt),
        jnp.asarray(pos), jnp.asarray(active), k)
    et, tt, pt, _ = lm.decode_window_paged(
        tparams, tcfg, torch.tensor(tok), pools_t, torch.tensor(bt),
        torch.tensor(pos), torch.tensor(active), k)
    assert np.array_equal(np.asarray(ej), et.numpy())
    assert np.array_equal(np.asarray(tj), tt.numpy())
    assert np.array_equal(np.asarray(pj), pt.numpy())
    assert et.dtype == tt.dtype == pt.dtype == torch.int32


# --- the norms after residual adds, fused --------------------------------
FUSION_ARCHS = ("qwen3-1.7b", "rwkv6-1.6b", "recurrentgemma-2b",
                "grok-1-314b")


def _dense_logits(cfg, params, tokens):
    """Logits of a prefill and of one decode step after it."""
    logits, caches = lm.prefill(params, cfg, tokens,
                                max_len=tokens.shape[1] + 2)
    nxt = logits.argmax(-1).to(torch.int32)
    step, _ = lm.decode_step(params, cfg, nxt, caches, tokens.shape[1])
    return logits, step


@pytest.mark.parametrize("arch", FUSION_ARCHS)
def test_norms_after_adds_take_the_fused_wrappers(arch, monkeypatch):
    """Under impl="pallas" every norm that follows a residual add (every
    ln2, every ln1 but the first layer's, the final norm) reaches
    ``ops.add_rmsnorm``, a layer's q and k norms one ``ops.qk_rmsnorm``,
    and only the first ln1 (and post-norms) ``ops.rmsnorm``; a tiny config
    of every served family gives the same logits, bit for bit, with the
    fused wrappers replaced by the separate add and norms."""
    from repro_torch.kernels import ops
    cfg = get_tiny_config(arch).replace(impl="pallas")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.tensor(np.random.default_rng(20).integers(
        0, cfg.vocab_size, (2, 9)), dtype=torch.int32)
    calls = {}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return wrapper

    plain = {n: getattr(ops, n) for n in ("rmsnorm", "add_rmsnorm",
                                          "qk_rmsnorm")}
    for name, fn in plain.items():
        monkeypatch.setattr(ops, name, counted(name, fn))
    fused = _dense_logits(cfg, params, tokens)
    n_attn = sum(k in ("attn", "local") for k in cfg.layer_kinds)
    L = cfg.n_layers
    assert calls == {"rmsnorm": 2 * (1 + 2 * cfg.post_norm * L),
                     "add_rmsnorm": 2 * 2 * L,
                     **({"qk_rmsnorm": 2 * n_attn} if cfg.qk_norm else {})}
    monkeypatch.setattr(ops, "add_rmsnorm", lambda x, d, s, eps=1e-6: (
        x + d, plain["rmsnorm"](x + d, s, eps=eps)))
    monkeypatch.setattr(ops, "qk_rmsnorm", lambda q, k, sq, sk, eps=1e-6: (
        plain["rmsnorm"](q, sq, eps=eps), plain["rmsnorm"](k, sk, eps=eps)))
    unfused = _dense_logits(cfg, params, tokens)
    assert all(torch.equal(a, b) for a, b in zip(fused, unfused))
