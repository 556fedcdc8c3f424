"""The port's DeepSeek-V3 family (MLA, shared experts, MTP parameters)
against the JAX reference on the CPU.

Parameters come from the reference's ``lm.init_params`` on the tiny
DeepSeek config (2 layers: one dense, one MoE with 8 routed experts, top-2
sigmoid routing, and one shared expert) and cross into torch through
``repro_torch.weights.from_reference``; every other input is made with
numpy from a seed.  At float32 activations MLA's prefill and decode agree
within 1e-5 and the model's logits within 1e-4, with identical greedy
tokens.  At bf16 activations (the serving dtype) the two sides round at
the same points and differ in summation order only: MLA outputs agree
within 2e-2 abs on O(1) values and the model's logits within 1e-2 of
the largest reference logit.

Routing is discontinuous (see ``tests/test_torch_moe.py``): the model
traces here record their smallest top-2/top-3 router gap and require it
above 1e-5, so that no near-tie decides a token.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import dense_oracle, seeded_prompts
from repro import steps as jsteps
from repro.configs import get_tiny_config as jtiny
from repro.launch import serve as jserve
from repro.models import blocks as jblocks, lm as jlm, mla as jmla
from repro.serving import PagedEngine as JEngine
from repro_torch import steps
from repro_torch.configs import get_tiny_config
from repro_torch.launch import serve
from repro_torch.models import blocks, lm, mla, moe
from repro_torch.serving.engine import PagedEngine
from repro_torch.weights import from_reference, init_params

ARCH = "deepseek-v3-671b"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# fp32: abs; bf16: relative to the largest reference logit (about two
# bf16 units: gemma2's logits reach its softcap of 30)
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
ROUTER_TIE = 1e-5
IMPLS = ("ref", "blocked", "pallas")
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _err(j, t):
    return float(np.abs(_np(j) - _np(t)).max())


def _logit_err(j, t, dtype):
    """max |j - t|, relative to max |j| at bf16 (``LOGIT_TOL``)."""
    return _err(j, t) / (float(np.abs(_np(j)).max())
                         if dtype == "bfloat16" else 1.0)


_MODELS = {}


def _model(dtype="float32"):
    """(reference cfg, reference params, port cfg, port params) at
    ``dtype`` activations; fp32 parameters, as the tiny config has."""
    if dtype not in _MODELS:
        cfg = jtiny(ARCH).replace(activation_dtype=dtype)
        tcfg = get_tiny_config(ARCH).replace(activation_dtype=dtype)
        params = jlm.init_params(jax.random.PRNGKey(0), cfg)
        tparams = from_reference(jax.tree.map(np.asarray, params), tcfg,
                                 "cpu")
        _MODELS[dtype] = (cfg, params, tcfg, tparams)
    return _MODELS[dtype]


def _mla_block(dtype="float32"):
    """The MLA params of the first (dense) layer on both sides."""
    cfg, params, tcfg, tparams = _model(dtype)
    return params["segments"][0][0]["mla"], tparams["segments"][0][0][0]["mla"]


def _angles(cfg, tcfg, B, S, offset=0):
    pos = np.broadcast_to(np.arange(offset, offset + S, dtype=np.int32),
                          (B, S))
    return (jlm._angles(cfg, jnp.asarray(pos)),
            lm._angles(tcfg, torch.tensor(np.ascontiguousarray(pos))))


# --- parameters and the bridge -----------------------------------------------
def test_rotary_width_is_the_rope_head_dim():
    cfg, _, tcfg, _ = _model()
    aj, at = _angles(cfg, tcfg, 2, 5)
    assert at.shape == (2, 5, cfg.mla.qk_rope_head_dim // 2)
    assert _err(aj, at) < 1e-6


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_init_params_has_the_reference_layout(param_dtype):
    """Every leaf's shape and dtype, the MLA, shared-expert and MTP leaves
    included; the reference's init scales of the MLA projections."""
    cfg = jtiny(ARCH).replace(param_dtype=param_dtype)
    tcfg = get_tiny_config(ARCH).replace(param_dtype=param_dtype)
    mine = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    ref = jlm.init_params(jax.random.PRNGKey(0), cfg)
    assert set(mine) == set(ref) == {"embed", "segments", "final_norm",
                                     "head", "mtp"}

    def shapes(tree, torch_side):
        if torch_side:
            return jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]),
                                tree)
        return jax.tree.map(lambda a: (a.shape, str(a.dtype)), tree)

    for seg, seg_p, seg_t in zip(jlm.make_segments(cfg), ref["segments"],
                                 mine["segments"]):
        assert not seg.scanned and seg.kinds == ("mla",)
        assert shapes(seg_t[0][0], True) == shapes(seg_p[0], False)
    assert "shared" in mine["segments"][1][0][0]
    for k in ("mtp", "head", "embed", "final_norm"):
        assert shapes(mine[k], True) == shapes(ref[k], False), k
    q_a = mine["segments"][0][0][0]["mla"]["q_a"].float()
    assert abs(float(q_a.std()) * cfg.d_model ** 0.5 - 1) < 0.1


def test_bridge_round_trip_carries_mla_shared_and_mtp():
    cfg, params, tcfg, tparams = _model()
    ref_np = jax.tree.map(np.asarray, params)
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref_np)[0]:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        node = tparams
        if keys[0] == "segments":      # unscanned: [seg][block] -> [seg][0][j]
            keys = ["segments", keys[1], 0] + keys[2:]
        for k in keys:
            node = node[k]
        assert np.array_equal(node.numpy(), leaf), keys
        n += 1
    names = {tuple(getattr(k, "key", None) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(ref_np)[0]}
    assert any("shared" in p for p in names) and any("mtp" in p for p in names)
    assert n == len(jax.tree.leaves(ref_np))


# --- MLA ---------------------------------------------------------------------
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_apply_matches_reference(impl, dtype):
    """Prefill of 2 x 24 tokens under each impl: the output and the latent
    cache contributions (the normed c_kv, the rotated rope key)."""
    cfg, _, tcfg, _ = _model(dtype)
    pj, pt = _mla_block(dtype)
    x = np.random.default_rng(50).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    aj, at = _angles(cfg, tcfg, 2, 24)
    oj, (cj, kj) = jmla.apply(pj, cfg, jnp.asarray(x, JDT[dtype]), angles=aj,
                              impl=impl)
    ot, (ct, kt) = mla.apply(pt, tcfg.replace(impl=impl),
                             torch.tensor(x).to(TDT[dtype]), angles=at)
    assert ot.dtype == TDT[dtype] and ot.shape == x.shape
    for a, b in ((oj, ot), (cj, ct), (kj, kt)):
        assert _err(a, b) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_apply_decode_matches_reference(dtype):
    """Four absorbed-weight decode steps after a 10-token prefill into a
    16-slot latent cache: outputs and both cache tensors."""
    cfg, _, tcfg, _ = _model(dtype)
    pj, pt = _mla_block(dtype)
    rng = np.random.default_rng(51)
    S, T = 10, 16
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    aj, at = _angles(cfg, tcfg, 2, S)
    _, lat_j = jmla.apply(pj, cfg, jnp.asarray(x, JDT[dtype]), angles=aj)
    _, lat_t = mla.apply(pt, tcfg, torch.tensor(x).to(TDT[dtype]), angles=at)
    cache_j = jmla.cache_from_prefill(*lat_j, T)
    cache_t = mla.cache_from_prefill(*lat_t, T)
    assert cache_t.ckv.shape == (2, T, cfg.mla.kv_lora_rank)
    for i in range(4):
        xs = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        aj, at = _angles(cfg, tcfg, 2, 1, S + i)
        oj, cache_j = jmla.apply_decode(pj, cfg, jnp.asarray(xs, JDT[dtype]),
                                        cache_j, S + i, angles=aj)
        ot, cache_t = mla.apply_decode(pt, tcfg,
                                       torch.tensor(xs).to(TDT[dtype]),
                                       cache_t, S + i, angles=at)
        assert ot.dtype == TDT[dtype]
        assert _err(oj, ot) < TOL[dtype], i
        assert _err(cache_j.ckv, cache_t.ckv) < TOL[dtype]
        assert _err(cache_j.k_rope, cache_t.k_rope) < TOL[dtype]


def test_mla_cache_init_matches_reference():
    cfg, _, tcfg, _ = _model("bfloat16")
    cj = jmla.cache_init(cfg, 3, 7, jnp.bfloat16)
    ct = mla.cache_init(tcfg, 3, 7, torch.bfloat16, "cpu")
    for a, b in zip(cj, ct):
        assert tuple(b.shape) == a.shape and b.dtype == torch.bfloat16
        assert not bool(b.any())


# --- shared experts ----------------------------------------------------------
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shared_expert_moe_block_matches_reference(impl, dtype):
    """The MoE layer's FFN half (routed experts plus the shared expert) on
    the tiny DeepSeek block params; 2 x 9 tokens."""
    cfg, params, tcfg, tparams = _model(dtype)
    pj, pt = params["segments"][1][0], tparams["segments"][1][0][0]
    assert "shared" in pj and "shared" in pt
    x = np.random.default_rng(52).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32)
    oj, _ = jblocks._ffn_part(pj, cfg, jnp.asarray(x, JDT[dtype]))
    ot, _ = blocks._ffn_part(pt, tcfg.replace(impl=impl),
                             torch.tensor(x).to(TDT[dtype]))
    assert _err(oj, ot) < TOL[dtype]
    # the shared expert adds its own FFN: without it the outputs part
    routed = moe.apply(pt["moe"], tcfg.replace(impl=impl),
                       torch.tensor(x).to(TDT[dtype]))[0]
    assert _err(oj, routed) > 10 * TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_apply_and_decode_match_reference(dtype):
    """Both DeepSeek blocks (MLA + dense FFN, MLA + MoE + shared) through
    prefill and two decode steps, the port's pending branch output added
    back: the residual stream and the caches."""
    cfg, params, tcfg, tparams = _model(dtype)
    rng = np.random.default_rng(53)
    S, T = 12, 16
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    aj, at = _angles(cfg, tcfg, 2, S)
    xj, xt = jnp.asarray(x, JDT[dtype]), torch.tensor(x).to(TDT[dtype])
    pend = None
    caches_j, caches_t = [], []
    for si in range(2):
        pj, pt = params["segments"][si][0], tparams["segments"][si][0][0]
        xj, lat_j, _ = jblocks.apply(pj, cfg, "mla", xj, angles=aj,
                                     mode="prefill")
        xt, pend, lat_t, _ = blocks.apply(pt, tcfg, "mla", xt, pend,
                                          angles=at)
        assert _err(xj, xt + pend) < 4 * TOL[dtype], si
        caches_j.append(jblocks.cache_from_prefill(cfg, "mla", lat_j, T))
        caches_t.append(blocks.cache_from_prefill(tcfg, "mla", lat_t, T))
    for i in range(2):
        xs = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        aj, at = _angles(cfg, tcfg, 2, 1, S + i)
        xj, xt, pend = (jnp.asarray(xs, JDT[dtype]),
                        torch.tensor(xs).to(TDT[dtype]), None)
        for si in range(2):
            pj, pt = params["segments"][si][0], tparams["segments"][si][0][0]
            xj, caches_j[si] = jblocks.apply_decode(
                pj, cfg, "mla", xj, caches_j[si], S + i, angles=aj)
            xt, pend, caches_t[si] = blocks.apply_decode(
                pt, tcfg, "mla", xt, pend, caches_t[si], S + i, angles=at)
            assert _err(xj, xt + pend) < 4 * TOL[dtype], (i, si)


# --- the whole model ---------------------------------------------------------
@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_and_greedy_decode_match_reference(impl):
    """The reference's dense prefill/serve steps and the port's on a batch
    of ``seeded_prompts``: first-token and every decode step's logits
    within 1e-4, identical tokens, no router near-tie on the trace."""
    cfg, params, tcfg, tparams = _model()
    tcfg = tcfg.replace(impl=impl)
    S, gen = 20, 6
    toks = np.stack(seeded_prompts(cfg, 3, S))
    pre_j = jsteps.make_prefill_step(cfg, max_len=S + gen)
    serve_j = jsteps.make_serve_step(cfg)
    pre_t = steps.make_prefill_step(tcfg, max_len=S + gen)
    serve_t = steps.make_serve_step(tcfg)
    with moe.record_router_gaps() as gaps:
        lj, cj = pre_j(params, jnp.asarray(toks))
        lt, ct = pre_t(tparams, torch.tensor(toks))
        assert _err(lj, lt) < LOGIT_TOL["float32"]
        tj = jnp.argmax(lj, -1).astype(jnp.int32)
        tt = lt.argmax(-1).to(torch.int32)
        for i in range(gen - 1):
            assert np.array_equal(np.asarray(tj), tt.numpy()), i
            tj, lj, cj = serve_j(params, tj, cj, jnp.int32(S + i))
            tt, lt, ct = serve_t(tparams, tt, ct, S + i)
            assert _err(lj, lt) < LOGIT_TOL["float32"]
        assert np.array_equal(np.asarray(tj), tt.numpy())
    assert len(gaps) == gen and float(torch.cat(gaps).min()) > ROUTER_TIE


def test_bf16_prefill_and_decode_logits_match_reference():
    cfg, params, tcfg, tparams = _model("bfloat16")
    S = 16
    toks = np.stack(seeded_prompts(cfg, 2, S, seed=3))
    lj, cj = jlm.prefill(params, cfg, jnp.asarray(toks), max_len=S + 3)
    lt, ct = lm.prefill(tparams, tcfg.replace(impl="pallas"),
                        torch.tensor(toks), max_len=S + 3)
    assert _logit_err(lj, lt, "bfloat16") < LOGIT_TOL["bfloat16"]
    tok = jnp.argmax(lj, -1).astype(jnp.int32)
    for i in range(2):
        lj, cj = jlm.decode_step(params, cfg, tok, cj, S + i)
        lt, ct = lm.decode_step(tparams, tcfg.replace(impl="pallas"),
                                torch.tensor(np.asarray(tok)), ct, S + i)
        assert _logit_err(lj, lt, "bfloat16") < LOGIT_TOL["bfloat16"], i
        tok = jnp.argmax(lj, -1).astype(jnp.int32)


def test_run_dense_matches_reference_run_dense(monkeypatch):
    """Both dense engines (the CLIs' ``run_dense``) on the same
    ``seeded_prompts``: 5 requests in batches of 2 (the last one padded),
    prompts of 12 and 6 tokens each: the same tokens, and the dense
    oracle's."""
    cfg, params, tcfg, tparams = _model()
    prompts = seeded_prompts(cfg, 5, 12, seed=7)

    def fake(n, length, vocab, *a, **k):
        assert (n, length) == (5, 12)
        return prompts

    monkeypatch.setattr(jserve, "make_prompts", fake)
    monkeypatch.setattr(serve, "make_prompts", fake)
    args = serve.build_parser().parse_args(
        ["--device", "cpu", "--requests", "5", "--batch", "2",
         "--prompt-len", "12", "--gen", "6"])
    ref, _ = jserve.run_dense(args, cfg, None, params=params)
    out, stats = serve.run_dense(args, tcfg.replace(impl="pallas"),
                                 params=tparams, device="cpu")
    assert out == ref
    assert {f"r{k}": v for k, v in out.items()} == dense_oracle(
        cfg, params, prompts, 6, 18)
    assert stats["tokens"] == 30


# --- what the reference refuses ----------------------------------------------
def test_paged_engine_refuses_mla_as_the_reference_does():
    cfg, params, tcfg, tparams = _model()
    assert not lm.paged_decodable(tcfg) and not jlm.paged_decodable(cfg)
    kw = dict(max_batch=2, page_size=4, n_pages=9, max_len=16)
    with pytest.raises(AssertionError, match="paged-decodable"):
        JEngine(cfg, params, **kw)
    with pytest.raises(AssertionError, match="paged-decodable"):
        PagedEngine(tcfg, tparams, device="cpu", **kw)


def test_serve_cli_serves_deepseek_tiny_and_refuses_paged(capsys):
    serve.main(["--arch", ARCH, "--tiny", "--device", "cpu", "--requests",
                "3", "--prompt-len", "8", "--gen", "4", "--batch", "2"])
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        serve.main(["--arch", ARCH, "--tiny", "--device", "cpu", "--engine",
                    "paged"])
    assert e.value.code == 2
    assert "global-attention configs only" in capsys.readouterr().err


def test_mtp_block_matches_reference_block():
    """The MTP module's block is the last segment's kind (MLA + MoE +
    shared experts): bridged, it computes the reference's block."""
    cfg, params, tcfg, tparams = _model()
    x = np.random.default_rng(54).standard_normal(
        (1, 6, cfg.d_model)).astype(np.float32)
    aj, at = _angles(cfg, tcfg, 1, 6)
    oj, _, _ = jblocks.apply(params["mtp"]["block"], cfg, "mla",
                             jnp.asarray(x), angles=aj, mode="prefill")
    xt, pend, _, _ = blocks.apply(tparams["mtp"]["block"], tcfg, "mla",
                                  torch.tensor(x), None, angles=at)
    assert _err(oj, xt + pend) < 4 * TOL["float32"]
    assert tuple(tparams["mtp"]["mtp_proj"].shape) == (2 * cfg.d_model,
                                                      cfg.d_model)


def test_kv_a_norm_takes_a_contiguous_row(monkeypatch):
    """The latent's norm runs on the first kv_lora columns of each
    (kv_lora + rope)-wide row: the port hands the norm a contiguous copy
    (the kernel wrapper takes no row stride)."""
    cfg, _, tcfg, _ = _model()
    _, pt = _mla_block()
    seen = []
    orig = mla.nn.rmsnorm

    def spy(x, scale, eps=1e-6, impl=None):
        seen.append((tuple(x.shape), x.is_contiguous()))
        return orig(x, scale, eps, impl)

    monkeypatch.setattr(mla.nn, "rmsnorm", spy)
    mla._project_kv_latent(pt, tcfg.replace(impl="pallas"),
                           torch.randn(2, 3, cfg.d_model), None)
    assert seen == [((2, 3, cfg.mla.kv_lora_rank), True)]


def test_deepseek_full_config_cuts_as_the_chip_run_does():
    """The chip run's 5-layer cut keeps the 3 dense layers and 2 MoE
    layers, and mtp_depth=0 drops the MTP module."""
    from repro_torch.configs import get_config
    cfg = get_config(ARCH).replace(n_layers=5, mtp_depth=0)
    segs = lm.make_segments(cfg)
    assert [(s.is_moe, s.n_cycles) for s in segs] == [(False, 3), (True, 2)]
    small = dataclasses.replace(get_tiny_config(ARCH), mtp_depth=0)
    assert "mtp" not in init_params(small, device="cpu")
