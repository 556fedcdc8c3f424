"""The port's remaining model families against the JAX reference on the
CPU: gemma2-27b (local/global attention, softcaps, post-norms), qwen3-14b,
minitron-8b (squared ReLU, no gate), qwen2-vl-7b (embedding inputs, M-RoPE)
and hubert-xlarge (embedding inputs, bidirectional, no rotary), with the
registry of all eleven configs.

Parameters come from the reference's ``lm.init_params`` on the tiny
configs and cross into torch through ``repro_torch.weights.from_reference``;
every other input is made with numpy from a seed.  At float32 activations
logits agree within 1e-4 abs and greedy tokens are identical; at bf16
activations (the serving dtype) the logits agree within 1e-2 of the
largest reference logit: both sides round at the same points and differ
in summation order (and, under ``jax.jit``, in XLA's fusions) only.
gemma2's tiny window is 32 tokens, so the 40-token prompts here wrap its
local layers' ring caches.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import dense_oracle, seeded_prompts
from repro import steps as jsteps
from repro.configs import get_config as jget, get_tiny_config as jtiny
from repro.configs import list_archs as jlist
from repro.launch import serve as jserve
from repro.models import lm as jlm, modules as jnn
from repro.serving import PagedEngine as JEngine
from repro_torch import steps
from repro_torch.configs import get_config, get_tiny_config, list_archs
from repro_torch.launch import serve
from repro_torch.models import lm, modules as nn
from repro_torch.serving.engine import PagedEngine
from repro_torch.weights import from_reference, init_params

NEW_ARCHS = ("qwen3-14b", "minitron-8b", "gemma2-27b", "qwen2-vl-7b",
             "deepseek-v3-671b", "hubert-xlarge")
# fp32: abs; bf16: relative to the largest reference logit (about two
# bf16 units: gemma2's logits reach its softcap of 30)
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
IMPLS = ("ref", "blocked", "pallas")
PAGED_ARCHS = ("qwen3-14b", "minitron-8b")
REFUSED_PAGED = ("gemma2-27b", "qwen2-vl-7b", "deepseek-v3-671b",
                 "hubert-xlarge")


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


def _model(arch, dtype="float32"):
    """(reference cfg, reference params, port cfg, port params)."""
    if (arch, dtype) not in _MODELS:
        cfg = jtiny(arch).replace(activation_dtype=dtype)
        tcfg = get_tiny_config(arch).replace(activation_dtype=dtype)
        params = jlm.init_params(jax.random.PRNGKey(0), cfg)
        tparams = from_reference(jax.tree.map(np.asarray, params), tcfg,
                                 "cpu")
        _MODELS[arch, dtype] = (cfg, params, tcfg, tparams)
    return _MODELS[arch, dtype]


def _vl_positions(B, S):
    """Text-like 3-D M-RoPE ids: 8 text tokens, a 4x4 grid of image
    patches at one temporal id, then text again from the next id on."""
    pos = np.zeros((3, B, S), np.int32)
    pos[:, :, :8] = np.arange(8)
    hh, ww = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
    pos[0, :, 8:24] = 8
    pos[1, :, 8:24] = 8 + hh.reshape(-1)
    pos[2, :, 8:24] = 8 + ww.reshape(-1)
    pos[:, :, 24:] = 12 + np.arange(S - 24)
    return pos


# --- the registry ------------------------------------------------------------
def test_every_reference_arch_is_registered():
    assert list_archs() == jlist()
    with pytest.raises(KeyError, match="unknown arch"):
        get_tiny_config("no-such-arch")


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_matches_reference_field_for_field(arch):
    for mine, theirs in ((get_config(arch), jget(arch)),
                         (get_tiny_config(arch), jtiny(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.n_params() == theirs.n_params()


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_init_params_has_the_reference_layout(arch):
    """Every leaf's shape and dtype: no embedding table for the embedding-
    input configs (an untied head instead), tied gemma2 without a head."""
    cfg = jtiny(arch)
    mine = init_params(get_tiny_config(arch),
                       torch.Generator().manual_seed(0), "cpu")
    ref = jlm.init_params(jax.random.PRNGKey(0), cfg)
    assert set(mine) == set(ref)
    assert ("embed" in mine) == cfg.embed_inputs
    for seg, seg_p, seg_t in zip(jlm.make_segments(cfg), ref["segments"],
                                 mine["segments"]):
        assert len(seg_t) == seg.n_cycles
        for j in range(len(seg.kinds)):
            rblk = seg_p[j]
            if seg.scanned:
                rblk = jax.tree.map(lambda a: a[0], rblk)
            want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), rblk)
            got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]),
                               seg_t[0][j])
            assert got == want, seg.kinds[j]


# --- M-RoPE and the embedding inputs -----------------------------------------
@pytest.mark.parametrize("sections,head_dim", [((16, 24, 24), 128),
                                               ((4, 2, 2), 16)])
def test_mrope_angles_match_reference(sections, head_dim):
    pos = np.random.default_rng(60).integers(0, 5000, (3, 2, 11)).astype(
        np.int32)
    aj = jnn.rope_angles(jnp.asarray(pos), head_dim, 1e6, sections)
    at = nn.rope_angles(torch.tensor(pos), head_dim, 1e6, sections)
    assert at.shape == (2, 11, head_dim // 2)
    assert _err(aj, at) < 1e-6 * 5000


def test_default_positions_match_reference():
    for arch in ("qwen2-vl-7b", "qwen3-14b"):
        cfg = jtiny(arch)
        pj = jlm.default_positions(cfg, 2, 7)
        pt = lm.default_positions(get_tiny_config(arch), 2, 7)
        assert tuple(pt.shape) == pj.shape
        assert np.array_equal(np.asarray(pj), pt.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qwen2_vl_prefill_and_decode_match_reference(dtype):
    """Prefill of 2 x 40 embeddings at text-like 3-D positions, then four
    decode steps of embeddings (every plane at the step's position)."""
    cfg, params, tcfg, tparams = _model("qwen2-vl-7b", dtype)
    rng = np.random.default_rng(61)
    S = 40
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    pos = _vl_positions(2, S)
    lj, cj = jlm.prefill(params, cfg, jnp.asarray(x), max_len=S + 4,
                         positions=jnp.asarray(pos))
    lt, ct = lm.prefill(tparams, tcfg.replace(impl="pallas"),
                        torch.tensor(x), max_len=S + 4,
                        positions=torch.tensor(pos))
    assert lt.shape == (2, 1, cfg.vocab_size)
    assert _logit_err(lj, lt, dtype) < LOGIT_TOL[dtype]
    # the positions reach the model: the default ramp gives other logits
    lt_ramp, _ = lm.prefill(tparams, tcfg, torch.tensor(x), max_len=S + 4)
    assert _logit_err(lj, lt_ramp, dtype) > 2 * LOGIT_TOL[dtype]
    for i in range(4):
        e = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        lj, cj = jlm.decode_step(params, cfg, jnp.asarray(e), cj, S + i)
        lt, ct = lm.decode_step(tparams, tcfg.replace(impl="pallas"),
                                torch.tensor(e), ct, S + i)
        assert _logit_err(lj, lt, dtype) < LOGIT_TOL[dtype], i


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hubert_forward_logits_match_reference(impl, dtype):
    """Bidirectional forward of 2 x 48 frame embeddings: the logits of
    every position (the final norm, then the untied head)."""
    cfg, params, tcfg, tparams = _model("hubert-xlarge", dtype)
    x = np.random.default_rng(62).standard_normal(
        (2, 48, cfg.d_model)).astype(np.float32)
    h, _, _ = jlm.forward(params, cfg, jnp.asarray(x), mode="prefill",
                          impl=impl)
    lj = jlm.head_logits(params, cfg, jnn.rmsnorm(
        h, params["final_norm"]["scale"], cfg.norm_eps))
    c = tcfg.replace(impl=impl)
    xt, pend, _ = lm.forward(tparams, c, torch.tensor(x))
    lt = lm.head_logits(tparams, c, lm.final_norm(tparams, c, xt, pend))
    assert lt.shape == (2, 48, cfg.vocab_size)
    assert _logit_err(lj, lt, dtype) < LOGIT_TOL[dtype]


# --- decoding families through the dense engine ------------------------------
@pytest.mark.parametrize("arch", ["gemma2-27b", "qwen3-14b", "minitron-8b"])
@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_and_greedy_decode_match_reference(arch, impl):
    """The reference's dense prefill/serve steps and the port's on 2
    ``seeded_prompts`` of 40 tokens (past gemma2's 32-token window):
    first-token and every decode step's logits within 1e-4, identical
    tokens."""
    cfg, params, tcfg, tparams = _model(arch)
    tcfg = tcfg.replace(impl=impl)
    S, gen = 40, 6
    toks = np.stack(seeded_prompts(cfg, 2, S))
    pre_j = jsteps.make_prefill_step(cfg, max_len=S + gen)
    serve_j = jsteps.make_serve_step(cfg)
    pre_t = steps.make_prefill_step(tcfg, max_len=S + gen)
    serve_t = steps.make_serve_step(tcfg)
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


@pytest.mark.parametrize("arch", ["gemma2-27b", "qwen3-14b", "minitron-8b"])
def test_bf16_prefill_and_decode_logits_match_reference(arch):
    cfg, params, tcfg, tparams = _model(arch, "bfloat16")
    tcfg = tcfg.replace(impl="pallas")
    S = 40
    toks = np.stack(seeded_prompts(cfg, 2, S, seed=3))
    pre = jax.jit(lambda p, t: jlm.prefill(p, cfg, t, max_len=S + 3))
    dec = jax.jit(lambda p, t, c, i: jlm.decode_step(p, cfg, t, c, i))
    lj, cj = pre(params, jnp.asarray(toks))
    lt, ct = lm.prefill(tparams, tcfg, torch.tensor(toks), max_len=S + 3)
    assert _logit_err(lj, lt, "bfloat16") < LOGIT_TOL["bfloat16"]
    tok = jnp.argmax(lj, -1).astype(jnp.int32)
    for i in range(2):
        lj, cj = dec(params, tok, cj, S + i)
        lt, ct = lm.decode_step(tparams, tcfg, torch.tensor(np.asarray(tok)),
                                ct, S + i)
        assert _logit_err(lj, lt, "bfloat16") < LOGIT_TOL["bfloat16"], i
        tok = jnp.argmax(lj, -1).astype(jnp.int32)


@pytest.mark.parametrize("arch", ["gemma2-27b", "qwen3-14b", "minitron-8b"])
def test_run_dense_matches_reference_run_dense(arch, monkeypatch):
    """Both dense engines (the CLIs' ``run_dense``) on the same
    ``seeded_prompts``: 3 requests of 40 tokens in batches of 2 (the last
    one padded), 5 tokens each; the same tokens, and the dense oracle's."""
    cfg, params, tcfg, tparams = _model(arch)
    prompts = seeded_prompts(cfg, 3, 40, seed=5)

    def fake(n, length, vocab, *a, **k):
        assert (n, length) == (3, 40)
        return prompts

    monkeypatch.setattr(jserve, "make_prompts", fake)
    monkeypatch.setattr(serve, "make_prompts", fake)
    args = serve.build_parser().parse_args(
        ["--device", "cpu", "--requests", "3", "--batch", "2",
         "--prompt-len", "40", "--gen", "5"])
    ref, _ = jserve.run_dense(args, cfg, None, params=params)
    out, _ = serve.run_dense(args, tcfg.replace(impl="pallas"),
                             params=tparams, device="cpu")
    assert out == ref
    assert {f"r{k}": v for k, v in out.items()} == dense_oracle(
        cfg, params, prompts, 5, 45)


# --- the paged engine --------------------------------------------------------
@pytest.mark.parametrize("arch", PAGED_ARCHS)
@pytest.mark.parametrize("fused", [True, False])
def test_paged_engine_matches_reference_engine(arch, fused):
    """The port's PagedEngine and the reference's on ``seeded_prompts``,
    fp32, with the tight pool of the serving tests: identical tokens, and
    both equal to the dense oracle."""
    cfg, params, tcfg, tparams = _model(arch)
    S, gens = 12, [6, 3, 6, 5]
    max_len = S + max(gens)
    prompts = seeded_prompts(cfg, len(gens), S)
    kw = dict(max_batch=3, page_size=4, n_pages=14, max_len=max_len,
              prefill_budget=0.0, fused=fused, max_window=8)
    out = {}
    for name, eng in (("port", PagedEngine(tcfg.replace(impl="pallas"),
                                           tparams, device="cpu", **kw)),
                      ("ref", JEngine(cfg, params, **kw))):
        for i, (p, g) in enumerate(zip(prompts, gens)):
            eng.submit(np.asarray(p), g, rid=f"r{i}")
        out[name] = {r.rid: list(r.tokens) for r in eng.run()}
    assert out["port"] == out["ref"] == dense_oracle(cfg, params, prompts,
                                                     gens, max_len)


@pytest.mark.parametrize("arch", REFUSED_PAGED)
def test_paged_engine_refuses_what_the_reference_refuses(arch):
    cfg, params, tcfg, tparams = _model(arch)
    assert not lm.paged_decodable(tcfg) and not jlm.paged_decodable(cfg)
    kw = dict(max_batch=2, page_size=4, n_pages=9, max_len=16)
    with pytest.raises(AssertionError, match="paged-decodable"):
        JEngine(cfg, params, **kw)
    with pytest.raises(AssertionError, match="paged-decodable"):
        PagedEngine(tcfg, tparams, device="cpu", **kw)


# --- the serve CLI -----------------------------------------------------------
@pytest.mark.parametrize("arch", ["gemma2-27b", "qwen3-14b", "minitron-8b"])
def test_serve_cli_serves_dense(arch, capsys):
    serve.main(["--arch", arch, "--tiny", "--device", "cpu", "--requests",
                "3", "--prompt-len", "36", "--gen", "4", "--batch", "2"])
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", PAGED_ARCHS)
def test_serve_cli_serves_paged(arch, capsys):
    serve.main(["--arch", arch, "--tiny", "--device", "cpu", "--engine",
                "paged", "--requests", "3", "--prompt-len", "8", "--gen",
                "4", "--batch", "2"])
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out


def test_serve_cli_refuses_gemma2_paged(capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(["--arch", "gemma2-27b", "--tiny", "--device", "cpu",
                    "--engine", "paged"])
    assert e.value.code == 2
    assert "global-attention configs only" in capsys.readouterr().err


def test_serve_cli_refuses_the_encoder_as_the_reference_does(monkeypatch,
                                                             capsys):
    """hubert has nothing to decode: the reference CLI asserts, the
    port's exits with code 2."""
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "hubert-xlarge",
                                     "--tiny"])
    with pytest.raises(AssertionError, match="encoder-only"):
        jserve.main()
    with pytest.raises(SystemExit) as e:
        serve.main(["--arch", "hubert-xlarge", "--tiny", "--device", "cpu"])
    assert e.value.code == 2
    assert "encoder-only" in capsys.readouterr().err


def test_serve_cli_refuses_embedding_inputs(capsys):
    """qwen2-vl takes embeddings and 3-D positions, which the CLI's token
    prompts cannot give: the port exits with code 2 (the reference's CLI
    builds no such inputs either)."""
    with pytest.raises(SystemExit) as e:
        serve.main(["--arch", "qwen2-vl-7b", "--tiny", "--device", "cpu"])
    assert e.value.code == 2
    assert "embeddings" in capsys.readouterr().err
