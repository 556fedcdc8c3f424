"""The port's MoE family (grok-1) against the JAX reference on the CPU.

Parameters come from the reference's ``lm.init_params`` on the tiny grok
config and cross into torch through ``repro_torch.weights.from_reference``;
every other input is made with numpy from a seed.  Parity runs at float32
activations: logits within 1e-4 abs, identical greedy tokens, MoE layer
outputs within 1e-5.  With bf16 activations (the serving dtype) the MoE
layer agrees within 2e-2 abs on O(1) outputs: both sides round the
gathered tokens and the hidden h to bf16 at the same points, and differ in
fp32 summation order only.  The combine of the weighted expert rows adds
in the reference's order and equals its scatter bit for bit.

Routing is discontinuous: a near-tie between the top_k-th and the next
router score can send a token to another expert on one side only, and
``torch.topk`` does not promise ``jax.lax.top_k``'s lower-index-first
order between equal scores.  The traces here (numpy seeds 40 to 44, the
tiny grok params of ``PRNGKey(0)``, ``conftest.seeded_prompts`` seeds 0)
have no such near-tie: ``test_prefill_and_greedy_decode_match_dense_oracle``
records the smallest gap it sees and requires it above 1e-5.
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
from repro.models import lm as jlm, moe as jmoe
from repro.serving import PagedEngine as JEngine
from repro_torch import steps
from repro_torch.configs import get_config, get_tiny_config
from repro_torch.launch import serve
from repro_torch.models import lm, moe
from repro_torch.serving.engine import PagedEngine
from repro_torch.weights import from_reference, init_params

ARCH = "grok-1-314b"
LOGIT_TOL = 1e-4
MOE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
IMPLS = ("ref", "blocked", "pallas")
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _err(j, t):
    return float(np.abs(_np(j) - _np(t)).max())


_MODEL = {}


def _model():
    """(reference cfg, reference params, port cfg, port params), fp32."""
    if not _MODEL:
        cfg = jtiny(ARCH).replace(activation_dtype="float32")
        tcfg = get_tiny_config(ARCH).replace(activation_dtype="float32")
        params = jlm.init_params(jax.random.PRNGKey(0), cfg)
        tparams = from_reference(jax.tree.map(np.asarray, params), tcfg,
                                 "cpu")
        _MODEL.update(m=(cfg, params, tcfg, tparams))
    return _MODEL["m"]


def _moe_params(rng, cfg):
    """Expert and router weights of ``cfg`` (fp32), numpy."""
    m, d = cfg.moe, cfg.d_model
    E, fe = m.n_experts, m.d_ff_expert
    return dict(router_w=rng.standard_normal((d, E)).astype(np.float32),
                e_gate=(rng.standard_normal((E, d, fe)) * d ** -0.5
                        ).astype(np.float32),
                e_up=(rng.standard_normal((E, d, fe)) * d ** -0.5
                      ).astype(np.float32),
                e_down=(rng.standard_normal((E, fe, d)) * fe ** -0.5
                        ).astype(np.float32))


# --- config, routing and dispatch -------------------------------------------
def test_grok_config_matches_reference_field_for_field():
    for mine, theirs in ((get_config(ARCH), jget(ARCH)),
                         (get_tiny_config(ARCH), jtiny(ARCH))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)


@pytest.mark.parametrize("score_func", ["softmax", "sigmoid"])
def test_route_matches_reference(score_func):
    cfg = jtiny(ARCH)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, score_func=score_func))
    rng = np.random.default_rng(40)
    tokens = rng.standard_normal((37, cfg.d_model)).astype(np.float32)
    router_w = rng.standard_normal((cfg.d_model, cfg.moe.n_experts)
                                   ).astype(np.float32)
    wj, idj, auxj = jmoe.route(cfg, jnp.asarray(router_w), jnp.asarray(tokens))
    wt, idt, auxt = moe.route(cfg, torch.tensor(router_w),
                              torch.tensor(tokens))
    assert np.array_equal(np.asarray(idj), idt.numpy())
    assert _err(wj, wt) < 1e-6 and _err(auxj, auxt) < 1e-6


@pytest.mark.parametrize("n_tokens", [1, 7, 8, 100, 4096])
def test_capacity_and_group_count_match_reference(n_tokens):
    cfg = jget(ARCH)
    C = moe.capacity(cfg, n_tokens)
    assert C == jmoe.capacity(cfg, n_tokens)
    assert moe._group_count(8, C, 6144) == jmoe._group_count(8, C, 6144)


@pytest.mark.parametrize("C", [8, 16, 40])
def test_dispatch_indices_match_reference_with_drops(C):
    """T=40 tokens top-2 over 4 experts: 80 assignments, about 20 per
    expert, so C=8 and 16 drop tokens and C=40 drops none."""
    rng = np.random.default_rng(41)
    T, k, E = 40, 2, 4
    ids = np.stack([rng.choice(E, k, replace=False) for _ in range(T)])
    st_j, slot_j = jmoe.dispatch_indices(jnp.asarray(ids, jnp.int32), T, k, E,
                                         C)
    st_t, slot_t = moe.dispatch_indices(torch.tensor(ids), T, k, E, C)
    assert np.array_equal(np.asarray(st_j), st_t.numpy())
    assert np.array_equal(np.asarray(slot_j), slot_t.numpy())
    dropped = int((slot_t == E * C).sum())
    assert (dropped > 0) == (C < 40)


@pytest.mark.parametrize("groups", [1, 2, 8])
@pytest.mark.parametrize("top_k", [2, 8])
def test_combine_is_the_reference_scatter_bit_for_bit(top_k, groups):
    """The fixed-order combine against the reference's ``out.at[st].add(y
    * sw, mode="drop")`` over its groups in order, on the tiny DeepSeek's
    8 experts at top-2 and top-8 with dropped tokens (C=8 of about 10 an
    expert at top-2, of 40 at top-8): one group (``moe.combine``'s
    gather) and 2 or 8 groups (``moe.add_group``, one ``index_add_`` an
    expert), equal bit for bit."""
    rng = np.random.default_rng(45)
    T, E, C, D = 40, 8, 8, 16
    ids = np.stack([rng.choice(E, top_k, replace=False) for _ in range(T)])
    w = rng.random((T, top_k)).astype(np.float32)
    y = rng.standard_normal((E * C, D)).astype(np.float32)
    st_j, slot_j = jmoe.dispatch_indices(jnp.asarray(ids, jnp.int32), T,
                                         top_k, E, C)
    sw_j = jnp.zeros((E * C,), jnp.bfloat16).at[slot_j].set(
        jnp.asarray(w.reshape(-1), jnp.bfloat16), mode="drop")
    yw_j = (jnp.asarray(y) * sw_j[:, None]).astype(jnp.float32)
    rows = E * C // groups
    want = jnp.zeros((T + 1, D), jnp.float32)
    for g in range(groups):
        want = want.at[st_j[g * rows:(g + 1) * rows]].add(
            yw_j[g * rows:(g + 1) * rows], mode="drop")

    st, slot = moe.dispatch_indices(torch.tensor(ids), T, top_k, E, C)
    sw = torch.zeros(E * C + 1, dtype=torch.bfloat16).scatter_(
        0, slot, torch.tensor(w.reshape(-1)).bfloat16())[:E * C]
    ss = slot.view(T, top_k).sort(dim=1).values
    assert int((slot == E * C).sum()) > 0
    yt = torch.tensor(y)
    if groups == 1:
        got = moe.combine(yt, sw, ss)
    else:
        got = torch.zeros((T + 1, D))
        for g in range(groups):
            r = slice(g * rows, (g + 1) * rows)
            got = moe.add_group(got, st[r], yt[r] * sw[r, None], C)
        got = got[:T]
    assert np.array_equal(np.asarray(want[:T]), got.numpy())


# --- the MoE layer -----------------------------------------------------------
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_local_moe_matches_reference(impl, dtype, capacity_factor):
    """``local_moe`` on 30 tokens, with and without dropped tokens (a
    capacity factor of 0.5 fills each expert's slots at about half the
    assignments); fp32 parameters against ``dtype`` activations, as the
    tiny config runs them."""
    cfg = jtiny(ARCH)
    cfg = cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))
    tcfg = get_tiny_config(ARCH).replace(moe=cfg.moe, impl=impl)
    rng = np.random.default_rng(42)
    x = rng.standard_normal((30, cfg.d_model)).astype(np.float32)
    p = _moe_params(rng, cfg)
    names = ("router_w", "e_gate", "e_up", "e_down")
    oj, auxj = jmoe.local_moe(cfg, jnp.asarray(x, JDT[dtype]),
                              *(jnp.asarray(p[n]) for n in names))
    ot, auxt = moe.local_moe(tcfg, torch.tensor(x).to(TDT[dtype]),
                             *(torch.tensor(p[n]) for n in names))
    assert ot.dtype == TDT[dtype] and ot.shape == x.shape
    assert _err(oj, ot) < MOE_TOL[dtype]
    assert _err(auxj, auxt) < 1e-6


@pytest.mark.parametrize("impl", IMPLS)
def test_moe_apply_matches_reference_on_the_block_params(impl):
    cfg, params, tcfg, tparams = _model()
    p_j = jax.tree.map(lambda a: a[0], params["segments"][0][0]["moe"])
    p_t = tparams["segments"][0][0][0]["moe"]
    x = np.random.default_rng(43).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32)
    oj, auxj = jmoe.apply(p_j, cfg, jnp.asarray(x))
    ot, auxt = moe.apply(p_t, tcfg.replace(impl=impl), torch.tensor(x))
    assert _err(oj, ot) < MOE_TOL["float32"]
    assert _err(auxj, auxt) < 1e-6


# --- parameters --------------------------------------------------------------
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_init_params_has_the_reference_moe_layout(param_dtype):
    """Shapes and dtypes of every leaf, the MoE block's included: the
    router in fp32, the experts in ``param_dtype``."""
    cfg = jtiny(ARCH).replace(param_dtype=param_dtype)
    mine = init_params(get_tiny_config(ARCH).replace(param_dtype=param_dtype),
                       torch.Generator().manual_seed(0), "cpu")
    ref = jlm.init_params(jax.random.PRNGKey(0), cfg)
    for seg, seg_p, seg_t in zip(jlm.make_segments(cfg), ref["segments"],
                                 mine["segments"]):
        assert seg.is_moe and seg.scanned
        for c in range(seg.n_cycles):
            rblk = jax.tree.map(lambda a: a[c], seg_p[0])
            want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), rblk)
            got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]),
                               seg_t[c][0])
            assert got == want
    assert set(mine) == set(ref)
    m = mine["segments"][0][0][0]["moe"]
    d, fe = cfg.d_model, cfg.moe.d_ff_expert
    # the reference's init scales: d**-0.5 in, fe**-0.5 / sqrt(L) out
    assert abs(float(m["e_up"].float().std()) * d ** 0.5 - 1) < 0.1
    assert abs(float(m["e_down"].float().std()) * fe ** 0.5
               * cfg.n_layers ** 0.5 - 1) < 0.1


def test_bridge_carries_the_moe_subtree():
    cfg, params, tcfg, tparams = _model()
    ref_np = jax.tree.map(np.asarray, params)
    segs = lm.make_segments(tcfg)
    for seg, seg_p, mine in zip(segs, ref_np["segments"],
                                tparams["segments"]):
        for c in range(seg.n_cycles):
            for name, leaf in seg_p[0]["moe"].items():
                assert np.array_equal(mine[c][0]["moe"][name].numpy(),
                                      leaf[c]), (c, name)


# --- the whole model through both engines ------------------------------------
def test_router_gap_and_its_recording():
    """``router_gap`` is the top_k-th minus the next router score of each
    token (numpy on the reference's scores); ``record_router_gaps``
    records one (B*S,) gap per MoE layer of a prefill, and nothing
    outside its block."""
    cfg, params, tcfg, tparams = _model()
    rng = np.random.default_rng(45)
    tokens = rng.standard_normal((11, cfg.d_model)).astype(np.float32)
    router_w = rng.standard_normal((cfg.d_model, cfg.moe.n_experts)
                                   ).astype(np.float32)
    scores = np.asarray(jax.nn.softmax(jnp.asarray(tokens @ router_w), -1))
    top = -np.sort(-scores, -1)
    want = top[:, cfg.moe.top_k - 1] - top[:, cfg.moe.top_k]
    got = moe.router_gap(tcfg, torch.tensor(router_w), torch.tensor(tokens))
    assert got.shape == (11,) and np.abs(got.numpy() - want).max() < 1e-6
    toks = torch.tensor(rng.integers(2, cfg.vocab_size, (2, 5),
                                     dtype=np.int32))
    with moe.record_router_gaps() as gaps:
        steps.make_prefill_step(tcfg, max_len=8)(tparams, toks)
    assert [g.shape for g in gaps] == [(10,)] * tcfg.n_layers
    steps.make_prefill_step(tcfg, max_len=8)(tparams, toks)
    assert len(gaps) == tcfg.n_layers and not moe._GAP_LOGS


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_and_greedy_decode_match_dense_oracle(impl):
    """The reference's dense prefill/serve steps and the port's on the same
    prompts (numpy seed 44): first-token and every decode step's logits
    within 1e-4, identical tokens, and no router near-tie on the trace."""
    cfg, params, tcfg, tparams = _model()
    tcfg = tcfg.replace(impl=impl)
    S, gen = 20, 6
    toks = np.random.default_rng(44).integers(
        2, cfg.vocab_size, (2, S)).astype(np.int32)
    pre_j = jsteps.make_prefill_step(cfg, max_len=S + gen)
    serve_j = jsteps.make_serve_step(cfg)
    pre_t = steps.make_prefill_step(tcfg, max_len=S + gen)
    serve_t = steps.make_serve_step(tcfg)
    with moe.record_router_gaps() as gaps:
        lj, cj = pre_j(params, jnp.asarray(toks))
        lt, ct = pre_t(tparams, torch.tensor(toks))
        assert _err(lj, lt) < LOGIT_TOL
        tj = jnp.argmax(lj, -1).astype(jnp.int32)
        tt = lt.argmax(-1).to(torch.int32)
        for i in range(gen - 1):
            assert np.array_equal(np.asarray(tj), tt.numpy()), i
            tj, lj, cj = serve_j(params, tj, cj, jnp.int32(S + i))
            tt, lt, ct = serve_t(tparams, tt, ct, S + i)
            assert _err(lj, lt) < LOGIT_TOL
        assert np.array_equal(np.asarray(tj), tt.numpy())
    assert gaps and float(torch.cat(gaps).min()) > 1e-5


def test_run_dense_matches_dense_oracle():
    cfg, params, tcfg, tparams = _model()
    args = serve.build_parser().parse_args(
        ["--device", "cpu", "--requests", "3", "--batch", "2",
         "--prompt-len", "12", "--gen", "5"])
    out, stats = serve.run_dense(args, tcfg.replace(impl="pallas"),
                                 params=tparams, device="cpu")
    prompts = serve.make_prompts(3, 12, cfg.vocab_size, 0)
    assert out == {int(r[1:]): t for r, t in dense_oracle(
        cfg, params, prompts, 5, 12 + 5).items()}


@pytest.mark.parametrize("fused", [True, False])
def test_paged_engine_matches_reference_engine(fused):
    """The port's PagedEngine and the reference's on ``seeded_prompts``
    (seed 0), fp32, with the tight pool of the serving tests: identical
    tokens, and both equal to the dense oracle (batch-1 prefills: the
    same capacity on every path)."""
    cfg, params, tcfg, tparams = _model()
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


@pytest.mark.parametrize("engine", ["dense", "paged"])
def test_serve_cli_runs_grok_tiny(engine, capsys):
    serve.main(["--arch", ARCH, "--tiny", "--device", "cpu", "--engine",
                engine, "--requests", "3", "--prompt-len", "8", "--gen", "4",
                "--batch", "2"])
    out = capsys.readouterr().out
    assert ("served 3 requests, 12 tokens" in out)
