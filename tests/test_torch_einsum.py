"""The port's attention einsum (``repro_torch.kernels.product.einsum32``,
which ``attention._einsum32`` and MLA call) against the reference's
``jnp.einsum(..., preferred_element_type=jnp.float32)``: bf16 operands,
exact products summed in fp32.

On the card two bf16 operands go through ``product.Einsum32`` (one
``torch.bmm`` with an fp32 output over the equation's batch, free and
contracted indices; backward the transpose rule); on the CPU the einsum
keeps the promotion of both operands to fp32, bit for bit.  Here the
route's index plumbing and backward run on CPU bf16 tensors (its
products then on the promoted operands: the same exact products, summed
in fp32), and the functions that call it run both ways against the
reference's own functions under ``jax.value_and_grad``.  Tolerances as
for the weight product (``tests/test_torch_product.py``): a bf16 value
or gradient within one bf16 unit of the reference's; an fp32 einsum
output within 2 K 2**-24 (|a| . |b|) elementwise, the bound on two fp32
summation orders of K products.  The gradients of q and k, which flow
back through the softmax's cancelling sum, take the trainers' bf16 gate
instead (``_within_softmax_grad_gate``).  On ``meta`` (the card's route, the dry
run) the graphs make no fp32 copy of a bf16 operand.  Inputs are made
with numpy from seeds and passed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_tiny_config as jtiny
from repro.models import attention as jattn, lm as jlm, mla as jmla
from repro_torch.configs import get_tiny_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import product
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import attention as attn, lm, mla
from repro_torch.weights import from_reference, init_params

# every equation the port's attention and MLA pass to ``_einsum32``, with
# a size for each index (k and g the grouped forms' kv heads and group,
# w a suffix window, l MLA's latent width)
EQUATIONS = ("bqhd,bthd->bhqt", "bhqt,bthd->bqhd", "bhqt,bthd->bhqd",
             "bkgd,btkd->bkgt", "bkgt,btkd->bkgd", "bwkgd,btkd->bkgwt",
             "bkgwt,btkd->bwkgd", "bhl,btl->bht", "bhd,btd->bht",
             "bht,btl->bhl", "bhd,lhd->bhl", "bhl,lhv->bhv")
SIZE = dict(b=2, q=3, h=4, d=16, t=12, k=2, g=1, w=5, l=24, v=8)


def _bf16(a):
    return torch.tensor(a, dtype=torch.float32).bfloat16()


def _f64(t):
    if isinstance(t, torch.Tensor):
        t = t.detach().float().numpy()
    return np.asarray(np.asarray(t, np.float32), np.float64)


def _within_bf16_unit(got, want):
    """|got - want| at most one bf16 unit in the last place at the larger
    of the two (normal numbers)."""
    got, want = _f64(got), _f64(want)
    v = np.maximum(np.maximum(np.abs(got), np.abs(want)), 2.0 ** -126)
    unit = 2.0 ** (np.floor(np.log2(v)) - 7)
    assert np.all(np.abs(got - want) <= unit), \
        float(np.max(np.abs(got - want) / unit))


def _within_softmax_grad_gate(got, want):
    """A gradient that flows back through the softmax (dq, dk): within
    2**-7 of the largest reference gradient, the trainers' bf16 gate
    (``tests/test_torch_train_loss.py``).  Its cotangent ds = p (dp -
    sum p dp) cancels, so a one-unit difference in a bf16-rounded dp
    (each side rounds the probabilities' gradient to bf16, as the
    reference's transpose rule does) can move a small entry by many of
    its own units."""
    got, want = _f64(got), _f64(want)
    assert np.max(np.abs(got - want)) <= 2.0 ** -7 * np.max(np.abs(want))


def _within_order_bound(got, want, eq, a, b):
    """|got - want| <= 2 K 2**-24 (|a| . |b|) for ``eq``'s K contracted
    products a term."""
    ins, out = eq.split("->")
    ia, ib = ins.split(",")
    size = dict(zip(ia, a.shape))
    K = int(np.prod([size[c] for c in ia if c in ib and c not in out]))
    bound = 2 * K * 2.0 ** -24 * np.einsum(eq, np.abs(_f64(a)),
                                           np.abs(_f64(b)))
    assert np.all(np.abs(_f64(got) - _f64(want)) <= bound), \
        float(np.max(np.abs(_f64(got) - _f64(want)) - bound))


def _operands(eq, rng, dtypes=(torch.bfloat16, torch.bfloat16)):
    ia, ib = eq.split("->")[0].split(",")
    return [torch.tensor(rng.standard_normal([SIZE[c] for c in idx]),
                         dtype=torch.float32).to(dt)
            for idx, dt in zip((ia, ib), dtypes)]


def _route(eq, a, b):
    """The card's route on the CPU: ``Einsum32``'s plumbing and transpose
    rule, its batched products on the promoted operands."""
    if a.dtype == b.dtype == torch.bfloat16:
        return product.Einsum32.apply(eq, a, b)
    return torch.einsum(eq, a.float(), b.float())


@pytest.fixture(params=["cpu", "route"])
def way(request, monkeypatch):
    """Each function as it runs on the CPU, and again with the card's
    route (``_route``) in place of the CPU's promotion."""
    if request.param == "route":
        monkeypatch.setattr(product, "einsum32", _route)
    return request.param


# --- the einsum itself -------------------------------------------------------
@pytest.mark.parametrize("dtypes", [("bfloat16", "bfloat16"),
                                    ("float32", "bfloat16"),
                                    ("float32", "float32")])
@pytest.mark.parametrize("eq", EQUATIONS)
def test_cpu_einsum32_is_the_promotion_bit_for_bit(eq, dtypes):
    """On the CPU ``einsum32`` is ``torch.einsum`` of the promoted
    operands, as ``_einsum32`` was: forward and gradients."""
    rng = np.random.default_rng(31)
    a, b = _operands(eq, rng, [getattr(torch, d) for d in dtypes])
    results = []
    for new in (True, False):
        ag, bg = a.clone().requires_grad_(), b.clone().requires_grad_()
        y = attn._einsum32(eq, ag, bg) if new else \
            torch.einsum(eq, ag.float(), bg.float())
        (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum(
        ).backward()
        results.append((y.detach(), ag.grad, bg.grad))
    for x, y in zip(*results):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("cot", ["float32", "bfloat16"])
@pytest.mark.parametrize("eq", EQUATIONS)
def test_route_matches_reference_einsum_and_its_grads(eq, cot):
    """``Einsum32`` on bf16 operands against the reference's einsum
    under ``jax.value_and_grad``: the fp32 output within the order bound,
    both bf16 gradients within one bf16 unit, with an fp32 cotangent (the
    attention's) and a bf16 one."""
    rng = np.random.default_rng(32)
    a, b = _operands(eq, rng)
    out_shape = jnp.einsum(eq, jnp.zeros(a.shape), jnp.zeros(b.shape)).shape
    c = rng.standard_normal(out_shape).astype(np.float32)
    cdt = getattr(jnp, cot)

    def jloss(x, w):
        y = jnp.einsum(eq, x, w, preferred_element_type=jnp.float32)
        return jnp.sum(y.astype(cdt).astype(jnp.float32) * c), y
    (_, yj), (daj, dbj) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(_f64(a), jnp.bfloat16), jnp.asarray(_f64(b),
                                                         jnp.bfloat16))
    at, bt = a.clone().requires_grad_(), b.clone().requires_grad_()
    yt = product.Einsum32.apply(eq, at, bt)
    assert yt.dtype == torch.float32 and yt.shape == tuple(out_shape)
    (yt.to(getattr(torch, cot)).float() * torch.from_numpy(c)).sum(
    ).backward()
    _within_order_bound(yt, yj, eq, a, b)
    assert at.grad.dtype == bt.grad.dtype == torch.bfloat16
    _within_bf16_unit(at.grad, daj)
    _within_bf16_unit(bt.grad, dbj)


def test_einsum32_refuses_an_equation_it_cannot_map():
    a = torch.zeros(2, 3, 4, dtype=torch.bfloat16, device="meta")
    for eq in ("bij,bjk->bi", "bii,bik->bik", "...ij,...jk->...ik"):
        with pytest.raises(ValueError):
            product.einsum32(eq, a, a)


# --- the functions that call it, against the reference's ---------------------
def _grads_t(fn, args, cots):
    """fn(*args) (tensors or tuples of them), the loss sum(out * cot) and
    the gradients of every arg that is a float tensor."""
    args = [a.clone().requires_grad_() for a in args]
    outs = fn(*args)
    outs = outs if isinstance(outs, tuple) else (outs,)
    sum((o.float() * torch.from_numpy(c)).sum()
        for o, c in zip(outs, cots)).backward()
    return outs, [a.grad for a in args]


def _grads_j(fn, args, cots):
    def loss(*xs):
        outs = fn(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum(jnp.sum(o.astype(jnp.float32) * c)
                   for o, c in zip(outs, cots)), outs
    (_, outs), grads = jax.value_and_grad(
        loss, argnums=tuple(range(len(args))), has_aux=True)(*args)
    return outs, grads


def _bf16_pair(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), _bf16(x)


BLOCKED = [("causal", True, None, None), ("softcap 30", True, None, 30.0),
           ("bidirectional", False, None, None)]


@pytest.mark.parametrize("case", BLOCKED, ids=[c[0] for c in BLOCKED])
def test_attend_blocked_matches_reference(case, way):
    """The trainers' attention (2 x 32 tokens, 4 heads of 16, 8 x 16
    blocks): the bf16 output and the bf16 gradients of q, k and v."""
    _, causal, window, softcap = case
    rng = np.random.default_rng(33)
    B, S, H, hd = 2, 32, 4, 16
    pairs = [_bf16_pair(rng, (B, S, H, hd)) for _ in range(3)]
    c = [rng.standard_normal((B, S, H, hd)).astype(np.float32)]
    kw = dict(causal=causal, window=window, scale=hd ** -0.5,
              softcap=softcap, block_q=8, block_kv=16)
    oj, gj = _grads_j(lambda q, k, v: jattn.attend_blocked(q, k, v, **kw),
                      [p[0] for p in pairs], c)
    ot, gt = _grads_t(lambda q, k, v: attn.attend_blocked(q, k, v, **kw),
                      [p[1] for p in pairs], c)
    assert ot[0].dtype == torch.bfloat16
    _within_bf16_unit(ot[0], oj[0])
    _check_grads(gt, gj)


def _check_grads(gt, gj):
    """dq and dk (through the softmax) within its gate, dv within one
    bf16 unit; all bf16."""
    assert all(g.dtype == torch.bfloat16 for g in gt)
    for a, b in zip(gt[:2], gj[:2]):
        _within_softmax_grad_gate(a, b)
    _within_bf16_unit(gt[2], gj[2])


def test_attend_local_blocked_matches_reference(way):
    """The sliding-window fast path (window 8, 8-row q blocks over 32
    tokens): the bf16 output and gradients."""
    rng = np.random.default_rng(34)
    B, S, H, hd = 2, 32, 4, 16
    pairs = [_bf16_pair(rng, (B, S, H, hd)) for _ in range(3)]
    c = [rng.standard_normal((B, S, H, hd)).astype(np.float32)]
    kw = dict(causal=True, window=8, scale=hd ** -0.5, softcap=None, bq=8)
    oj, gj = _grads_j(
        lambda q, k, v: jattn._attend_local_blocked(q, k, v, **kw),
        [p[0] for p in pairs], c)
    ot, gt = _grads_t(
        lambda q, k, v: attn._attend_local_blocked(q, k, v, **kw),
        [p[1] for p in pairs], c)
    _within_bf16_unit(ot[0], oj[0])
    _check_grads(gt, gj)


@pytest.mark.parametrize("softcap", [None, 50.0])
def test_decode_partial_matches_reference(softcap, way):
    """The split-T decode partial over a 24-slot slice (8 query heads on
    2 kv heads, slots past 17 invalid): m within the order bound of its
    scores, l and acc within the order bound of their sums, the bf16
    gradients as ``_check_grads`` gates them."""
    rng = np.random.default_rng(35)
    B, H, Kv, hd, Tl = 2, 8, 2, 16, 24
    q = _bf16_pair(rng, (B, 1, H, hd))
    k = _bf16_pair(rng, (B, Tl, Kv * hd))
    v = _bf16_pair(rng, (B, Tl, Kv * hd))
    valid = np.arange(Tl) <= 17
    kw = dict(scale=hd ** -0.5, softcap=softcap, n_kv=Kv)
    G = H // Kv
    c = [rng.standard_normal(s).astype(np.float32)
         for s in ((B, Kv, G), (B, Kv, G), (B, Kv, G, hd))]
    oj, gj = _grads_j(lambda a, b, d: jattn._decode_partial(
        a, b, d, jnp.asarray(valid), **kw), [q[0], k[0], v[0]], c)
    ot, gt = _grads_t(lambda a, b, d: attn._decode_partial(
        a, b, d, torch.from_numpy(valid), **kw), [q[1], k[1], v[1]], c)
    qg = _f64(q[1]).reshape(B, Kv, G, hd)
    kk, vv = (_f64(t[1]).reshape(B, Tl, Kv, hd) for t in (k, v))
    # each valid score within the order bound of its hd products, scaled
    # (the softcap's tanh contracts it), and a few fp32 roundings after
    # the sum; m, the largest, within the largest of them
    s = np.einsum("bkgd,btkd->bkgt", qg, kk)[..., valid] * kw["scale"]
    s_bound = (2 * hd * 2.0 ** -24 * kw["scale"] * np.einsum(
        "bkgd,btkd->bkgt", np.abs(qg), np.abs(kk))[..., valid]
        + 8 * 2.0 ** -24 * np.abs(s)).max(-1)
    assert np.all(np.abs(_f64(ot[0]) - _f64(oj[0])) <= s_bound)
    # p_t = exp(s_t - m) <= 1 moves by at most 2 s_bound relative (and
    # exp's roundings); l = sum_t p_t, acc = sum_t bf16(p_t) v_t, each an
    # fp32 sum of Tl terms
    l_ref = _f64(oj[1])
    rel = 2 * s_bound + (2 * Tl + 4) * 2.0 ** -24
    assert np.all(np.abs(_f64(ot[1]) - l_ref) <= rel * l_ref)
    acc_bound = rel[..., None] * np.einsum(
        "btkd->bkd", np.abs(vv) * valid[None, :, None, None])[:, :, None]
    assert np.all(np.abs(_f64(ot[2]) - _f64(oj[2])) <= acc_bound)
    _check_grads(gt, gj)


def test_attend_prefill_paged_matches_reference(way):
    """The suffix body (a 6-token window from position 9 over 4 pages of
    4 slots, 8 query heads on 2 kv heads): the bf16 output and the bf16
    gradients of q and of both pools."""
    rng = np.random.default_rng(36)
    H, Kv, hd, ps, P, W, start = 8, 2, 16, 4, 6, 6, 9
    q = _bf16_pair(rng, (1, W, H, hd))
    pk = _bf16_pair(rng, (P, ps, Kv * hd))
    pv = _bf16_pair(rng, (P, ps, Kv * hd))
    row = np.array([4, 0, 2, 5], np.int32)
    kw = dict(scale=hd ** -0.5, softcap=None, n_kv=Kv)
    c = [rng.standard_normal((1, W, H * hd)).astype(np.float32)]
    oj, gj = _grads_j(lambda a, k, v: jattn.attend_prefill_paged(
        a, jattn.PagedAttnCache(k, v), jnp.asarray(row), start, **kw),
        [q[0], pk[0], pv[0]], c)
    ot, gt = _grads_t(lambda a, k, v: attn.attend_prefill_paged(
        a, attn.PagedAttnCache(k, v), torch.from_numpy(row), start, **kw),
        [q[1], pk[1], pv[1]], c)
    assert ot[0].dtype == torch.bfloat16
    _within_bf16_unit(ot[0], oj[0])
    _check_grads(gt, gj)


def _mla_models():
    """DeepSeek-V3's tiny config with bf16 parameters and activations
    (the served dtypes: ``kv_b``'s views and the latent cache bf16) on
    both sides, the first layer's MLA parameters."""
    cfg = jtiny("deepseek-v3-671b").replace(param_dtype="bfloat16",
                                             activation_dtype="bfloat16")
    tcfg = get_tiny_config("deepseek-v3-671b").replace(
        param_dtype="bfloat16", activation_dtype="bfloat16")
    params = jlm.init_params(jax.random.PRNGKey(3), cfg)
    tparams = from_reference(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return (cfg, params["segments"][0][0]["mla"], tcfg,
            tparams["segments"][0][0][0]["mla"])


def test_mla_apply_decode_matches_reference(way):
    """One absorbed decode step at position 11 of a 16-slot bf16 latent
    cache: the bf16 output within one bf16 unit, the written cache rows
    equal."""
    cfg, pj, tcfg, pt = _mla_models()
    m = cfg.mla
    rng = np.random.default_rng(37)
    B, T, pos = 2, 16, 11
    x = _bf16_pair(rng, (B, 1, cfg.d_model))
    ckv = _bf16_pair(rng, (B, T, m.kv_lora_rank))
    kr = _bf16_pair(rng, (B, T, m.qk_rope_head_dim))
    p = np.full((B, 1), pos, np.int32)
    oj, cj = jmla.apply_decode(pj, cfg, x[0], jmla.MLACache(ckv[0], kr[0]),
                               pos, angles=jlm._angles(cfg, jnp.asarray(p)))
    ot, ct = mla.apply_decode(pt, tcfg, x[1], mla.MLACache(ckv[1].clone(),
                                                           kr[1].clone()),
                              pos, angles=lm._angles(tcfg,
                                                     torch.from_numpy(p)))
    assert ot.dtype == torch.bfloat16 and ot.shape == (B, 1, cfg.d_model)
    _within_bf16_unit(ot, oj)
    for a, b in ((ct.ckv, cj.ckv), (ct.k_rope, cj.k_rope)):
        _within_bf16_unit(a, b)


# --- on meta: no fp32 copy of an operand -------------------------------------
class _Conversions(TorchDispatchMode):
    """Records the numel of every bf16 -> fp32 conversion."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in (torch.ops.aten._to_copy.default,
                    torch.ops.aten.to.dtype) \
                and args[0].dtype == torch.bfloat16 \
                and isinstance(out, torch.Tensor) \
                and out.dtype == torch.float32:
            self.seen.append(args[0].numel())
        return out


def _nodes(fn):
    seen, todo = set(), [fn]
    while todo:
        f = todo.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        todo += [g for g, _ in f.next_functions]
    return seen


def test_meta_attend_blocked_saves_no_fp32_copy_of_an_operand():
    """On ``meta`` the trainers' blocked attention converts no bf16
    tensor to fp32, every einsum saves its two bf16 operands, and no
    saved fp32 tensor has the size of a k or v block (a q block's is
    the fp32 accumulator's, which the reference keeps too)."""
    B, S, H, hd, bq, bkv = 2, 64, 4, 32, 16, 32
    q, k, v = (torch.empty(B, S, H, hd, device="meta", dtype=torch.bfloat16,
                           requires_grad=True) for _ in range(3))
    saved = []
    with _Conversions() as conv, torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append((t.dtype, t.numel())) or t, lambda t: t):
        o = attn.attend_blocked(q, k, v, causal=True, window=None,
                                scale=hd ** -0.5, softcap=None, block_q=bq,
                                block_kv=bkv)
    assert not conv.seen, conv.seen
    ein = [f for f in _nodes(o.grad_fn)
           if type(f).__name__ == "Einsum32Backward"]
    assert len(ein) == 2 * (S // bq) * (S // bkv)
    assert all(t.dtype == torch.bfloat16 for f in ein
               for t in f.saved_tensors)
    kv_block = B * bkv * H * hd
    assert not [s for s in saved if s == (torch.float32, kv_block)], saved
    o.float().sum().backward()
    assert q.grad.dtype == k.grad.dtype == torch.bfloat16


def test_meta_mla_decode_converts_no_weight_view_or_latent_cache():
    """On ``meta`` DeepSeek's absorbed decode (bf16 parameters and
    cache) converts neither ``kv_b``'s ``w_uk`` / ``w_uv`` views nor the
    latent cache nor its rope keys to fp32."""
    cfg = get_tiny_config("deepseek-v3-671b").replace(
        param_dtype="bfloat16", activation_dtype="bfloat16")
    m = cfg.mla
    p = init_params(cfg, None, "meta")["segments"][0][0][0]["mla"]
    B, T = 2, 40
    cache = mla.cache_init(cfg, B, T, torch.bfloat16, "meta")
    x = torch.empty(B, 1, cfg.d_model, device="meta", dtype=torch.bfloat16)
    angles = lm._angles(cfg, torch.zeros(B, 1, dtype=torch.int32,
                                         device="meta"))
    w_uk, w_uv = mla._kv_b_split(p, cfg)
    sizes = {w_uk.numel(), w_uv.numel(), cache.ckv.numel(),
             cache.k_rope.numel()}
    assert w_uk.dtype == w_uv.dtype == cache.ckv.dtype == torch.bfloat16
    with _Conversions() as conv:
        out, _ = mla.apply_decode(p, cfg, x, cache, 7, angles=angles)
    assert out.shape == (B, 1, cfg.d_model)
    assert not [n for n in conv.seen if n in sizes], conv.seen
    assert m.kv_lora_rank * cfg.n_heads * m.qk_nope_head_dim == w_uk.numel()


# temp_size_in_bytes of the tiny DeepSeek-V3 train step (n_layers 2, bf16
# parameters, B=4, S=32) on a 1x2 meta mesh with the attention's einsums
# promoted, as they were: the tally counts it to the byte
TEMP_EINSUMS_PROMOTED = 2_585_532


def test_dry_run_temp_falls_with_the_einsum_route(monkeypatch):
    """The dry run of a DeepSeek train step holds fewer bytes with the
    einsums on the route than with them promoted (the same step with
    ``einsum32`` swapped for the promotion)."""
    cfg = get_tiny_config("deepseek-v3-671b").replace(
        param_dtype="bfloat16", activation_dtype="bfloat16")
    shape = ShapeConfig("t", 32, 4, "train")

    def temp():
        return dryrun.dry_step(cfg, shape, make_test_mesh(
            1, 2, devices="meta"))["memory"]["temp_size_in_bytes"]
    route = temp()
    monkeypatch.setattr(product, "einsum32", lambda eq, a, b: torch.einsum(
        eq, a.float(), b.float()))
    assert temp() == TEMP_EINSUMS_PROMOTED
    assert route < TEMP_EINSUMS_PROMOTED
