"""The port's product (``repro_torch.kernels.product.matmul``, which the
models call as ``modules.matmul``, and its autograd Function
``Product``) against the reference's ``modules.matmul`` and
``lm.head_logits`` (``dot_general`` with ``preferred_element_type=
float32``: bf16 operands, fp32 accumulation).

On the card, two bf16 operands go to cuBLAS's bf16 GEMM with an fp32
output through ``Product``; on the CPU the product keeps the promotion of
both operands to fp32.  Here ``Product`` is called directly on CPU bf16
tensors (its products then run on the promoted operands: the same exact
products, summed in fp32), forward and backward against
``jax.value_and_grad`` of the reference.  Tolerances: a bf16 output or
gradient within one bf16 unit of the reference's (both round an fp32 sum
of the same products); an fp32 output within the bound on two fp32
summation orders of K products, 2 K 2**-24 (|x| @ |w|) elementwise.
Inputs are made with numpy from seeds and passed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_tiny_config as jtiny
from repro.models import lm as jlm, modules as jnn
from repro_torch.configs import get_tiny_config
from repro_torch.kernels import product
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import lm, moe, modules as nn

OUT = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
       "float32": (torch.float32, jnp.float32)}


def _bf16(a):
    return torch.tensor(a, dtype=torch.float32).bfloat16()


def _f32(t):
    return np.asarray(t.detach().float().numpy(), np.float64)


def _bf16_unit(v):
    """One bf16 unit in the last place at |v| (normal numbers)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _within_bf16_unit(got, want):
    got, want = _f32(got), np.asarray(want, np.float64)
    unit = _bf16_unit(np.maximum(np.abs(got), np.abs(want)))
    assert np.all(np.abs(got - want) <= unit), \
        float(np.max(np.abs(got - want) / unit))


def _within_order_bound(got, want, x, w):
    """|got - want| <= 2 K 2**-24 (|x| @ |w|): two fp32 sums of the same
    K exact products in different orders."""
    K = x.shape[-1]
    bound = 2 * K * 2.0 ** -24 * (np.abs(x) @ np.abs(w))
    assert np.all(np.abs(_f32(got) - np.asarray(want, np.float64))
                  <= bound)


@pytest.mark.parametrize("out", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(2, 3, 16, 24), (1, 5, 40, 8)])
def test_product_matches_reference_matmul_and_its_grads(shape, out):
    B, S, K, N = shape
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, S, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    c = rng.standard_normal((B, S, N)).astype(np.float32)
    tdt, jdt = OUT[out]

    xj, wj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    yj = jnn.matmul(xj, wj, out_dtype=jdt)
    dxj, dwj = jax.grad(lambda a, b: jnp.sum(
        jnn.matmul(a, b, out_dtype=jdt).astype(jnp.float32) * c),
        argnums=(0, 1))(xj, wj)

    xt = _bf16(x).requires_grad_()
    wt = _bf16(w).requires_grad_()
    yt = product.Product.apply(xt, wt, tdt)
    (yt.float() * torch.from_numpy(c)).sum().backward()

    assert yt.dtype == tdt
    if out == "bfloat16":
        _within_bf16_unit(yt, np.asarray(yj, np.float32))
    else:
        _within_order_bound(yt, np.asarray(yj), _f32(xt), _f32(wt))
    assert xt.grad.dtype == xt.dtype and wt.grad.dtype == wt.dtype
    _within_bf16_unit(xt.grad, np.asarray(dxj, np.float32))
    _within_bf16_unit(wt.grad, np.asarray(dwj, np.float32))


@pytest.mark.parametrize("tied", [True, False])
def test_product_matches_reference_head_logits(tied):
    """The head's fp32 logits and the bf16 gradients of h and of the
    head, the tied (V, D) table read transposed in place."""
    jcfg = jtiny("gemma2-27b").replace(tie_embeddings=tied,
                                        logit_softcap=None)
    D, V = 32, 48
    rng = np.random.default_rng(12)
    h = rng.standard_normal((2, 3, D)).astype(np.float32)
    table = rng.standard_normal((V, D) if tied else (D, V)).astype(
        np.float32) * D ** -0.5
    c = rng.standard_normal((2, 3, V)).astype(np.float32)
    key = ("embed", "embed_table") if tied else ("head", "head_w")

    def jloss(hh, tt):
        logits = jlm.head_logits({key[0]: {key[1]: tt}}, jcfg, hh)
        return jnp.sum(logits * c), logits
    (_, lj), (dhj, dtj) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(h, jnp.bfloat16), jnp.asarray(table, jnp.bfloat16))

    ht = _bf16(h).requires_grad_()
    tt = _bf16(table).requires_grad_()
    lt = product.Product.apply(ht, tt.T if tied else tt, torch.float32)
    (lt * torch.from_numpy(c)).sum().backward()

    assert lt.dtype == torch.float32
    w = _f32(tt).T if tied else _f32(tt)
    _within_order_bound(lt, np.asarray(lj), _f32(ht), w)
    assert ht.grad.dtype == torch.bfloat16 and tt.grad.dtype == torch.bfloat16
    assert tt.grad.shape == tt.shape
    _within_bf16_unit(ht.grad, np.asarray(dhj, np.float32))
    _within_bf16_unit(tt.grad, np.asarray(dtj, np.float32))


@pytest.mark.parametrize("dtypes", [("bfloat16", "bfloat16"),
                                    ("bfloat16", "float32"),
                                    ("float32", "float32")])
@pytest.mark.parametrize("out", [None, "float32"])
def test_cpu_route_is_the_promotion_bit_for_bit(dtypes, out):
    """On the CPU ``matmul`` is the promoted product it always was,
    forward and gradients."""
    xd, wd = (OUT[d][0] for d in dtypes)
    od = OUT[out][0] if out else None
    rng = np.random.default_rng(13)
    x = torch.tensor(rng.standard_normal((2, 5, 24)), dtype=xd)
    w = torch.tensor(rng.standard_normal((24, 40)), dtype=wd)
    grads = []
    for new in (True, False):
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = product.matmul(xg, wg, od) if new else \
            (xg.float() @ wg.float()).to(od or xd)
        y.float().sum().backward()
        grads.append((y.detach(), xg.grad, wg.grad))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("tied", [True, False])
def test_cpu_head_logits_is_the_promotion_bit_for_bit(tied):
    cfg = get_tiny_config("gemma2-27b").replace(tie_embeddings=tied)
    rng = np.random.default_rng(14)
    D, V = cfg.d_model, cfg.vocab_size
    h = torch.tensor(rng.standard_normal((2, 3, D)), dtype=torch.bfloat16)
    t = torch.tensor(rng.standard_normal((V, D) if tied else (D, V)),
                     dtype=torch.bfloat16)
    params = ({"embed": {"embed_table": t}} if tied
              else {"head": {"head_w": t}})
    before = h.float() @ (t.float().T if tied else t.float())
    assert torch.equal(lm.head_logits(params, cfg, h),
                       nn.softcap(before, cfg.logit_softcap))


class _Outputs(TorchDispatchMode):
    """Records (dtype, numel) of every op's tensor outputs."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.seen.append((func, t.dtype, t.numel()))
        return out


@pytest.mark.parametrize("case", ["matmul", "tied head", "grouped"])
def test_meta_bf16_product_makes_no_fp32_copy_of_an_operand(case):
    """On ``meta`` (the card's route) a bf16 x bf16 product creates no
    fp32 tensor of an operand's size, and saves only the bf16 operands
    for its backward."""
    m = dict(device="meta", dtype=torch.bfloat16, requires_grad=True)
    if case == "matmul":
        x, w = torch.empty(2, 3, 64, **m), torch.empty(64, 96, **m)
        fn = lambda: product.matmul(x, w)                    # noqa: E731
    elif case == "tied head":
        x, t = torch.empty(2, 3, 64, **m), torch.empty(96, 64, **m)
        w = t.T
        fn = lambda: product.matmul(x, w, torch.float32)     # noqa: E731
    else:
        cfg = get_tiny_config("grok-1-314b")
        x, w = torch.empty(4, 8, 64, **m), torch.empty(4, 64, 96, **m)
        fn = lambda: moe._grouped(cfg, x, w)                 # noqa: E731
    saved = []
    with _Outputs() as rec, torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append((t.dtype, t.numel())) or t, lambda t: t):
        fn()
    sizes = {x.numel(), w.numel()}
    assert not [s for s in rec.seen if s[1] == torch.float32
                and s[2] in sizes], rec.seen
    assert saved and all(d == torch.bfloat16 for d, _ in saved), saved


# temp_size_in_bytes of a DeepSeek-V3 train step (tiny, n_layers 2, bf16
# parameters, B=4, S=32) on a 1x2 meta mesh: 3,957,440 B with the
# promoted products and the index_add_ combine; 2,585,532 B with the bf16
# route for the weight products and the fixed-order combine, the
# attention's einsums still promoted; 2,278,332 B with the einsums on the
# bf16 route too (``product.einsum32``), which the tally counts to the
# byte
TEMP_PROMOTED = 3_957_440
TEMP_ROUTE = 2_278_332


def test_dry_run_temp_falls_with_the_bf16_route():
    cfg = get_tiny_config("deepseek-v3-671b").replace(
        param_dtype="bfloat16", activation_dtype="bfloat16")
    r = dryrun.dry_step(cfg, ShapeConfig("t", 32, 4, "train"),
                        make_test_mesh(1, 2, devices="meta"))
    assert r["memory"]["temp_size_in_bytes"] == TEMP_ROUTE < TEMP_PROMOTED
