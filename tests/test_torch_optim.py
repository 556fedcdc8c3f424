"""The port's optimizer, schedule, data pipeline and train step against
the JAX reference on the CPU.

* ``optim/quant``: the int8 codes and scales equal the reference's, bit
  for bit, in both layouts (flat 256-blocks padded to 512 blocks, and
  param-shaped 128-blocks), with and without the sqrt encoding;
* ``optim/adam.update`` over 3 steps of seeded gradients on the
  reference's stacked parameter tree (qwen3-14b tiny: one scanned segment
  of 2 cycles; gemma2 tiny: bf16 parameters), fp32, bf16 and int8 states;
* ``warmup_cosine`` at every step;
* ``SyntheticLM`` / ``FileTokens`` batches bit for bit, and the
  ``Prefetcher``'s order;
* ``steps.make_train_step`` for 3 steps on qwen3-14b (its stacked (2, 64)
  norm scales are decayed and, in int8, quantized flat across the
  cycles), grok (a scanned MoE segment) and DeepSeek (two unscanned
  one-cycle segments, dense and MoE, and MTP), with weight decay 0.1.

Tolerances: metrics within 1e-5 of |value| (lr within 1e-6: the two
cosines may differ by an fp32 unit).  With fp32 moments, parameters and
moments within 1e-4 of each leaf's largest entry: the two sides differ in
summation order only (the global norm, hence the clip scale, by an fp32
unit).  Those unit differences flip a rounding now and then, and a flip
is what the looser bounds admit: bf16 moments and bf16 parameters
(gemma2) within 2**-7 of the leaf's largest entry (one bf16 unit); with
int8 moments, codes within 1 (at most 1% of them off), and scales and
parameters within 5e-3 of the largest entry (a flipped code moves a
moment by 1/127 of its block's scale, and the steps after it by as
much).  bf16-moment parameters within 2e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import steps as jsteps
from repro.configs import get_tiny_config as jtiny
from repro.data import pipeline as jdata
from repro.models import lm as jlm
from repro.optim import adam as jadam, quant as jquant
from repro_torch import steps, weights
from repro_torch.configs import get_tiny_config
from repro_torch.data import pipeline as data
from repro_torch.optim import adam, quant

PARAM_TOL = {"float32": 1e-4, "bfloat16": 2e-3, "int8": 5e-3}
SCALE_TOL = 5e-3
BF16_PARAM_TOL = 2.0 ** -7
MOMENT_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file: the suite runs files on several
    workers at once, and the many small CPU ops of a train step slow down
    many times over when every worker spreads them over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


METRIC_TOL = 1e-5


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x, jnp.float32))


def _torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _param_tol(leaf, state_dtype):
    tol = PARAM_TOL[state_dtype]
    return max(tol, BF16_PARAM_TOL) if leaf.dtype == torch.bfloat16 else tol


def _rel_err(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max()) / max(float(np.abs(a).max()), 1e-30)


# --- quant -------------------------------------------------------------------
QUANT_SHAPES = {"flat": [(2, 64), (1000,), (3, 70), (256, 64)],
                "aligned": [(2, 64, 256), (64, 128), (3, 5, 384)]}


def _quant_input(shape, seed, sqrt):
    rs = np.random.default_rng(seed)
    x = rs.standard_normal(shape).astype(np.float32) * 3.0
    flat = x.reshape(-1)
    if flat.size >= 384:
        flat[:128] = 0.0                              # an all-zero block
        flat[256:320] = np.arange(64) - 31.5          # half-integer codes
    return np.abs(x) if sqrt else x


@pytest.mark.parametrize("sqrt", [False, True])
@pytest.mark.parametrize("mode", ["flat", "aligned"])
def test_quant_codes_and_scales_match_reference(mode, sqrt):
    jq = jquant.quantize if mode == "flat" else jquant.quantize_aligned
    tq = quant.quantize if mode == "flat" else quant.quantize_aligned
    for i, shape in enumerate(QUANT_SHAPES[mode]):
        x = _quant_input(shape, i, sqrt)
        a = jq(jnp.asarray(x), sqrt_encode=sqrt)
        b = tq(torch.from_numpy(x), sqrt_encode=sqrt)
        assert (b.shape, b.sqrt_encoded, b.mode) == (a.shape, sqrt, mode)
        assert b.q.dtype == torch.int8 and tuple(b.q.shape) == a.q.shape
        assert np.array_equal(np.asarray(a.q), b.q.numpy())
        assert np.array_equal(np.asarray(a.scale), b.scale.numpy())
        assert np.array_equal(np.asarray(jquant.dequantize(a)),
                              quant.dequantize(b).numpy())
    assert quant.aligned_ok((2, 64, 256)) and not quant.aligned_ok((2, 64))
    assert quant.flatten_blocks(torch.zeros(3)).shape == \
        (quant.MAX_SHARDS, quant.BLOCK)


# --- adam.update -------------------------------------------------------------
def _grads(params, seed):
    rs = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (rs.standard_normal(p.shape) * 0.1)
                        .astype(np.float32).astype(p.dtype), params)


def _check_moments(jm, tm, state_dtype):
    assert len(jm) == len(tm)
    for a, b in zip(jm, tm):
        if state_dtype == "int8":
            assert isinstance(b, quant.QTensor) and b.mode == a.mode
            dq = np.abs(np.asarray(a.q, np.int32) - b.q.int().numpy())
            assert dq.max() <= 1 and dq.mean() <= 0.01
            assert _rel_err(a.scale, b.scale) <= SCALE_TOL
        else:
            assert b.dtype == {"float32": torch.float32,
                               "bfloat16": torch.bfloat16}[state_dtype]
            assert _rel_err(a, b) <= MOMENT_TOL[state_dtype]


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("arch", ["qwen3-14b", "gemma2-27b"])
def test_adam_update_matches_reference(arch, state_dtype):
    cfg = jtiny(arch)
    params = jlm.init_params(jax.random.PRNGKey(0), cfg)
    jc = jadam.AdamConfig(state_dtype=state_dtype, weight_decay=0.1)
    tc = adam.AdamConfig(state_dtype=state_dtype, weight_decay=0.1)
    tparams = jax.tree.map(_torch, params)
    js, ts = jadam.init(params, jc), adam.init(tparams, tc)
    for step in range(3):
        g = _grads(params, step)
        lr = 1e-2 * (step + 1)
        params, js, jm = jadam.update(g, js, params, lr=lr, cfg=jc)
        tparams, ts, tm = adam.update(jax.tree.map(_torch, g), ts, tparams,
                                      lr=lr, cfg=tc)
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) \
            <= METRIC_TOL * float(jm["grad_norm"])
    assert int(ts.step) == int(js.step) == 3
    for a, b in zip(jax.tree.leaves(params), weights.tree_leaves(tparams)):
        assert str(b.dtype)[6:] == str(a.dtype)
        assert _rel_err(a, b) <= _param_tol(b, state_dtype)
    _check_moments(js.m, ts.m, state_dtype)
    _check_moments(js.v, ts.v, state_dtype)


def test_weight_decay_follows_the_stacked_leaf():
    """With zero gradients only the decay moves a parameter: qwen3-14b's
    scanned norm scales, stacked to (2, 64), are decayed as in the
    reference; ``final_norm`` (64,) is not."""
    cfg = get_tiny_config("qwen3-14b")
    p = weights.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tree = weights.to_reference(p, cfg)
    c = adam.AdamConfig(weight_decay=0.1)
    new, _, _ = adam.update(jax.tree.map(torch.zeros_like, tree),
                            adam.init(tree, c), tree, lr=0.5, cfg=c)
    ln1 = tree["segments"][0][0]["ln1"]["scale"]
    assert ln1.shape == (2, 64)
    assert torch.allclose(new["segments"][0][0]["ln1"]["scale"], ln1 * 0.95)
    assert torch.equal(new["final_norm"]["scale"], tree["final_norm"]["scale"])


def test_warmup_cosine_matches_reference_at_every_step():
    kw = dict(peak_lr=3e-4, warmup=5, total=23)
    for s in range(kw["total"] + 3):
        want = float(jadam.warmup_cosine(jnp.int32(s), **kw))
        got = float(adam.warmup_cosine(torch.tensor(s, dtype=torch.int32),
                                       **kw))
        assert abs(got - want) <= 1e-6 * kw["peak_lr"], s
    assert float(adam.warmup_cosine(torch.tensor(0), **kw)) == 0.0


# --- data --------------------------------------------------------------------
def _same_batches(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_synthetic_batches_match_reference_bit_for_bit():
    kw = dict(vocab_size=1000, seq_len=64, global_batch=4, seed=3,
              mean_doc_len=32)
    j, t = jdata.SyntheticLM(jdata.DataConfig(**kw)), \
        data.SyntheticLM(data.DataConfig(**kw))
    for step in (0, 1, 7, 1000):
        _same_batches(j.batch(step), t.batch(step))


def test_file_tokens_match_reference_bit_for_bit(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 60000, 5000).astype(
        np.uint16).tofile(path)
    kw = dict(vocab_size=3000, seq_len=32, global_batch=3, seed=1,
              path=str(path))
    j = jdata.make_source(jdata.DataConfig(**kw))
    t = data.make_source(data.DataConfig(**kw))
    assert isinstance(t, data.FileTokens)
    for step in (0, 5, 9):
        _same_batches(j.batch(step), t.batch(step))


def test_prefetcher_yields_steps_in_order():
    src = data.SyntheticLM(data.DataConfig(vocab_size=100, seq_len=8,
                                           global_batch=2, seed=0))
    pf = data.Prefetcher(src, start_step=5)
    try:
        for want in range(5, 12):
            step, b = next(pf)
            assert step == want
            _same_batches(b, src.batch(want))
    finally:
        pf.close()


# --- make_train_step ---------------------------------------------------------
def _train_batches(cfg, n, B=2, S=24):
    src = data.SyntheticLM(data.DataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=S, global_batch=B,
                                           seed=5, mean_doc_len=16))
    return [src.batch(s) for s in range(n)]


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
@pytest.mark.parametrize("arch", ["qwen3-14b", "grok-1-314b",
                                  "deepseek-v3-671b"])
def test_train_step_matches_reference_for_three_steps(arch, state_dtype):
    cfg = jtiny(arch).replace(activation_dtype="float32")
    tcfg = get_tiny_config(arch).replace(activation_dtype="float32")
    params = jlm.init_params(jax.random.PRNGKey(0), cfg)
    tparams = weights.from_reference(jax.tree.map(np.asarray, params), tcfg,
                                     "cpu")
    jc = jadam.AdamConfig(state_dtype=state_dtype, weight_decay=0.1)
    tc = adam.AdamConfig(state_dtype=state_dtype, weight_decay=0.1)
    kw = dict(peak_lr=1e-2, warmup=2, total=6)
    jstep = jax.jit(jsteps.make_train_step(
        cfg, jc, lambda s: jadam.warmup_cosine(s, **kw)))
    tstep = steps.make_train_step(
        tcfg, tc, lambda s: adam.warmup_cosine(s, **kw))
    js = jadam.init(params, jc)
    ts = adam.init(weights.to_reference(tparams, tcfg), tc)
    for b in _train_batches(cfg, 3):
        params, js, jm = jstep(params, js,
                               {k: jnp.asarray(v) for k, v in b.items()})
        tparams, ts, tm = tstep(tparams, ts,
                                {k: torch.from_numpy(v) for k, v in b.items()})
        assert set(tm) == set(jm)
        for k in jm:
            tol = 1e-6 if k == "lr" else METRIC_TOL
            assert abs(float(tm[k]) - float(jm[k])) \
                <= tol * max(abs(float(jm[k])), 1e-30), k
    assert float(jm["lr"]) > 0 and int(ts.step) == 3
    tree = weights.to_reference(tparams, tcfg)
    jl = jax.tree.leaves(params)
    assert len(jl) == len(weights.tree_leaves(tree))
    for a, b in zip(jl, weights.tree_leaves(tree)):
        assert tuple(b.shape) == a.shape
        assert _rel_err(a, b) <= _param_tol(b, state_dtype)
    _check_moments(js.m, ts.m, state_dtype)
    _check_moments(js.v, ts.v, state_dtype)


def test_train_step_returns_views_of_the_stacked_leaves():
    """The new parameters are rows of one stacked tensor a leaf, so the
    next step's ``to_reference`` copies nothing."""
    cfg = get_tiny_config("qwen3-14b")
    p = weights.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    c = steps.adam_config_for(cfg)
    step = steps.make_train_step(cfg, c)
    b = {k: torch.from_numpy(v) for k, v in _train_batches(cfg, 1)[0].items()}
    p, s, _ = step(p, adam.init(weights.to_reference(p, cfg), c), b)
    stacked = weights.to_reference(p, cfg)["segments"][0][0]["attn"]["wq"]
    assert stacked.shape == (2, 64, 64)
    assert p["segments"][0][1][0]["attn"]["wq"].data_ptr() == \
        stacked[1].data_ptr()
    abstract = steps.abstract_params(cfg)
    assert all(l.device.type == "meta" for l in weights.tree_leaves(abstract))
    assert [tuple(l.shape) for l in weights.tree_leaves(abstract)] == \
        [tuple(l.shape) for l in weights.tree_leaves(
            weights.to_reference(p, cfg))]
