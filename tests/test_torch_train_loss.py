"""The port's training loss and its gradients against the JAX reference
on the CPU.

For each of the eleven tiny configs, at float32 activations, the same
reference parameters (``lm.init_params(PRNGKey(0))``) and the same batch
(made with numpy from a seed: token ids or, for hubert and qwen2-vl,
embeddings; qwen2-vl at 3-D M-RoPE positions; a mask with zeros) go
through ``jax.jit(jax.value_and_grad(repro.models.lm.loss_fn))`` and the
port's ``lm.loss_fn``, differentiated with respect to the reference's
stacked leaves (``weights.unstack`` of the reference-shaped tree).  The cases
cover MoE's aux loss (grok, DeepSeek), DeepSeek's MTP head, softcaps
(gemma2, grok), the recurrent families, M-RoPE, embedding inputs, and a
sequence longer than ``LOSS_CHUNK`` (the CE in checkpointed chunks).

Tolerances: the loss and its metrics within 2e-6 of max(1, |value|)
(summation order only); each gradient leaf within 2e-4 of the leaf's
largest reference entry for fp32 leaves, and within 2**-7 of it for
gemma2's bf16 leaves (the gradient is rounded to bf16, so one rounding
flip is one bf16 unit).  Remat on and off give the same bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_tiny_config as jtiny
from repro.models import lm as jlm
from repro_torch import weights
from repro_torch.configs import get_tiny_config, list_archs
from repro_torch.kernels import ops
from repro_torch.models import lm, modules as nn

LOSS_TOL = 2e-6
GRAD_TOL = {torch.float32: 2e-4, torch.bfloat16: 2.0 ** -7}

_MODELS = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file: the suite runs files on several
    workers at once, and the many small CPU ops of a train step slow down
    many times over when every worker spreads them over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(arch):
    """(reference cfg, reference params, port cfg) at fp32 activations."""
    if arch not in _MODELS:
        cfg = jtiny(arch).replace(activation_dtype="float32")
        tcfg = get_tiny_config(arch).replace(activation_dtype="float32")
        _MODELS[arch] = (cfg, jlm.init_params(jax.random.PRNGKey(0), cfg),
                         tcfg)
    return _MODELS[arch]


def _vl_positions(B, S):
    """3-D M-RoPE ids: 8 text tokens, a 4x4 grid of image patches at one
    temporal id, then text again."""
    pos = np.zeros((3, B, S), np.int32)
    pos[:, :, :8] = np.arange(8)
    hh, ww = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
    pos[0, :, 8:24] = 8
    pos[1, :, 8:24] = 8 + hh.reshape(-1)
    pos[2, :, 8:24] = 8 + ww.reshape(-1)
    pos[:, :, 24:] = 12 + np.arange(S - 24)
    return pos


def make_batch(cfg, B, S, seed):
    rs = np.random.default_rng(seed)
    if cfg.embed_inputs:
        tokens = rs.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    else:
        tokens = rs.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    batch = {"tokens": tokens,
             "labels": rs.integers(0, cfg.vocab_size, (B, S)).astype(
                 np.int32),
             "mask": (rs.random((B, S)) < 0.85).astype(np.float32)}
    if cfg.mrope_sections is not None:
        batch["positions"] = _vl_positions(B, S)
    return batch


def _torch_tree(np_tree):
    return jax.tree.map(
        lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
            torch.bfloat16) if a.dtype == jnp.bfloat16
        else torch.from_numpy(np.array(a)), np_tree)


def port_loss_and_grads(tcfg, params, batch):
    """(loss, metrics, gradient leaves) of the port with respect to the
    reference-shaped leaves of ``params`` (a reference parameter tree)."""
    tree = _torch_tree(params)
    leaves = [l.requires_grad_() for l in weights.tree_leaves(tree)]
    p = weights.unstack(weights.tree_unflatten(tree, leaves), tcfg)
    loss, metrics = lm.loss_fn(p, tcfg, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        [torch.zeros_like(l) if g is None else g
         for l, g in zip(leaves, grads)]


def ref_loss_and_grads(cfg, params, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(p, cfg, jb), has_aux=True))(params)
    return loss, metrics, jax.tree.leaves(grads)


def _check(ref, port):
    (jl, jm, jg), (tl, tm, tg) = ref, port
    for k in jm:
        want = float(jm[k])
        assert abs(float(tm[k]) - want) <= LOSS_TOL * max(1.0, abs(want)), k
    assert set(tm) == set(jm)
    assert len(jg) == len(tg)
    for a, g in zip(jg, tg):
        a = np.asarray(a, np.float32)
        assert tuple(g.shape) == a.shape
        err = float(np.abs(a - g.float().numpy()).max())
        assert err <= GRAD_TOL[g.dtype] * float(np.abs(a).max()) + 1e-30, \
            (a.shape, err)


@pytest.mark.parametrize("arch", list_archs())
def test_loss_and_grads_match_reference(arch):
    cfg, params, tcfg = _model(arch)
    batch = make_batch(cfg, 2, 40, seed=1)
    _check(ref_loss_and_grads(cfg, params, batch),
           port_loss_and_grads(tcfg, params, batch))


@pytest.mark.parametrize("arch", ["qwen3-14b", "deepseek-v3-671b"])
def test_chunked_cross_entropy_matches_reference(arch):
    """S = 2 x LOSS_CHUNK: two checkpointed chunks of 512 (DeepSeek's MTP
    head takes its own chunked CE)."""
    cfg, params, tcfg = _model(arch)
    assert 1024 // lm.LOSS_CHUNK == 2
    batch = make_batch(cfg, 1, 1024, seed=2)
    _check(ref_loss_and_grads(cfg, params, batch),
           port_loss_and_grads(tcfg, params, batch))


def test_chunk_shrinks_until_it_divides_the_sequence():
    """S = 520: the chunk shrinks from 512 to 260 (two chunks), as in the
    reference; the loss equals one unchunked CE within fp32 rounding."""
    cfg, params, tcfg = _model("qwen3-14b")
    batch = make_batch(cfg, 1, 520, seed=3)
    loss, _, _ = port_loss_and_grads(tcfg, params, batch)
    jl, _, _ = ref_loss_and_grads(cfg, params, batch)
    assert abs(float(loss) - float(jl)) <= LOSS_TOL * max(1.0, float(jl))
    tree = weights.unstack(_torch_tree(params), tcfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    h, _ = lm.forward(tree, tcfg, tb["tokens"], mode="train")
    hn = nn.rmsnorm(h, tree["final_norm"]["scale"], tcfg.norm_eps)
    tot, cnt = lm._chunk_ce(lm._head_weight(tree, tcfg), tcfg, hn,
                            tb["labels"], tb["mask"])
    assert abs(float(tot / cnt) - float(loss)) <= 1e-5 * float(loss)


@pytest.mark.parametrize("arch", ["qwen3-14b", "grok-1-314b"])
def test_remat_gives_the_same_bits(arch):
    """A scanned segment's cycles under torch.utils.checkpoint (remat on)
    and kept whole (off): the same loss and gradients bit for bit, and
    fewer tensors saved for backward outside the checkpoints."""
    cfg, params, tcfg = _model(arch)
    assert any(s.scanned for s in lm.make_segments(tcfg)) and tcfg.remat
    batch = make_batch(cfg, 2, 40, seed=4)
    runs, saved = {}, {}
    for remat in (True, False):
        count = [0]

        def pack(t):
            count[0] += 1
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            runs[remat] = port_loss_and_grads(tcfg.replace(remat=remat),
                                              params, batch)
        saved[remat] = count[0]
    assert torch.equal(runs[True][0], runs[False][0])
    for a, b in zip(runs[True][2], runs[False][2]):
        assert torch.equal(a, b)
    assert saved[True] < saved[False]


def test_train_forward_returns_final_residual_and_aux():
    """mode="train" returns x + pending (the prefill forward's residual
    with its last branch added) and the summed MoE aux loss, which
    ``moe.apply`` computes per layer and the blocks carry out."""
    cfg, params, tcfg = _model("grok-1-314b")
    batch = make_batch(cfg, 2, 40, seed=5)
    tree = weights.unstack(_torch_tree(params), tcfg)
    tok = torch.from_numpy(batch["tokens"])
    with torch.no_grad():
        h, aux = lm.forward(tree, tcfg, tok, mode="train")
        x, pending, _ = lm.forward(tree, tcfg, tok)
    assert torch.equal(h, x + pending)
    jh, _, jaux = jlm.forward(params, cfg, jnp.asarray(batch["tokens"]),
                              mode="train")
    assert float(aux) > 0
    assert abs(float(aux) - float(jaux)) <= LOSS_TOL * float(jaux)
    assert float(np.abs(np.asarray(jh) - h.numpy()).max()) <= 1e-4


def test_kernel_wrappers_refuse_operands_that_require_grad():
    """The first check of every CUDA wrapper: an operand that requires
    grad under grad mode raises (the kernels have no backward) before the
    device is looked at; under no_grad the device check speaks."""
    x = torch.zeros(4, 8, requires_grad=True)
    s = torch.ones(8)
    with pytest.raises(RuntimeError, match="no backward.*impl='blocked'"):
        ops._check("rmsnorm", x.device, {"x": x, "scale": s}, ("x",),
                   fp32_names=("scale",))
    with torch.no_grad(), pytest.raises(ValueError, match="no kernel"):
        ops._check("rmsnorm", x.device, {"x": x, "scale": s}, ("x",),
                   fp32_names=("scale",))
    with pytest.raises(ValueError, match="no kernel"):
        ops._check("rmsnorm", x.device, {"x": x.detach(), "scale": s},
                   ("x",), fp32_names=("scale",))


def test_blocked_loss_runs_with_grads_on():
    """The training impl ("blocked") goes through no kernel wrapper: with
    grad mode on, the loss and a gradient come out."""
    cfg, params, tcfg = _model("tiny-100m")
    assert tcfg.impl == "blocked"
    loss, _, grads = port_loss_and_grads(tcfg, params,
                                         make_batch(cfg, 1, 16, seed=6))
    assert torch.isfinite(loss) and all(torch.isfinite(g).all()
                                        for g in grads)
