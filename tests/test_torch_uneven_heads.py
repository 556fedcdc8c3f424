"""A head count the model axis does not divide (qwen3-14b's 40 heads, and
qwen2-vl's 28 and recurrentgemma's 10, over 16 positions), on the CPU.

The mesh train forward and the mesh prefill split q by the columns of
wo's row blocks (``attention._apply_tp``): q is gathered whole on every
position, which computes the heads that cover its block, a head shared
with a neighbour on both.  At tiny widths, 6 heads of 16 over a model
axis of 4 (24 of q's 96 columns a position), fp32.

Held against the JAX reference's own mesh, whose attention pads the
intermediates of such a head count: the reference runs once, in one
subprocess with 8 forced host devices, on meshes it builds itself with
Auto axes (``jax.make_mesh(shape, ("data", "model"),
axis_types=(AxisType.Auto,) * 2)``, as ``test_torch_mesh_families.py``
and ``test_torch_dense_mesh.py`` do), and writes its parameters, its
``jax.value_and_grad`` of ``lm.loss_fn`` on 1x4 and 2x4, and its
jitted prefill of 4 prompts of 16 tokens and 5 greedy decode steps on
1x4 (``steps.make_prefill_step`` and ``make_serve_step``) to a
temporary file; the port runs the same parameters
(``weights.from_reference``) on the same meshes.  The gates are those
files': the loss within 1e-5 of its value and every gradient leaf
within 1e-4 of its largest entry (read: the loss equal, the gradients
within 8.8e-7); the greedy tokens identical and every step's logits
within 5e-5.

Held against the port's own one device as well: the mesh trainer's loss
within 1e-6 relative and every gradient leaf within 1e-5 of its largest
entry (the train-step parity gate of ``test_torch_mesh_train.py``) on
1x4 and 2x4, and the mesh prefill's logits and the next decode step's
within 1e-5 (they reach about 5).  ``steps.check_mesh`` still refuses
q columns the axis does not divide (64 over 3).
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import steps, weights
from repro_torch.configs import get_tiny_config
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import lm
from repro_torch.parallel.sharding import sum_regions, use_sharding

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
B, S = 4, 32
SB, SS, GEN = 4, 16, 6              # the served prompts and steps
TOL = dict(loss=1e-5, grad=1e-4, logits=5e-5)
HEADS = dict(activation_dtype="float32", param_dtype="float32", n_heads=6,
             n_kv_heads=2)

REF_SCRIPT = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro import steps
from repro.configs import get_tiny_config
from repro.models import lm
from repro.parallel.sharding import use_sharding

B, S, SB, SS, GEN = %(B)d, %(S)d, %(SB)d, %(SS)d, %(GEN)d
def mesh(shape):
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)

cfg = get_tiny_config("qwen3-14b").replace(**%(heads)r)
params = lm.init_params(jax.random.PRNGKey(0), cfg)
r = np.random.default_rng(5)
batch = {"tokens": r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "labels": r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "mask": (r.random((B, S)) < 0.9).astype(np.float32)}
prompts = np.random.default_rng(1).integers(
    2, cfg.vocab_size, (SB, SS)).astype(np.int32)
out = {"params": jax.tree.map(np.asarray, params), "batch": batch,
       "prompts": prompts}
f = lambda p: lm.loss_fn(p, cfg, jax.tree.map(jnp.asarray, batch))[0]
for shape in ((1, 4), (2, 4)):
    with use_sharding(mesh(shape)):
        loss, g = jax.jit(jax.value_and_grad(f))(params)
    out[shape] = (float(loss), jax.tree.map(np.asarray, g))
with use_sharding(mesh((1, 4))):
    pre = jax.jit(steps.make_prefill_step(cfg, max_len=SS + GEN))
    ser = jax.jit(steps.make_serve_step(cfg))
    lg, c = pre(params, jnp.asarray(prompts))
    tok = jnp.argmax(lg, -1).astype(jnp.int32)
    toks, lgs = [tok], [lg]
    for i in range(GEN - 1):
        tok, lg, c = ser(params, tok, c, jnp.int32(SS + i))
        toks.append(tok)
        lgs.append(lg)
out["serve"] = (np.asarray(jnp.concatenate(toks, -1)),
                np.asarray(jnp.stack(lgs)))
pickle.dump(out, open(sys.argv[1], "wb"))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = env.get("XLA_FLAGS", "") + \
        " --xla_force_host_platform_device_count=8"
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(
        REF_SCRIPT % dict(B=B, S=S, SB=SB, SS=SS, GEN=GEN, heads=HEADS)),
        str(path)], capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def _cfg():
    return get_tiny_config("qwen3-14b").replace(**HEADS)


def _params(cfg):
    return weights.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _batch(cfg):
    r = np.random.default_rng(0)
    return {"tokens": torch.from_numpy(r.integers(
                0, cfg.vocab_size, (B, S)).astype(np.int32)),
            "labels": torch.from_numpy(r.integers(
                0, cfg.vocab_size, (B, S)).astype(np.int32)),
            "mask": torch.from_numpy((r.random((B, S)) < 0.75)
                                     .astype(np.float32))}


def _mesh_loss_and_grads(cfg, params, batch, shape):
    mesh = make_test_mesh(*shape, devices="cpu")
    with use_sharding(mesh):
        placed = weights.shard_params(params, cfg, mesh)
        metrics, g = steps.mesh_loss_and_grads(cfg, placed, batch)
    return float(metrics["loss"]), [
        sum_regions(t.shards, t.shape, t.spec, mesh, "cpu")
        for t in weights.tree_leaves(g)]


@pytest.mark.parametrize("data,model", [(1, 4), (2, 4)])
def test_mesh_trainer_matches_reference_mesh(ref, data, model):
    cfg = _cfg()
    params = weights.from_reference(ref["params"], cfg, device="cpu")
    batch = {k: torch.tensor(v) for k, v in ref["batch"].items()}
    loss, grads = _mesh_loss_and_grads(cfg, params, batch, (data, model))
    want_loss, want = ref[(data, model)]
    assert abs(loss - want_loss) <= TOL["loss"] * abs(want_loss)
    want = weights.tree_leaves(want)
    assert len(want) == len(grads)
    for w, got in zip(want, grads):
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(got.numpy() - w).max())
        assert err <= TOL["grad"] * scale, (err, scale)


def test_mesh_prefill_and_decode_match_reference_mesh(ref):
    cfg = _cfg()
    params = weights.from_reference(ref["params"], cfg, device="cpu")
    mesh = make_test_mesh(1, 4, devices="cpu")
    with use_sharding(mesh):
        placed = weights.shard_params(params, cfg, mesh)
        pre = steps.make_prefill_step(cfg, SS + GEN, mesh=mesh)
        ser = steps.make_serve_step(cfg, mesh=mesh)
        lg, c = pre(placed, torch.tensor(ref["prompts"]))
        tok = lg.argmax(-1).to(torch.int32)
        toks, lgs = [tok], [lg]
        for i in range(GEN - 1):
            tok, lg, c = ser(placed, tok, c, SS + i)
            toks.append(tok)
            lgs.append(lg)
    want_t, want_l = ref["serve"]
    np.testing.assert_array_equal(torch.cat(toks, -1).numpy(), want_t)
    err = float(np.abs(torch.stack(lgs).numpy() - want_l).max())
    assert err <= TOL["logits"], err


@pytest.mark.parametrize("data,model", [(1, 4), (2, 4)])
def test_mesh_trainer_matches_one_device(data, model):
    cfg, batch = _cfg(), _batch(_cfg())
    tree = weights.to_reference(_params(cfg), cfg)
    leaves = [l.detach().requires_grad_() for l in weights.tree_leaves(tree)]
    loss, _ = lm.loss_fn(weights.unstack(weights.tree_unflatten(
        tree, leaves), cfg), cfg, batch)
    want = torch.autograd.grad(loss, leaves, allow_unused=True)
    loss = float(loss.detach())
    got_loss, got = _mesh_loss_and_grads(cfg, _params(cfg), batch,
                                         (data, model))
    assert abs(got_loss - loss) <= 1e-6 * loss
    for a, b in zip(want, got):
        a = torch.zeros_like(b) if a is None else a
        assert float((a - b).abs().max()) <= \
            1e-5 * max(float(a.abs().max()), 1e-30)


def test_mesh_prefill_and_decode_match_one_device():
    cfg, tok = _cfg(), _batch(_cfg())["tokens"]
    lg1, c1 = steps.make_prefill_step(cfg, max_len=S + 1)(_params(cfg), tok)
    nxt = lg1.argmax(-1).to(torch.int32)
    _, d1, _ = steps.make_serve_step(cfg)(_params(cfg), nxt, c1, S)
    mesh = make_test_mesh(1, 4, devices="cpu")
    with use_sharding(mesh):
        placed = weights.shard_params(_params(cfg), cfg, mesh)
        lg, c = steps.make_prefill_step(cfg, max_len=S + 1, mesh=mesh)(
            placed, tok)
        _, d, _ = steps.make_serve_step(cfg, mesh=mesh)(placed, nxt, c, S)
    assert float((lg - lg1).abs().max()) <= 1e-5
    assert float((d - d1).abs().max()) <= 1e-5


def test_q_columns_the_axis_does_not_divide_are_refused():
    cfg = get_tiny_config("qwen3-14b").replace(d_ff=96)
    with pytest.raises(NotImplementedError, match="n_heads \\* head_dim"):
        steps.check_mesh(cfg, make_test_mesh(1, 3, devices="cpu"))
