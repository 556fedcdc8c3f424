"""The mesh trainer for every family, and the pipeline's backward, held
against the JAX reference's own mesh (CPU positions, fp32, tiny widths).

The reference runs once, in one subprocess with 4 forced host devices,
on meshes it builds itself with Auto axes (``jax.make_mesh(shape,
("data", "model"), axis_types=(AxisType.Auto,) * 2)``: the package's
``make_test_mesh`` gives Explicit axes on this jax, under which its
``with_sharding_constraint`` raises).  It writes its parameters, each
case's ``lm.loss_fn`` loss and ``jax.grad`` gradients, and the
pipeline's, to a temporary file; the port runs in this process on the
same parameters (``weights.from_reference``).

* MoE (grok-1) on (1,2), (2,2) and (2,1), under expert-TP (the default
  rules) and EP (``{"expert": "model", "expert_ff": None}``); DeepSeek-V3
  (MLA, shared experts, MTP) on (1,2) and (2,2); RWKV-6 and RG-LRU on
  (1,2).  On a data axis the reference's loss is not its one-device
  loss (capacity from a data group's tokens, the load-balance loss
  averaged over the groups): the control holds that DeepSeek's (2,2)
  mesh loss differs from its one-device loss, and the port matches the
  mesh's.
* ``pipeline_apply``'s gradients (stage parameters and input) against
  ``jax.grad`` of the reference's on a 2-stage mesh.

Gates (the two sides sum in another order): loss within 1e-5 of its
value (read: 1.2e-7); every gradient leaf within 1e-4 of its largest
entry (read: 1.3e-5 on RWKV-6, at most 1.5e-6 elsewhere); the
pipeline's within 1e-5.
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
from repro_torch.launch.mesh import make_mesh, make_test_mesh
from repro_torch.models import lm as tlm
from repro_torch.parallel import collectives as col
from repro_torch.parallel.pipeline import pipeline_apply
from repro_torch.parallel.sharding import sum_regions, use_sharding

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
EP = {"expert": "model", "expert_ff": None}
B, S = 4, 32
CASES = [("grok-1-314b", (1, 2), None), ("grok-1-314b", (1, 2), EP),
         ("grok-1-314b", (2, 2), None), ("grok-1-314b", (2, 2), EP),
         ("grok-1-314b", (2, 1), None),
         ("deepseek-v3-671b", (1, 2), None),
         ("deepseek-v3-671b", (2, 2), None),
         ("rwkv6-1.6b", (1, 2), None), ("recurrentgemma-2b", (1, 2), None)]
TOL = dict(loss=1e-5, grad=1e-4, pipe=1e-5)

REF_SCRIPT = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_tiny_config
from repro.models import lm
from repro.parallel.pipeline import pipeline_apply
from repro.parallel.sharding import use_sharding

B, S = %(B)d, %(S)d
def mesh(shape, names=("data", "model")):
    return jax.make_mesh(shape, names,
                         axis_types=(jax.sharding.AxisType.Auto,) * len(shape))

def batch_of(cfg):
    r = np.random.default_rng(5)
    return {"tokens": r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "mask": (r.random((B, S)) < 0.9).astype(np.float32)}

out = {"params": {}, "batch": {}, "cases": {}}
for arch, shape, rules in %(cases)r:
    cfg = get_tiny_config(arch).replace(activation_dtype="float32",
                                        param_dtype="float32")
    if arch not in out["params"]:
        params = lm.init_params(jax.random.PRNGKey(0), cfg)
        out["params"][arch] = jax.tree.map(np.asarray, params)
        out["batch"][arch] = batch_of(cfg)
    params = jax.tree.map(jnp.asarray, out["params"][arch])
    batch = jax.tree.map(jnp.asarray, out["batch"][arch])
    f = lambda p: lm.loss_fn(p, cfg, batch)[0]
    if shape == (1, 1):
        loss, g = jax.jit(jax.value_and_grad(f))(params)
    else:
        with use_sharding(mesh(shape), rules):
            loss, g = jax.jit(jax.value_and_grad(f))(params)
    out["cases"][(arch, shape, str(rules))] = (
        float(loss), jax.tree.map(np.asarray, g))

r = np.random.default_rng(9)
pw = r.standard_normal((2, 8, 8)).astype(np.float32) * 0.5
pb = r.standard_normal((2, 8)).astype(np.float32) * 0.1
px = r.standard_normal((4, 3, 8)).astype(np.float32)
pc = r.standard_normal((4, 3, 8)).astype(np.float32)
def stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])
def pipe_loss(p, x):
    y = pipeline_apply(stage, p, x, n_micro=2, axis="stage")
    return jnp.sum(y * pc)
with use_sharding(mesh((2,), ("stage",))):
    val, (gp, gx) = jax.jit(jax.value_and_grad(pipe_loss, argnums=(0, 1)))(
        {"w": jnp.asarray(pw), "b": jnp.asarray(pb)}, jnp.asarray(px))
out["pipe"] = dict(w=pw, b=pb, x=px, c=pc, loss=float(val),
                   gw=np.asarray(gp["w"]), gb=np.asarray(gp["b"]),
                   gx=np.asarray(gx))
pickle.dump(out, open(sys.argv[1], "wb"))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "ref.pkl"
    cases = CASES + [("deepseek-v3-671b", (1, 1), None)]
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = env.get("XLA_FLAGS", "") + \
        " --xla_force_host_platform_device_count=4"
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(
        REF_SCRIPT % dict(B=B, S=S, cases=cases)), str(path)],
        capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def _cfg(arch):
    return get_tiny_config(arch).replace(activation_dtype="float32",
                                         param_dtype="float32")


def _port_loss_and_grads(ref, arch, shape, rules):
    cfg = _cfg(arch)
    params = weights.from_reference(ref["params"][arch], cfg, device="cpu")
    batch = {k: torch.tensor(v) for k, v in ref["batch"][arch].items()}
    mesh = make_test_mesh(*shape, devices="cpu")
    with use_sharding(mesh, rules):
        metrics, grads = steps.mesh_loss_and_grads(
            cfg, weights.shard_params(params, cfg, mesh), batch)
    return metrics, [sum_regions(g.shards, g.shape, g.spec, mesh, "cpu")
                     for g in weights.tree_leaves(grads)]


@pytest.mark.parametrize("arch,shape,rules", CASES,
                         ids=[f"{a}-{s[0]}x{s[1]}-{'ep' if r else 'tp'}"
                              for a, s, r in CASES])
def test_mesh_loss_and_grads_match_reference_mesh(ref, arch, shape, rules):
    loss, g_ref = ref["cases"][(arch, shape, str(rules))]
    metrics, grads = _port_loss_and_grads(ref, arch, shape, rules)
    assert abs(float(metrics["loss"]) - loss) <= TOL["loss"] * abs(loss)
    g_ref = weights.tree_leaves(g_ref)
    assert len(g_ref) == len(grads)
    for want, got in zip(g_ref, grads):
        scale = max(float(np.abs(want).max()), 1e-12)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= TOL["grad"] * scale, (err, scale)


def test_data_axis_changes_deepseek_loss_as_the_reference_does(ref):
    """Control: on (2,2) the reference's DeepSeek loss is not its
    one-device loss (MoE capacity from a data group's tokens, the aux
    averaged), and the port's is the mesh's."""
    mesh_loss = ref["cases"][("deepseek-v3-671b", (2, 2), "None")][0]
    local = ref["cases"][("deepseek-v3-671b", (1, 1), "None")][0]
    assert abs(mesh_loss - local) > 10 * TOL["loss"] * abs(local)
    metrics, _ = _port_loss_and_grads(ref, "deepseek-v3-671b", (2, 2), None)
    assert abs(float(metrics["loss"]) - mesh_loss) <= \
        TOL["loss"] * abs(mesh_loss)
    assert "mtp_ce" in metrics and float(metrics["moe_aux"]) > 0


def test_pipeline_backward_matches_reference(ref):
    """The GPipe ticks' gradients, through the hand-ons' sends, equal
    ``jax.grad`` of the reference's ``pipeline_apply``; the backward
    carries as many bytes between the stages as the forward."""
    p = ref["pipe"]
    w = torch.tensor(p["w"], requires_grad=True)
    b = torch.tensor(p["b"], requires_grad=True)
    x = torch.tensor(p["x"], requires_grad=True)
    mesh = make_mesh((2,), ("stage",), devices="cpu")
    col.WIRE.clear()
    with use_sharding(mesh):
        y = pipeline_apply(lambda q, t: torch.tanh(t @ q["w"] + q["b"]),
                           [{"w": w[s], "b": b[s]} for s in range(2)], x,
                           n_micro=2)
    loss = (y * torch.tensor(p["c"])).sum()
    fwd = col.WIRE["pipeline ppermute"]
    gw, gb, gx = torch.autograd.grad(loss, (w, b, x))
    assert abs(float(loss.detach()) - p["loss"]) <= \
        TOL["pipe"] * abs(p["loss"])
    for got, want in ((gw, p["gw"]), (gb, p["gb"]), (gx, p["gx"])):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=TOL["pipe"] * np.abs(want).max())
    assert fwd > 0 and col.WIRE["pipeline ppermute"] == 2 * fwd


def test_moe_expert_weights_gather_over_the_data_axis():
    """On a (2,2) mesh the experts' weights are stored over the data axis
    (the reference's "fsdp") and each model position's MoE layer gathers
    its expert-TP block of them when it runs, and again in the
    checkpointed cycle's recompute (the reference's ``jax.checkpoint``ed
    scan body); the gathers and their transpose are counted."""
    cfg = _cfg("grok-1-314b")
    params = weights.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    mesh = make_test_mesh(2, 2, devices="cpu")
    r = np.random.default_rng(0)
    batch = {"tokens": torch.tensor(r.integers(0, 256, (B, S)),
                                    dtype=torch.int32),
             "labels": torch.tensor(r.integers(0, 256, (B, S)),
                                    dtype=torch.int32),
             "mask": torch.ones((B, S))}
    with use_sharding(mesh):
        st = weights.shard_params(params, cfg, mesh)
        up = st["segments"][0][0]["moe"]["e_up"]
        assert up.spec == (None, None, "data", "model")
        col.WIRE.clear()
        steps.mesh_loss_and_grads(cfg, st, batch)
    assert cfg.remat and all(s.scanned for s in tlm.make_segments(cfg))
    assert col.WIRE["fsdp all_gather"] > 0
    assert 2 * col.WIRE["fsdp reduce_scatter"] == col.WIRE["fsdp all_gather"]
