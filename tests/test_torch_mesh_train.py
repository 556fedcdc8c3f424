"""The port's training on a device mesh, on CPU positions, held against
the JAX reference where its mesh pieces still run on this jax, and
against the port's own one-device trainer elsewhere (the reference's
sharded train step is no oracle here: ROADMAP Queue C).

* ``param_specs`` and ``adam.state_specs`` (fp32 and int8 moments) equal
  the reference's for all eleven tiny configs on (2,4), (4,2) and
  (2,2,2) meshes; the reference's specs, its ``compressed_all_reduce``
  rounds, ``wire_bytes`` and a checkpoint it saved sharded on a (4,2)
  mesh come from ONE subprocess with 8 forced host devices.  jax 0.9's
  ``PartitionSpec`` stores a one-axis tuple entry as the axis name, so
  both sides are compared with ("data",) written "data";
* the mesh trainer's loss and grad norm (3 steps), its step-0 gradients
  and its 3-step parameters and moments equal the one-device trainer's
  within the train-step parity gates (chip_smoke.py's STEP_TOL), on
  (2,1), (1,2), (2,2) and (2,2,2)
  meshes (tiny-100m, qwen3-14b, gemma2-27b, hubert-xlarge), for rwkv6
  and recurrentgemma on (2,1), and for hubert at a vocabulary of 65 on
  (1,2) (the loss's fallback); int8 moments on (2,2) and (2,2,2);
* on a (2,2) mesh the loss equals the reference's one-device
  ``lm.loss_fn`` on the same parameters within 1e-5 relative, and the
  gradients its ``jax.value_and_grad`` within 2e-4 of a leaf's max;
* ``compressed_all_reduce`` equals the reference's over 4 positions
  within one int8 code, its bytes ``wire_bytes``; a reference checkpoint
  saved sharded on (4,2) restores onto the port's (2,4) mesh bit for
  bit; ``rebatch`` equals the reference's on a hypothesis grid; each
  collective counts the bytes it moved; the train loop restarts on a
  mesh.

Gates (fp32 activations and parameters; the two sides sum in another
order): loss and grad norm within 1e-4 of their value; every gradient
leaf within 1e-5 of its largest entry (read: 9.3e-7); parameters at most
1e-3 of a leaf's elements more than 1e-6 of its largest entry apart,
except that a leaf that is zero at init (RWKV-6's mixes and ln bias,
RG-LRU's gate biases) is all update, lr m/(sqrt(v)+eps) a step, and is
held to the moments' gate instead; fp32 moments within 1e-3 of a leaf's
largest entry; int8 codes within 3 on at most 1e-3 of them, block
scales within 3/127 of themselves.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypothesis_compat import given, settings, st
from repro.configs import get_tiny_config as jtiny
from repro.models import lm as jlm
from repro.runtime import elastic as jelastic
from repro_torch import steps, weights
from repro_torch.configs import get_tiny_config, list_archs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import make_mesh, make_test_mesh
from repro_torch.models import lm
from repro_torch.optim import adam, compress, quant
from repro_torch.parallel import collectives as col
from repro_torch.parallel.sharding import (gather, param_specs, path_str,
                                           region, sum_regions, use_sharding)
from repro_torch.runtime import checkpoint as ckpt, elastic, train_loop

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = ((1, 2, 4), (1, 4, 2), (2, 2, 2))        # (pod, data, model)
B, S, STEPS, LR = 4, 64, 3, 1e-3
TOL = dict(metric=1e-4, grad=1e-5, param_near=1e-6, param_share=1e-3,
           moment=1e-3, codes=1e-3)

REF_SCRIPT = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro import steps
from repro.configs import get_tiny_config, list_archs
from repro.launch.mesh import make_test_mesh
from repro.models import lm
from repro.optim import adam, compress, quant
from repro.parallel.sharding import param_specs, path_str, use_sharding
from repro.runtime import checkpoint as ckpt, elastic

out_dir = sys.argv[1]

def spec(s):
    return [list(e) if isinstance(e, tuple) else e for e in s]

def moment(s):
    if isinstance(s, quant.QTensor):
        return {"q": spec(s.q), "scale": spec(s.scale), "mode": s.mode}
    return spec(s)

specs = {}
for pod, data, model in %(meshes)r:
    mesh = make_test_mesh(data, model, pod)
    for arch in list_archs():
        cfg = get_tiny_config(arch)
        p_shape = steps.abstract_params(cfg)
        with use_sharding(mesh) as env:
            ps = param_specs(p_shape, env)
            flat = jax.tree_util.tree_flatten_with_path(
                ps, is_leaf=lambda x: isinstance(x, P))[0]
            rec = {"params": {path_str(k): spec(v) for k, v in flat}}
            for sd in ("float32", "int8"):
                o = adam.state_specs(p_shape, adam.AdamConfig(state_dtype=sd),
                                     ps)
                rec[sd] = {"m": [moment(x) for x in o.m],
                           "v": [moment(x) for x in o.v]}
        specs["%%dx%%dx%%d/%%s" %% (pod, data, model, arch)] = rec

g = jnp.asarray(np.random.default_rng(3).standard_normal(3000)
                .astype(np.float32))
rounds = []
with use_sharding(jax.make_mesh((4,), ("data",))):
    err = jnp.zeros_like(g)
    for _ in range(8):
        red, err = jax.jit(lambda g, e: compress.compressed_all_reduce(
            g, e, axis="data"))(g, err)
        rounds.append([np.asarray(red).tolist(), np.asarray(err).tolist()])
wire = {"%%d/%%d/%%s" %% (s, n, k): compress.wire_bytes(s, n, k)
        for s in (3000, 1 << 20) for n in (2, 4, 8)
        for k in ("fp32", "bf16", "int8_ef")}

cfg = get_tiny_config("qwen3-14b")
c = adam.AdamConfig()
params = lm.init_params(jax.random.PRNGKey(0), cfg)
gr = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
params, opt, _ = adam.update(gr, adam.init(params, c), params, lr=1e-2, cfg=c)
with use_sharding(make_test_mesh(4, 2)) as env:
    ps, os_ = elastic.state_shardings(cfg, c, env)
    ckpt.save(out_dir + "/ckpt", 5, {"params": jax.device_put(params, ps),
                                     "opt": jax.device_put(opt, os_)})
json.dump({"specs": specs, "compress": {"x": np.asarray(g).tolist(),
                                        "rounds": rounds},
           "wire": wire}, open(out_dir + "/ref.json", "w"))
print("OK")
""" % {"meshes": MESHES}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs files on several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's specs, compressed all-reduce rounds, wire bytes
    and sharded checkpoint, from one subprocess with 8 host devices."""
    d = tmp_path_factory.mktemp("ref_mesh")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = env.get("XLA_FLAGS", "") + \
        " --xla_force_host_platform_device_count=8"
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REF_SCRIPT),
                        str(d)], capture_output=True, text=True,
                       timeout=600, env=env)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    out = json.loads((d / "ref.json").read_text())
    out["ckpt"] = str(d / "ckpt")
    return out


def _norm(entry):
    if isinstance(entry, (tuple, list)):
        return entry[0] if len(entry) == 1 else list(entry)
    return entry


def _spec(s):
    return [_norm(e) for e in s]


def _moment(s):
    if isinstance(s, quant.QTensor):
        return {"q": _spec(s.q), "scale": _spec(s.scale), "mode": s.mode}
    return _spec(s)


def _flat_specs(t, path=(), out=None):
    out = {} if out is None else out
    if isinstance(t, dict):
        for k, v in t.items():
            _flat_specs(v, path + (k,), out)
    elif isinstance(t, list):
        for i, v in enumerate(t):
            _flat_specs(v, path + (i,), out)
    else:
        out[path_str(path)] = _spec(t)
    return out


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda m: "x".join(
    map(str, m)))
@pytest.mark.parametrize("arch", list_archs())
def test_specs_match_the_reference(ref, arch, mesh_shape):
    pod, data, model = mesh_shape
    mesh = make_test_mesh(data, model, pod, devices="cpu")
    want = ref["specs"][f"{pod}x{data}x{model}/{arch}"]
    want = {"params": {k: [_norm(e) for e in v]
                       for k, v in want["params"].items()},
            **{sd: {k: [{f: (_spec(x[f]) if f != "mode" else x[f])
                         for f in x} if isinstance(x, dict) else _spec(x)
                        for x in v] for k, v in want[sd].items()}
               for sd in ("float32", "int8")}}
    p_shape = steps.abstract_params(get_tiny_config(arch))
    with use_sharding(mesh) as env:
        ps = param_specs(p_shape, env)
        assert _flat_specs(ps) == want["params"]
        for sd in ("float32", "int8"):
            o = adam.state_specs(p_shape, adam.AdamConfig(state_dtype=sd), ps)
            assert {"m": [_moment(x) for x in o.m],
                    "v": [_moment(x) for x in o.v]} == want[sd], sd


# ---------------------------------------------------------------------------
# the mesh trainer against the one-device trainer
# ---------------------------------------------------------------------------
def _cfg(arch):
    """The tiny config at fp32; "arch:V" with its vocabulary set to V."""
    arch, _, vocab = arch.partition(":")
    cfg = get_tiny_config(arch).replace(activation_dtype="float32",
                                        param_dtype="float32")
    return cfg.replace(vocab_size=int(vocab)) if vocab else cfg


def _batch(cfg, i):
    """Seeded rows with a mask that differs between the data groups."""
    r = np.random.default_rng(100 + i)
    b = {"tokens": r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "labels": r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "mask": (r.random((B, S)) < 0.75).astype(np.float32)}
    if not cfg.embed_inputs:
        b["tokens"] = r.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _init(cfg):
    return weights.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


_ONE = {}


def _one_device(arch, state_dtype):
    """The one-device trainer's step-0 gradients and 3 steps (cached)."""
    key = (arch, state_dtype)
    if key not in _ONE:
        cfg = _cfg(arch)
        tree = weights.to_reference(_init(cfg), cfg)
        leaves = [l.detach().requires_grad_()
                  for l in weights.tree_leaves(tree)]
        loss, _ = lm.loss_fn(weights.unstack(weights.tree_unflatten(
            tree, leaves), cfg), cfg, _batch(cfg, 0))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        c = adam.AdamConfig(state_dtype=state_dtype)
        step = steps.make_train_step(cfg, c, lambda s: LR)
        p, o, hist = _init(cfg), adam.init(tree, c), []
        for i in range(STEPS):
            p, o, m = step(p, o, _batch(cfg, i))
            hist.append({k: float(m[k]) for k in ("loss", "grad_norm")})
        _ONE[key] = (grads, hist, weights.tree_leaves(
            weights.to_reference(p, cfg)), o, [l.detach() for l in leaves])
    return _ONE[key]


def _mesh_run(arch, mesh, state_dtype):
    cfg = _cfg(arch)
    c = adam.AdamConfig(state_dtype=state_dtype)
    step = steps.make_train_step(cfg, c, lambda s: LR)
    with use_sharding(mesh):
        tree = weights.shard_params(_init(cfg), cfg, mesh)
        _, g = steps.mesh_loss_and_grads(cfg, tree, _batch(cfg, 0))
        grads = [sum_regions(t.shards, t.shape, t.spec, mesh, "cpu")
                 for t in weights.tree_leaves(g)]
        o, hist = adam.init(tree, c), []
        for i in range(STEPS):
            tree, o, m = step(tree, o, _batch(cfg, i))
            hist.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    return grads, hist, [gather(t, "cpu") for t in weights.tree_leaves(
        tree)], o


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)


def _assert_parity(one, got, state_dtype):
    g1, h1, p1, o1, init = one
    g2, h2, p2, o2 = got
    for x, y in zip(h1, h2):
        for k in x:
            assert abs(x[k] - y[k]) <= TOL["metric"] * abs(x[k]), (k, x, y)
    for a, b in zip(g1, g2):
        assert _rel(torch.zeros_like(b) if a is None else a, b) \
            <= TOL["grad"]
    for a, b, a0 in zip(p1, p2, init):
        if not bool(a0.any()):        # zero at init: all update
            assert _rel(a, b) <= TOL["moment"]
            continue
        off = float(((a - b).abs() > TOL["param_near"] * a.abs().max())
                    .float().mean())
        assert off <= TOL["param_share"], off
    for a, b in zip(o1.m + o1.v, o2.m + o2.v):
        if isinstance(a, quant.QTensor):
            d = (a.q.int() - gather(b.q, "cpu").int()).abs()
            assert int(d.max()) <= STEPS
            assert float((d > 0).float().mean()) <= TOL["codes"]
            sc = gather(b.scale, "cpu")
            assert float(((a.scale - sc).abs() / a.scale.clamp(
                min=1e-30)).max()) <= STEPS / 127
        else:
            assert _rel(a, gather(b, "cpu")) <= TOL["moment"]


PARITY = [(a, m) for m in ((1, 2, 1), (1, 1, 2), (1, 2, 2), (2, 2, 2))
          for a in ("tiny-100m", "qwen3-14b", "gemma2-27b", "hubert-xlarge")]
PARITY += [("rwkv6-1.6b", (1, 2, 1)), ("recurrentgemma-2b", (1, 2, 1)),
           # a vocabulary the model axis does not divide: the head stays
           # whole on every position and the group's root takes the loss
           ("hubert-xlarge:65", (1, 1, 2))]


@pytest.mark.parametrize("arch,mesh_shape", PARITY, ids=lambda x: x if
                         isinstance(x, str) else "x".join(map(str, x)))
def test_mesh_trainer_matches_one_device(arch, mesh_shape):
    pod, data, model = mesh_shape
    mesh = make_test_mesh(data, model, pod, devices="cpu")
    _assert_parity(_one_device(arch, "float32"),
                   _mesh_run(arch, mesh, "float32"), "float32")


@pytest.mark.parametrize("mesh_shape", [(1, 2, 2), (2, 2, 2)],
                         ids=["2x2", "2x2x2"])
def test_mesh_trainer_int8_moments(mesh_shape):
    pod, data, model = mesh_shape
    mesh = make_test_mesh(data, model, pod, devices="cpu")
    _assert_parity(_one_device("qwen3-14b", "int8"),
                   _mesh_run("qwen3-14b", mesh, "int8"), "int8")


def test_a_batch_that_does_not_split_is_refused():
    cfg = _cfg("qwen3-14b")
    mesh = make_test_mesh(2, 2, devices="cpu")
    batch = {k: v[:3] for k, v in _batch(cfg, 0).items()}
    with use_sharding(mesh):
        tree = weights.shard_params(_init(cfg), cfg, mesh)
        with pytest.raises(ValueError, match="does not split"):
            steps.mesh_loss_and_grads(cfg, tree, batch)


def test_mesh_loss_matches_the_reference_loss():
    """(2,2) mesh, tiny qwen3-14b on the reference's parameters: the loss
    within 1e-5 of the reference's one-device ``lm.loss_fn``, and each
    gradient leaf (the positions' shares summed) within 2e-4 of the
    leaf's largest entry of ``jax.value_and_grad``'s (fp32 leaves;
    2**-7 for a bf16 leaf, one rounding), as tests/test_torch_train_loss
    holds the one-device gradients."""
    jcfg = jtiny("qwen3-14b").replace(activation_dtype="float32")
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    batch = _batch(_cfg("qwen3-14b"), 0)
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    (want, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jcfg, jb), has_aux=True))(jp)
    cfg = get_tiny_config("qwen3-14b").replace(activation_dtype="float32")
    params = weights.from_reference(jax.tree.map(np.asarray, jp), cfg,
                                    device="cpu")
    mesh = make_test_mesh(2, 2, devices="cpu")
    with use_sharding(mesh):
        tree = weights.shard_params(params, cfg, mesh)
        m, g = steps.mesh_loss_and_grads(cfg, tree, batch)
    assert abs(float(m["loss"]) - float(want)) <= 1e-5 * abs(float(want))
    got = [sum_regions(t.shards, t.shape, t.spec, mesh, "cpu")
           for t in weights.tree_leaves(g)]
    want_g = jax.tree.leaves(jg)
    assert len(got) == len(want_g)
    for a, t in zip(want_g, got):
        a = np.asarray(a, np.float32)
        assert tuple(t.shape) == a.shape
        tol = {torch.float32: 2e-4, torch.bfloat16: 2.0 ** -7}[t.dtype]
        err = float(np.abs(a - t.float().numpy()).max())
        assert err <= tol * float(np.abs(a).max()) + 1e-30, (a.shape, err)


# ---------------------------------------------------------------------------
# compressed all-reduce, checkpoints, rebatch, the collectives' bytes
# ---------------------------------------------------------------------------
def test_compressed_all_reduce_matches_the_reference(ref):
    """4 positions, 8 error-feedback rounds of the reference's
    replicated input: the reduced value and the residual within one int8
    code of their block (the sums of dequantized chunks run in another
    order); the bytes each position receives are ``wire_bytes``."""
    x = torch.tensor(ref["compress"]["x"])
    mesh = make_mesh((4,), ("data",), devices="cpu")
    err = torch.zeros_like(x)
    with use_sharding(mesh):
        for want_red, want_err in ref["compress"]["rounds"]:
            stats = {}
            red, err = compress.compressed_all_reduce(x, err, "data",
                                                      stats=stats)
            for got, want in ((red, want_red), (err, want_err)):
                want = torch.tensor(want)
                pad = (-want.numel()) % quant.BLOCK
                code = torch.nn.functional.pad(want.abs(), (0, pad)).reshape(
                    -1, quant.BLOCK).amax(1).repeat_interleave(quant.BLOCK)[
                    :want.numel()] / 127
                assert bool(((got - want).abs() <= code * 1.01 + 1e-7).all())
            # 3000 values pad to 3072: the bytes of the padded chunks
            assert sum(stats.values()) == compress.wire_bytes(3072, 4)
    for key, want in ref["wire"].items():
        s, n, k = key.split("/")
        assert compress.wire_bytes(int(s), int(n), k) == want


def test_compressed_all_reduce_per_position_values():
    """One gradient per position: the mean within one code, the residual
    exactly what the quantizer dropped."""
    mesh = make_test_mesh(4, 1, devices="cpu")
    g = [torch.randn(4096, generator=torch.Generator().manual_seed(i))
         for i in range(4)]
    with use_sharding(mesh):
        out, err = compress.compressed_all_reduce(
            g, [torch.zeros(4096)] * 4, "data")
    mean = torch.stack(g).mean(0)
    for o, e, x in zip(out, err, g):
        assert torch.equal(o, out[0])
        assert float((o - mean).abs().max()) <= 2 * float(
            torch.stack(g).abs().max()) / 127
        q, s = compress._q8(x)
        assert torch.equal(e, x - compress._dq8(q, s))


def test_reference_sharded_checkpoint_restores_on_another_mesh(ref):
    """Saved by the reference sharded on a (4,2) mesh, restored by the
    port onto a (2,4) mesh: every position's block is the logical
    array's, bit for bit, placed by the port's specs."""
    cfg = get_tiny_config("qwen3-14b")
    mesh = make_test_mesh(2, 4, devices="cpu")
    step, params, opt = elastic.restore_elastic(
        ref["ckpt"], cfg, adam.AdamConfig(), mesh)
    assert step == 5 and int(opt.step) == 1
    arrays = np.load(os.path.join(ref["ckpt"], "step_00000005",
                                  "arrays.npz"))
    state = {"params": params, "opt": opt}
    n = 0
    for path, leaf in ckpt._items(state):
        want = torch.from_numpy(arrays["/".join(path)])
        if leaf.ndim == 0:
            assert torch.equal(leaf.cpu(), want)
            continue
        for p, t in enumerate(leaf.shards):
            assert torch.equal(t, want[region(leaf.shape, leaf.spec, mesh,
                                              p)])
            n += 1
    assert n > 8 * 20
    with use_sharding(mesh) as env:
        specs = param_specs(steps.abstract_params(cfg), env)
    assert [l.spec for l in weights.tree_leaves(params)] == \
        weights.tree_leaves_specs(specs)


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 512), st.integers(1, 16), st.integers(1, 16),
       st.integers(1, 8))
def test_rebatch_matches_the_reference(global_batch, old, new, accum):
    assert elastic.rebatch(global_batch, old, new, accum) == \
        jelastic.rebatch(global_batch, old, new, accum)


@pytest.mark.parametrize("n", [2, 4])
def test_collectives_count_the_bytes_they_move(n):
    """Forward and backward of gather_seq, column_parallel and
    row_parallel on an n-position group: each counter holds the bytes of
    the blocks that crossed between positions, (n-1)/n of the full
    tensor a position, and the results equal the plain products."""
    g = col.Group(tuple(range(n)), (torch.device("cpu"),) * n)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8 * n, 16, generator=gen, requires_grad=True)
    w1 = torch.randn(16, 4 * n, generator=gen, requires_grad=True)
    w2 = torch.randn(4 * n, 16, generator=gen, requires_grad=True)
    xs = col.Shards(list(x.chunk(n, 1)), g, 1)
    col.WIRE.clear()
    (h,) = col.column_parallel(xs, [col.PerPos(w1.chunk(n, 1))])
    y = col.row_parallel(h, col.PerPos(w2.chunk(n, 0)))
    full = (x @ w1) @ w2
    assert torch.allclose(torch.cat(list(y), 1), full, atol=1e-4)
    grads = torch.autograd.grad(sum((t * t).sum() for t in y), (x, w1, w2))
    want = torch.autograd.grad((full * full).sum(), (x, w1, w2))
    for a, b in zip(grads, want):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-3)
    act = 2 * 8 * n * 16 * 4                # one (B, S, D) fp32 tensor
    each = act * (n - 1) // n               # what one position receives
    assert dict(col.WIRE) == {
        "seq all_gather": n * each, "seq reduce_scatter": n * each,
        "row_parallel reduce_scatter": n * each,
        "row_parallel all_gather": n * each}


def test_train_loop_restarts_on_a_mesh(tmp_path):
    """A (2,2) mesh run with checkpoints every 2 steps, stopped at step
    2 and restarted on a (1,4) mesh, repeats the uninterrupted run's
    step-2 and -3 losses (within 1e-5: the step runs on other groups)."""
    cfg = get_tiny_config("qwen3-14b").replace(activation_dtype="float32")
    shape = ShapeConfig("t", 32, 4, "train")
    job = lambda d: train_loop.TrainJobConfig(
        steps=4, log_every=1, ckpt_every=2, ckpt_dir=str(tmp_path / d),
        peak_lr=2e-3, warmup=1)
    full = train_loop.run(cfg, shape, mesh=make_test_mesh(2, 2,
                                                          devices="cpu"),
                          job=job("a"))

    def crash(step):
        if step == 2:
            raise RuntimeError("simulated node failure")
    with pytest.raises(RuntimeError, match="simulated"):
        train_loop.run(cfg, shape, mesh=make_test_mesh(2, 2, devices="cpu"),
                       job=job("b"), failure_hook=crash)
    again = train_loop.run(cfg, shape, mesh=make_test_mesh(
        1, 4, devices="cpu"), job=job("b"))
    assert [h["step"] for h in again["history"]] == [2, 3]
    for a, b in zip(full["history"][2:], again["history"]):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(a["loss"])
    assert isinstance(again["params"]["final_norm"]["scale"].shards, list)
