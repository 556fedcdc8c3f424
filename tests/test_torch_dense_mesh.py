"""The dense engine on a device mesh (CPU positions, fp32, tiny widths),
held against the JAX reference's own mesh.

The reference runs once, in one subprocess with 4 forced host devices,
on meshes it builds itself with Auto axes (``jax.make_mesh(shape,
("data", "model"), axis_types=(AxisType.Auto,) * 2)``: the package's
``make_test_mesh`` gives Explicit axes on this jax, under which its
``with_sharding_constraint`` raises), its jitted ``make_prefill_step`` and
``make_serve_step`` under ``use_sharding``: a batch of 4 prompts of 16
tokens, then 5 greedy decode steps (max_len 22), for the nine decoder
configs on (1,2) and on (2,2) or (1,4).  It writes its parameters,
tokens and logits to a temporary file; the port serves the same prompts
on the same parameters (``weights.from_reference``) on the same meshes
(``steps.make_prefill_step(mesh=)``).

* The greedy tokens are identical and every step's logits (the
  prefill's and the decode steps') within 5e-5 (read: 1.9e-5; the
  logits reach 70): tensor parallelism sums in another order.
* A cache of 22 slots splits over 2 positions (split-T decode, the
  attention and MLA caches in time blocks) and not over 4, where every
  position keeps the whole cache (the reference's fallback): both run.
* A data group sizes the MoE capacity from its own tokens, as the
  reference's does: DeepSeek's (2,2) logits can differ from one
  device's (the reference's own such difference is held in
  ``test_torch_mesh_families.py``).
* The caches are Sharded by the reference's ``cache_specs``; the split-T
  merge, the gathers and the MoE's combine count their bytes.
* The serve CLI's dense engine takes ``--devices``, ``--data``,
  ``--model`` and ``--layout auto``.
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
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.parallel import collectives as col
from repro_torch.parallel.sharding import gather, use_sharding

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CASES = [("tiny-100m", (1, 4)), ("qwen3-14b", (2, 2)),
         ("minitron-8b", (1, 4)), ("qwen3-1.7b", (2, 2)),
         ("gemma2-27b", (1, 4)), ("recurrentgemma-2b", (1, 4)),
         ("deepseek-v3-671b", (2, 2)), ("grok-1-314b", (2, 2)),
         ("rwkv6-1.6b", (1, 4))]
B, S, GEN = 4, 16, 6
LOGIT_TOL = 5e-5

REF_SCRIPT = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro import steps
from repro.configs import get_tiny_config
from repro.models import lm
from repro.parallel.sharding import use_sharding

B, S, GEN = %(B)d, %(S)d, %(GEN)d
out = {}
for arch, second in %(cases)r:
    cfg = get_tiny_config(arch).replace(activation_dtype="float32",
                                        param_dtype="float32")
    params = lm.init_params(jax.random.PRNGKey(0), cfg)
    tokens = jnp.asarray(np.random.default_rng(1).integers(
        2, cfg.vocab_size, (B, S)), jnp.int32)
    res = {"params": jax.tree.map(np.asarray, params),
           "tokens": np.asarray(tokens)}
    for shape in ((1, 2), second):
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        with use_sharding(mesh):
            pre = jax.jit(steps.make_prefill_step(cfg, max_len=S + GEN))
            ser = jax.jit(steps.make_serve_step(cfg))
            lg, c = pre(params, tokens)
            tok = jnp.argmax(lg, -1).astype(jnp.int32)
            toks, lgs = [tok], [lg]
            for i in range(GEN - 1):
                tok, lg, c = ser(params, tok, c, jnp.int32(S + i))
                toks.append(tok)
                lgs.append(lg)
        res[shape] = (np.asarray(jnp.concatenate(toks, -1)),
                      np.asarray(jnp.stack(lgs)))
    out[arch] = res
pickle.dump(out, open(sys.argv[1], "wb"))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = env.get("XLA_FLAGS", "") + \
        " --xla_force_host_platform_device_count=4"
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(
        REF_SCRIPT % dict(B=B, S=S, GEN=GEN, cases=CASES)), str(path)],
        capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def _cfg(arch):
    return get_tiny_config(arch).replace(activation_dtype="float32",
                                         param_dtype="float32")


def _serve(cfg, params, tokens, mesh, keep=None):
    """The port's dense engine, one device (``mesh`` None) or a mesh:
    (tokens (B, GEN), logits (GEN, B, 1, V)); ``keep`` gets the caches
    after the prefill and after the last step."""
    if mesh is None:
        pre = steps.make_prefill_step(cfg, S + GEN)
        ser = steps.make_serve_step(cfg)
        p = params
    else:
        p = weights.shard_params(params, cfg, mesh)
        pre = steps.make_prefill_step(cfg, S + GEN, mesh=mesh)
        ser = steps.make_serve_step(cfg, mesh=mesh)
    lg, c = pre(p, tokens)
    if keep is not None:
        keep.append(c)
    tok = lg.argmax(-1).to(torch.int32)
    toks, lgs = [tok], [lg]
    for i in range(GEN - 1):
        tok, lg, c = ser(p, tok, c, S + i)
        toks.append(tok)
        lgs.append(lg)
    if keep is not None:
        keep.append(c)
    return torch.cat(toks, -1).numpy(), torch.stack(lgs).numpy()


def _port(ref, arch, shape, keep=None):
    cfg = _cfg(arch)
    params = weights.from_reference(ref[arch]["params"], cfg, device="cpu")
    tokens = torch.tensor(ref[arch]["tokens"])
    if shape is None:
        return _serve(cfg, params, tokens, None)
    mesh = make_test_mesh(*shape, devices="cpu")
    with use_sharding(mesh):
        return _serve(cfg, params, tokens, mesh, keep)


@pytest.mark.parametrize("arch,second", CASES, ids=[a for a, _ in CASES])
def test_dense_mesh_matches_reference_mesh(ref, arch, second):
    for shape in ((1, 2), second):
        toks, logits = _port(ref, arch, shape)
        want_t, want_l = ref[arch][shape]
        np.testing.assert_array_equal(toks, want_t)
        err = float(np.abs(logits - want_l).max())
        assert err <= LOGIT_TOL, (shape, err)


def test_data_axis_sizes_moe_capacity_per_data_group():
    """A data group routes its own rows at the capacity of its own tokens
    (the reference's ``capacity(cfg, T)`` inside its ``shard_map``): with
    the port's seed-0 DeepSeek weights an expert overflows the capacity
    of 2 rows and not of 4, so the (2,2) mesh's logits differ from the
    one-device run's, while the (1,2) mesh's (one data group) do not."""
    cfg = _cfg("deepseek-v3-671b")
    tokens = torch.tensor(np.random.default_rng(0).integers(
        2, cfg.vocab_size, (B, S)), dtype=torch.int32)

    def run(shape):
        params = weights.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
        if shape is None:
            return _serve(cfg, params, tokens, None)[1]
        mesh = make_test_mesh(*shape, devices="cpu")
        with use_sharding(mesh):
            return _serve(cfg, params, tokens, mesh)[1]
    one = run(None)
    assert float(np.abs(run((1, 2)) - one).max()) <= LOGIT_TOL
    assert float(np.abs(run((2, 2)) - one).max()) > 1e3 * LOGIT_TOL


@pytest.mark.parametrize("arch,shape,split", [
    ("qwen3-14b", (1, 2), True), ("qwen3-14b", (1, 4), False),
    ("deepseek-v3-671b", (1, 2), True), ("recurrentgemma-2b", (2, 2), True),
    ("rwkv6-1.6b", (1, 2), True)])
def test_caches_placed_by_cache_specs(arch, shape, split):
    """After the prefill and the decode steps each cache field is a
    Sharded by ``cache_specs``: attention and MLA caches time-split when
    the group divides their 22 slots (whole on every position
    otherwise), the RG-LRU state over "model" by lanes, the RWKV-6 state
    by heads; gathered, the mesh's caches equal the one-device run's."""
    cfg = _cfg(arch)
    params = weights.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    tokens = torch.tensor(np.random.default_rng(2).integers(
        2, cfg.vocab_size, (B, S)), dtype=torch.int32)
    one, keep = [], []
    _serve(cfg, params, tokens, None, one)
    mesh = make_test_mesh(*shape, devices="cpu")
    with use_sharding(mesh):
        _serve(cfg, params, tokens, mesh, keep)
    for got, want in zip(weights.tree_leaves(keep[1]),
                         weights.tree_leaves(one[1])):
        assert got.shape == tuple(want.shape)
        if got.ndim == 3 and got.shape[1] == S + GEN:   # attention / MLA
            assert got.spec[1] == ("model" if split else None)
        torch.testing.assert_close(gather(got, "cpu"), want, rtol=0,
                                   atol=2e-5)
    kinds = set(cfg.layer_kinds)
    specs = {l.spec for l in weights.tree_leaves(keep[1])}
    if "rglru" in kinds:
        assert ("data", "model") in specs
    if "rwkv6" in kinds:
        assert ("data", "model", None, None) in specs


def test_decode_step_counts_its_collectives():
    """One decode step of qwen3 on (1,2): the split-T merge (max, then
    two sums), the gathers of q and k/v, the row-parallel all-reduces
    and the head's gather; grok's MoE all-reduces its expert-TP partial
    outputs.  Nothing is reduce-scattered: one token is never split."""
    for arch, want in (("qwen3-14b", "split_t all_reduce"),
                       ("grok-1-314b", "moe all_reduce")):
        cfg = _cfg(arch)
        params = weights.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
        mesh = make_test_mesh(1, 2, devices="cpu")
        tokens = torch.randint(2, 256, (2, S), dtype=torch.int32)
        with use_sharding(mesh):
            p = weights.shard_params(params, cfg, mesh)
            lg, c = steps.make_prefill_step(cfg, S + GEN, mesh=mesh)(p,
                                                                    tokens)
            col.WIRE.clear()
            steps.make_serve_step(cfg, mesh=mesh)(
                p, lg.argmax(-1).to(torch.int32), c, S)
        wire = dict(col.WIRE)
        assert wire[want] > 0 and wire["head all_gather"] > 0
        assert wire["row_parallel all_reduce"] > 0
        assert not any("reduce_scatter" in k for k in wire), wire
    assert wire["kv all_gather"] > 0 and wire["q all_gather"] > 0


@pytest.mark.parametrize("argv", [
    ["--devices", "4", "--data", "2", "--model", "2"],
    ["--devices", "4", "--layout", "auto"],
    ["--arch", "grok-1-314b", "--model", "2"],
    ["--arch", "rwkv6-1.6b", "--model", "2"]])
def test_serve_cli_dense_engine_on_a_mesh(argv, capsys):
    serve.main(["--tiny", "--device", "cpu", "--engine", "dense",
                "--requests", "4", "--prompt-len", "8", "--gen", "4",
                "--batch", "2"] + argv)
    out = capsys.readouterr().out
    assert "served 4 requests, 16 tokens" in out
    if "--layout" in argv:
        assert "[cost-engine]" in out
    else:
        assert "[dense] mesh {" in out


def test_serve_cli_refuses_a_model_axis_that_does_not_divide(capsys):
    """As the reference's specs do: 4 heads over a model axis of 3."""
    with pytest.raises(SystemExit) as e:
        serve.main(["--tiny", "--device", "cpu", "--model", "3"])
    assert e.value.code == 2
    assert "does not split over a model axis of 3" in capsys.readouterr().err
