"""The port's dry run (``launch/dryrun.py``), its roofline and its wire
model, held against the reference's on the CPU.

* ``analysis/roofline.analyze`` equals the reference's field for field
  (relative 1e-12) on every runnable cell of the eleven configs and the
  four shapes, on the 16x16 and 2x16x16 production meshes, with the
  reference's TPU constants (``REFERENCE_TPU``) and one fixed wire
  summary: arithmetic only, nothing compiled;
* ``analysis/wire.Collective.wire_bytes`` equals the reference's ring
  model for every op and group sizes 1 to 8 on a hypothesis grid;
* the reference's oracle, ONE subprocess with 8 forced host devices on a
  mesh it builds with Auto axes (``jax.make_mesh(..., axis_types=
  (AxisType.Auto,) * 2)``: the package's ``make_test_mesh`` gives
  Explicit axes on this jax, ROADMAP Queue C), lowers and compiles three
  tiny cells on 2x4: qwen3-14b ``train`` (16, 128), and a decode step of
  16 sequences over a 128-slot cache for qwen3-14b and for grok-1 under
  the ``--moe-ep`` rules.  The port's per-position
  ``argument_size_in_bytes`` equals XLA's (228,356, 173,604 and 149,796:
  each the sum of the reference's shard shapes), and so do the
  roofline's ``model_flops``, ``hlo_flops_global`` and
  ``hbm_bytes_per_chip``.  Both wire totals are above 0; their ratio by
  op is printed, not gated: GSPMD moves other bytes in other forms
  (all-to-all, collective-permute, fp32 all-reduces) than the port's
  explicit collectives;
* every kernel wrapper's meta branch: the CUDA path's checks, outputs of
  the kernel's shapes and dtypes, ``dry_calls`` counted and ``launches``
  not;
* ``main``: the skip path, a cell the shape rules skip, and
  ``append_record`` rewriting a cell's record.

The dry run against the port's own CPU run and its symmetries are in
``test_torch_dryrun_sym.py``.
"""
import json
import os
import subprocess
import sys
import textwrap
from dataclasses import asdict

import pytest
import torch

from hypothesis_compat import given, settings, st
from repro.analysis import hlo as jhlo, roofline as jroofline
from repro.configs import get_config as jget_config
from repro.configs.base import SHAPES as JSHAPES
from repro_torch.analysis import roofline, wire
from repro_torch.configs import SHAPES, cell_is_runnable, get_config
from repro_torch.configs import get_tiny_config, list_archs
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
EP = {"expert": "model", "expert_ff": None}
FIXED = {"wire_bytes_per_device": {"all-gather": 3.0e9,
                                   "reduce-scatter": 1.25e9,
                                   "all-reduce": 2.5e8},
         "operand_bytes_per_device": {}, "op_counts": {"all-gather": 7},
         "total_wire_bytes_per_device": 4.5e9,
         "total_operand_bytes_per_device": 0.0}

ORACLE = [("qwen3-14b train", "qwen3-14b", ("t", 128, 16, "train"), None),
          ("qwen3-14b decode", "qwen3-14b", ("d", 128, 16, "decode"), None),
          ("grok-1-314b decode ep", "grok-1-314b", ("d", 128, 16, "decode"),
           EP)]
REF_SCRIPT = """
import json, sys
import jax
from jax.sharding import AxisType
from repro import steps
from repro.analysis import hlo, roofline
from repro.configs import get_tiny_config
from repro.configs.base import ShapeConfig
from repro.parallel.sharding import use_sharding

mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {}
for name, arch, shape, rules in %(cases)r:
    cfg, shape = get_tiny_config(arch), ShapeConfig(*shape)
    with use_sharding(mesh, rules) as env:
        adam_cfg = steps.adam_config_for(cfg)
        sh = lambda tree: jax.tree.map(
            lambda s: s.sharding, tree,
            is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
        params, opt = steps.make_state_structs(cfg, adam_cfg, mesh, env)
        if shape.kind == "train":
            batch = steps.make_batch_struct(cfg, shape, mesh, env)
            jf = jax.jit(steps.make_train_step(cfg, adam_cfg),
                         donate_argnums=(0, 1),
                         out_shardings=(sh(params), sh(opt), None))
            lowered = jf.lower(params, opt, batch)
        else:
            tok, caches, pos = steps.make_decode_structs(cfg, shape, mesh,
                                                         env)
            jf = jax.jit(steps.make_serve_step(cfg), donate_argnums=(2,),
                         out_shardings=(None, None, sh(caches)))
            lowered = jf.lower(params, tok, caches, pos)
        compiled = lowered.compile()
        text = compiled.as_text()
        rl = roofline.analyze(cfg, shape, "2x4", 8, 4, hlo_text=text)
    out[name] = dict(
        arg=int(compiled.memory_analysis().argument_size_in_bytes),
        wire=hlo.collective_summary(text), model_flops=rl.model_flops,
        hlo_flops_global=rl.hlo_flops_global, hbm=rl.hbm_bytes_per_chip)
json.dump(out, open(sys.argv[1], "w"))
"""


def _rel_eq(a, b, tol=1e-12):
    if isinstance(a, float) or isinstance(b, float):
        return abs(a - b) <= tol * max(abs(a), abs(b), 1e-300)
    return a == b


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
def test_roofline_matches_the_reference_on_every_cell(multi, monkeypatch):
    monkeypatch.setattr(jroofline.hlo_mod, "collective_summary",
                        lambda text: FIXED)
    mesh_name, n = ("2x16x16", 512) if multi else ("16x16", 256)
    cells = 0
    for arch in list_archs():
        cfg, jcfg = get_config(arch), jget_config(arch)
        for name, shape in SHAPES.items():
            if not cell_is_runnable(cfg, shape)[0]:
                continue
            ca = {"flops": 1.5e15}
            want = asdict(jroofline.analyze(jcfg, JSHAPES[name], mesh_name,
                                            n, 16, hlo_text="",
                                            cost_analysis=ca))
            got = asdict(roofline.analyze(cfg, shape, mesh_name, n, 16,
                                          collectives=FIXED,
                                          cost_analysis=ca,
                                          hw=roofline.REFERENCE_TPU))
            assert got.pop("hardware") == roofline.REFERENCE_TPU.name
            assert got.keys() == want.keys()
            for k in want:
                assert _rel_eq(got[k], want[k]), (arch, name, k, got[k],
                                                  want[k])
            cells += 1
    assert cells == 34          # 31 of the ten archs, 3 of tiny-100m


def test_h100_constants_and_table():
    h = roofline.H100
    assert (h.peak_flops_bf16, h.hbm_bw, h.link_bw, h.memory_bytes) == \
        (989e12, 3.35e12, 450e9, 80e9)
    cfg, shape = get_config("qwen3-14b"), SHAPES["train_4k"]
    r = roofline.analyze(cfg, shape, "16x16", 256, 16, collectives=FIXED)
    assert r.hardware == "NVIDIA H100 80GB HBM3, 700 W"
    assert r.t_collective == FIXED["total_wire_bytes_per_device"] / 450e9
    assert r.step_time_bound == max(r.t_compute, r.t_memory,
                                    r.t_collective)
    table = roofline.format_table([r])
    assert "qwen3-14b" in table and len(table.splitlines()) == 3


OPS = jhlo.COLLECTIVES + ("send",)


@settings(max_examples=200, deadline=None)
@given(op=st.sampled_from(OPS), g=st.integers(1, 8),
       result=st.integers(0, 1 << 40), operand=st.integers(0, 1 << 40))
def test_ring_model_matches_the_reference(op, g, result, operand):
    want = jhlo.Collective(comp="c", op=op, name="n", result_bytes=result,
                           operand_bytes=operand, group_size=g,
                           attrs="").wire_bytes()
    got = wire.Collective(op, result, operand, g).wire_bytes()
    assert got == want


def test_summary_keys_and_weights():
    from repro_torch.parallel.collectives import Event
    ev = [Event("seq all_gather", "all-gather", 4, 100, 400),
          Event("x send", "collective-permute", 1, 64, 64)]
    s = wire.collective_summary(ev, 8)
    j = jhlo.collective_summary("")
    assert s.keys() == j.keys()
    assert s["wire_bytes_per_device"] == {"all-gather": 4 * 300 / 8,
                                          "collective-permute": 64 / 8}
    assert s["op_counts"] == {"all-gather": 1, "collective-permute": 1}
    assert wire.collective_summary(ev, 8, [3, 0])["op_counts"] == \
        {"all-gather": 3, "collective-permute": 0}


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    path = tmp_path_factory.mktemp("oracle") / "ref.json"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = env.get("XLA_FLAGS", "") + \
        " --xla_force_host_platform_device_count=8"
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(
        REF_SCRIPT % dict(cases=ORACLE)), str(path)],
        capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return json.loads(path.read_text())


@pytest.mark.parametrize("case", ORACLE, ids=[c[0] for c in ORACLE])
def test_arguments_and_costs_match_xla(oracle, case):
    name, arch, shape, rules = case
    ref = oracle[name]
    cfg, shape = get_tiny_config(arch), ShapeConfig(*shape)
    mesh = make_test_mesh(2, 4, devices="meta")
    got = dryrun.dry_step(cfg, shape, mesh, rules)
    assert got["memory"]["argument_size_in_bytes"] == ref["arg"]
    rl = roofline.analyze(cfg, shape, "2x4", 8, 4,
                          collectives=got["collectives"])
    assert (rl.model_flops, rl.hlo_flops_global, rl.hbm_bytes_per_chip) \
        == (ref["model_flops"], ref["hlo_flops_global"], ref["hbm"])
    ours = got["collectives"]["total_wire_bytes_per_device"]
    theirs = ref["wire"]["total_wire_bytes_per_device"]
    assert ours > 0 and theirs > 0
    print(f"{name}: wire a device, port {ours:.0f} B, reference "
          f"{theirs:.0f} B; port by op "
          f"{got['collectives']['wire_bytes_per_device']}, reference "
          f"{ref['wire']['wire_bytes_per_device']}")


def test_arguments_known_values():
    """grok-1's decode arguments under the EP rules, pinned to the
    figure the oracle reads on this jax (149,796 B)."""
    m = make_test_mesh(2, 4, devices="meta")
    cfg = get_tiny_config("grok-1-314b")
    got = dryrun.dry_step(cfg, ShapeConfig("d", 128, 16, "decode"), m, EP)
    assert got["memory"]["argument_size_in_bytes"] == 149796
    assert got["memory"]["alias_size_in_bytes"] > 0     # caches in place


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_kernel_wrappers_meta_branch():
    ops.reset_launches()
    ops.reset_dry_calls()
    f32 = torch.float32
    q = _meta(2, 8, 4, 64)
    assert ops.flash_attention(q, q, q).shape == q.shape
    qd = _meta(2, 4, 64)
    kc = _meta(2, 16, 2, 64)
    assert ops.decode_attention(qd, kc, kc, 7).shape == qd.shape
    kp = _meta(5, 4, 2, 64)
    bt = _meta(2, 3, dtype=torch.int32)
    pos = _meta(2, dtype=torch.int32)
    assert ops.paged_decode_attention(qd, kp, kp, bt, pos).shape == qd.shape
    acc, m, l = ops.paged_decode_attention(qd, kp, kp, bt, pos,
                                           page_mask=bt, partials=True)
    assert (acc.shape, m.shape, acc.dtype) == ((2, 2, 2, 64), (2, 2, 2), f32)
    out = ops.moe_gemm(_meta(3, 5, 16), _meta(3, 16, 24), out_dtype=f32)
    assert (out.shape, out.dtype) == ((3, 5, 24), f32)
    x, sc = _meta(4, 64), _meta(64, dtype=f32)
    assert ops.rmsnorm(x, sc).shape == x.shape
    assert [t.shape for t in ops.add_rmsnorm(x, x, sc)] == [x.shape] * 2
    assert len(ops.qk_rmsnorm(x, x, sc, sc)) == 2
    r = _meta(1, 3, 2, 32)
    o, S_T = ops.rwkv6_scan(r, r, r, _meta(1, 3, 2, 32, dtype=f32),
                            _meta(2, 32, dtype=f32),
                            _meta(1, 2, 32, 32, dtype=f32))
    assert (o.shape, o.dtype, S_T.shape) == ((1, 3, 2, 32), f32,
                                             (1, 2, 32, 32))
    a = _meta(2, 3, 8, dtype=f32)
    assert [t.shape for t in ops.rglru_scan(a, a, _meta(2, 8, dtype=f32))] \
        == [(2, 3, 8), (2, 8)]
    calls = ops.dry_calls()
    assert all(v == 1 for k, v in calls.items()
               if k != "paged_decode_attention")
    assert calls["paged_decode_attention"] == 2
    assert all(fn.launches == 0 for fn in ops.WRAPPERS)
    # the CUDA path's checks hold on meta
    with pytest.raises(ValueError, match="must match"):
        ops.flash_attention(q, _meta(2, 8, 4, 32), q)
    with pytest.raises(ValueError, match="outside the cache"):
        ops.decode_attention(qd, kc, kc, 16)
    with pytest.raises(ValueError, match="contiguous"):
        ops.rmsnorm(_meta(64, 4).t(), sc)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.flash_attention(*[_meta(2, 8, 4, 64, dtype=torch.float16)] * 3)
    assert sum(ops.dry_calls().values()) == 10      # refused calls: none


def test_production_meshes():
    m = make_production_mesh()
    assert (m.axis_names, m.shape) == (("data", "model"),
                                       {"data": 16, "model": 16})
    assert {d.type for d in m.devices} == {"meta"}
    m = make_production_mesh(multi_pod=True, devices="cpu")
    assert len(m.devices) == 512 and m.axis_names[0] == "pod"


def test_main_skips_and_rewrites(tmp_path, capsys):
    out = str(tmp_path / "dry.json")
    rec = {"arch": "qwen3-14b", "shape": "train_4k", "mesh": "16x16",
           "lower_s": 1.0}
    dryrun.append_record(out, dict(rec, lower_s=0.5))
    dryrun.append_record(out, rec)                  # the same cell: rewrite
    dryrun.append_record(out, {"arch": "hubert-xlarge",
                               "shape": "decode_32k", "skipped": "x"})
    recs = json.loads(open(out).read())
    assert len(recs) == 2 and recs[0]["lower_s"] == 1.0
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen3-14b", "--shape", "train_4k",
                     "--mesh", "single", "--skip-existing", "--out", out])
    assert e.value.code == 0
    assert "skip existing qwen3-14b x train_4k x 16x16" in \
        capsys.readouterr().out
    # a cell the shape rules skip: a record that says why, exit 0
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "hubert-xlarge", "--shape", "decode_32k",
                     "--mesh", "single", "--out", out])
    assert e.value.code == 0
    recs = json.loads(open(out).read())
    assert recs[-1]["skipped"] == "encoder-only arch has no decode step"
