"""The port's copies of the paper's modules, its striped memory server and
its mesh functions against the JAX reference on the CPU.

* host copies (``principles``, ``topology``, ``ratio``, ``overlays``,
  the memory server's host half): ``tests/test_core.py``'s and
  ``tests/test_system.py``'s cases run over both packages, and every
  value of the port equals the reference's exactly;
* the device half of the memory server: the port's ``StripedStore`` on
  1x1, 1x2 and 1x4 CPU meshes against the reference's ``StripedStore``
  off the mesh and against ``SingleController`` (the reference's store
  on a mesh fails on this jax, ``test_multidevice.py``'s
  ``test_striped_store_write_keeps_placement``, so it is no oracle):
  equal reads, duplicated addresses keep their last write, each stripe
  holds the rows ``stripe_slab_index`` gives on its position's device,
  and a write keeps that placement;
* the mesh functions (``lattice_all_reduce``, ``pipeline_apply``,
  ``farmer_worker``) on CPU meshes against the reference run in a
  subprocess with a forced host device count, on the same numpy inputs:
  the all-reduce bit for bit on integers and within 1e-6 relative on
  normal values (the summation order differs), the pipeline within 1e-5
  as in the reference's own test.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypothesis_compat import given, settings, st
from repro.configs import get_config as jget_config
from repro.configs import get_tiny_config as jget_tiny_config
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core import memory_server as jms
from repro.core import overlays as jov
from repro.core import paradigms as jpar
from repro.core import principles as jpr
from repro.core import ratio as jratio
from repro.core import topology as jtopo
from repro.parallel import lattice as jlat
from repro.parallel import pipeline as jpipe
from repro_torch.configs import get_config, get_tiny_config
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.core import memory_server as tms
from repro_torch.core import overlays as tov
from repro_torch.core import paradigms as tpar
from repro_torch.core import principles as tpr
from repro_torch.core import ratio as tratio
from repro_torch.core import topology as ttopo
from repro_torch.launch.mesh import make_mesh, make_test_mesh
from repro_torch.parallel import lattice as tlat
from repro_torch.parallel import pipeline as tpipe
from repro_torch.parallel.sharding import use_sharding

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
PKGS = ["port", "reference"]


def _fields(x):
    return dataclasses.asdict(x)


# --- ratio (§II-B, Tab. III) -------------------------------------------------
@pytest.mark.parametrize("pkg", PKGS)
def test_swallow_table_iii(pkg):
    ratio = tratio if pkg == "port" else jratio
    r = ratio.swallow_ec()
    assert r.ec == 2.0 and r.EC == 32
    assert r.perf_bound() == 32


@pytest.mark.parametrize("pkg", PKGS)
def test_cell_ratio_balanced_detection(pkg):
    ratio = tratio if pkg == "port" else jratio
    r = ratio.analyze_cell("x", wire_bytes_per_device=1e6,
                           compute_seconds=1.0, n_chips=256,
                           mesh_shape={"data": 16, "model": 16})
    assert r.balanced and r.bound == "compute"
    r2 = ratio.analyze_cell("y", wire_bytes_per_device=1e13,
                            compute_seconds=0.1, n_chips=256,
                            mesh_shape={"data": 16, "model": 16})
    assert not r2.balanced


CELLS = [("x", 1e6, 1.0, 256, {"data": 16, "model": 16}),
         ("y", 1e13, 0.1, 256, {"data": 16, "model": 16}),
         ("z", 3e9, 2e-3, 8, {"pod": 2, "data": 4, "model": 1}),
         ("w", 5e8, 0.0, 1, {"data": 1, "model": 1})]


def test_ratio_values_equal_the_reference():
    assert tratio.SWALLOW_TABLE_III == jratio.SWALLOW_TABLE_III
    assert tratio.ICI_LINKS_PER_CHIP == jratio.ICI_LINKS_PER_CHIP
    assert _fields(tratio.swallow_ec()) == _fields(jratio.swallow_ec())
    rows_t = [tratio.analyze_cell(*c) for c in CELLS]
    rows_j = [jratio.analyze_cell(*c) for c in CELLS]
    assert [_fields(r) for r in rows_t] == [_fields(r) for r in rows_j]
    # the port's table is the reference's, and then says what it priced
    assert tratio.format_table(rows_t + [tratio.swallow_ec()]) == \
        jratio.format_table(rows_j + [jratio.swallow_ec()]) \
        + "\n" + tratio.TPU_NOTE


# --- topology (§V-A) ----------------------------------------------------------
@settings(max_examples=60, deadline=None)
@given(rows=st.integers(2, 8), cols=st.integers(2, 8),
       data=st.data())
def test_lattice_routing_properties(rows, cols, data):
    lat = ttopo.Lattice(rows, cols)
    ref = jtopo.Lattice(rows, cols)
    nodes = list(lat.nodes())
    assert nodes == list(ref.nodes())
    src = data.draw(st.sampled_from(nodes))
    dst = data.draw(st.sampled_from(nodes))
    path = lat.route(src, dst)
    assert path == ref.route(src, dst)
    assert lat.neighbors(src) == ref.neighbors(src)
    assert lat.hops(src, dst) == ref.hops(src, dst)
    assert path[0] == src and path[-1] == dst
    for a, b in zip(path, path[1:]):
        assert b in lat.neighbors(a), (a, b)
    assert ttopo.Lattice.layer_transitions(path) <= 3
    seen_h = False
    for a, b in zip(path, path[1:]):
        if a[0] == b[0] == 1 and a[2] != b[2]:
            seen_h = True
        if a[0] == b[0] == 0 and a[1] != b[1]:
            assert not seen_h


@pytest.mark.parametrize("pkg", PKGS)
def test_lattice_two_transitions_and_connectivity(pkg):
    topology = ttopo if pkg == "port" else jtopo
    lat = topology.Lattice(4, 4)
    assert topology.Lattice.layer_transitions(
        lat.route((1, 0, 0), (1, 3, 3))) == 2
    lat = topology.Lattice(3, 3)
    nodes = list(lat.nodes())
    for s in nodes:
        for d in nodes:
            p = lat.route(s, d)
            assert p[0] == s and p[-1] == d


@pytest.mark.parametrize("rows,cols", [(2, 2), (3, 5), (4, 4)])
def test_topology_tables_equal_the_reference(rows, cols):
    assert ttopo.average_hops(ttopo.Lattice(rows, cols)) == \
        jtopo.average_hops(jtopo.Lattice(rows, cols))
    shape = {"pod": rows, "data": cols, "model": 1}
    assert ttopo.map_to_torus(shape) == jtopo.map_to_torus(shape)


# --- memory server, host half (§III-A / §X-B, Fig. 3) -------------------------
@settings(max_examples=30, deadline=None)
@given(n=st.integers(1, 64), addr=st.integers(0, 10 ** 6))
def test_striping_rule(n, addr):
    assert tms.striped_owner(addr, n) == addr % n == \
        jms.striped_owner(addr, n)
    size = n * (addr // n + 1)
    assert tms.stripe_slab_index(addr, n, size) == \
        jms.stripe_slab_index(addr, n, size)


@pytest.mark.parametrize("pkg", PKGS)
def test_memory_per_task_fig3(pkg):
    ms = tms if pkg == "port" else jms
    assert ms.memory_per_task(1024, 1) == 1024 * 64
    assert ms.memory_per_task(1024, 1024) == 64
    assert ms.memory_per_task(2048, 1024) == 128
    for procs, tasks in ((480, 1), (480, 7), (3, 0), (17, 480)):
        assert tms.memory_per_task(procs, tasks) == \
            jms.memory_per_task(procs, tasks)


def test_traffic_models_equal_the_reference():
    js, jc = jms.StripedStore(64), jms.SingleController(64)
    ts, tc = tms.StripedStore(64, device="cpu"), tms.SingleController(
        64, device="cpu")
    for n_acc, n_nodes in ((4096, 16), (10, 1), (7, 480)):
        assert ts.traffic_model(n_acc, n_nodes) == \
            js.traffic_model(n_acc, n_nodes)
        assert tc.traffic_model(n_acc, n_nodes) == \
            jc.traffic_model(n_acc, n_nodes)
    assert ts.traffic_model(4096) == js.traffic_model(4096)


# --- overlays (§III-B, Fig. 4) ------------------------------------------------
@pytest.mark.parametrize("pkg", PKGS)
def test_overlay_map_fig4(pkg):
    ov = tov if pkg == "port" else jov
    m = ov.overlay_map()
    assert m["n_overlays"] == 2
    assert m["resident_kwords"] == 12


@pytest.mark.parametrize("args", [(), (16, (0x1000, 0x2FFF), 4),
                                  (32, (0x2000, 0x5FFF), 8), (8, (0, 0xFFF), 2)])
def test_overlay_map_equals_the_reference(args):
    assert tov.overlay_map(*args) == jov.overlay_map(*args)


@pytest.mark.parametrize("pkg", PKGS)
def test_overlay_planner_decisions(pkg):
    if pkg == "port":
        ov, cfgf, tiny, shapes, shape_cls = (
            tov, get_config, get_tiny_config, SHAPES, ShapeConfig)
    else:
        ov, cfgf, tiny, shapes, shape_cls = (
            jov, jget_config, jget_tiny_config, JSHAPES, JShapeConfig)
    p = ov.plan(cfgf("qwen3-14b"), shapes["train_4k"], n_chips=256)
    assert p.remat and p.extra_flops > 0
    p2 = ov.plan(tiny("qwen3-14b"), shape_cls("t", 64, 2, "train"),
                 n_chips=1)
    assert not p2.remat


@pytest.mark.parametrize("arch,shape,n_chips", [
    ("qwen3-14b", "train_4k", 256), ("grok-1-314b", "train_4k", 512),
    ("deepseek-v3-671b", "train_4k", 256), ("gemma2-27b", "train_4k", 64),
    ("rwkv6-1.6b", "train_4k", 16)])
def test_overlay_plan_equals_the_reference(arch, shape, n_chips):
    t = tov.plan(get_config(arch), SHAPES[shape], n_chips)
    j = jov.plan(jget_config(arch), JSHAPES[shape], n_chips)
    assert _fields(t) == _fields(j)
    assert t.summary() == j.summary()


# --- principles (§II-A) and paradigms (§III) ----------------------------------
RECORDS = [
    ({"memory": {"temp_size_in_bytes": 100, "argument_size_in_bytes": 50},
      "collectives": {"total_wire_bytes_per_device": 1000}},
     {"memory": {"temp_size_in_bytes": 90, "argument_size_in_bytes": 50},
      "collectives": {"total_wire_bytes_per_device": 1100}}),
    ({"memory": {"temp_size_in_bytes": 100, "argument_size_in_bytes": 50},
      "collectives": {"total_wire_bytes_per_device": 1000}},
     {"memory": {"temp_size_in_bytes": 200, "argument_size_in_bytes": 50},
      "collectives": {"total_wire_bytes_per_device": 2000}}),
    ({}, {}),
]


@pytest.mark.parametrize("pkg", PKGS)
def test_scale_free_principles_checker(pkg):
    principles = tpr if pkg == "port" else jpr
    checks = principles.check_scale_free(*RECORDS[0])
    assert len(checks) == 5
    assert all(c.holds for c in checks)


@pytest.mark.parametrize("records", RECORDS)
def test_principles_equal_the_reference(records):
    assert [_fields(c) for c in tpr.check_scale_free(*records)] == \
        [_fields(c) for c in jpr.check_scale_free(*records)]


def test_farmer_worker_paradigm():
    data = torch.arange(16.0)
    out = tpar.farmer_worker(lambda x: (x ** 2).sum(), data)
    assert float(out) == float((data ** 2).sum())
    ref = jpar.farmer_worker(lambda x: (x ** 2).sum(), jnp.arange(16.0))
    assert float(out) == float(ref)


def test_streaming_pipeline_paradigm():
    fns = [lambda x: x + 1, lambda x: x * 2]
    x = torch.arange(8.0)[:, None]
    y1 = tpar.streaming_pipeline(fns, x, microbatches=1)
    y4 = tpar.streaming_pipeline(fns, x, microbatches=4)
    assert torch.equal(y1, y4)
    assert torch.equal(y1, (x + 1) * 2)
    ref = jpar.streaming_pipeline(fns, jnp.arange(8.0)[:, None],
                                  microbatches=4)
    assert np.array_equal(y4.numpy(), np.asarray(ref))


# --- memory server, device half -----------------------------------------------
def _addresses(rng, size, n):
    """``n`` addresses in [0, size) with duplicates on purpose: half of
    them drawn from a pool of n // 8."""
    pool = rng.integers(0, size, max(n // 8, 1))
    return np.concatenate([rng.integers(0, size, n - n // 2),
                           rng.choice(pool, n // 2)])


def _last_values(addrs, vals):
    """{address: value of its last write}, written out as a loop."""
    want = {}
    for a, v in zip(addrs.tolist(), vals.tolist()):
        want[a] = v
    return want


@pytest.mark.parametrize("model", [1, 2, 4])
def test_striped_store_on_a_cpu_mesh_matches_the_reference(model):
    size = 256
    rng = np.random.default_rng(model)
    mesh = make_test_mesh(1, model, devices="cpu")
    with use_sharding(mesh):
        st_ = tms.StripedStore(size)
    assert st_.n == model and len(st_.stripes) == model
    single = tms.SingleController(size, device="cpu")
    ref = jms.StripedStore(size)
    ref_single = jms.SingleController(size)
    placed = [s.data_ptr() for s in st_.stripes]
    written = {}
    for batch in range(3):
        addrs = _addresses(rng, size, 96)
        vals = rng.standard_normal(96).astype(np.float32)
        st_.write(torch.tensor(addrs), torch.tensor(vals))
        single.write(torch.tensor(addrs), torch.tensor(vals))
        ref.write(jnp.asarray(addrs), jnp.asarray(vals))
        ref_single.write(jnp.asarray(addrs), jnp.asarray(vals))
        written.update(_last_values(addrs, vals))
        # a write keeps the placement: the same stripe tensors, each on
        # its position's device, each of size / n rows
        assert [s.data_ptr() for s in st_.stripes] == placed
        assert [s.device for s in st_.stripes] == \
            list(mesh.axis_devices("model"))
        assert all(s.shape == (size // model,) for s in st_.stripes)
    every = np.arange(size)
    got = st_.read(torch.tensor(every)).numpy()
    assert np.array_equal(got, single.read(torch.tensor(every)).numpy())
    assert np.array_equal(got, np.asarray(ref.read(jnp.asarray(every))))
    assert np.array_equal(got,
                          np.asarray(ref_single.read(jnp.asarray(every))))
    # the last write of each address wins; untouched addresses read 0
    for a in range(size):
        assert got[a] == written.get(a, 0.0), a
    # each stripe holds exactly the rows stripe_slab_index gives it
    slab = torch.cat(list(st_.stripes)).numpy()
    rows = tms.stripe_slab_index(every, model, size)
    assert np.array_equal(slab[rows], got)
    for j, stripe in enumerate(st_.stripes):
        mine = every[every % model == j]
        assert np.array_equal(
            stripe.numpy()[rows[mine] - j * (size // model)], got[mine])


def test_store_reads_from_a_mesh_arrive_on_position_0():
    mesh = make_test_mesh(1, 4, devices="cpu")
    with use_sharding(mesh):
        st_ = tms.StripedStore(64)
    st_.write(torch.tensor([0, 5, 17, 63]), torch.tensor([1., 2., 3., 4.]))
    got = st_.read(torch.tensor([0, 5, 17, 63]))
    assert got.device == mesh.axis_devices("model")[0]
    assert torch.equal(got, torch.tensor([1., 2., 3., 4.]))
    assert float(st_.read(torch.tensor([1]))[0]) == 0.0
    assert int(tms.stripe_slab_index(0, st_.n, st_.size)) == 0


def test_last_writes_keeps_each_address_last_value():
    addrs = torch.tensor([7, 3, 7, 7, 1, 3])
    vals = torch.tensor([1., 2., 3., 4., 5., 6.])
    a, v = tms.last_writes(addrs, vals)
    assert dict(zip(a.tolist(), v.tolist())) == {7: 4.0, 3: 6.0, 1: 5.0}
    st_ = tms.SingleController(8, device="cpu")
    st_.write(torch.tensor([2, 2, 2]), torch.tensor([1., 2., 3.]))
    assert float(st_.read(torch.tensor([2]))[0]) == 3.0


def test_store_size_must_split_over_the_stripes():
    with use_sharding(make_test_mesh(1, 4, devices="cpu")):
        with pytest.raises(ValueError, match="not a multiple"):
            tms.StripedStore(66)


# --- mesh functions against the reference on forced host devices -------------
REFERENCE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.core import paradigms
from repro.parallel import lattice, pipeline
from repro.parallel.sharding import use_sharding
inp = dict(np.load(sys.argv[1]))
out = {}
with use_sharding(jax.make_mesh((2, 4), ("pod", "data"))):
    for name in ("int", "normal", "odd"):
        out["lattice_" + name] = np.asarray(lattice.lattice_all_reduce(
            jnp.asarray(inp[name]), fast_axes=("data",), slow_axis="pod"))
with use_sharding(jax.make_mesh((2, 2, 2), ("pod", "data", "model"))):
    for name in ("int", "normal"):
        out["lattice3_" + name] = np.asarray(lattice.lattice_all_reduce(
            jnp.asarray(inp[name]), fast_axes=("data", "model"),
            slow_axis="pod"))
    out["lattice_fast_only"] = np.asarray(lattice.lattice_all_reduce(
        jnp.asarray(inp["int"]), fast_axes=("data",), slow_axis="none"))
stage_fn = lambda w, x: jnp.tanh(x @ w)
with use_sharding(jax.make_mesh((4,), ("stage",))):
    out["pipeline"] = np.asarray(jax.jit(lambda W, x: pipeline.pipeline_apply(
        stage_fn, W, x, n_micro=4, axis="stage"))(
            jnp.asarray(inp["W"]), jnp.asarray(inp["x"])))
with use_sharding(jax.make_mesh((4,), ("data",))):
    d = jnp.asarray(inp["farm"])
    out["farm_sum"] = np.asarray(paradigms.farmer_worker(
        lambda x: (x ** 2).sum(0), d))
    out["farm_mean"] = np.asarray(paradigms.farmer_worker(
        lambda x: (x * 3).sum(0), d, reduce="mean"))
    out["farm_gather"] = np.asarray(paradigms.farmer_worker(
        lambda x: x * 2 + 1, d, reduce="gather"))
np.savez(sys.argv[2], **out)
print("OK")
"""


@pytest.fixture(scope="module")
def mesh_case(tmp_path_factory):
    """The inputs of the mesh cases and the reference's outputs, from one
    subprocess that sees 8 forced host devices."""
    rng = np.random.default_rng(0)
    inp = {"int": rng.integers(-50, 50, (8, 8)).astype(np.float32),
           "normal": rng.standard_normal((16, 24)).astype(np.float32),
           "odd": rng.integers(-9, 9, (5, 3)).astype(np.float32),
           "W": (rng.standard_normal((4, 16, 16)) * 0.3).astype(np.float32),
           "x": rng.standard_normal((8, 16)).astype(np.float32),
           "farm": rng.integers(-5, 5, (16, 3)).astype(np.float32)}
    d = tmp_path_factory.mktemp("mesh_case")
    np.savez(d / "inp.npz", **inp)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = env.get("XLA_FLAGS", "") + \
        " --xla_force_host_platform_device_count=8"
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                        str(d / "inp.npz"), str(d / "out.npz")],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return inp, dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("name", ["int", "normal", "odd"])
def test_lattice_all_reduce_matches_the_reference(mesh_case, name):
    inp, ref = mesh_case
    x = torch.tensor(inp[name])
    with use_sharding(make_mesh((2, 4), ("pod", "data"), "cpu")):
        stats = {}
        out = tlat.lattice_all_reduce(x, fast_axes=("data",),
                                      slow_axis="pod", stats=stats)
    want = ref["lattice_" + name]
    if name == "normal":
        # eight copies summed in another order than XLA's
        assert np.allclose(out.numpy(), want, rtol=1e-6, atol=0)
    else:
        assert np.array_equal(out.numpy(), want)
        assert np.array_equal(want, inp[name] * 8)


@pytest.mark.parametrize("name", ["int", "normal"])
def test_lattice_all_reduce_over_two_fast_axes(mesh_case, name):
    inp, ref = mesh_case
    x = torch.tensor(inp[name])
    with use_sharding(make_mesh((2, 2, 2), ("pod", "data", "model"),
                                "cpu")):
        out = tlat.lattice_all_reduce(x, fast_axes=("data", "model"),
                                      slow_axis="pod")
        fast_only = tlat.lattice_all_reduce(torch.tensor(inp["int"]),
                                            fast_axes=("data",),
                                            slow_axis="none")
    if name == "normal":
        assert np.allclose(out.numpy(), ref["lattice3_normal"], rtol=1e-6,
                           atol=0)
    else:
        assert np.array_equal(out.numpy(), ref["lattice3_int"])
    assert np.array_equal(fast_only.numpy(), ref["lattice_fast_only"])


def test_lattice_all_reduce_sums_distinct_positions_and_counts_bytes():
    """Eight positions, each with its own integers: every position ends
    with the plain sum over all eight, bit for bit; the bytes each phase
    moves are the ring model's, and the slow axis's are
    ``dcn_bytes_saved``'s."""
    mesh = make_mesh((2, 4), ("pod", "data"), "cpu")
    gen = torch.Generator().manual_seed(0)
    parts = [torch.randint(-1000, 1000, (4096,), generator=gen).float()
             for _ in mesh.devices]
    want = torch.stack(parts).sum(0)
    stats = {}
    with use_sharding(mesh):
        outs = tlat.lattice_all_reduce(parts, ("data",), "pod", stats=stats)
    assert len(outs) == 8 and all(torch.equal(o, want) for o in outs)
    nbytes = 4096 * 4
    assert stats == {"reduce_scatter": nbytes * 3 // 4,
                     "all_reduce": nbytes // 4,
                     "all_gather": nbytes * 3 // 4}
    model = tlat.dcn_bytes_saved(nbytes, 4, 2)
    assert stats["all_reduce"] == model["lattice_dcn_bytes"]
    assert model == jlat.dcn_bytes_saved(nbytes, 4, 2)


def test_lattice_all_reduce_off_the_mesh_is_the_identity():
    x = torch.arange(6.0)
    assert tlat.lattice_all_reduce(x) is x
    with use_sharding(make_mesh((1, 4), ("pod", "model"), "cpu")):
        assert tlat.lattice_all_reduce(x) is x


def test_pipeline_apply_matches_the_reference(mesh_case):
    inp, ref = mesh_case
    W, x = torch.tensor(inp["W"]), torch.tensor(inp["x"])
    stage_fn = lambda w, x: torch.tanh(x @ w)    # noqa: E731
    with use_sharding(make_mesh((4,), ("stage",), "cpu")):
        y = tpipe.pipeline_apply(stage_fn, list(W), x, n_micro=4)
    assert np.abs(y.numpy() - ref["pipeline"]).max() < 1e-5
    # the same stages run in order over the same microbatches, bit for bit
    seq = tpar.streaming_pipeline(
        [lambda h, w=w: stage_fn(w, h) for w in W], x, microbatches=4)
    assert torch.equal(y, seq)
    # off the mesh the stages run in order on the full batch
    off = tpipe.pipeline_apply(stage_fn, list(W), x, n_micro=4)
    assert torch.equal(off, tpar.streaming_pipeline(
        [lambda h, w=w: stage_fn(w, h) for w in W], x))


def test_pipeline_apply_runs_every_microbatch_through_every_stage():
    """Three stages, six microbatches: each microbatch meets each stage
    once, in stage order, and the outputs come back in batch order."""
    calls = []

    def stage_fn(p, x):
        calls.append((p, int(x[0, 0])))
        return x * 10 + p

    x = torch.arange(6, dtype=torch.int64)[:, None]
    with use_sharding(make_mesh((3,), ("stage",), "cpu")):
        y = tpipe.pipeline_apply(stage_fn, [1, 2, 3], x, n_micro=6)
    assert y[:, 0].tolist() == [((m * 10 + 1) * 10 + 2) * 10 + 3
                                for m in range(6)]
    assert len(calls) == 18
    assert tpipe.bubble_fraction(4, 8) == jpipe.bubble_fraction(4, 8) == 3 / 11


def test_farmer_worker_matches_the_reference_on_a_mesh(mesh_case):
    inp, ref = mesh_case
    d = torch.tensor(inp["farm"])
    with use_sharding(make_mesh((4,), ("data",), "cpu")):
        got = {"sum": tpar.farmer_worker(lambda x: (x ** 2).sum(0), d),
               "mean": tpar.farmer_worker(lambda x: (x * 3).sum(0), d,
                                          reduce="mean"),
               "gather": tpar.farmer_worker(lambda x: x * 2 + 1, d,
                                            reduce="gather")}
    for k, v in got.items():
        assert np.array_equal(v.numpy(), ref["farm_" + k]), k
