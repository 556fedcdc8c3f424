"""The dry run (``launch/dryrun.py``) against the port's own run, on the
CPU at tiny sizes.

A tiny qwen3-14b cell and a tiny grok-1 cell (4 layers; grok's expert
weights stored over the data axis, each MoE layer gathering its blocks
when it runs and again in the train step's recompute) on a 2x2 mesh,
its train, prefill and decode step run once on CPU positions
(``devices="cpu"``) under ``FlopCounterMode``, gives the same wire
bytes at every collective site,
the same event summary and the same counted FLOPs as the dry run on meta
positions, which cut the cycles to 2 and 3 and ran one data group
(the decode step's too); and
the summary's total times the positions is the sum of
``collectives.WIRE``.
"""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import steps, weights
from repro_torch.analysis import wire
from repro_torch.configs import get_tiny_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.optim import adam
from repro_torch.parallel import collectives as col
from repro_torch.parallel.sharding import use_sharding

B, S = 4, 32


def _close(a, b, tol=1e-9):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k], tol)
                                            for k in a)
    return abs(a - b) <= tol * max(abs(a), abs(b), 1.0)


def _cpu_run(cfg, shape, mesh):
    """The cell's step once on CPU positions: (WIRE, EVENTS, FLOPs)."""
    g = torch.Generator().manual_seed(0)
    ints = lambda *s: torch.randint(0, cfg.vocab_size, s, generator=g,
                                    dtype=torch.int32)
    with use_sharding(mesh) as env:
        params = weights.shard_params(weights.init_params(cfg, g, "cpu"),
                                      cfg, mesh)
        if shape.kind == "train":
            c = steps.adam_config_for(cfg)
            args = (params, adam.init(params, c),
                    {"tokens": ints(B, S), "labels": ints(B, S),
                     "mask": torch.ones(B, S)})
            step = steps.make_train_step(cfg, c)
        elif shape.kind == "prefill":
            args = (params, ints(B, S))
            step = steps.make_prefill_step(cfg, max_len=S, mesh=mesh)
        else:
            _, caches, pos = steps.make_decode_structs(cfg, shape, mesh, env)
            args = (params, ints(B, 1), caches, pos)
            step = steps.make_serve_step(cfg, mesh=mesh)
        col.WIRE.clear()
        col.EVENTS.clear()
        with FlopCounterMode(display=False) as fc:
            step(*args)
    return dict(col.WIRE), list(col.EVENTS), fc.get_total_flops()


CASES = [(a, k) for a in ("qwen3-14b", "grok-1-314b")
         for k in ("train", "prefill", "decode")]


@pytest.mark.parametrize("arch,kind", CASES, ids=[
    k if a == "qwen3-14b" else f"{a}-{k}" for a, k in CASES])
def test_prediction_equals_the_port_run(arch, kind):
    cfg = get_tiny_config(arch).replace(n_layers=4)
    shape = ShapeConfig("t", S, B, kind)
    got = dryrun.dry_step(cfg, shape, make_test_mesh(2, 2, devices="meta"))
    assert got["symmetry"]["cycles"]["runs_at"] == [2, 3]
    assert got["symmetry"]["data_groups_run"] == 1
    w, events, flops = _cpu_run(cfg, shape, make_test_mesh(2, 2,
                                                            devices="cpu"))
    assert got["wire_bytes_by_site"] == {k: float(v) for k, v in w.items()}
    assert got["cost_analysis"]["flops"] == flops
    summary = wire.collective_summary(events, 4)
    assert got["collectives"]["op_counts"] == summary["op_counts"]
    assert _close(got["collectives"], summary)
    assert summary["total_wire_bytes_per_device"] * 4 == sum(w.values())
