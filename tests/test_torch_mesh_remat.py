"""The mesh step's MoE gathers, the port's checkpoint and the dry run's
received blocks, on the CPU at tiny sizes.

* A leaf stored over the data axes (the MoE's "fsdp" expert weights)
  stays each position's stored block in the group view
  (``collectives.Stored``) and each MoE layer gathers its own when it
  runs.  On a 2x2 meta mesh (``launch/dryrun.peak_by_op``), the gathered
  expert blocks alive at the data group's peak are at most one MoE
  layer's (the group's two positions), or two in a train step (the
  recompute's gather and its gradient), for tiny grok-1 and DeepSeek-V3
  in train, prefill and decode (4 layers: 4 and 3 MoE layers).  The
  expert widths are set so that no other tensor takes a gathered
  block's shape.
* ``models/remat.checkpoint`` gives the loss and every gradient of
  ``torch.utils.checkpoint(use_reentrant=False)`` bit for bit, for a
  dense, an MoE and an MLA config, on one device and on a 2x2 mesh.
* A send between two positions of a meta mesh makes a storage the
  tally counts (as a send between two cards makes a copy), with or
  without autograd; under ``collectives.sends_as_views`` it is a view.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch
import torch.utils.checkpoint as torch_checkpoint

from repro_torch import steps, weights
from repro_torch.configs import get_tiny_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import lm
from repro_torch.parallel import collectives as col
from repro_torch.parallel.sharding import use_sharding

B, S = 8, 24


def _moe_cfg(arch):
    """4 layers; 5 experts of width 36: a gathered block's shapes, (5,
    64, 18), (5, 18, 64) and (64, 5), are no activation's at B=8, S=24
    (capacity 48 a group) and no other leaf's."""
    cfg = get_tiny_config(arch)
    return cfg.replace(n_layers=4, moe=dataclasses.replace(
        cfg.moe, n_experts=5, d_ff_expert=36))


def _gathered_shapes(cfg, tp):
    """{shape: bytes} of one position's gathered blocks of one MoE layer
    (expert-TP: each expert's FFN width split over ``tp``)."""
    params = weights.init_params(cfg, device="meta")
    moe = next(blk["moe"] for seg in params["segments"] for cyc in seg
               for blk in cyc if "moe" in blk)
    F = cfg.moe.d_ff_expert
    out = {}
    for k, t in moe.items():
        if k in ("router_w", "e_gate", "e_up", "e_down"):
            s = tuple(d // tp if d == F else d for d in t.shape)
            out[s] = out.get(s, 0) + t.numel() // (
                tp if F in t.shape else 1) * t.element_size()
    return out


MOE_CASES = [(a, k) for a in ("grok-1-314b", "deepseek-v3-671b")
             for k in ("train", "prefill", "decode")]


@pytest.mark.parametrize("arch,kind", MOE_CASES,
                         ids=[f"{a}-{k}" for a, k in MOE_CASES])
def test_one_moe_layer_gathered_at_the_peak(arch, kind):
    cfg = _moe_cfg(arch)
    mesh = make_test_mesh(2, 2, devices="meta")
    shape = ShapeConfig("t", S, B, kind)
    _, first, (live, by) = dryrun.peak_by_op(cfg, shape, mesh)
    blocks = _gathered_shapes(cfg, 2)
    layer = 2 * sum(blocks.values())        # the group's two positions
    made = sum(n for w, n in first.made.items()
               if w != "argument" and w[0] == "aten.cat.default"
               and w[1] in blocks)
    n_moe = sum(1 for k in range(cfg.n_layers) if k >= cfg.first_k_dense)
    assert made >= n_moe * layer          # every MoE layer gathered
    alive = sum(n for w, n in by.items()        # a stack of them too
                if w != "argument"
                and any(w[1][len(w[1]) - len(b):] == b for b in blocks))
    assert alive <= (2 if kind == "train" else 1) * layer, (alive, layer)


def _batch(cfg, seed=4):
    r = np.random.default_rng(seed)
    return {"tokens": torch.tensor(r.integers(0, cfg.vocab_size, (4, 32)),
                                   dtype=torch.int32),
            "labels": torch.tensor(r.integers(0, cfg.vocab_size, (4, 32)),
                                   dtype=torch.int32),
            "mask": torch.tensor((r.random((4, 32)) < 0.85),
                                 dtype=torch.float32)}


def _loss_and_grads(cfg, mesh):
    """(metrics, gradient tensors) of one device's loss or a mesh's."""
    params = weights.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    batch = _batch(cfg)
    if mesh is None:
        tree = weights.to_reference(params, cfg)
        leaves = [l.detach().requires_grad_()
                  for l in weights.tree_leaves(tree)]
        loss, metrics = lm.loss_fn(weights.unstack(
            weights.tree_unflatten(tree, leaves), cfg), cfg, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return metrics, [g for g in grads if g is not None]
    with use_sharding(mesh):
        metrics, grads = steps.mesh_loss_and_grads(
            cfg, weights.shard_params(params, cfg, mesh), batch)
    return metrics, [t for l in weights.tree_leaves(grads)
                     for t in l.shards]


REMAT_CASES = [(a, m) for a in ("qwen3-14b", "grok-1-314b",
                                "deepseek-v3-671b")
               for m in ("one device", "2x2")]


@pytest.mark.parametrize("arch,where", REMAT_CASES,
                         ids=[f"{a}-{m.replace(' ', '-')}"
                              for a, m in REMAT_CASES])
def test_remat_equals_torch_checkpoint(arch, where, monkeypatch):
    cfg = get_tiny_config(arch).replace(n_layers=4)
    assert cfg.remat and any(s.scanned and s.n_cycles > 1
                             for s in lm.make_segments(cfg))
    mesh = None if where == "one device" else make_test_mesh(
        2, 2, devices="cpu")
    got = _loss_and_grads(cfg, mesh)
    with monkeypatch.context() as m:
        m.setattr(lm, "checkpoint", functools.partial(
            torch_checkpoint.checkpoint, use_reentrant=False))
        want = _loss_and_grads(cfg, mesh)
    assert got[0].keys() == want[0].keys()
    for k in got[0]:
        assert torch.equal(got[0][k], want[0][k]), k
    assert len(got[1]) == len(want[1]) > 0
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("grad", [False, True])
def test_a_meta_send_makes_a_storage(grad):
    x = torch.empty((4, 256), device="meta", requires_grad=grad)
    n = 4 * 256 * 4
    with dryrun._Tally() as tally:
        y = col.send(x, torch.device("meta"), "t", "all_gather")
        assert tally.live == n
        assert y.untyped_storage()._cdata != x.untyped_storage()._cdata
        if grad:
            (g,) = torch.autograd.grad(y.sum(), x)
            assert g.shape == x.shape
        with col.sends_as_views():
            v = col.send(x, torch.device("meta"), "t", "all_gather")
        assert v.untyped_storage()._cdata == x.untyped_storage()._cdata
