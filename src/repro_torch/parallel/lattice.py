"""Dimension-ordered collectives — the Swallow lattice lesson (§V-A)
applied to multi-pod all-reduce.

Reference: ``repro/parallel/lattice.py``.  Swallow's 2.5-D lattice
routes one dimension per layer, crossing layers at most twice.  The
pod-scale translation: decompose big collectives one mesh axis at a
time, cheapest dimension last, so the slow (DCN) axis carries only
1/N_fast of the bytes:

  lattice_all_reduce(x, ("data",), "pod"):
      reduce-scatter over "data"   (fast links, full bytes)
      all-reduce over "pod"        (slow links, bytes / n_data)
      all-gather over "data"

vs a flat all-reduce over ("data","pod") which drags full gradients
across the pod boundary.  ``dcn_bytes_saved`` quantifies the win.

The reference runs the schedule as a ``shard_map`` of ``psum_scatter``,
``psum`` and ``all_gather``.  Here one controller holds one tensor per
mesh position (on that position's device) and runs each phase as
explicit copies between the positions of a group; the all-reduce over
the slow axis is a ring's reduce-scatter then all-gather, so the bytes
each position receives are the ring model's that ``dcn_bytes_saved``
prices.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.parallel.sharding import current_env

PHASES = ("reduce_scatter", "all_reduce", "all_gather")


def _reduce_scatter(parts: List[torch.Tensor], groups, devices):
    """Within each group of k positions, position i keeps the sum over
    the group (in the group's order) of every member's i-th 1/k chunk.
    Returns the new parts and the bytes one position received."""
    out = list(parts)
    k = len(groups[0])
    for group in groups:
        chunks = [parts[p].chunk(k) for p in group]
        for i, p in enumerate(group):
            acc = chunks[0][i].to(devices[p])
            for c in chunks[1:]:
                acc = acc + c[i].to(devices[p])
            out[p] = acc
    return out, (k - 1) * parts[0].numel() // k * parts[0].element_size()


def _all_gather(parts: List[torch.Tensor], groups, devices):
    """Within each group, every position gets the concatenation of the
    members' parts in the group's order."""
    out = list(parts)
    for group in groups:
        for p in group:
            out[p] = torch.cat([parts[q].to(devices[p]) for q in group])
    return out, (len(groups[0]) - 1) * parts[0].numel() \
        * parts[0].element_size()


def lattice_all_reduce(x, fast_axes: Sequence[str] = ("data",),
                       slow_axis: str = "pod",
                       stats: Optional[Dict[str, int]] = None):
    """Dimension-ordered all-reduce over ``fast_axes`` and ``slow_axis``.

    ``x`` is one tensor, held by every position as the reference's
    replicated input is, or a sequence of tensors, one per mesh position
    (``mesh.devices`` order, each on its device).  Returns the reduced
    tensor (position 0's) for one tensor in, and every position's for a
    sequence.  Equal to a sum over the positions of each group;
    the slow axis carries 1/prod(fast sizes) of the bytes.  ``stats``,
    if given, receives the bytes one position receives in each phase.
    """
    env = current_env()
    single = isinstance(x, torch.Tensor)
    if env is None:
        return x
    mesh = env.mesh
    fast = tuple(a for a in fast_axes if a in mesh.axis_names
                 and mesh.shape[a] > 1)
    slow = slow_axis if (slow_axis in mesh.axis_names
                         and mesh.shape[slow_axis] > 1) else None
    if not fast and slow is None:
        return x
    devices = mesh.devices
    parts = [x.to(d) for d in devices] if single else list(x)
    if len(parts) != len(devices):
        raise ValueError(f"{len(parts)} tensors for {len(devices)} "
                         f"positions")
    shape, numel = parts[0].shape, parts[0].numel()
    n = 1
    for a in fast:
        n *= mesh.shape[a]
    pad = (-numel) % (n * (mesh.shape[slow] if slow else 1))
    flat = [torch.nn.functional.pad(p.reshape(-1), (0, pad)) for p in parts]
    moved = dict.fromkeys(PHASES, 0)
    for ax in fast:
        flat, b = _reduce_scatter(flat, mesh.axis_groups(ax), devices)
        moved["reduce_scatter"] += b
    if slow is not None:
        groups = mesh.axis_groups(slow)
        flat, b1 = _reduce_scatter(flat, groups, devices)
        flat, b2 = _all_gather(flat, groups, devices)
        moved["all_reduce"] = b1 + b2
    for ax in reversed(fast):
        flat, b = _all_gather(flat, mesh.axis_groups(ax), devices)
        moved["all_gather"] += b
    if stats is not None:
        stats.update(moved)
    out = [f[:numel].reshape(shape) for f in flat]
    return out[0] if single else out


def dcn_bytes_saved(nbytes: float, n_fast: int, n_pods: int) -> dict:
    """Wire bytes over the pod (DCN) boundary: flat vs dimension-ordered."""
    flat = 2.0 * nbytes * (n_pods - 1) / n_pods          # full AR over DCN
    lattice = 2.0 * (nbytes / n_fast) * (n_pods - 1) / n_pods
    return {"flat_dcn_bytes": flat, "lattice_dcn_bytes": lattice,
            "saving_factor": flat / max(lattice, 1e-12)}
