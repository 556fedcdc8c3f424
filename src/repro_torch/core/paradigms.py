"""Swallow §III / Fig. 2: the target computational paradigms.

Reference: ``repro/core/paradigms.py``.

  farmer-worker (scatter-gather)  — a coordinator splits work over
      identical workers and reduces the results.  At pod scale this *is*
      data parallelism: ``farmer_worker`` shards a batch over an axis,
      maps, and reduces on the coordinator.
  pipelined / streaming — stages own disjoint program parts and stream
      activations (parallel/pipeline.py distributes them over a mesh).
  multiple independent applications — disjoint mesh slices, one job per
      slice (core/nos.py schedules them).

The reference runs ``farmer_worker`` as a ``shard_map`` with ``psum`` /
``pmean``; here one controller launches each shard's work on its
position's device and reduces on position 0.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.parallel.sharding import current_env


def farmer_worker(work_fn: Callable, data, *, reduce: str = "sum",
                  axis: str = "data"):
    """Scatter ``data`` over ``axis``, apply ``work_fn`` per shard on its
    position's device, and sum (``"sum"``), average (``"mean"``) or
    gather along dim 0 (anything else) the results on position 0's
    device (Fig. 2a).  Off-mesh it degrades to work_fn."""
    env = current_env()
    if env is None or axis not in env.mesh.axis_names:
        return work_fn(data)
    devices = env.mesh.axis_devices(axis)
    n = len(devices)
    if data.shape[0] % n:
        raise ValueError(f"batch {data.shape[0]} does not split over {n} "
                         f"workers")
    outs = [work_fn(shard.to(dev))
            for shard, dev in zip(data.chunk(n, 0), devices)]
    home = devices[0]
    if reduce not in ("sum", "mean"):
        return torch.cat([o.to(home) for o in outs], 0)
    out = outs[0]
    for o in outs[1:]:
        out = out + o.to(home)
    return out / n if reduce == "mean" else out


def streaming_pipeline(stage_fns: Sequence[Callable], x,
                       *, microbatches: int = 1):
    """Fig. 2b: composed stages with bounded per-stage storage.  On one
    host this runs the stages over microbatch slices — the scheduling
    skeleton the pipeline-parallel runtime uses (parallel/pipeline.py
    distributes the same structure over the "stage" axis)."""
    if microbatches == 1:
        for f in stage_fns:
            x = f(x)
        return x
    if x.shape[0] % microbatches:
        raise ValueError(f"batch {x.shape[0]} does not split into "
                         f"{microbatches} microbatches")
    outs = []
    for mb in x.chunk(microbatches, 0):
        y = mb
        for f in stage_fns:
            y = f(y)
        outs.append(y)
    return torch.cat(outs, 0)
