"""Pipeline parallelism over a mesh axis (Swallow Fig. 2b at pod scale).

Reference: ``repro/parallel/pipeline.py``.  A GPipe schedule of
``n_micro + n_stages - 1`` ticks: position s holds stage s's parameters;
microbatches enter at stage 0, each tick's activations move to the next
position (the reference's ``ppermute``), and they leave at stage n-1.
The fill/drain bubble is the textbook (n_stages - 1) / (n_micro +
n_stages - 1) overhead, reported by ``bubble_fraction``.

It is differentiable, as the reference's is (it differentiates through
the ``shard_map``, which transposes every ``ppermute``): each hand-on
between positions is a ``collectives.send``, whose backward sends the
gradient back to the position before (counted in ``WIRE`` under
"pipeline ppermute"), and autograd runs each tick's backward on the
stream its forward ran on, waiting for the gradient's producer as it
does for any cross-stream use.

The unit here is an arbitrary ``stage_fn(stage_params, x) -> x``.  The
reference stacks the stages' parameters on a leading axis sharded over
the stage axis; the port's parameters are unstacked (``weights.py``), so
``stage_params`` is a sequence with one tree per stage.  One controller
drives every position: on a CUDA device each position runs on a stream
of its own, so positions overlap as the schedule allows, and an
activation is handed on after an event that marks it done; between two
cards PyTorch copies on the source card's current stream, after the
destination's, so the activation is recorded on that stream too (the
allocator would otherwise hand its memory to the stage's next work
before the copy has read it).  The
traffic is the Swallow "streaming" pattern: activations only, no
weights, nearest-neighbor.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Sequence

import torch

from repro_torch.parallel import collectives as col
from repro_torch.parallel.sharding import current_env


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def _on(stream):
    return torch.cuda.stream(stream) if stream is not None \
        else contextlib.nullcontext()


def pipeline_apply(stage_fn: Callable, stage_params: Sequence, x,
                   *, n_micro: int, axis: str = "stage"):
    """Run ``x`` through ``n_stages`` = mesh.shape[axis] stages.

    stage_params: one parameter tree per stage (placed on its position).
    x: (batch, ...) — batch must divide into n_micro.
    Returns y with the same shape, on ``x``'s device.  Off the mesh (or
    with one stage) the stages run in order on the full batch.
    """
    env = current_env()
    if env is None or axis not in env.mesh.axis_names \
            or env.mesh.shape[axis] == 1:
        for p_s in stage_params:
            x = stage_fn(p_s, x)
        return x

    devices = env.mesh.axis_devices(axis)
    n_stages = len(devices)
    if len(stage_params) != n_stages:
        raise ValueError(f"{len(stage_params)} stages' parameters for "
                         f"{n_stages} positions")
    if x.shape[0] % n_micro:
        raise ValueError(f"batch {x.shape[0]} does not split into "
                         f"{n_micro} microbatches")
    params = [_tree_to(p, d) for p, d in zip(stage_params, devices)]
    streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
               for d in devices]
    for s, d in zip(streams, devices):
        if s is not None:           # the parameters and x are ready
            s.wait_stream(torch.cuda.current_stream(d))
    xs = x.chunk(n_micro, 0)
    carry = [None] * n_stages       # (activation, its done event) a stage
    outs = []
    for t in range(n_micro + n_stages - 1):
        nxt = [None] * n_stages
        for s in range(n_stages):
            m = t - s
            if not 0 <= m < n_micro:
                continue            # the bubble: no microbatch here
            with _on(streams[s]):
                if s == 0:
                    x_in = xs[m].to(devices[0])
                else:
                    y, done = carry[s - 1]
                    if done is not None:
                        streams[s].wait_event(done)
                    if devices[s - 1] != devices[s] \
                            and streams[s - 1] is not None:
                        # a copy between two cards runs on the source
                        # card's current stream, after the destination
                        # stream (which waited for ``done``): y must
                        # outlive it there, not only on its own stream
                        y.record_stream(torch.cuda.current_stream(
                            devices[s - 1]))
                    x_in = col.send(y, devices[s], "pipeline", "ppermute")
                    if streams[s] is not None:
                        x_in.record_stream(streams[s])
                y = stage_fn(params[s], x_in)
                done = None
                if streams[s] is not None:
                    done = torch.cuda.Event()
                    done.record(streams[s])
            if s == n_stages - 1:
                outs.append((y, done))
            else:
                nxt[s] = (y, done)
        carry = nxt
    home = x.device
    ys = []
    for y, done in outs:
        if done is not None:
            torch.cuda.current_stream(y.device).wait_event(done)
            y.record_stream(torch.cuda.current_stream(y.device))
        ys.append(y.to(home))
    return torch.cat(ys, 0)
