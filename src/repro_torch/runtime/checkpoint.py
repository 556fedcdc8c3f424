"""Atomic, async checkpointing in the reference's on-disk format.

Reference: ``repro/runtime/checkpoint.py``.  Format: <dir>/step_<N>/
    manifest.json   — step, leaf paths/shapes/dtypes, extra metadata
    arrays.npz      — leaf path -> ndarray (a QTensor's q and scale)

Leaf paths are the reference's ``path_str``: dict keys sorted and joined
with "/", list indices, a NamedTuple's fields as ".name" (``opt/.m/3``),
and a QTensor's ``q`` and ``scale`` as its children 0 and 1.  A state
saved as ``{"params": weights.to_reference(params, cfg), "opt": adam
state}`` therefore has the reference's keys and shapes, and crosses
between the two packages.  bf16 leaves are written as their uint16 bits
with "bfloat16" in the manifest (numpy has no bf16 without ml_dtypes);
``restore`` reads those and the reference's 2-byte void records alike.

A state on a mesh (Sharded leaves, ``parallel/sharding.py``) is saved as
its logical arrays, each block read from the first position holding it,
so the checkpoint carries no mesh: ``restore(..., shardings=)`` places
every leaf on the current mesh (the reference's elastic restore), and a
checkpoint crosses between meshes and between the packages both ways.

Atomicity: write to step_<N>.tmp, then rename.  Async: every leaf is
copied to the host synchronously (a CPU tensor shares memory with its
numpy view, and the next optimizer step must not rewrite a checkpoint in
flight) and the copy is written by a daemon thread.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.optim.quant import QTensor
from repro_torch.parallel import sharding


def _items(tree, path=()):
    """(path, leaf) pairs in the reference's flatten order."""
    if isinstance(tree, QTensor):
        yield path + ("0",), tree.q
        yield path + ("1",), tree.scale
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], path + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _items(getattr(tree, f), path + ("." + f,))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _items(t, path + (str(i),))
    else:
        yield path, tree


def _host(t) -> Tuple[np.ndarray, str]:
    """A host copy of one leaf (a Sharded one's logical array) and its
    manifest dtype."""
    if isinstance(t, sharding.Sharded):
        t = sharding.gather(t, "cpu")      # a new host tensor already
    else:
        t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _snapshot(state) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    arrays, dtypes = {}, {}
    for path, leaf in _items(state):
        key = "/".join(path)
        arrays[key], dtypes[key] = _host(leaf)
    return arrays, dtypes


def _write(ckpt_dir, step, arrays, dtypes, extra_meta) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {
        "step": step,
        "treedef": "repro_torch",
        "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                   for k, v in arrays.items()},
        "extra": extra_meta or {},
        "time": time.time(),
    }
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def save(ckpt_dir: str, step: int, state: Any,
         extra_meta: Optional[dict] = None) -> str:
    """Synchronous atomic checkpoint. Returns the final path."""
    arrays, dtypes = _snapshot(state)
    return _write(ckpt_dir, step, arrays, dtypes, extra_meta)


def _to_torch(arr: np.ndarray, dtype: str, like, device) -> torch.Tensor:
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")
    if (like.dtype == torch.bfloat16 or dtype == "bfloat16") \
            and (arr.dtype.kind == "V" or arr.dtype == np.uint16):
        bits = torch.from_numpy(arr.view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device=device, dtype=like.dtype)


def restore(ckpt_dir: str, state_template: Any, step: Optional[int] = None,
            device=None, shardings: Any = None) -> Tuple[int, Any]:
    """Restore into the structure of ``state_template`` (tensors of any
    device, ``meta`` included, give the shapes and dtypes; QTensors their
    static fields) on ``device`` (default: each template leaf's own).

    ``shardings`` (the template's nesting with a
    :class:`~repro_torch.parallel.sharding.NamedSharding` at every leaf)
    places each leaf on its mesh instead, as a Sharded cut from the
    logical array: the checkpoint carries no mesh, only logical arrays."""
    path = latest(ckpt_dir) if step is None else os.path.join(
        ckpt_dir, f"step_{step:08d}")
    if path is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))

    def load(p, tpl, where):
        key = "/".join(p)
        arr = data[key]
        assert tuple(arr.shape) == tuple(tpl.shape), (key, arr.shape,
                                                      tuple(tpl.shape))
        dtype = manifest["leaves"].get(key, {}).get("dtype")
        if isinstance(where, sharding.NamedSharding):
            t = _to_torch(arr, dtype, tpl, "cpu")
            if t.ndim == 0:       # the step counter: on the first position
                return t.to(where.mesh.devices[0])
            return sharding.shard(t, where.spec, where.mesh)
        return _to_torch(arr, dtype, tpl,
                         tpl.device if device is None else device)

    def build(t, w, p=()):
        if isinstance(t, QTensor):
            return t._replace(q=load(p + ("0",), t.q, w and w.q),
                              scale=load(p + ("1",), t.scale,
                                         w and w.scale))
        if isinstance(t, dict):
            return {k: build(v, w and w[k], p + (str(k),))
                    for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(getattr(t, f), w and getattr(w, f),
                                   p + ("." + f,)) for f in t._fields))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v, w and w[i], p + (str(i),))
                           for i, v in enumerate(t))
        return load(p, t, w)

    return manifest["step"], build(state_template, shardings)


def latest(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    return os.path.join(ckpt_dir, steps[-1]) if steps else None


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = latest(ckpt_dir)
    return int(p.rsplit("_", 1)[1]) if p else None


class AsyncCheckpointer:
    """Snapshot synchronously, write in a daemon thread; keep_last GC."""

    def __init__(self, ckpt_dir: str, keep_last: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, state: Any, extra_meta: Optional[dict] = None):
        self.wait()
        arrays, dtypes = _snapshot(state)   # host copies, taken now

        def _run():
            try:
                _write(self.ckpt_dir, step, arrays, dtypes, extra_meta)
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = sorted(d for d in os.listdir(self.ckpt_dir)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for d in steps[:-self.keep_last]:
            shutil.rmtree(os.path.join(self.ckpt_dir, d), ignore_errors=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e
