"""Fault-tolerant training loop: checkpoint/restart, health, stragglers.

Reference: ``repro/runtime/train_loop.py``.  The loop is host-side nOS
(Swallow C8): it owns placement, persistence and recovery so the model
code never sees any of it.  Deterministic data (seed, step) and atomic
checkpoints give exactly-once step semantics across restarts; an
injectable failure hook lets tests exercise fail -> restore.  On a mesh
(a :class:`~repro_torch.launch.mesh.DeviceMesh`: one controller, one
torch device a position) the state is placed by ``param_specs`` and
``adam.state_specs``, a restore re-places the checkpoint's logical arrays
on the current mesh (``elastic.state_shardings``), and the step is the
mesh's (``steps.make_train_step`` under ``use_sharding``).
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import steps as steps_mod, weights
from repro_torch.data import pipeline as data_lib
from repro_torch.optim import adam as adam_lib
from repro_torch.parallel.sharding import use_sharding
from repro_torch.runtime import checkpoint as ckpt_lib
from repro_torch.runtime import elastic as elastic_lib
from repro_torch.runtime.health import HeartbeatMonitor, StragglerDetector


@dataclass
class TrainJobConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep_last: int = 3
    peak_lr: float = 3e-4
    warmup: int = 20
    seed: int = 0
    metrics_path: Optional[str] = None


def run(cfg, shape, mesh=None, rules=None, job: TrainJobConfig = None,
        failure_hook: Optional[Callable[[int], None]] = None,
        device=None) -> Dict[str, Any]:
    """Train ``cfg`` at ``shape`` on ``mesh`` (None: one device, ``cuda``
    unless the caller names another; a mesh's positions carry their own
    devices).  Initial parameters come from ``weights.init_params`` with a
    generator seeded ``job.seed`` (on a mesh: made on its first position's
    device, then placed), or from the latest checkpoint in
    ``job.ckpt_dir``.  Returns the reference's dict: final metrics, the
    logged history, params (the port's nesting; on a mesh the
    reference-shaped tree of Sharded leaves), opt_state and the loop's
    wall time."""
    device = mesh.devices[0] if mesh is not None \
        else weights.resolve_device(device)
    job = job or TrainJobConfig()
    adam_cfg = steps_mod.adam_config_for(cfg)
    schedule = lambda s: adam_lib.warmup_cosine(
        s, peak_lr=job.peak_lr, warmup=job.warmup, total=job.steps)

    data_cfg = data_lib.DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=shape.seq_len,
                                   global_batch=shape.global_batch,
                                   seed=job.seed)
    source = data_lib.make_source(data_cfg)

    with use_sharding(mesh, rules) as env:
        steps_mod.check_mesh(cfg, mesh, env)
        return _run(cfg, job, adam_cfg, schedule, source, env, device,
                    failure_hook)


def _run(cfg, job, adam_cfg, schedule, source, env, device, failure_hook):
    # --- state init / restore ------------------------------------------------
    start_step = 0
    if job.ckpt_dir and ckpt_lib.latest(job.ckpt_dir):
        p_shape = steps_mod.abstract_params(cfg)
        o_shape = steps_mod.abstract_opt_state(cfg, adam_cfg, p_shape)
        shardings = None
        if env is not None:
            ps, os_ = elastic_lib.state_shardings(cfg, adam_cfg, env)
            shardings = {"params": ps, "opt": os_}
        start_step, state = ckpt_lib.restore(
            job.ckpt_dir, {"params": p_shape, "opt": o_shape},
            device=device, shardings=shardings)
        params, opt_state = state["params"], state["opt"]
        if env is None:
            params = weights.unstack(params, cfg)
    else:
        gen = torch.Generator(device=device).manual_seed(job.seed)
        params = weights.init_params(cfg, generator=gen, device=device)
        if env is not None:
            params = weights.shard_params(params, cfg, env.mesh)
            opt_state = adam_lib.init(params, adam_cfg)
        else:
            opt_state = adam_lib.init(weights.to_reference(params, cfg),
                                      adam_cfg)

    step_fn = steps_mod.make_train_step(cfg, adam_cfg, schedule)
    cards = sorted({d for d in (env.mesh.devices if env is not None
                                else (device,)) if d.type == "cuda"},
                   key=str)

    # --- runtime services ----------------------------------------------------
    nodes = ["host0"]
    hb = HeartbeatMonitor(nodes, timeout_s=300.0)
    straggler = StragglerDetector(nodes)
    ckpt = ckpt_lib.AsyncCheckpointer(job.ckpt_dir, job.keep_last) \
        if job.ckpt_dir else None
    metrics_log = []
    prefetch = data_lib.Prefetcher(source, start_step=start_step)

    def state_tree():
        return {"params": params if env is not None
                else weights.to_reference(params, cfg), "opt": opt_state}

    t_loop = time.time()
    last, saved = {}, None
    try:
        for step, host_batch in prefetch:
            if step >= job.steps:
                break
            if failure_hook is not None:
                failure_hook(step)   # tests: raise to simulate a crash
            t0 = time.time()
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in host_batch.items()}
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            for d in cards:
                torch.cuda.synchronize(d)
            dt = time.time() - t0
            hb.beat(nodes[0])
            evict = straggler.observe({nodes[0]: dt})
            if evict:
                metrics["stragglers"] = len(evict)
            if (step + 1) % job.log_every == 0 or step == start_step:
                last = {k: float(v) for k, v in metrics.items()}
                last.update(step=step, sec_per_step=dt)
                metrics_log.append(last)
                print(f"step {step:6d} loss={last.get('loss', 0):.4f} "
                      f"gnorm={last.get('grad_norm', 0):.3f} "
                      f"{dt:.2f}s/step")
            if ckpt and (step + 1) % job.ckpt_every == 0:
                ckpt.save(step + 1, state_tree())
                saved = step + 1
    finally:
        prefetch.close()
        if ckpt:
            ckpt.wait()

    if ckpt and job.steps > 0 and saved != job.steps:
        # the final state (the reference writes it again when the last
        # periodic checkpoint already holds it)
        ckpt.save(job.steps, state_tree())
        ckpt.wait()
    if job.metrics_path:
        os.makedirs(os.path.dirname(job.metrics_path) or ".", exist_ok=True)
        with open(job.metrics_path, "w") as f:
            json.dump(metrics_log, f, indent=1)
    return {"final_metrics": last, "history": metrics_log,
            "params": params, "opt_state": opt_state,
            "wall_s": time.time() - t_loop}
