"""Swallow §VIII: nOS — a nano-OS for many-core, as a mesh-slice scheduler.

nOS abstracts thread creation, mapping, network configuration and energy
optimisation.  At pod scale the analogous runtime owns: mesh slicing
(placement), job admission (the paper's "multiple non-interacting
applications"), per-slice energy accounting, and restart orchestration.
The scheduler is pure host-side logic — unit-testable, no devices
needed — and produces placements that ``jax.make_mesh`` sub-meshes can
realise.

Placement policy (paper-faithful): jobs are independent (C1), so slices
never share chips; allocation is first-fit over whole "data" rows so the
"model" axis (the high-bandwidth dimension) is never split between
tenants — locality exactly as §II-B argues.

Cost-aware admission: a job submitted with a ``ModelConfig`` (instead of
a bare row count) is priced by the :mod:`repro.core.costs` engine at
placement time — every feasible row count is a candidate slice, each is
priced as a ``Layout(data=rows, model=model_cols)``, and the scheduler
picks the one minimising the per-step energy-delay product (the §VIII
"energy optimisation" responsibility, made concrete).  The chosen
estimate also drives per-job power/energy accounting, replacing the flat
active-watts assumption in ``power_estimate_w``.

Serving telemetry (what is extrapolated beyond the paper): the paged
serving engine (:mod:`repro.serving`) reports per-job KV pages held,
tokens emitted, queue latency, preemptions and engine-priced energy
through :meth:`NOS.update_serving`; ``serving_table()`` renders the
fleet view — the paper's "program that can measure its own power",
widened to a tenant that can measure its own cache footprint.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.serving.telemetry import MetricsRegistry, gauge_attr


def _gauge(name=None):
    # Job's serving gauges live in its per-job MetricsRegistry (attr
    # ``metrics``) — unannotated class attributes, so the dataclass
    # constructor/repr surface is unchanged (scheduling fields only)
    return gauge_attr(name, registry="metrics", default=0)


@dataclass
class Job:
    name: str
    rows_needed: int = 0               # data-axis rows (model axis is whole);
                                       # 0 => cost engine chooses at placement
    steps: int = 0
    submitted_at: float = 0.0
    started_at: Optional[float] = None
    rows: Tuple[int, ...] = ()
    state: str = "pending"             # pending|running|done|failed
    # -- cost-aware extension (set when submitted with a config) -----------
    config: Optional[object] = None    # repro.configs.base.ModelConfig
    shape: Optional[object] = None     # repro.configs.base.ShapeConfig
    link_mode: str = "circuit"         # §V model used to price placement
    auto_size: bool = False            # engine re-sizes at every attempt
    max_rows: int = 0                  # tenant quota; 0 = unlimited
    estimate: Optional[object] = None  # costs.CostEstimate of chosen slice
    energy_j: float = 0.0              # accrued at finish()

    # -- serving extension (paged engine reports through update_serving) ----
    # registry-backed gauges: one MetricsRegistry per job (``metrics``),
    # same external attribute names as the old dataclass fields
    pages_held = _gauge()              # KV pages currently allocated
    peak_pages = _gauge()
    tokens_out = _gauge()              # tokens emitted so far
    queue_latency_s = _gauge()         # mean admission->first-token latency
    preemptions = _gauge()
    # -- prefix-sharing overlay (repro.serving.prefix_cache) ----------------
    shared_pages = _gauge()            # pages owned by the radix tree
    prefix_hit_rate = _gauge()         # admissions served from shared pages
    bytes_deduped = _gauge()           # KV bytes NOT re-prefilled
    # -- speculative decoding (repro.serving.spec_decode) --------------------
    accept_rate = _gauge()             # draft tokens the verifier kept
    dispatches_per_token = _gauge()    # sequential model passes per token
    spec_k = _gauge()                  # mean adaptive draft depth requested
    # -- SLO telemetry (repro.serving.slo + the chunked scheduler) -----------
    ttft_p99_s = _gauge()              # tail first-token latency observed
    ttft_target_s = _gauge()           # the class deadline, priced to seconds
    goodput_frac = _gauge()            # fraction of tokens from SLO-met reqs
    # -- fault plane (repro.serving.faults) ----------------------------------
    pages_quarantined = _gauge()       # pages lost to dead stripes (cumul.)
    requests_recovered = _gauge()      # fault resets recomputed exactly
    tokens_recomputed = _gauge()       # emitted tokens discarded by resets
    recovery_steps_p99 = _gauge()      # reset -> first-token tail latency
    # -- predicted-vs-measured attribution (repro.serving.telemetry) ---------
    predicted_s = _gauge()             # cost-engine seconds, dispatch spans
    measured_s = _gauge()              # wall seconds over the same spans
    predicted_j = _gauge()             # §VI joules over the same spans
    model_error = None                 # per-phase rollup dict (or None)

    def __post_init__(self):
        self.metrics = MetricsRegistry()


@dataclass
class NOS:
    """First-fit row scheduler over a (data x model) pod."""
    data_rows: int = 16
    model_cols: int = 16
    jobs: Dict[str, Job] = field(default_factory=dict)
    _free: List[int] = field(default_factory=list)
    _quarantined: set = field(default_factory=set)

    def __post_init__(self):
        self._free = list(range(self.data_rows))
        self._quarantined = set()

    # -- admission -----------------------------------------------------------
    def submit(self, job, *, name: Optional[str] = None, shape=None,
               steps: int = 0, mode: str = "circuit",
               max_rows: int = 0) -> bool:
        """Admit a job.

        Accepts either a prepared :class:`Job`, or a ``ModelConfig``
        (plus ``name``/``shape``/``steps``/``max_rows`` keywords) — the
        cost-aware path, where the engine sizes the slice instead of the
        caller (``max_rows`` is the tenant's quota).
        """
        if not isinstance(job, Job):
            job = Job(name=name or getattr(job, "name", "job"),
                      config=job, shape=shape, steps=steps, link_mode=mode,
                      max_rows=max_rows)
        if job.config is not None and job.rows_needed == 0:
            job.auto_size = True
        job.submitted_at = job.submitted_at or time.time()
        self.jobs[job.name] = job
        return self._try_place(job)

    def _size_from_costs(self, job: Job) -> int:
        """Price every feasible row count; return the EDP-optimal one."""
        from repro_torch.core import costs as costs_mod
        free = len(self._free)
        if job.max_rows:
            free = min(free, job.max_rows)
        if free == 0:
            return 1            # nothing free: ask for the minimal slice
        B = job.shape.global_batch if job.shape is not None else 0
        candidates = [r for r in range(1, free + 1) if not B or B % r == 0]
        if not candidates:
            candidates = list(range(1, free + 1))
        best_r, best = None, None
        for r in candidates:
            lay = costs_mod.Layout(data=r, model=self.model_cols)
            est = costs_mod.estimate(job.config, lay, job.link_mode,
                                     job.shape)
            if best is None or est.edp() < best.edp():
                best_r, best = r, est
        job.estimate = best
        return best_r

    def _try_place(self, job: Job) -> bool:
        if job.state != "pending":
            return False
        if job.config is not None:
            if job.auto_size:
                job.rows_needed = self._size_from_costs(job)
            elif job.estimate is None:
                from repro_torch.core import costs as costs_mod
                lay = costs_mod.Layout(data=max(job.rows_needed, 1),
                                       model=self.model_cols)
                job.estimate = costs_mod.estimate(job.config, lay,
                                                  job.link_mode, job.shape)
        if job.rows_needed <= 0 or job.rows_needed > len(self._free):
            return False
        job.rows = tuple(sorted(self._free[:job.rows_needed]))
        self._free = self._free[job.rows_needed:]
        job.state = "running"
        job.started_at = time.time()
        return True

    def finish(self, name: str, state: str = "done"):
        job = self.jobs[name]
        if job.estimate is not None and job.steps:
            n_chips = len(job.rows) * self.model_cols
            job.energy_j += job.steps * job.estimate.energy.total_j * n_chips
        self._free = sorted(self._free + list(job.rows))
        job.rows = ()
        job.state = state
        # admit pending jobs in FIFO order
        for j in sorted(self.jobs.values(), key=lambda j: j.submitted_at):
            if j.state == "pending":
                self._try_place(j)

    def fail_rows(self, rows: List[int]):
        """Hardware failure: evict jobs touching the rows, quarantine them."""
        evicted = []
        for job in self.jobs.values():
            if job.state == "running" and set(job.rows) & set(rows):
                job.state = "pending"
                self._free = sorted(set(self._free) | set(job.rows))
                job.rows = ()
                evicted.append(job.name)
        self._free = [r for r in self._free if r not in rows]
        self._quarantined |= {r for r in rows if 0 <= r < self.data_rows}
        for j in sorted(self.jobs.values(), key=lambda j: j.submitted_at):
            if j.state == "pending":
                self._try_place(j)
        return evicted

    def restore_rows(self, rows: List[int]) -> List[str]:
        """Elastic re-join — the inverse of :meth:`fail_rows`: rows a
        failure quarantined return to the free pool, and pending jobs
        re-place in FIFO order against the recovered capacity.  Rows
        that were never quarantined are ignored (restoring is idempotent
        and never double-frees a row a running job holds).  Returns the
        names of jobs placed by the recovery."""
        back = {r for r in rows if r in self._quarantined}
        self._quarantined -= back
        self._free = sorted(set(self._free) | back)
        placed = []
        for j in sorted(self.jobs.values(), key=lambda j: j.submitted_at):
            if j.state == "pending" and self._try_place(j):
                placed.append(j.name)
        return placed

    # -- accounting -----------------------------------------------------------
    def utilisation(self) -> float:
        used = self.data_rows - len(self._free)
        return used / self.data_rows

    def power_estimate_w(self, active_w: float = 200.0,
                         idle_w: float = 60.0) -> float:
        """Fleet power (Fig. 8/9 logic): costed jobs contribute their
        engine-estimated per-chip draw, uncosted slices a flat TDP-ish
        figure, free rows idle — energy proportionality at the
        allocation level."""
        total = len(self._free) * idle_w * self.model_cols
        for job in self.jobs.values():
            if job.state != "running":
                continue
            per_chip = (job.estimate.energy.w_per_chip
                        if job.estimate is not None else active_w)
            total += len(job.rows) * self.model_cols * per_chip
        return total

    def energy_account(self) -> Dict[str, float]:
        """Joules accrued per finished job (the paper's 'program that can
        measure its own power', at the scheduler level)."""
        return {j.name: j.energy_j for j in self.jobs.values()
                if j.energy_j > 0.0}

    def update_serving(self, name: str, *, pages_held: Optional[int] = None,
                       peak_pages: Optional[int] = None,
                       tokens_out: Optional[int] = None,
                       queue_latency_s: Optional[float] = None,
                       preemptions: Optional[int] = None,
                       energy_j: Optional[float] = None,
                       shared_pages: Optional[int] = None,
                       prefix_hit_rate: Optional[float] = None,
                       bytes_deduped: Optional[int] = None,
                       accept_rate: Optional[float] = None,
                       dispatches_per_token: Optional[float] = None,
                       spec_k: Optional[float] = None,
                       ttft_p99_s: Optional[float] = None,
                       ttft_target_s: Optional[float] = None,
                       goodput_frac: Optional[float] = None,
                       pages_quarantined: Optional[int] = None,
                       requests_recovered: Optional[int] = None,
                       tokens_recomputed: Optional[int] = None,
                       recovery_steps_p99: Optional[float] = None,
                       predicted_s: Optional[float] = None,
                       measured_s: Optional[float] = None,
                       predicted_j: Optional[float] = None,
                       model_error: Optional[dict] = None):
        """Serving-engine telemetry (§VIII: nOS owns per-application
        accounting).  The paged engine calls this per replay/step batch;
        ``energy_j`` accrues (engine-priced decode energy), ``peak_pages``
        is monotone, the rest are gauges.  The prefix-sharing gauges
        (``shared_pages`` / ``prefix_hit_rate`` / ``bytes_deduped``)
        surface the §X-B overlay: how much of the striped store is
        serving more than one tenant, and how much prefill it saved.
        The speculative-decoding gauges (``accept_rate`` /
        ``dispatches_per_token`` / ``spec_k``) surface the §V
        payload-per-dispatch lever: how many sequential model passes
        each emitted token cost, and how deep the per-tenant adaptive
        controller is currently drafting.  The SLO gauges (``ttft_p99_s``
        vs ``ttft_target_s``, ``goodput_frac``) surface the chunked
        scheduler's deadline contract: tail first-token latency against
        the tenant's class deadline (priced to seconds by the cost
        engine's ``decode_cost_s``) and the fraction of emitted tokens
        that came from requests whose deadline was met.  The fault-plane
        gauges (``pages_quarantined`` / ``requests_recovered`` /
        ``tokens_recomputed`` / ``recovery_steps_p99``) surface the
        §VIII failure story: how much of the striped store a dead node
        took with it, how many tenants were reset and recomputed
        exactly, and the tail latency of that recovery.  The
        attribution gauges (``predicted_s`` / ``measured_s`` /
        ``predicted_j``, plus the per-phase ``model_error`` rollup from
        :func:`repro.serving.telemetry.rollup_dispatch_events`) surface
        the §IV contract — the cost model's priced seconds and §VI
        joules against the wall clock the dispatch spans actually
        measured — rendered fleet-wide by :meth:`attribution_table`."""
        job = self.jobs[name]
        if pages_held is not None:
            job.pages_held = pages_held
            job.peak_pages = max(job.peak_pages, pages_held)
        if peak_pages is not None:
            job.peak_pages = max(job.peak_pages, peak_pages)
        if tokens_out is not None:
            job.tokens_out = tokens_out
        if queue_latency_s is not None:
            job.queue_latency_s = queue_latency_s
        if preemptions is not None:
            job.preemptions = preemptions
        if energy_j is not None:
            job.energy_j += energy_j
        if shared_pages is not None:
            job.shared_pages = shared_pages
        if prefix_hit_rate is not None:
            job.prefix_hit_rate = prefix_hit_rate
        if bytes_deduped is not None:
            job.bytes_deduped = bytes_deduped
        if accept_rate is not None:
            job.accept_rate = accept_rate
        if dispatches_per_token is not None:
            job.dispatches_per_token = dispatches_per_token
        if spec_k is not None:
            job.spec_k = spec_k
        if ttft_p99_s is not None:
            job.ttft_p99_s = ttft_p99_s
        if ttft_target_s is not None:
            job.ttft_target_s = ttft_target_s
        if goodput_frac is not None:
            job.goodput_frac = goodput_frac
        if pages_quarantined is not None:
            job.pages_quarantined = pages_quarantined
        if requests_recovered is not None:
            job.requests_recovered = requests_recovered
        if tokens_recomputed is not None:
            job.tokens_recomputed = tokens_recomputed
        if recovery_steps_p99 is not None:
            job.recovery_steps_p99 = recovery_steps_p99
        if predicted_s is not None:
            job.predicted_s = predicted_s
        if measured_s is not None:
            job.measured_s = measured_s
        if predicted_j is not None:
            job.predicted_j = predicted_j
        if model_error is not None:
            job.model_error = dict(model_error)

    def attribution_table(self) -> str:
        """Fleet-level predicted-vs-measured view (§IV 'measure your own
        power', applied to the cost model itself): per job — and per
        dispatch phase when a ``model_error`` rollup was reported — the
        cost engine's priced seconds and §VI joules next to measured
        wall seconds, with the measured/predicted ratio that says how
        honest the model is."""
        hdr = (f"{'job/phase':<24} {'count':>6} {'pred_s':>10} "
               f"{'meas_s':>10} {'meas/pred':>9} {'pred_J':>10} "
               f"{'comm_s':>9}")
        rows = [hdr, "-" * len(hdr)]
        for j in self.jobs.values():
            if not (j.measured_s or j.model_error):
                continue
            ratio = (j.measured_s / j.predicted_s
                     if j.predicted_s else float("nan"))
            comm = sum(r.get("predicted_comms_s", 0.0)
                       for r in (j.model_error or {}).values())
            rows.append(f"{j.name:<24} {'':>6} {j.predicted_s:>10.4f} "
                        f"{j.measured_s:>10.4f} {ratio:>9.2f} "
                        f"{j.predicted_j:>10.3f} {comm:>9.4f}")
            for phase in sorted(j.model_error or ()):
                r = j.model_error[phase]
                pr = (r["measured_s"] / r["predicted_s"]
                      if r.get("predicted_s") else float("nan"))
                rows.append(f"  {phase:<22} {int(r.get('count', 0)):>6} "
                            f"{r.get('predicted_s', 0.0):>10.4f} "
                            f"{r.get('measured_s', 0.0):>10.4f} "
                            f"{pr:>9.2f} {r.get('predicted_j', 0.0):>10.3f} "
                            f"{r.get('predicted_comms_s', 0.0):>9.4f}")
        return "\n".join(rows)

    def serving_table(self) -> str:
        """Fleet view of the serving gauges (pages, tokens, TTFT, the
        prefix-sharing overlay columns, the SLO contract: observed p99
        TTFT vs the class target plus goodput, and the fault plane:
        quarantined pages, recovered requests, recomputed tokens, and
        the recovery tail)."""
        rows = [f"{'job':<18} {'pages':>6} {'peak':>5} {'tokens':>8} "
                f"{'ttft_s':>9} {'preempt':>7} {'energy_J':>10} "
                f"{'shared':>6} {'hit%':>5} {'dedupKB':>8} "
                f"{'acc%':>5} {'disp/tok':>8} {'K':>5} "
                f"{'p99/tgt_s':>18} {'good%':>5} "
                f"{'quar':>5} {'recov':>5} {'recomp':>6} {'rcvp99':>6}"]
        for j in self.jobs.values():
            if j.tokens_out == 0 and j.peak_pages == 0:
                continue
            slo = f"{j.ttft_p99_s:>8.2e}/{j.ttft_target_s:<8.2e}" \
                if j.ttft_target_s > 0 else f"{'-':>18}"
            rows.append(f"{j.name:<18} {j.pages_held:>6} {j.peak_pages:>5} "
                        f"{j.tokens_out:>8} {j.queue_latency_s:>9.2e} "
                        f"{j.preemptions:>7} {j.energy_j:>10.3g} "
                        f"{j.shared_pages:>6} "
                        f"{j.prefix_hit_rate * 100:>5.0f} "
                        f"{j.bytes_deduped / 1024:>8.0f} "
                        f"{j.accept_rate * 100:>5.0f} "
                        f"{j.dispatches_per_token:>8.2f} "
                        f"{j.spec_k:>5.1f} "
                        f"{slo} "
                        f"{j.goodput_frac * 100:>5.0f} "
                        f"{j.pages_quarantined:>5} "
                        f"{j.requests_recovered:>5} "
                        f"{j.tokens_recomputed:>6} "
                        f"{j.recovery_steps_p99:>6.1f}")
        return "\n".join(rows)

    def placement_table(self) -> str:
        rows = []
        for j in self.jobs.values():
            line = f"{j.name:<16} {j.state:<8} rows={list(j.rows)}"
            if j.estimate is not None:
                line += (f" step={j.estimate.step_time_s * 1e3:.2f}ms"
                         f" {j.estimate.energy.w_per_chip:.0f}W/chip")
            rows.append(line)
        rows.append(f"free rows: {self._free}")
        return "\n".join(rows)
