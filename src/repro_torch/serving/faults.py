"""Swallow §VIII's operating condition made testable: a deterministic
fault plane for the paged serving engine.

At 480 cores, node and link failure is routine, not exceptional — nOS
already models it for training placement (``core/nos.py::fail_rows``)
and the runtime ships pure-state-machine detectors
(:mod:`repro.runtime.health`).  This module gives the *serving* stack
the same story, deterministically: a :class:`FaultPlan` is a seeded,
replayable schedule of fault events on the scheduler's step clock —
node failures (a stripe of the §X-B DSM goes dark), transient dispatch
errors (an admission bounces and retries under capped exponential
backoff), and straggler slowdowns (a node's step durations inflate
until the detector evicts it) — and a :class:`FaultPlane` is the
watchdog that wires the plan through ``HeartbeatMonitor`` and
``StragglerDetector`` into :meth:`repro.serving.engine.PagedEngine
.fail_node` / ``join_node``.

Everything runs on the deterministic step clock (the detectors take
explicit ``now`` timestamps), so a chaos run is exactly reproducible:
same seed, same fault schedule, same detection steps, same recoveries —
which is what lets the chaos harness pin surviving requests
bit-identical to a fault-free run (greedy recompute is exact).

Pure host-side logic: no jax imports.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Set

import numpy as np

from repro_torch.runtime.health import HeartbeatMonitor, StragglerDetector
from repro_torch.serving.telemetry import MetricsRegistry, counter_attr

KINDS = ("fail", "join", "slow", "transient")


@dataclass(frozen=True)
class FaultEvent:
    """One planned fault on the scheduler step clock.

    ``fail``/``join`` toggle a node's liveness (it stops/resumes
    heartbeating); ``slow`` inflates the node's observed step durations
    by ``factor`` for ``duration`` steps; ``transient`` makes ``count``
    admission dispatches bounce from ``step`` onward."""
    step: int
    kind: str
    node: int = -1
    count: int = 1          # transient: rejection tokens made available
    duration: int = 0       # slow: steps the slowdown lasts
    factor: float = 3.0     # slow: per-step duration multiplier

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if self.step < 0:
            raise ValueError("fault steps are >= 0 (relative to arming)")


@dataclass
class FaultPlan:
    """A replayable fault schedule.  Steps are relative to the plane's
    arming point (the engine installs the plan *after* warmup, so warmup
    steps never consume events)."""
    events: List[FaultEvent] = field(default_factory=list)

    def __post_init__(self):
        self.events = sorted(self.events,
                             key=lambda e: (e.step, KINDS.index(e.kind),
                                            e.node))

    # -- queries (all pure; the watchdog polls them per step) --------------
    def alive(self, node: int, step: int) -> bool:
        """Liveness under the fail/join toggles through ``step``."""
        state = True
        for ev in self.events:
            if ev.step > step:
                break
            if ev.node != node:
                continue
            if ev.kind == "fail":
                state = False
            elif ev.kind == "join":
                state = True
        return state

    def slow_factor(self, node: int, step: int) -> float:
        """Duration multiplier for the node at ``step`` (1.0 = nominal)."""
        f = 1.0
        for ev in self.events:
            if ev.step > step:
                break
            if ev.kind == "slow" and ev.node == node \
                    and step < ev.step + ev.duration:
                f = max(f, ev.factor)
        return f

    def transients_through(self, step: int) -> int:
        """Total transient-rejection tokens made available by ``step``."""
        return sum(ev.count for ev in self.events
                   if ev.kind == "transient" and ev.step <= step)

    @property
    def n_node_failures(self) -> int:
        return sum(1 for ev in self.events if ev.kind == "fail")

    @property
    def horizon(self) -> int:
        """Last step any event (or slow window) is active."""
        h = 0
        for ev in self.events:
            h = max(h, ev.step + (ev.duration if ev.kind == "slow" else 0))
        return h

    @classmethod
    def seeded(cls, seed: int, *, n_nodes: int, horizon: int,
               n_fails: int = 2, n_transients: int = 2,
               n_slow: int = 1, slow_factor: float = 4.0) -> "FaultPlan":
        """Draw a deterministic chaos schedule.  Node 0 never fails —
        the pool always keeps at least one healthy stripe, so the run
        degrades instead of dying — and each failed node re-joins before
        the horizon so elastic re-join is exercised too.  Fail windows
        land on distinct nodes round-robin (a node is never double-failed
        while already down)."""
        if n_nodes < 2 and (n_fails or n_slow):
            raise ValueError("need n_nodes >= 2 to fail or slow a node "
                             "while keeping node 0 healthy")
        rng = np.random.default_rng(seed)
        events: List[FaultEvent] = []
        span = max(horizon, 8 * (n_fails + 1))
        for i in range(n_fails):
            node = 1 + i % (n_nodes - 1)
            at = span * (i + 1) // (n_fails + 2) \
                + int(rng.integers(0, max(span // 8, 1)))
            down = 3 + int(rng.integers(0, max(span // 6, 1)))
            events.append(FaultEvent(at, "fail", node))
            events.append(FaultEvent(at + down, "join", node))
        for _ in range(n_transients):
            at = int(rng.integers(1, max(span // 2, 2)))
            events.append(FaultEvent(at, "transient",
                                     count=1 + int(rng.integers(0, 2))))
        for i in range(n_slow):
            node = 1 + int(rng.integers(0, n_nodes - 1))
            at = int(rng.integers(1, max(span // 2, 2)))
            dur = 6 + int(rng.integers(0, max(span // 6, 1)))
            events.append(FaultEvent(at, "slow", node, duration=dur,
                                     factor=slow_factor))
        return cls(events)


class FaultPlane:
    """The watchdog: polls the plan each engine step, feeds the health
    detectors on the deterministic step clock, and drives
    ``engine.fail_node`` / ``engine.join_node``.

    Detection is honest, not oracular: a killed node is failed only
    after ``heartbeat_steps`` of missed beats, and a straggler only
    after ``straggler_patience`` consecutive over-ratio observations —
    the same state machines a wall-clock deployment would run, just fed
    synthetic observations derived from the plan."""

    # registry-backed (the engine's registry when installed through
    # PagedEngine.install_faults, so a warmup reset covers it)
    _transients_used = counter_attr("fault_transients_used")

    def __init__(self, plan: FaultPlan, n_nodes: int, *,
                 epoch: int = 0, heartbeat_steps: float = 2.0,
                 straggler_ratio: float = 1.5, straggler_patience: int = 2,
                 base_step_s: float = 1.0,
                 registry: MetricsRegistry = None):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.plan = plan
        self.n_nodes = n_nodes
        self.epoch = epoch            # plan step 0 == scheduler step epoch
        self.base_step_s = base_step_s
        names = [str(i) for i in range(n_nodes)]
        self.hb = HeartbeatMonitor(names, timeout_s=float(heartbeat_steps))
        self.sd = StragglerDetector(names, ratio=straggler_ratio,
                                    patience=straggler_patience)
        self.down: Set[int] = set()   # nodes the engine currently holds out
        self._transients_used = 0
        for n in names:
            self.hb.beat(n, 0.0)      # rebase heartbeats onto the step clock

    # the scheduler calls this per admission attempt (Request, step_idx)
    def transient_gate(self, req, step: int) -> bool:
        avail = self.plan.transients_through(step - self.epoch)
        if self._transients_used < avail:
            self._transients_used += 1
            return True
        return False

    def on_step(self, eng) -> None:
        """One watchdog tick: beats for alive nodes, heartbeat timeout
        check, straggler observation over the healthy cohort, then
        fail/join transitions on the engine."""
        rel = eng.sched.step_idx - self.epoch
        now = float(rel)
        for i in range(self.n_nodes):
            if self.plan.alive(i, rel):
                self.hb.beat(str(i), now)
        newly = {int(n) for n in self.hb.check(now)}
        durations = {str(i): self.base_step_s * self.plan.slow_factor(i, rel)
                     for i in range(self.n_nodes)
                     if i not in self.down and str(i) not in self.hb.failed}
        evicted: Set[int] = set()
        if len(durations) >= 2:
            evicted = {int(n) for n in self.sd.observe(durations)}
        for node in sorted(newly | evicted):
            if node not in self.down:
                self.down.add(node)
                eng.fail_node(node)
        for node in sorted(self.down - newly - evicted):
            if str(node) in self.hb.failed:
                continue              # still missing heartbeats
            if self.plan.alive(node, rel) \
                    and self.plan.slow_factor(node, rel) <= 1.0:
                self.down.discard(node)
                eng.join_node(node)

    def summary(self) -> dict:
        return {
            "events": len(self.plan.events),
            "planned_failures": self.plan.n_node_failures,
            "transients_used": self._transients_used,
            "nodes_down": sorted(self.down),
        }
