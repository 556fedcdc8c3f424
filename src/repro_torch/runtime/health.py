"""Failure detection and straggler mitigation (nOS-style runtime policy).

At thousand-node scale the runtime must (a) notice dead hosts quickly,
(b) notice *slow* hosts before they become the step time, and (c) decide
deterministically what to do.  Both detectors are pure state machines so
the policies are unit-testable without a cluster; the train loop feeds
them wall-clock observations (heartbeats, per-step durations).

Policies follow the Swallow design rules: independent nodes (C1) mean a
straggler cannot slow others *except* through collectives — so the only
lever is eviction/rescale, never waiting.
"""
from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set


@dataclass
class HeartbeatMonitor:
    """Dead-host detector: miss `timeout_s` of heartbeats => failed."""
    nodes: List[str]
    timeout_s: float = 60.0
    _last: Dict[str, float] = field(default_factory=dict)
    _failed: Set[str] = field(default_factory=set)

    def __post_init__(self):
        now = time.time()
        for n in self.nodes:
            self._last[n] = now

    def beat(self, node: str, now: Optional[float] = None):
        if node in self._failed:
            self._failed.discard(node)   # node came back (elastic re-join)
        self._last[node] = now if now is not None else time.time()

    def check(self, now: Optional[float] = None) -> Set[str]:
        """Returns the set of newly-failed nodes."""
        now = now if now is not None else time.time()
        new = set()
        for n, t in self._last.items():
            if n not in self._failed and now - t > self.timeout_s:
                new.add(n)
                self._failed.add(n)
        return new

    @property
    def failed(self) -> Set[str]:
        return set(self._failed)

    def healthy(self) -> List[str]:
        return [n for n in self.nodes if n not in self._failed]


@dataclass
class StragglerDetector:
    """Flags nodes whose step time exceeds `ratio` x fleet median for
    `patience` consecutive observations."""
    nodes: List[str]
    ratio: float = 1.5
    patience: int = 3
    window: int = 20
    _hist: Dict[str, List[float]] = field(default_factory=dict)
    _strikes: Dict[str, int] = field(default_factory=dict)

    def observe(self, durations: Dict[str, float]) -> Set[str]:
        """Feed one step's per-node durations; returns nodes to evict.
        An empty observation (every node failed or held out) evicts
        nobody — there is no fleet median to straggle against."""
        if not durations:
            return set()
        med = statistics.median(durations.values())
        evict = set()
        for n, d in durations.items():
            self._hist.setdefault(n, []).append(d)
            self._hist[n] = self._hist[n][-self.window:]
            if med > 0 and d > self.ratio * med:
                self._strikes[n] = self._strikes.get(n, 0) + 1
            else:
                self._strikes[n] = 0
            if self._strikes.get(n, 0) >= self.patience:
                evict.add(n)
        return evict

    def summary(self) -> Dict[str, float]:
        return {n: statistics.median(h) for n, h in self._hist.items() if h}


@dataclass
class RecoveryPolicy:
    """What to do when nodes fail: restart-in-place if spares exist,
    otherwise shrink the data axis to the largest feasible mesh."""
    data_axis: int
    model_axis: int
    spares: int = 0

    def plan(self, n_failed: int) -> dict:
        if n_failed == 0:
            return {"action": "none"}
        if n_failed <= self.spares:
            return {"action": "replace", "use_spares": n_failed}
        # shrink: drop whole data rows (model groups must stay intact)
        lost_rows = -(-n_failed // self.model_axis)  # ceil
        new_data = self.data_axis - lost_rows
        if new_data < 1:
            return {"action": "abort"}
        return {"action": "shrink", "new_data_axis": new_data,
                "note": "restore from checkpoint with elastic resharding"}
