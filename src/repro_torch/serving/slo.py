"""Per-tenant SLO classes for the chunked-prefill scheduler (§VIII nOS
admission, made latency-aware).

Swallow's nOS admits work by *pricing* it against the cost engine; this
module gives the serving scheduler the other half of that contract: what
each tenant was promised.  A class bundles

* ``ttft_steps`` — the first-token deadline, measured on the scheduler's
  deterministic step clock (one decode step == one tick).  Admission is
  earliest-deadline-first over ``arrived_step + ttft_steps``; fixed
  deadlines on a monotonic clock make EDF starvation-free — a waiting
  request's deadline only gets *relatively* earlier as time passes.
* ``stall_frac`` — the tolerable prefill interference per decode window,
  as a fraction of the window's decode seconds.  A running tenant with
  ``stall_frac = 0.25`` accepts tok/s no worse than ``rate / 1.25``:
  the chunk budget for a window is ``window_s * min(stall_frac over
  running)`` seconds, priced against chunk cost via
  :func:`repro.core.costs.estimate`'s ``prefill_cost_s`` — the same
  EDP-style pricing nOS uses for placement, applied to interference.
* ``priority`` — tie-break between equal deadlines (lower = sooner).

Classes are deliberately coarse (interactive / standard / batch): the
paper's argument is that a scalable system is judged by its *tail*
behaviour under contention, and three well-separated tiers are enough to
expose whether the scheduler defends them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class SLOClass:
    name: str
    ttft_steps: int      # first-token deadline, scheduler steps after arrival
    stall_frac: float    # prefill seconds tolerated per decode-second
    priority: int        # deadline tie-break; lower admits first

    def deadline(self, arrived_step: int) -> int:
        return arrived_step + self.ttft_steps

    def tpot_target_s(self, decode_cost_s: float) -> float:
        """Per-token latency ceiling implied by ``stall_frac``: the pure
        decode cost inflated by the tolerated interference."""
        return decode_cost_s * (1.0 + self.stall_frac)


SLO_CLASSES: Dict[str, SLOClass] = {
    "interactive": SLOClass("interactive", ttft_steps=8, stall_frac=0.25,
                            priority=0),
    "standard": SLOClass("standard", ttft_steps=32, stall_frac=0.5,
                         priority=1),
    "batch": SLOClass("batch", ttft_steps=256, stall_frac=1.0, priority=2),
}

DEFAULT_SLO = "standard"


def get_slo(name: str) -> SLOClass:
    """Resolve a class name, listing the registry on a miss (mirrors the
    harness's fail-fast trace validation)."""
    try:
        return SLO_CLASSES[name]
    except KeyError:
        valid = ", ".join(sorted(SLO_CLASSES))
        raise KeyError(f"unknown SLO class {name!r}; valid: {valid}") from None
