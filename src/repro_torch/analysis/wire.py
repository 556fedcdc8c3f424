"""Collective wire bytes of a step from the collectives it called.

Reference: ``repro/analysis/hlo.py``.  The reference parses the compiled
HLO text of a jitted step: it has no other record of the collectives
GSPMD and ``shard_map`` put in, and it must multiply every collective of
a while body by the loop's ``known_trip_count``.  The port has no HLO:
its steps run eagerly on one controller, and every collective call
appends one :class:`~repro_torch.parallel.collectives.Event` to
``collectives.EVENTS`` each time it runs (a scanned layer's once a
cycle, a remat's recompute again), so there is no text to parse and no
loop to multiply.  This module keeps the reference's wire model and its
summary's keys.

Wire-byte model (ring algorithms, g = replica-group size), per device of
the group:
  all-gather        (g-1)/g * output_bytes
  reduce-scatter    (g-1)/g * input_bytes
  all-reduce        2(g-1)/g * input_bytes
  all-to-all        (g-1)/g * input_bytes
  collective-permute  input_bytes

The port's all-gather, reduce-scatter and all-reduce (a reduce on the
group's first position and a broadcast back) move these bytes exactly,
summed over the group, and a point-to-point transfer (a
``collective-permute`` of one sender) moves its operand: so
``total_wire_bytes_per_device`` times the positions is the sum of
``collectives.WIRE``.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Sequence

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "collective-broadcast")


@dataclass
class Collective:
    op: str
    result_bytes: int
    operand_bytes: int
    group_size: int

    def wire_bytes(self) -> float:
        g = max(self.group_size, 1)
        f = (g - 1) / g
        if self.op == "all-gather":
            return f * self.result_bytes
        if self.op == "reduce-scatter":
            return f * self.operand_bytes
        if self.op == "all-reduce":
            return 2 * f * self.operand_bytes
        if self.op == "all-to-all":
            return f * self.operand_bytes
        if self.op in ("collective-permute", "collective-broadcast"):
            return float(self.operand_bytes)
        return 0.0


def collective_summary(events: Iterable, n_positions: int,
                       weights: Optional[Sequence[float]] = None) -> dict:
    """The reference's ``collective_summary`` of a run's ``events``
    (``collectives.EVENTS``) on a mesh of ``n_positions``: each event's
    ring-model bytes on each of its ``group_size`` positions, averaged
    over the mesh's positions.  ``op_counts`` counts the calls on the
    whole mesh (a model-axis collective once for each data group).
    ``weights`` counts each event that many times (the dry run's
    extrapolations)."""
    per_op: Dict[str, float] = defaultdict(float)
    raw_operand: Dict[str, float] = defaultdict(float)
    count: Dict[str, float] = defaultdict(float)
    events = list(events)
    for e, w in zip(events, weights or [1] * len(events)):
        c = Collective(e.op, e.result_bytes, e.operand_bytes, e.group_size)
        share = w * c.group_size / n_positions
        per_op[c.op] += share * c.wire_bytes()
        raw_operand[c.op] += share * max(c.operand_bytes, c.result_bytes)
        count[c.op] += w
    return {
        "wire_bytes_per_device": dict(per_op),
        "operand_bytes_per_device": dict(raw_operand),
        "op_counts": {op: int(round(n)) for op, n in count.items()},
        "total_wire_bytes_per_device": float(sum(per_op.values())),
        "total_operand_bytes_per_device": float(sum(raw_operand.values())),
    }
