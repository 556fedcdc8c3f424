"""Three-term roofline of a dry-run cell (Swallow Eqn. 1 at pod scale).

Reference: ``repro/analysis/roofline.py``, whose formulas these are:

    compute    = HLO_FLOPs / (chips * peak)
    memory     = HBM_bytes_per_chip / HBM_bw
    collective = wire_bytes_per_device / link_bw

with HLO_FLOPs, HBM bytes and MODEL_FLOPS from the analytic cost model
(``analysis/flops.step_costs``) and the wire bytes from the collectives
the port's step called (``analysis/wire.collective_summary``).  The
reference prices a TPU v5e-class chip; here the constants are a
:class:`Hardware` record, by default :data:`H100`, and the record a
cell gets names them (``Roofline.hardware``).
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, Optional

from repro_torch.analysis import flops as flops_mod
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16


@dataclass(frozen=True)
class Hardware:
    """One device's peak dense bf16 FLOP/s, HBM bytes/s, the bytes/s of
    its links in one direction, and its memory in bytes (None where
    the source gives none)."""
    name: str
    peak_flops_bf16: float
    hbm_bw: float
    link_bw: float
    memory_bytes: Optional[float] = None


# NVIDIA H100 Tensor Core GPU data sheet, SXM5 column: 989 TFLOP/s dense
# BF16 (1,979 is with sparsity), 3.35 TB/s HBM3, 80 GB, NVLink 4 at 900
# GB/s both directions together (450 GB/s each way)
H100 = Hardware("NVIDIA H100 80GB HBM3, 700 W", 989e12, 3.35e12, 450e9,
                80e9)
# the reference's constants (``launch/mesh.py``), kept so that the
# formulas can be held against the reference's; nothing the port prints
# is priced with them
REFERENCE_TPU = Hardware("reference TPU v5e-class chip", PEAK_FLOPS_BF16,
                         HBM_BW, ICI_BW)


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    # terms (seconds)
    t_compute: float
    t_memory: float
    t_collective: float
    dominant: str
    # counters
    hlo_flops_global: float
    hlo_flops_raw_costanalysis: Optional[float]
    hbm_bytes_per_chip: float
    wire_bytes_per_device: float
    model_flops: float
    useful_ratio: float            # MODEL_FLOPS / HLO_FLOPs
    roofline_fraction: float       # t_model / max(term) — the score
    step_time_bound: float         # max of the three terms
    collective_detail: Dict[str, float]
    hardware: str                  # the Hardware record's name

    def to_dict(self):
        return asdict(self)


def analyze(cfg: ModelConfig, shape: ShapeConfig, mesh_name: str,
            n_chips: int, tp: int, collectives: Optional[dict] = None,
            cost_analysis: Optional[dict] = None, memory_analysis=None,
            hw: Hardware = H100) -> Roofline:
    """The reference's ``analyze`` with ``collectives`` (a
    ``wire.collective_summary``) in place of the HLO text, on ``hw``."""
    cost = flops_mod.step_costs(cfg, shape, n_chips, tp=tp)

    wire = 0.0
    detail: Dict[str, float] = {}
    if collectives is not None:
        wire = collectives["total_wire_bytes_per_device"]
        detail = dict(collectives["wire_bytes_per_device"])
        detail["op_counts"] = collectives["op_counts"]

    t_compute = cost.flops_total / (n_chips * hw.peak_flops_bf16)
    t_memory = cost.hbm_bytes_per_chip / hw.hbm_bw
    t_collective = wire / hw.link_bw
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_collective}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    t_model = cost.model_flops / (n_chips * hw.peak_flops_bf16)

    raw = None
    if cost_analysis:
        raw = float(cost_analysis.get("flops", 0.0))

    return Roofline(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, chips=n_chips,
        t_compute=t_compute, t_memory=t_memory, t_collective=t_collective,
        dominant=dominant,
        hlo_flops_global=cost.flops_total,
        hlo_flops_raw_costanalysis=raw,
        hbm_bytes_per_chip=cost.hbm_bytes_per_chip,
        wire_bytes_per_device=wire,
        model_flops=cost.model_flops,
        useful_ratio=cost.model_flops / max(cost.flops_total, 1.0),
        roofline_fraction=t_model / max(bound, 1e-12),
        step_time_bound=bound,
        collective_detail=detail,
        hardware=hw.name)


def format_table(rows) -> str:
    hdr = (f"{'arch':<18} {'shape':<12} {'mesh':<7} "
           f"{'t_comp(s)':>10} {'t_mem(s)':>10} {'t_coll(s)':>10} "
           f"{'bound':>10} {'dom':>6} {'useful':>7} {'roofline':>9}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r.arch:<18} {r.shape:<12} {r.mesh:<7} "
            f"{r.t_compute:>10.4f} {r.t_memory:>10.4f} "
            f"{r.t_collective:>10.4f} {r.step_time_bound:>10.4f} "
            f"{r.dominant:>6.6s} {r.useful_ratio:>7.3f} "
            f"{r.roofline_fraction:>9.3f}")
    return "\n".join(lines)
