"""Swallow §II-B / §V-D / Tab. III: communication-to-computation analysis.

    Communication performance = max(e/c, E/C)            (Eqn. 1)
    balanced  iff  e/c <= 1  and  E/C <= 1               (Eqn. 2)

where e = a node's data source/sink throughput demand, c = the node's
local communication capacity, E = aggregate demand, C = global (bisection)
capacity.  The paper evaluates Swallow at e/c = 2 and E/C in [8, 32]
(Tab. III) and compares SpiNNaker / Centip3De / Tile / Epiphany.

Here the same quantities are derived for a TPU mesh from a dry-run cell:
the per-chip injection demand is the per-device collective wire bytes per
step over the step's compute time (what the chip *wants* to push), and
capacity is the chip's ICI links.  E/C uses bisection bandwidth.  This is
the paper's methodology with the HLO as the "application".
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.launch.mesh import ICI_BW, PEAK_FLOPS_BF16

# Paper Tab. III (bits/s) — reproduced as ground truth for tests/benches.
SWALLOW_TABLE_III = {
    #              source(bps)  sink(bps)  router(bps)  e/c    E/C
    "Swallow":    dict(e=4e9,   c=2e9,     C=4.5e9, ec=2.0, EC=(8, 32)),
    "SpiNNaker":  dict(e=6.4e6, c=240e6,   C=4e9,   ec=0.03, EC=0.42),
    "Centip3De":  dict(e=246e9, c=None,    C=4.46e9, ec=None, EC=55),
    "Tile":       dict(e=96e9,  c=1.28e12, C=2.56e12, ec=0.075, EC=2.4),
    "Epiphany":   dict(e=19.2e9, c=2e9,    C=51e9,  ec=0.10, EC=6.02),
}

ICI_LINKS_PER_CHIP = 4       # v5e: 4 usable ICI links


@dataclass
class RatioReport:
    name: str
    e: float          # per-chip injection demand, bytes/s
    c: float          # per-chip link capacity, bytes/s
    E: float          # aggregate demand across the bisection, bytes/s
    C: float          # bisection capacity, bytes/s
    ec: float
    EC: float
    balanced: bool
    bound: str        # "local" | "global" | "compute"

    def perf_bound(self) -> float:
        """Eqn. 1: max(e/c, E/C); > 1 means communication-throttled."""
        return max(self.ec, self.EC)


def swallow_ec() -> RatioReport:
    """The paper's own numbers (validates our formula against Tab. III)."""
    t = SWALLOW_TABLE_III["Swallow"]
    return RatioReport("swallow-480", e=t["e"] / 8, c=t["c"] / 8,
                       E=t["e"] / 8 * 480, C=t["C"] / 8 * 480 / 16,
                       ec=t["ec"], EC=t["EC"][1],
                       balanced=False, bound="global")


def analyze_cell(name: str, wire_bytes_per_device: float,
                 compute_seconds: float, n_chips: int,
                 mesh_shape: Dict[str, int]) -> RatioReport:
    """e/c & E/C for a dry-run cell.

    e: bytes/s the chip must inject to not stall the step's compute.
    c: per-chip ICI capacity.  E: all chips' demand crossing the mesh
    bisection (approximated as half of total traffic); C: bisection links.
    Capacity is the reference's TPU v5e-class ICI (``launch/mesh.py``),
    so the ratios are the reference's, not the GPU's.
    """
    t = max(compute_seconds, 1e-9)
    e = wire_bytes_per_device / t
    c = ICI_LINKS_PER_CHIP * ICI_BW
    # bisection of a 2-D (data x model) mesh: min dimension's row links
    dims = [v for k, v in mesh_shape.items() if v > 1]
    bisect_links = (min(dims) if dims else 1) * 2  # torus wrap
    E = e * n_chips / 2.0
    C = bisect_links * ICI_BW * (n_chips ** 0.5)
    ec = e / c
    EC = E / max(C, 1e-9)
    bound = "compute"
    if ec > 1 or EC > 1:
        bound = "local" if ec >= EC else "global"
    return RatioReport(name, e=e, c=c, E=E, C=C, ec=ec, EC=EC,
                       balanced=(ec <= 1 and EC <= 1), bound=bound)


# what format_table's last line says of the capacities it priced
TPU_NOTE = ("(c and C price the reference's TPU v5e-class ICI links, "
            "not the GPU's)")


def format_table(rows) -> str:
    out = [f"{'system':<28} {'e/c':>8} {'E/C':>8} {'balanced':>9} {'bound':>8}"]
    for r in rows:
        out.append(f"{r.name:<28} {r.ec:>8.3f} {r.EC:>8.3f} "
                   f"{str(r.balanced):>9} {r.bound:>8}")
    out.append(TPU_NOTE)
    return "\n".join(out)
