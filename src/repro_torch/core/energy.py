"""Swallow §VI-VII: energy transparency & proportionality, at both scales.

Paper ground truth (reproduced for validation + benchmarks):
  Eqn. 3   P/core = (46 + 0.30 f) mW       (f in MHz; static 46 mW)
  Tab. II  per-bit link energies: on-die 1.63 pJ, on-board ~101-106 pJ,
           off-board 30 cm FFC 5440 pJ
  Fig. 10  DVFS: P = C V^2 f with Vmin(71 MHz) = 0.6 V, Vmin(500) = 0.95 V
  §VII-A   480 cores: 193 mW/core active, 134 W system, ~26% conversion
           losses, 30% compute, 40% static/dynamic waste, 4% network

TPU adaptation: the same three-way split (static + dynamic-compute +
communication) is modelled per chip with public v5e-class constants, and
``step_energy`` prices a dry-run cell from its roofline counters — the
paper's "program that can measure its own power" becomes a step function
that can *account* its own energy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

# --- paper constants --------------------------------------------------------
SWALLOW_STATIC_MW = 46.0
SWALLOW_DYN_MW_PER_MHZ = 0.30
SWALLOW_ACTIVE_MW_500 = 193.0
SWALLOW_IDLE_MW_500 = 113.0  # 500 MHz all-idle (Fig. 9)
SWALLOW_LINK_PJ_PER_BIT = {
    "on_die": 1.63, "on_board_v": 106.0, "on_board_h": 101.0,
    "off_board_ffc": 5440.0}
SWALLOW_VMIN = {71.0: 0.60, 500.0: 0.95}


def swallow_core_power_mw(f_mhz: float) -> float:
    """Eqn. 3. Validates against 193 mW @ 500 MHz (within ~1 mW)."""
    return SWALLOW_STATIC_MW + SWALLOW_DYN_MW_PER_MHZ * f_mhz


def swallow_vdd(f_mhz: float) -> float:
    """Linear Vmin(f) interpolation between the paper's measured points."""
    f0, f1 = 71.0, 500.0
    v0, v1 = SWALLOW_VMIN[f0], SWALLOW_VMIN[f1]
    t = (f_mhz - f0) / (f1 - f0)
    return v0 + t * (v1 - v0)


def swallow_dvfs_power_mw(f_mhz: float) -> float:
    """Fig. 10: P = CV^2 f, normalized to Eqn. 3 dynamic power at 500 MHz
    (voltage scaling stacked on frequency scaling)."""
    v = swallow_vdd(f_mhz)
    v500 = SWALLOW_VMIN[500.0]
    dyn500 = SWALLOW_DYN_MW_PER_MHZ * 500.0
    dyn = dyn500 * (v / v500) ** 2 * (f_mhz / 500.0)
    return SWALLOW_STATIC_MW * (v / v500) ** 2 + dyn


# --- TPU v5e-class analytical model -----------------------------------------
# Public-ballpark constants; what matters for the methodology is the split.
TPU_TDP_W = 200.0                  # chip + HBM envelope
TPU_STATIC_W = 60.0                # idle/static share
TPU_PJ_PER_FLOP_BF16 = 0.55e-12 * 1e12  # ~0.55 pJ/flop dynamic -> J/flop
TPU_PJ_PER_FLOP = 0.55e-12
TPU_HBM_PJ_PER_BYTE = 6.0e-12      # HBM2e access energy
TPU_ICI_PJ_PER_BYTE = 10.0e-12     # intra-pod link
TPU_DCN_PJ_PER_BYTE = 60.0e-12     # pod-to-pod (optical + NIC)


@dataclass
class StepEnergy:
    compute_j: float
    hbm_j: float
    ici_j: float
    static_j: float
    total_j: float
    w_per_chip: float
    breakdown: Dict[str, float]


def step_energy(*, flops_per_chip: float, hbm_bytes_per_chip: float,
                ici_bytes_per_chip: float, step_seconds: float,
                dcn_bytes_per_chip: float = 0.0) -> StepEnergy:
    """Energy of one step on one chip (the Fig. 8 split, TPU constants)."""
    compute = flops_per_chip * TPU_PJ_PER_FLOP
    hbm = hbm_bytes_per_chip * TPU_HBM_PJ_PER_BYTE
    ici = ici_bytes_per_chip * TPU_ICI_PJ_PER_BYTE \
        + dcn_bytes_per_chip * TPU_DCN_PJ_PER_BYTE
    static = TPU_STATIC_W * step_seconds
    total = compute + hbm + ici + static
    return StepEnergy(
        compute_j=compute, hbm_j=hbm, ici_j=ici, static_j=static,
        total_j=total, w_per_chip=total / max(step_seconds, 1e-12),
        breakdown={
            "compute_frac": compute / total, "hbm_frac": hbm / total,
            "network_frac": ici / total, "static_frac": static / total})


def energy_proportionality(load: float, *, f_max_mhz: float = 500.0,
                           model: str = "swallow") -> float:
    """Power at fractional load under frequency scaling (Fig. 9 analogue).

    load in [0,1] maps linearly to f in [71, 500] MHz for the Swallow
    model; the TPU model scales the dynamic share linearly with load.
    """
    if model == "swallow":
        f = 71.0 + load * (f_max_mhz - 71.0)
        return swallow_core_power_mw(f)
    return TPU_STATIC_W + (TPU_TDP_W - TPU_STATIC_W) * load
