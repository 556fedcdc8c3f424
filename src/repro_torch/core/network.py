"""Swallow §V-B/C: link model — packet vs circuit switching, aggregation.

Paper ground truth:
  token = 8 bits as 2-bit symbols; transmit time 3*Ts + Tt switch cycles;
  fastest (Ts=2, Tt=1) -> 500 Mbit/s per internal link @500 MHz, external
  links 4x slower (125 Mbit/s).  Packetized transfer adds a 3-byte route
  header + control token -> ~435 Mbit/s effective; circuit switching holds
  links open and reaches the full 500 Mbit/s.
  Latencies: core-local 50 ns (~6 instr), intra-package 32-bit word =
  40 instr, package-to-package 360 ns (45 instr).

TPU adaptation: "packet" = on-demand GSPMD resharding (header/setup ==
fresh collective schedule + latency-bound small transfers); "circuit" =
persistent compiler-scheduled ring collectives (links held by the
program; zero per-step setup).  ``CollectiveCost`` prices a collective on
either model so benchmarks can show the circuit/packet gap the paper
measures (500 vs 435 Mbit/s -> here: bandwidth-bound vs latency-bound).
"""
from __future__ import annotations

from dataclasses import dataclass

# --- paper link model --------------------------------------------------------
SWITCH_HZ = 500e6


def token_time_s(ts: int = 2, tt: int = 1, hz: float = SWITCH_HZ) -> float:
    """8-bit token transmit time = (3*Ts + Tt) + 1 switch cycles.

    The +1 sync cycle reconciles the formula with the paper's quoted
    500 Mbit/s at (Ts=2, Tt=1, 500 MHz): 8 cycles per 8-bit token.
    """
    return (3 * ts + tt + 1) / hz


def link_rate_bps(ts: int = 2, tt: int = 1, hz: float = SWITCH_HZ) -> float:
    return 8.0 / token_time_s(ts, tt, hz)


def packet_rate_bps(payload_bytes: int, ts: int = 2, tt: int = 1,
                    hz: float = SWITCH_HZ) -> float:
    """Effective rate with 3-byte header + 1 control token per packet."""
    raw = link_rate_bps(ts, tt, hz)
    overhead = 4.0  # bytes
    return raw * payload_bytes / (payload_bytes + overhead)


SWALLOW_LATENCY = {
    "core_local_s": 50e-9,
    "intra_package_word_s": 360e-9 * 40 / 45,   # 40 instr @ 125 MIPS
    "package_to_package_word_s": 360e-9,
}


# --- TPU collective cost model ------------------------------------------------
@dataclass(frozen=True)
class LinkSpec:
    bandwidth: float = 50e9      # bytes/s per ICI link
    latency: float = 1e-6        # per hop
    setup: float = 5e-6          # "packet" mode: schedule/route setup


def ring_collective_time(bytes_per_device: float, group: int,
                         kind: str = "all_gather",
                         link: LinkSpec = LinkSpec(),
                         mode: str = "circuit") -> float:
    """Ring AG/RS/AR time under the circuit (persistent) or packet
    (per-step setup) model."""
    if group <= 1:
        return 0.0
    steps = group - 1
    factor = {"all_gather": 1.0, "reduce_scatter": 1.0, "all_reduce": 2.0,
              "all_to_all": 1.0}[kind]
    wire = factor * bytes_per_device * (group - 1) / group
    t = wire / link.bandwidth + steps * link.latency * factor
    if mode == "packet":
        t += link.setup + steps * link.latency  # route setup per step
    return t


def crossover_bytes(group: int, link: LinkSpec = LinkSpec()) -> float:
    """Message size above which circuit vs packet mode stops mattering
    (<5% difference) — the TPU version of the paper's 435/500 analysis."""
    steps = group - 1
    extra = link.setup + steps * link.latency
    # want extra <= 0.05 * wire/bw  ->  wire >= 20 * extra * bw
    return 20.0 * extra * link.bandwidth * group / max(group - 1, 1)
