"""Unified interconnect-aware cost engine (Swallow §II-B + §V + §VI, composed).

The paper's thesis is that scalability comes from pricing communication
honestly: the §V link model (circuit vs packet), the §II-B e/c-E/C
ratio methodology, and the §VI energy accounting only matter when they
*drive placement decisions*.  This module composes the three existing
analytic models into one API:

    estimate(config, layout, mode) -> CostEstimate

  * compute + HBM side  — ``analysis/flops.step_costs`` (HLO-equivalent
    FLOPs, per-chip HBM traffic, GSPMD padding waste at the layout's TP
    degree);
  * interconnect side   — ``core/network.ring_collective_time`` prices
    every collective the layout implies, under the paper's circuit
    (persistent, compiler-scheduled) or packet (per-step setup) model;
  * energy side         — ``core/energy.step_energy`` converts the
    resulting counters into the Fig. 8 three-way split.

Consumers:
  * ``parallel/sharding.autotune_layout`` — enumerates candidate
    (data, model) factorizations and picks the fastest (the §II-B
    "choose the balanced design point" loop, automated);
  * ``core/nos.NOS`` — prices candidate placements at admission and
    accounts per-job energy (§VIII nOS energy optimisation);
  * ``launch/train.py`` / ``launch/serve.py`` ``--layout auto`` and
    ``benchmarks/cost_sweep.py`` (Fig. 8/9-style tables).

Everything here is pure host-side arithmetic — no devices touched — so
the scheduler and the autotuner stay unit-testable on a laptop.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.flops import CellCost, param_bytes, step_costs
from repro_torch.configs.base import ModelConfig, ShapeConfig, SHAPES
from repro_torch.core.energy import StepEnergy, step_energy
from repro_torch.core.network import LinkSpec, ring_collective_time
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16

ACT_BYTES = 2.0  # bf16 activations on the wire


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Layout:
    """A (data x model) mesh factorization — the unit the engine prices.

    ``data`` is the batch/FSDP axis (paper: farmer-worker rows), ``model``
    the tensor-parallel axis (paper: the high-bandwidth dimension that
    nOS never splits between tenants).
    """
    data: int = 1
    model: int = 1
    pod: int = 1

    @property
    def n_chips(self) -> int:
        return self.pod * self.data * self.model

    def __str__(self) -> str:
        if self.pod > 1:
            return f"{self.pod}x{self.data}x{self.model} (pod x data x model)"
        return f"{self.data}x{self.model} (data x model)"


def candidate_layouts(n_chips: int, max_model: Optional[int] = None
                      ) -> List[Layout]:
    """All (data, model) factorizations of ``n_chips``, smallest TP first."""
    out = []
    for m in range(1, n_chips + 1):
        if n_chips % m:
            continue
        if max_model is not None and m > max_model:
            continue
        out.append(Layout(data=n_chips // m, model=m))
    return out


# ---------------------------------------------------------------------------
# Collective traffic implied by a layout
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class CommEvent:
    """One collective in the per-step schedule."""
    name: str
    kind: str                 # all_gather | reduce_scatter | all_reduce | all_to_all
    group: int                # participating devices (ring size)
    bytes_per_device: float   # input bytes each device contributes
    count: int = 1            # occurrences per step

    def wire_bytes_per_device(self) -> float:
        """Bytes each device actually pushes onto its links (ring model)."""
        if self.group <= 1:
            return 0.0
        factor = 2.0 if self.kind == "all_reduce" else 1.0
        return self.count * factor * self.bytes_per_device \
            * (self.group - 1) / self.group


def comm_events(cfg: ModelConfig, shape: ShapeConfig,
                layout: Layout) -> List[CommEvent]:
    """The collective schedule one step executes under ``layout``.

    Megatron-style accounting: every mixer and FFN sublayer ends in one
    all-reduce over the model axis; training re-runs the forward
    collectives in the backward pass (and once more under remat).  MoE
    layers add dispatch/combine all-to-alls.  Training adds a ZeRO-1
    gradient reduce-scatter + parameter all-gather over the data axis,
    on each device's TP shard of the parameters.
    """
    D = layout.data * layout.pod
    M = layout.model
    mode = shape.kind
    B, S = shape.global_batch, shape.seq_len
    tokens = float(B) * (1 if mode == "decode" else S)
    t_local = tokens / D
    passes = (3 if cfg.remat else 2) if mode == "train" else 1

    events: List[CommEvent] = []
    if M > 1:
        per = t_local * cfg.d_model * ACT_BYTES
        events.append(CommEvent("tp_sublayer_allreduce", "all_reduce", M,
                                per, count=2 * cfg.n_layers * passes))
        if cfg.moe is not None:
            n_moe = cfg.n_layers - cfg.first_k_dense
            slots = t_local * cfg.moe.top_k * cfg.moe.capacity_factor
            events.append(CommEvent(
                "moe_dispatch_combine", "all_to_all", M,
                slots * cfg.d_model * ACT_BYTES,
                count=2 * n_moe * passes))
    if mode == "train" and D > 1:
        shard = param_bytes(cfg) / M
        events.append(CommEvent("grad_reduce_scatter", "reduce_scatter",
                                D, shard))
        events.append(CommEvent("param_all_gather", "all_gather", D, shard))
    return events


def serving_comm_events(cfg: ModelConfig, layout: Layout, *,
                        n_tokens: int, n_merges: int = 1
                        ) -> List[CommEvent]:
    """The extra collectives paged-KV serving adds on top of
    :func:`comm_events` when the page pools are striped over the model
    axis (paper §V applied to §III-A's ``address % n`` store).

    * ``kv_stripe_write`` — every decoded/prefilled token appends one KV
      entry to the page owning its slot; under uniform page placement
      ``(M-1)/M`` of those writes leave the producing node, exactly the
      paper's remote-fraction model.  Modelled as an all-to-all of the
      per-token KV bytes (``2 * n_kv_heads * head_dim * n_layers`` bf16
      words for K and V) so ``wire_bytes_per_device`` carries the
      (M-1)/M factor.
    * ``decode_stats_merge`` — the sharded paged-attention kernel merges
      per-stripe online-softmax partials ``(m, l, acc)`` with an
      all-reduce over the model axis, once per decode dispatch
      (``n_merges``) per layer.
    """
    M = layout.model
    if M <= 1:
        return []
    kv_bytes_per_token = 2.0 * cfg.kv_dim * cfg.n_layers * ACT_BYTES
    stats_bytes = (float(n_tokens) * cfg.n_kv_heads
                   * (cfg.n_heads // cfg.n_kv_heads)
                   * (cfg.head_dim + 2) * 4.0)  # f32 acc + m + l
    return [
        CommEvent("kv_stripe_write", "all_to_all", M,
                  float(n_tokens) * kv_bytes_per_token),
        CommEvent("decode_stats_merge", "all_reduce", M, stats_bytes,
                  count=n_merges * cfg.n_layers),
    ]


def serving_comm_cost(cfg: ModelConfig, layout: Layout,
                      mode: str = "circuit", *, n_tokens: int,
                      n_merges: int = 1, link: LinkSpec = LinkSpec()
                      ) -> Tuple[float, float]:
    """(seconds, wire bytes per device) the serving collectives add under
    ``layout`` — the §V link model priced on the stripe traffic."""
    secs = 0.0
    wire = 0.0
    for ev in serving_comm_events(cfg, layout, n_tokens=n_tokens,
                                  n_merges=n_merges):
        secs += ev.count * ring_collective_time(
            ev.bytes_per_device, ev.group, kind=ev.kind, link=link,
            mode=mode)
        wire += ev.wire_bytes_per_device()
    return secs, wire


# ---------------------------------------------------------------------------
# The estimate
# ---------------------------------------------------------------------------
@dataclass
class CostEstimate:
    """What one step costs under a layout — time, traffic and energy."""
    layout: Layout
    shape: ShapeConfig
    mode: str                       # circuit | packet
    step_time_s: float
    compute_s: float
    hbm_s: float
    ici_s: float
    flops_per_chip: float
    hbm_bytes_per_chip: float
    ici_bytes_per_chip: float
    energy: StepEnergy
    cell: CellCost
    events: Tuple[CommEvent, ...] = ()
    breakdown: Dict[str, float] = field(default_factory=dict)

    @property
    def tokens_per_s(self) -> float:
        t = self.shape.global_batch * (
            1 if self.shape.kind == "decode" else self.shape.seq_len)
        return t / max(self.step_time_s, 1e-12)

    def edp(self) -> float:
        """Energy-delay product of one step across the whole slice —
        the §VIII nOS objective (fast AND proportional)."""
        return self.step_time_s * self.energy.total_j * self.layout.n_chips

    def describe(self) -> str:
        e = self.energy
        return (f"layout {self.layout}: step {self.step_time_s * 1e3:.3f} ms "
                f"(compute {self.compute_s * 1e3:.3f}, hbm "
                f"{self.hbm_s * 1e3:.3f}, ici {self.ici_s * 1e3:.3f}) "
                f"{e.w_per_chip:.0f} W/chip")


def estimate(config: ModelConfig, layout: Layout, mode: str = "circuit",
             shape: Optional[ShapeConfig] = None,
             link: LinkSpec = LinkSpec()) -> CostEstimate:
    """Price one step of ``config`` at ``shape`` under ``layout``.

    ``mode`` selects the §V link model: "circuit" (persistent ring
    collectives, zero per-step setup) or "packet" (per-step schedule
    setup + per-hop routing overhead).
    """
    if mode not in ("circuit", "packet"):
        raise ValueError(f"mode must be circuit|packet, got {mode!r}")
    shape = shape or SHAPES["train_4k"]
    n = layout.n_chips
    cell = step_costs(config, shape, n, tp=layout.model)
    compute_s = cell.flops_total / (n * PEAK_FLOPS_BF16)
    hbm_s = cell.hbm_bytes_per_chip / HBM_BW

    events = comm_events(config, shape, layout)
    ici_s = 0.0
    ici_bytes = 0.0
    for ev in events:
        ici_s += ev.count * ring_collective_time(
            ev.bytes_per_device, ev.group, kind=ev.kind, link=link, mode=mode)
        ici_bytes += ev.wire_bytes_per_device()

    # compute and HBM streams overlap (roofline max); collectives are
    # exposed — the pessimistic end of what GSPMD achieves, and exactly
    # the quantity the circuit/packet gap acts on.
    step = max(compute_s, hbm_s) + ici_s
    energy = step_energy(
        flops_per_chip=cell.flops_total / n,
        hbm_bytes_per_chip=cell.hbm_bytes_per_chip,
        ici_bytes_per_chip=ici_bytes,
        step_seconds=step)
    return CostEstimate(
        layout=layout, shape=shape, mode=mode, step_time_s=step,
        compute_s=compute_s, hbm_s=hbm_s, ici_s=ici_s,
        flops_per_chip=cell.flops_total / n,
        hbm_bytes_per_chip=cell.hbm_bytes_per_chip,
        ici_bytes_per_chip=ici_bytes, energy=energy, cell=cell,
        events=tuple(events),
        breakdown={"compute_s": compute_s, "hbm_s": hbm_s, "ici_s": ici_s})


def rank_layouts(config: ModelConfig, shape: Optional[ShapeConfig] = None,
                 n_chips: int = 1, mode: str = "circuit",
                 link: LinkSpec = LinkSpec(),
                 max_model: Optional[int] = None) -> List[CostEstimate]:
    """Estimates for every feasible factorization of ``n_chips``, fastest
    first.  Layouts whose data degree does not divide the global batch
    are excluded (the batch is sharded over that axis), unless no
    candidate survives the filter."""
    lays = candidate_layouts(n_chips, max_model)
    if shape is not None:
        B = shape.global_batch
        feasible = [l for l in lays if B % (l.data * l.pod) == 0]
        lays = feasible or lays
    ests = [estimate(config, lay, mode, shape, link) for lay in lays]
    ests.sort(key=lambda e: e.step_time_s)
    return ests


def rank_serving_layouts(config: ModelConfig,
                         shape: Optional[ShapeConfig] = None,
                         n_chips: int = 1, mode: str = "circuit",
                         link: LinkSpec = LinkSpec(),
                         max_model: Optional[int] = None
                         ) -> List[CostEstimate]:
    """:func:`rank_layouts` with the paged-serving stripe traffic priced
    in (``serving_comm_events``): each estimate's ``step_time_s`` and
    ``ici_s`` gain the per-decode-step KV stripe write + partials merge,
    recorded under ``breakdown["serving_comm_s"]``, then the candidates
    are re-sorted.  ``--layout auto`` on the paged engine ranks with
    this so the §V link model arbitrates serving placement too."""
    ests = rank_layouts(config, shape, n_chips, mode, link, max_model)
    for est in ests:
        n_tokens = est.shape.global_batch  # one token/sequence/decode step
        secs, wire = serving_comm_cost(
            config, est.layout, mode, n_tokens=n_tokens, n_merges=1,
            link=link)
        est.step_time_s += secs
        est.ici_s += secs
        est.ici_bytes_per_chip += wire
        est.breakdown["serving_comm_s"] = secs
        est.events = est.events + tuple(serving_comm_events(
            config, est.layout, n_tokens=n_tokens, n_merges=1))
    ests.sort(key=lambda e: e.step_time_s)
    return ests
