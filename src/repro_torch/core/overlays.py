"""Swallow §III-B: code overlays -> weight streaming & rematerialization.

The paper's overlays swap code regions through a node's 64 kB store at
run time (Fig. 4), and the paper *recommends against* them because the
interrupt-driven loads destroy timing predictability.  The pod-scale
analogues are (a) layer-weight streaming (gathering a layer's shards
just-in-time inside the scan) and (b) activation rematerialization —
both trade predictable extra traffic/compute for memory, and unlike
Swallow's interrupts both are *statically scheduled* by XLA, so the
paper's objection dissolves: the trade becomes analyzable.

``OverlayPlan`` quantifies that trade for a config so the decision is a
printed number, not folklore: extra HLO FLOPs (remat recompute) and
extra wire bytes (per-layer gathers) vs HBM bytes saved.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.analysis import flops as flops_mod
from repro_torch.configs.base import ModelConfig, ShapeConfig


# --- paper's overlay table (Fig. 4) as executable ground truth -------------
def overlay_map(linked_kwords: int = 16, region=(0x1000, 0x2FFF),
                overlay_kwords: int = 4):
    """Reproduce Fig. 4: linked addresses -> (overlay id, runtime addr)."""
    entries = []
    lo, hi = region
    n_overlays = (hi - lo + 1) // (overlay_kwords * 1024)
    for i in range(linked_kwords // overlay_kwords):
        start = i * overlay_kwords * 1024
        end = start + overlay_kwords * 1024 - 1
        if start < lo or end > hi:
            entries.append({"linked": (start, end), "overlay": None,
                            "runtime": (start if start < lo else
                                        start - (hi + 1 - lo - overlay_kwords
                                                 * 1024), end)})
        else:
            oid = (start - lo) // (overlay_kwords * 1024)
            entries.append({"linked": (start, end), "overlay": oid,
                            "runtime": (lo, lo + overlay_kwords * 1024 - 1)})
    resident = linked_kwords - (n_overlays - 1) * overlay_kwords
    return {"entries": entries, "n_overlays": n_overlays,
            "resident_kwords": resident}


@dataclass
class OverlayPlan:
    remat: bool
    stream_weights: bool
    extra_flops: float          # recompute
    extra_wire_bytes: float     # per-layer gathers
    hbm_bytes_saved: float
    recommended: bool

    def summary(self) -> str:
        return (f"remat={self.remat} stream={self.stream_weights} "
                f"extra_flops={self.extra_flops:.3e} "
                f"extra_wire={self.extra_wire_bytes:.3e}B "
                f"saved={self.hbm_bytes_saved:.3e}B "
                f"recommended={self.recommended}")


def plan(cfg: ModelConfig, shape: ShapeConfig, n_chips: int,
         hbm_per_chip: float = 16e9, tp: int = 16) -> OverlayPlan:
    """Decide remat/streaming the way the paper decides overlays: from the
    store budget, then price the cost."""
    cost = flops_mod.step_costs(cfg, shape, n_chips, tp=tp)
    tokens = shape.global_batch * shape.seq_len
    act_dtype = 2
    # full activation stash without remat (every layer, every sublayer)
    stash = flops_mod.activation_stream_bytes(cfg, float(tokens)) / n_chips
    fits_without_remat = stash + flops_mod.param_bytes(cfg) / tp \
        < hbm_per_chip * 0.8
    remat = not fits_without_remat
    extra_flops = cost.flops_fwd if remat else 0.0
    # weight streaming (FSDP gathers) applies to MoE expert tables only
    stream = cfg.moe is not None
    extra_wire = flops_mod.param_bytes(cfg) / tp * (1 if stream else 0)
    saved = stash if remat else 0.0
    return OverlayPlan(remat=remat, stream_weights=stream,
                       extra_flops=extra_flops, extra_wire_bytes=extra_wire,
                       hbm_bytes_saved=saved,
                       recommended=remat or stream)
