"""Swallow's contributions (C1-C10, see DESIGN.md §1) as composable modules.

  principles     — §II-A scale-free property checks
  ratio          — §II-B/V-D e/c & E/C methodology (Tab. III)
  topology       — §V-A 2.5-D lattice + dimension-ordered routing
  network        — §V-B/C packet vs circuit link model
  energy         — §VI-VII energy transparency & proportionality
  memory_server  — §III-A/X-B nodes-as-storage, address%n striping
  overlays       — §III-B overlays -> remat/weight-streaming planner
  paradigms      — §III farmer-worker / streaming pipelines
  nos            — §VIII nOS: cost-aware multi-tenant mesh-slice scheduler
  costs          — §II-B+§V+§VI composed: the unified cost engine
                   (estimate(config, layout, mode)) behind --layout auto,
                   nOS admission and benchmarks/cost_sweep.py

The serving-side composition of these pieces (paged KV over the striped
store, priced continuous batching) lives in ``repro_torch.serving``; see
docs/SERVING.md and docs/ARCHITECTURE.md for the layer map.
"""
