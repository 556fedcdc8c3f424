"""Case study I (Swallow §X-A) on the PyTorch port: Izhikevich
spiking-network simulation.

The counterpart of ``examples/neuron_sim.py``.  Regular-spiking neurons
with 10% random connectivity; spikes are "messages" (a masked matmul
against the connectivity table: the spike vector multicast the paper
describes).  The simulation runs on an explicit device from an explicit
``torch.Generator``; its pieces (the draws, the per-neuron parameters,
the connectivity table, one step) are separate so that a caller can feed
it other draws.

Also reproduces the Fig. 11 scaling analysis: per-neuron state is ~18 B
but the 10% connectivity table costs N bits *per neuron*, so neurons per
64 kB core shrink as N grows and the processors needed grow ~N^2 — the
paper's conclusion (run many modest sims, not one huge one) falls out of
``scaling_curve``.

Run:  PYTHONPATH=src python examples/torch_neuron_sim.py [--neurons 512]
          [--steps 200] [--device cpu]
"""
import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

CORE_BYTES = 64 * 1024
STATE_BYTES = 18          # 8 B state + 10 B event buffer (paper)
CODE_STACK = 1100 + 336   # shared code + stack


def max_neurons_per_core(total_neurons: int,
                         connectivity: float = 0.10) -> int:
    """Paper's memory model: state + N-bit connectivity row per neuron."""
    table_bytes = total_neurons / 8.0
    per_neuron = STATE_BYTES + table_bytes
    avail = CORE_BYTES - CODE_STACK
    return max(int(avail // per_neuron), 0)


def scaling_curve(max_procs: int = 100_000):
    """(neurons_per_core, total_neurons) pairs — Fig. 11's red line."""
    out = []
    for n_per_core in (1, 2, 4, 8, 16, 32, 64, 128, 191):
        # solve total = procs * n_per_core with the table constraint
        # table for total neurons must fit: n_per_core*(18 + total/8) < 63k
        total = (CORE_BYTES - CODE_STACK) / n_per_core - STATE_BYTES
        total *= 8.0                       # bits -> neurons
        procs = total / n_per_core
        if procs > max_procs:
            total = max_procs * n_per_core
        out.append((n_per_core, total))
    return out


def draw_network(n_neurons, generator, device, connectivity=0.10):
    """The network's draws: per-neuron ``r`` in [0, 1), the excitatory
    mask (80% of the neurons) and the (post, pre) connection mask."""
    r = torch.rand(n_neurons, generator=generator, device=device)
    exc = torch.rand(n_neurons, generator=generator, device=device) < 0.8
    W = torch.rand((n_neurons, n_neurons), generator=generator,
                   device=device) < connectivity
    return r, exc, W


def neuron_params(r, exc):
    """Heterogeneous (a, b, c, d) of Izhikevich (2003)."""
    a = torch.where(exc, 0.02, 0.02 + 0.08 * r)
    b = torch.where(exc, 0.2, 0.25 - 0.05 * r)
    c = torch.where(exc, -65.0 + 15 * r ** 2, -65.0)
    d = torch.where(exc, 8.0 - 6 * r ** 2, 2.0)
    return a, b, c, d


def connection_table(W, exc):
    """Synaptic weights (post, pre): 0.5 from an excitatory neuron, -1
    from an inhibitory one, 0 where there is no connection."""
    return torch.where(W, torch.where(exc[None, :], 0.5, -1.0), 0.0)


def step(state, noise, Wv, params, dt=1.0):
    """One ``dt`` ms step from ``state`` = (v, u) with the thalamic input
    ``5 * noise``.  Returns ((v, u), fired): ``fired`` are the neurons at
    threshold at the start of the step, whose spikes this step delivers."""
    a, b, c, d = params
    v, u = state
    fired = v >= 30.0
    I = 5.0 * noise + Wv @ fired.to(torch.float32)   # spike multicast
    v = torch.where(fired, c, v)
    u = torch.where(fired, u + d, u)
    v = v + dt * (0.04 * v * v + 5.0 * v + 140.0 - u + I)
    v = v.clamp(max=30.0)
    u = u + dt * a * (b * v - u)
    return (v, u), fired


def initial_state(params):
    a, b, c, d = params
    v0 = torch.full_like(a, -65.0)
    return v0, b * v0


def simulate(n_neurons: int = 512, steps: int = 200, seed: int = 0,
             connectivity: float = 0.10, dt: float = 1.0, device=None,
             generator=None, keep=()):
    """Izhikevich regular-spiking network with random 10% connectivity,
    on ``device`` (default ``cuda``; with no card it raises unless
    ``device="cpu"``) from ``generator`` (default: one seeded with
    ``seed``).  ``keep`` names steps whose input (state, noise) is
    returned under ``"kept"``."""
    from repro_torch.weights import resolve_device
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    r, exc, W = draw_network(n_neurons, generator, device, connectivity)
    params = neuron_params(r, exc)
    Wv = connection_table(W, exc)
    del W
    state = initial_state(params)
    total = torch.zeros((), dtype=torch.int64, device=device)
    kept = {}
    for t in range(steps):
        noise = torch.randn(n_neurons, generator=generator, device=device)
        if t in keep:
            kept[t] = (state, noise)
        state, fired = step(state, noise, Wv, params, dt)
        total += fired.sum()
    total = int(total)
    return {"total_spikes": total,
            "rate_hz": total / n_neurons / (steps * dt / 1000.0),
            "Wv": Wv, "params": params, "kept": kept}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--neurons", type=int, default=512)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default=None,
                    help="default cuda; cpu to run on the host")
    args = ap.parse_args()

    res = simulate(args.neurons, args.steps, device=args.device)
    print(f"simulated {args.neurons} neurons x {args.steps} ms: "
          f"{res['total_spikes']} spikes ({res['rate_hz']:.1f} Hz/neuron)")

    print("\nFig. 11 scaling (64 kB cores, 10% connectivity):")
    print(f"{'neurons/core':>14} {'total neurons':>14} {'procs needed':>14}")
    for npc, total in scaling_curve():
        print(f"{npc:>14} {total:>14.0f} {total / npc:>14.0f}")
    print(f"\nmax neurons/core at N=100k: {max_neurons_per_core(100_000)}"
          f" (the paper's hard-limit regime: P ~ N^2)")


if __name__ == "__main__":
    main()
