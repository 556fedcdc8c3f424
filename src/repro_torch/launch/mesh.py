"""Device meshes of the port, and the reference's hardware constants.

Reference: ``repro/launch/mesh.py``.  The reference is one controller
driving a ``jax.sharding.Mesh``; the port's :class:`DeviceMesh` is the
same: one process holds a torch device per mesh position, and code that
runs "on" a mesh axis launches its work on the devices along it.  A mesh
may name one card several times (``make_test_mesh`` spreads its positions
round-robin over the visible cards, or over the CPU), the counterpart of
the reference's forced host-platform device count.

The constants are the reference package's TPU v5e-class per-chip numbers,
copied so that the port's scheduler prices admission exactly as the
reference does.  They describe that TPU model, not the GPU the port runs
on, and are used only by the cost engine (``core/costs.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch


@dataclass(frozen=True)
class DeviceMesh:
    """``axis_names`` in order, ``shape`` (axis -> extent, as a jax mesh's
    ``shape``) and one torch device per position, row-major (the last
    axis fastest)."""
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    devices: Tuple[torch.device, ...]

    def axis_devices(self, axis: str) -> Tuple[torch.device, ...]:
        """The devices along ``axis`` at index 0 of every other axis (the
        other axes replicate what lives on this one)."""
        stride = 1
        for name in reversed(self.axis_names):
            if name == axis:
                break
            stride *= self.shape[name]
        return tuple(self.devices[i * stride]
                     for i in range(self.shape[axis]))

    @property
    def distinct_devices(self) -> int:
        return len(set(self.devices))


def make_test_mesh(data: int = 2, model: int = 4, pod: int = 1,
                   devices=None) -> DeviceMesh:
    """A ``(data, model)`` mesh (``(pod, data, model)`` when ``pod > 1``)
    whose positions go round-robin over ``devices``: by default the
    visible CUDA cards (none visible raises), ``"cpu"`` for the CPU, or a
    list of devices."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("make_test_mesh: no CUDA card is visible; "
                               "pass devices='cpu' for a CPU mesh")
        pool = [torch.device("cuda", i) for i in range(n)]
    elif isinstance(devices, (str, torch.device)):
        pool = [torch.device(devices)]
    else:
        pool = [torch.device(d) for d in devices]
    names = ("pod", "data", "model") if pod > 1 else ("data", "model")
    extents = (pod, data, model) if pod > 1 else (data, model)
    n_pos = pod * data * model
    return DeviceMesh(names, dict(zip(names, extents)),
                      tuple(pool[i % len(pool)] for i in range(n_pos)))


# Hardware constants for the roofline (TPU v5e-class chip).
PEAK_FLOPS_BF16 = 197e12      # per chip
HBM_BW = 819e9                # bytes/s per chip
ICI_BW = 50e9                 # bytes/s per link (~usable)
