"""Device meshes of the port, and the reference's hardware constants.

Reference: ``repro/launch/mesh.py``.  The reference is one controller
driving a ``jax.sharding.Mesh``; the port's :class:`DeviceMesh` is the
same: one process holds a torch device per mesh position, and code that
runs "on" a mesh axis launches its work on the devices along it.  A mesh
may name one card several times (``make_mesh`` spreads its positions
round-robin over the visible cards, or over the CPU), the counterpart of
the reference's forced host-platform device count.

The constants are the reference package's TPU v5e-class per-chip numbers,
copied so that the port's scheduler prices admission exactly as the
reference does.  They describe that TPU model, not the GPU the port runs
on, and are used only by the cost engine (``core/costs.py``) and the
e/c analysis (``core/ratio.py``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch


@dataclass(frozen=True)
class DeviceMesh:
    """``axis_names`` in order, ``shape`` (axis -> extent, as a jax mesh's
    ``shape``) and one torch device per position, row-major (the last
    axis fastest)."""
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    devices: Tuple[torch.device, ...]

    def _stride(self, axis: str) -> int:
        stride = 1
        for name in reversed(self.axis_names):
            if name == axis:
                return stride
            stride *= self.shape[name]
        raise KeyError(axis)

    def axis_devices(self, axis: str) -> Tuple[torch.device, ...]:
        """The devices along ``axis`` at index 0 of every other axis (the
        other axes replicate what lives on this one)."""
        return tuple(self.devices[i] for i in self.axis_groups(axis)[0])

    def axis_groups(self, axis: str) -> List[Tuple[int, ...]]:
        """The positions (indices into ``devices``) grouped along
        ``axis``: one group for each index of the other axes, ordered by
        the index along ``axis``."""
        stride, n = self._stride(axis), self.shape[axis]
        return [tuple(base + i * stride for i in range(n))
                for base in range(len(self.devices))
                if (base // stride) % n == 0]

    @property
    def distinct_devices(self) -> int:
        return len(set(self.devices))


def _device_pool(devices):
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA card is visible; pass devices='cpu' "
                               "for a CPU mesh")
        return [torch.device("cuda", i) for i in range(n)]
    if isinstance(devices, (str, torch.device)):
        return [torch.device(devices)]
    return [torch.device(d) for d in devices]


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str],
              devices=None) -> DeviceMesh:
    """The counterpart of ``jax.make_mesh``: a mesh of any axes, whose
    positions go round-robin over ``devices``: by default the visible
    CUDA cards (none visible raises), ``"cpu"`` for the CPU, or a list of
    devices."""
    if len(axis_shapes) != len(axis_names):
        raise ValueError(f"{len(axis_shapes)} extents for axes {axis_names}")
    pool = _device_pool(devices)
    n_pos = math.prod(axis_shapes)
    return DeviceMesh(tuple(axis_names), dict(zip(axis_names, axis_shapes)),
                      tuple(pool[i % len(pool)] for i in range(n_pos)))


def make_test_mesh(data: int = 2, model: int = 4, pod: int = 1,
                   devices=None) -> DeviceMesh:
    """A ``(data, model)`` mesh (``(pod, data, model)`` when ``pod > 1``)
    over ``devices``, as ``make_mesh`` places it."""
    if pod > 1:
        return make_mesh((pod, data, model), ("pod", "data", "model"),
                         devices)
    return make_mesh((data, model), ("data", "model"), devices)


# Hardware constants for the roofline (TPU v5e-class chip).
PEAK_FLOPS_BF16 = 197e12      # per chip
HBM_BW = 819e9                # bytes/s per chip
ICI_BW = 50e9                 # bytes/s per link (~usable)
