"""Swallow §III-A + §X-B: nodes as remote data storage / shared-memory
emulation over distributed memory.

Reference: ``repro/core/memory_server.py``.  Two strategies, exactly as
the paper frames them:
  * ``SingleController`` — one node owns the whole store; every access is
    a message to it (simple, a contention point).
  * ``StripedStore`` — address space striped ``address % n`` over n
    per-node controllers (the paper's "more elegant strategy").

The host half is the striping rule the page allocator accounts with
(``striped_owner``) and the slab index the paged engine places a striped
pool's pages by (``stripe_slab_index``, ``models/attention
.StripedPagedCache``).  The device half is a fixed-size fp32 slab: on a
:class:`~repro_torch.launch.mesh.DeviceMesh` under ``use_sharding`` it is
one stripe tensor per position along the store's axis, the counterpart
of the reference's ``NamedSharding(mesh, P(axis))``; one controller reads
by gathering from every stripe and writes by scattering into the owning
stripes, and no stripe ever leaves its position.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.parallel.sharding import current_env


def striped_owner(address, n_nodes: int):
    """address % n — the paper's distribution rule."""
    return address % n_nodes


def stripe_slab_index(address, n_nodes: int, size: int):
    """Slab (physical) row of ``address`` under the stripe layout.

    Word/page ``a`` lives on node ``a % n`` at local offset ``a // n``;
    node ``d`` owns the contiguous rows ``[d*size/n, (d+1)*size/n)``.
    Identity when ``n_nodes == 1``; ``stripe_slab_index(0, ...) == 0``
    always (the serving engine's null page stays row 0 on node 0).
    Requires ``size % n_nodes == 0``.
    """
    node = address % n_nodes
    local = address // n_nodes
    return node * (size // n_nodes) + local


def last_writes(addresses: torch.Tensor, values: torch.Tensor):
    """(addresses, values) with each duplicated address kept once, at its
    last occurrence in the batch: the order every device then writes in
    no longer matters.  (A CUDA ``index_put_`` leaves the winner among
    duplicates undefined; JAX's ``.at[].set`` keeps the last.)"""
    uniq, inv = torch.unique(addresses, return_inverse=True)
    order = torch.arange(addresses.numel(), device=addresses.device)
    last = torch.full_like(uniq, -1).scatter_reduce_(0, inv, order, "amax")
    return uniq, values[last]


def _slab_device(device):
    from repro_torch.weights import resolve_device
    return resolve_device(device)


@dataclass
class StripedStore:
    """address space striped over devices along one mesh axis.

    ``device`` places the slab off the mesh (default ``cuda``; with no
    card it raises unless ``device="cpu"``); on a mesh the stripes go to
    the positions along ``axis``."""
    size: int                   # total words
    axis: str = "model"
    device: Optional[str] = None

    def __post_init__(self):
        env = current_env()
        self.env = env
        self.n = env.mesh.shape[self.axis] if env is not None else 1
        if self.size % self.n:
            raise ValueError(f"size {self.size} is not a multiple of the "
                             f"{self.n} stripes")
        self.devices: Tuple[torch.device, ...] = (
            env.mesh.axis_devices(self.axis) if env is not None
            else (_slab_device(self.device),))
        rows = self.size // self.n
        self.stripes = tuple(torch.zeros(rows, dtype=torch.float32,
                                         device=d) for d in self.devices)

    def _owners(self, addresses):
        """(stripe, its local rows) of every address, through the slab
        index: stripe ``j`` holds slab rows ``[j*rows, (j+1)*rows)``."""
        rows = self.size // self.n
        slab = stripe_slab_index(addresses.long(), self.n, self.size)
        return slab // rows, slab % rows

    def read(self, addresses):
        """Gather a batch of words: each stripe answers for the addresses
        it owns; the words arrive on position 0's device."""
        home = self.devices[0]
        addresses = addresses.to(home)
        owner, local = self._owners(addresses)
        out = torch.empty(addresses.shape, dtype=torch.float32, device=home)
        for j, (stripe, dev) in enumerate(zip(self.stripes, self.devices)):
            sel = (owner == j).nonzero().squeeze(1)
            out[sel] = stripe[local[sel].to(dev)].to(home)
        return out

    def write(self, addresses, values):
        """Scatter a batch of words into their owning stripes; a
        duplicated address keeps its last value in the batch."""
        home = self.devices[0]
        addresses, values = last_writes(
            addresses.to(home).long(),
            values.to(device=home, dtype=torch.float32))
        owner, local = self._owners(addresses)
        for j, (stripe, dev) in enumerate(zip(self.stripes, self.devices)):
            sel = (owner == j).nonzero().squeeze(1)
            stripe[local[sel].to(dev)] = values[sel].to(dev)

    def traffic_model(self, n_accesses: int,
                      n_nodes: Optional[int] = None) -> dict:
        """Expected fraction of remote accesses (paper: (n-1)/n of reads
        leave the node under uniform addressing)."""
        n = n_nodes if n_nodes is not None else self.n
        remote = (n - 1) / max(n, 1)
        return {"remote_fraction": remote,
                "expected_remote_words": n_accesses * remote,
                "contention_points": 0}


@dataclass
class SingleController:
    """One owner node: every access is remote for everyone else.
    ``device`` as for :class:`StripedStore` off the mesh."""
    size: int
    device: Optional[str] = None

    def __post_init__(self):
        self.slab = torch.zeros(self.size, dtype=torch.float32,
                                device=_slab_device(self.device))

    def read(self, addresses):
        return self.slab[addresses.to(self.slab.device).long()]

    def write(self, addresses, values):
        addresses, values = last_writes(
            addresses.to(self.slab.device).long(),
            values.to(device=self.slab.device, dtype=torch.float32))
        self.slab[addresses] = values

    def traffic_model(self, n_accesses: int, n_nodes: int) -> dict:
        remote = (n_nodes - 1) / max(n_nodes, 1)
        return {"remote_fraction": remote,
                "expected_remote_words": n_accesses * remote,
                "contention_points": 1}


def memory_per_task(n_procs: int, tasks: int,
                    node_kb: float = 64.0) -> float:
    """Fig. 3: memory available per task (kB) when ``tasks`` tasks share
    ``n_procs`` nodes (idle nodes become storage)."""
    return n_procs * node_kb / max(tasks, 1)
