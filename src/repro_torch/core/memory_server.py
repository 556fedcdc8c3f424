"""Host half of the striped memory server (reference:
``repro/core/memory_server.py``): the address-to-node striping rule the
page allocator accounts with, and the slab index the paged engine places
a striped pool's pages by (``models/attention.StripedPagedCache``).  The
reference's device-side ``StripedStore`` is not ported.
"""
from __future__ import annotations


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
