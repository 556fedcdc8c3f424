"""Swallow §V-A: the 2.5-D "lattice" topology and dimension-ordered routing.

The XS1-L2A package exposes 4 external links but burns the internal ones
on the core<->core connection, so a grid of packages becomes a two-layer
*lattice*: one layer of cores routes vertically, the other horizontally,
with the only layer crossing inside a package (Fig. 7).  DOR with
vertical priority needs at most TWO layer transitions per route — we
implement the generator + router and property-test exactly that claim,
plus full connectivity.

``map_to_torus`` then re-derives the lesson for TPU: the lattice's
"dimension per layer" becomes "collective phase per mesh axis" — our 2-D
all-reduce decomposition (reduce-scatter along "data", then along "pod",
then all-gather back) is dimension-ordered routing applied to
collectives (see parallel/lattice.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Tuple

Node = Tuple[int, int, int]   # (layer, row, col); layer 0 = vertical router


@dataclass(frozen=True)
class Lattice:
    rows: int
    cols: int

    def nodes(self) -> Iterator[Node]:
        for l in (0, 1):
            for r in range(self.rows):
                for c in range(self.cols):
                    yield (l, r, c)

    def neighbors(self, n: Node) -> List[Node]:
        l, r, c = n
        out = [(1 - l, r, c)]                       # intra-package crossing
        if l == 0:                                   # vertical layer
            if r > 0:
                out.append((0, r - 1, c))
            if r < self.rows - 1:
                out.append((0, r + 1, c))
        else:                                        # horizontal layer
            if c > 0:
                out.append((1, r, c - 1))
            if c < self.cols - 1:
                out.append((1, r, c + 1))
        return out

    def route(self, src: Node, dst: Node) -> List[Node]:
        """Dimension-ordered routing, vertical dimension first (§V-A)."""
        path = [src]
        cur = src
        # 1. vertical moves need the vertical layer
        if cur[1] != dst[1]:
            if cur[0] != 0:
                cur = (0, cur[1], cur[2])
                path.append(cur)
            step = 1 if dst[1] > cur[1] else -1
            while cur[1] != dst[1]:
                cur = (0, cur[1] + step, cur[2])
                path.append(cur)
        # 2. horizontal moves need the horizontal layer
        if cur[2] != dst[2]:
            if cur[0] != 1:
                cur = (1, cur[1], cur[2])
                path.append(cur)
            step = 1 if dst[2] > cur[2] else -1
            while cur[2] != dst[2]:
                cur = (1, cur[1], cur[2] + step)
                path.append(cur)
        # 3. final layer fix-up (at most one more transition)
        if cur[0] != dst[0]:
            cur = (dst[0], cur[1], cur[2])
            path.append(cur)
        return path

    @staticmethod
    def layer_transitions(path: List[Node]) -> int:
        return sum(1 for a, b in zip(path, path[1:]) if a[0] != b[0])

    def hops(self, src: Node, dst: Node) -> int:
        return len(self.route(src, dst)) - 1


def average_hops(lat: Lattice, sample: int = 0) -> float:
    nodes = list(lat.nodes())
    tot = n = 0
    for i, s in enumerate(nodes):
        for d in nodes[i + 1:]:
            tot += lat.hops(s, d)
            n += 1
    return tot / max(n, 1)


def map_to_torus(mesh_shape: Dict[str, int]) -> Dict[str, float]:
    """TPU-torus analogue figures for a mesh: per-axis ring hop counts for
    the collectives our framework emits (ring AG/RS = size-1 hops)."""
    out = {}
    for axis, size in mesh_shape.items():
        out[axis] = {
            "ring_steps": max(size - 1, 0),
            "avg_p2p_hops_torus": size / 4 if size > 1 else 0,  # bidirectional
        }
    return out
