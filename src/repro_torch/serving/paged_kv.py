"""Swallow §III-A + §X-B: the KV cache as a striped distributed store.

What is reproduced: the paper's "more elegant strategy" — an address
space striped ``address % n`` over per-node controllers — applied to KV
pages.  Physical page ``p`` is owned by node ``striped_owner(p, n)``
(:mod:`repro.core.memory_server` is the single source of truth for the
mapping), and the allocator hands a request's *logical* page ``j`` a
physical page on node ``j % n`` whenever one is free, so a sequence's
cache reads fan out over the mesh exactly like the paper's memory-server
traffic instead of hammering one contention point.

What is extrapolated: Swallow stores 32-bit words; here a "word" is a
(page_size, Kv*hd) KV page and the striping axis is the mesh "model"
dimension the pools are sharded over.  Page 0 is reserved as the null
page — padded block-table slots point at it so the paged attention
kernel always DMAs a real page and masks its contribution to exactly 0.

Sharing (§X-B's shared-memory overlay made real): every allocated page
carries a refcount.  A freshly allocated page has refcount 1 (its
owner's reference); :meth:`PageAllocator.share` adds a reference (a
prefix-cache node, or a second request reusing a cached prefix) and
:meth:`PageAllocator.release_page` drops one — the page returns to the
free list only at refcount 0, so shared pages survive their original
owner's completion or preemption.  The null page is never shared and
never refcounted.  ``reclaim`` is an optional callback (wired to
:meth:`repro.serving.prefix_cache.PrefixCache.evict`) invoked when the
free list runs short, so cold cache pages are evicted before any tenant
is preempted.

Node failure (§VIII's fault model applied to the store): when a node of
the striped DSM dies, every physical page whose stripe lands on it is
*quarantined* by :meth:`PageAllocator.fail_node` — pulled from the free
lists immediately, and marked so that pages still referenced (by a
request's block table or the prefix-cache tree) route to the quarantine
pool instead of the free list when their last reference drops.  A
quarantined page is never handed out again until
:meth:`PageAllocator.restore_node` re-joins the node, and the
conservation invariant is extended to a three-way partition: free +
allocated + quarantined-free == n_pages - 1.  The null page is a device
convention (its contribution is masked to zero), not striped state, so
it survives any node's failure.

Pure host-side logic: no jax imports, unit-testable anywhere.  The
device-side half (pools + block tables) lives in
:mod:`repro.serving.engine`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set

from repro_torch.core.memory_server import striped_owner

NULL_PAGE = 0


@dataclass
class PageAllocator:
    """Fixed-size-page allocator over a striped pool.

    ``n_pages`` counts physical pages including the reserved null page;
    ``n_nodes`` is the striping width (mesh "model" extent).
    """
    n_pages: int
    page_size: int
    n_nodes: int = 1
    held: Dict[str, List[int]] = field(default_factory=dict)
    refcount: Dict[int, int] = field(default_factory=dict)
    reclaim: Optional[Callable[[int], int]] = None
    _free_by_node: List[List[int]] = field(default_factory=list)
    # fault plane: pages striped to a dead node (never re-allocated until
    # the node restores) and the set of currently-failed nodes
    quarantined: Set[int] = field(default_factory=set)
    failed_nodes: Set[int] = field(default_factory=set)
    # telemetry: occupancy/capacity exported as live gauge callables on
    # the owning engine's MetricsRegistry (or a private one)
    registry: Optional[object] = None

    def __post_init__(self):
        assert self.n_pages > 1, "need at least one page beyond the null page"
        if self.n_nodes > self.n_pages - 1:
            # a node whose stripe holds zero allocatable pages starves its
            # controller and skews conservation accounting (the paper's
            # striping assumes every node owns part of the address space)
            raise ValueError(
                f"n_nodes={self.n_nodes} > allocatable pages "
                f"{self.n_pages - 1}: every node needs at least one page "
                f"in its stripe (raise n_pages or lower n_nodes)")
        self._free_by_node = [[] for _ in range(self.n_nodes)]
        # LIFO free lists per owner node; page 0 is never handed out
        for p in range(self.n_pages - 1, NULL_PAGE, -1):
            self._free_by_node[self.owner(p)].append(p)
        if self.registry is None:
            from repro_torch.serving.telemetry import MetricsRegistry
            self.registry = MetricsRegistry()
        # registered as callables: the registry snapshot samples the
        # allocator live instead of caching stale occupancy
        self.registry.register_gauge("pages_in_use",
                                     lambda: self.pages_in_use)
        self.registry.register_gauge("free_pages", lambda: self.free_pages)
        self.registry.register_gauge("pages_quarantined_now",
                                     lambda: self.pages_quarantined)
        self.registry.register_gauge("allocatable_pages",
                                     lambda: self.allocatable_pages)

    # -- the striping rule (one source of truth) ---------------------------
    def owner(self, page: int) -> int:
        """Node owning physical ``page`` — delegates to the paper's
        address%n rule in core/memory_server."""
        return striped_owner(page, self.n_nodes)

    # -- accounting --------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return sum(len(f) for f in self._free_by_node)

    @property
    def pages_in_use(self) -> int:
        """Distinct allocated pages — a page shared by N requests and the
        prefix cache counts once (refcount, not held-list, is truth)."""
        return len(self.refcount)

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` KV entries.  Zero tokens
        need zero pages — a zero-length request is allocation-free, and
        the engine rejects empty prompts at submit anyway (a prompt must
        hold at least one token to prefill a first logit)."""
        if n_tokens <= 0:
            return 0
        return -(-n_tokens // self.page_size)

    def refcount_of(self, page: int) -> int:
        return self.refcount.get(page, 0)

    @property
    def pages_quarantined(self) -> int:
        """Pages currently striped to a dead node (allocated or idle)."""
        return len(self.quarantined)

    @property
    def allocatable_pages(self) -> int:
        """Pool capacity excluding the null page and the quarantine —
        what admission/feasibility checks must size against while a node
        is down."""
        return self.n_pages - 1 - len(self.quarantined)

    def occupancy_by_node(self) -> List[int]:
        """Allocated pages per owner node (load-balance observable).
        Shared pages count once — this is physical occupancy."""
        counts = [0] * self.n_nodes
        for p in self.refcount:
            counts[self.owner(p)] += 1
        return counts

    def check_conservation(self) -> bool:
        """Every non-null page is on exactly one side of a three-way
        partition: free list (refcount 0, healthy node), allocated
        (refcount >= 1 — possibly on a dead node, awaiting recovery), or
        quarantined-free (refcount 0 on a dead node, parked until
        :meth:`restore_node`)."""
        free = [p for f in self._free_by_node for p in f]
        if len(free) != len(set(free)):
            return False
        if set(free) & set(self.refcount):
            return False
        if set(free) & self.quarantined:
            return False              # quarantined pages never circulate
        if NULL_PAGE in self.refcount or NULL_PAGE in free \
                or NULL_PAGE in self.quarantined:
            return False
        if any(c < 1 for c in self.refcount.values()):
            return False
        quar_free = len(self.quarantined - set(self.refcount))
        return len(free) + len(self.refcount) + quar_free \
            == self.n_pages - 1

    # -- sharing (refcounts) ----------------------------------------------
    def share(self, page: int) -> None:
        """Add a reference to an allocated page (prefix-cache node or a
        second request reusing it).  The null page is never shared."""
        if page == NULL_PAGE:
            raise ValueError("the null page cannot be shared")
        if page in self.quarantined:
            # a dead node's page may be awaiting recovery but never gains
            # new readers — the "never re-served" half of the fault plane
            raise ValueError(f"page {page} is quarantined; cannot share")
        if self.refcount.get(page, 0) < 1:
            raise ValueError(f"page {page} is not allocated; cannot share")
        self.refcount[page] += 1

    def release_page(self, page: int) -> bool:
        """Drop one reference; free the page at refcount 0.  Returns True
        when the page actually returned to the free list.  Releasing an
        unallocated page is a double free and raises."""
        c = self.refcount.get(page, 0)
        if c < 1:
            raise ValueError(f"double free of page {page}")
        if c == 1:
            del self.refcount[page]
            if page in self.quarantined:
                return False          # parked until restore_node
            self._free_by_node[self.owner(page)].append(page)
            return True
        self.refcount[page] = c - 1
        return False

    # -- node failure / re-join (the fault plane's allocator half) ---------
    def fail_node(self, node: int) -> Set[int]:
        """Quarantine every physical page whose ``striped_owner`` stripe
        lands on ``node``.  Idle pages leave the free list immediately;
        pages still referenced (request block tables, prefix-cache tree)
        stay in ``refcount`` until their holders release them — the
        caller (engine recovery) is responsible for resetting those
        holders — and :meth:`release_page` then parks them in quarantine
        instead of recirculating them.  Returns the newly quarantined
        set.  Idempotent per node.  The null page is a device convention
        (masked, replicated), never quarantined."""
        if not 0 <= node < self.n_nodes:
            raise ValueError(f"node {node} outside stripe width "
                             f"{self.n_nodes}")
        if node in self.failed_nodes:
            return set()
        self.failed_nodes.add(node)
        newly = {p for p in range(1, self.n_pages) if self.owner(p) == node}
        # this node's refcount-0 pages are exactly its free list: pull
        # them from circulation in one move
        self._free_by_node[node] = []
        self.quarantined |= newly
        return newly

    def restore_node(self, node: int) -> int:
        """Re-join: the node's quarantined pages leave quarantine; those
        with no outstanding references return to its free list (LIFO,
        high to low, matching ``__post_init__``).  A page somehow still
        referenced simply resumes normal refcount life — it frees
        wherever its last release lands.  Returns how many pages
        re-entered the free list."""
        if node not in self.failed_nodes:
            return 0
        self.failed_nodes.discard(node)
        mine = {p for p in self.quarantined if self.owner(p) == node}
        self.quarantined -= mine
        restored = 0
        for p in sorted(mine, reverse=True):
            if p not in self.refcount:
                self._free_by_node[node].append(p)
                restored += 1
        return restored

    # -- alloc / grow / free ----------------------------------------------
    def _take(self, want_node: int) -> Optional[int]:
        """Pop a free page on ``want_node``, falling back to the richest
        node (work-conserving when the stripe is fragmented)."""
        if self._free_by_node[want_node]:
            return self._free_by_node[want_node].pop()
        best = max(range(self.n_nodes),
                   key=lambda n: len(self._free_by_node[n]))
        if self._free_by_node[best]:
            return self._free_by_node[best].pop()
        return None

    def _ensure(self, n: int) -> None:
        """Ask the reclaimer (prefix-cache LRU eviction) for pages when
        the free list cannot cover ``n`` — cold cache pages go before any
        tenant is preempted."""
        if n > self.free_pages and self.reclaim is not None:
            self.reclaim(n - self.free_pages)

    def alloc(self, rid: str, n: int,
              prefix: Optional[Sequence[int]] = None) -> Optional[List[int]]:
        """All-or-nothing: ``n`` *fresh* pages for ``rid``.  ``prefix``
        is an already-shared page run (refcounts bumped by the caller via
        the prefix cache) that fills logical pages 0..len(prefix)-1, so
        fresh logical page j lands on node (len(prefix)+j) % n_nodes.
        Returns the full page list (prefix + fresh) or None."""
        if rid in self.held:
            return None
        self._ensure(n)
        if n > self.free_pages:
            return None
        off = len(prefix) if prefix else 0
        pages = list(prefix) if prefix else []
        for j in range(n):
            p = self._take(striped_owner(off + j, self.n_nodes))
            assert p is not None
            self.refcount[p] = 1
            pages.append(p)
        self.held[rid] = pages
        return pages

    def grow(self, rid: str, n: int = 1) -> bool:
        """Append ``n`` pages to an existing allocation (decode crossing
        a page boundary)."""
        self._ensure(n)
        if n > self.free_pages:
            return False
        pages = self.held[rid]
        for _ in range(n):
            p = self._take(striped_owner(len(pages), self.n_nodes))
            assert p is not None
            self.refcount[p] = 1
            pages.append(p)
        return True

    def reserve(self, rid: str, n_tokens: int) -> int:
        """Horizon pre-reservation: grow ``rid`` (best-effort under page
        pressure) until its pages cover every write position below
        ``n_tokens``, so the block-table row is fixed for a whole fused
        decode window.  Returns the token capacity actually reserved —
        the caller shrinks the window to ``capacity - pos`` when the
        pool runs dry instead of preempting mid-window."""
        need = self.pages_for(n_tokens)
        while len(self.held[rid]) < need and self.grow(rid):
            pass
        return len(self.held[rid]) * self.page_size

    def truncate_to(self, rid: str, n_tokens: int) -> int:
        """Speculative rollback: shrink ``rid``'s allocation to exactly
        the pages covering token positions below ``n_tokens`` (whole
        rejected/over-reserved tail pages are released).  Only this
        request's references are dropped — a tail page another holder
        shares survives via its refcount (``release_page`` semantics),
        and the null page is never involved because it is never held.
        KV slots past ``n_tokens`` inside the *kept* tail page are not
        wiped: they are masked by position and overwritten before the
        sequence's write position ever reaches them (the same argument
        as COW page copies).  Returns how many pages actually returned
        to the free list."""
        pages = self.held[rid]
        keep = -(-max(n_tokens, 0) // self.page_size)
        freed = 0
        while len(pages) > keep:
            if self.release_page(pages.pop()):
                freed += 1
        return freed

    def free(self, rid: str) -> int:
        """Release every reference ``rid`` holds; returns how many pages
        actually returned to the free list (shared pages survive until
        their last reference — the prefix cache's or another request's —
        is dropped)."""
        pages = self.held.pop(rid, [])
        freed = 0
        for p in pages:
            if self.release_page(p):
                freed += 1
        return freed
