"""Swallow §X-B made load-bearing: a copy-on-write prefix-sharing overlay
on the striped page store.

The paper's second case study emulates *shared* memory on a
distributed-memory machine by striping one address space over per-node
controllers.  The paged store reproduces the striping for KV pages but
leaves every request with private pages — the overlay is modeled, not
used.  This module is the sharing half: a radix tree over token IDs
whose nodes own ref-counted, immutable KV pages, so two requests whose
prompts share a prefix read the *same* physical pages through their
block tables.  The ``paged_decode_attention`` gather needs no kernel
change — page indirection (the paged store) already decouples a
sequence's logical cache from physical placement, which is exactly the
payoff the paper claims for its address%n overlay.

Structure: one radix node == one physical page.  A node's ``key`` is the
run of token IDs stored in its page (``fill`` of them, ``fill ==
page_size`` for interior nodes; partially filled nodes are leaves —
donated tails of completed sequences).  Children hang off full nodes
only, keyed by their first token.  Matching a prompt walks full-page
chunks; the first mismatch (or a partial node) ends the walk with an
optional mid-page partial match — the copy-on-write case: the request
COWs that page into a private copy and overwrites from the divergence
point, never mutating a shared page.

Lifecycle (refcounts live in
:class:`~repro_torch.serving.paged_kv.PageAllocator`):

* ``acquire(prompt)`` — walk, bump refcounts on every matched page (full
  matches *and* the COW source) so eviction cannot pull them out from
  under an admission in flight, and return a :class:`PrefixMatch`.
* ``insert(tokens, pages, ...)`` — after a prefill (full pages, which
  are immutable the moment they are written) or a completion (the
  partial tail too — immutable once the owner stops decoding), graft the
  sequence's pages into the tree; the tree takes its own reference, so
  shared pages survive the owner's free.
* ``evict(n)`` — LRU over leaves with no active users (refcount == the
  tree's own single reference): drop the tree's reference, page returns
  to the striped free list.  Wired as ``PageAllocator.reclaim`` so cold
  cache pages are reclaimed before any tenant is preempted.

Exact-token invariant: sharing only ever changes *where* a KV entry
lives, never its value — cache contents for a given (token, position)
are deterministic under greedy decode, so ``--prefix-cache on`` emits
bit-identical tokens to ``off`` (pinned by tests/test_prefix_cache.py).

Pure host-side logic: no jax imports.  The device-side COW copy and
suffix prefill live in :mod:`repro_torch.serving.engine`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.paged_kv import PageAllocator
from repro_torch.serving.telemetry import MetricsRegistry, counter_attr


class RadixNode:
    """One cached page: ``key`` (the ``fill`` token IDs it stores), the
    physical ``page``, and children keyed by first token (full nodes
    only)."""
    __slots__ = ("key", "page", "parent", "children", "last_used")

    def __init__(self, key: Tuple[int, ...], page: int,
                 parent: Optional["RadixNode"]):
        self.key = key
        self.page = page
        self.parent = parent
        self.children: Dict[int, RadixNode] = {}
        self.last_used = 0

    @property
    def fill(self) -> int:
        return len(self.key)


@dataclass
class PrefixMatch:
    """Result of :meth:`PrefixCache.acquire` — everything the scheduler
    and engine need to admit a request against the cache.

    ``length`` cached tokens are usable (capped at prompt_len - 1 so at
    least one token always runs through the model for first-token
    logits); the first ``length // page_size`` logical pages are the
    shared ``pages`` (refcounts already bumped, one reference per this
    request); when ``length % page_size != 0`` the divergence lands
    mid-page and ``cow_src`` names the page to copy-on-write (a
    temporary reference is held until the engine copies or the admission
    aborts)."""
    length: int = 0
    pages: List[int] = field(default_factory=list)
    cow_src: Optional[int] = None

    @property
    def hit(self) -> bool:
        return self.length > 0


class PrefixCacheStats:
    """Cache counters, registry-backed: each attribute is one
    ``prefix_*`` slot in a :class:`~repro_torch.serving.telemetry
    .MetricsRegistry` (the owning engine's, so one reset covers the
    cache too), exposed under the historical attribute names."""

    lookups = counter_attr("prefix_lookups")
    hits = counter_attr("prefix_hits")
    tokens_cached = counter_attr("prefix_tokens_cached")
    cow_copies = counter_attr("prefix_cow_copies")
    inserts = counter_attr("prefix_inserts")         # nodes grafted
    evictions = counter_attr("prefix_evictions")     # LRU, refcount-0
    invalidations = counter_attr("prefix_invalidations")  # node failure

    def __init__(self, registry=None):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.lookups = 0
        self.hits = 0
        self.tokens_cached = 0   # prefill tokens served from shared pages
        self.cow_copies = 0
        self.inserts = 0
        self.evictions = 0
        self.invalidations = 0

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.lookups, 1)


class PrefixCache:
    """Radix-tree prefix index over token IDs on a striped page pool."""

    def __init__(self, alloc: PageAllocator, registry=None):
        self.alloc = alloc
        self.page_size = alloc.page_size
        self.root = RadixNode((), -1, None)     # sentinel, owns no page
        self._nodes: Dict[int, RadixNode] = {}  # page -> node
        self._clock = 0
        self.stats = PrefixCacheStats(registry)

    # -- bookkeeping -------------------------------------------------------
    def _touch(self, node: RadixNode) -> None:
        self._clock += 1
        node.last_used = self._clock

    @property
    def n_nodes(self) -> int:
        return len(self._nodes)

    @property
    def shared_pages(self) -> int:
        """Pages currently owned by the tree."""
        return len(self._nodes)

    def users_of(self, node: RadixNode) -> int:
        """Active references beyond the tree's own (requests whose block
        tables point at this page)."""
        return self.alloc.refcount_of(node.page) - 1

    # -- matching ----------------------------------------------------------
    def _walk(self, tokens: Sequence[int]) -> Tuple[List[RadixNode], int,
                                                    Optional[RadixNode]]:
        """Longest cached prefix of ``tokens``: (full-page node path,
        matched length, partial node) — ``partial`` is the node the match
        ends inside (mid-key divergence, a partial leaf, or a full node
        whose tail the prompt doesn't reach past)."""
        node, path, i, n = self.root, [], 0, len(tokens)
        while i < n:
            child = node.children.get(int(tokens[i]))
            if child is None:
                break
            m = 0
            stop = min(child.fill, n - i)
            while m < stop and child.key[m] == int(tokens[i + m]):
                m += 1
            if m == child.fill == self.page_size:
                path.append(child)
                i += m
                node = child
                continue
            return path, i + m, (child if m else None)
        return path, i, None

    def peek(self, tokens: Sequence[int]) -> int:
        """Usable cached token count for a prompt, without taking
        references or touching LRU state (admission pricing / horizon
        checks)."""
        if tokens is None:
            return 0
        _, length, _ = self._walk(tokens)
        return min(length, max(len(tokens) - 1, 0))

    def acquire(self, tokens: Sequence[int]) -> PrefixMatch:
        """Match + lock: bump a reference on every page the request will
        use (full shared pages) or copy from (``cow_src``), so LRU
        eviction triggered by a later allocation in the same scheduler
        step cannot free them.  Balance with the request's
        ``PageAllocator.free`` (full pages ride in ``held``) and
        :meth:`release_cow` / :meth:`release_match`.  Stats are NOT
        recorded here — the caller commits them with
        :meth:`commit_match` once the admission actually sticks, so
        page-pressure retries don't inflate hit rate or dedup gauges."""
        if tokens is None:
            return PrefixMatch()
        path, raw, partial = self._walk(tokens)
        length = min(raw, max(len(tokens) - 1, 0))
        if length <= 0:
            return PrefixMatch()
        ps = self.page_size
        n_full = length // ps
        pages = []
        for node in path[:n_full]:
            self.alloc.share(node.page)
            self._touch(node)
            pages.append(node.page)
        cow_src = None
        if length % ps:
            # the node the (possibly capped) match ends inside: either the
            # divergent/partial node from the walk, or the last full node
            # of the path when the cap pulled the boundary back
            node = partial if n_full == len(path) else path[n_full]
            assert node is not None
            self.alloc.share(node.page)
            self._touch(node)
            cow_src = node.page
        return PrefixMatch(length=length, pages=pages, cow_src=cow_src)

    def commit_match(self, match: PrefixMatch) -> None:
        """Record the lookup in the stats — called once per *successful*
        admission (hit or miss), never for budget/page-pressure aborts,
        so ``hit_rate`` / ``tokens_cached`` / ``bytes_deduped`` count
        real savings only."""
        self.stats.lookups += 1
        if match.hit:
            self.stats.hits += 1
            self.stats.tokens_cached += match.length

    def release_match(self, match: PrefixMatch) -> None:
        """Undo :meth:`acquire` when the admission aborts (budget or page
        pressure)."""
        for p in match.pages:
            self.alloc.release_page(p)
        self.release_cow(match)

    def release_cow(self, match: PrefixMatch) -> None:
        """Drop the temporary COW-source reference (engine calls this
        right after the device copy)."""
        if match.cow_src is not None:
            self.alloc.release_page(match.cow_src)
            match.cow_src = None

    # -- insertion ---------------------------------------------------------
    def insert(self, tokens: Sequence[int], pages: Sequence[int],
               n_tokens: Optional[int] = None, *,
               donate_partial: bool = False) -> int:
        """Graft a sequence's pages into the tree.  ``tokens[:n_tokens]``
        are the IDs whose KV actually lives in ``pages`` (logical order).
        Full pages are immutable the moment prefill writes them and are
        always inserted; the partial tail is inserted only with
        ``donate_partial`` (completion — the owner will never write the
        page again).  Idempotent: chunks already cached just refresh LRU.
        Returns the number of nodes grafted."""
        if tokens is None:
            return 0
        n = len(tokens) if n_tokens is None else n_tokens
        ps = self.page_size
        node, grafted = self.root, 0
        for j in range(-(-n // ps)):
            chunk = tuple(int(t) for t in tokens[j * ps:min((j + 1) * ps, n)])
            full = len(chunk) == ps
            if not full and not donate_partial:
                break
            child = node.children.get(chunk[0])
            if child is None:
                if j >= len(pages):
                    break
                child = RadixNode(chunk, pages[j], node)
                self.alloc.share(child.page)
                node.children[chunk[0]] = child
                self._nodes[child.page] = child
                self._touch(child)
                grafted += 1
                self.stats.inserts += 1
            elif child.fill < len(chunk) \
                    and child.key == chunk[:child.fill] \
                    and not child.children and j < len(pages) \
                    and self.users_of(child) == 0:
                # upgrade: a longer immutable run supersedes a donated
                # partial leaf nobody is using — swap the page in place
                self.alloc.share(pages[j])
                old = child.page
                del self._nodes[old]
                child.page, child.key = pages[j], chunk
                self._nodes[child.page] = child
                self.alloc.release_page(old)
                self._touch(child)
            elif child.key != chunk:
                break           # divergence inside the page: nothing to add
            else:
                self._touch(child)
            if not full or child.key != chunk:
                break
            node = child
        return grafted

    # -- eviction ----------------------------------------------------------
    def _evictable(self) -> List[RadixNode]:
        return [nd for nd in self._nodes.values()
                if not nd.children and self.users_of(nd) == 0]

    def evict(self, n_pages: int) -> int:
        """LRU eviction over refcount-0 leaves until ``n_pages`` pages
        returned to the free list (or nothing evictable remains).
        Interior nodes become leaves as their children go, so repeated
        passes peel the tree from the outside in."""
        freed = 0
        while freed < n_pages:
            victims = self._evictable()
            if not victims:
                break
            node = min(victims, key=lambda nd: nd.last_used)
            freed += self._drop(node)
        return freed

    def _drop(self, node: RadixNode) -> int:
        del self._nodes[node.page]
        node.parent.children.pop(node.key[0], None)
        self.stats.evictions += 1
        return 1 if self.alloc.release_page(node.page) else 0

    # -- fault-plane invalidation ------------------------------------------
    def invalidate_pages(self, pages) -> int:
        """Node-failure quarantine, tree-wide: drop every node whose page
        is in ``pages`` AND its whole subtree — descendants are only
        reachable for matching through the lost ancestor, so keeping them
        would strand pages the tree can never hand out again.  Unlike
        LRU eviction this ignores ``users_of``: the allocator's
        quarantine (not the free list) catches the released references,
        and live holders are reset by the scheduler's recovery pass.
        Returns the number of nodes dropped."""
        lost = {p for p in pages if p in self._nodes}
        if not lost:
            return 0
        dropped = 0
        for page in sorted(lost):
            node = self._nodes.get(page)
            if node is None:
                continue              # already gone via an ancestor
            dropped += self._drop_subtree(node)
        return dropped

    def _drop_subtree(self, node: RadixNode) -> int:
        n = 0
        for child in list(node.children.values()):
            n += self._drop_subtree(child)
        del self._nodes[node.page]
        node.parent.children.pop(node.key[0], None)
        self.stats.invalidations += 1
        self.alloc.release_page(node.page)
        return n + 1

    def clear(self) -> int:
        """Release every tree reference (e.g. after an engine warmup so
        benchmark runs start cold).  Pages still used by live requests
        survive via their own refcounts."""
        freed = 0
        for node in list(self._nodes.values()):
            if self.alloc.release_page(node.page):
                freed += 1
            del self._nodes[node.page]
        self.root = RadixNode((), -1, None)
        return freed

    # -- observability -----------------------------------------------------
    def metrics(self) -> dict:
        s = self.stats
        return {
            "prefix_lookups": s.lookups,
            "prefix_hits": s.hits,
            "prefix_hit_rate": s.hit_rate,
            "prefill_tokens_cached": s.tokens_cached,
            "cow_copies": s.cow_copies,
            "prefix_nodes": self.n_nodes,
            "shared_pages": self.shared_pages,
            "prefix_evictions": s.evictions,
            "prefix_invalidations": s.invalidations,
        }
