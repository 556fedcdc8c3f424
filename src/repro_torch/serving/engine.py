"""The paged-KV continuous-batching engine (reference:
``repro/serving/engine.py`` ``PagedEngine``).

Per-layer KV pools (``lm.init_paged_caches``) are the striped store, the
block-table matrix is the address map, and the steps
(``make_paged_serve_step`` / ``make_paged_serve_scan``) decode every
occupied slot of the batch while the scheduler refills freed slots with
cost-priced prefills.

Slot state — tokens, positions, block tables, active mask — lives in
device tensors; the host keeps a numpy mirror that is pushed only when
scheduler bookkeeping dirties it, and results are pulled once per fused
window.  ``h2d_syncs`` / ``d2h_syncs`` count those events exactly as the
reference does.  ``fused=False`` is the per-step path with identical
tokens.

Prefix sharing (``prefix_cache=True``): admissions are matched against
:mod:`repro_torch.serving.prefix_cache`, the radix tree over token ids
whose nodes own ref-counted pages.  A hit skips the cached prefix (the
block row points at the shared pages), copies the divergence page on the
device when the match ends mid-page (copy-on-write), and prefills only
the uncached suffix in one pass (``make_paged_suffix_prefill``).

Speculative decoding (``spec_decode=True``): each running sequence
drafts up to K tokens from its own prompt+output history
(:mod:`repro_torch.serving.spec_decode`, n-gram lookup) and one verify
pass scores all K+1 positions against the paged KV.  With
``spec_proposer="device"`` (the default) the draft, the verify, the
greedy acceptance and the history append are one chain on the device
(``make_spec_draft_verify``) and the host pulls only ``(emitted, n_emit,
m)``; ``spec_proposer="host"`` drafts on the host and verifies through
``make_verify_window``.  ``spec_k="auto"`` adapts K per tenant from an
acceptance EWMA, and a priced gate (:meth:`PagedEngine._spec_gate`, on
the cost engine's numbers) buys a verify only where it beats the scan
it displaces.  Rejected KV is rolled back (``PageAllocator.truncate_to``).

Chunked prefill (``chunked_prefill=True``): admitted requests sit in the
scheduler's ``prefilling`` state and each engine step dispatches a
budgeted round of page-aligned chunks (``make_chunk_prefill``, the
suffix-prefill body at successive offsets) before the decode window;
only the final chunk's logits are pulled.

Greedy tokens are the same with each feature on or off: the suffix,
chunk and verify passes compute the same function as the decode path
(``tests/test_torch_flag_cube.py`` holds the 32 combinations of the
features against the reference's dense oracle).

Fault plane (``n_nodes``, ``fault_plan``): the allocator stripes the
pool's pages over ``n_nodes`` nodes.  Without a mesh the striping is
host-side only: the pools stay one tensor on one device, and a node's
failure quarantines its pages in the allocator, resets every request
whose block table touches them (exact greedy recompute through the
preemption path) and sheds what the shrunken pool can never fit.  A
quarantined page keeps its stale KV on the device, so the host is the
only guard: ``_block_row`` and ``_assert_no_quarantined`` raise (after a
flight-recorder dump) rather than let a dispatch read one.  A
:class:`~repro_torch.serving.faults.FaultPlan` drives the failures,
re-joins, stragglers and transient admission errors on the scheduler's
step clock (:meth:`PagedEngine.install_faults`).

Tracing (``trace=True``): a :class:`~repro_torch.serving.telemetry
.StepTracer` records request-lifecycle spans (from the scheduler) and a
span around every dispatch, stamped with the cost engine's predicted
seconds and joules.  Those predictions price the reference's TPU
v5e-class model (``launch/mesh.py``), not the device the port runs on.
A span times its body on the host clock: it includes device time only
where the body ends in a pull to the host (prefill, chunk, scan and
verify bodies do; ``cow_copy`` times the enqueue).  Tracing never feeds
back into scheduling, so tokens are the same on or off.  Mesh-striped
pools raise ``NotImplementedError`` (ROADMAP Queue A item 7).
"""
from __future__ import annotations

import contextlib
import functools
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import steps as steps_mod
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import costs
from repro_torch.core.energy import step_energy
from repro_torch.launch.mesh import HBM_BW
from repro_torch.models import lm, modules as nn
from repro_torch.serving.faults import FaultPlane
from repro_torch.serving.paged_kv import NULL_PAGE, PageAllocator
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.scheduler import ContinuousBatchScheduler, Request
from repro_torch.serving.spec_decode import NGramSpec, SpecStats
from repro_torch.serving.telemetry import (HistogramDigest, MetricsRegistry,
                                           StepTracer, counter_attr)
from repro_torch.weights import resolve_device


# -- cost-engine pricing (the scheduler's admission inputs) ----------------
# functions of the config and the stripe, never bound methods: the
# scheduler holds them, and the engine is freed when its last reference
# goes, without the cycle collector
def _estimate(cfg, link_mode: str, n_nodes: int, shape):
    return costs.estimate(cfg, costs.Layout(data=1, model=n_nodes),
                          link_mode, shape)


def _prefill_cost(cfg, link_mode: str, n_nodes: int,
                  prompt_len: int) -> float:
    shape = ShapeConfig("serve_prefill", max(prompt_len, 1), 1, "prefill")
    return _estimate(cfg, link_mode, n_nodes, shape).step_time_s


class PagedEngine:
    """Paged-KV serving engine over one model on one device.

    ``max_len`` bounds prompt+gen per sequence; the block table has
    ``ceil(max_len / page_size)`` entries per slot.  ``n_pages`` includes
    the reserved null page.  ``fused=True`` decodes in windows of up to
    ``max_window`` steps per call; ``fused=False`` is the per-step path.
    ``prefix_cache``, ``spec_decode`` (``spec_k`` an int or ``"auto"``,
    ``spec_ngram``, ``spec_proposer`` ``"device"`` or ``"host"``) and
    ``chunked_prefill`` (``chunk_tokens``, 0 = two pages) take the
    reference's defaults.  ``n_nodes`` stripes the allocator's pages
    (host-side: the pools stay on one device) and, with ``link_mode``,
    prices admission as the reference does; ``fault_plan`` arms the fault
    plane, ``trace`` the flight recorder (``trace_capacity`` spans).
    ``device`` defaults to ``cuda`` and must hold ``params``; with no
    device given and no CUDA present the constructor raises.
    """

    steps_run = counter_attr()
    windows_run = counter_attr()
    decode_steps = counter_attr()
    decode_tokens = counter_attr()
    tokens_emitted = counter_attr()
    decode_time_s = counter_attr()
    spec_time_s = counter_attr()       # draft+verify subset of decode_time_s
    h2d_syncs = counter_attr()
    d2h_syncs = counter_attr()
    block_row_writes = counter_attr()
    peak_pages = counter_attr()
    prefill_tokens = counter_attr()    # prompt tokens actually computed
    chunk_dispatches = counter_attr()  # chunked-prefill model passes
    # sequential model passes (a fused K-step window counts K, a verify
    # one): the numerator of dispatches_per_token
    model_passes = counter_attr()
    # fault-plane counters (serving/faults.py)
    node_failures = counter_attr()
    node_joins = counter_attr()
    pages_quarantined_total = counter_attr()
    requests_recovered = counter_attr()
    tokens_recomputed = counter_attr()  # emitted tokens discarded by resets
    quarantined_served = counter_attr()  # MUST stay 0: stale-read guard hits

    def __init__(self, cfg, params, *, max_batch: int = 4,
                 page_size: int = 16, n_pages: int = 64,
                 max_len: int = 256, n_nodes: int = 1,
                 link_mode: str = "circuit", prefill_budget: float = 2.0,
                 fused: bool = True, max_window: int = 8,
                 prefix_cache: bool = False, spec_decode: bool = False,
                 spec_k=8, spec_ngram: int = 3,
                 spec_proposer: str = "device",
                 chunked_prefill: bool = False, chunk_tokens: int = 0,
                 fault_plan=None, trace: bool = False,
                 trace_capacity: int = 4096, mesh=None, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh: mesh-striped pools (Queue A item 7) are not ported "
                "yet; see ROADMAP.md")
        assert lm.paged_decodable(cfg), \
            f"{cfg.name} is not paged-decodable (attention-only, causal)"
        if spec_proposer not in ("device", "host"):
            raise ValueError(f"spec_proposer must be 'device' or 'host', "
                             f"got {spec_proposer!r}")
        want = resolve_device(device)
        self.device = params["embed"]["embed_table"].device
        if self.device.type != want.type or want.index not in (
                None, self.device.index):
            raise ValueError(f"params live on {self.device}, the engine "
                             f"was asked to run on {want}")
        self.registry = MetricsRegistry()
        self.tracer = StepTracer(capacity=trace_capacity) if trace else None
        self.cfg = cfg
        self.params = params
        self.page_size = page_size
        self.max_batch = max_batch
        self.max_len = max_len
        self.nmax = -(-max_len // page_size)
        self.fused = fused
        self.max_window = max(1, int(max_window))
        self.spec = None
        self._spec_host = spec_proposer == "host"
        if spec_decode:
            # "auto": adapt K per tenant from its acceptance EWMA, with
            # headroom to draft past max_window (a deep verify is still
            # one pass)
            if spec_k == "auto":
                self.spec = NGramSpec(
                    k=max(2 * self.max_window - 1, 3), max_n=spec_ngram,
                    adaptive=True)
            else:
                self.spec = NGramSpec(k=int(spec_k), max_n=spec_ngram)
        self.alloc = PageAllocator(n_pages=n_pages, page_size=page_size,
                                   n_nodes=n_nodes, registry=self.registry)
        self.cache = None
        if prefix_cache:
            self.cache = PrefixCache(self.alloc, registry=self.registry)
            # under pool pressure, LRU-evict cold cache pages before the
            # scheduler resorts to preempting tenants
            self.alloc.reclaim = self.cache.evict
        self.link_mode = link_mode
        self.n_nodes = n_nodes
        self.decode_estimate = _estimate(
            cfg, link_mode, n_nodes,
            ShapeConfig("serve_decode", max_len, max_batch, "decode"))
        self.sched = ContinuousBatchScheduler(
            self.alloc, max_batch,
            prefill_cost_s=functools.partial(_prefill_cost, cfg, link_mode,
                                             n_nodes),
            decode_cost_s=self.decode_estimate.step_time_s,
            prefill_budget=prefill_budget, prefix_cache=self.cache,
            chunked=chunked_prefill, chunk_tokens=chunk_tokens,
            registry=self.registry, tracer=self.tracer)
        self.pools = lm.init_paged_caches(cfg, n_pages=n_pages,
                                          page_size=page_size,
                                          device=self.device)
        self._prefill = steps_mod.make_paged_prefill_step(cfg)
        self._serve = steps_mod.make_paged_serve_step(cfg)
        self._scan = steps_mod.make_paged_serve_scan(cfg)
        self._suffix = steps_mod.make_paged_suffix_prefill(cfg)
        self._chunk = steps_mod.make_chunk_prefill(cfg)
        self._verify = steps_mod.make_verify_window(cfg)
        self._spec_step = steps_mod.make_spec_draft_verify(cfg)
        self._copy_page = steps_mod.make_page_copy()
        # KV bytes one token occupies across the whole stack (k + v, every
        # layer): the unit behind the bytes_deduped gauge
        self.kv_bytes_per_token = (cfg.n_layers * 2 * cfg.n_kv_heads
                                   * cfg.head_dim
                                   * nn.dt(cfg.activation_dtype).itemsize)
        # host MIRROR of slot state; the device copies are authoritative
        # between window boundaries
        self.block_tables = np.full((max_batch, self.nmax), NULL_PAGE,
                                    np.int32)
        self.tokens = np.zeros((max_batch, 1), np.int32)
        self.pos = np.zeros((max_batch,), np.int32)
        self.active = np.zeros((max_batch,), np.int32)
        self.d_tokens = self._dev(self.tokens)
        self.d_pos = self._dev(self.pos)
        self.d_block = self._dev(self.block_tables)
        self.d_active = self._dev(self.active)
        self._dirty = False
        self._dirty_block = False
        # dirty-tracking signature per slot: (rid, preemptions, n_pages)
        self._slot_sig: List[Optional[tuple]] = [None] * max_batch
        # device-resident token histories for speculative drafting: row s
        # holds slot s's prompt+output tokens, appended on the device by
        # the draft+verify chain.  _hist_state[s] = ((rid, preemptions),
        # device-valid length) decides when a row must be pushed
        self.d_hist = torch.zeros((max_batch, max_len), dtype=torch.int32,
                                  device=self.device) \
            if self.spec is not None else None
        self._hist_state: List[Optional[tuple]] = [None] * max_batch
        self._n_submitted = 0
        # seed every registry counter key (descriptors write through)
        self.steps_run = 0
        self.windows_run = 0
        self.decode_steps = 0
        self.decode_tokens = 0
        self.tokens_emitted = 0
        self.decode_time_s = 0.0
        self.spec_time_s = 0.0
        self.h2d_syncs = 0
        self.d2h_syncs = 0
        self.block_row_writes = 0
        self.peak_pages = 0
        self.prefill_tokens = 0
        self.chunk_dispatches = 0
        self.model_passes = 0
        self.node_failures = 0
        self.node_joins = 0
        self.pages_quarantined_total = 0
        self.requests_recovered = 0
        self.tokens_recomputed = 0
        self.quarantined_served = 0
        # dispatch-span predictions, memoized: (seconds, joules across the
        # fleet) per prefill-shaped width
        self._pred_cache: Dict[int, tuple] = {}
        self.faults = None
        if fault_plan is not None:
            self.install_faults(fault_plan)
        self.t0 = time.time()

    def install_faults(self, plan) -> None:
        """Attach a :class:`~repro_torch.serving.faults.FaultPlan`; its
        step 0 is the *current* scheduler step, so install after warmup
        and ``reset_metrics`` to keep warmup traffic out of the chaos
        window.  The plane holds the engine's registry, never the engine
        (``on_step`` takes it as an argument)."""
        self.faults = FaultPlane(plan, self.n_nodes,
                                 epoch=self.sched.step_idx,
                                 registry=self.registry)
        self.sched.transient_gate = self.faults.transient_gate

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """A device copy of a host array (never a view of the mirror)."""
        return torch.tensor(a, device=self.device)

    def reset_metrics(self):
        """Zero every counter/clock/digest (e.g. after a warmup pass)
        while keeping the pools and allocator state: the engine's,
        scheduler's, allocator's, prefix cache's and fault plane's
        counters and the histogram digests, so that warmup traffic never
        reaches chaos or SLO percentiles.  The prefix-cache tree is kept
        (``cache.clear()`` starts it cold); its counters restart.  The
        tracer's ring restarts too: an exported trace begins after the
        warmup."""
        self.registry.reset()
        self.sched.finished.clear()
        self._n_submitted = 0
        self.sched.shed.clear()
        self.sched.recovery_steps.clear()
        if self.spec is not None:
            self.spec.stats = SpecStats()
        if self.tracer is not None:
            self.tracer.reset()
        self.t0 = time.time()

    # -- predicted-vs-measured attribution (telemetry spans) ---------------
    # The pools are one tensor on one device, so no dispatch moves KV
    # between stripes: the reference's predicted interconnect share of a
    # span is 0 here (a mesh, ROADMAP Queue A item 7, brings it)
    def _predict_prefill(self, n_tokens: int) -> tuple:
        """(predicted seconds, predicted joules across the fleet) for one
        prefill-shaped pass of ``n_tokens``: prices prefill, suffix
        prefill, chunk and verify widths.  Memoized per width."""
        n = max(int(n_tokens), 1)
        hit = self._pred_cache.get(n)
        if hit is None:
            est = _estimate(self.cfg, self.link_mode, self.n_nodes,
                            ShapeConfig("serve_prefill", n, 1, "prefill"))
            hit = self._pred_cache[n] = (est.step_time_s,
                                         est.energy.total_j * self.n_nodes)
        return hit

    def _predict_scan(self, k: int) -> tuple:
        """(seconds, joules) for a fused K-step decode window: K times the
        admission-priced decode step."""
        return (k * self.sched.decode_cost_s,
                k * self.decode_estimate.energy.total_j * self.n_nodes)

    def _predict_cow(self) -> tuple:
        """(seconds, joules) for one device page copy: read + write one
        page of KV through HBM (no FLOPs)."""
        nbytes = 2 * self.page_size * self.kv_bytes_per_token
        secs = nbytes / HBM_BW
        return secs, step_energy(flops_per_chip=0.0,
                                 hbm_bytes_per_chip=nbytes,
                                 ici_bytes_per_chip=0.0,
                                 step_seconds=secs).total_j

    _NULLCTX = contextlib.nullcontext()

    def _span(self, phase: str, predfn, **extra):
        """Dispatch-span context: a no-op when tracing is off (``predfn``
        is never called: no cost-model work), else a
        :meth:`StepTracer.dispatch` span stamped with the current step
        and the cost engine's (seconds, joules) prediction.  The span
        times its body on the host clock; it adds no device sync."""
        if self.tracer is None:
            return self._NULLCTX
        ps, pj = predfn()
        return self.tracer.dispatch(phase, self.sched.step_idx,
                                    predicted_s=ps, predicted_j=pj, **extra)

    def _flight_dump(self, reason: str) -> Optional[str]:
        """Invariant-violation post-mortem: dump the flight recorder's
        last spans and a registry snapshot before the caller raises.  No
        tracer armed: no dump (never mask the original error)."""
        if self.tracer is None:
            return None
        try:
            path = self.tracer.flight_dump(reason, registry=self.registry)
        except OSError:
            return None
        print(f"[flight-recorder] dumped last {len(self.tracer.spans)} "
              f"spans to {path}")
        return path

    # -- request intake ----------------------------------------------------
    def submit(self, prompt, gen: int, *, tenant: str = "default",
               rid: Optional[str] = None, slo: str = "standard") -> Request:
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.shape[0] == 0:
            raise ValueError(
                "empty prompt: zero-length requests are rejected at "
                "submit (a prompt needs >= 1 token to prefill a first "
                "logit)")
        assert prompt.shape[0] + gen <= self.max_len
        rid = rid or f"r{self._n_submitted}"
        self._n_submitted += 1
        key = tuple(int(t) for t in prompt) if self.cache is not None \
            else None
        req = Request(rid=rid, prompt_len=int(prompt.shape[0]), gen=gen,
                      tenant=tenant, prompt=prompt, prompt_key=key, slo=slo)
        self.sched.submit(req)
        return req

    # -- node failure / re-join (the fault plane's engine half) ------------
    def fail_node(self, node: int) -> set:
        """A stripe of the page pool went dark: quarantine its pages,
        invalidate the prefix-cache subtrees that lived on them, reset
        every running or prefilling request whose block table touches them
        (exact greedy recompute through whatever cache survived), and
        shed requests the shrunken pool can never fit again.  Idempotent
        per down node.  Called by the fault plane's watchdog; callable
        directly by tests and operators."""
        quar = self.alloc.fail_node(node)
        if not quar:
            return quar
        self.node_failures += 1
        self.pages_quarantined_total += len(quar)
        if self.cache is not None:
            # tree-wide: a lost interior page strands its whole subtree
            self.cache.invalidate_pages(quar)
        victims = [r for r in (list(self.sched.running.values())
                               + list(self.sched.prefilling.values()))
                   if not quar.isdisjoint(self.alloc.held.get(r.rid, ()))]
        for req in victims:
            self.tokens_recomputed += len(req.tokens)
            self.sched.fault_reset(req)
        self.requests_recovered += len(victims)
        self.sched.shed_infeasible(self.alloc.allocatable_pages)
        self._assert_no_quarantined()
        return quar

    def join_node(self, node: int) -> int:
        """Elastic re-join: the node's quarantined pages return to the
        striped free lists.  Returns how many pages rejoined."""
        was_down = node in self.alloc.failed_nodes
        restored = self.alloc.restore_node(node)
        if was_down:
            self.node_joins += 1
        return restored

    def _assert_no_quarantined(self) -> None:
        """The never-re-served invariant: after recovery, no live block
        table references a quarantined page."""
        quar = self.alloc.quarantined
        if not quar:
            return
        for req in (list(self.sched.running.values())
                    + list(self.sched.prefilling.values())):
            bad = quar.intersection(self.alloc.held.get(req.rid, ()))
            if bad:
                self.quarantined_served += 1
                self._flight_dump("quarantined-served")
                raise RuntimeError(
                    f"request {req.rid} still references quarantined "
                    f"pages {sorted(bad)} after recovery")

    # -- host mirror maintenance -------------------------------------------
    def _block_row(self, rid: str) -> np.ndarray:
        row = np.full((self.nmax,), NULL_PAGE, np.int32)
        pages = self.alloc.held[rid]
        if self.alloc.quarantined \
                and not self.alloc.quarantined.isdisjoint(pages):
            # a quarantined page about to be served is a recovery bug,
            # never a runtime condition: fail fast, count the hit (the
            # page's stale KV is still on the device)
            self.quarantined_served += 1
            bad = sorted(self.alloc.quarantined.intersection(pages))
            self._flight_dump("stale-block-row")
            raise RuntimeError(
                f"block row for {rid} references quarantined pages {bad}")
        row[:len(pages)] = pages
        return row

    def _sig(self, req: Request) -> tuple:
        return (req.rid, req.preemptions, len(self.alloc.held[req.rid]))

    def _clear_slot(self, slot: int):
        self.block_tables[slot] = NULL_PAGE
        self.tokens[slot] = 0
        self.pos[slot] = 0
        self.active[slot] = 0
        self._slot_sig[slot] = None
        self._hist_state[slot] = None
        self._dirty = True
        self._dirty_block = True

    def _clear_vacated(self):
        """Null every mirror slot that no running request holds.  A slot
        is occupied while its active flag is set; its signature alone
        would miss a speculating request whose rejected drafts made the
        window forget the signature and which was then preempted or
        reset before the next refresh: its stale row, naming pages since
        freed, quarantined or reallocated, would stay active in the next
        scan.  (The reference keys this on the signature.)"""
        for slot in range(self.max_batch):
            if slot not in self.sched.running and self.active[slot]:
                self._clear_slot(slot)

    def _occupy_slot(self, req: Request, row: np.ndarray, token: int):
        self.block_tables[req.slot] = row
        self.tokens[req.slot] = token
        self.pos[req.slot] = req.pos
        self.active[req.slot] = 1
        self._slot_sig[req.slot] = self._sig(req)
        self.block_row_writes += 1
        self._dirty = True
        self._dirty_block = True

    def _refresh_slots(self):
        """Re-sync the mirror with scheduler state, rewriting only block
        rows whose page set changed (admission/growth/preemption)."""
        for slot, req in self.sched.running.items():
            sig = self._sig(req)
            if self._slot_sig[slot] != sig:
                self.block_tables[slot] = self._block_row(req.rid)
                self._slot_sig[slot] = sig
                self.block_row_writes += 1
                self._dirty = True
                self._dirty_block = True
            last = req.tokens[-1] if req.tokens else 0
            if self.tokens[slot, 0] != last:
                self.tokens[slot, 0] = last
                self._dirty = True
            if self.pos[slot] != req.pos:
                self.pos[slot] = req.pos
                self._dirty = True
            if not self.active[slot]:
                self.active[slot] = 1
                self._dirty = True

    def _push(self, force: bool = False):
        """One host->device sync event covering the whole slot-state
        bundle (tokens, positions, block tables, active mask)."""
        if not (self._dirty or force):
            return
        self.d_tokens = self._dev(self.tokens)
        self.d_pos = self._dev(self.pos)
        self.d_block = self._dev(self.block_tables)
        self.d_active = self._dev(self.active)
        self.h2d_syncs += 1
        self._dirty = False
        self._dirty_block = False

    def _push_block(self):
        """Push only the block tables (the one array a pure-verify
        window reads): steady-state speculation syncs nothing but page
        growth."""
        if not self._dirty_block:
            return
        self.d_block = self._dev(self.block_tables)
        self.h2d_syncs += 1
        self._dirty_block = False

    def _sync_hist(self, slot: int, req: Request):
        """Ensure the slot's device history row covers the request's
        current ``pos + 1`` tokens (prompt + emitted so far).  The fused
        draft+verify appends emissions on the device, so in steady state
        this is a no-op; a push happens only when the row is behind —
        slot reuse, preemption/recompute, or a scan window having
        advanced the request host-side."""
        need = req.pos + 1
        key = (req.rid, req.preemptions)
        st = self._hist_state[slot]
        if st is not None and st[0] == key and st[1] >= need:
            return
        row = np.zeros((self.max_len,), np.int32)
        hist = [int(t) for t in req.prompt] + [int(t) for t in req.tokens]
        row[:len(hist)] = hist
        self.d_hist[slot] = self._dev(row)
        self.h2d_syncs += 1
        self._hist_state[slot] = (key, len(hist))

    # -- warmup ------------------------------------------------------------
    def window_sizes(self) -> List[int]:
        """The power-of-two window buckets this engine will dispatch."""
        if not self.fused:
            return [1]
        sizes, k = [], 1
        while k <= self.max_window:
            sizes.append(k)
            k *= 2
        return sizes

    def warmup_prefix(self, prompt_len: int, shared_prefix: int,
                      seed: int = 424242):
        """Run the cache-hit path once for prompts of this shape: one miss
        (full prefill) followed by one hit sharing ``shared_prefix``
        tokens, which dispatches the COW page copy and the pow2 suffix
        bucket ``_do_prefill`` will pick.  Call before
        ``reset_metrics``/``cache.clear()``: both warm requests run to
        completion and their pages/stats are the caller's to reset."""
        if self.cache is None or shared_prefix <= 0:
            return
        sp = min(shared_prefix, prompt_len)
        gen = max(1, min(2, self.max_len - prompt_len))
        rng = np.random.default_rng(seed)
        base = rng.integers(2, self.cfg.vocab_size, prompt_len,
                            dtype=np.int32)
        self._n_warm = getattr(self, "_n_warm", 0) + 1
        self.submit(base, gen, rid=f"warmsfx{self._n_warm}a")
        self.run()
        variant = base.copy()
        if sp < prompt_len:
            variant[sp:] = rng.integers(2, self.cfg.vocab_size,
                                        prompt_len - sp, dtype=np.int32)
        self.submit(variant, gen, rid=f"warmsfx{self._n_warm}b")
        self.run()

    def verify_buckets(self) -> List[int]:
        """The pow2 verify widths speculation will dispatch: the same
        ``_pow2_ceil`` rule the runtime applies to drafts of 1..spec_k
        tokens plus the last emitted token."""
        if self.spec is None:
            return []
        return sorted({self._pow2_ceil(m + 1)
                       for m in range(1, self.spec.k + 1)})

    def warmup_windows(self):
        """Run every window bucket (and, with speculation on, every
        verify bucket) once against inactive slots and null rows (their
        writes land on the null page, masked by design)."""
        dev = self.device
        null_rows = torch.full((self.max_batch, self.nmax), NULL_PAGE,
                               dtype=torch.int32, device=dev)
        if self.fused or self.spec is not None:
            zeros_tok = torch.zeros((self.max_batch, 1), dtype=torch.int32,
                                    device=dev)
            zeros_pos = torch.zeros((self.max_batch,), dtype=torch.int32,
                                    device=dev)
            inactive = zeros_pos
            for k in self.window_sizes():
                toks, _, _, self.pools = self._scan(
                    self.params, zeros_tok, self.pools, null_rows, zeros_pos,
                    inactive, k=k)
                toks.cpu()
            self._dirty = True        # device state was clobbered
        if self.spec is not None and not self._spec_host:
            # the fused draft+verify chain at every verify width; it
            # writes history row 0, so every row is marked stale
            zero = torch.zeros((), dtype=torch.int32, device=dev)
            for w in self.verify_buckets():
                emit, _, _, self.d_hist, self.pools = self._spec_step(
                    self.params, self.d_hist, self.pools, null_rows, zero,
                    zero, zero + (w - 1), W=w, max_n=self.spec.max_n,
                    min_n=self.spec.min_n)
                emit.cpu()
            self.d_hist[0] = 0
            self._hist_state = [None] * self.max_batch
        elif self.spec is not None:
            for w in self.verify_buckets():
                logits, self.pools = self._verify(
                    self.params,
                    torch.zeros((1, w), dtype=torch.int32, device=dev),
                    self.pools, null_rows[0], 0, 1)
                logits.cpu()

    # -- prefill (full, or cached-prefix COW + suffix) ---------------------
    def _cow(self, req: Request):
        """Diverging inside a shared page: copy it into the request's
        private page before any write can touch it."""
        match = req.prefix_match
        dst = self.alloc.held[req.rid][req.cached_tokens // self.page_size]
        with self._span("cow_copy", self._predict_cow, rid=req.rid):
            self.pools = self._copy_page(self.pools, int(match.cow_src),
                                         int(dst))
        self.cache.stats.cow_copies += 1
        self.cache.release_cow(match)

    def _do_prefill(self, req: Request, row: np.ndarray) -> int:
        """Write the request's prompt KV and return its first greedy
        token.  On a prefix-cache hit the cached prefix is skipped: the
        block row already points at the shared pages, the divergence page
        (if the match ends mid-page) is copied, and only the uncached
        suffix runs, padded to a power-of-two width."""
        L = req.cached_tokens
        match = req.prefix_match
        if self.cache is None or L <= 0:
            with self._span("prefill",
                            lambda: self._predict_prefill(req.prompt_len),
                            rid=req.rid, tokens=req.prompt_len):
                logits, self.pools = self._prefill(
                    self.params, self._dev(req.prompt[None]), self.pools,
                    self._dev(row))
                self.h2d_syncs += 1    # prompt + block row push
                self.model_passes += 1
                tok = int(logits.argmax(-1)[0, 0])
                self.d2h_syncs += 1    # blocking first-token pull
            self.prefill_tokens += req.prompt_len
            return tok
        if match is not None and match.cow_src is not None:
            self._cow(req)
        suffix = np.asarray(req.prompt[L:], np.int32)
        slen = int(suffix.shape[0])
        k = self._pow2_ceil(slen)
        padded = np.zeros((1, k), np.int32)
        padded[0, :slen] = suffix
        with self._span("prefill", lambda: self._predict_prefill(k),
                        rid=req.rid, tokens=slen, cached=L):
            logits, self.pools = self._suffix(
                self.params, self._dev(padded), self.pools, self._dev(row),
                L, slen)
            self.h2d_syncs += 1        # suffix + block row push
            self.model_passes += 1
            tok = int(logits.argmax(-1)[0, 0])
            self.d2h_syncs += 1        # blocking first-token pull
        self.prefill_tokens += slen
        return tok

    # -- chunked prefill (page-aligned slices between decode windows) ------
    def _begin_chunked(self, req: Request):
        """Chunked admission: no model pass yet — only the COW copy when
        the prefix-cache match diverges mid-page, as :meth:`_do_prefill`'s
        hit branch would make it.  The block row rides into each chunk
        pass directly (the device mirror never sees a prefilling slot)."""
        match = req.prefix_match
        if self.cache is not None and match is not None \
                and match.cow_src is not None:
            self._cow(req)

    def _do_chunk(self, req: Request, start: int, n: int) -> Optional[int]:
        """Run ONE page-aligned prefill chunk — positions ``start ..
        start+n-1`` — padded to a pow2 width.  Returns the first greedy
        token when this was the final chunk, else None (intermediate
        logits are never pulled: one d2h per request, not per chunk)."""
        row = self._block_row(req.rid)
        seg = np.asarray(req.prompt[start:start + n], np.int32)
        w = self._pow2_ceil(n)
        padded = np.zeros((1, w), np.int32)
        padded[0, :n] = seg
        final = start + n == req.prompt_len
        with self._span("chunk_prefill", lambda: self._predict_prefill(w),
                        rid=req.rid, tokens=n, start=start):
            logits, self.pools = self._chunk(
                self.params, self._dev(padded), self.pools, self._dev(row),
                start, n)
            self.h2d_syncs += 1        # chunk + block row push
            self.model_passes += 1
            self.chunk_dispatches += 1
            tok = None
            if final:
                tok = int(logits.argmax(-1)[0, 0])
                self.d2h_syncs += 1    # blocking first-token pull
        self.prefill_tokens += n
        return tok

    def _chunk_round(self, max_window: Optional[int]) -> List[Request]:
        """One chunk round: the scheduler's budgeted page-aligned slices
        for this window, run before decode, so a request whose final
        chunk lands here joins the very next decode window."""
        k_budget = self.max_window if max_window is None \
            else max(1, min(self.max_window, max_window))
        if not self.fused:
            k_budget = 1
        finished: List[Request] = []
        for req, start, n in self.sched.plan_chunks(k_budget):
            tok = self._do_chunk(req, start, n)
            if tok is None:
                continue
            row = self._block_row(req.rid)
            if self.cache is not None:
                # all prompt pages are immutable now: graft them, as the
                # monolithic path does right after prefill
                self.cache.insert(req.prompt_key, self.alloc.held[req.rid],
                                  req.prompt_len)
            self.sched.finish_prefill(req, tok)
            self.tokens_emitted += 1
            if req.state == "running":
                self._occupy_slot(req, row, tok)
            else:                      # gen == 1: finished at prefill
                finished.append(req)
        return finished

    # -- one engine step (a window of >= 1 scheduler steps) ----------------
    @staticmethod
    def _pow2_floor(k: int) -> int:
        # bucket to the largest power of two <= k
        return 1 << (max(k, 1).bit_length() - 1)

    @staticmethod
    def _pow2_ceil(n: int) -> int:
        # smallest power of two >= n: the one bucket rule of the suffix
        # widths, the chunk widths and the verify widths
        return 1 << max(n - 1, 0).bit_length()

    def _pick_window(self, max_window: Optional[int]) -> int:
        cap = self.max_window if max_window is None \
            else max(1, min(self.max_window, max_window))
        return self.sched.safe_horizon(cap, quantize=self._pow2_floor)

    def _spec_gate(self, active: Dict[int, Request],
                   ks: Dict[int, int], kk_est: int) -> Dict[int, int]:
        """The priced worth-it gate: a verify pass is bought only where
        the tokens it is *expected* to emit — ``e = 1 + accept_EWMA *
        K`` — beat the fused scan it displaces, on the cost engine's own
        seconds (``sched.decode_cost_s`` / ``sched.prefill_cost_s``).

        * pure speculation — every slot drafts, so the verifies replace
          the scan outright: worth it iff ``sum(e) * t_scan > B * kk *
          sum(t_verify)``;
        * mixed — the scan runs anyway for the other slots, so a
          drafting slot must clear ``(e_s - kk) * t_scan > t_verify_s *
          B * kk``.
        """
        if not ks:
            return ks
        price = getattr(self.sched, "prefill_cost_s", None)
        scan_s = kk_est * float(self.sched.decode_cost_s or 0.0)
        if price is None or scan_s <= 0.0:
            return dict(ks)            # unpriced scheduler: keep drafts
        n = len(active)
        e = {s: 1.0 + self.spec.rate_for(active[s].tenant) * K
             for s, K in ks.items()}
        tv = {s: float(price(self._pow2_ceil(K + 1)))
              for s, K in ks.items()}
        if len(ks) == n and sum(e.values()) * scan_s \
                > n * kk_est * sum(tv.values()):
            return dict(ks)
        return {s: K for s, K in ks.items()
                if (e[s] - kk_est) * scan_s > tv[s] * n * kk_est}

    def _spec_window(self, max_window: Optional[int]) -> List[Request]:
        """One speculative decode window.

        Each running slot asks its tenant's controller for a draft depth
        K clamped to the scheduler's ``safe_horizon`` (exact page
        reservation: a verify may write any horizon position); the
        priced gate keeps the verifies worth buying.  The other slots
        ride one fused scan with the speculating slots masked to null
        rows.  Device proposer: one draft+verify chain per slot with one
        pull of ``(emitted, n_emit, m)``; host proposer: a host n-gram
        draft and a padded verify.  Rejected drafts roll their whole
        pages back (``PageAllocator.truncate_to``) and forget the slot
        signature (pop-then-regrow can alias page counts)."""
        finished: List[Request] = []
        cap = max(self.max_window, self.spec.k + 1)
        if max_window is not None:
            cap = max(1, min(cap, max_window))
        k = self.sched.safe_horizon(cap)
        self._refresh_slots()
        active = dict(self.sched.running)
        ks: Dict[int, int] = {}
        host_drafts: Dict[int, List[int]] = {}
        for slot, req in active.items():
            K = self.spec.draft_k(req.tenant, k)
            if K < 1:
                continue
            if self._spec_host:
                d = self.spec.propose(req.prompt, req.tokens, K)
                if not d:
                    continue          # no match: ride the scan
                host_drafts[slot] = d
                ks[slot] = len(d)
            else:
                ks[slot] = K          # draft length found on the device
        kk_est = self._pow2_floor(min(k, self.max_window)) if self.fused \
            else 1
        ks = self._spec_gate(active, ks, kk_est)
        host_drafts = {s: d for s, d in host_drafts.items() if s in ks}
        scan_slots = [s for s in active if s not in ks]
        t_dec = time.time()
        advanced = 0          # scheduler-clock steps complete_step took
        emitted_max = 0       # largest per-slot emission this window
        tok_np = None
        if scan_slots:
            kk = kk_est
            if ks:
                # ONE sync event: canonical tokens/pos plus this window's
                # masked rows/mask (speculating slots write the null
                # page); the canonical d_block/d_active stay host-side
                bt = self.block_tables.copy()
                act = self.active.copy()
                for s in ks:
                    bt[s] = NULL_PAGE
                    act[s] = 0
                self.d_tokens = self._dev(self.tokens)
                self.d_pos = self._dev(self.pos)
                d_bt, d_act = self._dev(bt), self._dev(act)
                self.h2d_syncs += 1
            else:
                self._push(force=not self.fused)
                d_bt, d_act = self.d_block, self.d_active
            with self._span("scan", lambda: self._predict_scan(kk),
                            k=kk, slots=len(scan_slots)):
                toks, d_tok, d_pos, self.pools = self._scan(
                    self.params, self.d_tokens, self.pools, d_bt, self.d_pos,
                    d_act, k=kk)
                tok_np = toks.cpu().numpy().reshape(self.max_batch, kk)
            self.d2h_syncs += 1
            self.decode_steps += kk
            self.model_passes += kk
            self.windows_run += 1
            for j in range(kk):
                emitted: Dict[int, int] = {s: int(tok_np[s, j])
                                           for s in scan_slots}
                self.decode_tokens += len(emitted)
                self.tokens_emitted += len(emitted)
                finished += self.sched.complete_step(emitted)
            advanced = emitted_max = kk
            if not ks:
                # pure scan window: adopt the device carry, as the plain
                # fused path does
                self.d_tokens, self.d_pos = d_tok, d_pos
        st = self.spec.stats
        if ks and not self._spec_host:
            # device chain inputs: history rows for any slot that fell
            # behind, plus page growth
            for slot in sorted(ks):
                self._sync_hist(slot, active[slot])
            self._push_block()
        for slot in sorted(ks):
            req = active[slot]
            K = ks[slot]
            t_sp = time.time()
            if self._spec_host:
                d = host_drafts[slot]
                m = len(d)
                W = self._pow2_ceil(m + 1)
                padded = np.zeros((1, W), np.int32)
                padded[0, 0] = req.tokens[-1]
                padded[0, 1:m + 1] = d
                with self._span("draft_verify",
                                lambda: self._predict_prefill(W),
                                rid=req.rid, k=K, width=W):
                    logits, self.pools = self._verify(
                        self.params, self._dev(padded), self.pools,
                        self._dev(self.block_tables[slot]), req.pos, m + 1)
                    self.h2d_syncs += 1   # draft + block row push
                    greedy = logits[0, :m + 1].argmax(-1).cpu().numpy()
                    self.d2h_syncs += 1   # blocking verdict pull
                out = self.spec.accept(d, greedy)   # updates stats
            else:
                W = self._pow2_ceil(K + 1)
                with self._span("draft_verify",
                                lambda: self._predict_prefill(W),
                                rid=req.rid, k=K, width=W):
                    # slot, start and K as 0-d device tensors, in one copy
                    args = self._dev(np.asarray([slot, req.pos, K],
                                                np.int32))
                    emit_d, n_emit_d, m_d, self.d_hist, self.pools = \
                        self._spec_step(self.params, self.d_hist, self.pools,
                                        self.d_block, args[0], args[1],
                                        args[2], W=W, max_n=self.spec.max_n,
                                        min_n=self.spec.min_n)
                    # one blocking verdict pull: (emitted, n_emit, m)
                    got = torch.cat([emit_d, n_emit_d.reshape(1),
                                     m_d.reshape(1)]).cpu().numpy()
                    n_emit, m = int(got[W]), int(got[W + 1])
                    self.d2h_syncs += 1
                out = [int(t) for t in got[:n_emit]]
                st.drafted += m
                st.accepted += n_emit - 1
                st.verifies += 1
            self.spec_time_s += time.time() - t_sp
            st.k_requested += K
            self.spec.observe(req.tenant, m, len(out) - 1)
            self.decode_steps += 1
            self.model_passes += 1
            self.windows_run += 1         # a verify is a device call
            self.decode_tokens += len(out)
            self.tokens_emitted += len(out)
            finished += self.sched.complete_spec(req, out)
            if req.state == "running" and len(out) <= m:
                # rejected drafts: release their whole pages (the kept
                # tail page's stale slots are masked by position)
                if self.alloc.truncate_to(req.rid, req.pos):
                    st.rollbacks += 1
                # pop-then-regrow can restore the same page COUNT with
                # other pages: the next refresh must rewrite the row
                self._slot_sig[req.slot] = None
            if not self._spec_host:
                # the chain appended the emission on the device: the row
                # covers exactly pos+1 verified tokens again
                self._hist_state[slot] = ((req.rid, req.preemptions),
                                          req.pos + 1)
            emitted_max = max(emitted_max, len(out))
        if ks:
            # the device carry is stale for speculating slots (and the
            # scan saw masked rows): fold the mirror, re-push next window
            for slot, req in self.sched.running.items():
                self.tokens[slot, 0] = req.tokens[-1] if req.tokens else 0
                self.pos[slot] = req.pos
            self._dirty = True
        elif tok_np is not None:
            for slot, req in self.sched.running.items():
                self.tokens[slot, 0] = int(tok_np[slot, advanced - 1])
                self.pos[slot] = req.pos
        self.decode_time_s += time.time() - t_dec
        # the window consumed max(scan depth, deepest verified emission)
        # scheduler-clock steps; complete_step already advanced `advanced`
        self.sched.step_idx += max(emitted_max - advanced, 0)
        self.steps_run += max(emitted_max, 1)
        return finished

    def step(self, max_window: Optional[int] = None) -> List[Request]:
        """Plan, prefill admissions (or run a chunk round), decode one
        fused window (or one step when ``fused=False``, or a speculative
        window).  ``max_window`` additionally caps this window (e.g. to
        the next trace arrival).  Returns requests finished this
        window."""
        if self.faults is not None:
            # watchdog tick BEFORE planning: detections quarantine pages
            # and reset victims, so this step's plan sees the degraded
            # pool and never dispatches against a dead stripe
            self.faults.on_step(self)
        plan = self.sched.plan_step()
        finished: List[Request] = []
        self._clear_vacated()           # preempted/reset slots -> null
        for req in plan.admitted:
            if self.sched.chunked:
                self._begin_chunked(req)   # COW only; chunks do the rest
                continue
            row = self._block_row(req.rid)
            tok = self._do_prefill(req, row)
            if self.cache is not None:
                # the prompt's full pages are immutable from this moment:
                # graft them so later arrivals share them
                self.cache.insert(req.prompt_key, self.alloc.held[req.rid],
                                  req.prompt_len)
            self.sched.note_first_token(req, tok)
            self.tokens_emitted += 1
            if req.state == "running":     # gen > 1: occupy the slot
                self._occupy_slot(req, row, tok)
            else:                          # gen == 1: finished at prefill
                finished.append(req)
        if self.sched.chunked and self.sched.prefilling:
            # budgeted chunk round BEFORE the decode window
            finished += self._chunk_round(max_window)
        if self.sched.running and self.spec is not None:
            finished += self._spec_window(max_window)
        elif self.sched.running:
            k = self._pick_window(max_window) if self.fused else 1
            self._refresh_slots()
            active = dict(self.sched.running)
            t_dec = time.time()
            with self._span("scan", lambda: self._predict_scan(k),
                            k=k, slots=len(active)):
                if self.fused:
                    self._push()
                    toks, self.d_tokens, self.d_pos, self.pools = \
                        self._scan(self.params, self.d_tokens, self.pools,
                                   self.d_block, self.d_pos, self.d_active,
                                   k=k)
                else:
                    # per-step path: push the whole bundle and pull one
                    # token per scheduler step — O(1) syncs per token
                    self._push(force=True)
                    toks, _, self.pools = self._serve(
                        self.params, self.d_tokens, self.pools,
                        self.d_block, self.d_pos)
                tok_np = toks.cpu().numpy()   # blocks: decode-only timing
            self.d2h_syncs += 1
            self.decode_time_s += time.time() - t_dec
            tok_np = tok_np.reshape(self.max_batch, k)
            self.decode_steps += k
            self.model_passes += k
            self.windows_run += 1
            for j in range(k):
                emitted: Dict[int, int] = {s: int(tok_np[s, j])
                                           for s in active}
                self.decode_tokens += len(emitted)
                self.tokens_emitted += len(emitted)
                finished += self.sched.complete_step(emitted)
            # fold the window's results back into the mirror; slots that
            # stayed running now match the device carry exactly
            for slot, req in self.sched.running.items():
                self.tokens[slot, 0] = int(tok_np[slot, k - 1])
                self.pos[slot] = req.pos
            self.steps_run += k
        else:
            self.sched.step_idx += 1
            self.steps_run += 1
        self._clear_vacated()           # finished slots -> null
        self.peak_pages = max(self.peak_pages, self.alloc.pages_in_use)
        if self.tracer is not None:
            # per-node occupancy counter track (Perfetto stacked counters)
            self.tracer.counter_sample(self.sched.step_idx,
                                       self.alloc.occupancy_by_node())
        return finished

    def run(self, max_steps: int = 100_000) -> List[Request]:
        """Step until every submitted request finished."""
        while (self.sched.waiting or self.sched.running
               or self.sched.prefilling) and self.steps_run < max_steps:
            self.step()
        if self.sched.waiting or self.sched.running or self.sched.prefilling:
            raise RuntimeError(
                f"engine wedged: {len(self.sched.waiting)} waiting / "
                f"{len(self.sched.prefilling)} prefilling / "
                f"{len(self.sched.running)} running after {max_steps} steps")
        assert self.sched.conserved(self._n_submitted)
        return self.sched.finished

    # -- observability -----------------------------------------------------
    def metrics(self) -> dict:
        fin = self.sched.finished
        dt = max(time.time() - self.t0, 1e-9)
        ttft_d = HistogramDigest.of(
            r.first_token_step - r.arrived_step for r in fin
            if r.first_token_step is not None)
        emitted = self.tokens_emitted
        out = {
            "finished": len(fin),
            "wall_s": dt,
            "decode_s": self.decode_time_s,
            "tokens_out": emitted,
            "tokens_finished": sum(len(r.tokens) for r in fin),
            "steps": self.steps_run,
            "windows": self.windows_run,
            "tok_per_s": emitted / dt,
            "decode_step_s": self.decode_time_s / max(self.decode_steps, 1),
            "decode_tok_per_s": self.decode_tokens
            / max(self.decode_time_s, 1e-9),
            "h2d_syncs": self.h2d_syncs,
            "d2h_syncs": self.d2h_syncs,
            "syncs_per_token": (self.h2d_syncs + self.d2h_syncs)
            / max(emitted, 1),
            "block_row_writes": self.block_row_writes,
            "model_passes": self.model_passes,
            "dispatches_per_token": self.model_passes / max(emitted, 1),
            "ttft_steps_mean": ttft_d.mean,
            "ttft_steps_p95": ttft_d.percentile(95),
            "ttft_steps_p99": ttft_d.percentile(99),
            "pages_in_use": self.alloc.pages_in_use,
            "peak_pages": self.peak_pages,
            "page_occupancy": self.peak_pages / max(self.alloc.n_pages - 1,
                                                    1),
            "preemptions": sum(r.preemptions
                               for r in self.sched.all_requests),
            "prefill_tokens": self.prefill_tokens,
            # fault plane: quarantine footprint, recovery work, and the
            # reset -> first-token latency tail (the registry's digest)
            "node_failures": self.node_failures,
            "node_joins": self.node_joins,
            "pages_quarantined": self.pages_quarantined_total,
            "pages_quarantined_now": self.alloc.pages_quarantined,
            "requests_recovered": self.requests_recovered,
            "requests_shed": len(self.sched.shed),
            "tokens_recomputed": self.tokens_recomputed,
            "transient_rejections": self.sched.transient_rejections,
            "quarantined_served": self.quarantined_served,
            "recovery_steps_p50": self.registry.percentile(
                "recovery_steps", 50),
            "recovery_steps_p99": self.registry.percentile(
                "recovery_steps", 99),
        }
        if self.sched.chunked:
            out.update({
                "chunk_dispatches": self.chunk_dispatches,
                "chunk_rounds": self.sched.chunk_rounds,
                "chunk_tasks": self.sched.chunk_tasks,
                "chunk_preemptions": self.sched.chunk_preemptions,
                "prefilling": len(self.sched.prefilling),
            })
        if self.spec is not None:
            s = self.spec.stats
            out.update({
                "spec_drafted": s.drafted,
                "spec_accepted": s.accepted,
                "spec_verifies": s.verifies,
                "spec_rollbacks": s.rollbacks,
                "accept_rate": s.accept_rate,
                "spec_k_mean": s.k_mean,
                "spec_verify_s": self.spec_time_s,
            })
        if self.cache is not None:
            out.update(self.cache.metrics())
            out["bytes_deduped"] = (self.cache.stats.tokens_cached
                                    * self.kv_bytes_per_token)
        return out
