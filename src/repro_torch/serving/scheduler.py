"""Swallow §III (farmer-worker, C3) + §VIII (nOS admission): the
continuous-batching scheduler.

What is reproduced: the farmer hands work to a fixed pool of compute
slots and refills a slot the moment it frees — here the "work" is one
decode step of one sequence, the slots are rows of the decode batch, and
the farmer refills them by prefilling waiting requests mid-flight.
Admission is priced, not guessed: each step spends at most
``prefill_budget x decode_cost_s`` seconds of prefill interference,
with both costs supplied by :func:`repro.core.costs.estimate` (the same
engine nOS uses for placement) so prefill bursts cannot starve decode
latency.

What is extrapolated: Swallow's farmer never revokes work; here page
pressure can *preempt* — the latest-arrived running request is evicted
(its pages freed, its generated tokens discarded) and re-queued for a
full recompute, vLLM-style.  Greedy decoding is deterministic, so a
preempted request's final output is unchanged — the conservation
property tests/test_serving.py pins down.

Prefix-cache integration (the §X-B sharing overlay,
:mod:`repro.serving.prefix_cache`): when a cache is attached, admission
is priced on *uncached* prefill tokens only (a request whose prompt is
mostly cached is nearly free to admit), matched pages are acquired as
shared references riding in the same ``held`` list as private pages,
and a finished request donates its now-immutable pages — including the
partially filled tail — to the cache before its references are
released.  Shared pages are non-reclaimable by preemption: preempting a
victim drops only its own references, so pages the cache (or another
tenant) still holds never return to the free list, and the pool-pressure
loop falls through to LRU cache eviction (``PageAllocator.reclaim``)
before killing further tenants.

Speculative decoding (:mod:`repro.serving.spec_decode`): the scheduler
records verified multi-token emissions through :meth:`complete_spec` —
each token in the batch is the greedy argmax at its position, so the
conservation and recompute-exactness properties are unchanged; only the
clock bookkeeping differs (the engine advances ``step_idx`` once per
window by the deepest per-slot emission).

Chunked prefill + SLO classes (the §III farmer made fair): with
``chunked=True`` a long prompt no longer stalls every decoding tenant
for its full duration.  Admitted requests enter a ``prefilling`` state
(slot held, pages fully allocated, KV filled page-aligned chunk by
chunk via :meth:`plan_chunks`), and the single ``prefill_budget`` scalar
is replaced by a *deadline-driven chunk budget*: each decode window
tolerates at most ``window_s * min(stall_frac)`` seconds of prefill
interference (both sides priced by :func:`repro.core.costs.estimate`,
the same engine nOS admission uses), distributed earliest-deadline-first
over per-tenant :class:`repro.serving.slo.SLOClass` targets.  Every
prefilling request is guaranteed at least one chunk per round regardless
of budget — progress is strict, so sustained overload cannot starve any
admitted request — and EDF over fixed deadlines keeps the waiting queue
starvation-free too.

Fault recovery (the robustness counterpart, :mod:`repro.serving.faults`):
node loss reuses the preemption machinery — a request whose block table
touches a quarantined page is reset to ``waiting`` through
:meth:`fault_reset` (greedy recompute is exact, so survivors' tokens are
bit-identical to a fault-free run), transient dispatch rejections
re-admit under capped exponential backoff (a backing-off head never
blocks later arrivals), and a pool shrunken by quarantine degrades
gracefully: requests that can never fit again are shed batch-class
first (:meth:`shed_infeasible`), and while any page is quarantined the
preemption victim rule prefers lower-priority SLO classes so batch
tenants absorb the pressure before interactive ones.

Pure host-side state machine: no jax imports.  The engine applies the
returned plan to device arrays.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.serving.paged_kv import PageAllocator
from repro_torch.serving.slo import DEFAULT_SLO, get_slo
from repro_torch.serving.telemetry import MetricsRegistry, counter_attr


@dataclass
class Request:
    rid: str
    prompt_len: int
    gen: int
    tenant: str = "default"
    arrived_step: int = 0
    seq: int = 0                     # monotonic submission order (FIFO key)
    prompt: object = None            # (S,) int32 array; opaque to the host
    prompt_key: Optional[tuple] = None   # token ids (prefix-cache key)
    slo: str = DEFAULT_SLO           # repro.serving.slo class name
    # -- lifecycle ---------------------------------------------------------
    state: str = "waiting"  # waiting | prefilling | running | finished | shed
    slot: Optional[int] = None
    pos: int = 0                     # next KV write position
    prefilled: int = 0               # prompt tokens with KV written (chunked)
    tokens: List[int] = field(default_factory=list)
    deadline_step: int = 0           # arrived_step + slo.ttft_steps
    first_token_step: Optional[int] = None
    finished_step: Optional[int] = None
    preemptions: int = 0
    # -- fault-plane state (repro.serving.faults) --------------------------
    recoveries: int = 0              # fault resets (subset of preemptions)
    recovered_step: Optional[int] = None   # last fault-reset step, cleared
                                           # when the first token re-lands
    transient_rejections: int = 0    # dispatch faults absorbed by backoff
    backoff_until: int = 0           # not admissible before this step
    # wall stamps (telemetry only — scheduling never reads the wall clock)
    arrived_wall: float = 0.0
    first_token_wall: float = 0.0
    finished_wall: float = 0.0
    # -- prefix-cache state (set at admission, consumed by the engine) -----
    cached_tokens: int = 0           # prompt tokens served from shared pages
    prefix_match: Optional[object] = None   # prefix_cache.PrefixMatch

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.gen


@dataclass
class StepPlan:
    """What the engine must do this step, in order: clear the preempted
    slots, prefill the admitted requests, then run one decode step."""
    admitted: List[Request] = field(default_factory=list)
    preempted: List[Request] = field(default_factory=list)


class ContinuousBatchScheduler:
    """Admission + page-pressure preemption over ``max_batch`` slots.

    ``registry`` (a :class:`~repro.serving.telemetry.MetricsRegistry`)
    is the single store behind the counter attributes below — the
    engine shares its own so one ``registry.reset()`` covers both;
    standalone schedulers get a private one.  ``tracer`` (optional
    :class:`~repro.serving.telemetry.StepTracer`) receives a
    request-lifecycle event at every state transition.
    """

    # registry-backed counters (pinned by tests under these names)
    chunk_rounds = counter_attr()
    chunk_tasks = counter_attr()
    chunk_preemptions = counter_attr()   # preempted while half-prefilled
    transient_rejections = counter_attr()

    def __init__(self, allocator: PageAllocator, max_batch: int,
                 prefill_cost_s: Optional[Callable[[int], float]] = None,
                 decode_cost_s: float = 0.0,
                 prefill_budget: float = 2.0,
                 prefix_cache=None,
                 chunked: bool = False,
                 chunk_tokens: int = 0,
                 registry: Optional[MetricsRegistry] = None,
                 tracer=None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer
        self.alloc = allocator
        self.max_batch = max_batch
        self.prefill_cost_s = prefill_cost_s
        self.decode_cost_s = decode_cost_s
        self.prefill_budget = prefill_budget
        self.cache = prefix_cache        # prefix_cache.PrefixCache or None
        self.chunked = chunked
        # page-aligned chunk quantum; a slice never splits a page except
        # at the prompt's tail
        self.chunk_tokens = chunk_tokens or 2 * allocator.page_size
        if self.chunk_tokens < 1:
            raise ValueError("chunk_tokens must be >= 1")
        self.waiting: List[Request] = []
        self.running: Dict[int, Request] = {}      # slot -> request
        self.prefilling: Dict[int, Request] = {}   # slot -> request (chunked)
        self.finished: List[Request] = []
        self.shed: List[Request] = []    # dropped by pool-shrink degradation
        self.step_idx = 0
        self._next_seq = 0
        # seed the registry keys (descriptors write through)
        self.chunk_rounds = 0
        self.chunk_tasks = 0
        self.chunk_preemptions = 0
        # fault plane: an injected transient-dispatch gate (request, step)
        # -> bool, and capped exponential backoff for its rejections
        self.transient_gate: Optional[Callable[[Request, int], bool]] = None
        self.backoff_base = 1
        self.backoff_cap = 8
        self.transient_rejections = 0
        self.recovery_steps: List[int] = []   # fault-reset -> first-token

    def _trace(self, req: Request, state: str) -> None:
        """Emit one lifecycle transition to the flight recorder (no-op
        without a tracer; never read back — tracing cannot perturb
        scheduling)."""
        if self.tracer is not None:
            self.tracer.request_event(req.rid, state, self.step_idx,
                                      tenant=req.tenant)

    # -- submission --------------------------------------------------------
    def submit(self, req: Request):
        max_need = self.alloc.pages_for(req.prompt_len + req.gen)
        if max_need > self.alloc.n_pages - 1:
            raise ValueError(
                f"request {req.rid} needs {max_need} pages at peak but the "
                f"pool only has {self.alloc.n_pages - 1} allocatable")
        req.arrived_step = self.step_idx
        req.seq = self._next_seq
        self._next_seq += 1
        req.deadline_step = get_slo(req.slo).deadline(req.arrived_step)
        req.arrived_wall = time.time()
        self.waiting.append(req)
        self._trace(req, "queued")
        self._sort_waiting()

    def _edf_key(self, r: Request):
        s = get_slo(r.slo)
        return (r.deadline_step, s.priority, r.arrived_step, r.seq)

    def _sort_waiting(self):
        if self.chunked:
            # earliest-deadline-first: deadlines are fixed at submission
            # on a monotonic clock, so EDF cannot starve — a waiting
            # request only ever moves toward the head
            self.waiting.sort(key=self._edf_key)
        else:
            self.waiting.sort(key=lambda r: (r.arrived_step, r.seq))

    def _slots_in_use(self) -> int:
        return len(self.running) + len(self.prefilling)

    # -- the per-step state machine ---------------------------------------
    def plan_step(self) -> StepPlan:
        """Growth/preemption for running requests, then priced admission.

        Growth runs first so decode always has its write page; admission
        runs second so freshly freed pages go to the grower, not a new
        tenant.
        """
        plan = StepPlan()
        if self.alloc.quarantined:
            # degraded pool: arrivals that can never fit the shrunken
            # capacity are shed up front instead of wedging admission
            self.shed_infeasible(self.alloc.allocatable_pages)
        self._grow_or_preempt(plan)
        self._admit(plan)
        return plan

    def _victim(self, protect: Request) -> Optional[Request]:
        """Latest-arrived running request — ``protect`` included.

        A grower never evicts an earlier-arrived request: when the
        grower itself is the latest arrival it self-preempts (the
        caller breaks out of the growth loop) and waits for the pool.
        The alternative — exempting the grower — is a priority
        inversion that can livelock: two requests filling a tight pool
        alternately evict each other one window before completion,
        forever.  With arrival order respected, the earliest running
        request is never preempted, so it always finishes, frees its
        pages, and the pool drains in arrival order.

        Chunked mode adds half-prefilled requests to the victim pool:
        they hold pages too, and they are usually the latest arrivals —
        a preempted chunk victim recomputes from scratch (through the
        prefix cache if its early pages were donated), exactly like a
        decode victim.

        Degraded mode (any page quarantined by a node failure): victims
        are picked by SLO class first — batch tenants absorb the
        shrunken pool's pressure before interactive ones.  Arrival order
        breaks ties within a class, so the livelock argument survives:
        the lowest-priority-number earliest request is never preempted,
        always finishes, and the pool still drains."""
        pool = list(self.running.values()) + list(self.prefilling.values())
        if not pool:
            return None
        if self.alloc.quarantined:
            return max(pool, key=lambda r: (get_slo(r.slo).priority,
                                            r.arrived_step, r.seq))
        return max(pool, key=lambda r: (r.arrived_step, r.seq))

    def _preempt(self, req: Request, plan: StepPlan):
        # drops only this request's references: pages the prefix cache or
        # another tenant shares survive (non-reclaimable by preemption)
        if self.cache is not None and req.prefix_match is not None:
            # engine-less flows can preempt between admission and first
            # token: drop acquire()'s temporary COW-source reference
            # (not in held) or the page leaks as permanently unevictable
            self.cache.release_cow(req.prefix_match)
        self.alloc.free(req.rid)
        if req.state == "prefilling":
            del self.prefilling[req.slot]
            self.chunk_preemptions += 1
        else:
            del self.running[req.slot]
        req.state, req.slot = "waiting", None
        req.pos = 0
        req.prefilled = 0
        req.tokens = []               # greedy decode: recompute is exact
        req.first_token_step = None
        req.cached_tokens, req.prefix_match = 0, None
        req.preemptions += 1
        self.waiting.append(req)
        self._trace(req, "preempted")
        self._sort_waiting()
        plan.preempted.append(req)

    # -- fault recovery (node loss rides the preemption machinery) ---------
    def fault_reset(self, req: Request, plan: Optional[StepPlan] = None
                    ) -> StepPlan:
        """Reset a RUNNING/PREFILLING request whose pages were quarantined
        by a node failure: exactly a preemption (pages released — the
        allocator parks the quarantined ones — state back to ``waiting``,
        greedy recompute through whatever prefix-cache pages survived),
        plus a recovery stamp so :meth:`note_first_token` can report the
        reset -> first-token latency distribution."""
        plan = plan if plan is not None else StepPlan()
        self._preempt(req, plan)
        req.recoveries += 1
        req.recovered_step = self.step_idx
        # lifecycle: the generic "preempted" span _preempt opened closes
        # immediately and "recovered" runs until re-admission, so a trace
        # distinguishes page-pressure eviction from fault recovery
        self._trace(req, "recovered")
        return plan

    def shed_infeasible(self, capacity: int) -> List[Request]:
        """Graceful degradation under a quarantine-shrunken pool: any
        request whose *peak* page need exceeds ``capacity`` can never be
        (re)admitted, so it is shed now — terminally, state ``shed`` —
        instead of wedging the engine in an un-admittable waiting queue.
        Shedding order follows SLO priority (batch before interactive),
        which only matters for observability: every infeasible request
        goes.  Live requests release their pages like a preemption."""
        pool = (list(self.waiting) + list(self.prefilling.values())
                + list(self.running.values()))
        doomed = [r for r in pool
                  if self.alloc.pages_for(r.prompt_len + r.gen) > capacity]
        doomed.sort(key=lambda r: (-get_slo(r.slo).priority,
                                   r.arrived_step, r.seq))
        for req in doomed:
            if req.state == "waiting":
                self.waiting.remove(req)
            else:
                if self.cache is not None and req.prefix_match is not None:
                    self.cache.release_cow(req.prefix_match)
                    req.prefix_match = None
                self.alloc.free(req.rid)
                if req.state == "prefilling":
                    del self.prefilling[req.slot]
                else:
                    del self.running[req.slot]
            req.state, req.slot = "shed", None
            req.finished_step = self.step_idx
            self.shed.append(req)
            self._trace(req, "shed")
        return doomed

    def _grow_or_preempt(self, plan: StepPlan):
        for req in sorted(self.running.values(),
                          key=lambda r: (r.arrived_step, r.seq)):
            if req.state != "running":
                continue
            needed = req.pos // self.alloc.page_size + 1
            while len(self.alloc.held[req.rid]) < needed:
                if self.alloc.grow(req.rid):
                    continue
                victim = self._victim(req)
                assert victim is not None
                self._preempt(victim, plan)
                if victim is req:
                    break

    def _uncached_len(self, req: Request) -> int:
        """Prefill tokens the request must actually compute — prompt
        minus the cached-prefix length (pricing sees only real work)."""
        if self.cache is None or req.prompt_key is None:
            return req.prompt_len
        return req.prompt_len - self.cache.peek(req.prompt_key)

    def _take_pages(self, req: Request):
        """Acquire the prefix-cache match and allocate the request's full
        page run (prompt + first decode page).  Returns True on success;
        on page pressure every acquired reference is released."""
        match = None
        shared = []
        if self.cache is not None and req.prompt_key is not None:
            match = self.cache.acquire(req.prompt_key)
            shared = match.pages
        n_fresh = self.alloc.pages_for(req.prompt_len + 1) - len(shared)
        pages = self.alloc.alloc(req.rid, n_fresh, prefix=shared)
        if pages is None:
            if match is not None:
                self.cache.release_match(match)
            return False              # page pressure: wait for frees
        if match is not None:
            self.cache.commit_match(match)
        req.cached_tokens = match.length if match is not None else 0
        req.prefix_match = match
        return True

    def _free_slot(self) -> int:
        used = set(self.running) | set(self.prefilling)
        return min(set(range(self.max_batch)) - used)

    def _transient_rejected(self, req: Request) -> bool:
        """Ask the fault plane's gate whether this dispatch transiently
        fails; on rejection, arm capped exponential backoff (1, 2, 4, ...
        ``backoff_cap`` steps) so the retry storm self-spaces.  Tokens are
        unaffected — admission merely lands later and greedy recompute is
        exact."""
        gate = self.transient_gate
        if gate is None or not gate(req, self.step_idx):
            return False
        req.transient_rejections += 1
        self.transient_rejections += 1
        back = min(self.backoff_cap,
                   self.backoff_base << (req.transient_rejections - 1))
        req.backoff_until = self.step_idx + max(back, 1)
        return True

    def _admit(self, plan: StepPlan):
        if self.chunked:
            self._admit_chunked(plan)
            return
        budget = self.prefill_budget * self.decode_cost_s
        spent = 0.0
        i = 0
        while i < len(self.waiting) and self._slots_in_use() < self.max_batch:
            req = self.waiting[i]
            if req.backoff_until > self.step_idx:
                i += 1                # backing off: never blocks the queue
                continue
            # admission is priced on UNCACHED prefill tokens only: a
            # request whose prompt is mostly shared pages is nearly free
            cost = (self.prefill_cost_s(self._uncached_len(req))
                    if self.prefill_cost_s else 0.0)
            starving = not self.running and not plan.admitted
            if budget > 0.0 and spent + cost > budget and not starving:
                break                 # interference budget exhausted
            if self._transient_rejected(req):
                i += 1                # dispatch fault: retry after backoff
                continue
            if not self._take_pages(req):
                break                 # page pressure: wait for frees
            self.waiting.pop(i)
            req.slot = self._free_slot()
            req.state = "running"
            req.pos = req.prompt_len
            self.running[req.slot] = req
            # lifecycle: admission starts the prefill; "running" begins
            # at note_first_token when its first token actually lands
            self._trace(req, "prefilling")
            plan.admitted.append(req)
            spent += cost

    def _admit_chunked(self, plan: StepPlan):
        """EDF admission into the ``prefilling`` state.  No interference
        budget here — that is the whole point: a long prompt's cost is
        paid chunk by chunk under :meth:`plan_chunks`'s per-window
        budget, so admission only needs a slot and pages.  This removes
        the monolithic path's head-of-line block, where one unaffordable
        long prompt at the FIFO head stalled every arrival behind it."""
        i = 0
        while i < len(self.waiting) and self._slots_in_use() < self.max_batch:
            req = self.waiting[i]
            if req.backoff_until > self.step_idx:
                i += 1                # backing off: never blocks the queue
                continue
            if self._transient_rejected(req):
                i += 1                # dispatch fault: retry after backoff
                continue
            if not self._take_pages(req):
                break                 # page pressure: wait for frees
            self.waiting.pop(i)
            req.slot = self._free_slot()
            req.state = "prefilling"
            # cached prefix pages already hold KV: chunking starts at the
            # first uncached token (mid-page after a COW divergence)
            req.prefilled = req.cached_tokens
            req.pos = req.prefilled
            self.prefilling[req.slot] = req
            self._trace(req, "prefilling")
            plan.admitted.append(req)

    # -- chunked prefill ----------------------------------------------------
    def _chunk_end(self, start: int, prompt_len: int) -> int:
        """Next chunk boundary: at most ``chunk_tokens`` ahead, aligned
        down to a page boundary so only the prompt's final slice may
        leave a partial page.  A misaligned start (COW divergence
        mid-page) realigns on its first chunk."""
        end = min(prompt_len, start + self.chunk_tokens)
        if end < prompt_len:
            aligned = end - end % self.alloc.page_size
            if aligned > start:
                end = aligned
        return end

    def plan_chunks(self, window: int = 1) -> List[Tuple[Request, int, int]]:
        """One chunk round: ``(request, start, n_tokens)`` tasks for the
        engine to dispatch before the next decode window.

        The budget is deadline-driven and priced: the tightest running
        tenant's ``stall_frac`` bounds how many seconds of prefill this
        ``window``-step decode window tolerates, and each chunk is priced
        by ``prefill_cost_s`` (cost engine) against it.  Distribution is
        earliest-deadline-first, but EVERY prefilling request gets at
        least one chunk per round regardless of budget — the strict-
        progress guarantee the no-starvation property test pins.  With
        nothing decoding (or an unpriced scheduler at idle) the budget is
        unbounded and a prompt drains at full speed, recovering the
        monolithic fast path.  Unpriced schedulers under decode load fall
        back to strict round-robin: one chunk each."""
        if not self.chunked or not self.prefilling:
            return []
        self.chunk_rounds += 1
        priced = bool(self.running) and self.prefill_cost_s is not None \
            and self.decode_cost_s > 0.0
        budget_s = 0.0
        if priced:
            frac = min(get_slo(r.slo).stall_frac
                       for r in self.running.values())
            budget_s = max(window, 1) * self.decode_cost_s * frac
        tasks: List[Tuple[Request, int, int]] = []
        spent = 0.0
        for req in sorted(self.prefilling.values(), key=self._edf_key):
            first = True
            while req.prefilled < req.prompt_len:
                start = req.prefilled
                end = self._chunk_end(start, req.prompt_len)
                cost = (self.prefill_cost_s(end - start)
                        if self.prefill_cost_s is not None else 0.0)
                if not first and priced and spent + cost > budget_s:
                    break             # budget exhausted: back to decode
                tasks.append((req, start, end - start))
                req.prefilled = end
                req.pos = end
                spent += cost
                first = False
                if not priced and self.running:
                    break             # unpriced under load: round-robin
        self.chunk_tasks += len(tasks)
        return tasks

    def finish_prefill(self, req: Request, token: int) -> bool:
        """Final chunk landed: promote ``prefilling -> running`` and
        record the first token.  Returns True if the request finished
        outright (``gen == 1``)."""
        assert req.prefilled == req.prompt_len
        del self.prefilling[req.slot]
        req.state = "running"
        req.pos = req.prompt_len
        self.running[req.slot] = req
        self.note_first_token(req, token)
        return req.state == "finished"

    # -- fused decode windows ---------------------------------------------
    def safe_horizon(self, max_window: int, quantize=None) -> int:
        """Largest K (``<= max_window``) such that no scheduling event can
        occur strictly inside a K-step decode window:

        * **completion** — K never exceeds any running request's remaining
          tokens, so the earliest finish lands exactly on the window's
          last step;
        * **priced admission** — the interference budget resets every
          step, so if the head of the waiting queue has a free slot and
          free pages, it could be admitted next step: horizon is 1;
        * **page-boundary crossing** — every running request gets its
          window's pages pre-reserved (:meth:`PageAllocator.reserve`) in
          arrival order, fixing the block tables; if the pool runs dry
          the horizon shrinks to the reserved capacity instead of
          preempting mid-window.

        ``quantize`` (e.g. the engine's power-of-two bucketing) is
        applied to the event horizon *before* pages are reserved — so
        reservation never grabs pages a smaller dispatched window won't
        write — and again to the capacity-shrunk result.

        Interplay with adaptive speculation: the horizon is computed
        for the *largest* window the engine might dispatch (its
        ``max(max_window, spec_k + 1)`` cap), and the per-tenant
        adaptive controller then clamps each slot's draft depth to
        ``horizon - 1`` — a verify emits at most K accepted drafts plus
        one corrected token, all landing inside the reserved window.
        The derivation above is unchanged: completion still bounds K by
        the smallest remaining generation (a deep verify may *finish* a
        request mid-buffer, but emission is truncated at ``gen`` so the
        finish lands on the window's last emitted step); admission
        pressure still collapses the horizon to 1 (shallow drafts near
        admission events are exactly what the priced worth-it gate then
        prices out); and page reservation is exact over the horizon, so
        a rejected draft rolls back pages that were reserved, never
        pages another slot could have claimed mid-window.  Adaptive K
        never widens the horizon — it only chooses how much of the
        already-safe window to spend on drafts.

        Call after :meth:`plan_step` (growth already guaranteed the
        current write page, so the result is always >= 1 while anything
        runs).  Returns 0 when nothing is running.
        """
        quantize = quantize or (lambda n: n)
        if not self.running:
            return 0
        k = max(1, max_window)
        for req in self.running.values():
            k = min(k, req.gen - len(req.tokens))
        k = max(quantize(max(k, 1)), 1)
        if k > 1 and self.waiting and self._slots_in_use() < self.max_batch:
            head = next((r for r in self.waiting
                         if r.backoff_until <= self.step_idx), None)
            if head is None:
                # every waiting request is backing off: cap the window at
                # the earliest backoff expiry so re-admission lands on a
                # window boundary, then fall through to reservation
                expiry = min(r.backoff_until
                             for r in self.waiting) - self.step_idx
                k = max(min(k, expiry), 1)
        else:
            head = None
        if head is not None:
            if self.chunked:
                # chunked admission is unpriced (slot + pages only), so
                # any head with capacity could land next step
                admissible = True
            else:
                budget = self.prefill_budget * self.decode_cost_s
                cost = (self.prefill_cost_s(self._uncached_len(head))
                        if self.prefill_cost_s else 0.0)
                # mirror _admit with spent=0: a head whose prefill alone
                # busts the budget cannot land while anything runs, so it
                # must not collapse every window to K=1
                admissible = not (budget > 0.0 and cost > budget)
            need = self.alloc.pages_for(head.prompt_len + 1)
            if self.cache is not None and head.prompt_key is not None:
                # cached full pages arrive as shared references, not
                # fresh allocations (cache eviction could free more — a
                # conservative miss just delays admission, never tokens)
                need -= self.cache.peek(head.prompt_key) \
                    // self.alloc.page_size
            if admissible and need <= self.alloc.free_pages:
                return 1              # admission could land next step
        if k == 1:
            return 1
        for req in sorted(self.running.values(),
                          key=lambda r: (r.arrived_step, r.seq)):
            capacity = self.alloc.reserve(req.rid, req.pos + k)
            k = min(k, capacity - req.pos)
        return max(quantize(max(k, 1)), 1)

    # -- completion callbacks (engine -> scheduler) ------------------------
    def note_first_token(self, req: Request, token: int):
        if self.cache is not None and req.prefix_match is not None:
            # prefill is done.  In engine flows this release is a no-op —
            # _do_prefill drops the COW-source reference right after its
            # device copy — but the scheduler is also driven engine-less
            # (host-only tests, cost studies), and there this is the ONLY
            # balance point for acquire()'s temporary COW reference.
            self.cache.release_cow(req.prefix_match)
            req.prefix_match = None
        req.tokens.append(token)
        req.first_token_step = self.step_idx
        req.first_token_wall = time.time()
        self._trace(req, "running")
        if req.recovered_step is not None:
            # recovery latency: fault reset -> the recompute's first token.
            # The list is the raw record (pinned by tests); the registry
            # digest is the streaming percentile view metrics() reports.
            steps = self.step_idx - req.recovered_step
            self.recovery_steps.append(steps)
            self.registry.observe("recovery_steps", steps)
            req.recovered_step = None
        self._maybe_finish(req)

    def complete_step(self, emitted: Dict[int, int]) -> List[Request]:
        """Record one decode step: ``emitted`` maps slot -> token.  The
        KV write for the token happened at ``pos``; advance it.  Returns
        the requests that just finished."""
        done = []
        for slot, token in emitted.items():
            req = self.running.get(slot)
            if req is None:
                continue
            req.pos += 1
            req.tokens.append(token)
            if self._maybe_finish(req):
                done.append(req)
        self.step_idx += 1
        return done

    def complete_spec(self, req: Request, tokens: List[int]) -> List[Request]:
        """Record one verified speculative emission for ONE request:
        ``tokens`` is the accepted draft prefix plus the verifier's
        bonus/correction token — every element is the greedy argmax of
        the model at its position, so speculation never changes emitted
        tokens, only how many model passes produced them.  The verify
        dispatch wrote KV for positions ``pos .. pos+len(tokens)-2``
        (the last token's KV is not yet written — the same invariant as
        :meth:`complete_step`); rejected-draft KV past that is masked by
        position and its whole pages are rolled back by the engine via
        :meth:`PageAllocator.truncate_to`.  Does NOT advance
        ``step_idx`` — the engine advances the clock once per window by
        the largest per-slot emission.  Returns ``[req]`` on finish."""
        req.pos += len(tokens)
        req.tokens.extend(int(t) for t in tokens)
        return [req] if self._maybe_finish(req) else []

    def _maybe_finish(self, req: Request) -> bool:
        if not req.done:
            return False
        if self.cache is not None and req.prompt_key is not None:
            # donate before free: every page is immutable now (the last
            # emitted token's KV is never written, so the valid run is
            # prompt + tokens[:-1]) and the tree takes its own reference
            # — shared pages survive the owner's completion
            valid = tuple(req.prompt_key) + tuple(req.tokens[:-1])
            self.cache.insert(valid, self.alloc.held.get(req.rid, []),
                              donate_partial=True)
        self.alloc.free(req.rid)
        if req.slot is not None:
            self.running.pop(req.slot, None)
        req.state, req.slot = "finished", None
        req.finished_step = self.step_idx
        req.finished_wall = time.time()
        self.finished.append(req)
        self._trace(req, "finished")
        return True

    # -- invariants (pinned by tests) --------------------------------------
    @property
    def all_requests(self) -> List[Request]:
        seen = {r.rid: r for r in self.waiting}
        seen.update({r.rid: r for r in self.prefilling.values()})
        seen.update({r.rid: r for r in self.running.values()})
        seen.update({r.rid: r for r in self.finished})
        seen.update({r.rid: r for r in self.shed})
        return list(seen.values())

    def conserved(self, submitted: int) -> bool:
        """No request dropped or duplicated across queues (``shed`` is a
        terminal queue too — degradation is accounted, never silent)."""
        rids = ([r.rid for r in self.waiting]
                + [r.rid for r in self.prefilling.values()]
                + [r.rid for r in self.running.values()]
                + [r.rid for r in self.finished]
                + [r.rid for r in self.shed])
        return len(rids) == len(set(rids)) == submitted
