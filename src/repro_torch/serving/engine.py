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

This slice ports the cache-miss prefill, fused windows and the per-step
path.  Prefix caching, speculative decoding, chunked prefill, the fault
plane, tracing and mesh-striped pools raise ``NotImplementedError`` naming
the ROADMAP item that brings them.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import steps as steps_mod
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import costs
from repro_torch.models import lm
from repro_torch.serving.paged_kv import NULL_PAGE, PageAllocator
from repro_torch.serving.scheduler import ContinuousBatchScheduler, Request
from repro_torch.serving.telemetry import (HistogramDigest, MetricsRegistry,
                                           counter_attr)
from repro_torch.weights import resolve_device

# (constructor flag, ROADMAP Queue A item that ports it)
_UNPORTED = (("prefix_cache", "the prefix cache (Queue A item 1)"),
             ("spec_decode", "speculative decoding (Queue A item 2)"),
             ("chunked_prefill", "chunked prefill (Queue A item 3)"),
             ("fault_plan", "the fault plane (Queue A item 4)"),
             ("trace", "step tracing (Queue A item 5)"),
             ("mesh", "mesh-striped pools (Queue A item 7)"))


class PagedEngine:
    """Paged-KV serving engine over one model on one device.

    ``max_len`` bounds prompt+gen per sequence; the block table has
    ``ceil(max_len / page_size)`` entries per slot.  ``n_pages`` includes
    the reserved null page.  ``fused=True`` decodes in windows of up to
    ``max_window`` steps per call; ``fused=False`` is the per-step path.
    ``device`` defaults to ``cuda`` and must hold ``params``; with no
    device given and no CUDA present the constructor raises.
    """

    steps_run = counter_attr()
    windows_run = counter_attr()
    decode_steps = counter_attr()
    decode_tokens = counter_attr()
    tokens_emitted = counter_attr()
    decode_time_s = counter_attr()
    h2d_syncs = counter_attr()
    d2h_syncs = counter_attr()
    block_row_writes = counter_attr()
    peak_pages = counter_attr()
    prefill_tokens = counter_attr()
    model_passes = counter_attr()

    def __init__(self, cfg, params, *, max_batch: int = 4,
                 page_size: int = 16, n_pages: int = 64,
                 max_len: int = 256, prefill_budget: float = 2.0,
                 fused: bool = True, max_window: int = 8,
                 prefix_cache: bool = False, spec_decode: bool = False,
                 chunked_prefill: bool = False, fault_plan=None,
                 trace: bool = False, mesh=None, device=None):
        flags = dict(prefix_cache=prefix_cache, spec_decode=spec_decode,
                     chunked_prefill=chunked_prefill,
                     fault_plan=fault_plan is not None, trace=trace,
                     mesh=mesh is not None)
        for flag, what in _UNPORTED:
            if flags[flag]:
                raise NotImplementedError(
                    f"{flag}: {what} is not ported yet; see ROADMAP.md")
        assert lm.paged_decodable(cfg), \
            f"{cfg.name} is not paged-decodable (attention-only, causal)"
        want = resolve_device(device)
        self.device = params["embed"]["embed_table"].device
        if self.device.type != want.type or want.index not in (
                None, self.device.index):
            raise ValueError(f"params live on {self.device}, the engine "
                             f"was asked to run on {want}")
        self.registry = MetricsRegistry()
        self.cfg = cfg
        self.params = params
        self.page_size = page_size
        self.max_batch = max_batch
        self.max_len = max_len
        self.nmax = -(-max_len // page_size)
        self.fused = fused
        self.max_window = max(1, int(max_window))
        self.alloc = PageAllocator(n_pages=n_pages, page_size=page_size,
                                   registry=self.registry)
        self.decode_estimate = self._estimate(
            ShapeConfig("serve_decode", max_len, max_batch, "decode"))
        self.sched = ContinuousBatchScheduler(
            self.alloc, max_batch,
            prefill_cost_s=self._prefill_cost,
            decode_cost_s=self.decode_estimate.step_time_s,
            prefill_budget=prefill_budget, registry=self.registry)
        self.pools = lm.init_paged_caches(cfg, n_pages=n_pages,
                                          page_size=page_size,
                                          device=self.device)
        self._prefill = steps_mod.make_paged_prefill_step(cfg)
        self._serve = steps_mod.make_paged_serve_step(cfg)
        self._scan = steps_mod.make_paged_serve_scan(cfg)
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
        # dirty-tracking signature per slot: (rid, preemptions, n_pages)
        self._slot_sig: List[Optional[tuple]] = [None] * max_batch
        self._n_submitted = 0
        # seed every registry counter key (descriptors write through)
        self.steps_run = 0
        self.windows_run = 0
        self.decode_steps = 0
        self.decode_tokens = 0
        self.tokens_emitted = 0
        self.decode_time_s = 0.0
        self.h2d_syncs = 0
        self.d2h_syncs = 0
        self.block_row_writes = 0
        self.peak_pages = 0
        self.prefill_tokens = 0
        self.model_passes = 0
        self.t0 = time.time()

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """A device copy of a host array (never a view of the mirror)."""
        return torch.tensor(a, device=self.device)

    def reset_metrics(self):
        """Zero every counter/clock/digest (e.g. after a warmup pass)
        while keeping the pools and allocator state."""
        self.registry.reset()
        self.sched.finished.clear()
        self._n_submitted = 0
        self.t0 = time.time()

    # -- cost-engine pricing (the scheduler's admission inputs) ------------
    def _estimate(self, shape):
        # one device: no stripe, so no interconnect term to price
        return costs.estimate(self.cfg, costs.Layout(data=1, model=1),
                              "circuit", shape)

    def _prefill_cost(self, prompt_len: int) -> float:
        shape = ShapeConfig("serve_prefill", max(prompt_len, 1), 1,
                            "prefill")
        return self._estimate(shape).step_time_s

    # -- request intake ----------------------------------------------------
    def submit(self, prompt, gen: int, *, rid: Optional[str] = None,
               slo: str = "standard") -> Request:
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.shape[0] == 0:
            raise ValueError(
                "empty prompt: zero-length requests are rejected at "
                "submit (a prompt needs >= 1 token to prefill a first "
                "logit)")
        assert prompt.shape[0] + gen <= self.max_len
        rid = rid or f"r{self._n_submitted}"
        self._n_submitted += 1
        req = Request(rid=rid, prompt_len=int(prompt.shape[0]), gen=gen,
                      prompt=prompt, slo=slo)
        self.sched.submit(req)
        return req

    # -- host mirror maintenance -------------------------------------------
    def _block_row(self, rid: str) -> np.ndarray:
        row = np.full((self.nmax,), NULL_PAGE, np.int32)
        pages = self.alloc.held[rid]
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
        self._dirty = True

    def _occupy_slot(self, req: Request, row: np.ndarray, token: int):
        self.block_tables[req.slot] = row
        self.tokens[req.slot] = token
        self.pos[req.slot] = req.pos
        self.active[req.slot] = 1
        self._slot_sig[req.slot] = self._sig(req)
        self.block_row_writes += 1
        self._dirty = True

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

    # -- fused-window warmup ----------------------------------------------
    def window_sizes(self) -> List[int]:
        """The power-of-two window buckets this engine will dispatch."""
        if not self.fused:
            return [1]
        sizes, k = [], 1
        while k <= self.max_window:
            sizes.append(k)
            k *= 2
        return sizes

    def warmup_windows(self):
        """Run every window bucket once against inactive slots and null
        rows (their writes land on the null page, masked by design)."""
        if not self.fused:
            return
        zeros_tok = torch.zeros((self.max_batch, 1), dtype=torch.int32,
                                device=self.device)
        zeros_pos = torch.zeros((self.max_batch,), dtype=torch.int32,
                                device=self.device)
        null_rows = torch.full((self.max_batch, self.nmax), NULL_PAGE,
                               dtype=torch.int32, device=self.device)
        inactive = zeros_pos
        for k in self.window_sizes():
            toks, _, _, self.pools = self._scan(
                self.params, zeros_tok, self.pools, null_rows, zeros_pos,
                inactive, k=k)
            toks.cpu()
        self._dirty = True        # device state was clobbered

    # -- prefill -----------------------------------------------------------
    def _do_prefill(self, req: Request, row: np.ndarray) -> int:
        """Write the request's prompt KV and return its first greedy
        token (the cache-miss path: the whole prompt runs)."""
        logits, self.pools = self._prefill(
            self.params, self._dev(req.prompt[None]), self.pools,
            self._dev(row))
        self.h2d_syncs += 1    # prompt + block row push
        self.model_passes += 1
        tok = int(logits.argmax(-1)[0, 0])
        self.d2h_syncs += 1    # blocking first-token pull
        self.prefill_tokens += req.prompt_len
        return tok

    # -- one engine step (a window of >= 1 scheduler steps) ----------------
    @staticmethod
    def _pow2_floor(k: int) -> int:
        # bucket to the largest power of two <= k
        return 1 << (max(k, 1).bit_length() - 1)

    def _pick_window(self, max_window: Optional[int]) -> int:
        cap = self.max_window if max_window is None \
            else max(1, min(self.max_window, max_window))
        return self.sched.safe_horizon(cap, quantize=self._pow2_floor)

    def step(self, max_window: Optional[int] = None) -> List[Request]:
        """Plan, prefill admissions, decode one fused window (or one step
        when ``fused=False``).  Returns requests finished this window."""
        plan = self.sched.plan_step()
        finished: List[Request] = []
        for slot in range(self.max_batch):   # preempted/idle slots -> null
            if slot not in self.sched.running \
                    and self._slot_sig[slot] is not None:
                self._clear_slot(slot)
        for req in plan.admitted:
            row = self._block_row(req.rid)
            tok = self._do_prefill(req, row)
            self.sched.note_first_token(req, tok)
            self.tokens_emitted += 1
            if req.state == "running":     # gen > 1: occupy the slot
                self._occupy_slot(req, row, tok)
            else:                          # gen == 1: finished at prefill
                finished.append(req)
        if self.sched.running:
            k = self._pick_window(max_window) if self.fused else 1
            self._refresh_slots()
            active = dict(self.sched.running)
            t_dec = time.time()
            if self.fused:
                self._push()
                toks, self.d_tokens, self.d_pos, self.pools = self._scan(
                    self.params, self.d_tokens, self.pools, self.d_block,
                    self.d_pos, self.d_active, k=k)
            else:
                # per-step path: push the whole bundle and pull one token
                # per scheduler step — O(1) syncs per token
                self._push(force=True)
                toks, _, self.pools = self._serve(
                    self.params, self.d_tokens, self.pools, self.d_block,
                    self.d_pos)
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
        for slot in range(self.max_batch):   # finished slots -> null
            if slot not in self.sched.running \
                    and self._slot_sig[slot] is not None:
                self._clear_slot(slot)
        self.peak_pages = max(self.peak_pages, self.alloc.pages_in_use)
        return finished

    def run(self, max_steps: int = 100_000) -> List[Request]:
        """Step until every submitted request finished."""
        while (self.sched.waiting or self.sched.running) \
                and self.steps_run < max_steps:
            self.step()
        if self.sched.waiting or self.sched.running:
            raise RuntimeError(
                f"engine wedged: {len(self.sched.waiting)} waiting / "
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
        return {
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
        }
