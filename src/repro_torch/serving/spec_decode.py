"""Swallow §V applied to the model-dispatch "interconnect": weightless
n-gram speculative decoding for the paged serving engine.

Reference: ``repro/serving/spec_decode.py``.  The host half
(``propose_ngram``, ``SpecStats``, ``AdaptiveK``, ``NGramSpec``) is the
reference's line for line; ``device_propose`` is rewritten from jnp as
torch tensor ops over one device row.

The paper's throughput argument is about the communication-to-computation
ratio: a fixed per-message overhead is amortized by making every message
carry more useful payload.  The fused windows apply that to
host<->device syncs (O(1)/window); this module applies it to *model
dispatches per emitted token* — the remaining per-token fixed cost.
A decode step is one model pass for one token; speculative decoding
turns it into one model pass for up to K+1 tokens: a draft of K tokens
is *proposed for free* (no model, no weights — pure string matching
over the sequence's own history) and *verified in one batched dispatch*
(:func:`repro_torch.models.lm.verify_window_paged`, the same
``apply_prefill_paged`` arithmetic as the prefix-cache suffix path), so
the accepted prefix plus the verifier's own bonus/correction token all
land from a single pass.

Drafting is prompt-lookup (n-gram) speculation: match the last ``n``
tokens of the sequence's own prompt+output history against an earlier
occurrence in that same history, and propose the tokens that followed
it.  Repetitive text — templated output, code, retrieval-heavy prompts,
or the fixed-point loops greedy decode falls into — drafts almost
perfectly; adversarial text drafts nothing and the engine degrades to
the plain fused-window path.  Either way the *emitted* tokens are
bit-identical to non-speculative greedy decode, because acceptance only
keeps drafts that equal the verifier's greedy argmax and the first
mismatch is replaced by that argmax (pinned by
tests/test_torch_prefix_spec.py across prefix-cache hits, preemption
and fused windows).

Two proposers, one semantics:

* :func:`propose_ngram` — the host reference implementation (pure
  Python).  It is the oracle rung of the exactness ladder
  (docs/TESTING.md) and stays the drafting path for
  ``spec_proposer="host"`` engines.
* :func:`device_propose` — the same suffix match vectorized in torch over
  a device-resident history buffer, so drafting composes into the
  engine's fused draft+verify dispatch with no host materialization of
  candidate drafts.  Pinned token-identical to the host proposer by a
  differential hypothesis property (tests/test_torch_prefix_spec.py).

:class:`AdaptiveK` closes the loop: a per-request EWMA of observed
acceptance picks the draft depth K (clamped to the scheduler's safe
horizon and snapped to the pow2 verify buckets), collapsing to K=0 —
speculation off, with a periodic 1-token probe — under sustained
rejection instead of thrashing rollbacks.

The verify dispatch and the page rollback
(:meth:`repro_torch.serving.paged_kv.PageAllocator.truncate_to`) live in
:mod:`repro_torch.serving.engine`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence


def _pow2_floor(k: int) -> int:
    return 1 << (max(k, 1).bit_length() - 1)


def _pow2_ceil(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def propose_ngram(history: Sequence[int], k: int, *, max_n: int = 3,
                  min_n: int = 1) -> List[int]:
    """Prompt-lookup drafting: find the *earliest* earlier occurrence of
    the history's last ``n`` tokens (longest ``n`` first, ``max_n`` down
    to ``min_n``) and propose up to ``k`` tokens that followed it.
    Earliest — not most recent — because the match nearest the end has
    the least history left after it: on a looping sequence the latest
    occurrence only ever yields a 1-token draft, while the earliest
    yields the whole period.

    Returns [] when nothing matches — the caller falls back to plain
    decode.  O(n * len(history)) per candidate ``n``; histories are
    bounded by the engine's ``max_len``, so this stays microseconds-cheap
    next to a model dispatch.
    """
    L = len(history)
    if k < 1 or L < min_n + 1:
        return []
    hist = [int(t) for t in history]
    for n in range(min(max_n, L - 1), min_n - 1, -1):
        pattern = hist[L - n:]
        for i in range(L - n):
            if hist[i:i + n] == pattern:
                return hist[i + n:i + n + k]
    return []


def device_propose(history, hist_len, k, *, k_max: int, max_n: int = 3,
                   min_n: int = 1):
    """:func:`propose_ngram` as tensor ops over one device-resident
    history row, with no host sync.

    ``history`` is a fixed-width ``(H,)`` int32 tensor whose first
    ``hist_len`` entries are the sequence's prompt+output history
    (entries past ``hist_len`` are arbitrary — padding or stale tokens
    from a rolled-back draft; the validity mask below keeps them out of
    every match).  ``hist_len`` and ``k`` are ints or 0-d tensors on
    ``history``'s device; ``k_max``/``max_n``/``min_n`` are ints.

    Returns ``(draft, m)``: a ``(k_max,)`` int32 tensor whose first
    ``m`` entries are the draft (zero-masked past ``m``), with ``m = 0``
    (a 0-d int32 tensor) when nothing matches — exactly the cases where
    the host proposer returns ``[]``.  Token-identical to
    ``propose_ngram(history[:L], k)`` for every ``min(k, k_max)``: same
    longest-``n``-first, earliest-occurrence match, same clip of the
    draft at the history end.
    """
    import torch

    dev = history.device
    H = history.shape[-1]
    i32 = torch.int32
    idx = torch.arange(H, dtype=i32, device=dev)
    L = torch.as_tensor(hist_len, dtype=i32, device=dev)
    kq = torch.clamp(torch.as_tensor(k, dtype=i32, device=dev), max=k_max)
    found = torch.zeros((), dtype=torch.bool, device=dev)
    start = torch.zeros((), dtype=i32, device=dev)
    for n in range(max_n, min_n - 1, -1):
        # the history's tail n-gram (indices clipped; masked below when
        # L < n so a clipped pattern can never produce a false match)
        pat = history[torch.clamp(L - n + torch.arange(n, dtype=i32,
                                                       device=dev),
                                  0, H - 1).long()]
        eq = torch.ones((H,), dtype=torch.bool, device=dev)
        for j in range(n):
            eq = eq & (history[torch.clamp(idx + j, 0, H - 1).long()]
                       == pat[j])
        # a match at i is valid only if the whole n-gram AND at least
        # one continuation token lie strictly inside the history — this
        # also excludes every clipped index above from participating
        valid = eq & (idx + n < L)
        has = valid.any()
        first = torch.argmax(valid.to(i32)).to(i32)   # earliest match
        take = has & ~found                            # longest n wins
        start = torch.where(take, first + n, start)
        found = found | has
    ok = found & (kq >= 1) & (L >= min_n + 1)
    m = torch.where(ok, torch.minimum(kq, L - start),
                    torch.zeros((), dtype=i32, device=dev)).to(i32)
    offs = torch.arange(k_max, dtype=i32, device=dev)
    draft = history[torch.clamp(start + offs, 0, H - 1).long()]
    draft = torch.where(offs < m, draft, torch.zeros_like(draft)).to(i32)
    return draft, m


@dataclass
class SpecStats:
    """Acceptance accounting for the engine's ``accept_rate`` /
    ``dispatches_per_token`` observables."""
    drafted: int = 0       # draft tokens proposed to the verifier
    accepted: int = 0      # draft tokens the verifier kept
    verifies: int = 0      # verification dispatches run
    rollbacks: int = 0     # verifies that released rejected pages
    k_requested: int = 0   # summed draft depth K over verifies

    @property
    def accept_rate(self) -> float:
        return self.accepted / max(self.drafted, 1)

    @property
    def k_mean(self) -> float:
        return self.k_requested / max(self.verifies, 1)


@dataclass
class AdaptiveK:
    """Per-request draft-depth controller: an EWMA ``rate`` of the
    observed accepted/requested ratio, mapped to the draft depth that
    ratio earns.

    For geometric acceptance at per-token rate r the expected accepted
    prefix of an infinite draft is r/(1-r), so that is the target depth:
    r=0.75 -> 3, r=0.9 -> 9, r -> 1 saturates at the engine's ``k_max``.
    Below r=0.5 the target is 0 — drafting is priced off entirely
    (collapse instead of rollback thrash) — and every ``probe_every``
    disabled windows a single 1-token probe runs so a sequence that
    *becomes* repetitive can re-enable itself (one accepted probe lifts
    the EWMA back over the threshold).
    """
    alpha: float = 0.3     # EWMA gain per observed verify
    rate: float = 0.75     # optimistic prior: try drafting, learn fast
    probe_every: int = 8   # disabled windows between 1-token probes
    idle: int = 0          # disabled windows since the last probe

    def observe(self, requested: int, accepted: int):
        """Fold one verify's outcome (K requested, a accepted) into the
        EWMA.  A no-draft verify (requested=0) teaches nothing."""
        if requested < 1:
            return
        self.rate += self.alpha * (accepted / requested - self.rate)
        self.idle = 0

    def target(self, k_max: int) -> int:
        """Draft depth the current EWMA earns, in [0, k_max].  Calling
        this while disabled advances the probe clock — the engine calls
        it once per window per slot."""
        r = min(self.rate, 0.999)
        t = int(r / (1.0 - r))
        if t < 1:
            self.idle += 1
            if self.idle >= self.probe_every:
                self.idle = 0
                return 1               # periodic re-enable probe
            return 0
        return min(t, k_max)


class NGramSpec:
    """Per-engine speculative-decoding policy: draft depth, n-gram
    bounds, adaptive-K state and acceptance stats.  Weightless — the
    proposer never touches model state, only the request's token
    history."""

    def __init__(self, k: int = 8, max_n: int = 3, min_n: int = 1,
                 adaptive: bool = False, alpha: float = 0.3,
                 r0: float = 0.75, probe_every: int = 8):
        assert k >= 1 and max_n >= min_n >= 1
        self.k = k
        self.max_n = max_n
        self.min_n = min_n
        self.adaptive = adaptive
        self.alpha = alpha
        self.r0 = r0
        self.probe_every = probe_every
        self.stats = SpecStats()
        self._ak: Dict[str, AdaptiveK] = {}

    # -- adaptive-K state --------------------------------------------------
    def state(self, key: str) -> AdaptiveK:
        st = self._ak.get(key)
        if st is None:
            st = self._ak[key] = AdaptiveK(alpha=self.alpha, rate=self.r0,
                                           probe_every=self.probe_every)
        return st

    def rate_for(self, key: str) -> float:
        """The key's acceptance EWMA (the prior before any verify) —
        the e = 1 + r*K input of the engine's priced worth-it gate.
        The engine keys controllers by tenant: acceptance statistics
        are a workload property, so they carry across a tenant's
        requests instead of re-ramping from the prior each time."""
        return self.state(key).rate

    def draft_k(self, key: str, horizon: int) -> int:
        """Draft depth for this window: the adaptive target (or the
        fixed ``k``), clamped to the safe horizon (a verify may write at
        most ``horizon - 1`` draft positions — the last emitted token's
        KV plus K drafts all land inside the reserved window) and, when
        adaptive, snapped to the pow2 verify buckets (K+1 a power of
        two) so adaptation never compiles a new verify width."""
        cap = min(self.k, horizon - 1)
        if cap < 1:
            return 0
        if not self.adaptive:
            return cap
        t = self.state(key).target(self.k)
        if t < 1:
            return 0
        t = min(t, cap)
        up = _pow2_ceil(t + 1) - 1       # optimistic: round K+1 up
        return up if up <= cap else _pow2_floor(cap + 1) - 1

    def observe(self, key: str, requested: int, accepted: int):
        self.state(key).observe(requested, accepted)

    def forget(self, key: str):
        """Drop a controller's state (back to the optimistic prior)."""
        self._ak.pop(key, None)

    # -- host reference proposer (the oracle rung) -------------------------
    def propose(self, prompt: Sequence[int], tokens: Sequence[int],
                k_cap: int) -> List[int]:
        """Draft up to ``min(self.k, k_cap)`` tokens from the sequence's
        own prompt+output history."""
        k = min(self.k, k_cap)
        if k < 1:
            return []
        history = [int(t) for t in prompt] + [int(t) for t in tokens]
        return propose_ngram(history, k, max_n=self.max_n,
                             min_n=self.min_n)

    def accept(self, draft: Sequence[int],
               greedy: Sequence[int]) -> List[int]:
        """Greedy acceptance rule: keep the longest draft prefix that
        matches the verifier's argmax at each position, then append the
        verifier's own token at the first mismatch (or the bonus token
        when everything matched).  The result is therefore *exactly*
        the token sequence non-speculative greedy decode would emit —
        speculation changes dispatch count, never tokens."""
        a = 0
        while a < len(draft) and int(greedy[a]) == int(draft[a]):
            a += 1
        emitted = [int(t) for t in draft[:a]] + [int(greedy[a])]
        self.stats.drafted += len(draft)
        self.stats.accepted += a
        self.stats.verifies += 1
        return emitted
