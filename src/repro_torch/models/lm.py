"""Unified LM: forward / loss / prefill / decode over layer segments.

Reference: ``repro/models/lm.py``.  Layers are grouped into the same
homogeneous *segments* (``make_segments``).  The reference stacks a
scanned segment's parameters and caches on a leading ``n_cycles`` axis and
``lax.scan``s over it; the port keeps one entry per cycle instead:

    params["segments"][seg][cycle][j]   block params of kind seg.kinds[j]
    caches[seg][cycle][j]               that layer's decode cache
    pools[seg][cycle][j]                that layer's PagedAttnCache

and runs the cycles as a Python loop over device tensors.  As in the
reference, ``decode_step`` returns the new cache nesting: attention caches
are written in place and returned, the recurrent states (RG-LRU, RWKV-6)
are new tensors, so the caller must use the caches it gets back.

The forward, the loss, the prefill and the decode step also run on one
model group of a mesh (``group=``: the mesh's train step,
``steps.make_train_step``, and the dense engine's mesh,
``steps.make_prefill_step`` / ``make_serve_step``): the parameters are
then one nesting whose leaves hold each position's block
(``weights.group_params``), the residual stream is sequence-sharded
(:class:`~repro_torch.parallel.collectives.Shards`, the reference's
``logical_constraint(x, "batch", "seq_sp", None)``), or whole on every
position when the group does not split the sequence (a decode step),
and the cross-entropy and the head are vocabulary-parallel: each
position's logits cover its vocabulary block; the loss crosses only
(B, chunk)-sized sums, the serving head gathers the (B, 1, V) logits to
the group's root, where the greedy token is taken (``argmax`` takes the
lowest index of a tie, as ``jnp.argmax`` does).
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks, modules as nn
from repro_torch.models.remat import checkpoint, span
from repro_torch.parallel import collectives as col


class SegmentSpec(NamedTuple):
    kinds: Tuple[str, ...]
    is_moe: bool
    n_cycles: int
    scanned: bool
    start_layer: int


def make_segments(cfg: ModelConfig) -> List[SegmentSpec]:
    kinds = cfg.layer_kinds
    moe_flags = [cfg.moe is not None and i >= cfg.first_k_dense
                 for i in range(cfg.n_layers)]
    p = len(cfg.layer_pattern)
    segs: List[SegmentSpec] = []
    i = 0
    while i < cfg.n_layers:
        if i % p == 0 and i + p <= cfg.n_layers \
                and len(set(moe_flags[i:i + p])) == 1:
            # count consecutive full cycles with the same MoE signature
            n = 0
            j = i
            while j + p <= cfg.n_layers \
                    and kinds[j:j + p] == cfg.layer_pattern \
                    and len(set(moe_flags[j:j + p])) == 1 \
                    and moe_flags[j] == moe_flags[i]:
                n += 1
                j += p
            segs.append(SegmentSpec(cfg.layer_pattern, moe_flags[i], n,
                                    n > 1, i))
            i = j
        else:
            # remainder: group consecutive same-(kind, moe) layers
            k0, m0 = kinds[i], moe_flags[i]
            n = 0
            while i + n < cfg.n_layers and kinds[i + n] == k0 \
                    and moe_flags[i + n] == m0:
                n += 1
            segs.append(SegmentSpec((k0,), m0, n, n > 1, i))
            i += n
    assert sum(s.n_cycles * len(s.kinds) for s in segs) == cfg.n_layers
    return segs


def _layers(cfg, params, states):
    """Yield (kind, block params, state, (seg, cycle, j)) for every layer
    in order; ``states`` mirrors the segment/cycle nesting (or is None)."""
    segs = make_segments(cfg)
    for si, seg in enumerate(segs):
        for c in range(seg.n_cycles):
            span(si, c, seg.n_cycles)
            for j, kind in enumerate(seg.kinds):
                st = None if states is None else states[si][c][j]
                yield kind, params["segments"][si][c][j], st, (si, c, j)
    span(len(segs), 0, 1)


def _nest(cfg, fn):
    """The segment/cycle/kind nesting with ``fn(kind, (seg, cycle, j))``
    at every layer."""
    segs, out = make_segments(cfg), []
    for si, seg in enumerate(segs):
        out.append([])
        for c in range(seg.n_cycles):
            span(si, c, seg.n_cycles)
            out[-1].append(tuple(fn(kind, (si, c, j))
                                 for j, kind in enumerate(seg.kinds)))
    span(len(segs), 0, 1)
    return out


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------
def _rope_dim(cfg) -> int:
    return cfg.mla.qk_rope_head_dim if cfg.mla is not None else cfg.head_dim


def _angles(cfg, positions):
    if not cfg.rope:
        return None
    return nn.rope_angles(positions, _rope_dim(cfg), cfg.rope_theta,
                          cfg.mrope_sections)


def default_positions(cfg, batch: int, seq: int, device=None):
    """(B, S) positions 0..S-1, or (3, B, S) under M-RoPE: every plane
    the text position, as the reference's stub frontend gives them."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None].expand(
        batch, seq)
    if cfg.mrope_sections is not None:
        pos = pos[None].expand(3, batch, seq)
    return pos


def embed_tokens(params, cfg, tokens):
    """(B, S) int ids through the table, or the (B, S, D) embeddings of a
    stub frontend (``embed_inputs=False``) cast to the activation dtype."""
    if cfg.embed_inputs:
        table = params["embed"]["embed_table"]
        x = table[tokens.long()].to(nn.dt(cfg.activation_dtype))
    else:
        x = tokens.to(nn.dt(cfg.activation_dtype))
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def head_logits(params, cfg, h):
    """h (..., D) -> fp32 logits (..., V), with final softcap: the
    reference's product (``modules.matmul``, fp32 out) against the head,
    or the tied table read transposed in place."""
    if cfg.tie_embeddings and cfg.embed_inputs:
        w = params["embed"]["embed_table"].T
    else:
        w = params["head"]["head_w"]
    logits = nn.matmul(h, w, torch.float32)
    if cfg.logit_softcap is not None:
        logits = nn.softcap(logits, cfg.logit_softcap)
    return logits


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------
def forward(params, cfg: ModelConfig, tokens, positions=None, *,
            mode: str = "prefill", group=None):
    """tokens: (B,S) int ids or (B,S,D) embeddings (stub frontends);
    positions (B,S), or (3,B,S) under M-RoPE, default
    ``default_positions``.

    ``mode="prefill"`` returns (x, pending, raw caches): the residual
    stream before the last layer's branch output ``pending`` is added
    (h_final = x + pending, pre-final-norm; ``last_logits`` adds it fused
    with the final norm), and the per-layer nesting of (k, v) or
    recurrent caches, converted by ``caches_from_prefill``.

    ``mode="train"`` returns (h_final, the summed MoE load-balance loss)
    and keeps no caches.  Under ``cfg.remat`` each cycle of a scanned
    segment runs under ``remat.checkpoint`` (the reference checkpoints
    its scan body, in train mode only): backward recomputes the cycle
    from its inputs, the MoE's gather of its expert blocks included,
    instead of keeping its activations.

    With ``group`` the forward runs on that model group: ``params`` is
    ``weights.group_params`` of its positions' blocks, ``tokens`` and
    ``positions`` the group's batch rows on its root device, and x,
    pending and h_final Shards; the raw caches each position's."""
    assert mode in ("train", "prefill"), mode
    if group is not None:
        return _forward_tp(params, cfg, tokens, positions, group, mode)
    x = embed_tokens(params, cfg, tokens)
    B, S = x.shape[:2]
    if positions is None:
        positions = default_positions(cfg, B, S, device=x.device)
    angles = _angles(cfg, positions)
    if mode == "train":
        return _forward_train(params, cfg, x, angles)
    raw, pending = {}, None
    for kind, p, _, key in _layers(cfg, params, None):
        x, pending, raw[key], _ = blocks.apply(p, cfg, kind, x, pending,
                                               angles=angles)
    return x, pending, _nest(cfg, lambda kind, key: raw[key])


def _cycle_train(cyc_p, cfg, kinds, x, pending, angles):
    """One cycle of a segment in train mode: (x, pending, its aux)."""
    dev = x[0].device if isinstance(x, col.Shards) else x.device
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    for p, kind in zip(cyc_p, kinds):
        x, pending, _, a = blocks.apply(p, cfg, kind, x, pending,
                                        angles=angles)
        if a is not None:
            aux = aux + a
    return x, pending, aux


def _forward_train(params, cfg, x, angles):
    dev = x[0].device if isinstance(x, col.Shards) else x.device
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    pending = None
    segs = make_segments(cfg)
    for si, (seg, seg_p) in enumerate(zip(segs, params["segments"])):
        for c, cyc_p in enumerate(seg_p):
            span(si, c, seg.n_cycles)
            if seg.scanned and cfg.remat:
                x, pending, a = checkpoint(_cycle_train, cyc_p, cfg,
                                           seg.kinds, x, pending, angles)
            else:
                x, pending, a = _cycle_train(cyc_p, cfg, seg.kinds, x,
                                             pending, angles)
            aux = aux + a
    span(len(segs), 0, 1)
    if isinstance(x, col.Shards):
        return col.local(torch.add, x, pending), aux
    return x + pending, aux


def _embed_tp(params, cfg, tokens, group):
    """The group's embeddings as the residual stream: sequence-sharded
    when the group splits the sequence, else whole on every position.  A
    vocabulary-split table: each position looks up the tokens in its
    block (zero elsewhere) and a reduce-scatter over the sequence (an
    all-reduce) sums them (exact: one term is not zero); a whole table (a
    vocabulary the group does not divide) or embedding inputs: each
    position its own sequence block."""
    n = group.size
    split = 1 if col.seq_splits(tokens.shape[1], group) else None
    act = nn.dt(cfg.activation_dtype)
    scale = cfg.d_model ** 0.5 if cfg.embed_scale else None

    def finish(x):
        return x * torch.tensor(scale, dtype=x.dtype) if scale else x

    def rows(m):
        return tokens.chunk(n, 1)[m] if split else tokens
    if not cfg.embed_inputs:
        return col.Shards([finish(rows(m).to(d, act))
                           for m, d in enumerate(group.devices)], group,
                          split)
    table = params["embed"]["embed_table"]
    if table[0].shape[0] == cfg.vocab_size:
        return col.Shards([finish(table[m][rows(m).to(d).long()].to(act))
                           for m, d in enumerate(group.devices)], group,
                          split)
    parts = []
    for m, d in enumerate(group.devices):
        v_local = table[m].shape[0]
        loc = tokens.to(d).long() - m * v_local
        ok = (loc >= 0) & (loc < v_local)
        e = table[m][torch.clamp(loc, 0, v_local - 1)].to(act)
        parts.append(torch.where(ok[..., None], e, torch.zeros((), dtype=act,
                                                               device=d)))
    red = col.reduce_scatter(parts, group, 1, "embed") if split \
        else col.all_reduce(parts, group, "embed")
    return col.Shards([finish(x) for x in red], group, split)


def _group_angles(cfg, positions, group):
    return col.PerPos(_angles(cfg, positions.to(d))
                      for d in group.devices) if cfg.rope else None


def _forward_tp(params, cfg, tokens, positions, group, mode):
    x = _embed_tp(params, cfg, tokens, group)
    B, S = tokens.shape[:2]
    if positions is None:
        positions = default_positions(cfg, B, S, device=group.root)
    angles = _group_angles(cfg, positions, group)
    if mode == "train":
        return _forward_train(params, cfg, x, angles)
    raw, pending = {}, None
    for kind, p, _, key in _layers(cfg, params, None):
        x, pending, raw[key], _ = blocks.apply(p, cfg, kind, x, pending,
                                               angles=angles)
    return x, pending, _nest(cfg, lambda kind, key: raw[key])


def _head_tp(params, cfg, h):
    """The vocabulary-parallel head of ``h`` (Shards, whole on every
    position): each position's (B, ..., V/n) fp32 logits, softcapped,
    gathered to the group's root."""
    tied = cfg.tie_embeddings and cfg.embed_inputs
    logits = col.local(lambda hm, wm: nn.softcap(
        nn.matmul(hm, wm.T if tied else wm, torch.float32),
        cfg.logit_softcap), h, _head_weight_blocks(params, cfg))
    root = h.group.root
    return torch.cat([l if m == 0 else col.send(l, root, "head",
                                                "all_gather")
                      for m, l in enumerate(logits)], -1) \
        if logits[0].shape[-1] != cfg.vocab_size else logits[0]


def _final_norm_tp(params, cfg, x, pending):
    return col.local(lambda a, b, sc: nn.add_rmsnorm(
        a, b, sc, cfg.norm_eps, cfg.impl)[1], x, pending,
        params["final_norm"]["scale"])


def _last_logits_tp(params, cfg, x, pending):
    """Next-token logits (B,1,V) of a group's prefill, on its root: the
    last row lives on the last position of a sequence split; its norm
    there, sent to every position for the head."""
    g = x.group
    if x.split is None:
        last = col.Shards([t[:, -1:] for t in x], g, None)
        pend = col.Shards([t[:, -1:] for t in pending], g, None)
        return _head_tp(params, cfg, _final_norm_tp(params, cfg, last, pend))
    h = nn.add_rmsnorm(x[-1][:, -1:], pending[-1][:, -1:],
                       params["final_norm"]["scale"][-1], cfg.norm_eps,
                       cfg.impl)[1]
    return _head_tp(params, cfg, col.Shards(
        [h if m == g.size - 1 else col.send(h, d, "head", "broadcast")
         for m, d in enumerate(g.devices)], g, None))


def final_norm(params, cfg, x, pending):
    """The last residual add fused with the final norm."""
    return nn.add_rmsnorm(x, pending, params["final_norm"]["scale"],
                          cfg.norm_eps, cfg.impl)[1]


def last_logits(params, cfg, x, pending):
    """Next-token logits (B,1,V) of the last position of a prefill."""
    return head_logits(params, cfg, final_norm(params, cfg, x[:, -1:],
                                               pending[:, -1:]))


# ---------------------------------------------------------------------------
# loss (chunked cross-entropy over the sequence)
# ---------------------------------------------------------------------------
LOSS_CHUNK = 512  # sequence chunk of the cross-entropy


def _head_weight(params, cfg):
    """(D, V) head matrix (the transposed embedding when tied)."""
    if cfg.tie_embeddings and cfg.embed_inputs:
        return params["embed"]["embed_table"].T
    return params["head"]["head_w"]


def _local_ce(logits, labels_c, mask_c, v_offset, v_local, softcap):
    """CE of fp32 logits (B,Sc,v_local) whose vocabulary starts at
    ``v_offset``.  Returns (the masked NLL's sum, the mask's sum).  The
    max is held constant for the gradient (the reference's
    ``stop_gradient``): d(lse)/d(logits) is the softmax either way."""
    if softcap is not None:
        logits = nn.softcap(logits, softcap)
    m = logits.max(-1).values.detach()
    s = torch.exp(logits - m[..., None]).sum(-1)
    lse = m + torch.log(s)
    loc = labels_c.long() - v_offset
    in_range = (loc >= 0) & (loc < v_local)
    loc = torch.clamp(loc, 0, v_local - 1)
    correct = logits.gather(-1, loc[..., None])[..., 0]
    correct = torch.where(in_range, correct, 0.0)
    nll = (lse - correct) * mask_c
    return nll.sum(), mask_c.sum()


def _chunk_ce(w, cfg, h_c, labels_c, mask_c):
    """One sequence chunk of CE against the (D, V) head ``w``: fp32
    logits (``modules.matmul``), softcap applied here."""
    logits = nn.matmul(h_c, w, torch.float32)
    return _local_ce(logits, labels_c, mask_c, 0, cfg.vocab_size,
                     cfg.logit_softcap)


def _chunk_ce_tp(w, cfg, h_c, labels_c, mask_c):
    """One sequence chunk of vocabulary-parallel CE on a model group:
    ``h_c`` the full chunk on every position (Shards), ``w`` the
    positions' (D, V/tp) head blocks.  The max, the sum of exps and the
    correct logit cross positions as (B, Sc) tensors, to the group's
    root, where the chunk's (nll sum, mask sum) is formed; the
    reference's ``_chunk_ce`` shard_map body.  A vocabulary the group does
    not divide leaves the head whole on every position: the root alone
    computes the chunk (the reference's fallback)."""
    g = h_c.group
    labels_c, mask_c = labels_c.to(g.root), mask_c.to(g.root)
    if w[0].shape[1] == cfg.vocab_size:
        return _chunk_ce(w[0], cfg, h_c[0], labels_c, mask_c)
    v_local = w[0].shape[1]
    logits = col.local(lambda h, wm: nn.softcap(
        nn.matmul(h, wm, torch.float32), cfg.logit_softcap), h_c, w)
    m_root = col.all_reduce_to_root([l.max(-1).values.detach()
                                     for l in logits], g, "ce", op="max")
    m = col.broadcast(m_root, g, "ce")
    s = col.all_reduce_to_root([torch.exp(l - m[q][..., None]).sum(-1)
                                for q, l in enumerate(logits)], g, "ce")
    lse = m_root + torch.log(s)

    def correct(q, l):
        loc = labels_c.to(l.device).long() - q * v_local
        ok = (loc >= 0) & (loc < v_local)
        c = l.gather(-1, torch.clamp(loc, 0, v_local - 1)[..., None])[..., 0]
        return torch.where(ok, c, 0.0)
    corr = col.all_reduce_to_root([correct(q, l) for q, l in
                                   enumerate(logits)], g, "ce")
    nll = (lse - corr) * mask_c
    return nll.sum(), mask_c.sum()


def ce_sums(params, cfg, h, labels, mask):
    """The chunked CE's (masked NLL sum, mask sum): the chunk is
    ``LOSS_CHUNK`` positions, shrunk until it divides S, and each chunk
    runs under ``remat.checkpoint`` (the reference's checkpointed scan
    body), so that neither the forward nor the backward holds (B, S,
    V) fp32 logits at once.  On a model group ``h`` is the
    sequence-sharded Shards: it is gathered to the full sequence on every
    position (the reference's ``h`` replicated over "model") and each
    chunk is vocabulary-parallel (``_chunk_ce_tp``)."""
    tp = isinstance(h, col.Shards)
    if tp:
        h = col.gather_seq(h)
        w = col.PerPos(t.T if cfg.tie_embeddings and cfg.embed_inputs
                       else t for t in _head_weight_blocks(params, cfg))
        chunk_ce, dev = _chunk_ce_tp, h.group.root
        B, S, D = h[0].shape
    else:
        w = _head_weight(params, cfg)
        chunk_ce, dev = _chunk_ce, h.device
        B, S, D = h.shape
    c = min(LOSS_CHUNK, S)
    while S % c:
        c -= 1
    n = S // c
    if n == 1:
        return chunk_ce(w, cfg, h, labels, mask)
    tot = torch.zeros((), dtype=torch.float32, device=dev)
    cnt = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(n):
        sl = slice(i * c, (i + 1) * c)
        h_c = col.Shards([t[:, sl] for t in h], h.group, None) if tp \
            else h[:, sl]
        t, k = checkpoint(chunk_ce, w, cfg, h_c, labels[:, sl],
                          mask[:, sl])
        tot, cnt = tot + t, cnt + k
    return tot, cnt


def _head_weight_blocks(params, cfg):
    if cfg.tie_embeddings and cfg.embed_inputs:
        return params["embed"]["embed_table"]
    return params["head"]["head_w"]


def cross_entropy(params, cfg, h, labels, mask):
    """Chunked CE (``ce_sums``): the masked NLL's mean."""
    tot, cnt = ce_sums(params, cfg, h, labels, mask)
    return tot / torch.clamp(cnt, min=1.0)


def loss_sums(params, cfg: ModelConfig, batch, group=None):
    """The sums a mesh's train step adds over its data groups: ``tot``
    and ``cnt``, the CE's masked NLL sum and mask sum (the reference's
    ``_chunk_ce`` sums both over the batch axes, so the step divides by
    the whole batch's count), ``aux``, this group's summed MoE
    load-balance loss (the step averages it over the groups, the
    reference's ``pmean``), and with DeepSeek's MTP head ``mtp_tot`` and
    ``mtp_cnt``.  With ``group`` the forward and the CE run on that model
    group (``forward``)."""
    h, aux = forward(params, cfg, batch["tokens"], batch.get("positions"),
                     mode="train", group=group)
    hn = blocks._norm(params["final_norm"]["scale"], cfg, h)
    tot, cnt = ce_sums(params, cfg, hn, batch["labels"], batch["mask"])
    out = {"tot": tot, "cnt": cnt, "aux": aux}
    if cfg.mtp_depth and "mtp" in params:
        out["mtp_tot"], out["mtp_cnt"] = _mtp_sums(
            params, cfg, h, batch["labels"], batch["mask"], group)
    return out


def loss_fn(params, cfg: ModelConfig, batch):
    """batch: tokens (B,S) ids or (B,S,D) embeddings, labels (B,S), mask
    (B,S) fp32, optional positions.  Returns (loss, metrics): ``ce``,
    ``moe_aux``, ``loss`` and, with DeepSeek's MTP head, ``mtp_ce``."""
    tokens = batch["tokens"]
    h, aux = forward(params, cfg, tokens, batch.get("positions"),
                     mode="train")
    hn = nn.rmsnorm(h, params["final_norm"]["scale"], cfg.norm_eps,
                    cfg.impl)
    ce = cross_entropy(params, cfg, hn, batch["labels"], batch["mask"])
    loss = ce
    metrics = {"ce": ce, "moe_aux": aux}
    if cfg.moe is not None:
        loss = loss + cfg.moe.aux_loss_coef * aux
    if cfg.mtp_depth and "mtp" in params:
        mtp_ce = _mtp_loss(params, cfg, h, batch["labels"], batch["mask"])
        loss = loss + 0.3 * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    metrics["loss"] = loss
    return loss, metrics


def _mtp_loss(params, cfg, h, labels, mask):
    """DeepSeek multi-token prediction: one extra block predicts t+2."""
    tot, cnt = _mtp_sums(params, cfg, h, labels, mask)
    return tot / torch.clamp(cnt, min=1.0)


def _mtp_sums(params, cfg, h, labels, mask, group=None):
    """The MTP head's CE sums (``ce_sums``).  On a model group ``h`` is
    the sequence-sharded Shards, the next tokens are embedded the same
    way and each position projects its rows with the whole mtp_proj
    (its column blocks all-gathered)."""
    p = params["mtp"]
    B, S = labels.shape
    kind = make_segments(cfg)[-1].kinds[-1]
    if group is not None:
        hn = blocks._norm(p["norm_h"]["scale"], cfg, h)
        en = blocks._norm(p["norm_e"]["scale"], cfg,
                          _embed_tp(params, cfg, labels, group))
        w = col.full_cols(col.Shards(list(p["mtp_proj"]), group, 1),
                          cfg.d_model, "mtp")
        h_in = col.local(lambda a, b, wm: nn.matmul(torch.cat([a, b], -1),
                                                    wm), hn, en, w)
        angles = _group_angles(cfg, default_positions(
            cfg, B, S, device=group.root), group)
        x, pending, _, _ = blocks.apply(p["block"], cfg, kind, h_in, None,
                                        angles=angles)
        h_mtp = _final_norm_tp({"final_norm": p["final_norm"]}, cfg, x,
                               pending)
    else:
        e_next = embed_tokens(params, cfg, labels)  # token t+1's embedding
        hn = nn.rmsnorm(h, p["norm_h"]["scale"], cfg.norm_eps, cfg.impl)
        en = nn.rmsnorm(e_next, p["norm_e"]["scale"], cfg.norm_eps, cfg.impl)
        h_in = nn.matmul(torch.cat([hn, en], -1), p["mtp_proj"])
        angles = _angles(cfg, default_positions(cfg, B, S, device=h.device))
        x, pending, _, _ = blocks.apply(p["block"], cfg, kind, h_in, None,
                                        angles=angles)
        h_mtp = nn.add_rmsnorm(x, pending, p["final_norm"]["scale"],
                               cfg.norm_eps, cfg.impl)[1]
    # targets: token t+2 = labels shifted left by one
    labels2 = torch.cat([labels[:, 1:], labels[:, -1:]], 1)
    mask2 = torch.cat([mask[:, 1:], torch.zeros_like(mask[:, -1:])], 1)
    return ce_sums(params, cfg, h_mtp, labels2, mask2)


# ---------------------------------------------------------------------------
# prefill / dense decode (the oracle path)
# ---------------------------------------------------------------------------
def caches_from_prefill(cfg, raw_caches, max_len: int, group=None):
    return _nest(cfg, lambda kind, key: blocks.cache_from_prefill(
        cfg, kind, raw_caches[key[0]][key[1]][key[2]], max_len, group))


def prefill(params, cfg, tokens, *, max_len: int, positions=None,
            group=None):
    """Returns (next-token logits (B,1,V), decode caches).  With
    ``group`` (its ``weights.group_params``) the prefill runs on that
    model group; the logits are on its root and the caches each
    position's (``blocks.cache_from_prefill``)."""
    x, pending, raw = forward(params, cfg, tokens, positions, group=group)
    caches = caches_from_prefill(cfg, raw, max_len, group)
    if group is not None:
        return _last_logits_tp(params, cfg, x, pending), caches
    return last_logits(params, cfg, x, pending), caches


def init_caches(cfg, batch: int, max_len: int, device):
    dtype = nn.dt(cfg.activation_dtype)
    return _nest(cfg, lambda kind, key: blocks.cache_init(
        cfg, kind, batch, max_len, dtype, device))


def decode_step(params, cfg, tokens, caches, pos, group=None):
    """One decode step. tokens (B,1) ids or (B,1,D) embeddings; pos int
    (shared position; under M-RoPE every plane's).  With ``group`` the
    step runs on that model group (``prefill``'s caches of it).

    Returns (logits (B,1,V), new caches)."""
    if group is not None:
        x = _embed_tp(params, cfg, tokens, group)
        dev = group.root
    else:
        x = embed_tokens(params, cfg, tokens)
        dev = x.device
    lead = (3,) if cfg.mrope_sections is not None else ()
    positions = torch.full(lead + (tokens.shape[0], 1), int(pos),
                           dtype=torch.int32, device=dev)
    angles = _angles(cfg, positions) if group is None \
        else _group_angles(cfg, positions, group)
    new, pending = {}, None
    for kind, p, cache, key in _layers(cfg, params, caches):
        x, pending, new[key] = blocks.apply_decode(
            p, cfg, kind, x, pending, cache, int(pos), angles=angles)
    caches = _nest(cfg, lambda kind, key: new[key])
    if group is not None:
        return _head_tp(params, cfg, _final_norm_tp(params, cfg, x,
                                                    pending)), caches
    h = final_norm(params, cfg, x, pending)
    return head_logits(params, cfg, h), caches


# ---------------------------------------------------------------------------
# paged decode — pools + block tables instead of per-sequence slabs
# ---------------------------------------------------------------------------
def paged_decodable(cfg) -> bool:
    """Paged serving needs causal, embedded-token, global-attention-only
    configs and no M-RoPE."""
    return (cfg.supports_decode and cfg.embed_inputs
            and cfg.mrope_sections is None
            and all(k == "attn" for k in cfg.layer_kinds))


def init_paged_caches(cfg, n_pages: int, page_size: int, device):
    """One PagedAttnCache per layer; all layers share one block table.
    Under a sharding environment that stripes "pages" (the paged engine
    with a mesh), one StripedPagedCache per layer instead, its stripes on
    the mesh's devices; every paged pass below takes either."""
    assert paged_decodable(cfg), f"{cfg.name} is not paged-decodable"
    dtype = nn.dt(cfg.activation_dtype)
    return _nest(cfg, lambda kind, key: blocks.paged_cache_init(
        cfg, kind, n_pages, page_size, dtype, device))


def paged_from_prefill(cfg, pools, raw_caches, block_row):
    """Scatter ONE sequence's prefill kv (from ``forward``, batch 1) into the pools at the pages named by ``block_row``, in
    place."""
    for si, seg in enumerate(make_segments(cfg)):
        for c in range(seg.n_cycles):
            for j, kind in enumerate(seg.kinds):
                blocks.paged_cache_from_prefill(
                    cfg, kind, pools[si][c][j], raw_caches[si][c][j],
                    block_row)
    return pools


def decode_step_paged(params, cfg, tokens, pools, block_tables, pos):
    """One paged decode step over a continuous batch.

    tokens (B,1) int32; block_tables (B,nmax) int32 physical page ids;
    pos (B,) int32 per-sequence positions (inactive slots: 0, with a
    null-page block row).  Returns (logits (B,1,V), pools updated in
    place)."""
    x = embed_tokens(params, cfg, tokens)
    angles = _angles(cfg, pos[:, None].to(torch.int32))
    pending = None
    for kind, p, pool, _ in _layers(cfg, params, pools):
        x, pending, _ = blocks.apply_decode_paged(
            p, cfg, kind, x, pending, pool, block_tables, pos, angles=angles)
    h = final_norm(params, cfg, x, pending)
    return head_logits(params, cfg, h), pools


def decode_window_paged(params, cfg, tokens, pools, block_tables, pos,
                        active, k: int):
    """Fused K-step greedy decode window, entirely on device.

    The reference's ``lax.scan`` becomes a Python loop over device
    tensors: the greedy argmax of step j feeds step j+1 with no host
    round-trip, KV pages are appended in place, and per-slot positions
    advance on device.  The block tables stay fixed for the window (the
    scheduler pre-reserves its pages).

    tokens (B,1) int32 last emitted token per slot; pos (B,) int32 write
    positions; active (B,) int32 1 for occupied slots (inactive slots hold
    token/pos fixed so their null-page writes stay at slot 0).
    Returns (emitted (B,K) int32, last tokens (B,1), pos (B,), pools).
    """
    tok, p = tokens, pos
    emitted = []
    for _ in range(k):
        logits, pools = decode_step_paged(params, cfg, tok, pools,
                                          block_tables, p)
        nxt = logits.argmax(-1).to(torch.int32)                  # (B,1)
        tok = torch.where(active[:, None] > 0, nxt, tok)
        p = p + active
        emitted.append(tok[:, 0])
    return torch.stack(emitted, dim=1), tok, p, pools


# ---------------------------------------------------------------------------
# paged suffix prefill — prefix-cache hits, prefill chunks, verify windows
# ---------------------------------------------------------------------------
def _suffix_forward_paged(params, cfg, tokens, pools, block_row, start,
                          n_valid):
    """Shared body of :func:`prefill_suffix_paged`,
    :func:`chunk_prefill_paged` and :func:`verify_window_paged`: run a
    W-token continuation (positions start..start+W-1) through every
    layer's ``apply_prefill_paged``, scattering its kv into the
    sequence's pages and attending causally over the whole page run.
    ``start`` and ``n_valid`` are ints or 0-d device tensors.  Returns
    (x, pending, pools) as ``forward`` does; the pools are updated in
    place.  A 1-token continuation runs as a 2-row window whose second
    row is padding (to the null page, as every pad row): a single-row
    product sums in another order than a multi-row one, and a window of
    two rows gives the bits of any wider window, so a 1-token chunk
    writes the KV and ends in the logits of one suffix pass."""
    W = tokens.shape[1]
    if W == 1:
        x, pending, pools = _suffix_forward_paged(
            params, cfg, torch.cat([tokens, torch.zeros_like(tokens)], 1),
            pools, block_row, start, n_valid)
        return x[:, :1], pending[:, :1], pools
    x = embed_tokens(params, cfg, tokens)
    B = tokens.shape[0]
    positions = (start + torch.arange(W, dtype=torch.int32,
                                      device=x.device)).to(torch.int32)
    angles = _angles(cfg, positions[None].expand(B, W))
    pending = None
    for kind, p, pool, _ in _layers(cfg, params, pools):
        x, pending, _ = blocks.apply_prefill_paged(
            p, cfg, kind, x, pending, pool, block_row, start, n_valid,
            angles=angles)
    return x, pending, pools


def prefill_suffix_paged(params, cfg, tokens, pools, block_row, start,
                         n_valid):
    """Prefill of a prompt *suffix* against the paged pools — the
    prefix-cache hit path.  The cached prefix (positions 0..start-1)
    already lives in the pages named by ``block_row``; only the uncached
    suffix runs through the model, in one batched pass.

    tokens (1,W) int32 suffix ids, padded to a bucket width W; ``start``
    the cached-prefix length; ``n_valid`` (an int) the true suffix
    length (padded slots scatter to the null page).  Returns (next-token
    logits (1,1,V) at the last *valid* suffix position — the request's
    first generated token — and the pools).  Row ``n_valid - 1`` of x
    and of the pending branch output is taken before the final norm,
    which normalises each row on its own: the same bits as normalising
    the whole window."""
    x, pending, pools = _suffix_forward_paged(params, cfg, tokens, pools,
                                              block_row, start, n_valid)
    last = slice(n_valid - 1, n_valid)
    h = final_norm(params, cfg, x[:, last], pending[:, last])
    return head_logits(params, cfg, h), pools


def chunk_prefill_paged(params, cfg, tokens, pools, block_row, start,
                        n_valid):
    """One slice of a chunked prefill: positions ``start ..
    start+n_valid-1`` of a prompt whose earlier KV (cached prefix or
    earlier chunks) is already in the pages named by ``block_row``.  A
    chunk at ``start`` IS a suffix continuation at ``start``, so
    composing chunks writes the same KV, in the same order, with the
    same arithmetic, as one pass.  Only the final chunk's logits are
    read (the first generated token)."""
    return prefill_suffix_paged(params, cfg, tokens, pools, block_row,
                                start, n_valid)


def verify_window_paged(params, cfg, tokens, pools, block_row, start,
                        n_valid):
    """Speculative-decoding verification: score K+1 continuation
    positions of ONE sequence in one pass.

    ``tokens`` (1,W) holds [last emitted token, draft_1..draft_K] padded
    to a pow2 width W; ``start`` is the sequence's KV write position and
    ``n_valid`` = K+1.  Returns (logits (1,W,V) at every position —
    position j's argmax is the model's next token after input j — and
    the pools).  Rejected positions' KV stays in the pages, masked by
    position and overwritten before the write position reaches it."""
    x, pending, pools = _suffix_forward_paged(params, cfg, tokens, pools,
                                              block_row, start, n_valid)
    return head_logits(params, cfg, final_norm(params, cfg, x, pending)), \
        pools
