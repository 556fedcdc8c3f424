"""The port's kernel wrappers on the CPU against the JAX reference.

On a CPU tensor each wrapper of ``repro_torch.kernels.ops`` runs its plain
PyTorch version; these tests hold that version against the reference's
Pallas kernels (interpret mode, as ``tests/test_kernels.py`` runs them) and
against its ``ref.py`` oracles, on the same numpy inputs.  The CUDA
kernels themselves are held against the same plain versions on the card by
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops, ref as jref
from repro_torch.kernels import ops, ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _randn(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _both(x, dtype):
    """The same values as a JAX array and a CPU torch tensor of ``dtype``
    (both round fp32 -> bf16 to nearest even)."""
    return (jnp.asarray(x).astype(JDT[dtype]),
            torch.tensor(x).to(TDT[dtype]))


def _err(j, t):
    return float(np.abs(np.asarray(j, np.float32)
                        - t.float().numpy()).max())


def _modes(mode):
    return dict(causal=mode != "bidir",
                window={"window": 64, "window40": 40}.get(mode),
                softcap=30.0 if mode == "softcap" else None)


# --- flash attention (tests/test_kernels.py:24-40) ---------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 128, 2, 64), (2, 256, 4, 64),
                                   (1, 192, 3, 128), (1, 130, 2, 256)])
@pytest.mark.parametrize("mode", ["causal", "window", "bidir", "softcap",
                                  "window40"])
def test_flash_plain_matches_reference_oracle(shape, dtype, mode):
    """Shapes and masks the kernel's tiles meet: hd 256 (four 64-column
    boxes a row), S not a multiple of the 64-key tiles, and a window of 40
    whose band starts in the middle of a tile."""
    rng = np.random.default_rng(11)
    (qj, qt), (kj, kt), (vj, vt) = (_both(_randn(rng, shape), dtype)
                                    for _ in range(3))
    kw = _modes(mode)
    o = ops.flash_attention(qt, kt, vt, **kw)
    assert o.dtype == qt.dtype and o.shape == qt.shape
    err = _err(jref.flash_attention(qj, kj, vj, **kw), o)
    assert err < TOL[dtype], (shape, dtype, mode, err)


@pytest.mark.parametrize("dtype,mode", [("float32", "causal"),
                                        ("float32", "window"),
                                        ("float32", "bidir"),
                                        ("float32", "softcap"),
                                        ("bfloat16", "causal")])
def test_flash_plain_matches_pallas_kernel(dtype, mode):
    rng = np.random.default_rng(12)
    shape = (1, 128, 2, 64)
    (qj, qt), (kj, kt), (vj, vt) = (_both(_randn(rng, shape), dtype)
                                    for _ in range(3))
    kw = _modes(mode)
    o_kernel = jops.flash_attention(qj, kj, vj, block_q=64, block_kv=64, **kw)
    err = _err(o_kernel, ops.flash_attention(qt, kt, vt, **kw))
    assert err < TOL[dtype], (dtype, mode, err)


# --- paged decode attention (tests/test_serving.py:129-205) ------------------
def _paged_inputs(rng, B, H, hd, Kv, ps, nmax, dtype):
    P = 1 + B * nmax
    q = _both(_randn(rng, (B, H, hd)), dtype)
    kp = _both(_randn(rng, (P, ps, Kv, hd)), dtype)
    vp = _both(_randn(rng, (P, ps, Kv, hd)), dtype)
    bt = (1 + rng.permutation(B * nmax)).reshape(B, nmax).astype(np.int32)
    return q, kp, vp, bt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ps,nmax,Kv,G", [(8, 4, 2, 4), (16, 2, 1, 8),
                                          (4, 3, 4, 1), (8, 4, 2, 6),
                                          (16, 3, 1, 16)])
def test_paged_decode_plain_matches_reference(ps, nmax, Kv, G, dtype):
    rng = np.random.default_rng(3)
    B, hd = 3, 64
    (qj, qt), (kj, kt), (vj, vt), bt = _paged_inputs(rng, B, Kv * G, hd, Kv,
                                                     ps, nmax, dtype)
    pos = np.array([nmax * ps - 1, ps + 3, 0], np.int32)   # ragged, pos 0
    o = ops.paged_decode_attention(qt, kt, vt, torch.tensor(bt),
                                   torch.tensor(pos))
    assert o.dtype == qt.dtype and o.shape == qt.shape
    err = _err(jref.paged_decode_attention(qj, kj, vj, jnp.asarray(bt),
                                           jnp.asarray(pos)), o)
    assert err < TOL[dtype], err
    if dtype == "float32":
        o_kernel = jops.paged_decode_attention(qj, kj, vj, jnp.asarray(bt),
                                               jnp.asarray(pos))
        assert _err(o_kernel, o) < TOL[dtype]


def test_paged_decode_matches_dense_decode_per_sequence():
    """Gathering a sequence's pages and attending densely gives the same
    output as the paged path (the reference's dense decode oracle)."""
    rng = np.random.default_rng(4)
    B, Kv, G, hd, ps, nmax = 2, 2, 2, 32, 4, 3
    (qj, qt), (kj, kt), (vj, vt), bt = _paged_inputs(
        rng, B, Kv * G, hd, Kv, ps, nmax, "float32")
    pos = np.array([9, 4], np.int32)
    o = ops.paged_decode_attention(qt, kt, vt, torch.tensor(bt),
                                   torch.tensor(pos))
    for b in range(B):
        kc = kj[bt[b]].reshape(1, nmax * ps, Kv, hd)
        vc = vj[bt[b]].reshape(1, nmax * ps, Kv, hd)
        dense = jref.decode_attention(qj[b:b + 1], kc, vc, int(pos[b]))
        assert _err(dense, o[b:b + 1]) < 1e-6


@pytest.mark.parametrize("pos", [0, 3])
def test_paged_decode_ignores_null_page_garbage(pos):
    """Padded table slots name the null page 0; poisoning it must not
    change a bit of the output (pos 0 reads slot 0 of page 1 only)."""
    rng = np.random.default_rng(5)
    q = torch.tensor(_randn(rng, (1, 4, 32)))
    k = torch.tensor(_randn(rng, (4, 4, 2, 32)))
    v = torch.tensor(_randn(rng, (4, 4, 2, 32)))
    bt = torch.tensor([[1, 0, 0]], dtype=torch.int32)
    p = torch.tensor([pos], dtype=torch.int32)
    o1 = ops.paged_decode_attention(q, k, v, bt, p)
    k[0], v[0] = 1e6, -1e6
    assert torch.equal(o1, ops.paged_decode_attention(q, k, v, bt, p))


# --- recurrent scans (tests/test_kernels.py:59-86), plus S=1 and a prime S --
def _rglru_inputs(rng, B, S, W):
    a = 1 / (1 + np.exp(-_randn(rng, (B, S, W)))) * 0.2 + 0.79
    return (a.astype(np.float32), _randn(rng, (B, S, W)) * 0.1,
            _randn(rng, (B, W)))


@pytest.mark.parametrize("S,W", [(64, 128), (256, 256), (128, 512), (1, 128),
                                 (37, 96)])
def test_rglru_scan_plain_matches_reference(S, W):
    rng = np.random.default_rng(7)
    a, b, h0 = _rglru_inputs(rng, 2, S, W)
    hs, hT = ops.rglru_scan(*(torch.tensor(x) for x in (a, b, h0)))
    assert hs.dtype == hT.dtype == torch.float32
    assert hs.shape == (2, S, W) and hT.shape == (2, W)
    for fn in (jref.rglru_scan, jops.rglru_scan):
        hs_j, hT_j = fn(*(jnp.asarray(x) for x in (a, b, h0)))
        assert _err(hs_j, hs) < 1e-5 and _err(hT_j, hT) < 1e-5


def _rwkv_inputs(rng, B, S, H, K):
    r, k, v = (_randn(rng, (B, S, H, K)) for _ in range(3))
    lw = -np.exp(_randn(rng, (B, S, H, K)) - 1.0).astype(np.float32)
    u = _randn(rng, (H, K)) * 0.1
    S0 = _randn(rng, (B, H, K, K))
    return r, k, v, lw, u, S0


@pytest.mark.parametrize("S,H,K,chunk", [(64, 2, 32, 16), (128, 1, 64, 32),
                                         (96, 3, 16, 32), (1, 2, 16, 32),
                                         (67, 2, 16, 32)])
def test_rwkv6_scan_plain_matches_reference(S, H, K, chunk):
    rng = np.random.default_rng(8)
    inputs = _rwkv_inputs(rng, 2, S, H, K)
    o, s = ops.rwkv6_scan(*(torch.tensor(x) for x in inputs))
    assert o.dtype == s.dtype == torch.float32
    assert o.shape == (2, S, H, K) and s.shape == (2, H, K, K)
    o_r, s_r = jref.rwkv6_scan(*(jnp.asarray(x) for x in inputs))
    assert _err(o_r, o) < 2e-3 and _err(s_r, s) < 2e-3
    o_k, s_k = jops.rwkv6_scan(*(jnp.asarray(x) for x in inputs),
                               chunk=chunk)
    assert _err(o_k, o) < 2e-3 and _err(s_k, s) < 2e-3


def test_rwkv6_scan_plain_takes_bf16_rkv_with_fp32_state():
    """The model's mixed operands: r/k/v in the activation dtype, lw, u
    and S0 in fp32; the output and state are fp32 either way."""
    rng = np.random.default_rng(9)
    r, k, v, lw, u, S0 = _rwkv_inputs(rng, 2, 9, 2, 16)
    rkv = [_both(x, "bfloat16") for x in (r, k, v)]
    o, s = ops.rwkv6_scan(*(t for _, t in rkv), torch.tensor(lw),
                          torch.tensor(u), torch.tensor(S0))
    assert o.dtype == s.dtype == torch.float32
    o_r, s_r = jref.rwkv6_scan(*(j for j, _ in rkv), jnp.asarray(lw),
                               jnp.asarray(u), jnp.asarray(S0))
    assert _err(o_r, o) < 2e-3 and _err(s_r, s) < 2e-3


def _rwkv6_subchunks(r, k, v, lw, u, S0, L=32, sub=16):
    """A CPU transcription of the chunk kernel's arithmetic
    (``csrc/rwkv6_scan.cu``) in fp32: chunks of L, the last one padded
    with lw = 0 and r = k = v = 0.  Every decay is the exp of a sum of
    log-decays over just the tokens it spans: q_int = r exp(la_prev),
    k_dec = k exp(la_L - la); in the off-diagonal sub-chunk block, r and k
    scaled relative to la at the end of the earlier sub-chunk; in the
    diagonal blocks, for s < t, the product of the step decays of the
    tokens between them; the bonus on the diagonal.  Returns (o, S_T, the
    largest exponent it evaluated)."""
    B, S, H, K = r.shape
    pad = -S % L
    r, k, v, lw = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
                   for x in (r, k, v, lw))
    st = S0.clone()
    os, top = [], -float("inf")

    def span(x, t0, t1):              # sum of log-decays of tokens t0..t1-1
        return x[:, t0:t1].sum(1) if t1 > t0 else torch.zeros_like(x[:, 0])

    def ex(x):
        nonlocal top
        top = max(top, float(x.max()))
        return torch.exp(x)

    for c0 in range(0, S + pad, L):
        rc, kc, vc, lwc = (x[:, c0:c0 + L] for x in (r, k, v, lw))
        w = ex(lwc)
        A = torch.zeros(B, H, L, L)
        for s0 in range(0, L, sub):                 # the diagonal blocks
            for t in range(s0, s0 + sub):
                p = torch.ones_like(rc[:, 0])
                for s in range(t - 1, s0 - 1, -1):
                    A[:, :, t, s] = (rc[:, t] * kc[:, s] * p).sum(-1)
                    p = p * w[:, s]
        for t0 in range(sub, L, sub):               # the off-diagonal ones
            for s0 in range(0, t0, sub):
                e = s0 + sub
                qt = torch.stack([rc[:, t] * ex(span(lwc, e, t))
                                  for t in range(t0, t0 + sub)], 1)
                kt = torch.stack([kc[:, s] * ex(span(lwc, s + 1, e))
                                  for s in range(s0, e)], 1)
                A[:, :, t0:t0 + sub, s0:e] = torch.einsum(
                    "bthk,bshk->bhts", qt, kt)
        diag = torch.einsum("bthk,bthk->bht", rc, u[None, None] * kc)
        A = A + torch.diag_embed(diag)
        qi = torch.stack([rc[:, t] * ex(span(lwc, 0, t)) for t in range(L)], 1)
        kd = torch.stack([kc[:, t] * ex(span(lwc, t + 1, L))
                          for t in range(L)], 1)
        o = torch.einsum("bthk,bhkv->bthv", qi, st) \
            + torch.einsum("bhts,bshv->bthv", A, vc)
        st = ex(span(lwc, 0, L))[..., None] * st + torch.einsum(
            "bshk,bshv->bhkv", kd, vc)
        os.append(o)
    return torch.cat(os, 1)[:, :S], st, top


@pytest.mark.parametrize("S,strong", [(77, False), (64, False), (1, False),
                                      (40, True), (77, True)])
def test_rwkv6_subchunk_factorization_matches_reference(S, strong):
    """The chunk kernel's sub-chunk factorization, transcribed on the CPU,
    against the JAX kernel (interpret mode) and its stepwise oracle within
    2e-3, on the reference test's decays and on strong ones, lw =
    -exp(N(0,1) + 2), where factoring the intra-chunk decay as
    exp(la_prev_t) exp(-la_s), with a positive exponent, overflows.  Every
    exponent the factorization evaluates is <= 0."""
    rng = np.random.default_rng(10)
    r, k, v, lw, u, S0 = _rwkv_inputs(rng, 2, S, 2, 16)
    if strong:
        lw = -np.exp(_randn(rng, lw.shape) + 2.0).astype(np.float32)
        with np.errstate(over="ignore"):
            assert not np.isfinite(np.exp(-np.cumsum(lw[:, :32], 1))).all()
    o, s, top = _rwkv6_subchunks(*(torch.tensor(x) for x in
                                   (r, k, v, lw, u, S0)))
    assert top <= 0.0
    for fn in (jref.rwkv6_scan, jops.rwkv6_scan):
        o_j, s_j = fn(*(jnp.asarray(x) for x in (r, k, v, lw, u, S0)))
        assert _err(o_j, o) < 2e-3 and _err(s_j, s) < 2e-3


@pytest.mark.parametrize("S", [1, 2, 16, 17, 77, 509, 512])
@pytest.mark.parametrize("V", [64, 40])
def test_rwkv6_plan_covers_every_token_and_column(S, V):
    """rwkv6_scan's plan at the served heads (B=8, H=32, K=V=64) and a
    narrow one: S = 1 takes the step kernel, whose CTAs take 16 columns of
    one (b, h) and cover V once; longer S the chunk kernel, one CTA per
    (b, h), whose chunks of 32 cover the tokens once, the last one
    ragged."""
    p = ops.rwkv6_plan(8, S, 32, 64, V)
    if S == 1:
        assert p.design == "step" and p.grid[1] == 8 * 32
        cols = ops.RWKV_STEP_COLS
        spans = [(i * cols, min(V, (i + 1) * cols)) for i in range(p.grid[0])]
        assert spans[0][0] == 0 and spans[-1][1] == V
        assert all(a < b for a, b in spans)
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    else:
        assert p.design == "chunks" and p.grid == (8 * 32, 1)
        assert (p.chunks - 1) * ops.RWKV_CHUNK + p.last == S
        assert 1 <= p.last <= ops.RWKV_CHUNK


# --- contiguous decode attention (tests/test_kernels.py:43-56) --------------
_DECODE_CASES = [(128, 2, 4, 17, 64), (256, 1, 8, 255, 64),
                 (192, 4, 1, 100, 64), (96, 2, 6, 0, 64),
                 (130, 1, 12, 129, 64), (64, 2, 16, 40, 64),
                 (80, 2, 6, 70, 256)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "T,Kv,G,pos,hd", _DECODE_CASES,
    ids=["-".join(map(str, c[:4])) + ("" if c[4] == 64 else f"-hd{c[4]}")
         for c in _DECODE_CASES])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_decode_attention_plain_matches_reference(T, Kv, G, pos, hd, dtype,
                                                  softcap):
    """G up to 16 query heads a kv head (the bf16 kernel's 16 tensor-core
    rows) and hd 256."""
    rng = np.random.default_rng(13)
    B = 2
    (qj, qt), (kj, kt), (vj, vt) = (
        _both(_randn(rng, shape), dtype)
        for shape in ((B, Kv * G, hd), (B, T, Kv, hd), (B, T, Kv, hd)))
    o = ops.decode_attention(qt, kt, vt, pos, softcap=softcap)
    assert o.dtype == qt.dtype and o.shape == qt.shape
    err = _err(jref.decode_attention(qj, kj, vj, pos, softcap=softcap), o)
    assert err < TOL[dtype], err
    o_kernel = jops.decode_attention(qj, kj, vj, jnp.int32(pos), block_t=64,
                                     softcap=softcap)
    assert _err(o_kernel, o) < TOL[dtype]


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("pairs", [8, 64, 1024])
@pytest.mark.parametrize("pos", [0, 31, 32, 575, 32767])
def test_decode_plan_covers_every_tile_once(pos, pairs, bf16):
    """The decode kernels' launch plan on a 132-SM card: split s takes
    tiles [s*tps, (s+1)*tps); every tile of slots 0..pos falls in exactly
    one split and no split is empty.  The bf16 kernel merges its splits in
    one thread-block cluster, so it never takes more than 8, and fills two
    CTAs an SM in one wave; the fp32 kernels aim at about four an SM."""
    tile = ops.DECODE_TILE[bf16]
    n_tiles = -(-(pos + 1) // tile)
    ns, tps = ops.decode_plan(pairs, pos + 1, 132, bf16)
    covered = [t for s in range(ns)
               for t in range(s * tps, min(n_tiles, (s + 1) * tps))]
    assert covered == list(range(n_tiles))
    assert all(s * tps < n_tiles for s in range(ns))
    if bf16:
        assert 1 <= ns <= ops.DECODE_CLUSTER
        want = min(n_tiles, ops.DECODE_CLUSTER, max(1, 2 * 132 // pairs))
        assert pairs * ns <= max(2 * 132, pairs)   # one wave at 2 an SM
    else:
        want = min(n_tiles, max(1, -(-4 * 132 // pairs)))
    assert ns <= want and -(-n_tiles // tps) == ns
    assert tps == -(-n_tiles // want)


# grok-1's six grouped GEMMs (chip_smoke.MOE_SHAPES) and the edge shapes of
# chip_smoke.MOE_CASES: C ragged against the row tile on both sides of the
# stream/wgmma threshold, D and F multiples of 8 but not of 64, E = 1, a K
# split that is uneven, and D, F not multiples of 8 (simt)
MOE_PLAN_SHAPES = [(4, 1280, 6144, 32768), (4, 1280, 32768, 6144),
                   (8, 160, 6144, 32768), (8, 160, 32768, 6144),
                   (8, 8, 6144, 32768), (8, 8, 32768, 6144),
                   (2, 24, 512, 264), (2, 72, 256, 136), (2, 200, 512, 264),
                   (2, 130, 264, 520), (1, 8, 6144, 1032),
                   (8, 8, 4104, 1032), (2, 70, 100, 90)]


def _moe_units(plan, E, C, D, F):
    """The work units of ``plan``'s grid, as csrc/moe_gemm.cu indexes it:
    (CTA, expert, rows [r0, r1) of C, columns [f0, f1) of F, depth
    [k0, k1) of D), clipped to the arrays, the CTA as its linear index in
    the grid.  A unit past an edge is dropped."""
    gx, gy, gz = plan.grid
    for e in range(gz):
        for by in range(gy):
            f0, f1 = by * plan.cols, min(F, (by + 1) * plan.cols)
            for bx in range(gx):
                if plan.regime == "stream":
                    r0, r1 = 0, min(C, plan.rows)
                    k0 = bx * plan.kps * ops.MOE_BK
                    k1 = min(D, (bx + 1) * plan.kps * ops.MOE_BK)
                else:
                    r0, r1 = bx * plan.rows, min(C, (bx + 1) * plan.rows)
                    k0, k1 = 0, D
                if r0 < r1 and f0 < f1 and k0 < k1:
                    yield ((e * gy + by) * gx + bx, e, r0, r1, f0, f1, k0,
                           k1)


def _partitions(ranges, n):
    """Sorted ranges [a, b) that tile [0, n) without gap or overlap."""
    ranges = sorted(ranges)
    return (ranges[0][0] == 0 and ranges[-1][1] == n
            and all(a[1] == b[0] for a, b in zip(ranges, ranges[1:])))


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("E,C,D,F", MOE_PLAN_SHAPES)
def test_moe_plan_covers_every_tile_once(E, C, D, F, sms):
    """moe_gemm's launch plan on an H100 SXM (132 SMs) and PCIe (114): its
    (expert, row tile, F tile, K range) units, as the kernels index the
    grid, cover every output element and every k exactly once, and no CTA
    of the grid is idle.  K is split at most 8 ways (the CTAs of a
    portable cluster), only by the stream kernel, whose MMA width holds
    all of C."""
    plan = ops.moe_plan(E, C, D, F, sms, True, True)
    units = list(_moe_units(plan, E, C, D, F))
    gx, gy, gz = plan.grid
    assert sorted({u[0] for u in units}) == list(range(gx * gy * gz))
    tiles = {}
    for _, e, r0, r1, f0, f1, k0, k1 in units:
        tiles.setdefault((e, r0, r1, f0, f1), []).append((k0, k1))
    for e in range(E):
        mine = [t for t in tiles if t[0] == e]
        rows = {(t[1], t[2]) for t in mine}
        cols = {(t[3], t[4]) for t in mine}
        assert _partitions(rows, C) and _partitions(cols, F)
        assert len(mine) == len(rows) * len(cols)
    assert len(tiles) == sum(1 for t in tiles if 0 <= t[0] < E)
    assert all(_partitions(ks, D) for ks in tiles.values())
    assert 1 <= plan.split <= ops.MOE_MAX_SPLIT
    if plan.regime == "stream":
        assert C <= plan.rows and plan.rows in ops.MOE_STREAM_N
        assert gx == plan.split
    else:
        assert plan.split == 1 and gx == -(-C // plan.rows)


def test_moe_plan_splits_where_the_grid_leaves_the_card_idle():
    """At C = 8 grok's down GEMM (384 CTAs of 32768 deep) splits K over a
    cluster into more CTAs than its up GEMM (2048 CTAs of 6144); the edge
    case of chip_smoke.py splits unevenly (D not a multiple of split x
    64)."""
    down = ops.moe_plan(8, 8, 32768, 6144, 132, True, True)
    up = ops.moe_plan(8, 8, 6144, 32768, 132, True, True)
    assert down.regime == up.regime == "stream"
    assert down.split > up.split >= 1
    assert np.prod(down.grid) > 2 * 132   # more than a wave of CTAs
    uneven = ops.moe_plan(8, 8, 4104, 1032, 132, True, True)
    assert uneven.split > 1 and 4104 % (uneven.split * ops.MOE_BK)
    assert ops.moe_plan(8, 160, 6144, 32768, 132, True, True).rows == 192
    assert ops.moe_plan(4, 1280, 6144, 32768, 132, True, True)[:3] == (
        "wgmma", 128, 256)


@pytest.mark.parametrize("x_bf16,w_bf16", [(True, True), (True, False),
                                           (False, True), (False, False)])
@pytest.mark.parametrize("D,F", [(512, 264), (100, 264), (512, 90),
                                 (6144, 32768)])
@pytest.mark.parametrize("C", [8, 160])
def test_moe_plan_takes_the_tensor_cores_only_where_tma_can(C, D, F, x_bf16,
                                                            w_bf16):
    """Only bf16 x bf16 with D and F multiples of 8 (16-byte row strides
    for TMA) reaches the wgmma and stream kernels; every other pair runs
    the fp32-core kernel over the whole of K."""
    plan = ops.moe_plan(2, C, D, F, 132, x_bf16, w_bf16)
    tc = x_bf16 and w_bf16 and D % 8 == 0 and F % 8 == 0
    assert (plan.regime in ("wgmma", "stream")) == tc
    if not tc:
        assert plan.regime == "simt" and plan.split == 1
        units = list(_moe_units(plan, 2, C, D, F))
        assert all((k0, k1) == (0, D) for *_, k0, k1 in units)


# --- grouped GEMM (tests/test_kernels.py:89-99) ------------------------------
def _moe_rel(j, t):
    ref_ = np.asarray(j, np.float32)
    return float(np.abs(ref_ - t.float().numpy()).max() / np.abs(ref_).max())


MOE_REL_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,D,F", [(2, 64, 128, 256), (4, 32, 256, 128),
                                     (3, 9, 40, 24)])
def test_moe_gemm_plain_matches_reference(E, C, D, F, dtype):
    rng = np.random.default_rng(14)
    xj, xt = _both(_randn(rng, (E, C, D)), dtype)
    wj, wt = _both(_randn(rng, (E, D, F)), dtype)
    o = ops.moe_gemm(xt, wt)
    assert o.dtype == xt.dtype and o.shape == (E, C, F)
    assert _moe_rel(jref.moe_gemm(xj, wj), o) < MOE_REL_TOL[dtype]
    o_kernel = jops.moe_gemm(xj, wj, block_c=32, block_f=128, block_d=64)
    assert _moe_rel(o_kernel, o) < MOE_REL_TOL[dtype]


@pytest.mark.parametrize("xt,wt", [("bfloat16", "float32"),
                                   ("float32", "bfloat16"),
                                   ("bfloat16", "bfloat16")])
def test_moe_gemm_plain_takes_mixed_operands_and_an_fp32_output(xt, wt):
    """The MoE path's calls: x and w each fp32 or bf16, widened to fp32
    as the TPU kernel widens them, the fp32 sum kept with
    ``out_dtype=float32`` (the reference's einsum with
    ``preferred_element_type=float32``)."""
    rng = np.random.default_rng(15)
    (xj, x), (wj, w) = (_both(_randn(rng, (2, 24, 48)), xt),
                        _both(_randn(rng, (2, 48, 40)), wt))
    o = ops.moe_gemm(x, w, out_dtype=torch.float32)
    assert o.dtype == torch.float32
    want = jnp.einsum("ecd,edf->ecf", xj, wj,
                      preferred_element_type=jnp.float32)
    assert _moe_rel(want, o) < 1e-6
    assert ops.moe_gemm(x, w).dtype == x.dtype


# --- RMSNorm (tests/test_kernels.py:102-111) ---------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,D", [(64, 128), (96, 256), (5, 2048)])
def test_rmsnorm_plain_matches_reference(N, D, dtype):
    rng = np.random.default_rng(16)
    xj, xt = _both(_randn(rng, (N, D)), dtype)
    s = _randn(rng, (D,))
    o = ops.rmsnorm(xt, torch.tensor(s))
    assert o.dtype == xt.dtype and o.shape == xt.shape
    assert _err(jref.rmsnorm(xj, jnp.asarray(s)), o) < TOL[dtype]
    o_kernel = jops.rmsnorm(xj, jnp.asarray(s), block_rows=32)
    assert _err(o_kernel, o) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_modules_rmsnorm_routes_through_the_kernel_wrapper(dtype):
    """``impl="pallas"`` sends a norm to ``ops.rmsnorm`` (and counts a
    launch only on a CUDA tensor); the plain path matches the reference's
    ``modules.rmsnorm``, on a (B,S,H,hd) q-norm input and on a strided
    last-token slice."""
    from repro.models import modules as jnn
    from repro_torch.models import modules as nn
    rng = np.random.default_rng(17)
    xn = _randn(rng, (2, 5, 3, 16))
    s = _randn(rng, (16,))
    x, st = torch.tensor(xn).to(TDT[dtype]), torch.tensor(s)
    xj = jnp.asarray(xn).astype(JDT[dtype])
    seen = []
    wrapped = ops.rmsnorm
    ops.rmsnorm = lambda *a, **k: seen.append(a[0].shape) or wrapped(*a, **k)
    try:
        for xi, xji in ((x, xj), (x[:, -1:, 0], xj[:, -1:, 0])):
            o = nn.rmsnorm(xi, st, 1e-6, "pallas")
            assert torch.equal(o, nn.rmsnorm(xi, st, 1e-6))
            assert _err(jnn.rmsnorm(xji, jnp.asarray(s)), o) < TOL[dtype]
    finally:
        ops.rmsnorm = wrapped
    assert seen == [x.shape, (2, 1, 16)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,D", [(64, 128), (5, 2048), (3, 16)])
def test_add_rmsnorm_plain_matches_reference(N, D, dtype):
    """The fused residual add and norm: s = x + d rounds as the reference's
    add does (bit for bit), and its norm matches the reference's
    ``rmsnorm`` and the Pallas kernel (interpret mode) on that sum."""
    rng = np.random.default_rng(18)
    (xj, xt), (dj, dt) = (_both(_randn(rng, (N, D)), dtype)
                          for _ in range(2))
    sc = _randn(rng, (D,))
    s, o = ops.add_rmsnorm(xt, dt, torch.tensor(sc))
    assert s.dtype == o.dtype == xt.dtype and o.shape == xt.shape
    sj = xj + dj
    assert np.array_equal(np.asarray(sj, np.float32), s.float().numpy())
    assert _err(jref.rmsnorm(sj, jnp.asarray(sc)), o) < TOL[dtype]
    assert _err(jops.rmsnorm(sj, jnp.asarray(sc), block_rows=N), o) \
        < TOL[dtype]
    s2, o2 = ref.add_rmsnorm(xt, dt, torch.tensor(sc))
    assert torch.equal(s2, xt + dt) and torch.equal(
        o2, ref.rmsnorm(xt + dt, torch.tensor(sc)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qk_rmsnorm_plain_is_two_rmsnorms(dtype):
    """One launch for a layer's q and k norms on the card; on the CPU the
    two plain norms, each matching the reference's."""
    rng = np.random.default_rng(19)
    (qj, q), (kj, k) = (_both(_randn(rng, sh), dtype)
                        for sh in ((2, 3, 4, 16), (2, 3, 2, 16)))
    sq, sk = _randn(rng, (16,)), _randn(rng, (16,))
    qo, ko = ops.qk_rmsnorm(q, k, torch.tensor(sq), torch.tensor(sk))
    assert torch.equal(qo, ops.rmsnorm(q, torch.tensor(sq)))
    assert torch.equal(ko, ops.rmsnorm(k, torch.tensor(sk)))
    assert _err(jref.rmsnorm(qj, jnp.asarray(sq)), qo) < TOL[dtype]
    assert _err(jref.rmsnorm(kj, jnp.asarray(sk)), ko) < TOL[dtype]


# --- dispatch on the tensor's device ----------------------------------------
def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    ops.reset_launches()
    rng = np.random.default_rng(6)
    q, k, v = (torch.tensor(_randn(rng, (1, 16, 2, 16))) for _ in range(3))
    assert torch.equal(ops.flash_attention(q, k, v),
                       ref.flash_attention(q, k, v))
    (_, qt), (_, kt), (_, vt), bt = _paged_inputs(rng, 2, 4, 16, 2, 4, 2,
                                                  "float32")
    pos = torch.tensor([7, 2], dtype=torch.int32)
    bt = torch.tensor(bt)
    assert torch.equal(ops.paged_decode_attention(qt, kt, vt, bt, pos),
                       ref.paged_decode_attention(qt, kt, vt, bt, pos))
    a, b, h0 = (torch.tensor(x) for x in _rglru_inputs(rng, 2, 5, 8))
    assert all(torch.equal(x, y) for x, y in zip(
        ops.rglru_scan(a, b, h0), ref.rglru_scan(a, b, h0)))
    rw = [torch.tensor(x) for x in _rwkv_inputs(rng, 2, 5, 2, 8)]
    assert all(torch.equal(x, y) for x, y in zip(ops.rwkv6_scan(*rw),
                                                 ref.rwkv6_scan(*rw)))
    kc, vc = (torch.tensor(_randn(rng, (2, 9, 2, 16))) for _ in range(2))
    assert torch.equal(ops.decode_attention(qt, kc, vc, 4),
                       ref.decode_attention(qt, kc, vc, 4))
    x, w = torch.tensor(_randn(rng, (2, 3, 8))), torch.tensor(
        _randn(rng, (2, 8, 5)))
    assert torch.equal(ops.moe_gemm(x, w), ref.moe_gemm(x, w))
    s = torch.tensor(_randn(rng, (8,)))
    assert torch.equal(ops.rmsnorm(x, s), ref.rmsnorm(x, s))
    assert all(torch.equal(a, b) for a, b in zip(
        ops.add_rmsnorm(x, x, s), ref.add_rmsnorm(x, x, s)))
    ops.qk_rmsnorm(x, x, s, s)
    assert [fn.launches for fn in ops.KERNELS] == [0] * len(ops.KERNELS)
    assert [fn.launches for fn in ops.WRAPPERS] == [0] * len(ops.WRAPPERS)


def test_non_cpu_tensor_without_a_kernel_raises(monkeypatch):
    """A tensor off the CPU goes to the kernel, or to the meta branch
    (shapes only: the dry run's), or raises: never to the plain
    version."""
    for name in ("flash_attention", "paged_decode_attention",
                 "decode_attention", "moe_gemm", "rmsnorm", "add_rmsnorm",
                 "rwkv6_scan", "rglru_scan"):
        monkeypatch.setattr(ref, name, lambda *a, **k: pytest.fail(
            "a meta tensor reached the plain version"))
    with pytest.raises(ValueError, match="no kernel for device xpu"):
        ops._check("flash_attention", torch.device("xpu"), {}, ())
    q = torch.empty((1, 16, 2, 16), device="meta")
    assert ops.flash_attention(q, q, q).device.type == "meta"
    qd = torch.empty((2, 4, 16), device="meta")
    pages = torch.empty((5, 4, 2, 16), device="meta")
    idx = torch.empty((2, 2), dtype=torch.int32, device="meta")
    assert ops.paged_decode_attention(qd, pages, pages, idx,
                                      idx[:, 0].contiguous()).is_meta
    a = torch.empty((2, 5, 8), device="meta")
    assert all(t.is_meta for t in ops.rglru_scan(a, a, a[:, 0].contiguous()))
    r = torch.empty((2, 5, 2, 8), device="meta")
    assert all(t.is_meta for t in ops.rwkv6_scan(
        r, r, r, r, torch.empty((2, 8), device="meta"),
        torch.empty((2, 2, 8, 8), device="meta")))
    kc = torch.empty((2, 9, 2, 16), device="meta")
    assert ops.decode_attention(qd, kc, kc, 3).is_meta
    assert ops.moe_gemm(a, a.transpose(1, 2).contiguous()).is_meta
    s8 = torch.empty((8,), device="meta")
    assert ops.rmsnorm(a, s8).is_meta
    assert all(t.is_meta for t in ops.add_rmsnorm(a, a, s8))
    assert all(t.is_meta for t in ops.qk_rmsnorm(a, a, s8, s8))
    assert [fn.launches for fn in ops.KERNELS] == [0] * len(ops.KERNELS)
    assert [fn.launches for fn in ops.WRAPPERS] == [0] * len(ops.WRAPPERS)
