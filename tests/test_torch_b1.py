"""The Python side of B1's and B1p's tensor-core body, on the CPU.

B1 and B1p over bf16 q run csrc/paged_flatten.cu's deft_flat_q over bf16
pools (B4's body, templated on the pool type); a CUDA kernel runs only on
the card, so these tests hold what surrounds it to deft_tpu:

- the bf16 operands (K and V rows put by cp.async into 128-byte-swizzled
  boxes, read by RS wgmma through their descriptors, Q's and P's A
  fragments in registers), emulated in numpy for a warpgroup's 64 rows and
  a 64-token tile, give Q K^T and P V exactly;
- the grid (row tiles of ``q_block_rows``, ``q_spans``' spans of the
  listed blocks' 64-token tiles, per-warp skips, masks) gives every (live
  folded row, visible token) pair exactly once, pad rows never twice, on
  the main path's tree halfway, the ranks' windows of grid 1x2x2, seg_len
  32/64/256 and a tree of at most 64 folded rows;
- the spans fill the card on the main and sharded shapes and none is
  empty;
- the spans' merge (each span's online softmax in base 2, then
  flatten_body.cuh's merge kernel: the LSE rule over the spans, m out in
  natural log, the finite floor of a row that saw nothing) against
  deft_tpu's paged_flatten_attention and its partial entry;
- the plain versions of B1 and B1p against deft_tpu's Pallas kernel in
  interpret mode on edge plans: FULL and dead blocks, a row tile that sees
  nothing, qpk 1/4/8 (fp32 2e-5, bf16 2e-2, live rows).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_b2_b4 import b4_visits, check_state, edge_plan, expected_visits
from test_torch_b9_b5 import DTYPES, rel_err

import chip_smoke as cs
from deft_tpu.ops.flatten_attn import fold_q, unfold_o
from deft_tpu.ops.paged_flatten_attn import paged_flatten_attention as j_b1
from deft_tpu.ops.paged_flatten_attn import paged_flatten_attention_partial as j_b1p
from deft_tpu_torch.ops import paged_flatten_attn as tpf
from deft_tpu_torch.parallel import engine
from deft_tpu_torch.parallel.mesh import Grid
from deft_tpu_torch.plan import build_flatten_plan

SMS = 132  # an H100's SMs
FULL_LO = -(1 << 20)
K_NEG, M_CLAMP = -1e30, -1e5  # flash_common.cuh: masked score, floor of the running max
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453


# -- fragments -----------------------------------------------------------------------

def swizzled_tile(rows, D):
    """A (64, D) bf16 tile as the kernel's cp.async puts it in a stage:
    16-byte chunk ch of token row r at Layout::chunk(r, ch) = (ch / 8) *
    kBox + r * 128 + ((ch % 8) ^ (r % 8)) * 16, kBox = 64 * 128.  Returns
    the stage's bytes as element slots (2 bytes each) holding the values."""
    box = 64 * 128
    out = np.full((D // 64) * box // 2, np.nan)
    for r in range(64):
        for ch in range(2 * D // 16):
            off = (ch // 8) * box + r * 128 + (((ch % 8) ^ (r % 8)) << 4)
            assert off % 16 == 0 and np.isnan(out[off // 2:off // 2 + 8]).all()
            out[off // 2:off // 2 + 8] = rows[r, 8 * ch:8 * ch + 8]
    assert not np.isnan(out).any()  # every slot written once
    return out


def sw128(tile, start, row, byte):
    """The element a wgmma operand descriptor (128-byte swizzle) reads:
    byte ``byte`` of 128-byte row ``row`` from ``start`` (bytes into the
    1024-byte-aligned stage), the 16-byte chunk index XOR-ed with the row
    in its 8-row atom, as TMA's SWIZZLE_128B writes a box."""
    b = start % 128 + byte
    addr = start - start % 128 + row * 128 + (((b // 16) ^ (row % 8)) << 4) + b % 16
    return tile[addr // 2]


def acc_layout(N):
    """The m64nNk16 accumulator of a warpgroup (and the mma.sync m16n8k16
    C fragment of each warp's 16 rows): thread (warp w, lane g * 4 + tig)
    holds d[4 j + i] at row 16 w + g + 8 (i // 2), column 8 j + 2 tig + i % 2."""
    return [(16 * w + lane // 4 + 8 * (i // 2), 8 * j + 2 * (lane % 4) + i % 2, w, lane, 4 * j + i)
            for w in range(4) for lane in range(32) for j in range(N // 8) for i in range(4)]


def a_fragment(x, w, lane, k0):
    """A (64 x 16) from registers: per warp the mma.sync m16n8k16 A fragment
    of its rows 16 w .. + 15 over columns k0 .. + 15, as the kernel loads Q
    (d = 16 ks + 2 tig (+ 8)) and packs P from the S accumulators:
    registers {row g, k 2 tig}, {row g + 8, k 2 tig}, {row g, k 2 tig + 8},
    {row g + 8, k 2 tig + 8}, two values each."""
    g, tig = lane // 4, lane % 4
    r = 16 * w + g
    return [x[r, k0 + 2 * tig:k0 + 2 * tig + 2], x[r + 8, k0 + 2 * tig:k0 + 2 * tig + 2],
            x[r, k0 + 2 * tig + 8:k0 + 2 * tig + 10], x[r + 8, k0 + 2 * tig + 8:k0 + 2 * tig + 10]]


@pytest.mark.parametrize("D", [64, 128])
def test_b1_fragments_give_scores_and_pv(D):
    """One 64-token tile and a warpgroup's 64 query rows, bf16 pools: K and
    V rows placed by the kernel's cp.async chunks into 128-byte-swizzled
    boxes; S = Q K^T as D / 16 RS wgmma m64n64k16 (descriptor start: box
    ks / 4, 32 bytes a step; K-major B: N = token rows), O = P V as 4 RS
    wgmma m64nDk16 (start 16 rows a step, LBO one box; N-major B: K = token
    rows, N = head dims across boxes), A fragments as the kernel holds Q and
    packs P.  Integer values, so every product is exact."""
    rng = np.random.default_rng(D + 2)
    q = rng.integers(-8, 9, (64, D)).astype(np.float64)
    k = rng.integers(-64, 65, (64, D)).astype(np.float64)
    v = rng.integers(-64, 65, (64, D)).astype(np.float64)
    ks_tile, vs_tile = swizzled_tile(k, D), swizzled_tile(v, D)
    box = 64 * 128

    S = np.zeros((64, 64))
    for ks in range(D // 16):
        start = (ks // 4) * box + (ks % 4) * 32
        # B (16 x 64), K-major: column n is token n's row, k its 16 dims here
        B = np.array([[sw128(ks_tile, start, n, 2 * kk) for n in range(64)]
                      for kk in range(16)])
        A = np.zeros((64, 16))
        for w in range(4):
            for lane in range(32):
                g, tig = lane // 4, lane % 4
                regs = a_fragment(q, w, lane, 16 * ks)
                r = 16 * w + g
                A[r, 2 * tig:2 * tig + 2], A[r + 8, 2 * tig:2 * tig + 2] = regs[0], regs[1]
                A[r, 2 * tig + 8:2 * tig + 10], A[r + 8, 2 * tig + 8:2 * tig + 10] = regs[2:]
        S += A @ B
    np.testing.assert_array_equal(S, q @ k.T)
    # the accumulators in registers, as the softmax and the mask read them
    sc = np.zeros((4, 32, 32))
    for row, col, w, lane, idx in acc_layout(64):
        sc[w, lane, idx] = S[row, col]

    P = rng.integers(-3, 4, (64, 64)).astype(np.float64)
    pc = np.zeros((4, 32, 32))  # P in the S accumulators' places
    for row, col, w, lane, idx in acc_layout(64):
        pc[w, lane, idx] = P[row, col]
    O = np.zeros((64, D))
    for kk in range(4):
        start = kk * 16 * 128
        # B (16 x D), N-major: k = token 16 kk + t, n = head dim in box n / 64
        B = np.array([[sw128(vs_tile, start + (n // 64) * box, t, 2 * (n % 64))
                       for n in range(D)] for t in range(16)])
        A = np.zeros((64, 16))
        for w in range(4):
            for lane in range(32):  # pa[kk] = s[8 kk .. 8 kk + 7] of the thread
                g, tig = lane // 4, lane % 4
                sk = pc[w, lane, 8 * kk:8 * kk + 8]
                r = 16 * w + g
                A[r, 2 * tig:2 * tig + 2], A[r + 8, 2 * tig:2 * tig + 2] = sk[0:2], sk[2:4]
                A[r, 2 * tig + 8:2 * tig + 10] = sk[4:6]
                A[r + 8, 2 * tig + 8:2 * tig + 10] = sk[6:8]
        O += A @ B
    np.testing.assert_array_equal(O, P @ v)
    # the accumulator's column n of n-tile nt is d = 8 nt + n: the epilogue's
    # staging (d = 8 nt + 2 tig + e) puts each O element in its place
    for row, col, w, lane, idx in acc_layout(D):
        nt, i = divmod(idx, 4)
        assert col == 8 * nt + 2 * (lane % 4) + i % 2 and row == 16 * w + lane // 4 + 8 * (i // 2)
    assert np.isfinite(sc).all()


# -- grid and spans ------------------------------------------------------------------

@pytest.fixture(scope="module")
def main_plan():
    """The main path's tree halfway through its 64 tokens (chip_smoke.py's
    path shapes: prompt 4000, width 50) and the plan the runner builds for
    bf16 pools."""
    tree = cs.grow_tree(cs.PROMPT_LEN, cs.WIDTH, cs.GEN_LEN // 2, 16384,
                        np.random.default_rng(cs.SEED))
    plan = build_flatten_plan(tree, q_per_kv=4, block_len=256, min_token_bucket=1024)
    int8 = build_flatten_plan(tree, q_per_kv=4, block_len=256, min_token_bucket=1024,
                              **cs.INT8_RULES["flatten"])
    return plan, int8


def rank_window(plan, rank, grid=cs.SHARDED_GRID):
    """The plan arrays of a rank of the sharded path's grid (its sp span of
    blocks, parallel/engine.py) and its rows."""
    batch = type("Batch", (), {n: torch.from_numpy(getattr(plan, n))
                               for n in ("seg_src", "tok_lo", "tok_hi", "blk_lo", "blk_hi")}
                 | {"blk_host": (plan.blk_lo, plan.blk_hi)})
    w = engine.flatten_window(Grid(grid, rank, torch.device("cpu")), batch, plan.l_pad, True)
    return tuple(t.numpy() for t in (w.seg_src, w.tok_lo, w.tok_hi, w.blk_lo, w.blk_hi))


def listed_tiles(qpk, Rq, blk_lo, blk_hi, block_len):
    """Per row tile, the 64-token tiles of the blocks it sees (warp 0's
    list in the kernel)."""
    RB = tpf.q_block_rows(Rq)
    full = blk_lo < FULL_LO
    out = []
    for r0 in range(0, Rq, RB):
        a, b = r0 // qpk, (min(Rq, r0 + RB) - 1) // qpk
        listed = (blk_hi > a) & (full | ((blk_lo < blk_hi) & (blk_lo <= b)))
        out.append(int(listed.sum()) * (block_len // 64))
    return out


def small_plan(seg_len):
    """At most 64 folded rows: 12 leaves at qpk 4 (l_pad 16): 4-warp blocks."""
    _, plan = edge_plan(seg_len, 1500, 12, qpk=4)
    assert plan.l_pad * 4 <= 64
    return plan


GRID_CASES = ["main", "rank0", "rank2", "rank0_int8", "seg32", "seg64", "seg256", "rows64"]


@pytest.mark.parametrize("case", GRID_CASES)
def test_b1_grid_covers_every_pair_once(case, main_plan):
    """Every (live folded row, visible token) pair once over the row tiles,
    spans and warps of q_spans' grid, pad rows never twice, on cards of
    132 SMs (H100 SXM), 114 (H100 PCIe) and 8."""
    qpk = 4
    if case in ("main", "rank0", "rank2", "rank0_int8"):
        # the bf16 plan (32 blocks; windows of 15) or the int8 one (64; 21)
        plan = main_plan[case.endswith("int8")]
        arrs = (plan.seg_src, plan.tok_lo, plan.tok_hi, plan.blk_lo, plan.blk_hi)
        Hkv = 8
        if case != "main":
            arrs, Hkv = rank_window(plan, int(case[4])), 4
            assert len(arrs[3]) == (21 if case.endswith("int8") else 15)
    else:
        plan = small_plan(64) if case == "rows64" else edge_plan(int(case[3:]), 4000, 40)[1]
        arrs = (plan.seg_src, plan.tok_lo, plan.tok_hi, plan.blk_lo, plan.blk_hi)
        Hkv = 2
    _, tok_lo, tok_hi, blk_lo, blk_hi = arrs
    Rq = plan.l_pad * qpk
    want = expected_visits(plan, tok_lo, tok_hi, blk_lo, blk_hi, qpk)
    live = plan.n_leaves * qpk
    for sms in (SMS, 114, 8):
        spans = tpf.q_spans(Rq, Hkv, len(blk_lo), plan.block_len, sms)
        got = b4_visits(plan.l_pad, qpk, tok_lo, tok_hi, blk_lo, blk_hi, plan.block_len,
                        spans)
        np.testing.assert_array_equal(got[:live], want)
        assert got.max() <= 1
    assert want.sum() > 0


@pytest.mark.parametrize("pools", ["bf16", "int8"])
def test_b1_spans_fill_the_card(pools, main_plan):
    """On the main shape (64 leaf rows x qpk 4, 8 KV heads; the bf16 plan,
    32 blocks of which 29 live, and the int8 plan, 64 of which 41) and on
    the sharded shape (each rank of grid 1x2x2: 4 KV heads, its window of
    blocks): one block an SM, at least 90% of them, and every span holding
    a tile of a live block."""
    bf16, int8 = main_plan
    cases = {"bf16": (bf16, 32, 29), "int8": (int8, 64, 41)}
    for plan, n_blocks, n_live in (cases[pools],):
        full = plan.blk_lo < FULL_LO
        assert (plan.l_pad, len(plan.blk_lo), int((full | (plan.blk_lo < plan.blk_hi)).sum())) \
            == (64, n_blocks, n_live)
        shapes = [(8, plan.blk_lo, plan.blk_hi)] + [(4, *rank_window(plan, r)[3:])
                                                    for r in range(4)]
        for Hkv, blk_lo, blk_hi in shapes:
            rq = plan.l_pad * 4
            pairs = -(-rq // tpf.q_block_rows(rq)) * Hkv
            spans = tpf.q_spans(rq, Hkv, len(blk_lo), 256, SMS)
            assert spans == SMS // pairs and 0.9 * SMS <= pairs * spans <= SMS
            for tiles in listed_tiles(4, rq, blk_lo, blk_hi, 256):
                assert tiles >= spans  # the tile's share: no span empty


# -- the merge of the spans ---------------------------------------------------------------

def span_states(q, k, v, lo, hi, blk_lo, blk_hi, qpk, block_len, spans, scale):
    """Each span's unnormalised state as the kernel's blocks leave it: per
    row tile, the span's share of the listed tiles in order, each warp's
    skips, and per tile the base-2 online softmax with the running max
    floored at -1e5 (rows of skipped tiles keep m = -1e30).  q (Rq, D)
    folded rows of one KV head, k and v (T, D), lo/hi the tokens' leaf
    intervals as the kernel reads them (FULL blocks: no mask).  Returns
    acc (spans, Rq, D), m, l (spans, Rq)."""
    Rq, D = q.shape
    RB = tpf.q_block_rows(Rq)
    full = blk_lo < FULL_LO
    tpb = block_len // 64
    acc = np.zeros((spans, Rq, D))
    m = np.full((spans, Rq), K_NEG)
    l = np.zeros((spans, Rq))
    for r0 in range(0, Rq, RB):
        leaf_a, leaf_b = r0 // qpk, (min(Rq, r0 + RB) - 1) // qpk
        listed = [b for b in range(len(blk_lo)) if blk_hi[b] > leaf_a
                  and (full[b] or (blk_lo[b] < blk_hi[b] and blk_lo[b] <= leaf_b))]
        total = len(listed) * tpb
        for span in range(spans):
            for li in range(total * span // spans, total * (span + 1) // spans):
                b = listed[li // tpb]
                toks = b * block_len + (li % tpb) * 64 + np.arange(64)
                for wr in range(r0, min(r0 + RB, Rq), 16):
                    wa, wb = wr // qpk, (min(Rq, wr + 16) - 1) // qpk
                    tl, th = lo[toks], hi[toks]
                    if full[b] and wa >= blk_hi[b]:
                        continue
                    if not full[b] and not ((tl < th) & (tl <= wb) & (th > wa)).any():
                        continue
                    rows = np.arange(wr, min(wr + 16, Rq))
                    s = q[rows] @ k[toks].T * scale * LOG2E
                    if not full[b]:
                        leaf = rows[:, None] // qpk
                        s = np.where((tl <= leaf) & (leaf < th), s, K_NEG)
                    m_new = np.maximum(np.maximum(m[span, rows], s.max(1)), M_CLAMP)
                    p = np.exp2(s - m_new[:, None])
                    alpha = np.exp2(m[span, rows] - m_new)
                    l[span, rows] = l[span, rows] * alpha + p.sum(1)
                    acc[span, rows] = acc[span, rows] * alpha[:, None] + p @ v[toks]
                    m[span, rows] = m_new
    return acc, m, l


def merge_spans(acc, m, l):
    """flatten_body.cuh's merge kernel: M = max over spans of m, weights
    2^(m_s - M) in span order; returns o = acc / l (0 where l = 0) and the
    partial state (acc, M ln 2, l)."""
    M = m.max(0)
    f = np.exp2(m - M)
    L = (l * f).sum(0)
    A = (acc * f[..., None]).sum(0)
    o = np.where(L[:, None] > 0, A / np.where(L > 0, L, 1)[:, None], 0.0)
    return o, (A, M * LN2, L)


def subset_plan(plan, blocks):
    """The plan arrays of the listed blocks alone, in order (a window)."""
    nseg, bl = plan.block_len // plan.seg_len, plan.block_len
    segs = np.concatenate([np.arange(b * nseg, (b + 1) * nseg) for b in blocks])
    toks = np.concatenate([np.arange(b * bl, (b + 1) * bl) for b in blocks])
    return (plan.seg_src[segs], plan.tok_lo[toks], plan.tok_hi[toks],
            plan.blk_lo[blocks], plan.blk_hi[blocks])


def edge_windows(plan):
    """The whole edge plan (FULL, few-leaf and dead blocks), and a window
    of its suffix blocks that only leaves of the first row tile see, so the
    second row tile sees nothing."""
    full = plan.blk_lo < FULL_LO
    live = ~full & (plan.blk_lo < plan.blk_hi)
    first = np.nonzero(live & (plan.blk_hi <= 128 // 4))[0]
    assert len(first) >= 2
    arrs = (plan.seg_src, plan.tok_lo, plan.tok_hi, plan.blk_lo, plan.blk_hi)
    return {"whole": arrs, "first tile only": subset_plan(plan, first[:4])}


@pytest.mark.parametrize("which", ["whole", "first tile only"])
def test_b1_span_merge_matches_deft_tpu(which):
    """Per-span states of the kernel's grid, merged by the merge kernel's rule,
    against deft_tpu's B1 (o) and B1p (acc, m, l) on the same fp32 inputs;
    rows that see nothing: o = 0, l = 0, m at the finite floor."""
    qpk, Hkv, D = 4, 4, 64  # 8 (row tile, head) pairs: 16 spans each
    tree, plan = edge_plan(64, 1500, 40, qpk=qpk)
    assert plan.l_pad * qpk > 128  # two row tiles
    arrs = edge_windows(plan)[which]
    seg_src, tok_lo, tok_hi, blk_lo, blk_hi = arrs
    S = tree.token_to_kv_pool.size
    rng = np.random.default_rng(7)
    kp, vp = (rng.standard_normal((1, S, Hkv * D)).astype(np.float32) for _ in range(2))
    q = rng.standard_normal((plan.l_pad, qpk * Hkv, D)).astype(np.float32)
    scale = D ** -0.5
    rows = tpf.segment_rows(torch.from_numpy(seg_src), plan.seg_len).numpy()
    lo, hi = (t.numpy() for t in tpf.leaf_intervals(
        *(torch.from_numpy(a) for a in (tok_lo, tok_hi, blk_lo, blk_hi)), plan.block_len,
        plan.l_pad))
    qf = tpf.fold_rows(torch.from_numpy(q), Hkv).numpy().astype(np.float64)
    Rq = plan.l_pad * qpk
    spans = tpf.q_spans(Rq, Hkv, len(blk_lo), plan.block_len, SMS)
    assert spans > 1
    o = np.zeros((Hkv, Rq, D))
    state = [np.zeros((Hkv, Rq, D)), np.zeros((Hkv, Rq)), np.zeros((Hkv, Rq))]
    for h in range(Hkv):
        k = kp[0][rows].reshape(-1, Hkv, D)[:, h].astype(np.float64)
        v = vp[0][rows].reshape(-1, Hkv, D)[:, h].astype(np.float64)
        st = span_states(qf[h], k, v, lo, hi, blk_lo, blk_hi, qpk, plan.block_len, spans,
                         scale)
        o[h], merged = merge_spans(*st)
        for x, y in zip(state, merged):
            x[h] = y
    kw = dict(scale=scale, qpk=qpk, block_len=plan.block_len, seg_len=plan.seg_len)
    jargs = [fold_q(jnp.asarray(q), Hkv), jnp.asarray(kp), jnp.asarray(vp),
             jnp.asarray(0, jnp.int32)] + [jnp.asarray(a) for a in arrs]
    live = slice(0, plan.n_leaves * qpk)
    want_o = np.asarray(j_b1(*jargs, **kw))
    assert rel_err(o[:, live], want_o[:, live]) < 2e-5
    wacc, wm, wl = (np.asarray(x) for x in j_b1p(*jargs, **kw))
    check_state([x[:, live] for x in state],
                (wacc[:, live], wm[..., 0][:, live], wl[..., 0][:, live]), 2e-5)
    assert np.isfinite(state[1]).all() and (state[1][state[2] == 0] <= M_CLAMP * LN2).all()
    assert (o[state[2] == 0] == 0).all()
    if which == "first tile only":  # the second row tile sees nothing
        assert (state[2][:, 128:] == 0).all() and (o[:, 128:] == 0).all()


# -- plain versions against deft_tpu -------------------------------------------------

@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("qpk,D", [(1, 128), (4, 64), (8, 64)])
@pytest.mark.parametrize("which", ["whole", "first tile only"])
def test_b1_plain_vs_pallas_on_edge_plans(which, qpk, D, dt):
    """B1 and B1p over bf16/fp32 pools on the edge plan (FULL, few-leaf and
    dead blocks) and on a window that the second row tile does not see."""
    Hkv = 2
    tree, plan = edge_plan(64, 1500, 40, qpk=qpk)
    arrs = (plan.seg_src, plan.tok_lo, plan.tok_hi, plan.blk_lo, plan.blk_hi)
    if which != "whole":
        full = plan.blk_lo < FULL_LO
        first = np.nonzero(~full & (plan.blk_lo < plan.blk_hi)
                           & (plan.blk_hi <= tpf.q_block_rows(plan.l_pad * qpk) // qpk))[0]
        arrs = subset_plan(plan, first[:4])
    S = tree.token_to_kv_pool.size
    rng = np.random.default_rng(qpk * D + len(which))
    kd, vd = (rng.standard_normal((1, S, Hkv * D)).astype(np.float32) for _ in range(2))
    q = rng.standard_normal((plan.l_pad, qpk * Hkv, D)).astype(np.float32)
    jdt, tdt, tol = DTYPES[dt]
    kw = dict(scale=D ** -0.5, qpk=qpk, block_len=plan.block_len, seg_len=plan.seg_len)
    jargs = [fold_q(jnp.asarray(q, jdt), Hkv), jnp.asarray(kd, jdt), jnp.asarray(vd, jdt),
             jnp.asarray(0, jnp.int32)] + [jnp.asarray(a) for a in arrs]
    targs = [torch.from_numpy(q).to(tdt), torch.from_numpy(kd).to(tdt),
             torch.from_numpy(vd).to(tdt), 0] + [torch.from_numpy(a) for a in arrs]
    live = plan.n_leaves
    want = np.asarray(unfold_o(j_b1(*jargs, **kw), plan.l_pad), np.float32)
    got = tpf.paged_flatten_attention(*targs, D ** -0.5, plan.block_len, plan.seg_len)
    assert rel_err(got.float().numpy()[:live], want[:live]) < tol
    wacc, wm, wl = (np.asarray(x) for x in j_b1p(*jargs, **kw))
    gacc, gm, gl = (t.numpy() for t in tpf.paged_flatten_attention_partial(
        *targs, D ** -0.5, plan.block_len, plan.seg_len))
    rows = slice(0, live * qpk)
    check_state((gacc[:, rows], gm[:, rows], gl[:, rows]),
                (wacc[:, rows], wm[..., 0][:, rows], wl[..., 0][:, rows]), tol)
