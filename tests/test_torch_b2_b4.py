"""The Python side of B2's and B4's tensor-core bodies, on the CPU.

- B2 (csrc/paged_seq.cu, deft_seq_q over bf16 pools): the bf16 fragment
  loads (ldmatrix for S = Q K^T, ldmatrix.trans for P V), emulated in
  numpy, give Q K^T and P V exactly; the path split over a cluster's blocks
  and their warps, with each tile's tokens mapped to pool rows through the
  segment table's prefix sums, reads every live path row once, in path
  order; the bf16 ``seq_splits`` fill the card.
- B4 (csrc/paged_flatten.cu, deft_flat_q): the grid (row tiles of
  ``q_block_rows``, ``q_spans`` spans of the listed blocks' 64-token tiles,
  per-warp skips, masks) gives every (live folded row, visible token) pair
  exactly once, on plans with FULL and dead blocks, tiles a row tile does
  not see, windows of 21 and 32 blocks and seg_len 32/128/256/512; the
  widened int8 fragments give Q K^T and P V exactly over every code; the
  spans fill the card and none is empty.
- The plain versions of B2, B2p, B4 and B4p against deft_tpu's Pallas
  kernels in interpret mode on those edge plans (fp32 2e-5, bf16 2e-2, live
  rows).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_b9_b5 import (DTYPES, pair_hi, pair_lo, rel_err, split_tiles,
                              synthetic_seq_plan, widen4)

from deft_tpu.ops.flatten_attn import fold_q, unfold_o
from deft_tpu.ops.paged_quant import paged_flatten_attention_q as j_b4
from deft_tpu.ops.paged_quant import paged_flatten_attention_q_partial as j_b4p
from deft_tpu.ops.paged_seq_attn import paged_seq_attention as j_b2
from deft_tpu.ops.paged_seq_attn import paged_seq_attention_partial as j_b2p
from deft_tpu_torch.core import ReqToTokenPool, TokenKVPool, TreeCache
from deft_tpu_torch.ops import paged_flatten_attn as tpf
from deft_tpu_torch.ops import paged_quant as tpq
from deft_tpu_torch.ops import paged_seq_attn as tps
from deft_tpu_torch.plan import build_flatten_plan

SMS = 132  # an H100's SMs


# -- B2 ------------------------------------------------------------------------------

def ldmatrix_x4(lane_rows, trans=False):
    """ldmatrix.x4: lane_rows[l] is the 8-element row lane l addresses (row
    l % 8 of tile l / 8); returns per lane its four registers as element
    pairs: row g = lane / 4, elements 2 tig, 2 tig + 1 (tig = lane % 4), or
    with .trans rows 2 tig, 2 tig + 1 of column g."""
    out = []
    for lane in range(32):
        g, tig = lane // 4, lane % 4
        regs = []
        for j in range(4):
            m = np.stack([lane_rows[8 * j + i] for i in range(8)])
            regs.append(m[2 * tig:2 * tig + 2, g] if trans else m[g, 2 * tig:2 * tig + 2])
        out.append(regs)
    return out


@pytest.mark.parametrize("D", [64, 128])
def test_b2_fragments_give_scores_and_pv(D):
    """One 16-token tile over bf16 rows: S = Q K^T from ldmatrix over K's
    rows, O = P V from ldmatrix.trans over V's rows, as deft_seq_q loads
    them (integer values, so every product is exact)."""
    rng = np.random.default_rng(D)
    q = rng.integers(-8, 9, (8, D)).astype(np.float64)  # rows g < qpk
    k = rng.integers(-64, 65, (16, D)).astype(np.float64)
    v = rng.integers(-64, 65, (16, D)).astype(np.float64)
    S = np.zeros((16, 16))
    for nt8 in range(2):
        for kp in range(D // 32):
            regs = ldmatrix_x4([k[nt8 * 8 + lane % 8, 32 * kp + 8 * (lane // 8):][:8]
                                for lane in range(32)])
            for half in range(2):
                ks = 2 * kp + half
                A, B = np.zeros((16, 16)), np.zeros((16, 8))
                for lane in range(32):
                    g, tig = lane // 4, lane % 4
                    B[2 * tig:2 * tig + 2, g] = regs[lane][2 * half]
                    B[2 * tig + 8:2 * tig + 10, g] = regs[lane][2 * half + 1]
                    A[g, 2 * tig:2 * tig + 2] = q[g, 16 * ks + 2 * tig:][:2]
                    A[g, 2 * tig + 8:2 * tig + 10] = q[g, 16 * ks + 8 + 2 * tig:][:2]
                S[:, nt8 * 8:nt8 * 8 + 8] += A @ B
    np.testing.assert_array_equal(S[:8], q @ k.T)

    P = rng.integers(-3, 4, (8, 16)).astype(np.float64)
    A = np.zeros((16, 16))
    for lane in range(32):  # the S accumulators' layout reused as the A fragment
        g, tig = lane // 4, lane % 4
        A[g, 2 * tig:2 * tig + 2] = P[g, 2 * tig:2 * tig + 2]
        A[g, 2 * tig + 8:2 * tig + 10] = P[g, 8 + 2 * tig:8 + 2 * tig + 2]
    O = np.zeros((8, D))
    for np_ in range(D // 16):
        regs = ldmatrix_x4([v[lane % 8 + 8 * ((lane // 8) & 1), 16 * np_ + 8 * (lane // 16):][:8]
                            for lane in range(32)], trans=True)
        for half in range(2):
            nt = 2 * np_ + half
            B = np.zeros((16, 8))
            for lane in range(32):
                g, tig = lane // 4, lane % 4
                B[2 * tig:2 * tig + 2, g] = regs[lane][2 * half]
                B[2 * tig + 8:2 * tig + 10, g] = regs[lane][2 * half + 1]
            O[:, 8 * nt:8 * nt + 8] = (A @ B)[:8]  # column n of n-tile nt: d = 8 nt + n
    np.testing.assert_array_equal(O, P @ v)


def path_rows_as_read(tables, R, nb, spb, seg_len, splits):
    """Per leaf, the pool rows deft_seq_q's blocks and warps read, in
    (block, warp, tile, lane) order: tile t's lane i takes path token 16 t +
    i, mapped through the prefix sums of the live counts (blocks with
    blk_live 0 count none) by the kernel's binary search."""
    src, off, live, blk = (a.reshape(R, -1) for a in tables)
    out = []
    for r in range(R):
        x = live[r] * np.repeat(blk[r] > 0, spb)
        cum = np.concatenate([[0], np.cumsum(x)])
        total, rows = int(cum[-1]), []
        for block in split_tiles(total, splits):
            for w0, w1 in block:
                for t in range(w0, w1):
                    for i in range(16 * t, min(16 * t + 16, total)):
                        a, b = 0, len(x)  # largest j with cum[j] <= i
                        while b - a > 1:
                            c = (a + b) // 2
                            a, b = (c, b) if cum[c] <= i else (a, c)
                        rows.append(int(src[r, a] + off[r, a] + i - cum[a]))
        out.append(rows)
    return out


@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_b2_path_split_reads_every_live_row_once(seed, splits):
    R, nb, spb, seg_len = 6, 3, 2, 32
    rng = np.random.default_rng(seed)
    tables = synthetic_seq_plan(rng, R, nb, spb, seg_len, 4096, one_token_leaf=2)
    rows, live = tps.segment_paths(*(torch.from_numpy(t) for t in tables), R, seg_len)
    lens = live.sum(1).numpy()
    assert lens[2] == 1 and (lens % 16 != 0).any() and (lens > 32).any()
    got = path_rows_as_read(tables, R, nb, spb, seg_len, splits)
    for r in range(R):
        assert got[r] == rows[r][live[r]].tolist()


def test_b2_splits_fill_the_card():
    """bf16 pools hold 2 blocks an SM (104 KB of ring at D = 128)."""
    assert tps.seq_splits(64, 8, SMS, int8=False) == 1  # the 8B main tree: 512 pairs
    assert tps.seq_splits(64, 4, SMS, int8=False) == 2  # rank 0 of grid 1x2x2
    for R, Hkv in ((64, 8), (64, 4), (8, 2), (1, 1)):
        sp = tps.seq_splits(R, Hkv, SMS, int8=False)
        assert 1 <= sp <= 8
        assert sp == 8 or R * Hkv * sp >= 2 * SMS  # every resident slot busy


# -- B4 ------------------------------------------------------------------------------

def b4_visits(R, qpk, tok_lo, tok_hi, blk_lo, blk_hi, block_len, spans):
    """(Rq, T) counts of the (folded row, plan token) pairs deft_flat_q's
    grid attends: per row tile of q_block_rows(Rq) rows, warp 0's list of
    the blocks the tile sees, each span's share of their 64-token tiles,
    each warp's skips (a FULL block past its rows' leaves, a tile none of
    its rows sees) and its rows' masks (FULL blocks: none)."""
    Rq = R * qpk
    RB = tpf.q_block_rows(Rq)
    full = blk_lo < -(1 << 20)
    nb, tpb = len(blk_lo), block_len // 64
    visits = np.zeros((Rq, nb * block_len), int)
    for r0 in range(0, Rq, RB):
        leaf_a, leaf_b = r0 // qpk, (min(Rq, r0 + RB) - 1) // qpk
        listed = [b for b in range(nb) if blk_hi[b] > leaf_a
                  and (full[b] or (blk_lo[b] < blk_hi[b] and blk_lo[b] <= leaf_b))]
        total = len(listed) * tpb
        for span in range(spans):
            for li in range(total * span // spans, total * (span + 1) // spans):
                b = listed[li // tpb]
                toks = b * block_len + (li % tpb) * 64 + np.arange(64)
                lo, hi = tok_lo[toks], tok_hi[toks]
                for wr in range(r0, min(r0 + RB, Rq), 16):
                    wa, wb = wr // qpk, (min(Rq, wr + 16) - 1) // qpk
                    if full[b] and wa >= blk_hi[b]:
                        continue
                    if not full[b] and not ((lo < hi) & (lo <= wb) & (hi > wa)).any():
                        continue
                    for r in range(wr, min(wr + 16, Rq)):
                        leaf = r // qpk
                        seen = np.ones(64, bool) if full[b] else (lo <= leaf) & (leaf < hi)
                        visits[r, toks[seen]] += 1
    return visits


def wide_tree(rng, prompt, width, steps):
    tree = TreeCache(TokenKVPool(16384), ReqToTokenPool(128, prompt + steps + 64))
    tree.init_prompt(rng.integers(4, 400, prompt).tolist())
    for i, c in enumerate(tree.branch(tree.root, width)):
        c.append_token(50 + i)
    for _ in range(steps):
        tree.alloc()
        for leaf in list(tree.leaves.values()):
            leaf.append_token(int(rng.integers(1, 400)))
    tree.cut(sorted(tree.leaves.values(), key=lambda x: x.id)[0])  # a pruned leaf
    tree.alloc()
    return tree


def edge_plan(seg_len, prompt, width, qpk=4):
    """A tree with FULL prefix blocks, few-leaf suffix blocks and a dead
    bucket tail, paged at ``seg_len``; at width 40, more than 128 folded
    rows (two row tiles, so some suffix tiles are seen by one tile only)."""
    tree = wide_tree(np.random.default_rng(seg_len), prompt, width, 12)
    block_len = max(128, seg_len)
    plan = build_flatten_plan(tree, q_per_kv=qpk, block_len=block_len,
                              min_token_bucket=1024, seg_len=(seg_len,), waste_limit=64.0)
    assert plan.paged and plan.seg_len == seg_len
    return tree, plan


def window(plan, nblk):
    """The first nblk plan blocks, as an sp rank's window of them."""
    nseg = plan.block_len // plan.seg_len
    return (plan.seg_src[:nblk * nseg], plan.tok_lo[:nblk * plan.block_len],
            plan.tok_hi[:nblk * plan.block_len], plan.blk_lo[:nblk], plan.blk_hi[:nblk])


def expected_visits(plan, tok_lo, tok_hi, blk_lo, blk_hi, qpk):
    """Live folded rows x tokens: 1 where the plain version attends."""
    lo, hi = tpf.leaf_intervals(*(torch.from_numpy(a) for a in (tok_lo, tok_hi, blk_lo,
                                                                 blk_hi)),
                                plan.block_len, plan.l_pad)
    leaf = np.arange(plan.n_leaves * qpk)[:, None] // qpk
    return ((lo.numpy()[None] <= leaf) & (leaf < hi.numpy()[None])).astype(int)


@pytest.mark.parametrize("seg_len,nblk", [(32, None), (128, None), (256, None),
                                          (512, None), (32, 21), (32, 32), (128, 21),
                                          (128, 32)])
def test_b4_grid_covers_every_pair_once(seg_len, nblk):
    qpk = 4
    _, plan = edge_plan(seg_len, 4000, 40, qpk=qpk)
    nb_all = len(plan.blk_lo)
    assert nblk is None or nblk <= nb_all
    _, tok_lo, tok_hi, blk_lo, blk_hi = window(plan, nblk or nb_all)
    full = blk_lo < -(1 << 20)
    dead = ~full & (blk_lo >= blk_hi)
    if nblk is None:
        assert full.any() and dead.any()
    Rq = plan.l_pad * qpk
    assert Rq > tpf.q_block_rows(Rq)  # two row tiles
    want = expected_visits(plan, tok_lo, tok_hi, blk_lo, blk_hi, qpk)
    for Hkv in (8, 4):
        spans = tpf.q_spans(Rq, Hkv, len(blk_lo), plan.block_len, SMS)
        got = b4_visits(plan.l_pad, qpk, tok_lo, tok_hi, blk_lo, blk_hi, plan.block_len,
                        spans)
        live = plan.n_leaves * qpk
        np.testing.assert_array_equal(got[:live], want)
        assert got.max() <= 1  # pad rows too: never twice
    if nblk is not None:
        return
    # a row tile skips the suffix blocks only the other tile's leaves see
    listed = [np.nonzero((blk_hi > r0 // qpk) & (full | ((blk_lo < blk_hi)
                                                         & (blk_lo <= (r0 + 127) // qpk))))[0]
              for r0 in (0, 128)]
    assert len(listed[0]) != len(listed[1]) or (listed[0] != listed[1]).any()


def test_b4_spans_fill_the_card():
    """At the main tree halfway (chip_smoke.py's path shapes: 64 leaf rows
    x qpk 4, 8 KV heads, the int8 plan rules) and rank 0 of grid 1x2x2 (4
    KV heads, the first 21 blocks; and a 32-block window): one block an SM,
    at least 90% of them, every span holding tiles of live blocks."""
    import chip_smoke as cs

    tree = cs.grow_tree(cs.PROMPT_LEN, cs.WIDTH, cs.GEN_LEN // 2, 16384,
                        np.random.default_rng(cs.SEED))
    plan = build_flatten_plan(tree, q_per_kv=4, block_len=256, min_token_bucket=1024,
                              **cs.INT8_RULES["flatten"])
    full = plan.blk_lo < -(1 << 20)
    live = int((full | (plan.blk_lo < plan.blk_hi)).sum())
    assert (plan.l_pad, len(plan.blk_lo), live) == (64, 64, 41)
    rq = plan.l_pad * 4
    for Hkv, nb, want in ((8, 64, 8), (4, 21, 16), (4, 32, 16)):
        spans = tpf.q_spans(rq, Hkv, nb, 256, SMS)
        blocks = -(-rq // tpf.q_block_rows(rq)) * Hkv * spans
        assert spans == want and 0.9 * SMS <= blocks <= SMS
        assert spans <= min(nb, live) * 4  # 64-token tiles a span: at least one
    assert tpf.q_spans(8, 2, 1, 64, SMS) == 1  # one tile: one span
    assert tpf.q_block_rows(256) == 128 and tpf.q_block_rows(64) == 64


@pytest.mark.parametrize("D", [64, 128])
def test_b4_widened_fragments_give_scores_and_pv(D):
    """One 64-token tile, 16 query rows all live: S = Q K^T through the
    permuted head dimension with K's codes widened in registers, O = P V
    through token-paired V codes, over every int8 code."""
    rng = np.random.default_rng(D + 1)
    codes = np.tile(np.arange(-128, 128), 64 * D // 256).astype(np.int8)
    k = rng.permutation(codes).reshape(64, D)
    v = rng.permutation(codes).reshape(64, D)
    assert len(np.unique(k)) == len(np.unique(v)) == 256
    q = rng.integers(-4, 5, (16, D)).astype(np.float64)
    kb, vb = k.view(np.uint8).astype(np.int64), v.view(np.uint8).astype(np.int64)

    def word(rows, t, d):
        return int(rows[t, d] | rows[t, d + 1] << 8 | rows[t, d + 2] << 16 | rows[t, d + 3] << 24)

    S = np.zeros((16, 64))
    for n8 in range(8):
        for ks in range(D // 16):
            A, B = np.zeros((16, 16)), np.zeros((16, 8))
            for lane in range(32):
                g, tig = lane // 4, lane % 4
                d = (D // 4) * tig + 4 * ks
                b0, b1 = widen4(word(kb, n8 * 8 + g, d))
                B[2 * tig:2 * tig + 2, g] = b0
                B[2 * tig + 8:2 * tig + 10, g] = b1
                for hh in range(2):  # a0 / a1: d, d + 1; a2 / a3: d + 2, d + 3
                    A[g + 8 * hh, 2 * tig:2 * tig + 2] = q[g + 8 * hh, d:d + 2]
                    A[g + 8 * hh, 2 * tig + 8:2 * tig + 10] = q[g + 8 * hh, d + 2:d + 4]
            S[:, n8 * 8:n8 * 8 + 8] += A @ B
    np.testing.assert_array_equal(S, q @ k.astype(np.float64).T)

    P = rng.integers(-3, 4, (16, 64)).astype(np.float64)
    O = np.zeros((16, D))
    for kk in range(4):
        A = np.zeros((16, 16))
        for lane in range(32):
            g, tig = lane // 4, lane % 4
            for hh in range(2):
                A[g + 8 * hh, 2 * tig:2 * tig + 2] = P[g + 8 * hh, 16 * kk + 2 * tig:][:2]
                A[g + 8 * hh, 2 * tig + 8:2 * tig + 10] = P[g + 8 * hh, 16 * kk + 8 + 2 * tig:][:2]
        for nt in range(D // 8):
            B = np.zeros((16, 8))
            for lane in range(32):
                g, tig = lane // 4, lane % 4
                u, j = nt // 4, nt % 4
                d = (D // 8) * g + 4 * u
                for r0, kr in ((2 * tig, 2 * tig), (2 * tig + 8, 2 * tig + 8)):
                    x, y = word(vb, 16 * kk + r0, d), word(vb, 16 * kk + r0 + 1, d)
                    pairs = widen4(pair_lo(x, y)) + widen4(pair_hi(x, y))
                    B[kr:kr + 2, g] = pairs[j]
            C = A @ B  # column n of n-tile nt: d = (D / 8) n + nt
            for n in range(8):
                O[:, (D // 8) * n + nt] += C[:, n]
    np.testing.assert_array_equal(O, P @ v.astype(np.float64))


# -- plain versions against deft_tpu ---------------------------------------------------

def check_state(got, want, tol):
    """A partial state (acc, m, l) against deft_tpu's, rows on the leading
    axes: m where the row saw a token; at fp32 tolerance acc and l
    themselves; at bf16 tolerance the output the state carries, acc / l.
    (deft_tpu's bf16 kernels round the scaled q to bf16: on scores of
    magnitude ~10 that moves e^s, so acc and l alike, by up to ~2%, which
    acc / l cancels.)"""
    (gacc, gm, gl), (wacc, wm, wl) = got, want
    seen = wl > 0
    assert rel_err(gm[seen], wm[seen]) < tol
    if tol < DTYPES["bfloat16"][2]:
        assert rel_err(gacc, wacc) < tol
        assert rel_err(gl, wl) < tol
    else:
        assert rel_err(gacc[seen] / gl[seen][:, None], wacc[seen] / wl[seen][:, None]) < tol
    assert np.isfinite(gm).all() and np.isfinite(gacc).all()


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("qpk,D", [(4, 64), (1, 128), (8, 64)])
def test_b2_plain_vs_pallas_on_edge_plans(qpk, D, dt):
    """B2 and B2p over bf16/fp32 pools on per-leaf tables with dead blocks,
    a one-token leaf and path lengths off the 16-token tile."""
    Hkv, R, nb, spb, seg_len, S = 2, 6, 3, 2, 128, 4096
    Hq = qpk * Hkv
    rng = np.random.default_rng(qpk * D + 7)
    tables = synthetic_seq_plan(rng, R, nb, spb, seg_len, S, one_token_leaf=2)
    jdt, tdt, tol = DTYPES[dt]
    kd, vd = (rng.standard_normal((1, S, Hkv * D)).astype(np.float32) for _ in range(2))
    q = rng.standard_normal((R, Hq, D)).astype(np.float32)
    jargs = [jnp.asarray(q, jdt).reshape(R, Hkv, qpk, D), jnp.asarray(kd, jdt),
             jnp.asarray(vd, jdt), jnp.asarray(0, jnp.int32)] + [jnp.asarray(t) for t in tables]
    targs = [torch.from_numpy(q).to(tdt), torch.from_numpy(kd).to(tdt),
             torch.from_numpy(vd).to(tdt), 0] + [torch.from_numpy(t) for t in tables]
    kw = dict(scale=D ** -0.5, block_len=spb * seg_len, seg_len=seg_len)
    want = np.asarray(j_b2(*jargs, **kw), np.float32).reshape(R, Hq, D)
    got = tps.paged_seq_attention(*targs, D ** -0.5, seg_len)
    assert rel_err(got.float().numpy(), want) < tol
    acc, m, l = (np.asarray(x).reshape(R, Hq, D) for x in j_b2p(*jargs, **kw))
    got = tps.paged_seq_attention_partial(*targs, D ** -0.5, seg_len)
    check_state([t.numpy() for t in got], (acc, m[..., 0], l[..., 0]), tol)


def int8_pools(rng, S, Hkv, D):
    codes = [rng.integers(-127, 128, (1, S, Hkv * D)).astype(np.int8) for _ in range(2)]
    scales = [rng.uniform(0.01, 0.1, (1, Hkv, S)).astype(np.float32) for _ in range(2)]
    return codes + scales


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("seg_len,nblk", [(32, None), (512, None), (128, 21), (256, 32)])
def test_b4_plain_vs_pallas_on_edge_plans(seg_len, nblk, dt):
    """B4 over the whole edge plan and B4p over a window of its first nblk
    blocks (or the whole plan), int8 codes and scales, qpk 4, D 64."""
    qpk, Hkv, D = 4, 2, 64
    tree, plan = edge_plan(seg_len, 2500, 12, qpk=qpk)
    nb = nblk or len(plan.blk_lo)
    assert nb <= len(plan.blk_lo)
    S = tree.token_to_kv_pool.size
    rng = np.random.default_rng(seg_len + (nblk or 0))
    pools = int8_pools(rng, S, Hkv, D)
    q = rng.standard_normal((plan.l_pad, qpk * Hkv, D)).astype(np.float32)
    jdt, tdt, tol = DTYPES[dt]
    jq = fold_q(jnp.asarray(q, jdt), Hkv)
    jp = [jnp.asarray(a) for a in pools] + [jnp.asarray(0, jnp.int32)]
    tq = torch.from_numpy(q).to(tdt)
    tp = [torch.from_numpy(a) for a in pools] + [0]
    kw = dict(scale=D ** -0.5, qpk=qpk, block_len=plan.block_len, seg_len=seg_len)
    live = plan.n_leaves
    if nblk is None:
        arrs = window(plan, nb)
        want = unfold_o(j_b4(jq, *jp, *(jnp.asarray(a) for a in arrs), **kw), plan.l_pad)
        got = tpq.paged_flatten_attention_q(tq, *tp, *(torch.from_numpy(a) for a in arrs),
                                            D ** -0.5, plan.block_len, seg_len)
        assert rel_err(got.float().numpy()[:live], np.asarray(want, np.float32)[:live]) < tol
    arrs = window(plan, nb)
    wacc, wm, wl = (np.asarray(x) for x in j_b4p(jq, *jp, *(jnp.asarray(a) for a in arrs),
                                                 **kw))
    gacc, gm, gl = (t.numpy() for t in tpq.paged_flatten_attention_q_partial(
        tq, *tp, *(torch.from_numpy(a) for a in arrs), D ** -0.5, plan.block_len, seg_len))
    rows = slice(0, live * qpk)
    check_state((gacc[:, rows], gm[:, rows], gl[:, rows]),
                (wacc[:, rows], wm[..., 0][:, rows], wl[..., 0][:, rows]), tol)
