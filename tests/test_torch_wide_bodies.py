"""The Python side of the wide-head bodies (head_dim 96, Phi-3-mini, and 256,
Gemma-7B) of B3/B8 and B7, on the CPU.

Over bf16, B3 and B8 (csrc/prefill.cu) run the wgmma body at every width,
and B7 (csrc/seq_gather.cu) runs csrc/seq_q_body.cuh's seq_q_wide at 96 and
256: path tokens on the products' M, query rows on N.  A CUDA kernel runs
only on the card, so these tests emulate in numpy what the kernels compute
from their layouts, on integer data, where every product is exact:

- B3/B8 (wg::Layout): the tile depth, stage count and register split fit
  an H100's 227 KB of shared memory and 65536 registers; at D 96 and 256
  the TMA boxes of the 3-D maps put every (token, head, d < D) element of
  q, K, V at exactly one 128-byte-swizzled shared-memory address, zeros
  past D; S = Q K^T over the live k16 steps, P V over whole boxes and the
  o staging and store give the folded rows' attention, and no column past
  D reaches o;
- B7 (seq_q_wide): K's and V's rows as issue_tile puts them, the A and B
  fragments as the kernel loads them (ldmatrix over bf16 rows; int8 codes
  widened in registers, V's codes paired two tokens at a time) and P^T's B
  fragment built by the kernel's shuffles from S^T's accumulators give
  S^T = K Q^T and O^T = V^T P^T exactly at D 96 and 256, qpk 1, 2 and 8,
  and the epilogue puts each live (row, d) of o in one place; the split
  over splits, warps and tiles reads every live path entry once at each
  width (test_torch_b7's emulation) and the tile copies cover each row
  once; ``seq_splits`` at Gemma-7B's and Phi-3-mini's shapes fills the
  card.
"""

import numpy as np
import pytest
from test_torch_b1 import a_fragment, acc_layout, sw128
from test_torch_b7 import idx_path_reads

import chip_smoke as cs
from deft_tpu_torch.ops import paged_seq_attn as tps

SMEM, REGS, SMS = 232448, 65536, 132  # an H100's block shared memory, SM registers, SMs


# -- B3/B8: the wgmma body's layout ------------------------------------------------------

ROWS, P_STAGES = 128, 2  # prefill.cu wg: folded rows a block, stages of the ring


def prefill_layout(D, tok=None):
    """prefill.cu wg::Layout<D>: boxes across D, live k16 steps, P V's N,
    tokens a KV tile, box and tile bytes, the block's shared memory and the
    (producer, consumer) registers a thread after setmaxnreg."""
    NC = -(-D // 64)
    tok = tok or (64 if D > 128 else 128)
    q_box, kv_box = ROWS * 128, tok * 128
    stage = 2 * NC * kv_box
    return dict(NC=NC, steps=D // 16, DN=64 * NC, tok=tok, q_box=q_box, kv_box=kv_box,
                kv=NC * kv_box, q=NC * q_box,
                bytes=1024 + NC * q_box + P_STAGES * stage + (1 + 2 * P_STAGES) * 8,
                regs=(24, 240) if D > 128 else (40, 232))


@pytest.mark.parametrize("D", [64, 96, 128, 256])
def test_b3_tiles_and_registers_fit(D):
    """Two stages of the width's tile depth beside the Q tile fit 227 KB (at
    D 256 a 128-token tile would not, so the tile is 64 tokens); the
    warpgroups' register split fits 65536 and leaves each consumer thread
    room for O, S and P's fragments."""
    L = prefill_layout(D)
    assert L["bytes"] <= SMEM
    if D == 256:
        assert L["tok"] == 64 and prefill_layout(D, tok=128)["bytes"] > SMEM
    producer, consumer = L["regs"]
    assert 128 * producer + 256 * consumer <= REGS
    assert producer % 8 == 0 and consumer % 8 == 0 and 24 <= producer < consumer <= 256
    held = L["DN"] // 2 + L["tok"] // 2 + L["tok"] // 16 * 4  # o, S, P (bf16 pairs)
    assert held < consumer - 32


def tma_box(x, c0, c1, c2, box, out, base):
    """One TMA box load under SWIZZLE_128B: x (dim2, dim1, dim0) of element
    slots, box (b0, b1, b2) innermost first at coordinates (c0, c1, c2);
    box row r = i2 * b1 + i1 holds 128 bytes, its 16-byte chunk c at chunk c
    ^ (r % 8).  Elements outside x arrive as zeros.  Writes out[base +
    slot] and returns {(global index): slot}."""
    b0, b1, b2 = box
    placed = {}
    for i2 in range(b2):
        for i1 in range(b1):
            r = i2 * b1 + i1
            for i0 in range(b0):
                byte = 2 * i0
                slot = (r * 128 + (((byte // 16) ^ (r % 8)) << 4) + byte % 16) // 2
                assert np.isnan(out[base + slot])  # each slot written once
                at = (c2 + i2, c1 + i1, c0 + i0)
                inside = all(a < n for a, n in zip(at, x.shape))
                out[base + slot] = x[at] if inside else 0.0
                if inside:
                    placed[at] = base + slot
    return placed


def tma_store(x, c0, c1, c2, box, tile, base):
    """One TMA box store: the inverse of tma_box, the box's part outside x
    dropped.  Returns the global indices written."""
    b0, b1, b2 = box
    written = set()
    for i2 in range(b2):
        for i1 in range(b1):
            r = i2 * b1 + i1
            for i0 in range(b0):
                byte = 2 * i0
                slot = (r * 128 + (((byte // 16) ^ (r % 8)) << 4) + byte % 16) // 2
                at = (c2 + i2, c1 + i1, c0 + i0)
                if all(a < n for a, n in zip(at, x.shape)):
                    x[at] = tile[base + slot]
                    written.add(at)
    return written


@pytest.mark.parametrize("D", [96, 256])
@pytest.mark.parametrize("qpk", [1, 4])
def test_b3_wide_boxes_products_and_store(D, qpk):
    """The last row tile of a prompt whose length it overruns, KV head 1 of
    2, its first KV tile: q, K and V boxes placed by TMA, S for each
    consumer warpgroup's 64 folded rows as L["steps"] SS wgmma (Q and K
    K-major, 32 bytes a step inside a box), O = P V as RS wgmma over the
    tile's k16 steps (V N-major, N over whole boxes one box apart), the o
    staging of the epilogue into the Q tile, then the store through the
    q map's boxes."""
    L = prefill_layout(D)
    NC, tok, Hkv = L["NC"], L["tok"], 2
    Hq, T, h = Hkv * qpk, ROWS // qpk, 1
    N = T + T // 2 + 3  # two row tiles, the last one past the prompt's end
    t0 = T  # the last row tile
    rng = np.random.default_rng(D + qpk)
    q = rng.integers(-4, 5, (N, Hq, D)).astype(np.float64)
    k = rng.integers(-4, 5, (N, Hkv, D)).astype(np.float64)
    v = rng.integers(-4, 5, (N, Hkv, D)).astype(np.float64)

    qs = np.full(L["q"] // 2, np.nan)
    placed = {}
    for c in range(NC):
        placed.update(tma_box(q, 64 * c, h * qpk, t0, (64, qpk, T), qs, c * L["q_box"] // 2))
    live = [(t, hh, d) for t in range(t0, N) for hh in range(h * qpk, h * qpk + qpk)
            for d in range(D)]
    assert sorted(placed) == live and len(set(placed.values())) == len(live)
    kt, vt = np.full(L["kv"] // 2, np.nan), np.full(L["kv"] // 2, np.nan)
    for c in range(NC):
        for x, tile in ((k, kt), (v, vt)):
            got = tma_box(x, 64 * c, h, 0, (64, 1, tok), tile, c * L["kv_box"] // 2)
            assert len(got) == min(64, D - 64 * c) * min(tok, N)
    if D % 64:  # the second box's columns past D hold zeros
        pad = [sw128(kt, L["kv_box"], r, 2 * (D % 64) + b) for r in range(tok)
               for b in range(0, 128 - 2 * (D % 64), 2)]
        assert not any(pad)

    # folded row r = (token t0 + r // qpk, head h qpk + r % qpk); keys 0 .. tok - 1
    qf = np.zeros((ROWS, D))
    for r in range(ROWS):
        if t0 + r // qpk < N:
            qf[r] = q[t0 + r // qpk, h * qpk + r % qpk]
    kk_, vv_ = np.zeros((2, tok, D))  # the tile's keys, zeros past the prompt
    kk_[:N], vv_[:N] = k[:tok, h], v[:tok, h]
    P = rng.integers(0, 4, (ROWS, tok)).astype(np.float64)
    o_fold = np.zeros((ROWS, L["DN"]))
    for cw in range(2):
        S = np.zeros((64, tok))
        for kk in range(L["steps"]):
            c, off = kk // 4, kk % 4 * 32
            A = sw128(qs, c * L["q_box"] + cw * 64 * 128 + off, np.arange(64)[:, None],
                      2 * np.arange(16)[None, :])
            B = sw128(kt, c * L["kv_box"] + off, np.arange(tok)[None, :],
                      2 * np.arange(16)[:, None])
            S += A @ B
        rows = slice(64 * cw, 64 * cw + 64)
        np.testing.assert_array_equal(S, qf[rows] @ kk_.T)
        O = np.zeros((64, L["DN"]))
        for kt_ in range(tok // 16):
            n = np.arange(L["DN"])[None, :]
            B = sw128(vt, kt_ * 16 * 128 + (n // 64) * L["kv_box"], np.arange(16)[:, None],
                      2 * (n % 64))
            A = np.zeros((64, 16))
            for w in range(4):
                for lane in range(32):
                    regs = a_fragment(P[rows], w, lane, 16 * kt_)
                    g, tig = lane // 4, lane % 4
                    r = 16 * w + g
                    A[r, 2 * tig:2 * tig + 2], A[r + 8, 2 * tig:2 * tig + 2] = regs[:2]
                    A[r, 2 * tig + 8:2 * tig + 10] = regs[2]
                    A[r + 8, 2 * tig + 8:2 * tig + 10] = regs[3]
            O += A @ B
        np.testing.assert_array_equal(O[:, :D], P[rows] @ vv_)
        assert not O[:, D:].any()  # V's zero columns
        o_fold[rows] = O

    # the epilogue: accumulator (row, column 8 n + 2 tig + e) into the Q
    # tile's box n / 8, chunk (n % 8) ^ (row % 8), word tig; then the store
    for cw in range(2):
        for row, col, w, lane, idx in acc_layout(L["DN"]):
            n, tig = col // 8, lane % 4
            lr = 64 * cw + row
            byte = (n // 8) * L["q_box"] + lr * 128 + (((n % 8) ^ (lr & 7)) << 4) + tig * 4
            qs[byte // 2 + idx % 2] = o_fold[lr, col]
    out = np.full(q.shape, np.nan)
    written = set()
    for c in range(NC):
        written |= tma_store(out, 64 * c, h * qpk, t0, (64, qpk, T), qs, c * L["q_box"] // 2)
    assert sorted(written) == live  # nothing past D, past N or of another head
    for r in range(ROWS):
        if t0 + r // qpk < N:
            np.testing.assert_array_equal(out[t0 + r // qpk, h * qpk + r % qpk], o_fold[r, :D])


# -- B7: seq_q_wide ----------------------------------------------------------------------

TILE = 16  # path tokens a tile (csrc/seq_q_body.cuh)


def row_pitch(D, kv):
    """Layout<KV, D, W>::P: a K or V row's bytes in a stage, padded by 16."""
    return D * (1 if kv == "int8" else 2) + 16


def mma(a, b):
    """mma.sync m16n8k16 over a warp: a[lane] the four A registers (pairs:
    rows g, g + 8 at k 2 tig, + 1, then at k 2 tig + 8, + 9), b[lane] the two
    B registers (k 2 tig, + 1 and + 8, + 9 at column g).  Rebuilds A (16 x
    16) and B (16 x 8), checking that the lanes agree, and returns C's
    fragments c[lane] = (row g, cols 2 tig, + 1; row g + 8, the same)."""
    A, B = np.full((16, 16), np.nan), np.full((16, 8), np.nan)
    for lane in range(32):
        g, tig = lane // 4, lane % 4
        for reg, (r, k0) in enumerate(((g, 2 * tig), (g + 8, 2 * tig), (g, 2 * tig + 8),
                                       (g + 8, 2 * tig + 8))):
            A[r, k0:k0 + 2] = a[lane][reg]
        for reg, k0 in enumerate((2 * tig, 2 * tig + 8)):
            B[k0:k0 + 2, g] = b[lane][reg]
    assert not np.isnan(A).any() and not np.isnan(B).any()
    C = A @ B
    return [(C[g, 2 * (lane % 4)], C[g, 2 * (lane % 4) + 1], C[g + 8, 2 * (lane % 4)],
             C[g + 8, 2 * (lane % 4) + 1]) for lane in range(32) for g in [lane // 4]]


def ldsm_x4(rows, addr, trans=False):
    """ldmatrix.x4 over a warp: lane l addresses row l % 8 of matrix l / 8
    (addr[l] = (token row, first element)); each matrix is 8 rows of 8
    elements.  rows[t, e] holds the stage's values.  Returns regs[lane][j]
    = two values of matrix j: row lane / 4, elements 2 (lane % 4), + 1; with
    trans, of the transposed matrix."""
    out = []
    for lane in range(32):
        regs = []
        for j in range(4):
            if trans:
                pair = [rows[addr[8 * j + 2 * (lane % 4) + e][0],
                             addr[8 * j + 2 * (lane % 4) + e][1] + lane // 4] for e in (0, 1)]
            else:
                t, e0 = addr[8 * j + lane // 4]
                pair = [rows[t, e0 + 2 * (lane % 4) + e] for e in (0, 1)]
            regs.append(pair)
        out.append(regs)
    return out


def v_codes(row, D, m):
    """The kernel's v_codes: the D / 16 codes of a V row at head dims
    (D / 16) m .. (row: the row's bytes).  D 96: read from the 4-byte-aligned
    8 bytes around them and shifted by 16 (m & 1) bits."""
    B = D // 16
    if B % 4 == 0:
        return list(row[B * m:B * m + B])
    at = B * m - 2 * (m & 1)
    assert at % 4 == 0
    return list(row[at:at + 8][2 * (m & 1):2 * (m & 1) + B])


def wide_tile(D, qpk, kv, rng):
    """S^T and O^T of one 16-token tile through seq_q_wide's fragments for
    one warp.  Returns (K, V, Q (8, D), ks, vs, P (8, 16), S^T (16, 8), O
    (8, D) as the epilogue places acc, the (row, d) each acc lands on)."""
    int8 = kv == "int8"
    K = rng.integers(-127 if int8 else -8, 128 if int8 else 9, (TILE, D)).astype(np.float64)
    V = rng.integers(-127 if int8 else -8, 128 if int8 else 9, (TILE, D)).astype(np.float64)
    Q = np.zeros((8, D))
    Q[:qpk] = rng.integers(-4, 5, (qpk, D))
    ks = rng.integers(1, 4, TILE).astype(np.float64) if int8 else np.ones(TILE)
    vs = rng.integers(1, 4, TILE).astype(np.float64) if int8 else np.ones(TILE)

    # Q's fragments (load_q), query row g: int8 d = (D / 4) tig + 4 ks + 0..3
    def qd(lane, ks_, w):
        g, tig = lane // 4, lane % 4
        d0 = (D // 4) * tig + 4 * ks_ + 2 * w if int8 else 16 * ks_ + 2 * tig + 8 * w
        return Q[g, d0:d0 + 2]

    # S^T = K Q^T (tile_scores_t)
    st = [(0.0,) * 4] * 32
    for ks_ in range(D // 16):
        if int8:  # rows g, g + 8: word ks_ of their D / 4 bytes at (D / 4) tig
            a = []
            for lane in range(32):
                g, tig = lane // 4, lane % 4
                d0 = (D // 4) * tig + 4 * ks_
                w0, w1 = K[g, d0:d0 + 4], K[g + 8, d0:d0 + 4]  # widen4: lo, hi
                a.append([w0[:2], w1[:2], w0[2:], w1[2:]])
        else:  # lane l: token l % 16, elements 8 (l / 16) of each 16
            addr = [(lane % 16, 8 * (lane // 16) + 16 * ks_) for lane in range(32)]
            a = ldsm_x4(K, addr)  # matrices 0-3: the A registers a0-a3
        b = [[qd(lane, ks_, 0), qd(lane, ks_, 1)] for lane in range(32)]
        c = mma(a, b)
        st = [tuple(x + y for x, y in zip(st[l], c[l])) for l in range(32)]
    ST = np.zeros((TILE, 8))
    for lane in range(32):  # s[i]: token g + 8 (i / 2), query row 2 tig + i % 2
        g, tig = lane // 4, lane % 4
        for i in range(4):
            ST[g + 8 * (i // 2), 2 * tig + i % 2] = st[lane][i] * ks[g + 8 * (i // 2)]
    np.testing.assert_array_equal(ST, (K * ks[:, None]) @ Q.T)

    # P in S^T's places, times V's scale; P^T's B fragment by the shuffles
    P = rng.integers(0, 4, (8, TILE)).astype(np.float64)
    pv = [[P[2 * (lane % 4) + i % 2, lane // 4 + 8 * (i // 2)]
           * vs[lane // 4 + 8 * (i // 2)] for i in range(4)] for lane in range(32)]
    w01 = [(p[0], p[1]) for p in pv]
    w23 = [(p[2], p[3]) for p in pv]
    pb = []
    for lane in range(32):
        g, tig = lane // 4, lane % 4
        src, half = 8 * tig + g // 2, g % 2
        pb.append([[w01[src][half], w01[src + 4][half]], [w23[src][half], w23[src + 4][half]]])

    # O^T += V^T P^T (tile_pv_t)
    acc = [[(0.0,) * 4 for _ in range(D // 16)] for _ in range(32)]
    if int8:
        # c[t][hh]: token 2 tig + t % 2 + 8 (t / 2), codes of row m = g + 8 hh
        codes = [[[v_codes(V[2 * (lane % 4) + t % 2 + 8 * (t // 2)], D, lane // 4 + 8 * hh)
                   for hh in range(2)] for t in range(4)] for lane in range(32)]
        for mt in range(D // 16):
            a = []
            for lane in range(32):
                cl = codes[lane]
                a.append([[cl[2 * (r // 2)][r % 2][mt], cl[2 * (r // 2) + 1][r % 2][mt]]
                          for r in range(4)])
            c = mma(a, pb)
            for lane in range(32):
                acc[lane][mt] = tuple(x + y for x, y in zip(acc[lane][mt], c[lane]))
    else:  # lane l: token l % 8 + 8 (l / 16), elements 8 ((l / 8) % 2) of each 16
        for mt in range(D // 16):
            addr = [(lane % 8 + 8 * (lane // 16), 8 * ((lane // 8) % 2) + 16 * mt)
                    for lane in range(32)]
            c = mma(ldsm_x4(V, addr, trans=True), pb)
            for lane in range(32):
                acc[lane][mt] = tuple(x + y for x, y in zip(acc[lane][mt], c[lane]))

    # the epilogue: acc[mt][i] is query row 2 tig + i % 2 at head dim d
    O, places = np.full((8, D), np.nan), []
    for lane in range(32):
        g, tig = lane // 4, lane % 4
        for mt in range(D // 16):
            for i in range(4):
                m = g + 8 * (i // 2)
                d = (D // 16) * m + mt if int8 else 16 * mt + m
                n = 2 * tig + i % 2
                assert np.isnan(O[n, d])
                O[n, d] = acc[lane][mt][i]
                places.append((n, d))
    return K, V, Q, ks, vs, P, ST, O, places


@pytest.mark.parametrize("D", [96, 256])
@pytest.mark.parametrize("qpk", [1, 2, 8])
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_b7_wide_fragments_give_scores_and_pv(D, qpk, kv):
    """One tile, one warp, integer values: S^T = K Q^T (int8: times K's
    scales), O = (P times V's scales) V, and every (query row, d) of the
    warp's 8 rows lands in one place of the epilogue's state; the live
    rows are the first qpk."""
    K, V, Q, ks, vs, P, ST, O, places = wide_tile(D, qpk, kv, np.random.default_rng(D + qpk))
    np.testing.assert_array_equal(O, (P * vs[None, :]) @ V)
    assert sorted(places) == [(n, d) for n in range(8) for d in range(D)]
    assert not ST[:, qpk:].any()  # rows past qpk: zero queries, never written to o
    # the softmax reduces over the lanes of one tig (xor 4, 8, 16): they hold
    # every token of rows 2 tig, 2 tig + 1, once each
    assert sorted(g + 8 * (i // 2) for g in range(8) for i in (0, 2)) == list(range(TILE))


def issue_chunks(D, kv):
    """issue_tile's copies of one tile: lane, (token, byte) of each 16-byte
    chunk of the K and V rows (u = lane, lane + 32, ... below 16 rows'
    chunks)."""
    cpr = D * (1 if kv == "int8" else 2) // 16
    return [(u % 32, u // cpr, 16 * (u % cpr)) for u in range(TILE * cpr)]


@pytest.mark.parametrize("D", [96, 256])
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("splits", [1, 3, 8])
def test_b7_wide_tiles_read_every_live_entry_once(D, kv, splits):
    """The wide body walks the path as deft_seq_q does (test_torch_b7's
    idx_path_reads: every live entry once, in path order, per (leaf, head),
    no pad, nothing for a seq_len 0 leaf); at this width each tile's copy
    covers every byte of its 16 rows once, each lane issuing as many chunks
    as the others, within the row pitch."""
    rng = np.random.default_rng(splits)
    paths, lens = cs.synthetic_gather_paths(rng, [37, 1, 0, 64, 16, 45, 0], 64, 4096)
    for r, cols in enumerate(idx_path_reads(paths, lens, splits)):
        assert cols == list(range(int(lens[r])))
    chunks = issue_chunks(D, kv)
    covered = sorted((t, b + i) for _, t, b in chunks for i in range(16))
    width = D * (1 if kv == "int8" else 2)
    assert covered == [(t, b) for t in range(TILE) for b in range(width)]
    assert width + 16 == row_pitch(D, kv) and row_pitch(D, kv) % 16 == 0
    per_lane = np.bincount([lane for lane, _, _ in chunks], minlength=32)
    assert per_lane.min() == per_lane.max()


def resident(D, kv, warps=2, stages=3):
    """Blocks of the wide body an SM holds: its ring (warps x stages x K, V
    rows and int8 scales) against 228 KB, 1 KB reserved a block."""
    stage = 2 * TILE * row_pitch(D, kv) + (2 * TILE * 4 if kv == "int8" else 0)
    state = warps * 8 * (2 + D + D // 32) * 4
    return 233472 // (max(warps * stages * stage, state) + 1024)


@pytest.mark.parametrize("D,Hkv", [(96, 32), (256, 16)])
def test_b7_wide_splits_fill_the_card(D, Hkv):
    """Phi-3-mini's 32 and Gemma-7B's 16 KV heads: the wrapper's blocks an
    SM holds are the wide body's ring against 228 KB; at the main and short
    trees' 50 leaves the (leaf, head) pairs alone fill every resident block
    slot, and a few leaves split their paths until they do, no further."""
    for kv in ("bfloat16", "int8"):
        int8 = kv == "int8"
        per_sm = resident(D, kv)
        assert tps._WIDE_BLOCKS_PER_SM[(D, kv)] == per_sm
        for R in (cs.WIDTH, 1, 2, 3, 5, 8):
            sp = tps.seq_splits(R, Hkv, SMS, int8, D)
            assert 1 <= sp <= 8
            assert sp == 8 or R * Hkv * sp >= per_sm * SMS  # every slot busy
            assert sp == 1 or R * Hkv * (sp - 1) < per_sm * SMS  # no more than that
        assert tps.seq_splits(cs.WIDTH, Hkv, SMS, int8, D) == 1
