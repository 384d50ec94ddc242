"""The Python side of B6's and B11's tensor-core body at the wide heads
(head_dim 96, Phi-3-mini, and 256, Gemma-7B), on the CPU.

Over bf16 q, B6 and B11 (csrc/flatten_gather.cu) run csrc/flat_q_body.cuh's
deft_flat_q at every head width.  A CUDA kernel runs only on the card, so
these tests emulate in numpy, on integer data (where every product is
exact), what the body computes from its layouts at D 96 and 256, 4 and 8
warps a block, bf16 and int8 pools:

- each Layout's ring, staged Q and block list fit an H100's 227 KB, the
  epilogue's staging fits the ring, and the registers a thread holds fit
  255 (at D 256 Q's A fragments would not, nor would four bf16 stages);
- the copies (one pool row a lane, shuffled to the lanes copying its
  chunks) put every (token, d < D) at exactly one swizzled address, the
  scales of every token once, and at D 96 the half box no copy writes is
  zeroed, so P V at N 128 reads zeros there;
- S over the live k16 steps (RS from Q's fragments; at D 256 SS from Q's
  staged boxes, the descriptors a base plus an offset) and P V at N 128 or
  256 give the tile's attention, and the epilogue stores each d < D once;
- int8 K's 24- and 64-byte and V's 12- and 32-byte reads, widened into
  mma.sync fragments, give exact products;
- ``q_spans`` and ``balanced_spans`` fill the card at Gemma-7B's and
  Phi-3-mini's main-tree shapes, and the wrapper's span rule
  (``span_count``) takes them for bf16 q at D 96 and 256 and ``num_spans``
  for fp32 q.
"""

import numpy as np
import pytest
import torch
from test_torch_b1 import a_fragment, acc_layout, sw128
from test_torch_wide_bodies import mma

import chip_smoke as cs
from deft_tpu_torch.ops import paged_flatten_attn as tpf
from deft_tpu_torch.plan import build_flatten_plan

SMEM, REGS, SMS = 231424, 255, 132  # deft_flat_q's kMaxSmem, a thread's registers, SMs
BN, BOX = 64, 64 * 128  # tokens a tile; a 64-column box of 64 rows x 128 bytes
WIDTHS = [64, 96, 128, 256]


def layout(kv, D):
    """csrc/flat_q_body.cuh Layout<KV, D>: the bytes of a stage and of the
    ring, and what the body keeps where."""
    q8 = kv == "int8"
    nb = -(-D // 64)
    P = D + 16 if q8 else 128
    rows = BN * P if q8 else nb * BOX
    scales = 2 * BN * 4 if q8 else 0
    stage = -(-(2 * rows + scales + 2 * BN * 4) // 1024) * 1024
    stages = 2 if not q8 and D > 128 else 4
    return dict(q8=q8, NB=nb, DN=D if q8 else 64 * nb, qsmem=D > 128, stages=stages, P=P,
                rows=rows, scales=scales, stage=stage, ring=stages * stage,
                qwarp=32 * D if D > 128 else 0, cpr=D * (1 if q8 else 2) // 16)


def smem_bytes(L, W, nb):
    """smem_bytes<KV, D, W>(nb): the ring's alignment, the ring, staged Q and
    the block list."""
    return 1024 + L["ring"] + W * L["qwarp"] + 8 * nb


def chunk_addr(L, tok, ch):
    """Layout::chunk: where 16-byte chunk ch of token row tok lands."""
    if L["q8"]:
        return tok * L["P"] + 16 * ch
    return (ch // 8) * BOX + tok * 128 + (((ch % 8) ^ (tok & 7)) << 4)


# -- shared memory and registers ------------------------------------------------------

@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("D", WIDTHS)
@pytest.mark.parametrize("W", [4, 8])
def test_layout_fits_smem_and_registers(kv, D, W):
    """Ring, staged Q and a 1024-block list fit 227 KB; 16 W rows of D + 1
    floats (the epilogue) fit the ring; a stage is whole 1024-byte swizzle
    atoms.  Registers a thread holds in the products' two phases: O (DN / 2),
    then S (32) and Q's fragments or the int8 body's reads, or P (16) and
    V's widened words: at most 208 of 255 (the rest: addresses, m, l).  At
    bf16 D 256, Q's fragments in registers (64) would bring that to 240 and
    four stages would not fit, hence SS from staged Q and two stages."""
    L = layout(kv, D)
    assert smem_bytes(L, W, 1024) <= SMEM
    assert 16 * W * (D + 1) * 4 <= L["ring"]
    assert L["stage"] % 1024 == 0 and L["ring"] % 1024 == 0
    qa = 0 if L["qsmem"] else D // 16 * 4
    if L["q8"]:  # S: Q's fragments (or 4 steps staged), K's words, their widening
        s_phase = L["DN"] // 2 + 32 + (16 if L["qsmem"] else qa) + D // 16 + 2
        pv_phase = L["DN"] // 2 + 16 + qa + 4 + 8
    else:
        s_phase = L["DN"] // 2 + 32 + qa
        pv_phase = L["DN"] // 2 + 16 + qa
    assert max(s_phase, pv_phase) <= 208
    if kv == "bf16" and D == 256:
        assert L["DN"] // 2 + 32 + 16 + D // 16 * 4 == 240
        assert smem_bytes(dict(L, ring=4 * L["stage"]), 4, 0) > SMEM
    if L["qsmem"]:  # staged Q: 16 rows of D bf16 a warp, in either form
        assert L["qwarp"] == 16 * D * 2 == D // 16 * 32 * 16


# -- the copies -------------------------------------------------------------------------

def stage_copies(kv, D, W):
    """Every 16-byte copy issue() makes into a stage's K (the same for V):
    (address, token, chunk).  Warp w copies tokens w TPW .. + TPW - 1; lane
    l holds the pool row of token l % TPW and gets the row of its chunk's
    token by a shuffle from lane v / CPR, v = c * 32 + l."""
    L = layout(kv, D)
    cpr, tpw = L["cpr"], BN // W
    wch = tpw * cpr
    out = []
    for warp in range(W):
        for lane in range(32):
            for c in range(-(-wch // 32)):
                v = c * 32 + lane
                if v >= wch:
                    continue
                tl, ch = divmod(v, cpr)
                assert tl < tpw and (tl % 32) % tpw == tl  # the source lane holds tl's row
                tok = warp * tpw + tl
                out.append((chunk_addr(L, tok, ch), tok, ch))
    return out


def zeroed(D, W):
    """The 16-byte slots the body zeroes at the start (bf16, D % 64): the
    chunks of the last box past D in every stage's K and V rows, as
    offsets into the ring."""
    L = layout("bf16", D)
    live = (D % 64) // 8
    dead = 8 - live
    out = []
    for tid in range(32 * W):
        for i in range(tid, L["stages"] * 2 * BN * dead, 32 * W):
            c, tok, part = live + i % dead, i // dead % BN, i // (dead * BN)
            out.append(part // 2 * L["stage"] + part % 2 * L["rows"] + (L["NB"] - 1) * BOX
                       + tok * 128 + ((c ^ (tok & 7)) << 4))
    return out


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("D", WIDTHS)
@pytest.mark.parametrize("W", [4, 8])
def test_copies_place_every_chunk_once(kv, D, W):
    """Each (token, chunk) of a tile is copied once to its own 16-byte slot
    inside the stage's K rows; over bf16 pools the copies and the zeroed
    slots (D 96) fill every slot of every stage's K and V boxes once; over
    int8 pools each token's K and V scale is copied once, by a lane that
    holds that token's row."""
    L = layout(kv, D)
    copies = stage_copies(kv, D, W)
    assert sorted((t, c) for _, t, c in copies) == [(t, c) for t in range(BN)
                                                    for c in range(L["cpr"])]
    addrs = [a for a, _, _ in copies]
    assert len(set(addrs)) == len(addrs) and all(0 <= a < L["rows"] for a in addrs)
    if not L["q8"]:
        zeros = zeroed(D, W) if D % 64 else []
        ring = [s * L["stage"] + part * L["rows"] + a for s in range(L["stages"])
                for part in (0, 1) for a in addrs] + zeros
        assert len(set(ring)) == len(ring)
        assert sorted(ring) == sorted(s * L["stage"] + part * L["rows"] + 16 * i
                                      for s in range(L["stages"]) for part in (0, 1)
                                      for i in range(L["rows"] // 16))
    else:
        tpw = BN // W
        scales = [((lane // tpw) * BN + warp * tpw + lane % tpw, warp * tpw + lane % tpw)
                  for warp in range(W) for lane in range(2 * tpw)]
        assert sorted(slot for slot, _ in scales) == list(range(2 * BN))
        assert all(slot % BN == tok for slot, tok in scales)


def bf16_stage(rows, D, zero_dead=True):
    """A (64, D) tile as the copies and the zeroing put it in one K (or V)
    box set: element slots (2 bytes each) of NB boxes."""
    L = layout("bf16", D)
    out = np.full(L["rows"] // 2, np.nan)
    for a, tok, ch in stage_copies("bf16", D, 4):
        out[a // 2:a // 2 + 8] = rows[tok, 8 * ch:8 * ch + 8]
    if zero_dead and D % 64:
        for a in zeroed(D, 4):
            if a < L["rows"]:  # stage 0's K boxes
                out[a // 2:a // 2 + 8] = 0.0
    return out


@pytest.mark.parametrize("D", [96, 256])
def test_swizzled_boxes_hold_each_element_once(D):
    """Read through the wgmma descriptors' 128-byte swizzle, box d / 64 row
    tok at byte 2 (d % 64) holds K[tok, d] for d < D and a zero for D <= d
    < DN (D 96: the half box no copy writes)."""
    L = layout("bf16", D)
    rng = np.random.default_rng(D)
    k = rng.integers(1, 100, (BN, D)).astype(np.float64)
    tile = bf16_stage(k, D)
    assert not np.isnan(tile).any()
    d = np.arange(L["DN"])[None, :]
    got = sw128(tile, (d // 64) * BOX, np.arange(BN)[:, None], 2 * (d % 64))
    np.testing.assert_array_equal(got[:, :D], k)
    assert not got[:, D:].any()


# -- bf16 products ------------------------------------------------------------------------

def desc_start(addr):
    """The start-address field of desc_sw128 (bits 0-13: (addr & 0x3FFFF) >> 4)."""
    return (addr & 0x3FFFF) >> 4


def test_descriptor_offsets_add_to_the_start_field():
    """At D 256 a step's descriptor is the base's plus its byte offset / 16:
    for every 16-byte-aligned base of 227 KB and every step offset inside
    the staged Q or a stage, the sum stays inside the 14-bit field (no
    carry into the leading byte offset)."""
    steps = [(ks // 4) * BOX + (ks % 4) * 32 for ks in range(16)]
    for base in range(0, SMEM - 4 * BOX, 16 * 97):
        for off in steps:
            assert desc_start(base) + off // 16 == desc_start(base + off) < 1 << 14


def a_from_fragments(x, lane_regs, k0):
    """A (64 x 16) rebuilt from each warp's mma A fragments of x."""
    A = np.zeros((64, 16))
    for w in range(4):
        for lane in range(32):
            g, tig = lane // 4, lane % 4
            r0 = a_fragment(x, w, lane, k0) if lane_regs is None else lane_regs(w, lane)
            r = 16 * w + g
            A[r, 2 * tig:2 * tig + 2], A[r + 8, 2 * tig:2 * tig + 2] = r0[0], r0[1]
            A[r, 2 * tig + 8:2 * tig + 10], A[r + 8, 2 * tig + 8:2 * tig + 10] = r0[2:]
    return A


def staged_q(q, Rq, r0, W, D):
    """Q staged at D 256 (bf16): row rr of the block's 16 W, chunk ch, at
    box ch / 8 of warpgroup rr / 64, chunk (ch % 8) ^ (rr % 8); rows past Rq
    zero-filled.  Element slots."""
    L = layout("bf16", D)
    qc, rb = D // 8, 16 * W
    out = np.full(W * L["qwarp"] // 2, np.nan)
    for u in range(rb * qc):  # every thread's u = tid, tid + 32 W, ...
        rr, ch = divmod(u, qc)
        a = ((rr // 64) * L["NB"] * BOX + (ch // 8) * BOX + (rr % 64) * 128
             + (((ch % 8) ^ (rr & 7)) << 4))
        r = r0 + rr
        out[a // 2:a // 2 + 8] = q[r, 8 * ch:8 * ch + 8] if r < Rq else 0.0
    assert not np.isnan(out).any()
    return out


@pytest.mark.parametrize("D", [96, 256])
@pytest.mark.parametrize("W", [4, 8])
def test_bf16_products_give_the_tile_attention(D, W):
    """One 64-token tile, a block's 16 W rows (the last row tile of a head
    whose Rq ends inside it): S = Q K^T over the D / 16 live k16 steps (D
    96: RS from Q's fragments in registers, 6 steps; D 256: SS from the
    staged boxes, descriptors base + offset), O = P V as m64nDNk16 over the
    tile's 4 k16 steps (V N-major, boxes BOX apart; D 96 at N 128 over the
    zeroed half box), A fragments of P as the kernel packs them; then the
    epilogue's columns d = 8 nt + 2 tig + e, nt < D / 8."""
    L = layout("bf16", D)
    rng = np.random.default_rng(D + W)
    rb = 16 * W
    Rq, r0 = rb + rb // 2 - 5, rb  # the second row tile, its last rows pads
    q = rng.integers(-8, 9, (2 * rb, D)).astype(np.float64)
    k = rng.integers(-16, 17, (BN, D)).astype(np.float64)
    v = rng.integers(-16, 17, (BN, D)).astype(np.float64)
    kt, vt = bf16_stage(k, D), bf16_stage(v, D)
    qs = staged_q(q, Rq, r0, W, D) if L["qsmem"] else None
    qb = np.where((r0 + np.arange(rb) < Rq)[:, None], q[r0:r0 + rb], 0.0)  # rows as loaded
    P = rng.integers(-3, 4, (rb, BN)).astype(np.float64)
    for wg in range(W // 4):
        rows = slice(64 * wg, 64 * wg + 64)
        S = np.zeros((64, BN))
        for ks in range(D // 16):
            off = (ks // 4) * BOX + (ks % 4) * 32
            B = sw128(kt, off, np.arange(BN)[None, :], 2 * np.arange(16)[:, None])
            if L["qsmem"]:
                A = sw128(qs, wg * L["NB"] * BOX + off, np.arange(64)[:, None],
                          2 * np.arange(16)[None, :])
            else:
                A = a_from_fragments(qb[rows], None, 16 * ks)
            S += A @ B
        np.testing.assert_array_equal(S, qb[rows] @ k.T)
        O = np.zeros((64, L["DN"]))
        n = np.arange(L["DN"])[None, :]
        for kk in range(BN // 16):
            B = sw128(vt, kk * 16 * 128 + (n // 64) * BOX, np.arange(16)[:, None], 2 * (n % 64))
            O += a_from_fragments(P[rows], None, 16 * kk) @ B
        np.testing.assert_array_equal(O[:, :D], P[rows] @ v)
        assert not O[:, D:].any()
    stored = sorted((row, 8 * (idx // 4) + 2 * (lane % 4) + idx % 2)
                    for row, col, w, lane, idx in acc_layout(L["DN"]) if idx // 4 < D // 8)
    assert stored == sorted((r, d) for r in range(64) for d in range(D))


# -- int8 products --------------------------------------------------------------------------

def int8_rows(codes, D):
    """A tile's int8 rows in a stage: token t at t * (D + 16), its D codes
    as bytes (two's complement)."""
    P = D + 16
    buf = np.zeros(BN * P, np.uint8)
    for t in range(BN):
        buf[t * P:t * P + D] = codes[t].astype(np.int8).view(np.uint8)
    return buf


def words(buf, at, n):
    """n 4-byte words at byte `at` of buf, each as its 4 signed codes."""
    return [buf[at + 4 * i:at + 4 * i + 4].view(np.int8).astype(np.float64) for i in range(n)]


def k_words(buf, D, g, tig, n8):
    """The kernel's K fragment words of token n8 * 8 + g: (D / 4) tig bytes
    in, read 8 bytes at a time at D 96 (24 tig is 8-byte aligned only) and
    16 at a time at D 256 (the staged-Q loop, 4 steps a read)."""
    at = (n8 * 8 + g) * (D + 16) + (D // 4) * tig
    width = 8 if D % 64 else 16
    assert at % width == 0
    out = []
    for v in range(D // 4 // width):
        out += words(buf, at + width * v, width // 4)
    return out


@pytest.mark.parametrize("D", [96, 256])
def test_int8_reads_give_exact_products(D):
    """A warp's 16 rows and one 64-token tile over int8 pools: S = Q K^T
    from Q's permuted A fragments (d = (D / 4) tig + 4 ks + 0, 1 | 2, 3;
    at D 256 staged at uint4 ks * 32 + lane and read back four steps at a
    time) and K's words widened (bytes 0, 1 -> b0, 2, 3 -> b1); O = P V
    from V's word u of rows 2 tig, + 1, + 8, + 9 at (D / 8) g + 4 u (4-byte
    aligned), paired by prmt and widened, into n-tile 4 u + j at d = (D / 8)
    n + nt."""
    rng = np.random.default_rng(D + 3)
    Q = rng.integers(-4, 5, (16, D)).astype(np.float64)
    K = rng.integers(-127, 128, (BN, D))
    V = rng.integers(-127, 128, (BN, D))
    kb, vb = int8_rows(K, D), int8_rows(V, D)
    nks = D // 16

    def qfrag(lane, ks):
        g, tig = lane // 4, lane % 4
        d = (D // 4) * tig + 4 * ks
        return [Q[g, d:d + 2], Q[g + 8, d:d + 2], Q[g, d + 2:d + 4], Q[g + 8, d + 2:d + 4]]

    if D > 128:  # staged: slot ks * 32 + lane; read as (4 v + j) * 32 + lane
        staged = {ks * 32 + lane: qfrag(lane, ks) for ks in range(nks) for lane in range(32)}
        assert sorted(staged) == list(range(nks * 32))
        qget = lambda lane, ks: staged[(4 * (ks // 4) + ks % 4) * 32 + lane]  # noqa: E731
    else:
        qget = qfrag
    S = np.zeros((16, BN))
    for n8 in range(BN // 8):
        kw = {lane: k_words(kb, D, lane // 4, lane % 4, n8) for lane in range(32)}
        for ks in range(nks):
            c = mma([qget(lane, ks) for lane in range(32)],
                    [(kw[lane][ks][0:2], kw[lane][ks][2:4]) for lane in range(32)])
            for lane in range(32):
                g, tig = lane // 4, lane % 4
                for i in range(4):
                    S[g + 8 * (i // 2), n8 * 8 + 2 * tig + i % 2] += c[lane][i]
    np.testing.assert_array_equal(S, Q @ K.T)

    Pm = rng.integers(-3, 4, (16, BN)).astype(np.float64)
    O = np.zeros((16, D))
    for kk in range(BN // 16):
        pa = [[Pm[lane // 4 + 8 * (r % 2), 16 * kk + 2 * (lane % 4) + 8 * (r // 2) + e]
               for e in (0, 1)] for lane in range(32) for r in range(4)]
        pa = [pa[4 * lane:4 * lane + 4] for lane in range(32)]
        for u in range(D // 32):
            w = {}
            for lane in range(32):
                g, tig = lane // 4, lane % 4
                rows_ = [16 * kk + 2 * tig + (r & 1) + 8 * (r >> 1) for r in range(4)]
                at = [t * (D + 16) + (D // 8) * g + 4 * u for t in rows_]
                assert all(a % 4 == 0 for a in at)
                w[lane] = [words(vb, a, 1)[0] for a in at]
            for j in range(4):  # b0w[j] = (rows 0, 1 byte j), b1w[j] = (rows 2, 3 byte j)
                c = mma(pa, [((w[lane][0][j], w[lane][1][j]), (w[lane][2][j], w[lane][3][j]))
                             for lane in range(32)])
                nt = 4 * u + j
                for lane in range(32):
                    g, tig = lane // 4, lane % 4
                    for i in range(4):
                        O[g + 8 * (i // 2), (D // 8) * (2 * tig + i % 2) + nt] += c[lane][i]
    np.testing.assert_array_equal(O, Pm @ V)


# -- spans --------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def main_tree_plan():
    """The main path's tree halfway (prompt 4000, width 50, 32 steps) as
    B6's gather plan at qpk 1 (Gemma-7B and Phi-3-mini both)."""
    tree = cs.grow_tree(cs.PROMPT_LEN, cs.WIDTH, cs.GEN_LEN // 2, 16384,
                        np.random.default_rng(cs.SEED))
    return build_flatten_plan(tree, q_per_kv=1, block_len=256, min_token_bucket=1024,
                              seg_len=None)


@pytest.mark.parametrize("D", sorted(cs.WIDE_HEADS))
def test_spans_fill_the_card_at_the_wide_heads(D, main_tree_plan):
    """At each wide head's shape (qpk 1, Hkv 32 or 16, 4-warp blocks) both
    span rules give one block an SM or nearly: one more span would pass the
    SM count, and every span holds tiles."""
    plan = main_tree_plan
    _, Hq, Hkv = cs.WIDE_HEADS[D]
    rq = plan.l_pad * (Hq // Hkv)
    nb = len(plan.blk_lo)
    assert tpf.q_block_rows(rq) == 64
    tiles = tpf.row_tile_tiles(plan.blk_lo, plan.blk_hi, rq, Hq // Hkv, plan.block_len)
    for spans in (tpf.q_spans(rq, Hkv, nb, plan.block_len, SMS),
                  tpf.balanced_spans(tiles, Hkv, SMS)):
        blocks = len(tiles) * Hkv * spans
        assert blocks <= SMS < blocks + len(tiles) * Hkv
        assert spans <= min(tiles)


@pytest.mark.parametrize("D", [96, 256])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_wrapper_takes_the_flat_q_spans_for_bf16(D, dt, main_tree_plan):
    """launch_flatten's span rule at the wide heads: bf16 q takes q_spans
    (balanced_spans given the row tiles), fp32 q num_spans over the KV
    bytes, as the staged body did."""
    plan = main_tree_plan
    _, Hq, Hkv = cs.WIDE_HEADS[D]
    rq, nb, T = plan.l_pad, len(plan.blk_lo), len(plan.kv_idx)
    kv_bytes = T * Hkv * D * 2 * (2 if dt == torch.bfloat16 else 4)
    tiles = tpf.row_tile_tiles(plan.blk_lo, plan.blk_hi, rq, 1, plan.block_len)
    got = tpf.span_count(dt, rq, Hkv, D, nb, plan.block_len, kv_bytes, SMS)
    got_tiles = tpf.span_count(dt, rq, Hkv, D, nb, plan.block_len, kv_bytes, SMS, tiles)
    if dt == torch.bfloat16:
        assert got == tpf.q_spans(rq, Hkv, nb, plan.block_len, SMS)
        assert got_tiles == tpf.balanced_spans(tiles, Hkv, SMS)
    else:
        assert got == got_tiles == tpf.num_spans(nb, kv_bytes, Hkv * rq * (D + 2) * 4)
