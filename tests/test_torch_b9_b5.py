"""The Python side of B9's and B5's tensor-core bodies, on the CPU.

- B9 (csrc/int8_matmul.cu): the split of H over a cluster's blocks covers
  every 64-row chunk exactly once, at every 8B and Mixtral weight shape and
  R in {8, 64, 256}; the kernel's index arithmetic (the swizzled 16-bit
  loads, the byte pairing and widening into wgmma A fragments, the column
  order and its inverse in the epilogue, the split sums), emulated in numpy,
  gives x @ w exactly; its plain version against deft_tpu's Pallas kernel in
  interpret mode (fp32, 2e-5).
- B5 (csrc/paged_seq.cu, deft_seq_q): the path split over blocks and warps
  covers every tile once; the permuted head dimension of the score product
  and the token-paired V fragments of the P V product, emulated, give
  Q K^T and P V; B5's and B5p's plain versions against deft_tpu's
  paged_seq_attention_q / _q_partial on plans with dead blocks, a leaf of
  one token, segments straddling 16-token tiles and path lengths off the
  tile (fp32 2e-5, bf16 2e-2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deft_tpu.ops import int8_matmul as j_i8
from deft_tpu.ops.paged_seq_attn import paged_seq_attention_q as j_b5
from deft_tpu.ops.paged_seq_attn import paged_seq_attention_q_partial as j_b5p
from deft_tpu_torch.ops import int8_matmul as t_i8
from deft_tpu_torch.ops import paged_seq_attn as tps

# (H, I) of Llama-3.1-8B's and Mixtral-8x7B's matmuls as B9 sees them at decode
SHAPES = {"8b wqkv": (4096, 6144), "8b wo": (4096, 4096), "8b wgu": (4096, 28672),
          "8b wdown": (14336, 4096), "8b lm_head": (4096, 128256),
          "mixtral lm_head": (4096, 32000), "ragged": (1408, 4096)}
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-9)


# -- B9 ------------------------------------------------------------------------------

@pytest.mark.parametrize("R", [8, 64, 256])
@pytest.mark.parametrize("name", list(SHAPES))
def test_b9_split_covers_every_chunk_once(name, R):
    H, I = SHAPES[name]
    chunks = H // 64
    tiles = -(-I // t_i8.column_tile(R))
    for resident in (None, lambda s: 132 // s, lambda s: 0):
        splits, per = t_i8.split_plan(R, H, I, 132, resident)
        ranges = t_i8.split_ranges(H, splits, per)
        seen = np.zeros(chunks, int)
        for c0, c1 in ranges:
            assert c0 < c1  # no split without work
            seen[c0:c1] += 1
        assert (seen == 1).all()
        assert 1 <= splits <= 8
        assert splits == 1 or tiles * splits <= 132
        if resident is not None and splits > 1:
            assert resident(splits) >= tiles
    if I == 4096 and R <= 128:  # 16 column tiles of 256: a cluster of 8
        assert t_i8.split_plan(R, H, I, 132)[0] == 8
    if I >= 28672:  # enough column tiles: no split
        assert t_i8.split_plan(R, H, I, 132)[0] == 1


def test_b9_split_of_a_ragged_h():
    """H = 1408: 22 chunks over 8 splits of 3, the last one short."""
    splits, per = t_i8.split_plan(64, 1408, 4096, 132)
    assert (splits, per) == (8, 3)
    assert t_i8.split_ranges(1408, splits, per)[-2:] == [(18, 21), (21, 22)]


def byte_perm(x, y, s):
    b = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(b[(s >> (4 * i)) & 7] << (8 * i) for i in range(4))


def bf16_pair(bits):
    """The two bf16 halves of a 32-bit word as floats (low half first)."""
    return [float(np.array([(bits >> (16 * i)) & 0xFFFF], np.uint32).__lshift__(16)
                  .view(np.float32)[0]) for i in range(2)]


def widen4(w):
    """hopper::widen4: four int8 codes to two bf16x2 words, as float pairs."""
    m, sg = w & 0x7F7F7F7F, w & 0x80808080
    out = []
    for sel in (0x4140, 0x4342):
        v, t = bf16_pair(byte_perm(m, 0x43, sel)), bf16_pair(byte_perm(sg, 0x43, sel))
        out.append([v[0] - t[0], v[1] - t[1]])
    return out


def pair_lo(x, y):
    return byte_perm(x, y, 0x5140)


def pair_hi(x, y):
    return byte_perm(x, y, 0x7362)


def test_widen4_is_exact_for_every_code():
    codes = np.arange(-128, 128).astype(np.int8).view(np.uint8).astype(np.int64)
    for i in range(0, 256, 4):
        w = int(codes[i] | codes[i + 1] << 8 | codes[i + 2] << 16 | codes[i + 3] << 24)
        lo, hi = widen4(w)
        assert lo + hi == [float(c) for c in range(i - 128, i - 124)]


def emulate_b9(x, w, R, splits, per):
    """out (R, I) of csrc/int8_matmul.cu's bf16 body on integer x, built
    from its loads as the kernel addresses them."""
    H, I = w.shape
    N, BI = t_i8.padded_rows(R), t_i8.column_tile(R)
    MT = BI // 128
    xp = np.zeros((N, H))
    xp[:R] = x
    wb = w.view(np.uint8).astype(np.int64)
    out = np.zeros((R, I))
    for col0 in range(0, I, BI):
        sums = np.zeros((splits, 2, MT, 64, N))  # per split: (cw, t, row, n)
        for sp, (c0, c1) in enumerate(t_i8.split_ranges(H, splits, per)):
            for c in range(c0, c1):
                # the stage's boxes as TMA's 128-byte swizzle lays them out
                boxes = []
                for b in range(BI // 128):
                    tile = np.zeros((64, 128), np.int64)
                    cols = wb[c * 64:(c + 1) * 64, col0 + 128 * b:col0 + 128 * (b + 1)]
                    tile[:, :cols.shape[1]] = cols
                    sw = np.zeros(64 * 128, np.int64)
                    for k in range(64):
                        for u in range(8):
                            sw[k * 128 + (u ^ (k % 8)) * 16:][:16] = tile[k, u * 16:u * 16 + 16]
                    boxes.append(sw)
                for cw in range(2):
                    for t in range(MT):
                        A = np.zeros((64, 64))
                        for wq in range(4):
                            for lane in range(32):
                                g, tig = lane // 4, lane % 4
                                col = (cw * MT + t) * 64 + wq * 16 + 2 * g
                                box, cin = boxes[col // 128], col % 128
                                u, bb = cin >> 4, cin & 15
                                o0 = ((u ^ (2 * tig)) << 4) + bb
                                o1 = ((u ^ (2 * tig + 1)) << 4) + bb
                                for ks in range(4):
                                    k0 = ks * 16 + 2 * tig

                                    def ld16(k, o):
                                        return int(box[k * 128 + o] | box[k * 128 + o + 1] << 8)

                                    a0, a1 = widen4(pair_lo(ld16(k0, o0), ld16(k0 + 1, o1)))
                                    a2, a3 = widen4(pair_lo(ld16(k0 + 8, o0), ld16(k0 + 9, o1)))
                                    r, kk = wq * 16 + g, ks * 16 + 2 * tig
                                    A[r, kk:kk + 2] = a0
                                    A[r + 8, kk:kk + 2] = a1
                                    A[r, kk + 8:kk + 10] = a2
                                    A[r + 8, kk + 8:kk + 10] = a3
                        sums[sp, cw, t] += A @ xp[:, c * 64:(c + 1) * 64].T
        total = sums.sum(0)
        for cw in range(2):
            for t in range(MT):
                for m in range(64):  # row wq * 16 + g + 8 h -> column wq * 16 + 2 g + h
                    wq, g, h = m // 16, m % 8, (m % 16) // 8
                    col = col0 + (cw * MT + t) * 64 + wq * 16 + 2 * g + h
                    if col < I:
                        out[:, col] = total[cw, t, m, :R]
    return out


@pytest.mark.parametrize("R,H,I", [(8, 128, 256), (72, 192, 384), (136, 128, 384)])
def test_b9_index_arithmetic_gives_x_at_w(R, H, I):
    rng = np.random.default_rng(R + H)
    x = rng.integers(-3, 4, (R, H)).astype(np.float64)
    w = rng.integers(-128, 128, (H, I)).astype(np.int8)
    for splits in sorted({1, min(3, H // 64)}):
        per = -(-(H // 64) // splits)
        got = emulate_b9(x, w, R, -(-(H // 64) // per), per)
        np.testing.assert_array_equal(got, x @ w.astype(np.float64))


@pytest.mark.parametrize("R", [8, 64, 256])
def test_b9_plain_vs_pallas_ragged_split_shape(R):
    """The plain version against deft_tpu's kernel at H = 1408 (a ragged
    last split on the card), fp32."""
    H, I = 1408, 384
    rng = np.random.default_rng(R)
    x = rng.standard_normal((R, H)).astype(np.float32)
    w = rng.integers(-127, 128, (H, I)).astype(np.int8)
    s = rng.uniform(0.01, 0.1, (I,)).astype(np.float32)
    want = j_i8.int8_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s))
    got = t_i8.int8_matmul(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(s))
    assert rel_err(got.numpy(), np.asarray(want)) < 2e-5


# -- B5 ------------------------------------------------------------------------------

def split_tiles(total, splits, warps=4):
    """The 16-token tiles [t0, t1) each (block, warp) of B5's tensor-core
    body takes of a path of ``total`` live tokens, as the kernel derives
    them on the device: block b of ``splits`` a contiguous share, each of
    its warps a share of that."""
    tiles = -(-total // 16)
    out = []
    for b in range(splits):
        b0, b1 = tiles * b // splits, tiles * (b + 1) // splits
        out.append([(b0 + (b1 - b0) * w // warps, b0 + (b1 - b0) * (w + 1) // warps)
                    for w in range(warps)])
    return out


@pytest.mark.parametrize("total", [0, 1, 15, 17, 250, 4050])
@pytest.mark.parametrize("splits", [1, 2, 8])
def test_b5_path_split_covers_every_tile_once(splits, total):
    spans = split_tiles(total, splits)
    seen = np.zeros(-(-total // 16), int)
    for block in spans:
        assert len(block) == 4
        for t0, t1 in block:
            seen[t0:t1] += 1
    assert (seen == 1).all()
    # each block's warps take consecutive spans of its share
    for block in spans:
        assert all(block[w][1] == block[w + 1][0] for w in range(3))


def test_b5_splits_fill_the_card():
    assert tps.seq_splits(64, 8, 132) == 1  # the 8B main tree
    assert tps.seq_splits(64, 4, 132) == 2  # rank 0 of grid 1x2x2
    assert tps.seq_splits(8, 2, 132) == 8
    assert all(1 <= tps.seq_splits(r, h, 132) <= 8 for r in (1, 64, 256) for h in (1, 8))


@pytest.mark.parametrize("D", [64, 128])
def test_b5_index_arithmetic_gives_scores_and_pv(D):
    """One 16-token tile: S = Q K^T through the permuted head dimension and
    O = P V through the token-paired V fragments, emulated from the int8
    rows as csrc/paged_seq.cu's deft_seq_q loads them."""
    rng = np.random.default_rng(D)
    q = rng.integers(-4, 5, (8, D)).astype(np.float64)  # rows g < qpk
    k = rng.integers(-128, 128, (16, D)).astype(np.int8)
    v = rng.integers(-128, 128, (16, D)).astype(np.int8)
    kb, vb = k.view(np.uint8).astype(np.int64), v.view(np.uint8).astype(np.int64)

    def word(rows, t, d):
        return int(rows[t, d] | rows[t, d + 1] << 8 | rows[t, d + 2] << 16 | rows[t, d + 3] << 24)

    S = np.zeros((16, 16))  # rows: q rows (8 .. 15 zero), columns: tokens
    for nt8 in range(2):
        for ks in range(D // 16):
            A, B = np.zeros((16, 16)), np.zeros((16, 8))
            for lane in range(32):
                g, tig = lane // 4, lane % 4
                d = (D // 4) * tig + 4 * ks
                b0, b1 = widen4(word(kb, nt8 * 8 + g, d))
                B[2 * tig:2 * tig + 2, g] = b0
                B[2 * tig + 8:2 * tig + 10, g] = b1
                A[g, 2 * tig:2 * tig + 2] = q[g, d:d + 2]
                A[g, 2 * tig + 8:2 * tig + 10] = q[g, d + 2:d + 4]
            S[:, nt8 * 8:nt8 * 8 + 8] += A @ B
    np.testing.assert_array_equal(S[:8], q @ k.astype(np.float64).T)

    P = rng.integers(-3, 4, (8, 16)).astype(np.float64)
    A = np.zeros((16, 16))
    for lane in range(32):  # the S accumulators' layout reused as the A fragment
        g, tig = lane // 4, lane % 4
        A[g, 2 * tig:2 * tig + 2] = P[g, 2 * tig:2 * tig + 2]
        A[g, 2 * tig + 8:2 * tig + 10] = P[g, 8 + 2 * tig:8 + 2 * tig + 2]
    O = np.zeros((8, D))
    for nt in range(D // 8):
        B = np.zeros((16, 8))
        for lane in range(32):
            g, tig = lane // 4, lane % 4
            u, j = nt // 4, nt % 4
            d = (D // 8) * g + 4 * u
            for r0, kk in ((2 * tig, 2 * tig), (2 * tig + 8, 2 * tig + 8)):
                x, y = word(vb, r0, d), word(vb, r0 + 1, d)
                pairs = widen4(pair_lo(x, y)) + widen4(pair_hi(x, y))
                B[kk:kk + 2, g] = pairs[j]
        C = A @ B  # rows q, columns n: d = (D / 8) n + nt
        for n in range(8):
            O[:, (D // 8) * n + nt] = C[:8, n]
    np.testing.assert_array_equal(O, P @ v.astype(np.float64))


def synthetic_seq_plan(rng, R, nb, spb, seg_len, S, one_token_leaf=0):
    """Per-leaf segment tables: random live spans (some segments empty,
    lengths off the 16-token tile, spans straddling tiles), one dead block
    a leaf where nb > 1, and leaf ``one_token_leaf`` holding one token."""
    nseg = nb * spb
    src = rng.integers(0, S // seg_len, (R, nseg)) * seg_len
    off = rng.integers(0, seg_len, (R, nseg))
    live = rng.integers(0, seg_len + 1, (R, nseg))
    live = np.minimum(live, seg_len - off)
    live[rng.random((R, nseg)) < 0.2] = 0
    blk = np.ones((R, nb), np.int32)
    if nb > 1:
        blk[np.arange(R), rng.integers(0, nb, R)] = 0
    live[one_token_leaf] = 0
    blk[one_token_leaf] = 1
    live[one_token_leaf, spb - 1] = 1
    off[one_token_leaf, spb - 1] = min(off[one_token_leaf, spb - 1], seg_len - 1)
    for r in range(R):  # every other leaf sees at least one token
        if r != one_token_leaf and not (live[r] * np.repeat(blk[r], spb)).any():
            j = int(np.nonzero(np.repeat(blk[r], spb))[0][0])
            off[r, j], live[r, j] = 0, 17
    return [a.astype(np.int32).reshape(-1) for a in (src, off, live, blk)]


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("qpk,D", [(4, 64), (1, 128), (8, 64)])
def test_b5_plain_vs_pallas_on_edge_plans(qpk, D, dt):
    Hkv, R, nb, spb, seg_len = 2, 6, 3, 2, 128
    Hq = qpk * Hkv
    S = 4096
    rng = np.random.default_rng(qpk * D)
    tables = synthetic_seq_plan(rng, R, nb, spb, seg_len, S, one_token_leaf=2)
    live = tables[2].reshape(R, -1) * np.repeat(tables[3].reshape(R, nb), spb, axis=1)
    assert live.sum(1)[2] == 1 and (live.sum(1) % 16 != 0).any()
    kd = rng.integers(-127, 128, (1, S, Hkv * D)).astype(np.int8)
    vd = rng.integers(-127, 128, (1, S, Hkv * D)).astype(np.int8)
    ks = rng.uniform(0.01, 0.1, (1, Hkv, S)).astype(np.float32)
    vs = rng.uniform(0.01, 0.1, (1, Hkv, S)).astype(np.float32)
    q = rng.standard_normal((R, Hq, D)).astype(np.float32)
    jdt, tdt, tol = DTYPES[dt]
    scale = D ** -0.5
    jargs = [jnp.asarray(q, jdt).reshape(R, Hkv, qpk, D)] + [
        jnp.asarray(a) for a in (kd, vd, ks, vs)] + [jnp.asarray(0, jnp.int32)] + [
        jnp.asarray(t) for t in tables]
    targs = [torch.from_numpy(q).to(tdt)] + [torch.from_numpy(a) for a in (kd, vd, ks, vs)] \
        + [0] + [torch.from_numpy(t) for t in tables]
    kw = dict(scale=scale, block_len=spb * seg_len, seg_len=seg_len)
    want = np.asarray(j_b5(*jargs, **kw), np.float32).reshape(R, Hq, D)
    got = tps.paged_seq_attention_q(*targs, scale, seg_len)
    assert rel_err(got.float().numpy(), want) < tol
    acc, m, l = (np.asarray(x).reshape(R, Hq, D) for x in j_b5p(*jargs, **kw))
    gacc, gm, gl = (t.numpy() for t in tps.paged_seq_attention_q_partial(*targs, scale,
                                                                         seg_len))
    assert rel_err(gacc, acc) < tol
    assert rel_err(gl, l[..., 0]) < tol
    assert rel_err(gm, m[..., 0]) < tol
