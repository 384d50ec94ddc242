"""The Python side of B6 and B11 on the tensor-core flatten body, on the CPU.

Over bf16 q, B6 (csrc/flatten_gather.cu deft_flatten_gather) and B11 (its
partial entry) run csrc/flat_q_body.cuh's deft_flat_q, B1's and B4's body,
with one pool index a token (deft::IdxRows) as its row source; a CUDA
kernel runs only on the card, so these tests hold what surrounds it to
deft_tpu:

- the grid (row tiles of ``q_block_rows``, spans of the listed blocks'
  64-token tiles by the wrapper's rule, per-warp skips, masks) gives every
  (live folded row, visible token) pair exactly once, pad rows never twice,
  on the short tree halfway (bf16 and int8 plan rules), the batch path's
  four trees halfway (their multi-tree gather plan), every rank window of
  grid 2x1x2 on the short tree and a plan of at most 64 folded rows, on
  cards of 132, 114 and 8 SMs;
- the pool rows the threads copy for a tile (the kernel's ``rows_of``)
  are the tile's ``kv_idx``, and a paged plan written as a gather plan
  reads the rows of its segment table;
- the span rule: ``balanced_spans`` on the batch and short shapes, the
  runner's host count of the row tiles, q_spans kept for paged plans; the
  1-D grid's blocks take every (row tile, head, span) once, a row tile's
  blocks together;
- spans beyond the listed tiles (B11's window) merge as "saw nothing";
- the plain versions of B6 and B11 against deft_tpu's Pallas kernels in
  interpret mode on a small multi-tree gather plan, over bf16/fp32 and
  int8 pools, at head_dim 64, 96 and 256 (fp32 2e-5, bf16 2e-2, live
  rows).
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_b1 import SMS, merge_spans, span_states
from test_torch_b2_b4 import b4_visits, check_state, expected_visits, int8_pools
from test_torch_b9_b5 import DTYPES, rel_err

import chip_smoke as cs
from deft_tpu.models.llama import KVPool as JKVPool
from deft_tpu.models.llama import kv_gather_heads as j_gather
from deft_tpu.ops.flatten_attn import flatten_attn_pallas as j_b6
from deft_tpu.ops.flatten_attn import fold_q
from deft_tpu.ops.sharded_flatten import flatten_attention_partial as j_b11
from deft_tpu_torch.core import ReqToTokenPool, TokenKVPool, TreeCache
from deft_tpu_torch.ops import flatten_attn as tfa
from deft_tpu_torch.ops import paged_flatten_attn as tpf
from deft_tpu_torch.ops import sharded_flatten as tsf
from deft_tpu_torch.parallel import engine
from deft_tpu_torch.parallel.mesh import Grid
from deft_tpu_torch.plan import build_flatten_plan
from deft_tpu_torch.plan.multi import build_multi_flatten_plan

QPK = 4
ARRS = ("kv_idx", "tok_lo", "tok_hi", "blk_lo", "blk_hi")


@pytest.fixture(scope="module")
def short_tree():
    """The CLI's 16-token prompt at width 50, halfway through its 64
    tokens (chip_smoke.py's path shape of B6 and B11)."""
    return cs.grow_tree(16, cs.WIDTH, cs.GEN_LEN // 2, 16384, np.random.default_rng(cs.SEED))


@pytest.fixture(scope="module")
def batch_plan():
    """The batch path's four trees halfway, their multi-tree plan as the
    batch engine builds it for bf16 pools (chip_smoke.py batch_case)."""
    trees = cs.batch_trees(cs.GEN_LEN // 2, np.random.default_rng(cs.SEED + 3))
    return build_multi_flatten_plan(trees, q_per_kv=QPK, block_len=256, min_token_bucket=1024)


def short_window(plan, rank):
    """The plan arrays, rows and live leaves of a rank of grid 2x1x2 (B11's
    path: its dp row window, intervals shifted into it; sp 1)."""
    batch = SimpleNamespace(**{n: torch.from_numpy(getattr(plan, n)) for n in ARRS},
                            blk_host=(plan.blk_lo, plan.blk_hi))
    w = engine.flatten_window(Grid(cs.SHORT_GRID, rank, torch.device("cpu")), batch,
                              plan.l_pad, paged=False)
    arrs = tuple(getattr(w, n).numpy() for n in ARRS)
    return arrs, w.rows, max(0, min(w.rows, plan.n_leaves - w.r0))


def small_gather_plan():
    """At most 64 folded rows: 12 leaves at qpk 4 (l_pad 16), 4-warp blocks."""
    tree = cs.grow_tree(16, 12, 6, 4096, np.random.default_rng(cs.SEED + 7))
    plan = build_flatten_plan(tree, q_per_kv=QPK, block_len=128, min_token_bucket=1024,
                              seg_len=None)
    assert not plan.paged and plan.l_pad * QPK <= 64
    return plan


GRID_CASES = ["short", "short_int8", "batch", "window0", "window1", "window2", "window3", "rows64"]


@pytest.mark.parametrize("case", GRID_CASES)
def test_b6_b11_grid_covers_every_pair_once(case, short_tree, batch_plan):
    """Every (live folded row, visible token) pair once over the row tiles,
    spans and warps of the grid the wrapper takes (B6 with the runner's
    row tiles: balanced_spans; B11's windows: q_spans), pad rows never
    twice, on cards of 132, 114 and 8 SMs."""
    Hkv = 8
    if case.startswith("short"):
        plan = build_flatten_plan(short_tree, q_per_kv=QPK, block_len=256,
                                  min_token_bucket=1024,
                                  **(cs.INT8_RULES["flatten"] if case.endswith("int8") else {}))
        arrs, rows, leaves = tuple(getattr(plan, n) for n in ARRS), plan.l_pad, plan.n_leaves
    elif case == "batch":
        plan = batch_plan
        arrs, rows, leaves = tuple(getattr(plan, n) for n in ARRS), plan.l_pad, plan.n_leaves
    elif case.startswith("window"):
        plan = build_flatten_plan(short_tree, q_per_kv=QPK, block_len=256,
                                  min_token_bucket=1024)
        (arrs, rows, leaves), Hkv = short_window(plan, int(case[-1])), 4
    else:
        plan = small_gather_plan()
        arrs, rows, leaves = tuple(getattr(plan, n) for n in ARRS), plan.l_pad, plan.n_leaves
    assert not plan.paged
    _, tok_lo, tok_hi, blk_lo, blk_hi = arrs
    Rq = rows * QPK
    tiles = tpf.row_tile_tiles(blk_lo, blk_hi, Rq, QPK, plan.block_len)
    want = expected_visits(SimpleNamespace(block_len=plan.block_len, l_pad=rows,
                                           n_leaves=leaves), tok_lo, tok_hi, blk_lo, blk_hi, QPK)
    assert want.sum() > 0
    for sms in (SMS, 114, 8):
        if case.startswith("window"):
            spans = tpf.q_spans(Rq, Hkv, len(blk_lo), plan.block_len, sms)
        else:
            spans = tpf.balanced_spans(tiles, Hkv, sms)
        got = b4_visits(rows, QPK, tok_lo, tok_hi, blk_lo, blk_hi, plan.block_len, spans)
        np.testing.assert_array_equal(got[:leaves * QPK], want)
        assert got.max() <= 1


def idx_row(kv_idx, b, bt, block_len):
    """deft::IdxRows.row: plan token bt of block b is pool row kv_idx[b *
    block_len + bt]."""
    return kv_idx[b * block_len + bt]


def rows_of(kv_idx, listed, tpb, block_len, j, D, itemsize, warps=8):
    """The pool rows the threads of a block copy for its listed tile j
    (flat_q_body.cuh rows_of: block list[j / tpb], tokens (j % tpb) * 64 +
    the chunk's row): per thread its CH chunks' rows (NT, CH), and (int8)
    the rows of the K (threads < 64) and V (64-127) scales."""
    NT = warps * 32
    CPR = D * itemsize // 16
    CH = 64 * CPR // NT
    b, bt0 = listed[j // tpb], (j % tpb) * 64
    tid = np.arange(NT)
    chunk_rows = idx_row(kv_idx, b, bt0 + (tid[:, None] + np.arange(CH)[None] * NT) // CPR,
                         block_len)
    return chunk_rows, idx_row(kv_idx, b, bt0 + np.arange(128) % 64, block_len)


@pytest.mark.parametrize("D,itemsize", [(128, 2), (64, 2), (128, 1), (64, 1)])
def test_b6_row_source_reads_kv_idx(D, itemsize, batch_plan):
    """Over the listed tiles of the batch plan's first row tile, in a
    span's order, the rows the threads copy for tile j are kv_idx of the
    plan tokens the tile holds (chip_smoke.b4_span_tokens, one span): each
    token's row in exactly D * itemsize / 16 chunks, and for int8 pools one
    K and one V scale a token.  The plan's pads read row 0."""
    plan = batch_plan
    Rq, tpb = plan.l_pad * QPK, plan.block_len // 64
    full = plan.blk_lo < -(1 << 20)
    leaf_b = (tpf.q_block_rows(Rq) - 1) // QPK
    listed = np.nonzero((plan.blk_hi > 0) & (full | ((plan.blk_lo < plan.blk_hi)
                                                     & (plan.blk_lo <= leaf_b))))[0]
    named = {n: torch.from_numpy(getattr(plan, n)) for n in ("blk_lo", "blk_hi")}
    tokens = cs.b4_span_tokens(dict(named, block_len=plan.block_len), plan.l_pad, QPK, 1, 0)
    assert len(tokens) == len(listed) * tpb * 64 == 80 * 64
    CPR = D * itemsize // 16
    for j in range(len(listed) * tpb):
        chunk_rows, scale_rows = rows_of(plan.kv_idx, listed, tpb, plan.block_len, j, D,
                                         itemsize)
        want = plan.kv_idx[tokens[64 * j:64 * (j + 1)]]
        np.testing.assert_array_equal(np.sort(chunk_rows.ravel()), np.sort(np.repeat(want, CPR)))
        np.testing.assert_array_equal(scale_rows, np.tile(want, 2))
    pads = plan.tok_lo >= 2 ** 30  # each tree's bucket tail and the plan's tail
    assert pads[-1] and (plan.kv_idx[pads] == 0).all() and (plan.tok_hi[pads] == 0).all()


@pytest.mark.parametrize("dt", list(DTYPES))
def test_paged_plan_as_gather_plan_reads_the_same_rows(dt):
    """A paged plan written as a gather plan (kv_idx = segment_rows(seg_src))
    gives, token for token, the rows SegRows reads, so B6's plain version
    on it equals B1's on the paged plan, output and state alike."""
    tree = cs.grow_tree(700, 6, 10, 8192, np.random.default_rng(cs.SEED + 1))
    plan = build_flatten_plan(tree, q_per_kv=QPK, block_len=128, min_token_bucket=1024,
                              seg_len=(32,), waste_limit=64.0)
    assert plan.paged
    nseg = plan.block_len // plan.seg_len
    kv_idx = tpf.segment_rows(torch.from_numpy(plan.seg_src), plan.seg_len).int()
    b, bt = np.divmod(np.arange(plan.t_pad), plan.block_len)
    seg_rows = plan.seg_src[b * nseg + bt // plan.seg_len] + bt % plan.seg_len  # SegRows.row
    np.testing.assert_array_equal(kv_idx.numpy(), seg_rows)
    Hkv, D = 2, 64
    rng = np.random.default_rng(3)
    S = tree.token_to_kv_pool.size
    tdt = DTYPES[dt][1]
    kp, vp = (torch.from_numpy(rng.standard_normal((1, S, Hkv * D)).astype(np.float32)).to(tdt)
              for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((plan.l_pad, QPK * Hkv, D)).astype(np.float32)
                         ).to(tdt)
    arrs = [torch.from_numpy(getattr(plan, n)) for n in ("tok_lo", "tok_hi", "blk_lo", "blk_hi")]
    seg = torch.from_numpy(plan.seg_src)
    got = tfa.flatten_attention(q, kp, vp, 0, kv_idx, *arrs, D ** -0.5)
    want = tpf.paged_flatten_attention(q, kp, vp, 0, seg, *arrs, D ** -0.5, plan.block_len,
                                       plan.seg_len)
    assert torch.equal(got, want)
    for x, y in zip(tsf.flatten_attention_partial(q, kp, vp, 0, kv_idx, *arrs, D ** -0.5),
                    tpf.paged_flatten_attention_partial(q, kp, vp, 0, seg, *arrs, D ** -0.5,
                                                        plan.block_len, plan.seg_len)):
        assert torch.equal(x, y)


def test_b6_span_rule(short_tree, batch_plan):
    """balanced_spans at the path shapes: the batch plan's row tiles (the
    busiest 136 tiles against the card's share, 520 x 8 / 132) take 4
    spans, where q_spans gives 2 and leaves the busiest block 68 tiles; the
    short plan's near-equal row tiles (20, 16: 9 by the share, under half
    again q_spans' 8) keep one wave, q_spans' 8.  Row tiles of equal work
    give q_spans' count, and never more spans than the busiest row tile's
    tiles."""
    tiles = tpf.row_tile_tiles(batch_plan.blk_lo, batch_plan.blk_hi, batch_plan.l_pad * QPK,
                               QPK, batch_plan.block_len)
    live = (batch_plan.blk_lo < batch_plan.blk_hi) | (batch_plan.blk_lo < -(1 << 20))
    assert (batch_plan.t_pad, len(batch_plan.blk_lo), int(live.sum()), batch_plan.n_tokens,
            batch_plan.n_leaves, batch_plan.l_pad) == (32768, 128, 68, 16600, 200, 256)
    assert tiles == (80, 136, 68, 104, 72, 36, 24, 0)
    assert tpf.q_spans(1024, 8, 128, 256, SMS) == 2
    assert tpf.balanced_spans(tiles, 8, SMS) == 4
    # the same requests admitted shortest prompt first: 132 of 552 tiles
    assert tpf.balanced_spans((36, 68, 52, 104, 132, 88, 72, 0), 8, SMS) == 4
    short = build_flatten_plan(short_tree, q_per_kv=QPK, block_len=256, min_token_bucket=1024)
    st = tpf.row_tile_tiles(short.blk_lo, short.blk_hi, short.l_pad * QPK, QPK, 256)
    assert st == (20, 16)
    assert tpf.balanced_spans(st, 8, SMS) == tpf.q_spans(256, 8, len(short.blk_lo), 256,
                                                         SMS) == 8
    for n_tiles, Hkv, sms in ((2, 8, SMS), (8, 8, SMS), (1, 4, SMS), (2, 2, 114), (4, 8, 8)):
        even = (40,) * n_tiles
        assert tpf.balanced_spans(even, Hkv, sms) == tpf.q_spans(
            n_tiles * 128, Hkv, 10, 256, sms)
    assert tpf.balanced_spans((3, 1), 1, SMS) == 3  # at most the busiest tile count
    assert tpf.balanced_spans((0, 0), 8, SMS) == 1


@pytest.mark.parametrize("tiles", [(80, 136, 68, 104, 72, 36, 24, 0), (20, 16), (7,),
                                   (36, 68, 52, 104, 132, 88, 72, 0)])
def test_b6_grid_takes_a_row_tiles_blocks_together(tiles):
    """The 1-D grid of flat_q_body.cuh: block b takes row tile b / (Hkv *
    spans), then KV head b % (Hkv * spans) / spans and span b % spans, so
    every (row tile, head, span) is one block and a row tile's blocks are
    consecutive in launch order."""
    Hkv = 8
    spans = tpf.balanced_spans(tiles, Hkv, SMS)
    per_tile = Hkv * spans
    b = np.arange(len(tiles) * per_tile)
    rt, h, sp = b // per_tile, b % per_tile // spans, b % spans
    assert len({(int(x), int(y), int(z)) for x, y, z in zip(rt, h, sp)}) == len(b)
    assert (np.diff(rt) >= 0).all() and rt.max() == len(tiles) - 1


def tiny_runner():
    from deft_tpu_torch.config import EngineConfig
    from deft_tpu_torch.models import PRESETS
    from deft_tpu_torch.runtime import ModelRunner

    return ModelRunner(PRESETS["tiny"], EngineConfig(kv_pool_slots=4096), device="cpu")


@pytest.mark.parametrize("paged", [False, True])
def test_runner_hands_b6_its_row_tiles(paged):
    """The runner counts a gather plan's row tiles on the host, from the
    numpy plan before upload, and hands them to B6 on the step's batch; a
    paged plan's batch has none (B1 keeps q_spans)."""
    runner = tiny_runner()
    tree = cs.grow_tree(700 if paged else 16, 8, 4, 4096, np.random.default_rng(2))
    qpk = runner.cfg.q_per_kv
    plan = build_flatten_plan(tree, q_per_kv=qpk, block_len=128, min_token_bucket=1024,
                              **({} if paged else {"seg_len": None}))
    assert plan.paged == paged
    batch = runner._step_batch(plan)
    if paged:
        assert not hasattr(batch, "row_tiles")
    else:
        assert batch.row_tiles == tpf.row_tile_tiles(plan.blk_lo, plan.blk_hi,
                                                     plan.l_pad * qpk, qpk, plan.block_len)
        assert all(isinstance(t, int) for t in batch.row_tiles)


def multi_gather_plan(qpk=QPK):
    """Three small trees in one pool, their multi-tree plan in the gather
    layout: per-tree bucket pads at DUMP_SLOT, the plan's tail pads at row
    0, a row tile's leaves from two trees."""
    rng = np.random.default_rng(11)
    pool, rtp = TokenKVPool(8192), ReqToTokenPool(64, 600)
    trees = []
    for n, width in ((300, 6), (200, 4), (100, 5)):
        t = TreeCache(pool, rtp)
        t.init_prompt(rng.integers(4, 400, n).tolist())
        for i, c in enumerate(t.branch(t.root, width)):
            c.append_token(50 + i)
        trees.append(t)
    for _ in range(6):
        for t in trees:
            t.alloc()
            for leaf in list(t.leaves.values()):
                leaf.append_token(int(rng.integers(1, 400)))
    for t in trees:
        t.alloc()
    plan = build_multi_flatten_plan(trees, q_per_kv=qpk, block_len=128, min_token_bucket=1024,
                                    seg_len=())
    assert not plan.paged and plan.t_pad > plan.n_tokens
    return pool.size, plan


def pools_for(kind, S, Hkv, D, dt, rng):
    """(jax KV pools, torch pools and scales) of q's dtype or int8."""
    jdt, tdt, _ = DTYPES[dt]
    if kind == "int8":
        kd, vd, ks, vs = int8_pools(rng, S, Hkv, D)
        return ([JKVPool(jnp.asarray(kd), jnp.asarray(ks)), JKVPool(jnp.asarray(vd),
                                                                     jnp.asarray(vs))],
                [torch.from_numpy(kd), torch.from_numpy(vd)],
                [torch.from_numpy(ks), torch.from_numpy(vs)])
    kd, vd = (rng.standard_normal((1, S, Hkv * D)).astype(np.float32) for _ in range(2))
    return ([JKVPool(jnp.asarray(kd, jdt)), JKVPool(jnp.asarray(vd, jdt))],
            [torch.from_numpy(kd).to(tdt), torch.from_numpy(vd).to(tdt)], [None, None])


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("kind", ["inherit", "int8"])
@pytest.mark.parametrize("D", [64, 96, 256])
def test_b6_b11_plain_vs_pallas_on_multi_tree_plan(D, kind, dt):
    """Plain B6 against deft_tpu's flatten_attn_pallas, and plain B11 on
    the plan's first half of blocks (an sp window) against deft_tpu's
    flatten_attention_partial over the same KV gathered (int8 dequantised
    to q's dtype, as deft_tpu's engine does), Pallas in interpret mode;
    live rows; at head_dim 64 and at Phi-3-mini's and Gemma's 96 and 256,
    whose heads do not pack."""
    S, plan = multi_gather_plan()
    Hkv = 2
    rng = np.random.default_rng(5 if kind == "int8" else 6)
    (jk, jv), (tk, tv), (tks, tvs) = pools_for(kind, S, Hkv, D, dt, rng)
    jdt, tdt, tol = DTYPES[dt]
    q = rng.standard_normal((plan.l_pad, QPK * Hkv, D)).astype(np.float32)
    jq, tq = jnp.asarray(q, jdt), torch.from_numpy(q).to(tdt)
    scale = D ** -0.5
    live = plan.n_leaves
    jbatch = SimpleNamespace(**{n: jnp.asarray(getattr(plan, n)) for n in ARRS})
    want = np.asarray(j_b6(jq, None, None, jk, jv, 0, jbatch, scale), np.float32)
    targs = [torch.from_numpy(getattr(plan, n)) for n in ARRS]
    got = tfa.flatten_attention(tq, tk, tv, 0, *targs, scale, tks, tvs)
    assert rel_err(got.float().numpy()[:live], want[:live]) < tol
    # B11 over the first half of the blocks
    nb = len(plan.blk_lo) // 2
    T = nb * plan.block_len
    cut = [plan.kv_idx[:T], plan.tok_lo[:T], plan.tok_hi[:T], plan.blk_lo[:nb],
           plan.blk_hi[:nb]]
    kt, vt = (jnp.moveaxis(j_gather(p, 0, jnp.asarray(cut[0]), D, jdt), 1, 0) for p in (jk, jv))
    wacc, wm, wl = (np.asarray(x) for x in j_b11(
        fold_q(jq, Hkv), kt, vt, *(jnp.asarray(a) for a in cut[1:]), scale=scale, qpk=QPK,
        block_len=plan.block_len))
    gacc, gm, gl = (t.numpy() for t in tsf.flatten_attention_partial(
        tq, tk, tv, 0, *(torch.from_numpy(a) for a in cut), scale, tks, tvs))
    rows = slice(0, live * QPK)
    check_state((gacc[:, rows], gm[:, rows], gl[:, rows]),
                (wacc[:, rows], wm[..., 0][:, rows], wl[..., 0][:, rows]), tol)


def test_b11_empty_spans_merge_as_nothing_seen(short_tree):
    """B11's path window (rank 0 of grid 2x1x2 on the short tree: one row
    tile of 20 listed tiles, 4 KV heads) takes q_spans' 28 spans, so 8 spans
    hold no tile; each span's state as the kernel's blocks leave it (an
    empty span: m = -1e30, l = 0, acc = 0), merged by the merge kernel's
    rule, equals deft_tpu's flatten_attention_partial on the window."""
    plan = build_flatten_plan(short_tree, q_per_kv=QPK, block_len=256, min_token_bucket=1024)
    (kv_idx, tok_lo, tok_hi, blk_lo, blk_hi), rows, leaves = short_window(plan, 0)
    Hkv, D = 4, 64
    Rq = rows * QPK
    tiles = tpf.row_tile_tiles(blk_lo, blk_hi, Rq, QPK, plan.block_len)
    spans = tpf.q_spans(Rq, Hkv, len(blk_lo), plan.block_len, SMS)
    assert tiles == (20,) and spans == 28
    S = short_tree.token_to_kv_pool.size
    rng = np.random.default_rng(9)
    kp, vp = (rng.standard_normal((1, S, Hkv * D)).astype(np.float32) for _ in range(2))
    q = rng.standard_normal((rows, QPK * Hkv, D)).astype(np.float32)
    scale = D ** -0.5
    lo, hi = (t.numpy() for t in tpf.leaf_intervals(
        *(torch.from_numpy(a) for a in (tok_lo, tok_hi, blk_lo, blk_hi)), plan.block_len, rows))
    qf = tpf.fold_rows(torch.from_numpy(q), Hkv).numpy().astype(np.float64)
    state = [np.zeros((Hkv, Rq, D)), np.zeros((Hkv, Rq)), np.zeros((Hkv, Rq))]
    for h in range(Hkv):
        k = kp[0][kv_idx].reshape(-1, Hkv, D)[:, h].astype(np.float64)
        v = vp[0][kv_idx].reshape(-1, Hkv, D)[:, h].astype(np.float64)
        acc, m, l = span_states(qf[h], k, v, lo, hi, blk_lo, blk_hi, QPK, plan.block_len,
                                spans, scale)
        no_tile = np.array([20 * s // spans == 20 * (s + 1) // spans for s in range(spans)])
        assert no_tile.sum() == spans - 20
        assert (m[no_tile] == -1e30).all() and (l[no_tile] == 0).all()
        assert (acc[no_tile] == 0).all()
        for x, y in zip(state, merge_spans(acc, m, l)[1]):
            x[h] = y
    kt, vt = (jnp.moveaxis(jnp.asarray(p[0][kv_idx].reshape(-1, Hkv, D)), 1, 0)
              for p in (kp, vp))
    wacc, wm, wl = (np.asarray(x) for x in j_b11(
        fold_q(jnp.asarray(q), Hkv), kt, vt, *(jnp.asarray(a) for a in (tok_lo, tok_hi, blk_lo,
                                                                        blk_hi)),
        scale=scale, qpk=QPK, block_len=plan.block_len))
    live = slice(0, leaves * QPK)
    check_state([x[:, live] for x in state],
                (wacc[:, live], wm[..., 0][:, live], wl[..., 0][:, live]), 2e-5)
