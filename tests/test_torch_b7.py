"""The Python side of B7 on the tensor-core seq body, and of B11's span
count counted on the host, on the CPU.

Over bf16 q, B7 (csrc/seq_gather.cu deft_seq_gather) runs
csrc/seq_q_body.cuh's deft_seq_q, B2's and B5's body, with the path table
(deft_seq::IdxPath) as its path source; a CUDA kernel runs only on the card,
so these tests hold what surrounds it to deft_tpu:

- the path split over a cluster's blocks, their warps and 16-token tiles,
  each tile's pool rows found one tile before its copy is issued, emulated
  in numpy: every live path entry paths[r, :seq_lens[r]] is read exactly
  once per (leaf, head), no pad entry is read, a seq_len 0 leaf reads
  nothing, and the row and int8 scale offsets address the token's pool row
  in layer li and head h;
- ``seq_splits`` at B7's shapes fills the card;
- the plain version of B7 against deft_tpu's ``seq_attn_pallas`` in
  interpret mode on a fragmented tree (a deep tree of tiny nodes) whose seq
  plan comes out not paged, over bf16/fp32 and int8 pools, qpk 1/4/8, D
  64/128 (fp32 2e-5, bf16 2e-2, live rows);
- B11: the rank windows' row tiles counted on the host from the numpy plan
  (parallel/engine.py ``host_window``) equal those recounted from the
  window's arrays as the engine cuts them, and its block count equals
  ``last_live`` of the batch tensors' mask; the span rule they give at the
  short tree's window; the engine hands B11 those row tiles and reads
  nothing back from the device.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_b9_b5 import DTYPES, rel_err

import chip_smoke as cs
from deft_tpu.models.llama import KVPool as JKVPool
from deft_tpu.ops.seq_attn import seq_attn_pallas as j_b7
from deft_tpu_torch.core import ReqToTokenPool, TokenKVPool, TreeCache
from deft_tpu_torch.core.kv_pool import DUMP_SLOT
from deft_tpu_torch.ops import paged_flatten_attn as tpf
from deft_tpu_torch.ops import paged_seq_attn as tps
from deft_tpu_torch.ops import seq_attn as tsa
from deft_tpu_torch.parallel import engine
from deft_tpu_torch.parallel.mesh import Grid
from deft_tpu_torch.parallel.sharding import row_window
from deft_tpu_torch.plan import build_flatten_plan, build_seq_plan
from deft_tpu_torch.plan.multi import build_multi_flatten_plan

TILE, STAGES, WARPS = 16, 3, 2  # csrc/seq_q_body.cuh over a path table (IdxPath)
QPK = 4
ARRS = ("kv_idx", "tok_lo", "tok_hi", "blk_lo", "blk_hi")


def fragmented_tree(rng, prompt=16, width=3, rounds=3, cap=24):
    """A deep tree of tiny nodes (ToT-like replay paths): every few steps
    each leaf branches in two, leaves take 0-2 tokens a step, one leaf is
    pruned; its seq plan pads paths past the 2.5x limit, so the runner's
    plan comes out in the gather layout."""
    tree = TreeCache(TokenKVPool(8192), ReqToTokenPool(64, 512))
    tree.init_prompt(rng.integers(4, 400, prompt).tolist())
    for i, c in enumerate(tree.branch(tree.root, width)):
        c.append_token(50 + i)
    for _ in range(rounds):
        for _ in range(3):
            tree.alloc()
            for leaf in list(tree.leaves.values()):
                for _ in range(int(rng.integers(0, 3))):
                    leaf.append_token(int(rng.integers(1, 400)))
        tree.alloc()
        if len(tree.leaves) * 2 <= cap:
            for leaf in list(tree.leaves.values()):
                for c in tree.branch(leaf, 2):
                    c.append_token(int(rng.integers(1, 400)))
    tree.cut(sorted(tree.leaves.values(), key=lambda x: x.id)[0])
    tree.alloc()
    return tree


@pytest.fixture(scope="module")
def frag_plan():
    plan = build_seq_plan(fragmented_tree(np.random.default_rng(3)), q_per_kv=QPK,
                          block_len=128, min_token_bucket=128, want_paged=True)
    assert not plan.paged and plan.n_leaves < plan.l_pad
    return plan


# -- B7: the path split and the tile rows ------------------------------------------

def idx_path_reads(paths, seq_lens, splits):
    """Per leaf, the path entries (column c of paths[r]) deft_seq_q's
    blocks, warps and lanes read, in issue order: block `split` takes its
    share of the path's 16-token tiles, each warp a share of its block's;
    a warp reads the pool rows of its first stages' tiles together, then
    holds the row of its next tile in a register (tile_ref), read one tile
    before the tile's copy is issued; lane l < 16 of tile t reads entry 16 t
    + l where that is below min(seq_lens[r], C)."""
    C = paths.shape[1]
    out = []
    for r in range(paths.shape[0]):
        total = min(int(seq_lens[r]), C)
        tiles = -(-total // TILE)
        cols = []
        for split in range(splits):
            b0, b1 = tiles * split // splits, tiles * (split + 1) // splits
            for warp in range(WARPS):
                w0 = b0 + (b1 - b0) * warp // WARPS
                w1 = b0 + (b1 - b0) * (warp + 1) // WARPS
                n = w1 - w0

                def tile_ref(t):
                    return [t * TILE + lane if t * TILE + lane < total else -1
                            for lane in range(TILE)]

                issued = []
                refs = [tile_ref(w0 + p) for p in range(STAGES - 1)]
                for p in range(STAGES - 1):
                    if p < n:
                        issued.append(refs[p])
                ref = tile_ref(w0 + STAGES - 1)
                for it in range(n):
                    nx = it + STAGES - 1
                    if nx < n:
                        issued.append(ref)
                        ref = tile_ref(w0 + nx + 1)
                # every tile of the warp's span once, in order
                assert issued == [tile_ref(t) for t in range(w0, w1)]
                cols += [c for tile in issued for c in tile if c >= 0]
        out.append(cols)
    return out


@pytest.mark.parametrize("splits", [1, 3, 8])
def test_b7_tiles_read_every_live_entry_once(frag_plan, splits):
    """The fragmented tree's gather plan (padded leaves with seq_len 0, pads
    at DUMP_SLOT) and a synthetic one with a one-token leaf, a leaf as long
    as the padded width and lengths off the tile."""
    rng = np.random.default_rng(splits)
    paths, lens = cs.synthetic_gather_paths(rng, [37, 1, 0, 64, 16, 45, 0], 64, 4096)
    for paths, lens in ((paths, lens), (frag_plan.paths, frag_plan.seq_lens)):
        got = idx_path_reads(paths, lens, splits)
        for r, cols in enumerate(got):
            assert cols == list(range(int(lens[r])))  # once each, in path order
            assert (paths[r, lens[r]:] == DUMP_SLOT).all()  # what is never read: the pads
        assert any(lens == 0) and not any(got[r] for r in np.flatnonzero(lens == 0))


def test_b7_tile_offsets_address_the_pool_row():
    """issue_tile's row offset layer_off + (row Hkv + h) D into the (L, S,
    Hkv*D) pools and scale offset scale_off + h S + row into the head-major
    (L, Hkv, S) scales reach the token's own row and scale at layer li, head
    h: the scales are indexed by the pool row, not the path position."""
    rng = np.random.default_rng(0)
    L, S, Hkv, D, li = 2, 256, 4, 64, 1
    pool = rng.integers(-127, 128, (L, S, Hkv * D)).astype(np.int8)
    scale = rng.uniform(0.01, 0.1, (L, Hkv, S)).astype(np.float32)
    paths, lens = cs.synthetic_gather_paths(rng, [37, 5], 48, S)
    flat_p, flat_s = pool.reshape(-1), scale.reshape(-1)
    for r, cols in enumerate(idx_path_reads(paths, lens, 3)):
        for c in cols:
            row = int(paths[r, c])
            for h in range(Hkv):
                roff = li * S * Hkv * D + (row * Hkv + h) * D
                soff = li * Hkv * S + h * S + row
                np.testing.assert_array_equal(flat_p[roff:roff + D],
                                              pool[li, row, h * D:(h + 1) * D])
                assert flat_s[soff] == scale[li, h, row]


@pytest.mark.parametrize("sms", [132, 114, 8])
def test_b7_splits_fill_the_card(sms):
    """B7 takes B2's and B5's rule: the short tree's 64 x 8 pairs fill an
    H100 alone; a 3-leaf plan splits its paths over the cluster."""
    for int8 in (False, True):
        per_sm = 3 if int8 else 2
        for R, Hkv in ((64, 8), (3, 8), (3, 2)):
            sp = tps.seq_splits(R, Hkv, sms, int8)
            assert 1 <= sp <= 8
            assert sp == 8 or R * Hkv * sp >= per_sm * sms  # every resident slot busy
            assert sp == 1 or R * Hkv * (sp - 1) < per_sm * sms  # no more than that
    assert tps.seq_splits(64, 8, 132, False) == tps.seq_splits(64, 8, 132, True) == 1


# -- B7: the plain version against deft_tpu ---------------------------------------------

def pools(rng, S, Hkv, D, kv, dt):
    """(jax KVPool, torch (data, scale)) pairs for K and V: random rows of
    q's dtype, or int8 codes and scales as deft_tpu tests/test_kernels.py:
    348-352 makes them."""
    jdt, tdt, _ = DTYPES[dt]
    out = []
    for _ in range(2):
        if kv == "int8":
            d = rng.integers(-127, 128, (1, S, Hkv * D)).astype(np.int8)
            s = rng.uniform(0.01, 0.1, (1, Hkv, S)).astype(np.float32)
            out.append((JKVPool(jnp.asarray(d), jnp.asarray(s)),
                        (torch.from_numpy(d), torch.from_numpy(s))))
        else:
            d = rng.standard_normal((1, S, Hkv * D)).astype(np.float32)
            out.append((JKVPool(jnp.asarray(d, jdt)), (torch.from_numpy(d).to(tdt), None)))
    return out


@pytest.mark.parametrize("qpk,D", [(1, 128), (4, 64), (8, 64)])
@pytest.mark.parametrize("kv", ["inherit", "int8"])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_b7_plain_matches_deft_tpu(frag_plan, dt, kv, qpk, D):
    rng = np.random.default_rng(qpk * D)
    Hkv = 2
    plan = frag_plan
    (jk, (tk, tks)), (jv, (tv, tvs)) = pools(rng, 8192, Hkv, D, kv, dt)
    q = rng.standard_normal((plan.l_pad, qpk * Hkv, D)).astype(np.float32)
    scale = D ** -0.5
    batch = SimpleNamespace(paths=jnp.asarray(plan.paths), seq_lens=jnp.asarray(plan.seq_lens))
    want = j_b7(jnp.asarray(q, DTYPES[dt][0]), None, None, jk, jv, 0, batch, scale)
    got = tsa.seq_attention(torch.from_numpy(q).to(DTYPES[dt][1]), tk, tv, 0,
                            torch.from_numpy(plan.paths), torch.from_numpy(plan.seq_lens),
                            scale, tks, tvs)
    live = slice(0, plan.n_leaves)
    assert rel_err(got.float().numpy()[live], np.asarray(want, np.float32)[live]) \
        < DTYPES[dt][2]


# -- B11: the window's row tiles counted on the host ---------------------------------------

@pytest.fixture(scope="module")
def gather_plans():
    """The short tree halfway (chip_smoke.py's B11 shape) and the batch
    path's four trees halfway (their multi-tree gather plan)."""
    short = cs.grow_tree(16, cs.WIDTH, cs.GEN_LEN // 2, 16384, np.random.default_rng(cs.SEED))
    trees = cs.batch_trees(cs.GEN_LEN // 2, np.random.default_rng(cs.SEED + 3))
    plans = [build_flatten_plan(short, q_per_kv=QPK, block_len=256, min_token_bucket=1024),
             build_multi_flatten_plan(trees, q_per_kv=QPK, block_len=256,
                                      min_token_bucket=1024)]
    assert not any(p.paged for p in plans)
    return plans


@pytest.mark.parametrize("shape", [(2, 1, 2), (1, 2, 1), (2, 2, 1)])
def test_b11_host_row_tiles_equal_the_window(gather_plans, shape):
    """Every rank window of the grid: host_window's block count equals
    last_live of the batch tensors' mask, and its row tiles equal
    row_tile_tiles recounted from the arrays flatten_window cuts."""
    for plan in gather_plans:
        batch = SimpleNamespace(**{n: torch.from_numpy(getattr(plan, n)) for n in ARRS},
                                blk_host=(plan.blk_lo, plan.blk_hi))
        mask = (batch.blk_lo < batch.blk_hi) | (batch.blk_lo < -(1 << 20))
        for rank in range(int(np.prod(shape))):
            grid = Grid(shape, rank, torch.device("cpu"))
            h = engine.host_window(grid, plan.blk_lo, plan.blk_hi, plan.l_pad,
                                   plan.block_len, QPK)
            assert h.B == engine.last_live(mask)
            w = engine.flatten_window(grid, batch, plan.l_pad, paged=False)
            assert w.row_tiles is None  # no qpk: nothing counted
            recount = tpf.row_tile_tiles(w.blk_lo.numpy(), w.blk_hi.numpy(), w.rows * QPK,
                                         QPK, plan.block_len)
            assert h.row_tiles == recount
            w = engine.flatten_window(grid, batch, plan.l_pad, paged=False, qpk=QPK)
            assert w.row_tiles == recount


def test_b11_rule_at_the_short_window(gather_plans):
    """rank 0 of grid 2x1x2 on the short tree (4 KV heads a rank): one row
    tile of 20 listed tiles; balanced_spans takes fewer spans than
    q_spans' 28, none of them empty."""
    plan = gather_plans[0]
    h = engine.host_window(Grid(cs.SHORT_GRID, 0, torch.device("cpu")), plan.blk_lo,
                           plan.blk_hi, plan.l_pad, plan.block_len, QPK)
    rq, Hkv = h.rows * QPK, 4
    qs = tpf.q_spans(rq, Hkv, h.span, plan.block_len, 132)
    spans = tpf.balanced_spans(h.row_tiles, Hkv, 132)
    assert qs == 28 and spans < qs and spans <= max(h.row_tiles)


class DeviceOnly(torch.Tensor):
    """A plan array that may not be read back to the host: ops on it give
    DeviceOnly tensors, and reading one raises."""

    def _read(self, *args, **kwargs):
        raise AssertionError("a window array was read back from the device")

    item = cpu = tolist = numpy = __int__ = __float__ = __bool__ = __index__ = _read


def test_b11_engine_hands_row_tiles_and_reads_nothing(gather_plans, monkeypatch):
    """make_sharded_tree_attn over a gather plan, rank 0 of grid 2x1x2 (q its
    dp window of the rows): the batch's plan arrays read nothing back to the
    host while the window is cut, and B11 gets the host's row tiles."""
    plan = gather_plans[0]
    grid = Grid(cs.SHORT_GRID, 0, torch.device("cpu"))
    monkeypatch.setattr(grid, "all_reduce", lambda t, axes, op="sum": t)
    seen = {}

    def b11(q, k_pool, v_pool, li, kv_idx, tok_lo, tok_hi, blk_lo, blk_hi, scale,
            k_scale=None, v_scale=None, row_tiles=None):
        seen.update(row_tiles=row_tiles, arrays=(kv_idx, tok_lo, tok_hi, blk_lo, blk_hi))
        rq, Hkv, D = q.shape[0] * QPK, k_pool.shape[-1] // q.shape[-1], q.shape[-1]
        return (torch.zeros(Hkv, rq, D), torch.zeros(Hkv, rq), torch.ones(Hkv, rq))

    monkeypatch.setattr(engine, "flatten_attention_partial", b11)
    rows = row_window(grid, "dp", plan.l_pad)
    batch = SimpleNamespace(**{n: torch.from_numpy(getattr(plan, n)).as_subclass(DeviceOnly)
                               for n in ARRS}, blk_host=(plan.blk_lo, plan.blk_hi),
                            dp_rows=rows)
    Hkv, D = 4, 64
    pool = SimpleNamespace(data=torch.zeros(1, 16384, Hkv * D), scale=None, quantized=False)
    q = torch.zeros(rows.rows, QPK * Hkv, D)  # the rank's window of the rows
    attn = engine.make_sharded_tree_attn(grid, paged=False)
    assert attn(q, None, None, pool, pool, 0, batch, D ** -0.5).shape == q.shape
    h = engine.host_window(grid, plan.blk_lo, plan.blk_hi, plan.l_pad, plan.block_len, QPK)
    assert seen["row_tiles"] == h.row_tiles and len(h.row_tiles) == 1
    assert all(isinstance(a, DeviceOnly) for a in seen["arrays"])
