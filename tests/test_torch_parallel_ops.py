"""deft_tpu_torch's multi-device pieces in one process, against deft_tpu's.

- the plain versions of the partial kernels (B11, B1p, B4p, B2p, B5p) on a
  rank's window of a (dp, sp) grid (shifted leaf intervals, blocks outside
  the window, pad blocks) against deft_tpu's partial entries in interpret
  mode, as tests/test_multichip.py runs them: acc, m and l (deft_tpu's
  column 0) at 2e-5 on live rows, m where the row saw a token;
- the LSE merge over sp shards against deft_tpu's flatten_attention_sharded
  on the 8-device CPU mesh;
- multi-tree plans (the batched engine's, plan/multi.py) cut into every
  rank window of (dp, sp) grids: each visible (leaf, pool row) pair lands
  in exactly one window, and the cut reads nothing back from the device
  (the block counts come from the numpy plan the batch carries);
- the grid factoring, the sharding rules and the rank slices of the fused
  tensors against deft_tpu's unfused shards; int8 row-parallel scales whole.

The windows are cut by the engine's own functions (parallel/engine.py,
parallel/seq_engine.py) on a Grid that names a rank's coordinates without a
process group; tests/test_torch_parallel.py runs real ranks.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deft_tpu.models import PRESETS as JPRESETS
from deft_tpu.models.loader import random_params as j_random_params
from deft_tpu.ops.flatten_attn import fold_q
from deft_tpu.ops.paged_flatten_attn import paged_flatten_attention_partial as j_b1p
from deft_tpu.ops.paged_quant import paged_flatten_attention_q_partial as j_b4p
from deft_tpu.ops.paged_seq_attn import (paged_seq_attention_partial as j_b2p,
                                         paged_seq_attention_q_partial as j_b5p)
from deft_tpu.ops.sharded_flatten import (flatten_attention_partial as j_b11,
                                          flatten_attention_sharded)
from deft_tpu.parallel.mesh import _factor as j_factor
from deft_tpu.parallel.mesh import make_mesh as j_make_mesh
from deft_tpu.parallel.sharding import shard_params as j_shard_params
from deft_tpu.parallel.sharding import shard_pool as j_shard_pool
from deft_tpu_torch.core import ReqToTokenPool, TokenKVPool, TreeCache
from deft_tpu_torch.models import PRESETS
from deft_tpu_torch.models.loader import random_params
from deft_tpu_torch.ops import paged_flatten_attn as tpf
from deft_tpu_torch.ops import paged_quant as tpq
from deft_tpu_torch.ops import paged_seq_attn as tps
from deft_tpu_torch.ops import sharded_flatten as tsf
from deft_tpu_torch.parallel import engine, seq_engine, sharding
from deft_tpu_torch.parallel.mesh import Grid, _factor
from deft_tpu_torch.plan import build_flatten_plan, build_seq_plan
from deft_tpu_torch.plan.multi import build_multi_flatten_plan, build_multi_seq_plan
from test_torch_b7 import DeviceOnly

Hq, Hkv, D = 8, 2, 64
QPK = Hq // Hkv
TOL = 2e-5
# (dp, sp) grids: 2 x 3 leaves a pad block in the last sp span
GRIDS = [(1, 2), (2, 3)]


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.size == 0:
        return 0.0
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-9)


def make_tree(rng):
    """FULL prefix blocks, a pruned leaf, a dead bucket tail and few-leaf
    suffix blocks over 11 live leaves (tests/test_torch_kernels.py)."""
    tree = TreeCache(TokenKVPool(8192), ReqToTokenPool(64, 2048))
    tree.init_prompt(rng.integers(4, 400, 700).tolist())
    for i, c in enumerate(tree.branch(tree.root, 12)):
        c.append_token(50 + i)
    for _ in range(12):
        tree.alloc()
        for leaf in list(tree.leaves.values()):
            leaf.append_token(int(rng.integers(1, 400)))
    tree.cut(sorted(tree.leaves.values(), key=lambda x: x.id)[0])
    tree.alloc()
    return tree


def pools(rng, S, int8):
    if int8:
        data = [rng.integers(-127, 128, (1, S, Hkv * D)).astype(np.int8) for _ in range(2)]
        scales = [(rng.random((1, Hkv, S)) * 0.09 + 0.01).astype(np.float32)
                  for _ in range(2)]
        return data, scales
    return [rng.standard_normal((1, S, Hkv * D)).astype(np.float32) for _ in range(2)], \
        [None, None]


def grid_ranks(dp, sp):
    """A Grid per (dp, sp) rank, tp 1, with no process group."""
    return [Grid((dp, sp, 1), r, torch.device("cpu")) for r in range(dp * sp)]


def to_t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def check_state(got, want_acc, want_m, want_l, live_rows, flat):
    """got (acc, m, l) of the port against deft_tpu's (lane-broadcast m, l:
    column 0), on the live rows (dim 1 of a folded flatten state, dim 0 of
    a seq state); m where the row saw a token."""
    acc, m, l = (t.numpy() for t in got)
    want_m, want_l = np.asarray(want_m)[..., 0], np.asarray(want_l)[..., 0]
    sel = (slice(None), live_rows) if flat else (live_rows,)
    acc, m, l = acc[sel], m[sel], l[sel]
    wa, wm, wl = np.asarray(want_acc)[sel], want_m[sel], want_l[sel]
    seen = wl > 0
    assert rel_err(acc, wa) < TOL
    assert rel_err(l, wl) < TOL
    assert rel_err(m[seen], wm[seen]) < TOL
    assert np.isfinite(m).all() and np.isfinite(acc).all()


@pytest.mark.parametrize("dp,sp", GRIDS)
@pytest.mark.parametrize("kind", ["paged", "paged_int8", "gather", "gather_int8"])
def test_flatten_partial_plain_matches_deft_tpu(kind, dp, sp):
    """B1p, B4p and B11 on every rank's window of the plan."""
    rng = np.random.default_rng(3)
    tree = make_tree(rng)
    int8 = kind.endswith("int8")
    paged = kind.startswith("paged")
    kw = ({} if not paged else
          dict(seg_len=(512, 256, 128), waste_limit=(1.1, 1.2, 3.0)) if int8 else {})
    if not paged:
        kw = {"seg_len": None}
    plan = build_flatten_plan(tree, q_per_kv=QPK, block_len=128, min_token_bucket=1024,
                              **kw)
    assert plan.paged == paged
    S = tree.token_to_kv_pool.size
    (kp, vp), (ks, vs) = pools(rng, S, int8)
    q = rng.standard_normal((plan.l_pad, Hq, D)).astype(np.float32)
    names = ["tok_lo", "tok_hi", "blk_lo", "blk_hi"] + (["seg_src"] if paged else ["kv_idx"])
    batch = type("Batch", (), {n: torch.from_numpy(getattr(plan, n)) for n in names}
                 | {"blk_host": (plan.blk_lo, plan.blk_hi)})
    scale = D ** -0.5
    checked = 0
    for grid in grid_ranks(dp, sp):
        w = engine.flatten_window(grid, batch, plan.l_pad, paged)
        ql = sharding.row_window(grid, "dp", plan.l_pad).take(torch.from_numpy(q))
        arrs = [w.tok_lo, w.tok_hi, w.blk_lo, w.blk_hi]
        if paged and int8:
            got = tpq.paged_flatten_attention_q_partial(
                ql, to_t(kp), to_t(vp), to_t(ks), to_t(vs), 0, w.seg_src, *arrs, scale,
                w.block_len, w.seg_len)
            want = j_b4p(fold_q(jnp.asarray(ql.numpy()), Hkv), jnp.asarray(kp),
                         jnp.asarray(vp), jnp.asarray(ks), jnp.asarray(vs),
                         jnp.asarray(0, jnp.int32), jnp.asarray(w.seg_src.numpy()),
                         *(jnp.asarray(a.numpy()) for a in arrs), scale=scale, qpk=QPK,
                         block_len=w.block_len, seg_len=w.seg_len)
        elif paged:
            got = tpf.paged_flatten_attention_partial(
                ql, to_t(kp), to_t(vp), 0, w.seg_src, *arrs, scale, w.block_len,
                w.seg_len)
            want = j_b1p(fold_q(jnp.asarray(ql.numpy()), Hkv), jnp.asarray(kp),
                         jnp.asarray(vp), jnp.asarray(0, jnp.int32),
                         jnp.asarray(w.seg_src.numpy()),
                         *(jnp.asarray(a.numpy()) for a in arrs), scale=scale, qpk=QPK,
                         block_len=w.block_len, seg_len=w.seg_len)
        else:
            got = tsf.flatten_attention_partial(ql, to_t(kp), to_t(vp), 0, w.kv_idx, *arrs,
                                                scale, to_t(ks), to_t(vs))
            # deft_tpu's engine gathers the span's KV first (dequantised)
            idx = w.kv_idx.numpy()
            kt, vt = ((p[0][idx].astype(np.float32).reshape(-1, Hkv, D)
                       * (1.0 if s is None else s[0][:, idx].T[..., None]))
                      .transpose(1, 0, 2) for p, s in ((kp, ks), (vp, vs)))
            want = j_b11(fold_q(jnp.asarray(ql.numpy()), Hkv), jnp.asarray(kt),
                         jnp.asarray(vt), *(jnp.asarray(a.numpy()) for a in arrs),
                         scale=scale, qpk=QPK, block_len=w.block_len)
        live = max(0, min(w.rows, plan.n_leaves - w.r0))
        check_state(got, *want, slice(0, live * QPK), flat=True)
        checked += live > 0
    assert checked >= dp  # every dp window holds live leaves


@pytest.mark.parametrize("dp,sp", GRIDS)
@pytest.mark.parametrize("int8", [False, True])
def test_seq_partial_plain_matches_deft_tpu(int8, dp, sp):
    """B2p and B5p on every rank's window of the per-leaf tables."""
    rng = np.random.default_rng(4)
    tree = make_tree(rng)
    kw = dict(seg_len=(128,), waste_limit=32.0) if int8 else {}
    plan = build_seq_plan(tree, q_per_kv=QPK, block_len=128, min_token_bucket=256, **kw)
    assert plan.paged
    S = tree.token_to_kv_pool.size
    (kp, vp), (ks, vs) = pools(rng, S, int8)
    R = plan.l_pad
    q = rng.standard_normal((R, Hq, D)).astype(np.float32)
    batch = type("Batch", (), {n: torch.from_numpy(getattr(plan, n)) for n in
                               ("seg_src", "seg_off", "seg_live", "blk_live")}
                 | {"live_host": plan.blk_live})
    block_len = plan.c_pad // (len(plan.blk_live) // R)
    scale = D ** -0.5
    for grid in grid_ranks(dp, sp):
        w = seq_engine.seq_window(grid, batch, R)
        ql = sharding.row_window(grid, "dp", R).take(torch.from_numpy(q))
        tables = (w.seg_src, w.seg_off, w.seg_live, w.blk_live)
        jt = [jnp.asarray(t.numpy()) for t in tables]
        jq = jnp.asarray(ql.numpy()).reshape(w.rows, Hkv, QPK, D)
        if int8:
            got = tps.paged_seq_attention_q_partial(ql, to_t(kp), to_t(vp), to_t(ks),
                                                    to_t(vs), 0, *tables, scale,
                                                    plan.seg_len)
            want = j_b5p(jq, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(ks),
                         jnp.asarray(vs), jnp.asarray(0, jnp.int32), *jt, scale=scale,
                         block_len=block_len, seg_len=plan.seg_len)
        else:
            got = tps.paged_seq_attention_partial(ql, to_t(kp), to_t(vp), 0, *tables,
                                                  scale, plan.seg_len)
            want = j_b2p(jq, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(0, jnp.int32),
                         *jt, scale=scale, block_len=block_len, seg_len=plan.seg_len)
        want = [np.asarray(x).reshape(w.rows, Hq, D) for x in want]
        live = max(0, min(w.rows, plan.n_leaves - w.r0))
        check_state(got, *want, slice(0, live), flat=False)


def stacked_reduce(t, op):
    """An all-reduce over the leading (shard) axis of a stacked tensor."""
    r = t.amax(0, keepdim=True) if op == "max" else t.sum(0, keepdim=True)
    return t.copy_(r.expand_as(t))


def test_sp_merge_matches_deft_tpu_sharded():
    """B11's state on each of sp = 2 spans, merged by engine.lse_merge,
    against deft_tpu's flatten_attention_sharded on the (sp 2, tp 4) CPU
    mesh, with the inputs of test_sharded_flatten_kernel_matches_oracle."""
    from jax.sharding import Mesh
    from deft_tpu.ops.flatten_attn import unfold_o

    rng = np.random.default_rng(11)
    R, hq, hkv, d, T = 16, 8, 4, 64, 1024
    block_len = 128
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("sp", "tp"))
    q = rng.standard_normal((R, hq, d)).astype(np.float32)
    k = rng.standard_normal((T, hkv, d)).astype(np.float32)
    v = rng.standard_normal((T, hkv, d)).astype(np.float32)
    lo = np.full(T, 2**30, np.int32)
    hi = np.zeros(T, np.int32)
    lo[: T // 2] = 0
    hi[: T // 2] = R
    for r in range(R):
        s = T // 2 + r * (T // 2 // R)
        lo[s:s + T // 2 // R] = r
        hi[s:s + T // 2 // R] = r + 1
    nb = T // block_len
    blk_lo = lo.reshape(nb, block_len).min(1)
    blk_hi = hi.reshape(nb, block_len).max(1)
    scale = d ** -0.5
    with mesh:
        want = unfold_o(flatten_attention_sharded(
            mesh, fold_q(jnp.asarray(q), hkv), jnp.swapaxes(jnp.asarray(k), 0, 1),
            jnp.swapaxes(jnp.asarray(v), 0, 1), jnp.asarray(lo), jnp.asarray(hi),
            jnp.asarray(blk_lo), jnp.asarray(blk_hi), scale=scale, qpk=hq // hkv,
            block_len=block_len, out_dtype=jnp.float32), R)
    batch = type("Batch", (), dict(kv_idx=torch.arange(T, dtype=torch.int32),
                                   tok_lo=torch.from_numpy(lo), tok_hi=torch.from_numpy(hi),
                                   blk_lo=torch.from_numpy(blk_lo),
                                   blk_hi=torch.from_numpy(blk_hi),
                                   blk_host=(blk_lo, blk_hi)))
    kp, vp = (torch.from_numpy(x.reshape(1, T, hkv * d)) for x in (k, v))
    states = []
    for grid in grid_ranks(1, 2):
        w = engine.flatten_window(grid, batch, R, paged=False)
        states.append(tsf.flatten_attention_partial(
            torch.from_numpy(q), kp, vp, 0, w.kv_idx, w.tok_lo, w.tok_hi, w.blk_lo,
            w.blk_hi, scale))
    acc, m, l = (torch.stack(x) for x in zip(*states))
    o = engine.lse_merge(acc, m, l, stacked_reduce)
    assert torch.equal(o[0], o[1])  # every rank holds the merged output
    got = tpf.unfold_rows(o[0], R).numpy()
    assert np.abs(got - np.asarray(want)).max() < 2e-5


@pytest.mark.parametrize("sp", [2, 3])
@pytest.mark.parametrize("kind", ["flatten", "seq"])
def test_sp_spans_hold_each_live_token_once(kind, sp):
    """sp splits the blocks up to the last live one: the plan's bucket
    padding falls to no rank, every span holds live tokens, and the spans
    together hold each visible (leaf, pool row) pair once."""
    rng = np.random.default_rng(5)
    tree = make_tree(rng)
    if kind == "flatten":
        plan = build_flatten_plan(tree, q_per_kv=QPK, block_len=128, min_token_bucket=1024)
        names = ("seg_src", "tok_lo", "tok_hi", "blk_lo", "blk_hi")
    else:
        plan = build_seq_plan(tree, q_per_kv=QPK, block_len=128, min_token_bucket=256)
        names = ("seg_src", "seg_off", "seg_live", "blk_live")
    assert plan.paged
    R = plan.l_pad
    batch = type("Batch", (), {n: torch.from_numpy(getattr(plan, n)) for n in names}
                 | ({"blk_host": (plan.blk_lo, plan.blk_hi)} if kind == "flatten"
                    else {"live_host": plan.blk_live}))

    def pairs(b, seg_len):
        """The sorted (leaf, pool row) pairs a plan or window makes visible."""
        if kind == "flatten":
            block_len = b.tok_lo.shape[0] // b.blk_lo.shape[0]
            lo, hi = tpf.leaf_intervals(b.tok_lo, b.tok_hi, b.blk_lo, b.blk_hi,
                                        block_len, R)
            r = torch.arange(R)[:, None]
            mask = (lo[None, :] <= r) & (r < hi[None, :])
            rows = tpf.segment_rows(b.seg_src, seg_len)[None].expand(R, -1)
        else:
            rows, mask = tps.segment_paths(b.seg_src, b.seg_off, b.seg_live, b.blk_live,
                                           R, seg_len)
        leaf = torch.arange(R)[:, None].expand_as(mask)
        return sorted(zip(leaf[mask].tolist(), rows[mask].tolist()))

    got, blocks = [], 0
    for grid in grid_ranks(1, sp):
        if kind == "flatten":
            w = engine.flatten_window(grid, batch, R, paged=True)
            blocks += w.blk_lo.shape[0]
        else:
            w = seq_engine.seq_window(grid, batch, R)
            blocks += w.blk_live.shape[0] // R
        span = pairs(w, plan.seg_len)
        assert span, f"sp rank {grid.index('sp')} holds no live token"
        got += span
    whole = plan.blk_lo.shape[0] if kind == "flatten" else len(plan.blk_live) // R
    assert blocks < whole  # the trailing pad blocks fell to no rank
    assert sorted(got) == pairs(batch, plan.seg_len)


def multi_trees(rng, steps):
    """Three trees in one pool, as the batched engine holds them: prompts of
    700, 300 and 130 tokens, 5, 4 and 3 leaves, ``steps`` tokens appended
    (at 20 their multi-tree flatten plan is segment-aligned, at 3 not)."""
    pool, rtp = TokenKVPool(8192), ReqToTokenPool(64, 2048)
    trees = []
    for n, width in ((700, 5), (300, 4), (130, 3)):
        t = TreeCache(pool, rtp)
        t.init_prompt(rng.integers(4, 400, n).tolist())
        for i, c in enumerate(t.branch(t.root, width)):
            c.append_token(50 + i)
        trees.append(t)
    for _ in range(steps):
        for t in trees:
            t.alloc()
            for leaf in list(t.leaves.values()):
                leaf.append_token(int(rng.integers(1, 400)))
    for t in trees:
        t.alloc()
    return trees


def visible_pairs(kind, b, R, r0, seg_len, n_leaves):
    """The sorted (global leaf, pool row) pairs the plan or window ``b`` of
    R rows starting at row r0 makes visible, live leaves only."""
    b = SimpleNamespace(**{k: v.as_subclass(torch.Tensor) if isinstance(v, torch.Tensor)
                           else v for k, v in vars(b).items()})
    if kind == "seq":
        rows, mask = tps.segment_paths(b.seg_src, b.seg_off, b.seg_live, b.blk_live, R,
                                       seg_len)
    else:
        block_len = b.tok_lo.shape[0] // b.blk_lo.shape[0]
        lo, hi = tpf.leaf_intervals(b.tok_lo, b.tok_hi, b.blk_lo, b.blk_hi, block_len, R)
        r = torch.arange(R)[:, None]
        mask = (lo[None, :] <= r) & (r < hi[None, :])
        src = (tpf.segment_rows(b.seg_src, seg_len) if kind == "paged"
               else b.kv_idx.long())
        rows = src[None].expand(R, -1)
    leaf = r0 + torch.arange(R)[:, None].expand_as(mask)
    mask = mask & (leaf < n_leaves)
    return sorted(zip(leaf[mask].tolist(), rows[mask].tolist()))


@pytest.mark.parametrize("dp,sp", GRIDS + [(2, 1)])
@pytest.mark.parametrize("kind", ["paged", "gather", "seq"])
def test_multi_tree_windows_cover_each_pair_once_and_read_nothing(kind, dp, sp):
    """The batched engine's multi-tree plans on every rank of the grid:
    dp windows start inside a tree's leaves (12 leaves, offsets 0, 5, 9),
    the sp spans split blocks of different trees; the windows together
    make each visible (leaf, pool row) pair visible once, and cutting them
    reads no plan array back (DeviceOnly raises on a read)."""
    trees = multi_trees(np.random.default_rng(11), 20 if kind == "paged" else 3)
    if kind == "seq":
        plan = build_multi_seq_plan(trees, q_per_kv=QPK, block_len=128,
                                    min_token_bucket=256)
        names = ("seg_src", "seg_off", "seg_live", "blk_live")
        host = {"live_host": plan.blk_live}
    else:
        plan = build_multi_flatten_plan(trees, q_per_kv=QPK, block_len=128,
                                        min_token_bucket=1024,
                                        **({} if kind == "paged" else {"seg_len": ()}))
        names = ("tok_lo", "tok_hi", "blk_lo", "blk_hi",
                 "seg_src" if kind == "paged" else "kv_idx")
        host = {"blk_host": (plan.blk_lo, plan.blk_hi)}
    assert plan.paged == (kind != "gather")
    assert list(plan.leaf_offsets) == [0, 5, 9] and plan.n_leaves == 12
    R = plan.l_pad
    batch = SimpleNamespace(**{n: torch.from_numpy(getattr(plan, n)).as_subclass(DeviceOnly)
                               for n in names}, **host)
    got, starts = [], set()
    for grid in grid_ranks(dp, sp):
        if kind == "seq":
            w = seq_engine.seq_window(grid, batch, R)
        else:
            w = engine.flatten_window(grid, batch, R, paged=kind == "paged")
        assert all(isinstance(getattr(w, n), DeviceOnly) for n in names)
        starts.add(w.r0)
        got += visible_pairs(kind, w, w.rows, w.r0, plan.seg_len, plan.n_leaves)
    assert sorted(got) == visible_pairs(kind, batch, R, 0, plan.seg_len, plan.n_leaves)
    if dp > 1:
        assert starts - {0, 5, 9}  # a window starts inside a tree's leaves


def test_grid_factor_matches_deft_tpu():
    for n in range(1, 9):
        for kv in (1, 2, 4, 8):
            assert _factor(n, kv) == j_factor(n, kv), (n, kv)


def test_grid_coordinates():
    """Rank r of (dp, sp, tp) sits at r = (dp_i * sp + sp_i) * tp + tp_i,
    tp innermost, as deft_tpu's mesh reshapes its devices."""
    for r in range(8):
        g = Grid((2, 2, 2), r, torch.device("cpu"))
        c = g.coords
        assert (c["dp"] * 2 + c["sp"]) * 2 + c["tp"] == r
    assert Grid((1, 1, 1), 0, torch.device("cpu")).size == 1


CONFIGS = {"dense": PRESETS["tiny"],
           "moe": dataclasses.replace(PRESETS["tiny"], num_experts=4)}


@pytest.mark.parametrize("wdt", ["inherit", "int8", "int8-pallas"])
@pytest.mark.parametrize("model", list(CONFIGS))
def test_sharding_rules_cover_every_parameter(model, wdt):
    cfg = CONFIGS[model]
    params = random_params(cfg, 0, "cpu", torch.float32, wdt)
    rules = sharding.param_shardings()
    assert set(params) <= set(rules)
    for grid in grid_ranks(1, 2):  # every slice is cut, none is refused
        local = sharding.shard_params(grid, params, cfg)
        assert set(local) == set(params)


def _jax_shard(arr, mesh, coords):
    """The shard of a placed jax array on the mesh device at coords."""
    dev = mesh.devices[coords]
    (shard,) = [s for s in arr.addressable_shards if s.device == dev]
    return np.asarray(shard.data)


@pytest.mark.parametrize("model", list(CONFIGS))
def test_fused_rank_slices_equal_deft_tpu_shards(model):
    """A rank's wqkv = its wq | wk | wv shards and wgu = wg | wu, as deft_tpu
    places the unfused tensors on a (1, 2, 2) mesh; expert stacks cut over
    sp; the rest slice for slice."""
    cfg = CONFIGS[model]
    jcfg = dataclasses.replace(JPRESETS["tiny"], num_experts=cfg.num_experts)
    jparams = j_random_params(jcfg, seed=0, dtype=jnp.float32)
    mesh = j_make_mesh(4, num_kv_heads=cfg.num_kv_heads, shape=(1, 2, 2))
    jsharded = j_shard_params(mesh, jparams)
    params = random_params(cfg, 0, "cpu", torch.float32)
    for r in range(4):
        grid = Grid((1, 2, 2), r, torch.device("cpu"))
        local = sharding.shard_params(grid, params, cfg)
        coords = (0, grid.index("sp"), grid.index("tp"))
        shard = {k: _jax_shard(v, mesh, coords) for k, v in jsharded.items()}
        fused = {"wqkv": ("wq", "wk", "wv")}
        if not cfg.num_experts:
            fused["wgu"] = ("wg", "wu")
        for name, parts in fused.items():
            want = np.concatenate([shard[p] for p in parts], axis=-1)
            np.testing.assert_array_equal(local[name].numpy(), want)
        for name, t in local.items():
            if name not in fused:
                np.testing.assert_array_equal(t.numpy(), shard[name], err_msg=name)


def test_pool_slices_equal_deft_tpu_shards():
    """KV pools (L, S, Hkv*D) cut over tp on their head-flattened axis, int8
    scale pools (L, Hkv, S) on their head axis, every slot on every rank."""
    from deft_tpu.models.llama import KVPool as JKVPool
    from deft_tpu_torch.models.llama import KVPool

    rng = np.random.default_rng(5)
    data = rng.integers(-127, 128, (2, 64, 4 * 8)).astype(np.int8)
    scale = rng.random((2, 4, 64)).astype(np.float32)
    mesh = j_make_mesh(4, num_kv_heads=4, shape=(1, 2, 2))
    jpool = j_shard_pool(mesh, JKVPool(jnp.asarray(data), jnp.asarray(scale)))
    for r in range(4):
        grid = Grid((1, 2, 2), r, torch.device("cpu"))
        local = sharding.shard_pool(grid, KVPool(torch.from_numpy(data),
                                                 torch.from_numpy(scale)))
        coords = (0, grid.index("sp"), grid.index("tp"))
        np.testing.assert_array_equal(local.data.numpy(), _jax_shard(jpool.data, mesh, coords))
        np.testing.assert_array_equal(local.scale.numpy(),
                                      _jax_shard(jpool.scale, mesh, coords))


def test_int8_row_parallel_scales_are_whole():
    """wo and wdown: a rank keeps its rows of the codes and the whole
    per-column scale vector, so the ranks' partial products sum to the
    whole layer's."""
    cfg = PRESETS["tiny"]
    params = random_params(cfg, 0, "cpu", torch.float32, "int8")
    grids = [Grid((1, 1, 2), r, torch.device("cpu")) for r in range(2)]
    locals_ = [sharding.shard_params(g, params, cfg) for g in grids]
    for name in ("wo", "wdown"):
        for loc in locals_:
            assert torch.equal(loc[name + "_s"], params[name + "_s"])
        rows = params[name].shape[1] // 2
        xs = torch.randn(3, 2 * rows, generator=torch.Generator().manual_seed(1))
        part = sum((xs[:, i * rows:(i + 1) * rows] @ loc[name][0].float())
                   * loc[name + "_s"][0] for i, loc in enumerate(locals_))
        whole = (xs @ params[name][0].float()) * params[name + "_s"][0]
        torch.testing.assert_close(part, whole, rtol=1e-5, atol=1e-5)
