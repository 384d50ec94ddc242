"""deft_tpu_torch's kernel functions (their plain torch versions, which the
wrappers run on the CPU) against deft_tpu's Pallas kernels, run as
tests/test_kernels.py runs them on the CPU (interpret mode).

Same numpy inputs to both; the plans come from real trees built with the
port's TreeCache (test_torch_core_plan.py proves them equal to deft_tpu's).
Tolerances, relative to the largest output, live rows only (dead rows differ
by convention, deft_tpu tests/test_kernels.py:77-84):
  fp32 2e-5 — summation order only;
  bf16 2e-2 — the Pallas kernels round the scaled q and p to bf16, the plain
              versions compute in fp32 (tests/test_kernels.py's bf16 bound).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deft_tpu.ops.flatten_attn import fold_q, unfold_o
from deft_tpu.ops.paged_flatten_attn import paged_flatten_attention as j_flatten
from deft_tpu.ops.paged_seq_attn import paged_seq_attention as j_seq
from deft_tpu.ops.prefill import prefill_attention as j_prefill
from deft_tpu_torch.core import ReqToTokenPool, TokenKVPool, TreeCache
from deft_tpu_torch.ops import paged_flatten_attn as tpf
from deft_tpu_torch.ops import paged_seq_attn as tps
from deft_tpu_torch.ops import prefill as tpr
from deft_tpu_torch.plan import build_flatten_plan, build_seq_plan

Hq, Hkv, D = 8, 2, 64
QPK = Hq // Hkv
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-9)


def dense_tree(rng):
    """FULL prefix blocks, a pruned leaf, a dead bucket tail and few-leaf
    suffix blocks; 12 leaves, so l_pad * qpk = 64 rows > the Pallas
    kernel's 32-row narrow-q window."""
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


def unaligned_tree(rng):
    """Speculative-decoding accepts merged into the root, leaves reset: the
    leaves' 1-token runs sit at unaligned pool offsets."""
    tree = TreeCache(TokenKVPool(16384), ReqToTokenPool(64, 4096))
    tree.init_prompt(rng.integers(4, 400, 300).tolist())
    for i, c in enumerate(tree.branch(tree.root, 16)):
        c.append_token(50 + i)
    tree.alloc()
    for _ in range(3):
        leaves = list(tree.leaves.values())
        before = tree.root.kv_len
        for i in range(2):
            tree.merge_nodes(tree.root, leaves[i], prune_b=False)
        for leaf in leaves:
            tree.reset_node_KV(leaf, tree.root.kv_len - before)
        tree.sync_page_table()
        tree.alloc()
    return tree


TREES = {"dense": dense_tree, "unaligned": unaligned_tree}


def inputs(rng, tree, l_pad, dt):
    S = tree.token_to_kv_pool.size
    kp = rng.standard_normal((1, S, Hkv * D)).astype(np.float32)
    vp = rng.standard_normal((1, S, Hkv * D)).astype(np.float32)
    q = rng.standard_normal((l_pad, Hq, D)).astype(np.float32)
    jdt, tdt, _ = DTYPES[dt]
    jx = [jnp.asarray(x, jdt) for x in (q, kp, vp)]
    tx = [torch.from_numpy(x).to(tdt) for x in (q, kp, vp)]
    return jx, tx


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", list(TREES))
def test_paged_flatten_plain_vs_pallas(case, dt):
    rng = np.random.default_rng(1)
    tree = TREES[case](rng)
    plan = build_flatten_plan(tree, q_per_kv=QPK, block_len=128,
                              min_token_bucket=1024)
    assert plan.paged
    full = plan.blk_lo < -(1 << 20)
    dead = (plan.blk_lo >= plan.blk_hi) & ~full
    if case == "dense":
        few = ~full & ~dead & (plan.blk_hi - plan.blk_lo < plan.n_leaves)
        assert full.any() and dead.any() and few.any()
    (jq, jk, jv), (tq, tk, tv) = inputs(rng, tree, plan.l_pad, dt)
    scale = D ** -0.5
    want = unfold_o(j_flatten(
        fold_q(jq, Hkv), jk, jv, jnp.asarray(0, jnp.int32),
        jnp.asarray(plan.seg_src), jnp.asarray(plan.tok_lo),
        jnp.asarray(plan.tok_hi), jnp.asarray(plan.blk_lo),
        jnp.asarray(plan.blk_hi), scale=scale, qpk=QPK,
        block_len=plan.block_len, seg_len=plan.seg_len), plan.l_pad)
    arr = [torch.from_numpy(a) for a in (plan.seg_src, plan.tok_lo, plan.tok_hi,
                                         plan.blk_lo, plan.blk_hi)]
    got = tpf.paged_flatten_attention(tq, tk, tv, 0, *arr, scale,
                                      plan.block_len, plan.seg_len)
    live = slice(0, plan.n_leaves)
    assert rel_err(got.float().numpy()[live],
                   np.asarray(want, np.float32)[live]) < DTYPES[dt][2]


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", list(TREES))
def test_paged_seq_plain_vs_pallas(case, dt):
    rng = np.random.default_rng(2)
    tree = TREES[case](rng)
    plan = build_seq_plan(tree, q_per_kv=QPK, block_len=128, min_token_bucket=256)
    assert plan.paged
    if case == "unaligned":
        assert plan.seg_off.any()
    (jq, jk, jv), (tq, tk, tv) = inputs(rng, tree, plan.l_pad, dt)
    R = plan.l_pad
    scale = D ** -0.5
    block_len = plan.c_pad // (len(plan.blk_live) // R)
    want = j_seq(jq.reshape(R, Hkv, QPK, D), jk, jv, jnp.asarray(0, jnp.int32),
                 jnp.asarray(plan.seg_src), jnp.asarray(plan.seg_off),
                 jnp.asarray(plan.seg_live), jnp.asarray(plan.blk_live),
                 scale=scale, block_len=block_len,
                 seg_len=plan.seg_len).reshape(R, Hq, D)
    arr = [torch.from_numpy(a) for a in (plan.seg_src, plan.seg_off,
                                         plan.seg_live, plan.blk_live)]
    got = tps.paged_seq_attention(tq, tk, tv, 0, *arr, scale, plan.seg_len)
    live = slice(0, plan.n_leaves)
    assert rel_err(got.float().numpy()[live],
                   np.asarray(want, np.float32)[live]) < DTYPES[dt][2]


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("N", [256, 384])
def test_prefill_plain_vs_pallas(N, dt):
    rng = np.random.default_rng(N)
    jdt, tdt, tol = DTYPES[dt]
    q = rng.standard_normal((N, Hq, D)).astype(np.float32)
    k = rng.standard_normal((N, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((N, Hkv, D)).astype(np.float32)
    scale = D ** -0.5
    want = unfold_o(j_prefill(
        fold_q(jnp.asarray(q, jdt), Hkv), jnp.swapaxes(jnp.asarray(k, jdt), 0, 1),
        jnp.swapaxes(jnp.asarray(v, jdt), 0, 1), scale=scale, qpk=QPK), N)
    got = tpr.prefill_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                                scale)
    assert rel_err(got.float().numpy(), np.asarray(want, np.float32)) < tol


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    """A tensor that is not on the CPU goes to the kernel path, which refuses
    what is not on one CUDA device before it builds or launches anything."""
    meta = dict(device="meta")
    i32 = dict(dtype=torch.int32, device="meta")
    q = torch.empty(4, Hq, D, **meta)
    pool = torch.empty(1, 512, Hkv * D, **meta)
    with pytest.raises(ValueError, match="CUDA device"):
        tpr.prefill_attention(q, torch.empty(4, Hkv, D, **meta),
                              torch.empty(4, Hkv, D, **meta), 0.1)
    with pytest.raises(ValueError, match="CUDA device"):
        tpf.paged_flatten_attention(
            q, pool, pool, 0, torch.empty(4, **i32), torch.empty(128, **i32),
            torch.empty(128, **i32), torch.empty(1, **i32), torch.empty(1, **i32),
            0.1, 128, 32)
    with pytest.raises(ValueError, match="CUDA device"):
        tps.paged_seq_attention(
            q, pool, pool, 0, torch.empty(16, **i32), torch.empty(16, **i32),
            torch.empty(16, **i32), torch.empty(4, **i32), 0.1, 32)


def test_plain_dead_rows_are_zero():
    """A row that sees no token gives 0 in the plain versions, as in the
    kernels (deft_tpu ops/dense_oracle.py:39-44)."""
    rng = np.random.default_rng(3)
    tree = dense_tree(rng)
    plan = build_flatten_plan(tree, q_per_kv=QPK, block_len=128,
                              min_token_bucket=1024)
    _, (tq, tk, tv) = inputs(rng, tree, plan.l_pad, "float32")
    lo = torch.from_numpy(plan.tok_lo)
    hi = torch.from_numpy(plan.tok_hi)
    # no FULL blocks: intervals decide alone, and padded leaves see nothing
    blo = torch.from_numpy(np.where(plan.blk_lo < -(1 << 20), 0, plan.blk_lo))
    got = tpf.paged_flatten_attention(
        tq, tk, tv, 0, torch.from_numpy(plan.seg_src), lo, hi, blo,
        torch.from_numpy(plan.blk_hi), D ** -0.5, plan.block_len, plan.seg_len)
    assert plan.n_leaves < plan.l_pad
    assert torch.all(got[plan.n_leaves:] == 0)
    assert torch.all(got[:plan.n_leaves].abs().amax(dim=(1, 2)) > 0)
