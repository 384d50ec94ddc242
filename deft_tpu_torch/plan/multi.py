"""Port of deft_tpu/plan/multi.py:26 (build_multi_flatten_plan) and :132
(build_multi_seq_plan): a copy, with the same behaviour, owned by
deft_tpu_torch.

Multi-tree (batched) plans.

The reference is strictly single-tree (its roadmap lists batching as future
work, DeFT's README.md:248-258).  Here several decoding trees share the KV
pool and decode in ONE step: leaves are numbered globally (tree i's leaves
occupy [leaf_offset_i, leaf_offset_i + n_i)), each tree's flattened KV keeps
its per-token [lo, hi) interval shifted by the tree's leaf offset, and the
segments concatenate — the kernels are unchanged.  This is the
data-parallel / continuous-batching axis: trees join and leave between
steps.  Each plan carries ``leaf_offsets``, the first global row of each
tree.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from deft_tpu_torch.core.kv_pool import DUMP_SLOT
from deft_tpu_torch.core.tree import TreeCache
from deft_tpu_torch.plan.flatten import FlattenPlan, _EMPTY_LO, build_flatten_plan
from deft_tpu_torch.plan.padding import pad_leaf_count, pad_token_count
from deft_tpu_torch.plan.seq import SeqPlan, build_seq_plan


def build_multi_flatten_plan(
    trees: Sequence[TreeCache],
    q_per_kv: int,
    block_len: int = 128,
    min_token_bucket: int = 1024,
    seg_len=(128, 32),
    waste_limit: float = 1.5,
) -> FlattenPlan:
    """Concatenate per-tree flatten plans into one batched plan.

    Call after each tree's alloc().  Exact: a query of tree i can never
    attend tokens of tree j (disjoint leaf intervals)."""
    assert trees
    candidates = (seg_len,) if isinstance(seg_len, int) else tuple(seg_len)
    plans: List[FlattenPlan] = []
    # all trees must agree on one seg length; try candidates in order
    for cand in candidates + (None,):
        plans = [build_flatten_plan(
            t, q_per_kv,
            block_len=block_len,
            min_token_bucket=block_len,  # tight per-tree; pad globally below
            seg_len=cand,
            pow2_bucket=False,
            granularity=block_len,  # block-granularity (default 512 would
            # inflate every small tree ~2-4x with dead blocks)
            waste_limit=waste_limit,
        ) for t in trees]
        if cand is None or all(p.paged for p in plans):
            break
    paged = all(p.paged for p in plans)
    seg = plans[0].seg_len if paged else 0

    # -- KV side: concatenate with leaf-offset shifts ------------------------
    kv_parts, lo_parts, hi_parts, seg_parts = [], [], [], []
    leaf_offsets = []
    off = 0
    for p in plans:
        leaf_offsets.append(off)
        kv_parts.append(p.kv_idx)
        lo = p.tok_lo.copy()
        hi = p.tok_hi.copy()
        live = lo < _EMPTY_LO
        lo[live] += off
        hi[hi > 0] += off
        lo_parts.append(lo)
        hi_parts.append(hi)
        if paged:
            seg_parts.append(p.seg_src)
        off += p.n_leaves
    n_leaves = off

    kv_idx = np.concatenate(kv_parts)
    tok_lo = np.concatenate(lo_parts)
    tok_hi = np.concatenate(hi_parts)
    n_tokens = sum(p.n_tokens for p in plans)

    t_pad = pad_token_count(len(kv_idx), block_len, min_token_bucket, pow2=True)
    pad = t_pad - len(kv_idx)
    if pad:
        tail = (
            np.arange(pad, dtype=np.int32) % seg
            if paged
            else np.zeros(pad, dtype=np.int32)
        )
        kv_idx = np.concatenate([kv_idx, tail])
        tok_lo = np.concatenate([tok_lo, np.full(pad, _EMPTY_LO, np.int32)])
        tok_hi = np.concatenate([tok_hi, np.zeros(pad, np.int32)])
        if paged:
            seg_parts.append(kv_idx[len(kv_idx) - pad :: seg][: pad // seg])
    seg_src = np.concatenate(seg_parts) if paged else None

    nb = t_pad // block_len
    blk_lo = tok_lo.reshape(nb, block_len).min(axis=1)
    blk_hi = tok_hi.reshape(nb, block_len).max(axis=1)

    # -- query side: stack with global numbering -----------------------------
    l_pad = pad_leaf_count(n_leaves, q_per_kv)
    q_tokens = np.zeros(l_pad, dtype=np.int32)
    q_pos = np.zeros(l_pad, dtype=np.int32)
    out_loc = np.zeros(l_pad, dtype=np.int32)
    for p, off in zip(plans, leaf_offsets):
        n = p.n_leaves
        q_tokens[off : off + n] = p.q_tokens[:n]
        q_pos[off : off + n] = p.q_pos[:n]
        out_loc[off : off + n] = p.out_loc[:n]

    plan = FlattenPlan(
        kv_idx=kv_idx,
        tok_lo=tok_lo,
        tok_hi=tok_hi,
        blk_lo=blk_lo,
        blk_hi=blk_hi,
        q_tokens=q_tokens,
        q_pos=q_pos,
        out_loc=out_loc,
        n_tokens=n_tokens,
        n_leaves=n_leaves,
        block_len=block_len,
        seg_src=seg_src,
        seg_len=seg,
        paged=paged,
    )
    plan.leaf_offsets = leaf_offsets  # type: ignore[attr-defined]
    return plan


def build_multi_seq_plan(
    trees: Sequence[TreeCache],
    q_per_kv: int,
    block_len: int = 128,
    min_token_bucket: int = 1024,
    seg_len=(128, 32),
    want_paged: bool = True,
    waste_limit: float = 2.5,
) -> SeqPlan:
    """Batched sequential-baseline plan: every tree's leaves stack into one
    global row set (numbering identical to build_multi_flatten_plan's, so
    BatchedEngine row windows work unchanged).  The seq baseline is per-leaf
    by construction — rows from different trees are independent — so
    batching is pure row concatenation; only the per-leaf path length
    (c_pad) and DMA segment length must be unified across trees."""
    assert trees
    candidates = (seg_len,) if isinstance(seg_len, int) else tuple(seg_len)
    if not want_paged:
        candidates = ()
    plans: List[SeqPlan] = []
    for cand in candidates + (None,):
        plans = [build_seq_plan(
            t, q_per_kv,
            block_len=block_len,
            min_token_bucket=block_len,  # tight per-tree; unified below
            seg_len=cand if cand is not None else (),
            want_paged=cand is not None,
            waste_limit=waste_limit,
        ) for t in trees]
        if cand is None or all(p.paged for p in plans):
            break
    paged = all(p.paged for p in plans)
    seg = plans[0].seg_len if paged else 0

    leaf_offsets = []
    off = 0
    for p in plans:
        leaf_offsets.append(off)
        off += p.n_leaves
    n_leaves = off
    l_pad = pad_leaf_count(n_leaves, q_per_kv)
    c_pad = pad_token_count(max(p.c_pad for p in plans), block_len,
                            min_token_bucket)

    q_tokens = np.zeros(l_pad, dtype=np.int32)
    q_pos = np.zeros(l_pad, dtype=np.int32)
    out_loc = np.full(l_pad, DUMP_SLOT, dtype=np.int32)
    seq_lens = np.zeros(l_pad, dtype=np.int32)
    for p, o in zip(plans, leaf_offsets):
        n = p.n_leaves
        q_tokens[o:o + n] = p.q_tokens[:n]
        q_pos[o:o + n] = p.q_pos[:n]
        out_loc[o:o + n] = p.out_loc[:n]
        seq_lens[o:o + n] = p.seq_lens[:n]
    total_kv = sum(p.total_kv for p in plans)

    if paged:
        nseg_tot = c_pad // seg
        nb = c_pad // block_len
        seg_src = np.zeros((l_pad, nseg_tot), dtype=np.int32)
        seg_off = np.zeros((l_pad, nseg_tot), dtype=np.int32)
        seg_live = np.zeros((l_pad, nseg_tot), dtype=np.int32)
        blk_live = np.zeros((l_pad, nb), dtype=np.int32)
        for p, o in zip(plans, leaf_offsets):
            n = p.n_leaves
            w = p.c_pad // seg
            seg_src[o:o + n, :w] = p.seg_src.reshape(p.l_pad, w)[:n]
            seg_off[o:o + n, :w] = p.seg_off.reshape(p.l_pad, w)[:n]
            seg_live[o:o + n, :w] = p.seg_live.reshape(p.l_pad, w)[:n]
            wb = p.c_pad // block_len
            blk_live[o:o + n, :wb] = p.blk_live.reshape(p.l_pad, wb)[:n]
        plan = SeqPlan(
            paths=np.empty((l_pad, 0), dtype=np.int32),
            seq_lens=seq_lens,
            q_tokens=q_tokens,
            q_pos=q_pos,
            out_loc=out_loc,
            n_leaves=n_leaves,
            total_kv=total_kv,
            seg_src=seg_src.reshape(-1),
            seg_off=seg_off.reshape(-1),
            seg_live=seg_live.reshape(-1),
            blk_live=blk_live.reshape(-1),
            seg_len=seg,
            paged=True,
            _c_pad=c_pad,
        )
        plan.leaf_offsets = leaf_offsets  # type: ignore[attr-defined]
        return plan

    paths = np.full((l_pad, c_pad), DUMP_SLOT, dtype=np.int32)
    for p, o in zip(plans, leaf_offsets):
        n = p.n_leaves
        paths[o:o + n, :p.c_pad] = p.paths[:n]
    plan = SeqPlan(
        paths=paths,
        seq_lens=seq_lens,
        q_tokens=q_tokens,
        q_pos=q_pos,
        out_loc=out_loc,
        n_leaves=n_leaves,
        total_kv=total_kv,
    )
    plan.leaf_offsets = leaf_offsets  # type: ignore[attr-defined]
    return plan
