"""Port of deft_tpu/plan/seq.py:102 (build_seq_plan): a copy, with the same
behaviour, owned by deft_tpu_torch.

Sequential (per-leaf) decode plan — the Flash-Decoding / Radix-Attention
baseline the reference compares against (token_attention.py, ForwardMode
DECODE): every leaf attends its own root-to-leaf KV path independently, so a
shared prefix is re-read once per leaf.  Paths come straight out of the
incremental ReqToTokenPool page table (no tree walk per step).

Fair-baseline requirement (the comparison the reference makes): the baseline
kernel must read paged KV **in-kernel** from the pool — the reference's
token_attention gathers per-token KV inside the Triton kernel
(DeFT's deft/layers/attention/token_attention.py:80-150).
Materializing a padded dense per-leaf KV copy via XLA first (the gather
fallback here) costs ~3x the true baseline IO and would inflate the
flatten-vs-seq speedup.  So this builder also emits per-leaf **DMA segment
tables** (same machinery as plan/flatten.py): each leaf's path is the
concatenation of its ancestor nodes' pool-contiguous kv_runs; every run is
padded to a ``seg_len`` multiple so each seg_len-token span of the padded
path is one contiguous pool read.  The paged kernel
(ops/paged_seq_attn.py) then DMAs the path HBM->VMEM directly — 1x the
baseline's defining per-leaf KV IO, no XLA gather materialization.

A segment's live tokens are one contiguous span [seg_off, seg_off+seg_live)
inside it (two ints per segment instead of a per-token mask): segment
sources are always tile-ALIGNED pool rows — a run starting mid-segment is
covered by its enclosing aligned segment with the lead-in masked — because
Mosaic DMA row offsets must respect the sublane tiling.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from deft_tpu_torch.core.kv_pool import DUMP_SLOT
from deft_tpu_torch.core.tree import TreeCache
from deft_tpu_torch.plan.padding import pad_leaf_count, pad_token_count

# Max padded-path inflation tolerated for DMA segment alignment before
# falling back to the XLA-gather kernel (deep trees of tiny nodes).  The
# gather fallback costs ~3x the true baseline IO plus a materialized copy,
# so paged-with-padding stays the FAIRER (faster) baseline well past 1.5x
# (deft_tpu's value, chosen on a TPU from set128ToT's fragmented replay
# paths; kept so both packages build the same plans).
_SEG_WASTE_LIMIT = 2.5


@dataclasses.dataclass
class SeqPlan:
    paths: np.ndarray       # (L_pad, C_pad) int32 KV slots per leaf path
    seq_lens: np.ndarray    # (L_pad,) int32 true path lengths (pad -> 0)
    q_tokens: np.ndarray    # (L_pad,) int32
    q_pos: np.ndarray       # (L_pad,) int32
    out_loc: np.ndarray     # (L_pad,) int32
    n_leaves: int
    total_kv: int           # sum of true path lengths (the baseline's KV IO)
    # Paged-kernel DMA tables; None when not segment-aligned (gather path).
    # Every segment source is seg-aligned (Mosaic DMA row offsets must
    # respect the sublane tiling); a run starting mid-segment is covered by
    # the enclosing aligned segment with its live span recorded as
    # (seg_off leading offset, seg_live count) — garbage rows on both sides
    # are masked in-kernel.
    seg_src: Optional[np.ndarray] = None   # (L_pad * C_pad/seg,) int32
    seg_off: Optional[np.ndarray] = None   # (L_pad * C_pad/seg,) int32
    seg_live: Optional[np.ndarray] = None  # (L_pad * C_pad/seg,) int32
    blk_live: Optional[np.ndarray] = None  # (L_pad * C_pad/block,) int32
    seg_len: int = 0
    paged: bool = False

    @property
    def l_pad(self) -> int:
        return int(self.seq_lens.shape[0])

    @property
    def c_pad(self) -> int:
        return int(self.paths.shape[1]) if self.paths.ndim == 2 and \
            self.paths.shape[1] else self._c_pad

    _c_pad: int = 0


def _leaf_chain_runs(tree: TreeCache, leaf):
    """Pool-contiguous (start, len) runs of the leaf's root-to-leaf path."""
    chain = []
    cur = leaf
    while cur is not None:
        chain.append(cur)
        cur = cur.parent
    chain.reverse()
    runs = []
    for node in chain:
        for s, n in node.kv_runs:
            # merge across node boundaries when pool-adjacent (a branch's
            # first child often continues right after its parent's slots)
            if runs and runs[-1][0] + runs[-1][1] == s:
                runs[-1][1] += int(n)
            else:
                runs.append([int(s), int(n)])
    return [(s, n) for s, n in runs]


def build_seq_plan(
    tree: TreeCache,
    q_per_kv: int,
    block_len: int = 128,
    min_token_bucket: int = 1024,
    seg_len=(128, 32),
    want_paged: bool = True,
    waste_limit: float = _SEG_WASTE_LIMIT,
    min_leaf_bucket: int = 0,
) -> SeqPlan:
    """Call after TreeCache.alloc() (same contract as build_flatten_plan).

    want_paged=True attempts the DMA segment layout (in-kernel paged reads);
    when alignment or the waste limit fails — or want_paged=False (XLA
    backend) — the dense ``paths`` gather table is built instead.
    """
    assert tree.req_to_token_pool is not None
    leaves = sorted(tree.leaves.values(), key=lambda x: x.id)
    # q numbering matches the DFS convention used everywhere else.
    _, leaf_to_q, _, _ = tree.dfs_plan_order()
    n_leaves = len(leaves)
    l_pad = max(pad_leaf_count(n_leaves, q_per_kv),
                min_leaf_bucket)  # monotonic floor, see flatten

    q_tokens = np.zeros(l_pad, dtype=np.int32)
    q_pos = np.zeros(l_pad, dtype=np.int32)
    out_loc = np.full(l_pad, DUMP_SLOT, dtype=np.int32)
    seq_lens = np.zeros(l_pad, dtype=np.int32)
    total_kv = 0
    for leaf in leaves:
        q = leaf_to_q[leaf.id]
        path_len = leaf.positions[-1] + 1
        seq_lens[q] = path_len
        q_tokens[q] = leaf.token_ids[-1]
        q_pos[q] = leaf.positions[-1]
        out_loc[q] = leaf.kv_indices[-1]
        total_kv += path_len

    # -- paged layout: per-leaf seg tables --------------------------------------
    if want_paged:
        candidates = (seg_len,) if isinstance(seg_len, int) else tuple(seg_len)
        pool_size = tree.token_to_kv_pool.size
        leaf_runs = {leaf.id: _leaf_chain_runs(tree, leaf) for leaf in leaves}
        scored = []  # (padded_total, -seg, seg, max_padded)
        for seg in candidates:
            if seg <= 0 or block_len % seg != 0:
                continue
            ok = True
            max_padded = 0
            padded_total = 0
            for leaf in leaves:
                padded = 0
                for start, n in leaf_runs[leaf.id]:
                    # runs need NOT be seg-aligned (spec-decode leaves own
                    # 1-token runs at arbitrary offsets): they are covered
                    # by the enclosing ALIGNED segments, with the leading
                    # offset masked in-kernel; only covers past the pool
                    # end are disallowed
                    off0 = start % seg
                    nseg_run = -(-(off0 + n) // seg)
                    if (start - off0) + nseg_run * seg > pool_size:
                        ok = False
                        break
                    padded += nseg_run * seg
                if not ok:
                    break
                padded_total += padded
                max_padded = max(max_padded, padded)
            if not ok or padded_total > waste_limit * max(total_kv, 1):
                continue
            scored.append((padded_total, -seg, seg, max_padded))
        # least padding wins (the baseline must not read more KV than it has
        # to); ties prefer the larger segment (fewer DMA descriptors)
        for _, _, seg, max_padded in sorted(scored)[:1]:
            c_pad = pad_token_count(max_padded, block_len, min_token_bucket)
            nseg_tot = c_pad // seg
            seg_src = np.zeros((l_pad, nseg_tot), dtype=np.int32)
            seg_off = np.zeros((l_pad, nseg_tot), dtype=np.int32)
            seg_live = np.zeros((l_pad, nseg_tot), dtype=np.int32)
            for leaf in leaves:
                q = leaf_to_q[leaf.id]
                j = 0
                for start, n in leaf_runs[leaf.id]:
                    off = start % seg
                    astart = start - off
                    rem = n
                    while rem > 0:
                        cnt = min(seg - off, rem)
                        seg_src[q, j] = astart
                        seg_off[q, j] = off
                        seg_live[q, j] = cnt
                        astart += seg
                        rem -= cnt
                        off = 0
                        j += 1
            spb = block_len // seg  # segments per block
            blk_live = (
                seg_live.reshape(l_pad, c_pad // block_len, spb).sum(axis=2)
                > 0
            ).astype(np.int32)
            return SeqPlan(
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

    # -- gather fallback ---------------------------------------------------------
    max_len = max(int(s) for s in seq_lens)
    c_pad = pad_token_count(max_len, block_len, min_token_bucket)
    paths = np.full((l_pad, c_pad), DUMP_SLOT, dtype=np.int32)
    for leaf in leaves:
        q = leaf_to_q[leaf.id]
        path_len = int(seq_lens[q])
        req = tree.leaf_to_req[leaf.id]
        paths[q, :path_len] = tree.req_to_token_pool.req_to_token[req, :path_len]
    return SeqPlan(
        paths=paths,
        seq_lens=seq_lens,
        q_tokens=q_tokens,
        q_pos=q_pos,
        out_loc=out_loc,
        n_leaves=n_leaves,
        total_kv=total_kv,
    )
