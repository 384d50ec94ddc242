"""Port of deft_tpu/plan/flatten.py:314 (build_flatten_plan): a copy, with the same
behaviour, owned by deft_tpu_torch.

DeFT-Flatten attention plan, TPU formulation.

The reference flattens the tree's KV into fixed 128-token blocks carrying a
per-token int64 query bitmask and splits each block's query set into <=32-query
"partials" combined by a two-stage atomic LSE reduction
(DeFT's deft/tree_decoding/tree_cache.py:591-881,
tree_attention.py:296-548).

Here the same KV-guided, load-balanced partitioning is expressed without
bitmasks or atomics:

- Tree KV slots are laid out in **DFS node order** (the flatten order the
  reference's dfs() produces is the same sequence, chopped every 128 tokens).
- Leaves (queries) are numbered in **DFS order**, so each node's descendant
  leaves form a contiguous interval [lo, hi).  Per token we record the
  owning node's (lo, hi): "query q attends token t" == lo[t] <= q < hi[t].
- The kernel is then one flash-attention pass over (q tile) x (kv block)
  with a range mask, skipping any (tile, block) pair whose leaf intervals
  don't intersect — IO-equivalent to the reference's KV-guided grouping
  (each KV block is read once per 32-leaf query group that attends it),
  with the LSE combination done by the online softmax in VMEM instead of a
  second atomic kernel pass.

**DMA segment tables** (``seg_src``): when ``seg_len`` is set, every
pool-contiguous KV run is padded to a seg_len multiple in the flattened
layout, so each seg_len-token segment of every block is one contiguous
(seg_len, head_dim) span in the KV pool.  The paged Pallas kernel
(ops/paged_flatten_attn.py) then gathers KV HBM->VMEM with one async DMA
per segment — 1x KV IO, no XLA gather materialization.  Pads carry empty
leaf intervals, so the over-read garbage is masked.  ``paged`` is False
(and the layout falls back to tight packing) when the tree is too
fragmented for segment alignment to pay (e.g. hundreds of 1-token
speculative-decoding leaves) — the runner then uses the gather kernel.

All arrays are numpy, padded to bucketed static shapes (see plan.padding):
the jitted decode step's signature depends only on the buckets.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from deft_tpu_torch.core.kv_pool import DUMP_SLOT
from deft_tpu_torch.core.tree import TreeCache, TreeNode
from deft_tpu_torch.plan.padding import pad_leaf_count, pad_token_count

# Sentinel for "block attends nobody" (padding): empty interval.
_EMPTY_LO = np.int32(2**30)

# blk_lo sentinel for mask-free FULL blocks (every token live with interval
# [0, n_leaves)).  Large-magnitude negative: the mesh engine shifts blk_lo
# by the dp shard's leaf base (parallel/engine.py shift_window), so a small
# sentinel like -1 would collide with boundary-straddling blocks' shifted
# values — the kernels therefore test `< -(1 << 20)`, which bounded shifts
# (|shift| <= max leaves) can never reach.
FULL_BLOCK_LO = np.int32(-(1 << 24))

# Max flattened-layout inflation tolerated for DMA segment alignment before
# falling back to tight packing + gather kernel.
_SEG_WASTE_LIMIT = 1.5


@dataclasses.dataclass
class FlattenPlan:
    """Static-shape device plan for one tree-decode step."""

    # KV side, DFS order, padded to T_pad (multiple of block_len):
    kv_idx: np.ndarray      # (T_pad,) int32 pool slots (pad -> DUMP_SLOT)
    tok_lo: np.ndarray      # (T_pad,) int32 leaf-interval lo (pad -> 2^30)
    tok_hi: np.ndarray      # (T_pad,) int32 leaf-interval hi (pad -> 0)
    blk_lo: np.ndarray      # (B,) int32 per-block min lo (tile-skip bound;
    #                         FULL_BLOCK_LO = mask-free FULL block, tested
    #                         via threshold blk_lo < -(1<<20), not equality)
    blk_hi: np.ndarray      # (B,) int32 per-block max hi
    # Query side, DFS leaf order, padded to L_pad:
    q_tokens: np.ndarray    # (L_pad,) int32 last token id per leaf
    q_pos: np.ndarray       # (L_pad,) int32 RoPE position of that token
    out_loc: np.ndarray     # (L_pad,) int32 pool slot for the new K/V
    # True sizes (static python ints for the host; not traced):
    n_tokens: int           # live tree KV tokens
    n_leaves: int
    block_len: int
    # DMA segment table: (B * block_len/seg_len,) int32 pool address of each
    # segment's first token; None when not segment-aligned.
    seg_src: Optional[np.ndarray] = None
    seg_len: int = 0
    paged: bool = False     # eligible for the in-kernel DMA gather path
    # Compact upload form (paged plans): (R, 4) int32 rows
    # [layout_off, pool_src, lo, hi] covering [0, n_live_pad) — kv_idx,
    # tok_lo/hi, seg_src and blk arrays are all re-derivable from this
    # table + the tail rule (see _fill with_runs / runner unpack).
    run_table: Optional[np.ndarray] = None
    n_live_pad: int = 0     # tokens covered by runs (seg-aligned layout end)

    @property
    def t_pad(self) -> int:
        return int(self.kv_idx.shape[0])

    @property
    def l_pad(self) -> int:
        return int(self.q_tokens.shape[0])

    @property
    def num_blocks(self) -> int:
        return self.t_pad // self.block_len


def _leaf_arrays(
    tree: TreeCache,
    order: List[TreeNode],
    leaf_to_q,
    l_pad: int,
):
    q_tokens = np.zeros(l_pad, dtype=np.int32)
    q_pos = np.zeros(l_pad, dtype=np.int32)
    out_loc = np.full(l_pad, DUMP_SLOT, dtype=np.int32)
    for node in order:
        if not node.children:
            q = leaf_to_q[node.id]
            q_tokens[q] = node.token_ids[-1]
            q_pos[q] = node.positions[-1]
            out_loc[q] = node.kv_indices[-1]
    return q_tokens, q_pos, out_loc


def _assemble(
    order, lo_arr, hi_arr, block_len, node_aligned, seg_len,
    chunk_len: Optional[int] = None, runs_of=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """O(runs) assembly from each node's incrementally-maintained pool runs
    (TreeNode.kv_runs): pass 1 sizes the layout (_layout), pass 2 fills
    preallocated arrays with vectorized slice writes (_fill) — this is the
    per-step host hot path (the reference's per-step python DFS + block
    packing costs ~1-2 ms, SURVEY.md §3.3).  Seg-candidate selection calls
    _layout alone (waste/alignment checks need only the layout), paying the
    fill once for the chosen candidate.

    chunk_len (node_chunk mode, reference MAX_BLOCK_LEN) splits each node's
    runs at chunk_len boundaries and block-pads after every chunk, so no
    kernel block spans more than chunk_len tokens of one node.  With
    chunk_len == block_len this coincides with plain node alignment (the
    reference's default node_chunk setting, run_DeFT_llama_paged.py:146-150);
    smaller chunks buy nothing on TPU (the grid is already block-tiled) and
    cost padding — that cost is made visible, not hidden.

    Coalescing (flatten mode, seg_len > 0): consecutive DFS extents that are
    POOL-contiguous merge into one DMA run before seg padding — masks are
    per-token, so a segment may span nodes.  This is what keeps speculative
    decoding seg-aligned: with group-allocated leaf slots
    (TokenKVPool.alloc_group) the w single-token leaves collapse into one
    w-token run instead of w segments padded seg_len-to-1."""
    groups, total = _layout(order, lo_arr, hi_arr, block_len, node_aligned,
                            seg_len, chunk_len, runs_of)
    return _fill(groups, total, seg_len)


def _layout(order, lo_arr, hi_arr, block_len, node_aligned, seg_len,
            chunk_len: Optional[int] = None, runs_of=None):
    """Pass 1 of _assemble: group the DFS extents and size the layout.
    Returns (groups, total) where groups = [(extents, pad)] with extents a
    list of pool-CONTIGUOUS (ps, pn, lo, hi) pieces (None for node-align
    block pads).  ``runs_of(node)`` overrides the per-node pool-run source
    (default: the incrementally-maintained TreeNode.kv_runs) — tree_index
    mode derives runs from TreeIndexPool rows instead."""
    groups: List[Tuple[Optional[List[Tuple[int, int, int, int]]], int]] = []
    total = 0
    cur: List[Tuple[int, int, int, int]] = []
    cur_n = 0
    coalesce = bool(seg_len) and not node_aligned

    def flush():
        nonlocal cur, cur_n, total
        if not cur:
            return
        pad = (-cur_n) % seg_len if seg_len else 0
        groups.append((cur, pad))
        total += cur_n + pad
        cur, cur_n = [], 0

    for i, node in enumerate(order):
        if node.kv_len == 0:
            continue
        lo, hi = int(lo_arr[i]), int(hi_arr[i])
        for start, n in (runs_of(node) if runs_of is not None
                         else node.kv_runs):
            pieces = (
                [(start + o, min(chunk_len, n - o))
                 for o in range(0, n, chunk_len)]
                if chunk_len else [(start, n)]
            )
            for ps, pn in pieces:
                if cur and (
                    not coalesce or cur[-1][0] + cur[-1][1] != ps
                ):
                    flush()
                cur.append((ps, pn, lo, hi))
                cur_n += pn
                if chunk_len and node_aligned:
                    flush()
                    # always emit the boundary marker (even at pad 0):
                    # _align_groups recomputes these pads after lead-in
                    # insertion, and a spot that needs no pad NOW may
                    # need one once earlier groups shift
                    padb = (-total) % block_len
                    groups.append((None, padb))
                    total += padb
        if node_aligned:
            flush()
            padb = (-total) % block_len
            groups.append((None, padb))
            total += padb
    flush()
    return groups, total


def _align_groups(groups, seg_len, pool_size, block_len: int = 0):
    """Cover groups whose base is not seg-aligned with a dead LEAD-IN: the
    run reads from the aligned base below it, the extra tokens carry empty
    leaf intervals and are masked in-kernel (the flatten analog of
    plan/seq.py's seg_off covers).  Batched admission packs prompts
    back-to-back in the pool, so later requests' runs routinely start
    mid-segment — without this every such tree fell off the paged path.

    block_len > 0 (node-aligned layouts): lead-ins shift later offsets by a
    non-block multiple, so the (None, pad) block pads _layout sized are
    RECOMPUTED from the post-alignment running total — otherwise a seg_len <
    block_len lead-in silently let later blocks mix nodes (output stayed
    exact; the DeFT-Node "no block mixes nodes" grouping property did not).
    Returns (groups, total, in_bounds)."""
    out = []
    total = 0
    ok = True
    for extents, pad in groups:
        if extents is None:
            if block_len:
                pad = (-total) % block_len
            if pad:
                out.append((extents, pad))
                total += pad
            continue
        base = extents[0][0]
        off = base % seg_len
        if off:
            extents = [(base - off, off, _EMPTY_LO, 0)] + extents
        n = sum(pn for _, pn, _, _ in extents)
        pad = (-n) % seg_len
        if base - off + n + pad > pool_size:
            ok = False
        out.append((extents, pad))
        total += n + pad
    return out, total, ok


def _fill(groups, total, seg_len, with_runs: bool = False):
    """Pass 2 of _assemble: materialize (kv_idx, tok_lo, tok_hi) from the
    layout with vectorized slice writes.

    with_runs=True additionally returns the layout as a RUN TABLE — one
    (layout_offset, pool_src, lo, hi) row per linear-address piece, covering
    [0, total) exactly (kv_idx[off + i] == src + i within each run).  The
    runner's compact plan upload ships this O(runs) table instead of the
    O(tokens) per-token arrays and re-expands them on device
    (runtime/runner.py unpack) — decisive when the host<->device link is
    slow, and strictly less upload traffic always."""
    kv = np.empty(total, dtype=np.int32)
    lo_a = np.empty(total, dtype=np.int32)
    hi_a = np.empty(total, dtype=np.int32)
    runs: List[Tuple[int, int, int, int]] = [] if with_runs else None
    pos = 0
    for extents, pad in groups:
        if extents is None:
            if seg_len:
                # seg-tiled scratch reads keep segments contiguous; block
                # pads start seg-aligned with seg-multiple length (group
                # pads close every group on a seg boundary), so each
                # seg-length slice is one linear run from scratch base 0
                kv[pos : pos + pad] = np.arange(pad, dtype=np.int32) % seg_len
                if with_runs:
                    for k in range(0, pad, seg_len):
                        runs.append((pos + k, 0, _EMPTY_LO, 0))
            else:
                kv[pos : pos + pad] = DUMP_SLOT
                if with_runs:
                    runs.append((pos, DUMP_SLOT, _EMPTY_LO, 0))
            lo_a[pos : pos + pad] = _EMPTY_LO
            hi_a[pos : pos + pad] = 0
            pos += pad
            continue
        for ps, pn, lo, hi in extents:
            kv[pos : pos + pn] = np.arange(ps, ps + pn, dtype=np.int32)
            lo_a[pos : pos + pn] = lo
            hi_a[pos : pos + pn] = hi
            if with_runs:
                runs.append((pos, ps, lo, hi))
            pos += pn
        if pad:
            # addresses the segment DMA over-reads; masked out
            end = extents[-1][0] + extents[-1][1]
            kv[pos : pos + pad] = np.arange(end, end + pad, dtype=np.int32)
            lo_a[pos : pos + pad] = _EMPTY_LO
            hi_a[pos : pos + pad] = 0
            if with_runs:
                runs.append((pos, end, _EMPTY_LO, 0))
            pos += pad
    assert pos == total
    if with_runs:
        return kv, lo_a, hi_a, runs
    return kv, lo_a, hi_a


def build_flatten_plan(
    tree: TreeCache,
    q_per_kv: int,
    block_len: int = 128,
    min_token_bucket: int = 1024,
    node_aligned: bool = False,
    chunk_len: Optional[int] = None,
    seg_len=(128, 32),
    pow2_bucket: bool = True,
    granularity: int = 512,
    waste_limit: float = _SEG_WASTE_LIMIT,
    runs_of=None,
    min_leaf_bucket: int = 0,
) -> FlattenPlan:
    """Build the flatten plan for the current tree state.

    Must be called *after* TreeCache.alloc() for the step, so each leaf's
    newest KV slot (this step's token) is part of the plan and the leaf
    attends its own current token.

    node_aligned=True gives the DeFT-Node variant: each node's KV run is
    padded up to a block boundary so no 128-token block mixes nodes —
    the node-granularity KV-guided grouping of the reference's
    TREE_DECODE_NODE mode (tree_attention.py:169-293), at the cost of
    padding waste on small nodes.  chunk_len (node_chunk mode) additionally
    splits node runs at chunk_len boundaries with block padding per chunk
    (see _assemble).

    seg_len turns on DMA segment alignment (see module docstring); it is
    dropped automatically when too wasteful or when a segment would read
    past the pool end.
    """
    order, leaf_to_q, lo_arr, hi_arr = tree.dfs_plan_order()
    n_leaves = len(tree.leaves)
    # min_leaf_bucket: monotonic floor from the runner — leaf-count
    # oscillation (branch/prune cycles) otherwise flips l_pad between
    # pow2 buckets, and every bucket flip switches the compiled
    # executable, which costs a full pool relayout copy per switch
    # (~300 ms at 8B; runner.build_plan bucket floors)
    l_pad = max(pad_leaf_count(n_leaves, q_per_kv), min_leaf_bucket)
    live_tokens = sum(n.kv_len for n in order)

    # Candidate segment lengths, best (fewest DMA descriptors) first; fall
    # back to tight packing + gather kernel when none fits the waste limit
    # or alignment (e.g. recycled-single fallbacks, tiny spec-decode leaves).
    if seg_len is None:
        candidates = ()
    elif isinstance(seg_len, int):
        candidates = (seg_len,)
    else:
        candidates = tuple(seg_len)
    pool_size = tree.token_to_kv_pool.size
    # Seg-alignment waste is judged against what the layout would cost
    # WITHOUT segments: for node-aligned plans that's the block-padded
    # total (node granularity's inherent padding is the mode's honest
    # cost, not seg overhead — else small-node trees never go paged and
    # fall to the gather kernel), for flat plans the live token count.
    if candidates and node_aligned:
        _, waste_base = _layout(order, lo_arr, hi_arr, block_len,
                                node_aligned, 0, chunk_len, runs_of)
        waste_base = max(waste_base, 1)
    else:
        waste_base = max(live_tokens, 1)
    # waste_limit may be per-candidate (tuple aligned with seg_len): wide
    # segments amortize DMA descriptors but read their padding, so they
    # are only worth taking when nearly free (int8 pools use this — the
    # per-segment scale DMAs double the descriptor count)
    if not isinstance(waste_limit, (tuple, list)):
        waste_limit = (waste_limit,) * len(candidates)
    assert len(waste_limit) == len(candidates)
    seg = 0
    for cand, wlim in zip(candidates, waste_limit):
        if block_len % cand != 0:
            # e.g. CLI --block_len 64 with default candidates (128, 32):
            # skip non-dividing candidates, fall back to gather if none fit
            continue
        # layout only — the O(tokens) array fill runs once, for the chosen
        # candidate (or the gather fallback), not per rejected candidate
        groups, total = _layout(
            order, lo_arr, hi_arr, block_len, node_aligned, cand, chunk_len,
            runs_of,
        )
        # every non-pad group is ONE pool-contiguous run whose segments
        # read [aligned_base, base + n + pad): misaligned bases (batched
        # admission packs prompts back-to-back) get a dead aligned lead-in
        # (Mosaic: DMA row offsets must respect the sublane tiling), and
        # the padded cover must stay in-bounds
        groups, total, in_bounds = _align_groups(
            groups, cand, pool_size,
            block_len=block_len if node_aligned else 0,
        )
        ok = in_bounds and total <= wlim * waste_base
        if ok:
            seg = cand
            kv_idx, tok_lo, tok_hi, runs = _fill(groups, total, cand,
                                                 with_runs=True)
            break
    if not seg:
        kv_idx, tok_lo, tok_hi = _assemble(
            order, lo_arr, hi_arr, block_len, node_aligned, 0, chunk_len,
            runs_of,
        )

    n_tokens = int(kv_idx.shape[0])
    t_pad = pad_token_count(n_tokens, block_len, min_token_bucket,
                            pow2=pow2_bucket, granularity=granularity)
    pad = t_pad - n_tokens
    if pad:
        # tail pads read the reserved scratch area [1, 1+seg) so every
        # segment stays contiguous and in-bounds (fully-dead blocks are
        # skipped by the kernel anyway)
        if seg:
            tail = np.arange(pad, dtype=np.int32) % seg
        else:
            tail = np.full(pad, DUMP_SLOT, dtype=np.int32)
        kv_idx = np.concatenate([kv_idx, tail])
        tok_lo = np.concatenate([tok_lo, np.full(pad, _EMPTY_LO, np.int32)])
        tok_hi = np.concatenate([tok_hi, np.zeros(pad, dtype=np.int32)])

    nb = t_pad // block_len
    blk_lo = tok_lo.reshape(nb, block_len).min(axis=1)
    blk_hi = tok_hi.reshape(nb, block_len).max(axis=1)
    # FULL-block sentinel (blk_lo = FULL_BLOCK_LO): every token in the block
    # is live with interval [0, n_leaves) — the shared tree prefix, the bulk
    # of dense trees — so the kernel's mask is provably all-true for every
    # live row and the paged kernels skip the mask build + where pass
    # entirely (ops/paged_flatten_attn.py update_heads masked=False).
    # blk_lo's other consumers only do live checks (negative < blk_hi) and
    # the narrow-window start (clipped to >= 0), both sentinel-safe;
    # multi-tree plans recompute blk arrays from the offset tok arrays and
    # never inherit the sentinel (a batched block is never all-leaves-full).
    if n_leaves > 0:
        full = ((tok_lo.reshape(nb, block_len) == 0).all(axis=1)
                & (tok_hi.reshape(nb, block_len) == n_leaves).all(axis=1))
        blk_lo = np.where(full, FULL_BLOCK_LO, blk_lo)

    seg_src = None
    paged = False
    run_table = None
    n_live_pad = 0
    if seg:
        view = kv_idx.reshape(-1, seg)
        if bool(np.all(np.diff(view, axis=1) == 1)):
            seg_src = np.ascontiguousarray(view[:, 0])
            paged = True
            run_table = np.asarray(runs, dtype=np.int32).reshape(-1, 4)
            n_live_pad = n_tokens  # pre-bucket layout length (seg-aligned)

    q_tokens, q_pos, out_loc = _leaf_arrays(tree, order, leaf_to_q, l_pad)
    return FlattenPlan(
        kv_idx=kv_idx,
        tok_lo=tok_lo,
        tok_hi=tok_hi,
        blk_lo=blk_lo,
        blk_hi=blk_hi,
        q_tokens=q_tokens,
        q_pos=q_pos,
        out_loc=out_loc,
        n_tokens=live_tokens,
        n_leaves=n_leaves,
        block_len=block_len,
        seg_src=seg_src,
        seg_len=seg if paged else 0,
        paged=paged,
        run_table=run_table,
        n_live_pad=n_live_pad,
    )
