"""Port of deft_tpu/plan/node.py:27 (build_node_plan) and :50
(build_tree_index_plan): a copy, with the same behaviour, owned by
deft_tpu_torch.  Both plans go through the port's build_flatten_plan and
run on the flatten kernels (B1/B4 when segment-aligned, B6 otherwise).

DeFT-Node and Tree-Index plan variants.

Node mode (reference TREE_DECODE_NODE, tree_attention.py:169-293) groups
attention work by whole KV tree node; node_chunk caps a node's run at
MAX_BLOCK_LEN for load balancing.  Both reduce to the flatten plan with
node-aligned blocks: each kernel block holds tokens of exactly one node
(padded), so every block's query interval is uniform — the
node-granularity KV-guided grouping, with the padding waste being the honest
cost of node granularity on small nodes.

Tree-Index mode (reference TREE_DECODE_INDEX_NODE, tree_cache.py:883-1018)
avoids re-concatenating per-node KV index lists every step by keeping each
node's indices in a fixed TreeIndexPool row; the plan builder slices rows
instead of walking python lists.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from deft_tpu_torch.core.tree import TreeCache
from deft_tpu_torch.plan.flatten import FlattenPlan, build_flatten_plan


def build_node_plan(
    tree: TreeCache,
    q_per_kv: int,
    block_len: int = 128,
    min_token_bucket: int = 1024,
    chunk_len: Optional[int] = None,
    seg_len=(128, 32),
    waste_limit: float = 1.5,
    min_leaf_bucket: int = 0,
) -> FlattenPlan:
    return build_flatten_plan(
        tree,
        q_per_kv,
        block_len=block_len,
        min_token_bucket=min_token_bucket,
        node_aligned=True,
        chunk_len=chunk_len,
        seg_len=seg_len,
        waste_limit=waste_limit,
        min_leaf_bucket=min_leaf_bucket,
    )


def build_tree_index_plan(
    tree: TreeCache,
    q_per_kv: int,
    block_len: int = 128,
    min_token_bucket: int = 1024,
    seg_len=(128, 32),
    waste_limit: float = 1.5,
    min_leaf_bucket: int = 0,
) -> FlattenPlan:
    """Node-aligned plan whose KV indices come from TreeIndexPool rows.

    The defining property of the mode (reference TREE_DECODE_INDEX_NODE,
    tree_cache.py:883-1018, tree_index_pool.py:11-50) is that plan building
    slices each node's precomputed index-pool row instead of walking python
    lists.  Here each row is turned into pool-contiguous runs with one
    vectorized diff, then fed through build_flatten_plan's node-aligned
    layout + segment-table machinery — so tree_index plans are ``paged`` and
    ride the same paged kernels as node plans."""
    assert tree.tree_index_pool is not None, "tree_index mode needs a TreeIndexPool"
    pool = tree.tree_index_pool

    def runs_from_row(node) -> List[tuple]:
        n = node.kv_len
        if n == 0:
            return []
        assert node.node_index_row is not None
        idx = pool.node_to_kv[node.node_index_row, :n]
        cuts = np.flatnonzero(np.diff(idx) != 1) + 1
        starts = np.concatenate(([0], cuts))
        ends = np.concatenate((cuts, [n]))
        return [(int(idx[s]), int(e - s)) for s, e in zip(starts, ends)]

    return build_flatten_plan(
        tree,
        q_per_kv,
        block_len=block_len,
        min_token_bucket=min_token_bucket,
        node_aligned=True,
        seg_len=seg_len,
        waste_limit=waste_limit,
        runs_of=runs_from_row,
        min_leaf_bucket=min_leaf_bucket,
    )
