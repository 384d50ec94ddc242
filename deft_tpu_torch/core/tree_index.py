"""Port of deft_tpu/core/tree_index.py:18 (TreeIndexPool): a copy, with the same
behaviour, owned by deft_tpu_torch.

Per-node contiguous KV-index rows.

Capability parity with TreeIndexPool
(DeFT's deft/tree_decoding/tree_index_pool.py:11-50): gives each
tree node a fixed row in a (size, max_context_len) int32 table so plan
builders can reference a node's KV indices as a contiguous (row, length) pair
instead of concatenating per-node index lists every decode step (the
reference's DeFT-Tree-Index mode, model_runner.py TREE_DECODE_INDEX_NODE).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class TreeIndexPool:
    def __init__(self, size: int, max_context_len: int):
        self.size = size
        self.max_context_len = max_context_len
        self.node_to_kv = np.zeros((size, max_context_len), dtype=np.int32)
        self._free = list(range(size - 1, -1, -1))

    def alloc(self, need_size: int = 1) -> Optional[np.ndarray]:
        if need_size > len(self._free):
            return None
        return np.array([self._free.pop() for _ in range(need_size)], dtype=np.int32)

    def free(self, row_id: int) -> None:
        self._free.append(int(row_id))

    def get_offset(self, row_id: int) -> int:
        """Flat offset of a node's row in the table (reference
        tree_index_pool.py:44-46: node_id * max_context_len)."""
        return int(row_id) * self.max_context_len

    def available_size(self) -> int:
        return len(self._free)

    def clear(self) -> None:
        """Release every row (fresh generation)."""
        self._free = list(range(self.size - 1, -1, -1))
