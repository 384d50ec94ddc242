"""Port of deft_tpu/core/page_table.py:17 (ReqToTokenPool): a copy, with the same
behaviour, owned by deft_tpu_torch.

Per-leaf page table: request slot -> KV slot indices of the leaf's full
root-to-leaf token path.

Capability parity with ReqToTokenPool
(DeFT's deft/memory_pool.py:11-45).  Host numpy; the sequential
(flash-decoding) baseline plan reads rows out of this table to build its
per-leaf KV gather lists without re-walking the tree each step.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class ReqToTokenPool:
    def __init__(self, size: int, max_context_len: int):
        self.size = size
        self.max_context_len = max_context_len
        self.req_to_token = np.zeros((size, max_context_len), dtype=np.int32)
        self._free = list(range(size - 1, -1, -1))

    def alloc(self, need_size: int = 1) -> Optional[np.ndarray]:
        if need_size > len(self._free):
            return None
        out = np.array([self._free.pop() for _ in range(need_size)], dtype=np.int32)
        return out

    def free(self, req_idx: int) -> None:
        self._free.append(int(req_idx))

    def copy(self, src_req: int, dst_req: int, length: int) -> None:
        """Duplicate a path prefix onto a new request row (branch op)."""
        self.req_to_token[dst_req, :length] = self.req_to_token[src_req, :length]

    def available_size(self) -> int:
        return len(self._free)

    def clear(self) -> None:
        self._free = list(range(self.size - 1, -1, -1))
