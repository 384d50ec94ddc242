"""Port of deft_tpu/core/kv_pool.py:28 (TokenKVPool): a copy, with the same
behaviour, owned by deft_tpu_torch.

Host-side token-granularity KV slot allocator with prefix-sharing refcounts.

Capability parity with the reference TokenToKVPool
(DeFT's deft/memory_pool.py:48-108), redesigned for TPU/JAX:

- The reference couples allocation with per-layer ``kv_data`` torch tensors
  mutated in place.  In JAX the device KV arrays are functional state owned by
  the model runner (donated through the jitted step); this class manages only
  the slot accounting on host.
- The reference's ``alloc`` does an O(pool) ``nonzero`` scan per step.  Here a
  bump pointer serves never-used slots first (keeping early allocations —
  notably the prompt — contiguous for coalesced TPU gathers), with freed slots
  recycled from a stack.
- Slot 0 is reserved as a scratch/"dump" slot so padded lanes in the jitted
  step can scatter garbage without corrupting live KV (the TPU analog of the
  reference's ``other_kv_index`` NaN guard, model_runner.py:116-123).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

DUMP_SLOT = 0


class TokenKVPool:
    """Slot allocator with two allocation paths:

    - ``alloc(n)``       — contiguous-first batch alloc (prompt prefill).
    - ``alloc_for(o, n)``— *chunked* per-owner alloc: each owner (a decoding
      leaf) reserves a private ``chunk``-slot span and fills it sequentially,
      so a leaf's appended KV is pool-contiguous in runs of up to ``chunk``
      tokens.  This is what lets the flatten plan's DMA segments
      (plan/flatten.py seg tables) read (SEG, head_dim) contiguous spans from
      HBM instead of per-token gathers — SURVEY.md §7 "hard parts" #3.

    Owners must be closed (``close_owner``) when they stop appending (leaf
    branched or cut); the unused tail of their open chunk is recycled as
    single slots.
    """

    # Top-of-pool DMA cover slack: the paged plans cover misaligned runs
    # with enclosing seg-aligned segments, which may READ up to seg-1 rows
    # past a run's end; the top COVER_SLACK rows are therefore never
    # allocated (an always-valid over-read target), so a run ending at the
    # pool's last allocatable slot still fits its cover — without this,
    # dense high-utilization pools dropped late-run plans off the paged
    # path (observed: int8 seq falling to the gather kernel mid-cell).
    COVER_SLACK = 128

    def __init__(self, size: int, chunk: int = 128,
                 cover_slack: int | None = None):
        if cover_slack is None:
            cover_slack = self.COVER_SLACK
        assert size > chunk + cover_slack
        self.size = size
        self._limit = size - cover_slack
        self.chunk = chunk
        self.refs = np.zeros(size, dtype=np.int32)
        # Slots [0, chunk) reserved: slot 0 is the DUMP scratch target and
        # the region serves as an always-valid DMA source for dead segments.
        # Starting the bump at a chunk boundary keeps every chunk (and hence
        # every DMA segment start) tile-aligned — Mosaic requires DMA row
        # offsets divisible by the sublane tiling.
        self._bump = chunk
        self._recycled: list[int] = []
        self._free_count = self._limit - chunk
        self._live = 0  # slots with refs > 0 (excludes reserved-unused)
        # owner id -> [next_slot, end_slot) of its open chunk
        self._open: dict[int, list] = {}
        # last alloc_group span [start, n) + ids of its slots freed since:
        # freed group slots are held back from _recycled so the NEXT
        # alloc_group can reuse the span in place once it is fully free —
        # without this, the speculative-decoding free-all/realloc-all cycle
        # consumes bump space monotonically (width slots per step, never
        # recycled into later groups)
        self._group_span: Optional[list] = None  # [start, n]
        self._group_freed: list[int] = []

    # -- queries -------------------------------------------------------------
    def available_size(self) -> int:
        return self._free_count

    def used_size(self) -> int:
        """Live (referenced) slots; reserved-but-unused chunk tails are
        neither used nor available until their owner closes."""
        return self._live

    # -- alloc / free ----------------------------------------------------------
    def alloc(self, need_size: int) -> Optional[np.ndarray]:
        """Allocate ``need_size`` slots (refcount 1 each); None if exhausted."""
        if need_size > self._free_count:
            return None
        out = np.empty(need_size, dtype=np.int32)
        n_bump = min(need_size, self._limit - self._bump)
        if n_bump > 0:
            out[:n_bump] = np.arange(self._bump, self._bump + n_bump, dtype=np.int32)
            self._bump += n_bump
        if n_bump < need_size:
            n_rec = need_size - n_bump
            out[n_bump:] = self._recycled[-n_rec:][::-1]
            del self._recycled[-n_rec:]
        self.refs[out] = 1
        self._free_count -= need_size
        self._live += need_size
        return out

    def alloc_for(self, owner: int, need_size: int = 1) -> Optional[np.ndarray]:
        """Allocate ``need_size`` slots from ``owner``'s open chunk(s)."""
        out = np.empty(need_size, dtype=np.int32)
        filled = 0
        while filled < need_size:
            span = self._open.get(owner)
            if span is None or span[0] == span[1]:
                if not self._open_chunk(owner):
                    # pool fragmented/full: fall back to recycled singles
                    rem = need_size - filled
                    if len(self._recycled) < rem:
                        # roll back slots consumed from this owner's chunks
                        if filled:
                            self._recycled.extend(int(x) for x in out[:filled])
                            self._free_count += filled
                        return None
                    out[filled:] = self._recycled[-rem:][::-1]
                    del self._recycled[-rem:]
                    self._free_count -= rem
                    filled = need_size
                    break
                continue
            take = min(need_size - filled, span[1] - span[0])
            out[filled : filled + take] = np.arange(
                span[0], span[0] + take, dtype=np.int32
            )
            span[0] += take
            filled += take
        self.refs[out] = 1
        self._live += need_size
        return out

    def alloc_group(self, need_size: int) -> Optional[np.ndarray]:
        """Chunk-ALIGNED contiguous batch alloc from the bump region, or None
        when it can't be served contiguously (caller falls back to per-owner
        chunks).  Used for the per-step decode slots of RESET leaves
        (speculative decoding): w single-token leaves allocated back-to-back
        form one pool run, which the flatten plan coalesces into one DMA
        segment instead of w seg-padded ones (plan/flatten.py _assemble)."""
        span = self._group_span
        if (
            span is not None
            and len(self._group_freed) == span[1]
            and need_size <= span[1]
        ):
            # previous group fully freed (the spec-decode steady state):
            # reuse the span in place, releasing any tail past need_size.
            # Held-back slots were never counted free, so free_count only
            # gains the released tail.
            start = span[0]
            out = np.arange(start, start + need_size, dtype=np.int32)
            if need_size < span[1]:
                self._recycled.extend(
                    range(start + need_size, start + span[1])
                )
                self._free_count += span[1] - need_size
            self._group_freed.clear()
            self._group_span = [start, need_size]
            self.refs[out] = 1
            self._live += need_size
            return out
        aligned = ((self._bump + self.chunk - 1) // self.chunk) * self.chunk
        skip = aligned - self._bump
        # retire the old span FIRST: its held-back freed slots are real
        # capacity and must count toward the free check below (otherwise a
        # near-full pool returns None while holding back reclaimable slots
        # forever).  The span must also be forgotten — some of its slots go
        # to _recycled now, so a later in-place reuse would double-hand them.
        if self._group_freed:
            self._recycled.extend(self._group_freed)
            self._free_count += len(self._group_freed)
            self._group_freed.clear()
            self._group_span = None
        if self._limit - aligned < need_size:
            return None
        if self._free_count < need_size + skip:
            return None
        if skip:
            self._recycled.extend(range(self._bump, aligned))
            self._bump = aligned
        out = np.arange(aligned, aligned + need_size, dtype=np.int32)
        self._group_span = [int(aligned), need_size]
        self._bump = aligned + need_size
        self.refs[out] = 1
        self._free_count -= need_size
        self._live += need_size
        return out

    def _reserved_unused(self) -> int:
        return sum(e - n for n, e in self._open.values())

    def _open_chunk(self, owner) -> bool:
        """Reserve a fresh chunk-aligned chunk from the bump region
        (free_count is charged at reservation; handed-out slots are not
        charged again).  Alignment skips (after an unaligned batch alloc)
        are recycled as single slots."""
        aligned = ((self._bump + self.chunk - 1) // self.chunk) * self.chunk
        if self._limit - aligned < self.chunk:
            return False
        if self._free_count < self.chunk + (aligned - self._bump):
            return False
        if aligned != self._bump:
            self._recycled.extend(range(self._bump, aligned))
            self._bump = aligned
        self._open[owner] = [self._bump, self._bump + self.chunk]
        self._bump += self.chunk
        self._free_count -= self.chunk
        return True

    def close_owner(self, owner: int) -> None:
        """Recycle the unused tail of ``owner``'s open chunk."""
        span = self._open.pop(owner, None)
        if span is None:
            return
        nxt, end = span
        if end > nxt:
            self._recycled.extend(range(nxt, end))
            self._free_count += end - nxt

    def add_refs(self, indices: np.ndarray) -> None:
        """Increment refcounts (prefix sharing across branches)."""
        np.add.at(self.refs, np.asarray(indices, dtype=np.int64), 1)

    def decrease_refs(self, indices: np.ndarray) -> None:
        indices = np.asarray(indices, dtype=np.int64)
        np.add.at(self.refs, indices, -1)
        # unique: a slot appearing twice in one call (multi-ref aliasing)
        # must be recycled once, not twice (double-recycling hands the slot
        # to two future owners)
        dead = np.unique(indices[self.refs[indices] == 0])
        if len(dead):
            assert np.all(self.refs[dead] == 0)
            self._live -= len(dead)
            if self._group_span is not None:
                # hold back dead group slots for span reuse (alloc_group);
                # they are NOT free capacity (not in _recycled) until the
                # span is reused or retired
                s, n = self._group_span
                in_group = (dead >= s) & (dead < s + n)
                if in_group.any():
                    self._group_freed.extend(int(i) for i in dead[in_group])
                    dead = dead[~in_group]
            self._recycled.extend(int(i) for i in dead)
            self._free_count += len(dead)

    # Reference naming: free == decrement refs, releasing slots at zero
    # (memory_pool.py:76-88).
    free = decrease_refs

    def clear(self) -> None:
        self.refs[:] = 0
        self._bump = self.chunk
        self._recycled.clear()
        self._free_count = self._limit - self.chunk
        self._live = 0
        self._open.clear()
        self._group_span = None
        self._group_freed.clear()
