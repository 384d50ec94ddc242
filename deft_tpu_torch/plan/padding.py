"""Port of deft_tpu/plan/padding.py:27,46: a copy, with the same
behaviour, owned by deft_tpu_torch.

Shape bucketing: the tree changes every step, but the jitted step needs
static shapes.  Pad counts to a small family of buckets so recompiles are
O(log(max size)) per run and the XLA compile cache absorbs them across runs.

This replaces the reference's luxury of fully dynamic Triton grids; it is the
central static-shape design noted in SURVEY.md §7 ("hard parts" #1).

Two bucket families:
- pow2=True  — powers of two: fewest jit buckets.  Used by flatten plans,
  where dead blocks are *skipped* by the kernel (blk_lo/hi bounds) and the
  upload is small, so padding waste costs ~nothing.
- pow2=False — multiples of ``granularity`` (default 512): tight buckets.
  Used by seq plans and prefill, where padded width is real gather/compute
  work (a pow2 bucket would inflate the seq baseline's KV IO by up to 2x,
  distorting the flatten-vs-seq comparison).
"""

from __future__ import annotations


def next_pow2(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def pad_token_count(n: int, block_len: int = 128, min_bucket: int = 1024,
                    pow2: bool = False, granularity: int = 512) -> int:
    """Bucket a token count: floored at ``min_bucket``, then powers of two
    (pow2=True) or multiples of ``granularity`` (pow2=False); the result is
    ALWAYS a multiple of ``block_len`` (plans reshape to (nb, block_len) —
    a min_bucket or granularity that isn't block-aligned must not break
    that)."""
    n = max(n, 1)
    n = ((n + block_len - 1) // block_len) * block_len
    if n <= min_bucket:
        out = min_bucket
    elif pow2:
        out = next_pow2(n)
    else:
        g = max(granularity, block_len)
        out = ((n + g - 1) // g) * g
    return ((out + block_len - 1) // block_len) * block_len


def pad_leaf_count(n_leaves: int, q_per_kv: int, min_rows: int = 16) -> int:
    """Pad the leaf count so folded query rows (leaves * q_per_kv) meet TPU
    sublane tiling (>=16 rows) and stay a power of two."""
    assert q_per_kv >= 1
    need = max(n_leaves, (min_rows + q_per_kv - 1) // q_per_kv, 1)
    return next_pow2(need)
