"""One rank's partial DeFT-Flatten state over a span of a gather plan.

Port of deft_tpu/ops/sharded_flatten.py:93 (flatten_attention_partial, the
Pallas kernel _partial_kernel :37), which deft_tpu's multi-device engine
runs on each rank's span of plan blocks when the plan is not
segment-aligned (parallel/engine.py:178-215).  deft_tpu gathers the span's
KV through ``kv_idx`` in XLA first (dequantised to q's dtype for int8
pools) and runs the kernel over the contiguous copy; the Hopper kernel,
csrc/flatten_gather.cu's entry deft_flatten_gather_partial (B11), reads
pool row kv_idx[t] in the kernel, as B6 does and on B6's bodies (bf16 q at
every head width: csrc/flat_q_body.cuh's tensor cores, spans from the SM
count, ``q_spans``;
fp32 q: the staged split-KV body), over bf16/fp32 pools or int8 pools with
their (L, Hkv, S) fp32 scales, and writes the unnormalised state (acc, m,
l) through the merge kernel's partial form.  Its spans follow the
window's row tiles (``balanced_spans``) where the engine counts them on the
host from the numpy plan (``row_tiles``, parallel/engine.py
``host_window``), else fill the card (``q_spans``).  Blocks whose leaf interval,
shifted into the rank's row window, misses its rows are skipped before any
read (sharded_flatten.py:55-60).  ``flatten_attention_partial_plain``
is the same function in plain torch, which the wrapper runs for CPU tensors
only.

Outputs: acc (Hkv, R*qpk, D), m and l (Hkv, R*qpk), fp32, m in natural-log
units; deft_tpu broadcasts m and l over 128 lanes, the port keeps one
column.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from deft_tpu_torch.ops.paged_flatten_attn import (launch_flatten,
                                                   tree_attention_state_plain)


def flatten_attention_partial_plain(q, k_pool, v_pool, li, kv_idx, tok_lo,
                                    tok_hi, blk_lo, blk_hi, scale, k_scale=None,
                                    v_scale=None, row_tiles=None):
    """B11's function in plain torch: the span's tokens read through kv_idx
    (dequantised in fp32 for int8 pools), masked attention as its
    unnormalised state.  row_tiles, the kernel's span input, is unread."""
    block_len = kv_idx.shape[0] // blk_lo.shape[0]
    return tree_attention_state_plain(q, k_pool, v_pool, li, kv_idx, tok_lo,
                                      tok_hi, blk_lo, blk_hi, scale, block_len,
                                      k_scale, v_scale)


def flatten_attention_partial(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, li: int, kv_idx: torch.Tensor,
                              tok_lo: torch.Tensor, tok_hi: torch.Tensor,
                              blk_lo: torch.Tensor, blk_hi: torch.Tensor,
                              scale: float, k_scale: Optional[torch.Tensor] = None,
                              v_scale: Optional[torch.Tensor] = None,
                              row_tiles: Optional[Sequence[int]] = None):
    """The unnormalised state of q (R, Hq, D) over the span's tokens at pool
    rows kv_idx of the (L, S, Hkv*D) pools: acc (Hkv, R*qpk, D), m and l
    (Hkv, R*qpk), fp32.  CUDA tensors launch csrc/flatten_gather.cu's partial
    entry; CPU tensors run the plain version.  ``row_tiles``: the window's
    paged_flatten_attn.row_tile_tiles, counted on the host, for the span
    rule of bf16 q."""
    if q.device.type == "cpu":
        return flatten_attention_partial_plain(q, k_pool, v_pool, li, kv_idx,
                                               tok_lo, tok_hi, blk_lo, blk_hi,
                                               scale, k_scale, v_scale)
    block_len = kv_idx.shape[0] // blk_lo.shape[0]
    out = launch_flatten("flatten_gather", "deft_flatten_gather_partial", q,
                         k_pool, v_pool, k_scale, v_scale, li, kv_idx, tok_lo,
                         tok_hi, blk_lo, blk_hi, scale, block_len, 0, partial=True,
                         row_tiles=row_tiles)
    flatten_attention_partial.launches += 1
    return out


flatten_attention_partial.launches = 0
