"""DeFT-Flatten tree-decode attention for plans that are not segment-aligned.

Port of deft_tpu/ops/flatten_attn.py:141 (flatten_attention, the Pallas
kernel _flatten_kernel :77) and :204 (flatten_attn_pallas).  deft_tpu gathers
the tree's KV through the plan's ``kv_idx`` in XLA first (dequantised for
int8 pools) and runs the kernel over the contiguous copy; the Hopper kernel,
csrc/flatten_gather.cu, reads row kv_idx[t] of the pool inside the kernel:
over bf16 q on B1's and B4's tensor-core body (csrc/flat_q_body.cuh, one
pool index a token as its row source) at every head width (64, 96, 128,
256), over fp32 q on the staged split-KV body.  It takes pools of q's
dtype, or int8 pools with their (L, Hkv, S) fp32 scales.  A multi-tree
plan's row tiles see unequal work, so the runner counts each row tile's
tiles on the host (``row_tiles``, from the numpy plan) and the spans follow
the busiest (``balanced_spans``); without them the spans fill the card
(``q_spans``).  ``flatten_attention_plain`` is
the same function in plain torch, which the wrapper runs for CPU tensors
only.

Plan format (deft_tpu plan/flatten.py, paged=False): kv_idx, tok_lo, tok_hi
(T,), T = nb * block_len, pads at DUMP_SLOT (pool row 0, also a multi-tree
plan's tail) with empty intervals; blk_lo / blk_hi (nb,) as in B1.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from deft_tpu_torch.ops.paged_flatten_attn import (launch_flatten,
                                                   tree_attention_plain)


def flatten_attention_plain(q, k_pool, v_pool, li, kv_idx, tok_lo, tok_hi,
                            blk_lo, blk_hi, scale, k_scale=None, v_scale=None,
                            row_tiles=None):
    """The kernel's function in plain torch: the tree KV read through kv_idx
    (dequantised for int8 pools), then exact masked attention.  row_tiles,
    the kernel's span input, is unread: the plain version has no spans."""
    block_len = kv_idx.shape[0] // blk_lo.shape[0]
    return tree_attention_plain(q, k_pool, v_pool, li, kv_idx, tok_lo, tok_hi,
                                blk_lo, blk_hi, scale, block_len, k_scale,
                                v_scale)


def flatten_attention(q: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, li: int, kv_idx: torch.Tensor,
                      tok_lo: torch.Tensor, tok_hi: torch.Tensor,
                      blk_lo: torch.Tensor, blk_hi: torch.Tensor, scale: float,
                      k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None,
                      row_tiles: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Tree attention of q (R, Hq, D) over the plan tokens at pool rows
    kv_idx of the (L, S, Hkv*D) pools; returns (R, Hq, D).  CUDA tensors
    launch csrc/flatten_gather.cu; CPU tensors run the plain version.
    ``row_tiles``: the plan's paged_flatten_attn.row_tile_tiles, counted on
    the host, for the span rule of bf16 q."""
    if q.device.type == "cpu":
        return flatten_attention_plain(q, k_pool, v_pool, li, kv_idx, tok_lo,
                                       tok_hi, blk_lo, blk_hi, scale, k_scale,
                                       v_scale)
    block_len = kv_idx.shape[0] // blk_lo.shape[0]
    o = launch_flatten("flatten_gather", "deft_flatten_gather", q, k_pool,
                       v_pool, k_scale, v_scale, li, kv_idx, tok_lo, tok_hi,
                       blk_lo, blk_hi, scale, block_len, 0, row_tiles=row_tiles)
    flatten_attention.launches += 1
    return o


flatten_attention.launches = 0
