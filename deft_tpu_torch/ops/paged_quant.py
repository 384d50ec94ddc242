"""DeFT-Flatten tree-decode attention over the paged int8 KV pool.

Port of deft_tpu/ops/paged_quant.py:305 (paged_flatten_attention_q, the
Pallas kernel _paged_q_kernel :32) and :338 (paged_flatten_attn_q_pallas).
The pools hold int8 codes, (L, S, Hkv*D), with per-(token, head) fp32 scales
stored head-major, (L, Hkv, S); a row dequantises to codes * scale.  The
Hopper kernel is csrc/paged_flatten.cu's entry deft_paged_flatten_q: over
bf16 q its own body (deft_flat_q: the int8 codes widened in registers into
mma.sync fragments, 128 folded rows a block, a cp.async ring, spans from the
SM count, ``q_spans``), over fp32 q B1's over an int8 KV type; scores are
scaled by the K scales after the product, P by the V scales before PV
(deft_tpu paged_quant.py:150-177).
``paged_flatten_attention_q_plain`` is the same function in plain torch,
which the wrapper runs for CPU tensors only.  The plan is B1's.

B4p, ``paged_flatten_attention_q_partial``, is the port of deft_tpu's
partial=True entry (paged_quant.py:321), for the multi-device engine: the
unnormalised state over the plan's blocks, as B1p writes it.
"""

from __future__ import annotations

import torch

from deft_tpu_torch.ops import _cuda
from deft_tpu_torch.ops.paged_flatten_attn import (launch_flatten,
                                                   segment_rows,
                                                   tree_attention_plain,
                                                   tree_attention_state_plain)


def paged_flatten_attention_q_plain(q, k_pool, v_pool, k_scale, v_scale, li,
                                    seg_src, tok_lo, tok_hi, blk_lo, blk_hi,
                                    scale, block_len, seg_len):
    """The kernel's function in plain torch: the flattened KV read through
    the segment table and dequantised in fp32, then exact masked
    attention."""
    return tree_attention_plain(q, k_pool, v_pool, li,
                                segment_rows(seg_src, seg_len), tok_lo, tok_hi,
                                blk_lo, blk_hi, scale, block_len, k_scale,
                                v_scale)


def paged_flatten_attention_q(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, k_scale: torch.Tensor,
                              v_scale: torch.Tensor, li: int,
                              seg_src: torch.Tensor, tok_lo: torch.Tensor,
                              tok_hi: torch.Tensor, blk_lo: torch.Tensor,
                              blk_hi: torch.Tensor, scale: float,
                              block_len: int, seg_len: int) -> torch.Tensor:
    """Tree attention of q (R, Hq, D) over the flattened tree KV read from
    the int8 (L, S, Hkv*D) pools and their (L, Hkv, S) scales; returns
    (R, Hq, D).  CUDA tensors launch csrc/paged_flatten.cu's int8 entry;
    CPU tensors run the plain version."""
    if q.device.type == "cpu":
        return paged_flatten_attention_q_plain(
            q, k_pool, v_pool, k_scale, v_scale, li, seg_src, tok_lo, tok_hi,
            blk_lo, blk_hi, scale, block_len, seg_len)
    _cuda.require(seg_len > 0 and k_scale is not None and v_scale is not None,
                  "the int8 paged kernel takes a paged plan and scale pools")
    o = launch_flatten("paged_flatten", "deft_paged_flatten_q", q, k_pool,
                       v_pool, k_scale, v_scale, li, seg_src, tok_lo, tok_hi,
                       blk_lo, blk_hi, scale, block_len, seg_len)
    paged_flatten_attention_q.launches += 1
    return o


paged_flatten_attention_q.launches = 0


def paged_flatten_attention_q_partial_plain(q, k_pool, v_pool, k_scale, v_scale,
                                            li, seg_src, tok_lo, tok_hi, blk_lo,
                                            blk_hi, scale, block_len, seg_len):
    """B4p's function in plain torch: B4's attention as its unnormalised
    state."""
    return tree_attention_state_plain(q, k_pool, v_pool, li,
                                      segment_rows(seg_src, seg_len), tok_lo,
                                      tok_hi, blk_lo, blk_hi, scale, block_len,
                                      k_scale, v_scale)


def paged_flatten_attention_q_partial(q: torch.Tensor, k_pool: torch.Tensor,
                                      v_pool: torch.Tensor, k_scale: torch.Tensor,
                                      v_scale: torch.Tensor, li: int,
                                      seg_src: torch.Tensor, tok_lo: torch.Tensor,
                                      tok_hi: torch.Tensor, blk_lo: torch.Tensor,
                                      blk_hi: torch.Tensor, scale: float,
                                      block_len: int, seg_len: int):
    """B4p: the unnormalised state of q (R, Hq, D) over the plan's blocks
    read from the int8 pools and their scales: acc (Hkv, R*qpk, D), m and l
    (Hkv, R*qpk), fp32, m in natural-log units.  CUDA tensors launch
    csrc/paged_flatten.cu's int8 partial entry; CPU tensors run the plain
    version."""
    if q.device.type == "cpu":
        return paged_flatten_attention_q_partial_plain(
            q, k_pool, v_pool, k_scale, v_scale, li, seg_src, tok_lo, tok_hi,
            blk_lo, blk_hi, scale, block_len, seg_len)
    _cuda.require(seg_len > 0 and k_scale is not None and v_scale is not None,
                  "the int8 paged kernel takes a paged plan and scale pools")
    out = launch_flatten("paged_flatten", "deft_paged_flatten_q_partial", q, k_pool,
                         v_pool, k_scale, v_scale, li, seg_src, tok_lo, tok_hi,
                         blk_lo, blk_hi, scale, block_len, seg_len, partial=True)
    paged_flatten_attention_q_partial.launches += 1
    return out


paged_flatten_attention_q_partial.launches = 0
