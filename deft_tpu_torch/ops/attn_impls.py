"""Attention entries behind the model's AttnFn interface.

Port of deft_tpu/ops/attn_impls.py:24-61 (flatten_attn_xla, seq_attn_xla,
prefill_attn_xla) and of the runner's kernel choice (deft_tpu
runtime/runner.py:418-488).  Each entry has the signature

    (q, k_new, v_new, k_pool, v_pool, layer_idx, batch, scale) -> (R, Hq, D)

and calls a kernel wrapper, which launches the Hopper kernel for CUDA tensors
and runs the kernel's plain torch version for CPU tensors.  Only paged plans
reach here (the runner refuses the gather plans, whose kernels are queued).
"""

from __future__ import annotations

from deft_tpu_torch.ops.paged_flatten_attn import paged_flatten_attention
from deft_tpu_torch.ops.paged_seq_attn import paged_seq_attention
from deft_tpu_torch.ops.prefill import prefill_attn


def flatten_attn(q, k_new, v_new, k_pool, v_pool, li, batch, scale):
    """DeFT-Flatten tree attention over a paged FlattenPlan's arrays."""
    return paged_flatten_attention(
        q, k_pool.data, v_pool.data, li, batch.seg_src, batch.tok_lo,
        batch.tok_hi, batch.blk_lo, batch.blk_hi, scale,
        block_len=batch.block_len, seg_len=batch.seg_len)


def seq_attn(q, k_new, v_new, k_pool, v_pool, li, batch, scale):
    """Sequential per-leaf baseline over a paged SeqPlan's arrays."""
    return paged_seq_attention(
        q, k_pool.data, v_pool.data, li, batch.seg_src, batch.seg_off,
        batch.seg_live, batch.blk_live, scale, seg_len=batch.seg_len)


__all__ = ["flatten_attn", "seq_attn", "prefill_attn"]
