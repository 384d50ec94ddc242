"""Attention entries behind the model's AttnFn interface.

Port of deft_tpu/ops/attn_impls.py:24-67 (flatten_attn_xla, seq_attn_xla,
prefill_attn_xla, ragged_prefill_attn_xla) and of the runner's kernel choice (deft_tpu
runtime/runner.py:418-488).  Each entry has the signature

    (q, k_new, v_new, k_pool, v_pool, layer_idx, batch, scale) -> (R, Hq, D)

with k_pool / v_pool the model's KVPool objects.  The kernel entries call a
kernel wrapper, which launches the Hopper kernel for CUDA tensors and runs
the kernel's plain torch version for CPU tensors:

    plan             bf16/fp32 pools          int8 pools
    flatten, paged   flatten_attn (B1)        flatten_attn_q (B4)
    flatten, gather  flatten_gather_attn (B6, both pool types)
    seq, paged       seq_attn (B2)            seq_attn_q (B5)
    seq, gather      seq_gather_attn (B7, both pool types)

Prefill attends the in-flight projections: ``prefill_attn`` (B3, one
prompt) and ``ragged_prefill_attn`` (B8, prompts joined on the token axis,
batch.seg_ids).

``flatten_attn_xla`` and ``seq_attn_xla`` are deft_tpu's dense oracles over
the gather plans' arrays: B6's and B7's plain versions (int8 rows
dequantised in fp32) behind the AttnFn interface, and
``ragged_prefill_attn_xla`` is B8's.  One runner path takes
``flatten_attn_xla``: UNPAGED_MEDUSA, the dense masked-attention baseline,
which is this same plain attention in deft_tpu (runner.py:448-453), not a
kernel's stand-in.

On a grid (a batch with ``dp_rows``, the rank's window of the step's rows)
q holds the window's rows and the entries return them: the runner cuts a
gather seq plan's paths and seq_lens to the window, so ``seq_gather_attn``
runs B7 on it as it is, and ``flatten_attn_xla`` shifts the plan's leaf
intervals into it.
"""

from __future__ import annotations

from deft_tpu_torch.ops.flatten_attn import (flatten_attention,
                                             flatten_attention_plain)
from deft_tpu_torch.ops.paged_flatten_attn import paged_flatten_attention
from deft_tpu_torch.ops.paged_quant import paged_flatten_attention_q
from deft_tpu_torch.ops.paged_seq_attn import (paged_seq_attention,
                                               paged_seq_attention_q)
from deft_tpu_torch.ops.prefill import (prefill_attn, ragged_prefill_attn,
                                        ragged_prefill_attention_plain)
from deft_tpu_torch.ops.seq_attn import seq_attention, seq_attention_plain


def flatten_attn(q, k_new, v_new, k_pool, v_pool, li, batch, scale):
    """DeFT-Flatten tree attention over a paged FlattenPlan's arrays."""
    return paged_flatten_attention(
        q, k_pool.data, v_pool.data, li, batch.seg_src, batch.tok_lo,
        batch.tok_hi, batch.blk_lo, batch.blk_hi, scale,
        block_len=batch.block_len, seg_len=batch.seg_len)


def flatten_attn_q(q, k_new, v_new, k_pool, v_pool, li, batch, scale):
    """B1's entry over int8 pools (deft_tpu paged_flatten_attn_q_pallas)."""
    return paged_flatten_attention_q(
        q, k_pool.data, v_pool.data, k_pool.scale, v_pool.scale, li,
        batch.seg_src, batch.tok_lo, batch.tok_hi, batch.blk_lo, batch.blk_hi,
        scale, block_len=batch.block_len, seg_len=batch.seg_len)


def flatten_gather_attn(q, k_new, v_new, k_pool, v_pool, li, batch, scale):
    """Tree attention over a FlattenPlan that is not segment-aligned
    (deft_tpu flatten_attn_pallas); the runner's batch carries the plan's
    row_tiles, counted on the host, for the kernel's span rule."""
    return flatten_attention(
        q, k_pool.data, v_pool.data, li, batch.kv_idx, batch.tok_lo,
        batch.tok_hi, batch.blk_lo, batch.blk_hi, scale, k_pool.scale,
        v_pool.scale, row_tiles=getattr(batch, "row_tiles", None))


def seq_attn(q, k_new, v_new, k_pool, v_pool, li, batch, scale):
    """Sequential per-leaf baseline over a paged SeqPlan's arrays."""
    return paged_seq_attention(
        q, k_pool.data, v_pool.data, li, batch.seg_src, batch.seg_off,
        batch.seg_live, batch.blk_live, scale, seg_len=batch.seg_len)


def seq_attn_q(q, k_new, v_new, k_pool, v_pool, li, batch, scale):
    """B2's entry over int8 pools (deft_tpu paged_seq_attn_q_pallas)."""
    return paged_seq_attention_q(
        q, k_pool.data, v_pool.data, k_pool.scale, v_pool.scale, li,
        batch.seg_src, batch.seg_off, batch.seg_live, batch.blk_live, scale,
        seg_len=batch.seg_len)


def seq_gather_attn(q, k_new, v_new, k_pool, v_pool, li, batch, scale):
    """Sequential per-leaf baseline over a SeqPlan that is not
    segment-aligned (deft_tpu seq_attn_pallas)."""
    return seq_attention(q, k_pool.data, v_pool.data, li, batch.paths,
                         batch.seq_lens, scale, k_pool.scale, v_pool.scale)


def flatten_attn_xla(q, k_new, v_new, k_pool, v_pool, li, batch, scale):
    """deft_tpu attn_impls.py:24: the tree KV gathered through kv_idx, then
    dense masked attention; B6's plain version behind the AttnFn
    interface.  On a dp window the leaf intervals are shifted by its first
    row: row r of q is leaf r0 + r (the FULL sentinel stays far below the
    kernels' threshold, and no leaf of a pad row exists)."""
    ivs = (batch.tok_lo, batch.tok_hi, batch.blk_lo, batch.blk_hi)
    rows = getattr(batch, "dp_rows", None)
    if rows is not None and rows.r0:
        ivs = tuple(x - rows.r0 for x in ivs)
    return flatten_attention_plain(q, k_pool.data, v_pool.data, li, batch.kv_idx,
                                   *ivs, scale, k_pool.scale, v_pool.scale)


def seq_attn_xla(q, k_new, v_new, k_pool, v_pool, li, batch, scale):
    """deft_tpu attn_impls.py:34: each leaf gathers and attends its own
    padded path, masked by seq_lens; B7's plain version behind the AttnFn
    interface (a padded leaf, seq_len 0, gets 0 here where deft_tpu
    averages its padding)."""
    return seq_attention_plain(q, k_pool.data, v_pool.data, li, batch.paths,
                               batch.seq_lens, scale, k_pool.scale,
                               v_pool.scale)


def ragged_prefill_attn_xla(q, k_new, v_new, k_pool, v_pool, li, batch, scale):
    """deft_tpu attn_impls.py:64: ragged causal prefill, cross-prompt pairs
    masked by batch.seg_ids; B8's plain version behind the AttnFn
    interface."""
    return ragged_prefill_attention_plain(q, k_new, v_new, batch.seg_ids, scale)


__all__ = ["flatten_attn", "flatten_attn_q", "flatten_gather_attn", "seq_attn",
           "seq_attn_q", "seq_gather_attn", "prefill_attn", "ragged_prefill_attn",
           "flatten_attn_xla", "seq_attn_xla", "ragged_prefill_attn_xla"]
