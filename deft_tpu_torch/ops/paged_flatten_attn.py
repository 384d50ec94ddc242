"""DeFT-Flatten tree-decode attention over the paged KV pool.

Port of deft_tpu/ops/paged_flatten_attn.py:381 (paged_flatten_attention, the
Pallas kernel _paged_kernel :63) and :458 (paged_flatten_attn_pallas).  The
Hopper kernel is csrc/paged_flatten.cu (split-KV: per-span partial states,
then an LSE merge); ``paged_flatten_attention_plain`` is the same function in
plain torch over the same plan arrays, which the wrapper runs for CPU
tensors only.

Plan format (deft_tpu plan/flatten.py, unchanged): the tree's KV in DFS
order, ``block_len`` tokens per block; segment j of block b is the pool span
[seg_src[b * nseg + j], + seg_len); leaf r sees token t iff
tok_lo[t] <= r < tok_hi[t]; blocks with blk_lo >= blk_hi are dead, and
blk_lo < -(1 << 20) (FULL_BLOCK_LO) marks a block every leaf sees in full.
"""

from __future__ import annotations

import ctypes

import torch

from deft_tpu_torch.ops import _cuda
from deft_tpu_torch.ops.dense_oracle import dense_tree_attention

_FULL_THRESHOLD = -(1 << 20)


def flattened_kv(pool: torch.Tensor, li: int, seg_src: torch.Tensor,
                 seg_len: int, head_dim: int) -> torch.Tensor:
    """(T, Hkv, D) rows of layer ``li`` of a (L, S, Hkv*D) pool, read
    through the plan's segment table (T = len(seg_src) * seg_len)."""
    addr = (seg_src[:, None].long()
            + torch.arange(seg_len, device=seg_src.device)).reshape(-1)
    rows = pool[li].index_select(0, addr)
    return rows.view(addr.shape[0], -1, head_dim)


def paged_flatten_attention_plain(q, k_pool, v_pool, li, seg_src, tok_lo,
                                  tok_hi, blk_lo, blk_hi, scale, block_len,
                                  seg_len):
    """The kernel's function in plain torch: gather the flattened KV through
    the segment table, then exact masked attention.  FULL blocks are seen
    by every row (the kernel takes no mask there); dead blocks by none."""
    D = q.shape[-1]
    k = flattened_kv(k_pool, li, seg_src, seg_len, D)
    v = flattened_kv(v_pool, li, seg_src, seg_len, D)
    full = (blk_lo < _FULL_THRESHOLD).repeat_interleave(block_len)
    dead = (blk_lo >= blk_hi) & ~(blk_lo < _FULL_THRESHOLD)
    dead = dead.repeat_interleave(block_len)
    R = q.shape[0]
    lo = torch.where(full, torch.zeros_like(tok_lo), tok_lo)
    hi = torch.where(full, torch.full_like(tok_hi, R), tok_hi)
    hi = torch.where(dead, torch.zeros_like(hi), hi)
    return dense_tree_attention(q, k, v, lo, hi, scale)


def _fn():
    fn = _cuda.library("paged_flatten").deft_paged_flatten
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, ctypes.c_longlong, P, P, P, P, P, P, P, P, P,
                       I, I, I, I, I, I, I, I, I, ctypes.c_float, P]
        fn.restype = I
    return fn


def num_spans(num_blocks: int, kv_bytes: int, state_bytes: int) -> int:
    """Split-KV span count: the partial state written (state_bytes per
    span) stays at most a quarter of the KV read, and no span is empty."""
    return max(1, min(num_blocks, kv_bytes // max(4 * state_bytes, 1)))


def paged_flatten_attention(q: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, li: int,
                            seg_src: torch.Tensor, tok_lo: torch.Tensor,
                            tok_hi: torch.Tensor, blk_lo: torch.Tensor,
                            blk_hi: torch.Tensor, scale: float,
                            block_len: int, seg_len: int) -> torch.Tensor:
    """Tree attention of q (R, Hq, D) over the flattened tree KV read from
    the (L, S, Hkv*D) pools; returns (R, Hq, D).  CUDA tensors launch
    csrc/paged_flatten.cu; CPU tensors run the plain version."""
    if q.device.type == "cpu":
        return paged_flatten_attention_plain(
            q, k_pool, v_pool, li, seg_src, tok_lo, tok_hi, blk_lo, blk_hi,
            scale, block_len, seg_len)
    R, Hq, D = q.shape
    L, S, HD = k_pool.shape
    Hkv = HD // D
    nb = blk_lo.shape[0]
    T = tok_lo.shape[0]
    _cuda.require(Hkv * D == HD and Hq % Hkv == 0, "pool width != Hkv * D")
    _cuda.require(v_pool.shape == k_pool.shape, "k/v pools differ in shape")
    _cuda.require(q.dtype == k_pool.dtype == v_pool.dtype, "dtypes differ")
    _cuda.require(D in (64, 128), f"head_dim {D}: the kernel takes 64 or 128")
    _cuda.require(T == nb * block_len and block_len % 64 == 0
                  and block_len % seg_len == 0
                  and seg_src.shape[0] == T // seg_len,
                  "plan arrays disagree with block_len / seg_len")
    for t in (seg_src, tok_lo, tok_hi, blk_lo, blk_hi):
        _cuda.require(t.dtype == torch.int32 and t.is_contiguous(),
                      "plan arrays must be contiguous int32")
    _cuda.require_device(q, k_pool, v_pool, seg_src, tok_lo, tok_hi, blk_lo,
                         blk_hi)
    _cuda.require(k_pool.is_contiguous() and v_pool.is_contiguous(),
                  "pools must be contiguous")
    q = q.contiguous()
    Rq = R * (Hq // Hkv)
    spans = num_spans(nb, T * HD * 2 * k_pool.element_size(),
                      Hkv * Rq * (D + 2) * 4)
    acc = torch.empty((spans, Hkv, Rq, D), dtype=torch.float32, device=q.device)
    m = torch.empty((spans, Hkv, Rq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    o = torch.empty_like(q)
    err = _fn()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                int(li) * S * HD, seg_src.data_ptr(), tok_lo.data_ptr(),
                tok_hi.data_ptr(), blk_lo.data_ptr(), blk_hi.data_ptr(),
                acc.data_ptr(), m.data_ptr(), l.data_ptr(), o.data_ptr(),
                R, Hq, Hkv, D, nb, block_len, seg_len, spans,
                _cuda.dtype_code(q.dtype), float(scale),
                _cuda.stream_ptr(q.device))
    _cuda.check(err, "paged flatten kernel")
    paged_flatten_attention.launches += 1
    return o


paged_flatten_attention.launches = 0
