"""The flatten kernel lab's variants of B1, as Hopper kernels B12-B14.

Ports of the three Pallas kernels of deft_tpu's experiments/kernel_lab.py
that compute B1's function (ops/paged_flatten_attn.py) another way:

- B12 ``lab_passes_attention``: _lab_kernel (kernel_lab.py:142, its
  pallas_call :296, variant B), one program walking every plan block;
- B13 ``lab_fused_attention``: _lab_kernel_fused (:312, pallas_call :449,
  variant D), every KV head's scores from one read of a token's K and V;
- B14 ``lab_k2_attention``: _lab2_kernel (:544, pallas_call :729, variants
  K2 and TQ), programs of ``prog_len`` tokens dispatched at ``sub_len``
  sub-blocks (FULL, masked or dead by ``sub_lo`` / ``sub_hi``), with row
  tiles of ``tq`` rows skipped where a masked sub-block misses their
  leaves.

The Hopper kernels are csrc/lab_flatten.cu (its header says what each
answers on the card).  As in the lab, q and o are folded (Hkv, Rq, D): row r
is leaf r // qpk.  CUDA tensors launch the kernel (bf16 q and pools,
head_dim 128) or raise; CPU tensors run the plain version, B1's exact
masked attention over the same plan (dense_oracle), for which every skip of
the kernels is an identity.
"""

from __future__ import annotations

import ctypes

import torch

from deft_tpu_torch.models.llama import KVPool, kv_gather_heads
from deft_tpu_torch.ops import _cuda
from deft_tpu_torch.ops.dense_oracle import dense_tree_attention
from deft_tpu_torch.ops.paged_flatten_attn import (fold_rows, leaf_intervals,
                                                   segment_rows, unfold_rows)

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# q, k_pool, v_pool, layer_off, seg_src, seg_len, tok_lo, tok_hi: every entry
_HEAD = [_P, _P, _P, _LL, _P, _I, _P, _P]
_PASSES_ARGS = _HEAD + [_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P]
_FUSED_ARGS = _HEAD + [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P]
_K2_ARGS = _HEAD + [_P, _P, _P, _P, _P, _P] + [_I] * 9 + [_F, _P]
# the kernels' head width and B13's most KV heads (one warp a head)
HEAD_DIM = 128
FUSED_MAX_HKV = 8
# folded rows of a B13 block (one mma.sync row tile) and of a B12 / B14 block
FUSED_ROWS = 16
TILE_ROWS = 64


def _attend(q, k_pool, v_pool, li, seg_src, seg_len, lo, hi, scale, qpk):
    """Folded q (Hkv, Rq, D) over the plan tokens read through the segment
    table, token t seen by leaves [lo[t], hi[t]): exact, in fp32, cast back
    to q's dtype."""
    Hkv, Rq, D = q.shape
    rows = segment_rows(seg_src, seg_len)
    k, v = (kv_gather_heads(KVPool(p), li, rows, D, torch.float32) for p in (k_pool, v_pool))
    o = dense_tree_attention(unfold_rows(q, Rq // qpk), k, v, lo, hi, scale)
    return fold_rows(o, Hkv)


def _live_intervals(tok_lo, tok_hi, blk_lo, blk_hi, block_len):
    """The leaf intervals B12 and B13 mask with: the tokens' own, none in a
    dead block (blk_lo >= blk_hi; a FULL sentinel block is live and masked
    by its tokens, as the lab's variants B and D take it)."""
    dead = (blk_lo >= blk_hi).repeat_interleave(block_len)
    return tok_lo, torch.where(dead, torch.zeros_like(tok_hi), tok_hi)


def lab_passes_attention_plain(q, k_pool, v_pool, li, seg_src, tok_lo, tok_hi, blk_lo,
                               blk_hi, scale, qpk, block_len, seg_len):
    """B12's function in plain torch."""
    return _attend(q, k_pool, v_pool, li, seg_src, seg_len,
                   *_live_intervals(tok_lo, tok_hi, blk_lo, blk_hi, block_len), scale, qpk)


# B13's function in plain torch: B12's
lab_fused_attention_plain = lab_passes_attention_plain


def lab_k2_attention_plain(q, k_pool, v_pool, li, seg_src, tok_lo, tok_hi, sub_lo, sub_hi,
                           scale, qpk, prog_len, sub_len, seg_len, tq):
    """B14's function in plain torch: the sub-blocks' FULL, masked and dead
    dispatch as B1 reads its blocks' (leaf_intervals); programs and row
    tiles change no result."""
    lo, hi = leaf_intervals(tok_lo, tok_hi, sub_lo, sub_hi, sub_len, q.shape[1] // qpk)
    return _attend(q, k_pool, v_pool, li, seg_src, seg_len, lo, hi, scale, qpk)


def _check(q, k_pool, v_pool, seg_src, tok_lo, tok_hi, seg_len, qpk, *tables):
    """Refuse what the kernels do not take; returns (Hkv, Rq, layer stride
    S * Hkv * D)."""
    Hkv, Rq, D = q.shape
    L, S, HD = k_pool.shape
    T = tok_lo.shape[0]
    _cuda.require(q.dtype == torch.bfloat16 and k_pool.dtype == torch.bfloat16
                  and v_pool.shape == k_pool.shape and v_pool.dtype == k_pool.dtype,
                  "the lab kernels take bf16 q and pools")
    _cuda.require(D == HEAD_DIM and HD == Hkv * D and Rq % qpk == 0,
                  f"the lab kernels take folded q (Hkv, Rq, {HEAD_DIM}) over "
                  "(L, S, Hkv * D) pools")
    _cuda.require(seg_len > 0 and seg_src.shape[0] * seg_len == T
                  and tok_hi.shape[0] == T, "plan arrays disagree with seg_len")
    for t in (seg_src, tok_lo, tok_hi, *tables):
        _cuda.require(t.dtype == torch.int32 and t.is_contiguous(),
                      "plan arrays must be contiguous int32")
    for t in (q, k_pool, v_pool):
        _cuda.require(t.is_contiguous(), "q and the pools must be contiguous")
    _cuda.require_device(q, k_pool, v_pool, seg_src, tok_lo, tok_hi, *tables)
    return Hkv, Rq, S * HD


def _states(n_spans, Hkv, Rq, device):
    """fp32 scratch of the spans' unnormalised states (acc, m, l), which
    the merge kernel reads."""
    acc = torch.empty((n_spans, Hkv, Rq, HEAD_DIM), dtype=torch.float32, device=device)
    m = torch.empty((n_spans, Hkv, Rq), dtype=torch.float32, device=device)
    return acc, m, torch.empty_like(m)


def fused_spans(Rq: int, units: int, sms: int) -> int:
    """B13's spans: as many as fill the SMs with one block each beside the
    16-row tiles, and no more than the plan's 16-token stages."""
    return max(1, min(units, sms // -(-Rq // FUSED_ROWS)))


def k2_spans(Rq: int, Hkv: int, n_prog: int, sms: int) -> int:
    """B14's spans: as many as fill the SMs beside the (64-row tile, KV
    head) pairs, and no more than the programs."""
    return max(1, min(n_prog, sms // (-(-Rq // TILE_ROWS) * Hkv)))


def lab_passes_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                         li: int, seg_src: torch.Tensor, tok_lo: torch.Tensor,
                         tok_hi: torch.Tensor, blk_lo: torch.Tensor, blk_hi: torch.Tensor,
                         scale: float, qpk: int, block_len: int,
                         seg_len: int) -> torch.Tensor:
    """B12: folded q (Hkv, Rq, D) over the plan's blocks of ``block_len``
    tokens, walked in order by one block a (64 rows, KV head); o (Hkv, Rq,
    D).  CUDA tensors launch csrc/lab_flatten.cu; CPU tensors run the plain
    version."""
    if q.device.type == "cpu":
        return lab_passes_attention_plain(q, k_pool, v_pool, li, seg_src, tok_lo, tok_hi,
                                          blk_lo, blk_hi, scale, qpk, block_len, seg_len)
    nb = blk_lo.shape[0]
    Hkv, Rq, stride = _check(q, k_pool, v_pool, seg_src, tok_lo, tok_hi, seg_len, qpk,
                             blk_lo, blk_hi)
    _cuda.require(tok_lo.shape[0] == nb * block_len and block_len % 64 == 0
                  and blk_hi.shape[0] == nb, "B12 takes blocks of a multiple of 64 tokens")
    o = torch.empty_like(q)
    fn = _cuda.bind("lab_flatten", "deft_lab_passes", _PASSES_ARGS)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), int(li) * stride,
             seg_src.data_ptr(), seg_len, tok_lo.data_ptr(), tok_hi.data_ptr(),
             blk_lo.data_ptr(), blk_hi.data_ptr(), o.data_ptr(), Rq, Hkv, qpk, HEAD_DIM, nb,
             block_len, float(scale), _cuda.stream_ptr(q.device))
    _cuda.check(err, "deft_lab_passes")
    lab_passes_attention.launches += 1
    return o


lab_passes_attention.launches = 0


def lab_fused_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                        li: int, seg_src: torch.Tensor, tok_lo: torch.Tensor,
                        tok_hi: torch.Tensor, blk_lo: torch.Tensor, blk_hi: torch.Tensor,
                        scale: float, qpk: int, block_len: int,
                        seg_len: int) -> torch.Tensor:
    """B13: B12's function, every KV head of a token from one read of its
    rows, by blocks of 16 rows over spans of the live 16-token stages,
    then the spans' merge; o (Hkv, Rq, D).  CUDA tensors launch
    csrc/lab_flatten.cu; CPU tensors run the plain version."""
    if q.device.type == "cpu":
        return lab_fused_attention_plain(q, k_pool, v_pool, li, seg_src, tok_lo, tok_hi,
                                         blk_lo, blk_hi, scale, qpk, block_len, seg_len)
    nb = blk_lo.shape[0]
    Hkv, Rq, stride = _check(q, k_pool, v_pool, seg_src, tok_lo, tok_hi, seg_len, qpk,
                             blk_lo, blk_hi)
    _cuda.require(tok_lo.shape[0] == nb * block_len and block_len % 16 == 0
                  and blk_hi.shape[0] == nb and Hkv <= FUSED_MAX_HKV,
                  f"B13 takes blocks of a multiple of 16 tokens, at most {FUSED_MAX_HKV} "
                  "KV heads")
    spans = fused_spans(Rq, nb * block_len // 16, _cuda.sm_count(q.device.index))
    acc, m, l = _states(spans, Hkv, Rq, q.device)
    o = torch.empty_like(q)
    fn = _cuda.bind("lab_flatten", "deft_lab_fused", _FUSED_ARGS)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), int(li) * stride,
             seg_src.data_ptr(), seg_len, tok_lo.data_ptr(), tok_hi.data_ptr(),
             blk_lo.data_ptr(), blk_hi.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
             o.data_ptr(), Rq, Hkv, qpk, HEAD_DIM, nb, block_len, spans, float(scale),
             _cuda.stream_ptr(q.device))
    _cuda.check(err, "deft_lab_fused")
    lab_fused_attention.launches += 1
    return o


lab_fused_attention.launches = 0


def lab_k2_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor, li: int,
                     seg_src: torch.Tensor, tok_lo: torch.Tensor, tok_hi: torch.Tensor,
                     sub_lo: torch.Tensor, sub_hi: torch.Tensor, scale: float, qpk: int,
                     prog_len: int, sub_len: int, seg_len: int, tq: int) -> torch.Tensor:
    """B14: folded q (Hkv, Rq, D) over programs of ``prog_len`` tokens whose
    ``sub_len`` sub-blocks are FULL, masked or dead by ``sub_lo`` /
    ``sub_hi`` (T / sub_len,); with ``tq`` > 0 (rounded up to 16 rows) a
    masked sub-block updates only the row tiles that meet its leaves.
    Spans of the live programs, then their merge; o (Hkv, Rq, D).  CUDA
    tensors launch csrc/lab_flatten.cu; CPU tensors run the plain
    version."""
    if q.device.type == "cpu":
        return lab_k2_attention_plain(q, k_pool, v_pool, li, seg_src, tok_lo, tok_hi,
                                      sub_lo, sub_hi, scale, qpk, prog_len, sub_len,
                                      seg_len, tq)
    T = tok_lo.shape[0]
    Hkv, Rq, stride = _check(q, k_pool, v_pool, seg_src, tok_lo, tok_hi, seg_len, qpk,
                             sub_lo, sub_hi)
    _cuda.require(sub_len % 64 == 0 and prog_len % sub_len == 0 and T % prog_len == 0
                  and sub_lo.shape[0] == T // sub_len and sub_hi.shape == sub_lo.shape
                  and tq >= 0,
                  "B14 takes programs of whole sub-blocks of a multiple of 64 tokens")
    n_prog = T // prog_len
    spans = k2_spans(Rq, Hkv, n_prog, _cuda.sm_count(q.device.index))
    acc, m, l = _states(spans, Hkv, Rq, q.device)
    o = torch.empty_like(q)
    fn = _cuda.bind("lab_flatten", "deft_lab_k2", _K2_ARGS)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), int(li) * stride,
             seg_src.data_ptr(), seg_len, tok_lo.data_ptr(), tok_hi.data_ptr(),
             sub_lo.data_ptr(), sub_hi.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
             o.data_ptr(), Rq, Hkv, qpk, HEAD_DIM, n_prog, prog_len, sub_len, int(tq), spans,
             float(scale), _cuda.stream_ptr(q.device))
    _cuda.check(err, "deft_lab_k2")
    lab_k2_attention.launches += 1
    return o


lab_k2_attention.launches = 0
