"""DeFT-Flatten tree-decode attention over the paged KV pool.

Port of deft_tpu/ops/paged_flatten_attn.py:381 (paged_flatten_attention, the
Pallas kernel _paged_kernel :63) and :458 (paged_flatten_attn_pallas).  The
Hopper kernel is csrc/paged_flatten.cu: over bf16 q the tensor-core body of
csrc/flat_q_body.cuh (spans of the live 64-token tiles from the SM count,
``q_spans``), over fp32 q the staged split-KV body, each followed by the LSE
merge kernel of the spans' states; ``paged_flatten_attention_plain`` is the
same function in plain torch over the same plan arrays, which the wrapper
runs for CPU tensors only.  ``launch_flatten`` and ``tree_attention_plain``
serve the other flatten kernels too: B4 (ops/paged_quant.py, int8 pools),
B6 (ops/flatten_attn.py) and B11 (ops/sharded_flatten.py), plans that are
not segment-aligned, on the same bodies.

B1p, ``paged_flatten_attention_partial``, is the port of deft_tpu's
partial=True entry (paged_flatten_attn.py:408), which the multi-device
engine runs on each rank's span of plan blocks (parallel/engine.py): the
same kernels, writing the merged unnormalised state (acc, m, l) of the
plan's blocks instead of o, folded rows (Hkv, R*qpk) as deft_tpu lays them
out, m in natural-log units (``tree_attention_state_plain`` is its
arithmetic).

Plan format (deft_tpu plan/flatten.py, unchanged): the tree's KV in DFS
order, ``block_len`` tokens per block; segment j of block b is the pool span
[seg_src[b * nseg + j], + seg_len); leaf r sees token t iff
tok_lo[t] <= r < tok_hi[t]; blocks with blk_lo >= blk_hi are dead, and
blk_lo < -(1 << 20) (FULL_BLOCK_LO) marks a block every leaf sees in full.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from deft_tpu_torch.models.llama import KVPool, kv_gather_heads
from deft_tpu_torch.ops import _cuda
from deft_tpu_torch.ops.dense_oracle import (dense_tree_attention,
                                              dense_tree_attention_state)

_FULL_THRESHOLD = -(1 << 20)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the C signature every flatten entry shares (csrc/paged_flatten.cu,
# csrc/flatten_gather.cu)
_FLATTEN_ARGS = [_P, _P, _P, _P, _P, _LL, _LL, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                 _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P]
# the partial entries: acc_o, m_o, l_o where the others take o
_FLATTEN_PARTIAL_ARGS = _FLATTEN_ARGS[:17] + [_P, _P] + _FLATTEN_ARGS[17:]


def segment_rows(seg_src: torch.Tensor, seg_len: int) -> torch.Tensor:
    """(T,) pool row of each plan token of a paged plan (T = len(seg_src)
    * seg_len)."""
    return (seg_src[:, None].long()
            + torch.arange(seg_len, device=seg_src.device)).reshape(-1)


def leaf_intervals(tok_lo, tok_hi, blk_lo, blk_hi, block_len: int, R: int):
    """Each plan token's leaf interval [lo, hi) as the flatten kernels read
    it for R rows: FULL blocks seen by every row (the kernels take no mask
    there), dead blocks by none."""
    is_full = blk_lo < _FULL_THRESHOLD
    full = is_full.repeat_interleave(block_len)
    dead = ((blk_lo >= blk_hi) & ~is_full).repeat_interleave(block_len)
    lo = torch.where(full, torch.zeros_like(tok_lo), tok_lo)
    hi = torch.where(full, torch.full_like(tok_hi, R), tok_hi)
    return lo, torch.where(dead, torch.zeros_like(hi), hi)


def _tree_inputs(q, k_pool, v_pool, li, rows, tok_lo, tok_hi, blk_lo, blk_hi,
                 block_len, k_scale, v_scale):
    """(k, v, lo, hi) the flatten kernels attend: plan token t read from
    pool row rows[t] (int8 rows dequantised in fp32, as the kernels keep the
    codes exact and the scales in fp32), and its leaf_intervals."""
    D = q.shape[-1]
    k = kv_gather_heads(KVPool(k_pool, k_scale), li, rows, D, torch.float32)
    v = kv_gather_heads(KVPool(v_pool, v_scale), li, rows, D, torch.float32)
    return (k, v, *leaf_intervals(tok_lo, tok_hi, blk_lo, blk_hi, block_len,
                                  q.shape[0]))


def tree_attention_plain(q, k_pool, v_pool, li, rows, tok_lo, tok_hi, blk_lo,
                         blk_hi, scale, block_len, k_scale=None, v_scale=None):
    """The flatten kernels' function in plain torch: the plan tokens read
    through ``rows`` (``_tree_inputs``), then exact masked attention."""
    k, v, lo, hi = _tree_inputs(q, k_pool, v_pool, li, rows, tok_lo, tok_hi,
                                blk_lo, blk_hi, block_len, k_scale, v_scale)
    return dense_tree_attention(q, k, v, lo, hi, scale)


def fold_rows(x: torch.Tensor, Hkv: int) -> torch.Tensor:
    """(R, Hq, ...) -> (Hkv, R*qpk, ...): folded row r*qpk + g is query head
    h*qpk + g of leaf r (deft_tpu flatten_attn.py:54 fold_q)."""
    R, Hq = x.shape[:2]
    qpk = Hq // Hkv
    return (x.reshape(R, Hkv, qpk, *x.shape[2:]).transpose(0, 1)
            .reshape(Hkv, R * qpk, *x.shape[2:]))


def unfold_rows(x: torch.Tensor, R: int) -> torch.Tensor:
    """fold_rows' inverse: (Hkv, R*qpk, ...) -> (R, Hq, ...)."""
    Hkv, Rq = x.shape[:2]
    qpk = Rq // R
    return (x.reshape(Hkv, R, qpk, *x.shape[2:]).transpose(0, 1)
            .reshape(R, Hkv * qpk, *x.shape[2:]))


def tree_attention_state_plain(q, k_pool, v_pool, li, rows, tok_lo, tok_hi,
                               blk_lo, blk_hi, scale, block_len, k_scale=None,
                               v_scale=None):
    """The flatten kernels' partial form in plain torch: the unnormalised
    state of tree_attention_plain's attention, acc (Hkv, R*qpk, D), m and l
    (Hkv, R*qpk), fp32, m in natural-log units."""
    k, v, lo, hi = _tree_inputs(q, k_pool, v_pool, li, rows, tok_lo, tok_hi,
                                blk_lo, blk_hi, block_len, k_scale, v_scale)
    Hkv = k.shape[1]
    return tuple(fold_rows(x, Hkv)
                 for x in dense_tree_attention_state(q, k, v, lo, hi, scale))


def paged_flatten_attention_plain(q, k_pool, v_pool, li, seg_src, tok_lo,
                                  tok_hi, blk_lo, blk_hi, scale, block_len,
                                  seg_len):
    """B1's function in plain torch: the flattened KV read through the
    segment table, then exact masked attention."""
    return tree_attention_plain(q, k_pool, v_pool, li,
                                segment_rows(seg_src, seg_len), tok_lo, tok_hi,
                                blk_lo, blk_hi, scale, block_len)


def paged_flatten_attention_partial_plain(q, k_pool, v_pool, li, seg_src,
                                          tok_lo, tok_hi, blk_lo, blk_hi, scale,
                                          block_len, seg_len):
    """B1p's function in plain torch: B1's attention over the plan's
    blocks, as its unnormalised state."""
    return tree_attention_state_plain(q, k_pool, v_pool, li,
                                      segment_rows(seg_src, seg_len), tok_lo,
                                      tok_hi, blk_lo, blk_hi, scale, block_len)


def num_spans(num_blocks: int, kv_bytes: int, state_bytes: int) -> int:
    """Split-KV span count: the partial state written (state_bytes per
    span) stays at most a quarter of the KV read, and no span is empty."""
    return max(1, min(num_blocks, kv_bytes // max(4 * state_bytes, 1)))


def q_block_rows(rq: int) -> int:
    """Folded rows a block of the body over bf16 q takes (csrc/
    paged_flatten.cu, deft_flat_q): 128 (8 warps) where a KV head has more
    than 64 rows, else 64."""
    return 128 if rq > 64 else 64


def q_spans(rq: int, Hkv: int, nb: int, block_len: int, sms: int) -> int:
    """Split-KV span count of the body over bf16 q: as many spans as fill
    the SMs with one block each next to the (row tile, KV head) pairs, and
    no more than the plan's 64-token tiles, so no span is empty."""
    pairs = -(-rq // q_block_rows(rq)) * Hkv
    return max(1, min(nb * (block_len // 64), sms // pairs))


def row_tile_tiles(blk_lo, blk_hi, rq: int, qpk: int, block_len: int) -> tuple:
    """Per row tile of ``q_block_rows(rq)`` folded rows, the 64-token tiles
    of the plan blocks it sees, as warp 0 of csrc/flat_q_body.cuh lists
    them: a FULL block, or a live block whose leaf interval meets the
    tile's leaves.  Host numpy over the plan's (nb,) blk_lo / blk_hi, read
    before upload."""
    blk_lo, blk_hi = np.asarray(blk_lo), np.asarray(blk_hi)
    rb, full = q_block_rows(rq), blk_lo < _FULL_THRESHOLD
    return tuple(int(((blk_hi > r0 // qpk)
                      & (full | ((blk_lo < blk_hi)
                                 & (blk_lo <= (min(rq, r0 + rb) - 1) // qpk)))).sum())
                 * (block_len // 64) for r0 in range(0, rq, rb))


def balanced_spans(row_tiles, Hkv: int, sms: int) -> int:
    """Span count of the body over bf16 q from the row tiles' work (a
    multi-tree plan's are very unequal): one wave of blocks, as q_spans
    takes, unless the busiest row tile's tiles against the card's share
    (all listed tiles of every KV head over the SMs, rounded) ask for half
    again as many spans or more; then that many, so the busiest block holds
    about one SM's share and the lighter blocks fill the SMs it leaves.  A
    smaller excess costs a partial second wave more than the shorter blocks
    save (on an H100, PERF.md §6).  Never more spans than the
    busiest row tile's tiles."""
    busiest, total = max(row_tiles), sum(row_tiles)
    if busiest == 0:
        return 1
    one_wave = max(1, sms // (len(row_tiles) * Hkv))
    even = (2 * busiest * sms + total * Hkv) // (2 * total * Hkv)
    return max(1, min(busiest, even if 2 * even >= 3 * one_wave else one_wave))


# head widths of the paged kernels (deft_tpu's paged plans need 128 % D ==
# 0) and of the gather kernels B6, B7 and B11 (Phi-3-mini's 96 and Gemma's
# 256 too, which only gather plans reach); over bf16 q every width runs
# deft_flat_q
PAGED_WIDTHS = (64, 128)
GATHER_WIDTHS = (64, 96, 128, 256)


def span_count(dtype, Rq: int, Hkv: int, D: int, nb: int, block_len: int,
               kv_bytes: int, sms: int, row_tiles: Optional[Sequence[int]] = None) -> int:
    """The spans launch_flatten gives a flatten kernel: over bf16 q (the
    tensor-core body, deft_flat_q, at every head width) ``q_spans``, or
    ``balanced_spans`` where the caller gives the plan's ``row_tiles``;
    over fp32 q (the staged body) ``num_spans`` from the KV bytes read."""
    if dtype == torch.bfloat16:
        if row_tiles is None:
            return q_spans(Rq, Hkv, nb, block_len, sms)
        _cuda.require(len(row_tiles) == -(-Rq // q_block_rows(Rq)),
                      "row_tiles disagree with q's rows")
        return balanced_spans(row_tiles, Hkv, sms)
    return num_spans(nb, kv_bytes, Hkv * Rq * (D + 2) * 4)


def check_pools(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                k_scale: Optional[torch.Tensor],
                v_scale: Optional[torch.Tensor],
                widths: Sequence[int] = PAGED_WIDTHS) -> int:
    """Refuse pools the kernels do not take; returns Hkv.  Pools hold the
    q dtype, or int8 with (L, Hkv, S) fp32 scales; head_dim one of
    ``widths``."""
    R, Hq, D = q.shape
    L, S, HD = k_pool.shape
    Hkv = HD // D
    _cuda.require(Hkv * D == HD and Hq % Hkv == 0, "pool width != Hkv * D")
    _cuda.require(v_pool.shape == k_pool.shape and v_pool.dtype == k_pool.dtype,
                  "k/v pools differ")
    _cuda.require(D in widths, f"head_dim {D}: the kernels take {widths}")
    _cuda.dtype_code(q.dtype)
    if k_scale is None:
        _cuda.require(v_scale is None and k_pool.dtype == q.dtype,
                      "pools of another dtype than q need int8 data and scales")
    else:
        _cuda.require(k_pool.dtype == torch.int8 and v_scale is not None,
                      "scales come with int8 pools, for K and V")
        for s in (k_scale, v_scale):
            _cuda.require(s.shape == (L, Hkv, S) and s.dtype == torch.float32
                          and s.is_contiguous(),
                          "scale pools must be contiguous (L, Hkv, S) float32")
    _cuda.require(k_pool.is_contiguous() and v_pool.is_contiguous(),
                  "pools must be contiguous")
    return Hkv


def launch_flatten(source: str, entry: str, q, k_pool, v_pool, k_scale,
                   v_scale, li, rows, tok_lo, tok_hi, blk_lo, blk_hi, scale,
                   block_len, seg_len, partial: bool = False,
                   row_tiles: Optional[Sequence[int]] = None):
    """Launch a flatten kernel of csrc/<source>.cu on q (R, Hq, D);
    ``rows`` is the segment table (paged plans, seg_len > 0) or one pool
    index a token (seg_len 0).  bf16 q runs the tensor-core body (B1, B4,
    B6 and their partial entries, at every head width) and fp32 q the
    staged body, on ``span_count``'s spans (``row_tiles``: the plan's
    ``row_tile_tiles``, counted on the host); the merge kernel follows
    either.  Returns (R, Hq, D), or for a ``partial`` entry the state (acc
    (Hkv, R*qpk, D), m, l (Hkv, R*qpk)), fp32."""
    R, Hq, D = q.shape
    L, S, HD = k_pool.shape
    Hkv = check_pools(q, k_pool, v_pool, k_scale, v_scale,
                      PAGED_WIDTHS if seg_len else GATHER_WIDTHS)
    nb = blk_lo.shape[0]
    T = tok_lo.shape[0]
    _cuda.require(T == nb * block_len and block_len % 64 == 0
                  and tok_hi.shape[0] == T and blk_hi.shape[0] == nb
                  and rows.shape[0] == (T // seg_len if seg_len else T)
                  and (not seg_len or block_len % seg_len == 0),
                  "plan arrays disagree with block_len / seg_len")
    for t in (rows, tok_lo, tok_hi, blk_lo, blk_hi):
        _cuda.require(t.dtype == torch.int32 and t.is_contiguous(),
                      "plan arrays must be contiguous int32")
    scales = [s for s in (k_scale, v_scale) if s is not None]
    _cuda.require_device(q, k_pool, v_pool, *scales, rows, tok_lo, tok_hi,
                         blk_lo, blk_hi)
    q = q.contiguous()
    Rq = R * (Hq // Hkv)
    kv_bytes = T * HD * 2 * k_pool.element_size() + (T * Hkv * 8 if scales else 0)
    spans = span_count(q.dtype, Rq, Hkv, D, nb, block_len, kv_bytes,
                       _cuda.sm_count(q.device.index), row_tiles)
    if q.dtype == torch.bfloat16:  # the ring copies the leaf intervals in 16-byte chunks
        tok_lo, tok_hi = _cuda.aligned16(tok_lo), _cuda.aligned16(tok_hi)
    acc = torch.empty((spans, Hkv, Rq, D), dtype=torch.float32, device=q.device)
    m = torch.empty((spans, Hkv, Rq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    if partial:
        out = (torch.empty((Hkv, Rq, D), dtype=torch.float32, device=q.device),
               torch.empty((Hkv, Rq), dtype=torch.float32, device=q.device),
               torch.empty((Hkv, Rq), dtype=torch.float32, device=q.device))
    else:
        out = (torch.empty_like(q),)
    fn = _cuda.bind(source, entry, _FLATTEN_PARTIAL_ARGS if partial else _FLATTEN_ARGS)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             _cuda.ptr(k_scale), _cuda.ptr(v_scale), int(li) * S * HD,
             int(li) * Hkv * S, S, rows.data_ptr(), tok_lo.data_ptr(),
             tok_hi.data_ptr(), blk_lo.data_ptr(), blk_hi.data_ptr(),
             acc.data_ptr(), m.data_ptr(), l.data_ptr(), *(t.data_ptr() for t in out),
             R, Hq, Hkv, D, nb, block_len, seg_len, spans,
             _cuda.dtype_code(q.dtype), float(scale), _cuda.stream_ptr(q.device))
    _cuda.check(err, entry)
    return out if partial else out[0]


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
    _cuda.require(seg_len > 0, "a paged plan has a segment length")
    o = launch_flatten("paged_flatten", "deft_paged_flatten", q, k_pool, v_pool,
                       None, None, li, seg_src, tok_lo, tok_hi, blk_lo, blk_hi,
                       scale, block_len, seg_len)
    paged_flatten_attention.launches += 1
    return o


paged_flatten_attention.launches = 0


def paged_flatten_attention_partial(q: torch.Tensor, k_pool: torch.Tensor,
                                    v_pool: torch.Tensor, li: int,
                                    seg_src: torch.Tensor, tok_lo: torch.Tensor,
                                    tok_hi: torch.Tensor, blk_lo: torch.Tensor,
                                    blk_hi: torch.Tensor, scale: float,
                                    block_len: int, seg_len: int):
    """B1p: the unnormalised state of q (R, Hq, D) over the plan's blocks
    read from the (L, S, Hkv*D) pools: acc (Hkv, R*qpk, D), m and l
    (Hkv, R*qpk), fp32, m in natural-log units.  CUDA tensors launch
    csrc/paged_flatten.cu's partial entry; CPU tensors run the plain
    version."""
    if q.device.type == "cpu":
        return paged_flatten_attention_partial_plain(
            q, k_pool, v_pool, li, seg_src, tok_lo, tok_hi, blk_lo, blk_hi,
            scale, block_len, seg_len)
    _cuda.require(seg_len > 0, "a paged plan has a segment length")
    out = launch_flatten("paged_flatten", "deft_paged_flatten_partial", q, k_pool,
                         v_pool, None, None, li, seg_src, tok_lo, tok_hi, blk_lo,
                         blk_hi, scale, block_len, seg_len, partial=True)
    paged_flatten_attention_partial.launches += 1
    return out


paged_flatten_attention_partial.launches = 0
