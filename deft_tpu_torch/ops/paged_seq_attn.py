"""Sequential per-leaf decode attention over the paged KV pool: the fair
seq (Flash-Decoding) baseline.

Port of deft_tpu/ops/paged_seq_attn.py:328 (paged_seq_attention, the Pallas
kernel _paged_seq_kernel :41) and :403 (paged_seq_attn_pallas), and of its
int8 variant :369 (paged_seq_attention_q, the same kernel with
quantized=True) and :429 (paged_seq_attn_q_pallas).  The Hopper kernels are
csrc/paged_seq.cu's two entries; ``paged_seq_attention_plain`` and
``paged_seq_attention_q_plain`` are the same functions in plain torch over
the same plan arrays, which the wrappers run for CPU tensors only.
``launch_seq``, ``path_attention_plain`` and ``seq_splits`` also serve B7
(ops/seq_attn.py, plans that are not segment-aligned).  Over bf16 q, B2,
B2p, B5, B5p and B7 run one tensor-core body (csrc/seq_q_body.cuh) that
may split each path over the blocks of a cluster (``seq_splits``); fp32 q
keeps one block a (leaf, head).

B2p and B5p, ``paged_seq_attention_partial`` and
``paged_seq_attention_q_partial``, port deft_tpu's partial=True entries
(paged_seq_attn.py:351, :389), which the multi-device engine runs on each
rank's span of every leaf's path blocks (parallel/seq_engine.py): the same
kernel with seq_body.cuh's partial epilogue, writing each leaf's
unnormalised state acc (R, Hq, D), m and l (R, Hq), fp32, m in natural-log
units (deft_tpu's (R, Hkv, qpk, D) with m and l broadcast over D).

Plan format (deft_tpu plan/seq.py, unchanged): leaf r's path is nb blocks of
spb = block_len / seg_len segments; segment (r, j) holds the live pool rows
[seg_src + seg_off, + seg_live); blk_live (R * nb,) is 0 for blocks with no
live token.  Every leaf reads its whole path, shared prefix included.
int8 pools hold codes with per-(token, head) fp32 scales, (L, Hkv, S).
"""

from __future__ import annotations

import ctypes

import torch

from deft_tpu_torch.models.llama import KVPool, kv_gather_heads
from deft_tpu_torch.ops import _cuda
from deft_tpu_torch.ops.dense_oracle import (dense_path_attention,
                                              dense_path_attention_state)
from deft_tpu_torch.ops.paged_flatten_attn import PAGED_WIDTHS, check_pools

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def segment_paths(seg_src, seg_off, seg_live, blk_live, R: int, seg_len: int):
    """Per-leaf padded paths of a paged plan: ((R, C) pool rows, (R, C) live
    mask), C = segments per leaf * seg_len."""
    nseg = seg_src.shape[0] // R
    spb = nseg // (blk_live.shape[0] // R)
    i = torch.arange(seg_len, device=seg_src.device)
    rows = (seg_src.view(R, nseg, 1).long() + i).reshape(R, -1)
    off = seg_off.view(R, nseg, 1)
    live = (i >= off) & (i < off + seg_live.view(R, nseg, 1))
    live = live & (blk_live.view(R, -1, 1) > 0).repeat_interleave(spb, dim=1)
    return rows, live.reshape(R, -1)


def path_attention_plain(q, k_pool, v_pool, li, rows, live, scale,
                         k_scale=None, v_scale=None, state=False):
    """The seq kernels' function in plain torch: leaf r attends the pool
    rows rows[r, c] where live[r, c] (int8 rows dequantised in fp32, as the
    kernels keep the codes exact and the scales in fp32).  ``state``: the
    partial entries' unnormalised (acc, m, l) instead."""
    D = q.shape[-1]
    k = kv_gather_heads(KVPool(k_pool, k_scale), li, rows, D, torch.float32)
    v = kv_gather_heads(KVPool(v_pool, v_scale), li, rows, D, torch.float32)
    if state:
        return dense_path_attention_state(q, k, v, live, scale)
    return dense_path_attention(q, k, v, live, scale)


def paged_seq_attention_plain(q, k_pool, v_pool, li, seg_src, seg_off,
                              seg_live, blk_live, scale, seg_len):
    """B2's function in plain torch: each leaf's path read through its
    segment table, then attention over its live tokens."""
    rows, live = segment_paths(seg_src, seg_off, seg_live, blk_live,
                               q.shape[0], seg_len)
    return path_attention_plain(q, k_pool, v_pool, li, rows, live, scale)


def paged_seq_attention_q_plain(q, k_pool, v_pool, k_scale, v_scale, li,
                                seg_src, seg_off, seg_live, blk_live, scale,
                                seg_len):
    """B5's function in plain torch: B2's over int8 rows dequantised in
    fp32."""
    rows, live = segment_paths(seg_src, seg_off, seg_live, blk_live,
                               q.shape[0], seg_len)
    return path_attention_plain(q, k_pool, v_pool, li, rows, live, scale,
                                k_scale, v_scale)


def paged_seq_attention_partial_plain(q, k_pool, v_pool, li, seg_src, seg_off,
                                      seg_live, blk_live, scale, seg_len):
    """B2p's function in plain torch: B2's attention over each leaf's path
    blocks in the tables, as its unnormalised state."""
    rows, live = segment_paths(seg_src, seg_off, seg_live, blk_live,
                               q.shape[0], seg_len)
    return path_attention_plain(q, k_pool, v_pool, li, rows, live, scale,
                                state=True)


def paged_seq_attention_q_partial_plain(q, k_pool, v_pool, k_scale, v_scale, li,
                                        seg_src, seg_off, seg_live, blk_live,
                                        scale, seg_len):
    """B5p's function in plain torch: B5's attention as its unnormalised
    state."""
    rows, live = segment_paths(seg_src, seg_off, seg_live, blk_live,
                               q.shape[0], seg_len)
    return path_attention_plain(q, k_pool, v_pool, li, rows, live, scale,
                                k_scale, v_scale, state=True)


def launch_seq(source: str, entry: str, argtypes: list, q, k_pool, v_pool,
               k_scale, v_scale, li, plan_arrays, lead, tail, scale,
               partial: bool = False, widths=PAGED_WIDTHS):
    """Launch a seq kernel of csrc/<source>.cu on q (R, Hq, D).  Its C
    arguments: q, k and v pools, k and v scales, o (a partial entry: acc, m,
    l), layer and scale offsets, S, *plan_arrays, R, *lead, Hq, Hkv, D,
    *tail, dtype, scale, stream.  Returns (R, Hq, D), or for a ``partial``
    entry (acc (R, Hq, D), m, l (R, Hq)), fp32."""
    R, Hq, D = q.shape
    L, S, HD = k_pool.shape
    Hkv = check_pools(q, k_pool, v_pool, k_scale, v_scale, widths)
    _cuda.require(Hq // Hkv <= 8, "more than 8 q heads per KV head")
    for t in plan_arrays:
        _cuda.require(t.dtype == torch.int32 and t.is_contiguous(),
                      "plan arrays must be contiguous int32")
    scales = [s for s in (k_scale, v_scale) if s is not None]
    _cuda.require_device(q, k_pool, v_pool, *scales, *plan_arrays)
    q = q.contiguous()
    if partial:
        out = (torch.empty(q.shape, dtype=torch.float32, device=q.device),
               torch.empty((R, Hq), dtype=torch.float32, device=q.device),
               torch.empty((R, Hq), dtype=torch.float32, device=q.device))
    else:
        out = (torch.empty_like(q),)
    fn = _cuda.bind(source, entry, argtypes)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             _cuda.ptr(k_scale), _cuda.ptr(v_scale), *(t.data_ptr() for t in out),
             int(li) * S * HD, int(li) * Hkv * S, S,
             *(t.data_ptr() for t in plan_arrays), R, *lead, Hq, Hkv, D, *tail,
             _cuda.dtype_code(q.dtype), float(scale), _cuda.stream_ptr(q.device))
    _cuda.check(err, entry)
    return out if partial else out[0]


# (q, k, v, ks, vs, o, layer_off, scale_off, S, seg_src, seg_off, seg_live,
#  blk_live, R, Hq, Hkv, D, nseg, spb, splits, dtype, scale, stream)
_PAGED_SEQ_ARGS = [_P, _P, _P, _P, _P, _P, _LL, _LL, _I, _P, _P, _P, _P,
                   _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P]
# the tensor-core bodies over bf16 q: blocks a cluster may split one (leaf,
# head)'s path over, and how many of its blocks an SM holds, by pool type:
# at head_dim 64 and 128, int8 (B5) 57 KB of shared memory a block, bf16
# (B2) 104 KB at D = 128; at 96 and 256 (B7's wide body, 2 warps of 3
# stages of 16 K and V rows of 2 D + 16 bytes, or D + 16 and the scales),
# what 228 KB holds at 1 KB reserved a block
_MAX_SPLITS = 8
_BLOCKS_PER_SM = {"int8": 3, "bfloat16": 2}
_WIDE_BLOCKS_PER_SM = {(96, "bfloat16"): 5, (96, "int8"): 10,
                       (256, "bfloat16"): 2, (256, "int8"): 4}


def seq_splits(R: int, Hkv: int, sms: int, int8: bool = True, D: int = 128) -> int:
    """Blocks of a cluster that share each (leaf, KV head)'s path in the
    tensor-core bodies (bf16 q; int8 pools, else bf16; head_dim D): enough
    that the R * Hkv pairs fill the SMs' resident blocks, at most 8; 1
    where the pairs alone fill them (the 8B main tree, 64 x 8 pairs).  Each
    block takes a contiguous share of the path's 16-token tiles, computed
    on the device from the segment table (B2, B5) or the path's length
    (B7): the host needs no path length."""
    pool = "int8" if int8 else "bfloat16"
    per_sm = _WIDE_BLOCKS_PER_SM.get((D, pool)) or _BLOCKS_PER_SM[pool]
    return max(1, min(_MAX_SPLITS, -(-per_sm * sms // max(1, R * Hkv))))


# the partial entries: acc, m, l where the others take o
_PAGED_SEQ_PARTIAL_ARGS = _PAGED_SEQ_ARGS[:6] + [_P, _P] + _PAGED_SEQ_ARGS[6:]


def _launch_paged(entry, q, k_pool, v_pool, k_scale, v_scale, li, seg_src,
                  seg_off, seg_live, blk_live, scale, partial=False):
    R = q.shape[0]
    splits = 1  # only the tensor-core body (bf16 q) splits paths
    if q.dtype == torch.bfloat16:
        splits = seq_splits(R, k_pool.shape[-1] // q.shape[-1],
                            _cuda.sm_count(q.device.index), k_scale is not None)
    nseg = seg_src.shape[0] // R
    nb = blk_live.shape[0] // R
    _cuda.require(nseg * R == seg_src.shape[0] and nb * R == blk_live.shape[0]
                  and nb > 0 and nseg % nb == 0
                  and seg_off.shape == seg_live.shape == seg_src.shape,
                  "plan arrays disagree with the leaf count")
    return launch_seq("paged_seq", entry,
                      _PAGED_SEQ_PARTIAL_ARGS if partial else _PAGED_SEQ_ARGS, q,
                      k_pool, v_pool, k_scale, v_scale, li,
                      (seg_src, seg_off, seg_live, blk_live), (),
                      (nseg, nseg // nb, splits), scale, partial)


def paged_seq_attention(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, li: int, seg_src: torch.Tensor,
                        seg_off: torch.Tensor, seg_live: torch.Tensor,
                        blk_live: torch.Tensor, scale: float,
                        seg_len: int) -> torch.Tensor:
    """Each leaf of q (R, Hq, D) attends its own root-to-leaf path read from
    the (L, S, Hkv*D) pools; returns (R, Hq, D).  CUDA tensors launch
    csrc/paged_seq.cu; CPU tensors run the plain version."""
    if q.device.type == "cpu":
        return paged_seq_attention_plain(q, k_pool, v_pool, li, seg_src,
                                         seg_off, seg_live, blk_live, scale,
                                         seg_len)
    o = _launch_paged("deft_paged_seq", q, k_pool, v_pool, None, None, li,
                      seg_src, seg_off, seg_live, blk_live, scale)
    paged_seq_attention.launches += 1
    return o


paged_seq_attention.launches = 0


def paged_seq_attention_q(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, k_scale: torch.Tensor,
                          v_scale: torch.Tensor, li: int,
                          seg_src: torch.Tensor, seg_off: torch.Tensor,
                          seg_live: torch.Tensor, blk_live: torch.Tensor,
                          scale: float, seg_len: int) -> torch.Tensor:
    """B2 over int8 (L, S, Hkv*D) pools and their (L, Hkv, S) scales;
    returns (R, Hq, D).  CUDA tensors launch csrc/paged_seq.cu's int8 entry;
    CPU tensors run the plain version."""
    if q.device.type == "cpu":
        return paged_seq_attention_q_plain(q, k_pool, v_pool, k_scale,
                                           v_scale, li, seg_src, seg_off,
                                           seg_live, blk_live, scale, seg_len)
    _cuda.require(k_scale is not None and v_scale is not None,
                  "the int8 seq kernel takes scale pools")
    o = _launch_paged("deft_paged_seq_q", q, k_pool, v_pool, k_scale, v_scale,
                      li, seg_src, seg_off, seg_live, blk_live, scale)
    paged_seq_attention_q.launches += 1
    return o


paged_seq_attention_q.launches = 0


def paged_seq_attention_partial(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor, li: int,
                                seg_src: torch.Tensor, seg_off: torch.Tensor,
                                seg_live: torch.Tensor, blk_live: torch.Tensor,
                                scale: float, seg_len: int):
    """B2p: each leaf of q (R, Hq, D) over the path blocks in its tables, as
    the unnormalised state acc (R, Hq, D), m and l (R, Hq), fp32, m in
    natural-log units.  CUDA tensors launch csrc/paged_seq.cu's partial
    entry; CPU tensors run the plain version."""
    if q.device.type == "cpu":
        return paged_seq_attention_partial_plain(q, k_pool, v_pool, li, seg_src,
                                                 seg_off, seg_live, blk_live,
                                                 scale, seg_len)
    out = _launch_paged("deft_paged_seq_partial", q, k_pool, v_pool, None, None,
                        li, seg_src, seg_off, seg_live, blk_live, scale,
                        partial=True)
    paged_seq_attention_partial.launches += 1
    return out


paged_seq_attention_partial.launches = 0


def paged_seq_attention_q_partial(q: torch.Tensor, k_pool: torch.Tensor,
                                  v_pool: torch.Tensor, k_scale: torch.Tensor,
                                  v_scale: torch.Tensor, li: int,
                                  seg_src: torch.Tensor, seg_off: torch.Tensor,
                                  seg_live: torch.Tensor, blk_live: torch.Tensor,
                                  scale: float, seg_len: int):
    """B5p: B2p over int8 pools and their (L, Hkv, S) scales.  CUDA tensors
    launch csrc/paged_seq.cu's int8 partial entry; CPU tensors run the plain
    version."""
    if q.device.type == "cpu":
        return paged_seq_attention_q_partial_plain(q, k_pool, v_pool, k_scale,
                                                   v_scale, li, seg_src, seg_off,
                                                   seg_live, blk_live, scale,
                                                   seg_len)
    _cuda.require(k_scale is not None and v_scale is not None,
                  "the int8 seq kernel takes scale pools")
    out = _launch_paged("deft_paged_seq_q_partial", q, k_pool, v_pool, k_scale,
                        v_scale, li, seg_src, seg_off, seg_live, blk_live, scale,
                        partial=True)
    paged_seq_attention_q_partial.launches += 1
    return out


paged_seq_attention_q_partial.launches = 0
