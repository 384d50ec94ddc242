"""Sequential per-leaf decode attention over the paged KV pool: the fair
seq (Flash-Decoding) baseline.

Port of deft_tpu/ops/paged_seq_attn.py:328 (paged_seq_attention, the Pallas
kernel _paged_seq_kernel :41) and :403 (paged_seq_attn_pallas).  The Hopper
kernel is csrc/paged_seq.cu; ``paged_seq_attention_plain`` is the same
function in plain torch over the same plan arrays, which the wrapper runs
for CPU tensors only.

Plan format (deft_tpu plan/seq.py, unchanged): leaf r's path is nb blocks of
spb = block_len / seg_len segments; segment (r, j) holds the live pool rows
[seg_src + seg_off, + seg_live); blk_live (R * nb,) is 0 for blocks with no
live token.  Every leaf reads its whole path, shared prefix included.
"""

from __future__ import annotations

import ctypes

import torch

from deft_tpu_torch.ops import _cuda
from deft_tpu_torch.ops.dense_oracle import dense_path_attention


def path_kv(pool: torch.Tensor, li: int, seg_src: torch.Tensor,
            seg_off: torch.Tensor, seg_live: torch.Tensor,
            blk_live: torch.Tensor, R: int, seg_len: int, head_dim: int):
    """Per-leaf padded paths of layer ``li``: ((R, C, Hkv, D) rows, (R, C)
    live mask), C = segments per leaf * seg_len."""
    nseg = seg_src.shape[0] // R
    spb = nseg // (blk_live.shape[0] // R)
    i = torch.arange(seg_len, device=seg_src.device)
    addr = (seg_src.view(R, nseg, 1).long() + i).reshape(R, -1)
    off = seg_off.view(R, nseg, 1)
    live = (i >= off) & (i < off + seg_live.view(R, nseg, 1))
    live = live & (blk_live.view(R, -1, 1) > 0).repeat_interleave(spb, dim=1)
    rows = pool[li].index_select(0, addr.reshape(-1))
    return rows.view(R, addr.shape[1], -1, head_dim), live.reshape(R, -1)


def paged_seq_attention_plain(q, k_pool, v_pool, li, seg_src, seg_off,
                              seg_live, blk_live, scale, seg_len):
    """The kernel's function in plain torch: gather each leaf's path
    through its segment table, then attention over its live tokens."""
    R, _, D = q.shape
    k, live = path_kv(k_pool, li, seg_src, seg_off, seg_live, blk_live, R,
                      seg_len, D)
    v, _ = path_kv(v_pool, li, seg_src, seg_off, seg_live, blk_live, R,
                   seg_len, D)
    return dense_path_attention(q, k, v, live, scale)


def _fn():
    fn = _cuda.library("paged_seq").deft_paged_seq
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, ctypes.c_longlong, P, P, P, P,
                       I, I, I, I, I, I, I, ctypes.c_float, P]
        fn.restype = I
    return fn


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
    R, Hq, D = q.shape
    L, S, HD = k_pool.shape
    Hkv = HD // D
    nseg = seg_src.shape[0] // R
    nb = blk_live.shape[0] // R
    _cuda.require(Hkv * D == HD and Hq % Hkv == 0 and Hq // Hkv <= 8,
                  "pool width != Hkv * D, or more than 8 q heads per KV head")
    _cuda.require(v_pool.shape == k_pool.shape, "k/v pools differ in shape")
    _cuda.require(q.dtype == k_pool.dtype == v_pool.dtype, "dtypes differ")
    _cuda.require(D in (64, 128), f"head_dim {D}: the kernel takes 64 or 128")
    _cuda.require(nseg * R == seg_src.shape[0] and nb * R == blk_live.shape[0]
                  and nb > 0 and nseg % nb == 0
                  and seg_off.shape == seg_live.shape == seg_src.shape,
                  "plan arrays disagree with the leaf count")
    for t in (seg_src, seg_off, seg_live, blk_live):
        _cuda.require(t.dtype == torch.int32 and t.is_contiguous(),
                      "plan arrays must be contiguous int32")
    _cuda.require_device(q, k_pool, v_pool, seg_src, seg_off, seg_live, blk_live)
    _cuda.require(k_pool.is_contiguous() and v_pool.is_contiguous(),
                  "pools must be contiguous")
    q = q.contiguous()
    o = torch.empty_like(q)
    err = _fn()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                o.data_ptr(), int(li) * S * HD, seg_src.data_ptr(),
                seg_off.data_ptr(), seg_live.data_ptr(), blk_live.data_ptr(),
                R, Hq, Hkv, D, nseg, nseg // nb, _cuda.dtype_code(q.dtype),
                float(scale), _cuda.stream_ptr(q.device))
    _cuda.check(err, "paged seq kernel")
    paged_seq_attention.launches += 1
    return o


paged_seq_attention.launches = 0
