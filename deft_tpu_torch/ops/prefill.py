"""Causal prefill attention (GQA): one prompt (B3), or several prompts
joined on the token axis (B8, ragged).

Port of deft_tpu/ops/prefill.py:143 (prefill_attention, the Pallas kernel
_prefill_kernel :82), :190 (prefill_attn_pallas), :288
(ragged_prefill_attention, the Pallas kernel _ragged_prefill_kernel :205)
and :365 (ragged_prefill_attn_pallas).  Both Hopper kernels are
csrc/prefill.cu (entries deft_prefill, deft_ragged_prefill; bf16 on wgmma
and TMA at head_dim 64, 96, 128 and 256, fp32 on an FMA body); each
``*_plain`` function is the same function in plain torch, which the wrapper
runs for CPU tensors only.  Layouts stay the model's: q (N, Hq, D), k and v
(N, Hkv, D), output (N, Hq, D); query head h * qpk + g attends KV head h
(standard GQA grouping, deft_tpu ops/flatten_attn.py:54).
"""

from __future__ import annotations

import ctypes

import torch

from deft_tpu_torch.ops import _cuda
from deft_tpu_torch.ops.dense_oracle import (dense_causal_attention,
                                             dense_ragged_causal_attention)


def prefill_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            scale: float) -> torch.Tensor:
    """The kernel's function in plain torch: dense causal attention in fp32."""
    return dense_causal_attention(q, k, v, scale)


_P, _I = ctypes.c_void_p, ctypes.c_int
_PREFILL_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P]
_RAGGED_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P]


def _check(q, k, v, *rest):
    N, Hq, D = q.shape
    _cuda.require(k.shape == v.shape and k.shape[0] == N and k.shape[2] == D
                  and Hq % k.shape[1] == 0, f"bad shapes {q.shape} {k.shape}")
    _cuda.require(q.dtype == k.dtype == v.dtype, "q, k, v dtypes differ")
    _cuda.require(D in (64, 96, 128, 256),
                  f"head_dim {D}: the kernel takes 64, 96, 128 or 256")
    _cuda.require(Hq // k.shape[1] <= 128, f"{Hq // k.shape[1]} query heads a KV head: "
                  "the kernel folds at most 128")
    _cuda.require_device(q, k, v, *rest)
    # bf16 runs the wgmma body, whose TMA reads 16-byte aligned tensors
    return tuple(_cuda.aligned16(t.contiguous()) for t in (q, k, v))


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """Causal self-attention of a prompt: (N, Hq, D) queries over (N, Hkv, D)
    keys/values.  CUDA tensors launch csrc/prefill.cu; CPU tensors run the
    plain version."""
    if q.device.type == "cpu":
        return prefill_attention_plain(q, k, v, scale)
    N, Hq, D = q.shape
    q, k, v = _check(q, k, v)
    o = torch.empty_like(q)
    fn = _cuda.bind("prefill", "deft_prefill", _PREFILL_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), N, Hq,
             k.shape[1], D, _cuda.dtype_code(q.dtype), float(scale),
             _cuda.stream_ptr(q.device))
    _cuda.check(err, "prefill kernel")
    prefill_attention.launches += 1
    return o


prefill_attention.launches = 0


def ragged_prefill_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, seg: torch.Tensor,
                                   scale: float) -> torch.Tensor:
    """B8's function in plain torch: each prompt's dense causal attention in
    fp32, pad rows 0."""
    return dense_ragged_causal_attention(q, k, v, seg, scale)


def segment_starts(seg: torch.Tensor) -> torch.Tensor:
    """First token of each token's run of equal seg ids, in one pass
    (deft_tpu ops/prefill.py:311-316): the running max of the change
    points.  For prompts joined in ascending order, each token's prompt
    start."""
    idx = torch.arange(seg.shape[0], dtype=torch.int32, device=seg.device)
    change = torch.ones_like(seg, dtype=torch.bool)
    change[1:] = seg[1:] != seg[:-1]
    return torch.cummax(torch.where(change, idx, 0), dim=0).values.to(torch.int32)


def ragged_prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             seg: torch.Tensor, scale: float) -> torch.Tensor:
    """Causal self-attention of prompts joined on the token axis: q (N, Hq,
    D), k, v (N, Hkv, D), seg (N,) int32 each token's prompt, ascending,
    pads < 0.  Token i attends token j iff seg[i] == seg[j] >= 0 and
    i >= j; pad rows give 0.  CUDA tensors launch csrc/prefill.cu
    (deft_ragged_prefill); CPU tensors run the plain version."""
    if q.device.type == "cpu":
        return ragged_prefill_attention_plain(q, k, v, seg, scale)
    N, Hq, D = q.shape
    _cuda.require(seg.shape == (N,) and seg.dtype == torch.int32,
                  f"seg must be int32 ({N},), got {seg.dtype} {tuple(seg.shape)}")
    q, k, v = _check(q, k, v, seg)
    seg = seg.contiguous()
    starts = segment_starts(seg)
    o = torch.empty_like(q)
    fn = _cuda.bind("prefill", "deft_ragged_prefill", _RAGGED_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
             starts.data_ptr(), o.data_ptr(), N, Hq, k.shape[1], D,
             _cuda.dtype_code(q.dtype), float(scale), _cuda.stream_ptr(q.device))
    _cuda.check(err, "ragged prefill kernel")
    ragged_prefill_attention.launches += 1
    return o


ragged_prefill_attention.launches = 0


def prefill_attn(q, k_new, v_new, k_pool, v_pool, li, batch, scale):
    """AttnFn entry (deft_tpu ops/prefill.py:190): causal attention over the
    in-flight projections; the pools were already written by kv_store."""
    return prefill_attention(q, k_new, v_new, scale)


def ragged_prefill_attn(q, k_new, v_new, k_pool, v_pool, li, batch, scale):
    """AttnFn entry (deft_tpu ops/prefill.py:365): ragged causal attention
    over the in-flight projections of prompts told apart by batch.seg_ids."""
    return ragged_prefill_attention(q, k_new, v_new, batch.seg_ids, scale)
