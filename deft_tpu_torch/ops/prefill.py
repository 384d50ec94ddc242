"""Causal prefill attention over one prompt (GQA).

Port of deft_tpu/ops/prefill.py:143 (prefill_attention, the Pallas kernel
_prefill_kernel :82) and :190 (prefill_attn_pallas).  The Hopper kernel is
csrc/prefill.cu; ``prefill_attention_plain`` is the same function in plain
torch, which the wrapper runs for CPU tensors only.  Layouts stay the
model's: q (N, Hq, D), k and v (N, Hkv, D), output (N, Hq, D); query head
h * qpk + g attends KV head h (standard GQA grouping, deft_tpu
ops/flatten_attn.py:54).
"""

from __future__ import annotations

import ctypes

import torch

from deft_tpu_torch.ops import _cuda
from deft_tpu_torch.ops.dense_oracle import dense_causal_attention


def prefill_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            scale: float) -> torch.Tensor:
    """The kernel's function in plain torch: dense causal attention in fp32."""
    return dense_causal_attention(q, k, v, scale)


_P, _I = ctypes.c_void_p, ctypes.c_int
_PREFILL_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P]


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """Causal self-attention of a prompt: (N, Hq, D) queries over (N, Hkv, D)
    keys/values.  CUDA tensors launch csrc/prefill.cu; CPU tensors run the
    plain version."""
    if q.device.type == "cpu":
        return prefill_attention_plain(q, k, v, scale)
    N, Hq, D = q.shape
    _cuda.require(k.shape == v.shape and k.shape[0] == N and k.shape[2] == D
                  and Hq % k.shape[1] == 0, f"bad shapes {q.shape} {k.shape}")
    _cuda.require(q.dtype == k.dtype == v.dtype, "q, k, v dtypes differ")
    _cuda.require(D in (64, 128), f"head_dim {D}: the kernel takes 64 or 128")
    _cuda.require_device(q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    fn = _cuda.bind("prefill", "deft_prefill", _PREFILL_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), N, Hq,
             k.shape[1], D, _cuda.dtype_code(q.dtype), float(scale),
             _cuda.stream_ptr(q.device))
    _cuda.check(err, "prefill kernel")
    prefill_attention.launches += 1
    return o


prefill_attention.launches = 0


def prefill_attn(q, k_new, v_new, k_pool, v_pool, li, batch, scale):
    """AttnFn entry (deft_tpu ops/prefill.py:190): causal attention over the
    in-flight projections; the pools were already written by kv_store."""
    return prefill_attention(q, k_new, v_new, scale)
