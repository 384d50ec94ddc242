"""Sequential per-leaf decode attention for plans that are not
segment-aligned: each leaf's path is a padded row of pool indices.

Port of deft_tpu/ops/seq_attn.py:89 (seq_attention, the Pallas kernel
_seq_kernel :28) and :132 (seq_attn_pallas).  deft_tpu gathers every leaf's
padded path in XLA first (dequantised for int8 pools) and runs the kernel in
128-token blocks masked by ``seq_lens``; the Hopper kernel,
csrc/seq_gather.cu, reads rows paths[r, c], c < seq_lens[r], of the pool
inside the kernel: over bf16 q on B2's and B5's tensor-core bodies
(csrc/seq_q_body.cuh, the path table as their path source; at head_dim 96
and 256, Phi-3-mini's and Gemma-7B's, the body with the path tokens on the
products' M and the query rows on N), each path split over
``paged_seq_attn.seq_splits`` blocks of a cluster, a count taken from R,
Hkv and the SM count alone (nothing is read back from the device); over
fp32 q on the FMA body of csrc/seq_body.cuh, one block a (leaf, head).  It
takes pools of q's dtype, or int8 pools with their (L, Hkv, S) fp32 scales.
``seq_attention_plain`` is the same function in plain torch, which the
wrapper runs for CPU tensors only.

Plan format (deft_tpu plan/seq.py, paged=False): paths (R, C) int32, pads at
DUMP_SLOT; seq_lens (R,), 0 for padded leaves.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from deft_tpu_torch.ops import _cuda
from deft_tpu_torch.ops import paged_seq_attn
from deft_tpu_torch.ops.paged_flatten_attn import GATHER_WIDTHS
from deft_tpu_torch.ops.paged_seq_attn import launch_seq, path_attention_plain

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (q, k, v, ks, vs, o, layer_off, scale_off, S, paths, seq_lens, R, C, Hq,
#  Hkv, D, splits, dtype, scale, stream)
_SEQ_GATHER_ARGS = [_P, _P, _P, _P, _P, _P, _LL, _LL, _I, _P, _P,
                    _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P]


def seq_attention_plain(q, k_pool, v_pool, li, paths, seq_lens, scale,
                        k_scale=None, v_scale=None):
    """The kernel's function in plain torch: leaf r attends the pool rows
    paths[r, :seq_lens[r]] (dequantised for int8 pools)."""
    live = (torch.arange(paths.shape[1], device=paths.device)[None, :]
            < seq_lens[:, None])
    return path_attention_plain(q, k_pool, v_pool, li, paths, live, scale,
                                k_scale, v_scale)


def seq_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                  li: int, paths: torch.Tensor, seq_lens: torch.Tensor,
                  scale: float, k_scale: Optional[torch.Tensor] = None,
                  v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each leaf of q (R, Hq, D) attends its own path, the pool rows
    paths[r, :seq_lens[r]] of the (L, S, Hkv*D) pools; returns (R, Hq, D).
    CUDA tensors launch csrc/seq_gather.cu; CPU tensors run the plain
    version."""
    if q.device.type == "cpu":
        return seq_attention_plain(q, k_pool, v_pool, li, paths, seq_lens,
                                   scale, k_scale, v_scale)
    R, C = paths.shape
    _cuda.require(R == q.shape[0] and seq_lens.shape == (R,) and C > 0,
                  "paths and seq_lens disagree with the leaf count")
    splits = 1  # only the tensor-core bodies (bf16 q) split paths
    if q.dtype == torch.bfloat16:
        splits = paged_seq_attn.seq_splits(R, k_pool.shape[-1] // q.shape[-1],
                                           _cuda.sm_count(q.device.index),
                                           k_scale is not None, q.shape[-1])
    o = launch_seq("seq_gather", "deft_seq_gather", _SEQ_GATHER_ARGS, q,
                   k_pool, v_pool, k_scale, v_scale, li, (paths, seq_lens),
                   (C,), (splits,), scale, widths=GATHER_WIDTHS)
    seq_attention.launches += 1
    return o


seq_attention.launches = 0
