"""Weight-only int8 matmul for decode-sized activations.

Port of deft_tpu/ops/int8_matmul.py:64 (int8_matmul, the Pallas kernel
_kernel :44) and :101 (eligible).  x (R, H) bf16 or fp32 times int8 codes w
(H, I), scaled per output column by fp32 ``scale`` (I,), in x's dtype: the
product accumulates in fp32, is rounded to x's dtype, then scaled in fp32
and cast, the order of deft_tpu's int8 expression (models/llama.py:150);
deft_tpu's TPU kernel scales the fp32 sum unrounded, which in bf16 differs
by at most one rounding of the product.  The Hopper kernel is
csrc/int8_matmul.cu; ``int8_matmul_plain`` is the same function in plain
torch, which the wrapper runs for CPU tensors only.  Callers gate on
``eligible`` (models/llama.py ``mm``), deft_tpu's rule.
"""

from __future__ import annotations

import ctypes

import torch

from deft_tpu_torch.ops import _cuda

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
_BI = 128  # output columns per CUDA block
_BK = {torch.bfloat16: 128, torch.float32: 32}  # H rows per pipeline stage


def _pick_block(dim: int, candidates=(512, 256, 128)) -> int:
    for c in candidates:
        if dim % c == 0:
            return c
    return 0


def eligible(x: torch.Tensor, w: torch.Tensor) -> bool:
    """deft_tpu's preconditions (int8_matmul.py:101-114): 2-D decode-sized
    activations (R % 8 == 0, R <= 256) and H, I divisible by 512, 256 or
    128.  Prefill-sized products stay on the plain expression."""
    if x.dim() != 2 or w.dim() != 2:
        return False
    R, H = x.shape
    return (R % 8 == 0 and R <= 256 and _pick_block(H) != 0
            and _pick_block(w.shape[1]) != 0)


def int8_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch: fp32 product rounded to x's
    dtype, times the fp32 scale, cast to x's dtype."""
    return ((x.float() @ w.float()).to(x.dtype).float() * scale).to(x.dtype)


def num_splits(H: int, I: int, dtype, sms: int) -> int:
    """Blocks along H for each 128-column tile: enough for ~2 blocks an SM
    (I = 4096 gives only 32 column tiles), every split owning at least one
    H-chunk."""
    chunks = H // _BK[dtype]
    want = max(1, min(chunks, -(-2 * sms // (I // _BI))))
    per = -(-chunks // want)
    return -(-chunks // per)


def int8_matmul(x: torch.Tensor, w: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """(x @ w) * scale in x's dtype for x (R, H), int8 w (H, I), fp32 scale
    (I,).  CUDA tensors launch csrc/int8_matmul.cu; CPU tensors run the
    plain version."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w, scale)
    _cuda.require(eligible(x, w), f"shapes x {tuple(x.shape)}, w "
                  f"{tuple(w.shape)} are not eligible (llama.mm gates on it)")
    R, H = x.shape
    _cuda.require(w.shape[0] == H and w.dtype == torch.int8,
                  f"w must be int8 ({H}, I), got {w.dtype} {tuple(w.shape)}")
    I = w.shape[1]
    _cuda.require(scale.shape == (I,) and scale.dtype == torch.float32,
                  "scale must be float32 (I,)")
    dtype = _cuda.dtype_code(x.dtype)
    _cuda.require_device(x, w, scale)
    x, w, scale = x.contiguous(), w.contiguous(), scale.contiguous()
    if x.data_ptr() % 16:  # a view at an odd offset: cp.async reads 16 bytes
        x = x.clone()
    _cuda.require(w.data_ptr() % 16 == 0, "w must be 16-byte aligned")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = num_splits(H, I, x.dtype, sms)
    out = torch.empty((R, I), dtype=x.dtype, device=x.device)
    part = (torch.empty((splits, R, I), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    fn = _cuda.bind("int8_matmul", "deft_int8_matmul", _ARGS)
    err = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
             _cuda.ptr(part), R, H, I, splits, dtype, _cuda.stream_ptr(x.device))
    _cuda.check(err, "int8 matmul kernel")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
