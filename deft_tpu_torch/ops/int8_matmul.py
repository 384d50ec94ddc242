"""Weight-only int8 matmul for decode-sized activations.

Port of deft_tpu/ops/int8_matmul.py:64 (int8_matmul, the Pallas kernel
_kernel :44) and :101 (eligible).  x (R, H) bf16 or fp32 times int8 codes w
(H, I), scaled per output column by fp32 ``scale`` (I,), in x's dtype: the
product accumulates in fp32, is rounded to x's dtype, then scaled in fp32
and cast, the order of deft_tpu's int8 expression (models/llama.py:150);
deft_tpu's TPU kernel scales the fp32 sum unrounded, which in bf16 differs
by at most one rounding of the product.  The Hopper kernel is
csrc/int8_matmul.cu, one launch a call; ``int8_matmul_plain`` is the same
function in plain torch, which the wrapper runs for CPU tensors only.
Callers gate on ``eligible`` (models/llama.py ``mm``), deft_tpu's rule.
``split_plan`` picks how many blocks of a cluster share each column tile's
H; the wrapper caches it, with the card's SM count, by shape.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from deft_tpu_torch.ops import _cuda

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
_BK = 64  # H rows per pipeline stage of the bf16 kernel
_MAX_CLUSTER = 8  # blocks of a cluster sharing one column tile's H


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


def padded_rows(R: int) -> int:
    """x rows as the bf16 kernel's wgmma sees them: R padded to a power of
    two >= 8 (the rows past R are zeros)."""
    n = 8
    while n < R:
        n *= 2
    return n


def column_tile(R: int) -> int:
    """Output columns a bf16 block owns: 256, or 128 when R > 128 (two
    warpgroups of two or one m64 tiles; the accumulators of 256 rows leave
    room for one)."""
    return 256 if padded_rows(R) <= 128 else 128


def split_plan(R: int, H: int, I: int, sms: int, resident=None):
    """(splits, chunks per split) of the bf16 kernel: the blocks of a
    cluster that share each column tile's H, enough for one block an SM
    (I = 4096 gives 16 column tiles), at most 8, each owning at least one
    64-row chunk of H, all but the last split the same number.
    ``resident(splits)``, where given, is how many clusters of that size the
    card keeps resident at once: the split shrinks until every column
    tile's cluster fits in one wave."""
    chunks = H // _BK
    tiles = -(-I // column_tile(R))
    splits = max(1, min(_MAX_CLUSTER, chunks, sms // tiles))
    while splits > 1 and resident is not None and resident(splits) < tiles:
        splits -= 1
    per = -(-chunks // splits)
    return -(-chunks // per), per


def split_ranges(H: int, splits: int, per: int):
    """The H-chunks [c0, c1) of each split, as the kernel derives them."""
    chunks = H // _BK
    return [(r * per, min(chunks, (r + 1) * per)) for r in range(splits)]


@functools.lru_cache(maxsize=None)
def _resident(index: int, R: int, splits: int) -> int:
    with torch.cuda.device(index):
        fn = _cuda.bind("int8_matmul", "deft_int8_matmul_max_clusters", [_I, _I])
        return fn(R, splits)


@functools.lru_cache(maxsize=None)
def launch_splits(index: int, R: int, H: int, I: int, dtype) -> int:
    """The split a call launches with on CUDA device ``index``, cached by
    shape: 1 for fp32 (its FMA body takes all of H in one block)."""
    if dtype != torch.bfloat16:
        return 1
    return split_plan(R, H, I, _cuda.sm_count(index),
                      lambda s: _resident(index, padded_rows(R), s))[0]


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
    x = _cuda.aligned16(x)  # a view at an odd offset: TMA reads 16-byte units
    _cuda.require(w.data_ptr() % 16 == 0, "w must be 16-byte aligned")
    splits = launch_splits(x.device.index, R, H, I, x.dtype)
    out = torch.empty((R, I), dtype=x.dtype, device=x.device)
    fn = _cuda.bind("int8_matmul", "deft_int8_matmul", _ARGS)
    err = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(), R, H,
             I, splits, dtype, _cuda.stream_ptr(x.device))
    _cuda.check(err, "int8 matmul kernel")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
