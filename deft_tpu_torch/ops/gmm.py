"""Grouped matmul of the MoE prefill (expert dispatch).

Port of deft_tpu/ops/gmm.py:72 (gmm, the Pallas kernels _gmm_kernel :37 and
_gmm_scaled_kernel :58) and :64 (gmm_eligible).  ``gmm(x, w, tile_eid)``
computes out[i] = x[i] @ w[tile_eid[i // tile_m]] for rows sorted by expert
and padded so that every tile_m-row tile belongs to one expert
(models/llama.py ``moe_dispatch`` builds that layout); int8 ``w`` comes with
per-expert, per-output-column fp32 scales ``w_scale`` (NE, F), which multiply
the fp32 sum before the one cast to x's dtype, the Pallas order (gmm.py:50-55).
The Hopper kernel is csrc/gmm.cu; ``gmm_plain`` is the same function in plain
torch, which the wrapper runs for CPU tensors only.

Launches are counted apart for the unscaled and the scaled entry, the two
TPU kernels: ``gmm.launches`` and ``gmm.scaled_launches``.
"""

from __future__ import annotations

import ctypes

import torch

from deft_tpu_torch.ops import _cuda

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
TILE_M = 128  # the kernel's row tile: deft_tpu's tile_m default
_BK, _BN = 32, 128  # the kernel's E depth of a stage and its column tile


def gmm_eligible(M: int, E: int, F: int, tile_m: int = TILE_M) -> bool:
    """deft_tpu's shape rule (gmm.py:64-68): M a multiple of tile_m, E and F
    at most 512 or multiples of 512."""
    tile_k, tile_f = min(512, E), min(512, F)
    return M % tile_m == 0 and E % tile_k == 0 and F % tile_f == 0


def gmm_plain(x: torch.Tensor, w: torch.Tensor, tile_eid: torch.Tensor,
              w_scale: torch.Tensor = None, tile_m: int = TILE_M) -> torch.Tensor:
    """The kernel's function in plain torch: each row tile times its
    expert's weights in fp32, times the scale, one cast to x's dtype.  Tiles
    of one expert are taken together (the same rows times the same matrix)."""
    M, E = x.shape
    F = w.shape[-1]
    out = torch.empty((M, F), dtype=x.dtype, device=x.device)
    xt, ot = x.view(M // tile_m, tile_m, E), out.view(M // tile_m, tile_m, F)
    for e in torch.unique(tile_eid).tolist():
        t = (tile_eid == e).nonzero().flatten()
        y = xt[t].float() @ w[e].float()
        if w_scale is not None:
            y = y * w_scale[e].float()
        ot[t] = y.to(x.dtype)
    return out


def gmm(x: torch.Tensor, w: torch.Tensor, tile_eid: torch.Tensor,
        w_scale: torch.Tensor = None, tile_m: int = TILE_M) -> torch.Tensor:
    """x (M, E) bf16 or fp32 times w[tile_eid[t]] for each tile_m-row tile
    t, w (NE, E, F) of x's dtype, or int8 with ``w_scale`` (NE, F) fp32;
    returns (M, F) in x's dtype.  CUDA tensors launch csrc/gmm.cu (which
    takes E % 32 == 0 and F % 128 == 0, every width of the presets): bf16 x
    its wgmma body, fp32 x its FMA body; CPU tensors run the plain
    version."""
    if x.device.type == "cpu":
        return gmm_plain(x, w, tile_eid, w_scale, tile_m)
    scaled = w_scale is not None
    _cuda.require(tile_m == TILE_M, f"tile_m {tile_m}: the kernel's row tile is {TILE_M}")
    _cuda.require(x.dim() == 2 and w.dim() == 3 and w.shape[1] == x.shape[1],
                  f"x {tuple(x.shape)} and w {tuple(w.shape)} must be (M, E), (NE, E, F)")
    M, E = x.shape
    NE, _, F = w.shape
    _cuda.require(M % TILE_M == 0 and E % _BK == 0 and F % _BN == 0,
                  f"(M, E, F) = {(M, E, F)}: the kernel takes M % {TILE_M}, "
                  f"E % {_BK}, F % {_BN} == 0")
    _cuda.require(tile_eid.shape == (M // TILE_M,),
                  f"tile_eid {tuple(tile_eid.shape)} != ({M // TILE_M},)")
    if scaled:
        _cuda.require(w.dtype == torch.int8, f"w_scale comes with int8 w, not {w.dtype}")
        _cuda.require(w_scale.shape == (NE, F) and w_scale.dtype == torch.float32,
                      f"w_scale must be float32 {(NE, F)}")
    else:
        _cuda.require(w.dtype == x.dtype, f"w is {w.dtype}, x {x.dtype}: unscaled "
                      "weights take x's dtype")
    dtype = _cuda.dtype_code(x.dtype)
    _cuda.require_device(x, w, tile_eid, *([w_scale] if scaled else []))
    x, w = _cuda.aligned16(x.contiguous()), w.contiguous()
    _cuda.require(w.data_ptr() % 16 == 0, "w must be 16-byte aligned")
    tile_eid = tile_eid.to(torch.int32).contiguous()
    w_scale = w_scale.contiguous() if scaled else None
    out = torch.empty((M, F), dtype=x.dtype, device=x.device)
    fn = _cuda.bind("gmm", "deft_gmm", _ARGS)
    err = fn(x.data_ptr(), w.data_ptr(), _cuda.ptr(w_scale), tile_eid.data_ptr(),
             out.data_ptr(), M, E, F, NE, dtype, int(scaled), _cuda.stream_ptr(x.device))
    _cuda.check(err, "grouped matmul kernel")
    if scaled:
        gmm.scaled_launches += 1
    else:
        gmm.launches += 1
    return out


gmm.launches = 0
gmm.scaled_launches = 0
