"""Parameters: random init and conversion from numpy.

Port of deft_tpu/models/loader.py:25 (_param_shapes), :76 (QUANT_WEIGHTS),
:83 (_fuse_host), :103 (_fused_shapes), :189 (_quantize_int8), :197
(_finalize) and :217 (random_params).  The port keeps the JAX package's
parameter layout: stacked (num_layers, ...) tensors, projections as (in,
out) matrices, and q/k/v and gate/up fused along the output axis (wqkv, wgu)
as deft_tpu's single-chip runner keeps them (runner.py:228-252).  A
Mixtral-family MoE config replaces the dense MLP by the router ``wrt`` (L, E,
NE) and stacked experts ``wg``/``wu`` (L, NE, E, I) and ``wdown`` (L, NE, I,
E), which stay unfused (deft_tpu loader.py:31-38, :90-95, :120-123).

Weight-only int8 (``weight_dtype`` "int8" or "int8-pallas"): every matmul
weight in QUANT_WEIGHTS becomes int8 codes plus a per-output-channel fp32
scale under ``name + "_s"`` ("int8") or ``name + "_sp"`` ("int8-pallas"),
which tells ``llama.mm`` which route to take (deft_tpu loader.py:207-211).
Expert stacks are quantised per expert and output column (scales (L, NE,
F)); the router stays in the model dtype.

Two random streams:
- the numpy stream (``random_params(..., device="cpu")``): default_rng(seed)
  drawn in _param_shapes order, the same numbers as deft_tpu's CPU path
  (loader.py:233-244), so both packages get identical weights;
- a ``torch.Generator`` on the target device for full-size models, where
  the numpy path would hold some 32 GB of fp32 on the host (8B).
Local checkpoint loading comes in a later slice.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from deft_tpu_torch.config import WEIGHT_DTYPES
from deft_tpu_torch.models.config import LlamaConfig

# (members, fused name) along the output axis (deft_tpu loader.py:80)
_FUSE_GROUPS = ((("wq", "wk", "wv"), "wqkv"), (("wg", "wu"), "wgu"))

# Matmul weights that weight-only int8 quantises: all but embed and the norms
# (deft_tpu loader.py:76).  Scales are per output column, so quantising a
# fused tensor equals fusing the quantised members.
QUANT_WEIGHTS = ("wq", "wk", "wv", "wo", "wg", "wu", "wdown", "lm_head",
                 "wqkv", "wgu")
SCALE_SUFFIX = {"int8": "_s", "int8-pallas": "_sp"}


def _param_shapes(cfg: LlamaConfig) -> Dict[str, Any]:
    """Llama shapes (MoE: router and stacked experts in place of the dense
    MLP), in the order the numpy stream draws them."""
    E, D, L, I = cfg.hidden_size, cfg.head_dim, cfg.num_layers, cfg.intermediate_size
    NE = cfg.num_experts
    mlp = ({"wrt": (L, E, NE), "wg": (L, NE, E, I), "wu": (L, NE, E, I),
            "wdown": (L, NE, I, E)} if NE > 0 else
           {"wg": (L, E, I), "wu": (L, E, I), "wdown": (L, I, E)})
    return {
        "embed": (cfg.vocab_size, E),
        "ln1": (L, E),
        "wq": (L, E, cfg.num_q_heads * D),
        "wk": (L, E, cfg.num_kv_heads * D),
        "wv": (L, E, cfg.num_kv_heads * D),
        "wo": (L, cfg.num_q_heads * D, E),
        "ln2": (L, E),
        **mlp,
        "ln_f": (E,),
        "lm_head": (E, cfg.vocab_size),
    }


def _fused_shapes(cfg: LlamaConfig) -> Dict[str, Any]:
    shapes = _param_shapes(cfg)
    out: Dict[str, Any] = {}
    for name, shape in shapes.items():
        for group, fused in _FUSE_GROUPS:
            if len(shapes[group[0]]) == 4:  # MoE experts stay unfused
                continue
            if name == group[0]:
                out[fused] = shape[:-1] + (sum(shapes[g][-1] for g in group),)
                break
            if name in group:
                break
        else:
            out[name] = shape
    return out


def fuse_host(bufs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """q/k/v -> wqkv and gate/up -> wgu on host numpy; already fused inputs
    and 4-D MoE expert stacks pass through (deft_tpu loader.py:83)."""
    p = dict(bufs)
    for group, out in _FUSE_GROUPS:
        if all(g in p for g in group) and np.ndim(p[group[0]]) == 3:
            p[out] = np.concatenate([np.asarray(p[g]) for g in group], axis=-1)
            for g in group:
                del p[g]
    return p


def check_supported(cfg: LlamaConfig) -> None:
    """The port runs Llama and Mixtral-family (sparse MoE) models; the other
    families come with checkpoint loading."""
    unsupported = [name for name, on in (
        ("Gemma norm", cfg.gemma_norm), ("qk-norm", cfg.qk_norm),
        ("qkv bias", cfg.qkv_bias),
        (f"hidden_act={cfg.hidden_act}", cfg.hidden_act != "silu"),
    ) if on]
    if unsupported:
        raise NotImplementedError(
            f"not ported yet: {', '.join(unsupported)} (Llama and Mixtral only)")


def _quantize_int8(w: torch.Tensor):
    """Per-output-channel symmetric int8 of fp32 ``w`` (..., in, out): scale
    max(max|w| / 127, 1e-8) over the input axis, codes round(w / scale)
    (half to even, as np.round) clipped to +-127 (deft_tpu loader.py:189).
    Returns (int8 codes, fp32 scales (..., out))."""
    s = torch.clamp_min(w.abs().amax(dim=-2, keepdim=True) / 127.0, 1e-8)
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return q, s.squeeze(-2)


def _check_weight_dtype(weight_dtype: str) -> None:
    if weight_dtype not in WEIGHT_DTYPES:
        raise ValueError(f"weight_dtype {weight_dtype!r}: one of "
                         f"{', '.join(WEIGHT_DTYPES)}")


def params_from_numpy(np_params: Dict[str, np.ndarray], cfg: LlamaConfig,
                      device, dtype: torch.dtype,
                      weight_dtype: str = "inherit") -> Dict[str, torch.Tensor]:
    """The port's parameters from float numpy arrays in deft_tpu's layout,
    fused (wqkv, wgu) or unfused (wq/wk/wv, wg/wu): e.g. ``{k: np.asarray(v)}``
    of a deft_tpu runner's (unquantised) params, or the numpy random stream.
    ``weight_dtype`` int8 flavours quantise the fused matmul weights, as
    deft_tpu's _finalize(fuse=True) does (loader.py:197-214)."""
    check_supported(cfg)
    _check_weight_dtype(weight_dtype)
    bufs = fuse_host(np_params)
    want = _fused_shapes(cfg)
    if set(bufs) != set(want):
        raise KeyError(f"parameter names {sorted(bufs)} != {sorted(want)}")
    out = {}
    for name, shape in want.items():
        arr = np.array(bufs[name], dtype=np.float32)  # a private copy
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape} != {shape}")
        w = torch.from_numpy(arr)
        if weight_dtype != "inherit" and name in QUANT_WEIGHTS:
            q, s = _quantize_int8(w)
            out[name] = q.to(device)
            out[name + SCALE_SUFFIX[weight_dtype]] = s.to(device)
        else:
            out[name] = w.to(device=device, dtype=dtype)
    return out


def numpy_random_params(cfg: LlamaConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """deft_tpu's CPU random stream (loader.py:233-244): norms are ones,
    every other tensor N(0, 1) / sqrt(fan_in), drawn in _param_shapes order."""
    rng = np.random.default_rng(seed)
    bufs: Dict[str, np.ndarray] = {}
    for name, shape in _param_shapes(cfg).items():
        if name.startswith("ln"):
            bufs[name] = np.ones(shape, dtype=np.float32)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            arr = rng.standard_normal(size=shape, dtype=np.float32)
            arr *= 1.0 / np.sqrt(fan_in)
            bufs[name] = arr
    return bufs


def random_params(cfg: LlamaConfig, seed: int = 0, device="cuda",
                  dtype: torch.dtype = torch.bfloat16,
                  weight_dtype: str = "inherit") -> Dict[str, torch.Tensor]:
    """Random-init parameters with sane scales.

    On the CPU: deft_tpu's numpy stream, so both packages get the same
    weights (and, for int8, the same codes and scales).  On a GPU: a
    torch.Generator seeded with ``seed`` draws the fused tensors directly on
    ``device``, one layer at a time, and int8 flavours quantise each layer's
    slice as it is drawn: the fp32 transient is one layer's tensor (lm_head,
    the largest, is 2.1 GB at 8B; one layer's expert stack is 1.9 GB at
    Mixtral-8x7B) and no full-precision copy of a quantised weight ever
    exists.  The same seed gives the int8 weights of the same
    draws as the bf16 ones."""
    device = torch.device(device)
    _check_weight_dtype(weight_dtype)
    if device.type == "cpu":
        return params_from_numpy(numpy_random_params(cfg, seed), cfg, device,
                                 dtype, weight_dtype)
    return generator_params(cfg, seed, device, dtype, weight_dtype)


def generator_params(cfg: LlamaConfig, seed: int, device, dtype: torch.dtype,
                     weight_dtype: str = "inherit",
                     keep: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """random_params' torch.Generator stream on ``device``: the fused
    tensors in _fused_shapes order, each stacked tensor one layer at a time,
    N(0, 1) / sqrt(fan_in) in fp32, then quantised (int8 flavours) or cast.
    ``keep(name, x, stacked)`` cuts what is stored of each drawn tensor (a
    layer of a stacked one, or a whole one) and of its int8 scale (the
    name ends in the scale suffix), after the quantisation: the
    multi-device loader keeps a rank's slice of the same draws."""
    device = torch.device(device)
    _check_weight_dtype(weight_dtype)
    check_supported(cfg)
    cut = keep or (lambda name, x, stacked: x)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params: Dict[str, torch.Tensor] = {}
    for name, shape in _fused_shapes(cfg).items():
        stacked = len(shape) >= 3
        if name.startswith("ln"):
            params[name] = cut(name, torch.ones(shape, dtype=dtype, device=device),
                               False)
            continue
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        quant = weight_dtype != "inherit" and name in QUANT_WEIGHTS
        sname = name + SCALE_SUFFIX.get(weight_dtype, "")
        out = scale = None
        for i in range(shape[0]) if stacked else [None]:
            x = torch.randn(shape[1:] if stacked else shape, generator=gen,
                            device=device, dtype=torch.float32).mul_(fan_in ** -0.5)
            if quant:
                q, s = _quantize_int8(x)
                q, s = cut(name, q, stacked), cut(sname, s, stacked)
            else:
                q, s = cut(name, x.to(dtype), stacked), None
            del x
            if not stacked:
                out, scale = q, s
                break
            if out is None:  # the kept layer's shape is known once drawn
                out = torch.empty((shape[0],) + q.shape, dtype=q.dtype, device=device)
                scale = (torch.empty((shape[0],) + s.shape, dtype=s.dtype,
                                     device=device) if quant else None)
            out[i].copy_(q)
            if quant:
                scale[i].copy_(s)
        params[name] = out
        if quant:
            params[sname] = scale
    return params
