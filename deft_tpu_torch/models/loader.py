"""Parameters: random init and conversion from numpy.

Port of deft_tpu/models/loader.py:25 (_param_shapes), :83 (_fuse_host) and
:217 (random_params).  The port keeps the JAX package's parameter layout:
stacked (num_layers, ...) tensors, projections as (in, out) matrices, and
q/k/v and gate/up fused along the output axis (wqkv, wgu) as deft_tpu's
single-chip runner keeps them (runner.py:228-252).

Two random streams:
- the numpy stream (``random_params(..., device="cpu")``): default_rng(seed)
  drawn in _param_shapes order, the same numbers as deft_tpu's CPU path
  (loader.py:233-244), so both packages get identical weights;
- a ``torch.Generator`` on the target device for full-size models, where
  the numpy path would hold some 32 GB of fp32 on the host (8B).
Local checkpoint loading comes in a later slice.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from deft_tpu_torch.models.config import LlamaConfig

# (members, fused name) along the output axis (deft_tpu loader.py:80)
_FUSE_GROUPS = ((("wq", "wk", "wv"), "wqkv"), (("wg", "wu"), "wgu"))


def _param_shapes(cfg: LlamaConfig) -> Dict[str, Any]:
    """Dense-Llama shapes, in the order the numpy stream draws them."""
    E, D, L, I = cfg.hidden_size, cfg.head_dim, cfg.num_layers, cfg.intermediate_size
    return {
        "embed": (cfg.vocab_size, E),
        "ln1": (L, E),
        "wq": (L, E, cfg.num_q_heads * D),
        "wk": (L, E, cfg.num_kv_heads * D),
        "wv": (L, E, cfg.num_kv_heads * D),
        "wo": (L, cfg.num_q_heads * D, E),
        "ln2": (L, E),
        "wg": (L, E, I),
        "wu": (L, E, I),
        "wdown": (L, I, E),
        "ln_f": (E,),
        "lm_head": (E, cfg.vocab_size),
    }


def _fused_shapes(cfg: LlamaConfig) -> Dict[str, Any]:
    shapes = _param_shapes(cfg)
    out: Dict[str, Any] = {}
    for name, shape in shapes.items():
        for group, fused in _FUSE_GROUPS:
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
    pass through (deft_tpu loader.py:83)."""
    p = dict(bufs)
    for group, out in _FUSE_GROUPS:
        if all(g in p for g in group):
            p[out] = np.concatenate([np.asarray(p[g]) for g in group], axis=-1)
            for g in group:
                del p[g]
    return p


def check_supported(cfg: LlamaConfig) -> None:
    """This slice runs dense Llama only."""
    unsupported = [name for name, on in (
        ("MoE", cfg.num_experts > 0), ("Gemma norm", cfg.gemma_norm),
        ("qk-norm", cfg.qk_norm), ("qkv bias", cfg.qkv_bias),
        (f"hidden_act={cfg.hidden_act}", cfg.hidden_act != "silu"),
    ) if on]
    if unsupported:
        raise NotImplementedError(
            f"not ported yet: {', '.join(unsupported)} (dense Llama only)")


def params_from_numpy(np_params: Dict[str, np.ndarray], cfg: LlamaConfig,
                      device, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The port's parameters from numpy arrays in deft_tpu's layout, fused
    (wqkv, wgu) or unfused (wq/wk/wv, wg/wu): e.g. ``{k: np.asarray(v)}`` of
    a deft_tpu runner's params, or the numpy random stream."""
    check_supported(cfg)
    bufs = fuse_host(np_params)
    want = _fused_shapes(cfg)
    if set(bufs) != set(want):
        raise KeyError(f"parameter names {sorted(bufs)} != {sorted(want)}")
    out = {}
    for name, shape in want.items():
        arr = np.array(bufs[name], dtype=np.float32)  # a private copy
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape} != {shape}")
        out[name] = torch.from_numpy(arr).to(device=device, dtype=dtype)
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
                  dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Random-init parameters with sane scales.

    On the CPU: deft_tpu's numpy stream, so both packages get the same
    weights.  On a GPU: a torch.Generator seeded with ``seed`` draws the
    fused tensors directly on ``device``, one layer at a time, so the fp32
    transient is one layer's tensor."""
    device = torch.device(device)
    if device.type == "cpu":
        return params_from_numpy(numpy_random_params(cfg, seed), cfg, device,
                                 dtype)
    check_supported(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params: Dict[str, torch.Tensor] = {}
    for name, shape in _fused_shapes(cfg).items():
        if name.startswith("ln"):
            params[name] = torch.ones(shape, dtype=dtype, device=device)
            continue
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        out = torch.empty(shape, dtype=dtype, device=device)
        for part in (out if len(shape) == 3 else [out]):
            x = torch.randn(part.shape, generator=gen, device=device,
                            dtype=torch.float32)
            part.copy_(x.mul_(fan_in ** -0.5))
        params[name] = out
    return params
