"""Rotary position embeddings, HF-Llama (rotate-half) convention, with
deft_tpu's frequency scalings.

Port of deft_tpu/models/rope.py:20 (_llama3_scale_freqs), :42
(_yarn_correction_dim), :49 (_yarn_ramp_mask), :56 (_yarn_scale_freqs), :92
(rope_table: linear, dynamic NTK, YaRN, DeepSeek-YaRN, Llama-3 and
LongRoPE, a numpy copy) and :177 (apply_rope, now torch).  The cos/sin table
is built once on the host in float64, cast to fp32 and moved to the
runner's device.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch


def _llama3_scale_freqs(inv_freq: np.ndarray, scaling: Dict[str, Any]) -> np.ndarray:
    factor = scaling["factor"]
    low = scaling.get("low_freq_factor", 1.0)
    high = scaling.get("high_freq_factor", 4.0)
    orig_ctx = scaling.get("original_max_position_embeddings", 8192)
    wavelen = 2 * math.pi / inv_freq
    # three bands: long wavelengths fully scaled, short untouched, smooth mid
    low_wl = orig_ctx / low
    high_wl = orig_ctx / high
    smooth = (orig_ctx / wavelen - low) / (high - low)
    scaled = np.where(
        wavelen > low_wl,
        inv_freq / factor,
        np.where(
            wavelen < high_wl,
            inv_freq,
            (1 - smooth) * inv_freq / factor + smooth * inv_freq,
        ),
    )
    return scaled


def _yarn_correction_dim(num_rot: float, dim: int, base: float,
                         orig_max: int) -> float:
    return (dim * math.log(orig_max / (num_rot * 2 * math.pi))) / (
        2 * math.log(base))


def _yarn_ramp_mask(low: float, high: float, n: int) -> np.ndarray:
    if low == high:
        high += 1e-3
    r = (np.arange(n, dtype=np.float64) - low) / (high - low)
    return np.clip(r, 0.0, 1.0)


def _yarn_scale_freqs(inv_freq: np.ndarray, scaling: Dict[str, Any],
                      base: float, head_dim: int):
    """YaRN (and DeepSeek's variant) frequency interpolation, ramped between
    the beta_fast / beta_slow correction dims; returns (inv_freq, mscale),
    mscale multiplying cos/sin (deft_tpu models/rope.py:56)."""
    factor = float(scaling["factor"])
    orig_max = int(scaling.get("original_max_position_embeddings", 4096))
    beta_fast = float(scaling.get("beta_fast", 32))
    beta_slow = float(scaling.get("beta_slow", 1))
    half = len(inv_freq)
    low = max(math.floor(
        _yarn_correction_dim(beta_fast, head_dim, base, orig_max)), 0)
    high = min(math.ceil(
        _yarn_correction_dim(beta_slow, head_dim, base, orig_max)),
        head_dim - 1)
    # 1 where extrapolation (high-frequency dims), 0 where interpolation
    extrap_mask = 1.0 - _yarn_ramp_mask(float(low), float(high), half)
    inv = inv_freq / factor * (1.0 - extrap_mask) + inv_freq * extrap_mask

    attn_factor = float(scaling.get("attention_factor") or
                        scaling.get("attn_factor") or 0.0)
    if attn_factor:
        mscale = attn_factor
    elif scaling.get("rope_type", scaling.get("type")) == "deepseek_yarn":
        def _ms(s, m):
            return 1.0 if s <= 1 else 0.1 * m * math.log(s) + 1.0
        mscale = _ms(factor, float(scaling.get("mscale", 1.0))) / _ms(
            factor, float(scaling.get("mscale_all_dim", 0.0)) or 1.0)
    else:
        mscale = 0.1 * math.log(factor) + 1.0 if factor > 1 else 1.0
    return inv, mscale


def _longrope(inv_freq: np.ndarray, scaling: Dict[str, Any], max_pos: int,
              orig_max_pos: Optional[int]):
    """Phi-3 LongRoPE: per-position frequencies (max_pos, half), the short
    factors below the original max and the long ones from it on (what HF's
    incremental decode gives tokens written in each regime), and the
    attention factor of the config's max ratio (deft_tpu rope.py:134-160)."""
    orig_in_cfg = scaling.get("original_max_position_embeddings")
    orig_max = int(orig_in_cfg or orig_max_pos or max_pos)
    inv_s = inv_freq / np.asarray(scaling["short_factor"], dtype=np.float64)
    inv_l = inv_freq / np.asarray(scaling["long_factor"], dtype=np.float64)
    is_long = (np.arange(max_pos) >= orig_max)[:, None]
    inv = np.where(is_long, inv_l[None, :], inv_s[None, :])
    af = scaling.get("attention_factor")
    if af is None:
        # HF overrides any explicit factor with the config-max ratio only
        # when the config carries the original max
        factor = scaling.get("factor")
        if orig_in_cfg and orig_max_pos:
            factor = orig_max_pos / orig_max
        af = (math.sqrt(1 + math.log(factor) / math.log(orig_max))
              if factor and factor > 1.0 else 1.0)
    return inv, float(af)


def rope_table(
    head_dim: int,
    max_pos: int,
    theta: float = 10000.0,
    scaling: Optional[Dict[str, Any]] = None,
    orig_max_pos: Optional[int] = None,
) -> np.ndarray:
    """(max_pos, head_dim) fp32 numpy table: [cos | sin] halves, HF layout
    (cos/sin each repeated over the two rotated halves), times the
    scaling's attention factor.  ``orig_max_pos``: the config's
    max_position_embeddings, which dynamic NTK and LongRoPE read where the
    scaling dict lacks an original max (deft_tpu runner.py:255-258)."""
    half = head_dim // 2
    inv_freq = 1.0 / (theta ** (np.arange(0, half, dtype=np.float64) * 2 / head_dim))
    mscale = 1.0
    rtype = None if scaling is None else scaling.get("rope_type",
                                                     scaling.get("type", ""))
    if rtype == "llama3":
        inv_freq = _llama3_scale_freqs(inv_freq, scaling)
    elif rtype == "linear":
        inv_freq = inv_freq / scaling["factor"]
    elif rtype == "dynamic":
        # NTK: the base rescaled for the table's length; the pre-scaling max
        # is max_position_embeddings itself in HF's dynamic configs
        factor = float(scaling["factor"])
        orig_max = int(scaling.get("original_max_position_embeddings",
                                   orig_max_pos if orig_max_pos else max_pos))
        seq_len = max(max_pos, orig_max)
        base = theta * (factor * seq_len / orig_max - (factor - 1)) ** (
            head_dim / (head_dim - 2))
        inv_freq = 1.0 / (base ** (np.arange(0, half, dtype=np.float64) * 2 / head_dim))
    elif rtype in ("yarn", "deepseek_yarn"):
        inv_freq, mscale = _yarn_scale_freqs(inv_freq, scaling, theta, head_dim)
    elif rtype == "longrope":
        inv_freq, mscale = _longrope(inv_freq, scaling, max_pos, orig_max_pos)
    elif rtype not in (None, "default", ""):
        raise NotImplementedError(f"rope scaling {rtype!r}")
    pos = np.arange(max_pos, dtype=np.float64)
    freqs = (pos[:, None] * inv_freq if inv_freq.ndim == 2  # longrope: per row
             else np.outer(pos, inv_freq))
    table = np.concatenate([np.cos(freqs), np.sin(freqs)], axis=-1) * mscale
    return table.astype(np.float32)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               table: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` (n_tokens, heads, head_dim) by per-token positions
    (deft_tpu models/rope.py:177): out = x*cos + rotate_half(x)*sin with
    rotate_half([a, b]) = [-b, a], in fp32, cast back to x's dtype."""
    half = x.shape[-1] // 2
    cs = table[positions]  # (n, head_dim) fp32
    cos = cs[:, None, :half]
    sin = cs[:, None, half:]
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
