"""Rotary position embeddings, HF-Llama (rotate-half) convention, with
Llama-3 frequency scaling.

Port of deft_tpu/models/rope.py:92 (rope_table, a numpy copy with its
Llama-3 scaling) and :177 (apply_rope, now torch).  The cos/sin table is
built once on the host and moved to the runner's device.
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


def rope_table(
    head_dim: int,
    max_pos: int,
    theta: float = 10000.0,
    scaling: Optional[Dict[str, Any]] = None,
) -> np.ndarray:
    """(max_pos, head_dim) fp32 numpy table: [cos | sin] halves, HF layout
    (cos/sin each repeated over the two rotated halves).

    Scalings: none and Llama-3 (DeFT's deft/layers/rotary_embedding.py);
    deft_tpu's linear, dynamic NTK, YaRN and LongRoPE come with the presets
    that need them, and raise here until then."""
    half = head_dim // 2
    inv_freq = 1.0 / (theta ** (np.arange(0, half, dtype=np.float64) * 2 / head_dim))
    if scaling is not None:
        rtype = scaling.get("rope_type", scaling.get("type", ""))
        if rtype == "llama3":
            inv_freq = _llama3_scale_freqs(inv_freq, scaling)
        elif rtype not in ("default", "", None):
            raise NotImplementedError(f"rope scaling {rtype!r} is not ported yet")
    freqs = np.outer(np.arange(max_pos, dtype=np.float64), inv_freq)
    table = np.concatenate([np.cos(freqs), np.sin(freqs)], axis=-1)
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
