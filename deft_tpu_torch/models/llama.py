"""Dense Llama forward over stacked layer parameters, in torch.

Port of deft_tpu/models/llama.py: RaggedPrefillBatch (:73), KVPool,
kv_store and kv_gather_heads (:84-133, int8 KV included), mm (:136, int8
weights included), rms_norm (:161), the per-layer body (:318-417, a
lax.scan there, a Python loop over layers here), decode_forward (:420),
prefill_forward (:456) and ragged_prefill_forward (:488).  MoE, Gemma
norms, qk-norm and qkv biases come in later slices; loader.check_supported
refuses such configs.

Attention is a pluggable AttnFn (ops/attn_impls.py), as in deft_tpu:
    (q, k_new, v_new, k_pool, v_pool, layer_idx, batch, scale) -> (R, Hq, D)
Norm and softmax math runs in fp32; matmuls run in the activation dtype
(int8 weights: see ``mm``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from deft_tpu_torch.models.config import LlamaConfig
from deft_tpu_torch.models.rope import apply_rope
from deft_tpu_torch.ops import int8_matmul as i8mm


@dataclasses.dataclass
class RaggedPrefillBatch:
    """B prompts joined on the token axis (deft_tpu llama.py:73), on the
    device: the per-token arrays are (P,) and ``last_idx`` (B,)."""

    tokens: torch.Tensor     # concatenated prompt tokens
    positions: torch.Tensor  # position within the token's own prompt
    out_loc: torch.Tensor    # KV slot of each token
    seg_ids: torch.Tensor    # prompt index of each token (int32)
    last_idx: torch.Tensor   # index of each prompt's final token


@dataclasses.dataclass
class KVPool:
    """Paged KV arena for one of K/V: ``data`` is token-major and
    head-flattened, (L, S, Hkv*D) — one row is every head's K (or V) of one
    token, the layout the paged kernels read (deft_tpu llama.py:84).  An
    int8 pool adds per-(token, head) fp32 ``scale`` stored head-major,
    (L, Hkv, S), so one head's scales of consecutive slots are contiguous."""

    data: torch.Tensor
    scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.scale is not None


def kv_store(pool: KVPool, li: int, out_loc: torch.Tensor,
             x: torch.Tensor) -> None:
    """Write new per-token rows x (n, Hkv, D) to pool slots ``out_loc`` of
    layer ``li``, IN PLACE (``index_copy_``; deft_tpu's functional scatter
    llama.py:102), quantising them for an int8 pool: s = max(max|x| / 127,
    1e-8) per (token, head), codes round(x / s) (half to even, as jnp.round)
    clipped to +-127.  Padded rows all carry DUMP_SLOT: duplicate indices
    there race harmlessly, and no plan reads that slot as live."""
    n, Hkv, _ = x.shape
    if not pool.quantized:
        pool.data[li].index_copy_(0, out_loc, x.reshape(n, -1).to(pool.data.dtype))
        return
    xf = x.float()
    s = torch.clamp_min(xf.abs().amax(dim=-1) / 127.0, 1e-8)  # (n, Hkv)
    codes = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8)
    pool.data[li].index_copy_(0, out_loc, codes.reshape(n, -1))
    pool.scale[li].index_copy_(1, out_loc, s.t().contiguous())


def kv_gather_heads(pool: KVPool, li: int, idx: torch.Tensor, head_dim: int,
                    out_dtype) -> torch.Tensor:
    """Pool rows of layer ``li`` with the head axis un-flattened, int8 rows
    dequantised to ``out_dtype`` (deft_tpu llama.py:123): idx (T,) gives
    (T, Hkv, D), idx (R, C) gives (R, C, Hkv, D).  The kernels' plain
    versions read the pools through it."""
    flat = idx.reshape(-1).long()
    d = pool.data[li].index_select(0, flat)
    d = d.view(idx.shape + (-1, head_dim))
    if not pool.quantized:
        return d
    s = pool.scale[li].index_select(1, flat).t()  # (n, Hkv)
    s = s.reshape(idx.shape + (-1, 1))
    return (d.float() * s).to(out_dtype)


def mm(x: torch.Tensor, p: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    """x @ p[name], routed by the scale key the loader wrote (deft_tpu
    llama.py:136-158):
      name + "_s"  — weight-only int8, the plain torch expression: the
                     product in x's dtype, times the fp32 per-column scale,
                     cast back (deft_tpu leaves it to XLA);
      name + "_sp" — the kernel B9 (ops/int8_matmul.py) when deft_tpu's
                     shape rule makes the product eligible (decode-sized
                     rows), else the same expression;
      neither      — x @ w."""
    w = p[name]
    s = p.get(name + "_s")
    if s is None:
        s = p.get(name + "_sp")
        if s is None:
            return x @ w
        if i8mm.eligible(x, w):
            return i8mm.int8_matmul(x, w, s)
    return ((x @ w.to(x.dtype)).float() * s).to(x.dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


AttnFn = Callable[..., torch.Tensor]

_LAYER_KEYS = ("ln1", "wqkv", "wo", "ln2", "wgu", "wdown")


def layer_params(params: Dict[str, torch.Tensor], li: int) -> Dict[str, torch.Tensor]:
    """Layer li's slices of the stacked parameters, int8 scales included."""
    return {k: params[k][li] for base in _LAYER_KEYS
            for k in (base, base + "_s", base + "_sp") if k in params}


def forward_layers(cfg: LlamaConfig, params: Dict[str, torch.Tensor],
                   rope_tbl: torch.Tensor, k_pool: KVPool, v_pool: KVPool,
                   tokens: torch.Tensor, positions: torch.Tensor,
                   out_loc: torch.Tensor, attn: AttnFn, batch) -> torch.Tensor:
    """Embed, run every decoder layer (writing each layer's new K/V into the
    pools before its attention reads them), final norm; returns (n, E)."""
    x = params["embed"][tokens]
    n = x.shape[0]
    D = cfg.head_dim
    nq_d, nkv_d = cfg.num_q_heads * D, cfg.num_kv_heads * D
    scale = D ** -0.5
    eps = cfg.rms_norm_eps
    I = cfg.intermediate_size
    for li in range(cfg.num_layers):
        lp = layer_params(params, li)
        h = rms_norm(x, lp["ln1"], eps)
        qkv = mm(h, lp, "wqkv")
        q = qkv[:, :nq_d].reshape(n, cfg.num_q_heads, D)
        k = qkv[:, nq_d:nq_d + nkv_d].reshape(n, cfg.num_kv_heads, D)
        v = qkv[:, nq_d + nkv_d:].reshape(n, cfg.num_kv_heads, D)
        qk = apply_rope(torch.cat([q, k], dim=1), positions, rope_tbl)
        q, k = qk[:, :cfg.num_q_heads], qk[:, cfg.num_q_heads:]
        kv_store(k_pool, li, out_loc, k)
        kv_store(v_pool, li, out_loc, v)
        o = attn(q, k, v, k_pool, v_pool, li, batch, scale)
        x = x + mm(o.reshape(n, -1).to(x.dtype), lp, "wo")
        h = rms_norm(x, lp["ln2"], eps)
        gu = mm(h, lp, "wgu")
        g, u = gu[:, :I], gu[:, I:]
        x = x + mm(torch.nn.functional.silu(g.float()).to(x.dtype) * u,
                   lp, "wdown")
    return rms_norm(x, params["ln_f"], eps)


def decode_forward(cfg: LlamaConfig, params, rope_tbl, k_pool: KVPool,
                   v_pool: KVPool, batch, attn: AttnFn) -> torch.Tensor:
    """One tree-decode step over ``batch`` (q_tokens, q_pos, out_loc and the
    attention plan's arrays); returns (R, V) fp32 logits."""
    x = forward_layers(cfg, params, rope_tbl, k_pool, v_pool, batch.q_tokens,
                       batch.q_pos, batch.out_loc, attn, batch)
    return mm(x, params, "lm_head").float()


def prefill_forward(cfg: LlamaConfig, params, rope_tbl, k_pool: KVPool,
                    v_pool: KVPool, tokens: torch.Tensor, out_loc: torch.Tensor,
                    attn: AttnFn) -> torch.Tensor:
    """Prefill one prompt (positions 0..n-1); returns the last token's (V,)
    fp32 logits.  ``attn`` is causal attention over the in-flight
    projections (the pool rows are written, not re-read)."""
    positions = torch.arange(tokens.shape[0], device=tokens.device)
    x = forward_layers(cfg, params, rope_tbl, k_pool, v_pool, tokens,
                       positions, out_loc, attn, None)
    return mm(x[-1:], params, "lm_head")[0].float()


def ragged_prefill_forward(cfg: LlamaConfig, params, rope_tbl, k_pool: KVPool,
                           v_pool: KVPool, batch: RaggedPrefillBatch,
                           attn: AttnFn) -> torch.Tensor:
    """Prefill B prompts joined on the token axis in one forward; returns
    each prompt's last-token logits, (B, V) fp32.  ``attn`` masks pairs of
    tokens from different prompts through batch.seg_ids."""
    x = forward_layers(cfg, params, rope_tbl, k_pool, v_pool, batch.tokens,
                       batch.positions, batch.out_loc, attn, batch)
    return mm(x[batch.last_idx], params, "lm_head").float()
