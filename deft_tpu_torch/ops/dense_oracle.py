"""Dense masked attention in plain torch: the oracle every kernel is held
against, and the arithmetic of each kernel's plain version.

Port of deft_tpu/ops/dense_oracle.py:18 (dense_tree_attention), :48
(dense_causal_attention) and :72 (dense_ragged_causal_attention), plus the
per-leaf path attention of
deft_tpu/ops/attn_impls.py:34 (seq_attn_xla).  All in fp32, cast back to the
query dtype.  A fully masked row yields 0 (masked terms are zeroed after the
exp, so its normaliser is 0), the convention of the kernels.

The ``*_state`` forms return the unnormalised flash state of the same
attention, fp32 (acc, m, l): m the row's largest visible score (natural
log), l the sum of exp(s - m), acc the exp-weighted sum of V, as deft_tpu's
partial=True kernels emit it for a merge across devices.  A row that sees no
token keeps M_EMPTY, the kernels' -1e30 running max in base 2 times ln 2:
finite, so that merge never computes inf - inf.
"""

from __future__ import annotations

import math

import torch

M_EMPTY = -1e30 * math.log(2.0)


def _masked_softmax(s: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """softmax over the last axis of ``s`` restricted to ``mask``; rows
    with no True entry give all zeros."""
    m = s.masked_fill(~mask, float("-inf")).amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m) * mask
    l = p.sum(dim=-1, keepdim=True)
    return p / torch.where(l == 0, torch.ones_like(l), l)


def _masked_state(s: torch.Tensor, mask: torch.Tensor):
    """(p, m, l) of the scores ``s`` restricted to ``mask`` over the last
    axis: p = exp(s - m) on the mask (0 off it), m the masked max (M_EMPTY
    on rows with no True entry), l = sum p."""
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.full_like(m, M_EMPTY))
    p = torch.exp(s - m)  # exp(-inf) = 0 off the mask
    return p, m[..., 0], p.sum(dim=-1)


def dense_tree_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         tok_lo: torch.Tensor, tok_hi: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """Exact tree attention: q (R, Hq, D) over tree KV k, v (T, Hkv, D) in
    DFS order; query row (leaf) r attends token t iff
    tok_lo[t] <= r < tok_hi[t].  Query head h*qpk + g reads KV head h."""
    R, Hq, D = q.shape
    Hkv = k.shape[1]
    qg = q.float().view(R, Hkv, Hq // Hkv, D)
    s = torch.einsum("rhgd,thd->rhgt", qg, k.float()) * scale
    leaf = torch.arange(R, device=q.device)[:, None]
    mask = (tok_lo[None, :] <= leaf) & (leaf < tok_hi[None, :])  # (R, T)
    p = _masked_softmax(s, mask[:, None, None, :])
    return torch.einsum("rhgt,thd->rhgd", p, v.float()).reshape(R, Hq, D).to(q.dtype)


def dense_tree_attention_state(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               tok_lo: torch.Tensor, tok_hi: torch.Tensor,
                               scale: float):
    """dense_tree_attention's unnormalised state: acc (R, Hq, D), m and l
    (R, Hq), fp32."""
    R, Hq, D = q.shape
    Hkv = k.shape[1]
    qg = q.float().view(R, Hkv, Hq // Hkv, D)
    s = torch.einsum("rhgd,thd->rhgt", qg, k.float()) * scale
    leaf = torch.arange(R, device=q.device)[:, None]
    mask = (tok_lo[None, :] <= leaf) & (leaf < tok_hi[None, :])  # (R, T)
    p, m, l = _masked_state(s, mask[:, None, None, :])
    acc = torch.einsum("rhgt,thd->rhgd", p, v.float())
    return acc.reshape(R, Hq, D), m.reshape(R, Hq), l.reshape(R, Hq)


def dense_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: float) -> torch.Tensor:
    """Causal self-attention of one prompt: q (N, Hq, D), k, v (N, Hkv, D)."""
    N, Hq, D = q.shape
    Hkv = k.shape[1]
    qg = q.float().view(N, Hkv, Hq // Hkv, D)
    s = torch.einsum("nhgd,thd->hgnt", qg, k.float()) * scale
    causal = torch.ones(N, N, dtype=torch.bool, device=q.device).tril()
    p = _masked_softmax(s, causal)
    return torch.einsum("hgnt,thd->nhgd", p, v.float()).reshape(N, Hq, D).to(q.dtype)


def dense_ragged_causal_attention(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, seg: torch.Tensor,
                                  scale: float) -> torch.Tensor:
    """Causal self-attention of prompts joined on the token axis: q (N, Hq,
    D), k, v (N, Hkv, D), seg (N,) each token's prompt, pads < 0; token i
    attends token j iff seg[i] == seg[j] >= 0 and i >= j, and pad rows give
    0.  Computed one prompt at a time (dense_causal_attention over its own
    tokens), the same function as deft_tpu's one (N, N) mask without its
    (N, Hq, N) scores."""
    out = torch.zeros_like(q)
    for s in torch.unique(seg).tolist():
        if s < 0:
            continue
        idx = (seg == s).nonzero().flatten()
        out[idx] = dense_causal_attention(q[idx], k[idx], v[idx], scale)
    return out


def dense_path_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         live: torch.Tensor, scale: float) -> torch.Tensor:
    """Per-leaf attention over each leaf's own path: q (R, Hq, D), k, v
    (R, C, Hkv, D), live (R, C) marks the path tokens."""
    R, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.float().view(R, Hkv, Hq // Hkv, D)
    s = torch.einsum("rhgd,rthd->rhgt", qg, k.float()) * scale
    p = _masked_softmax(s, live[:, None, None, :])
    return torch.einsum("rhgt,rthd->rhgd", p, v.float()).reshape(R, Hq, D).to(q.dtype)


def dense_path_attention_state(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               live: torch.Tensor, scale: float):
    """dense_path_attention's unnormalised state: acc (R, Hq, D), m and l
    (R, Hq), fp32."""
    R, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.float().view(R, Hkv, Hq // Hkv, D)
    s = torch.einsum("rhgd,rthd->rhgt", qg, k.float()) * scale
    p, m, l = _masked_state(s, live[:, None, None, :])
    acc = torch.einsum("rhgt,rthd->rhgd", p, v.float())
    return acc.reshape(R, Hq, D), m.reshape(R, Hq), l.reshape(R, Hq)
