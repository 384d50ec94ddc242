"""Dense Llama forward over stacked layer parameters, in torch.

Port of deft_tpu/models/llama.py: RaggedPrefillBatch (:73), KVPool,
kv_store and kv_gather_heads (:84-133, int8 KV included), mm (:136, int8
weights included), rms_norm (:161), the Mixtral-family sparse MoE block
(_moe_mlp :188, _moe_gmm_ok :232, _moe_mlp_gmm :245), the per-layer body
(:318-417, a lax.scan there, a Python loop over layers here),
decode_forward (:420), prefill_forward (:456) and ragged_prefill_forward
(:488), with every family deft_tpu runs: Gemma's (1 + w) norms in fp32
(gemma_rms_norm :167), its embedding scale and GeGLU (_act_fn :177), the
Qwen2 qkv bias and the Qwen3 per-head q/k norms (:332-375).  The forwards
take a ``shard`` (parallel/engine.py ShardedModel) to run one rank of a
(dp, sp, tp) grid on its slices of the parameters and its window of the
step's rows (a decode step's leaves over dp, a prefill's tokens over sp:
deft_tpu parallel/sharding.py:121-162); the MoE routes' pieces
(routing_weights, moe_dense_sum, top_k_routes, moe_grouped_sum) serve the
grid's expert-parallel block (parallel/moe.py) too.

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
from deft_tpu_torch.ops import gmm as gmm_op
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


def gemma_rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Gemma's RMSNorm: (1 + w) multiplied in fp32 before the output cast
    (transformers GemmaRMSNorm; deft_tpu llama.py:167)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)


def _act_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The MLP gate activation by its HF name, fp32 in and out (deft_tpu
    llama.py:177): silu, the tanh gelu (Gemma's GeGLU) or the exact gelu."""
    if name == "silu":
        return torch.nn.functional.silu
    if name in ("gelu_pytorch_tanh", "gelu_new"):
        return lambda x: torch.nn.functional.gelu(x, approximate="tanh")
    if name == "gelu":
        return torch.nn.functional.gelu
    raise NotImplementedError(f"hidden_act {name!r}")


def _router_probs(lp: Dict[str, torch.Tensor], h: torch.Tensor) -> torch.Tensor:
    """The MoE router's softmax over the experts, fp32 (n, NE)."""
    return torch.softmax((h @ lp["wrt"].to(h.dtype)).float(), dim=-1)


def _expert_scale(lp: Dict[str, torch.Tensor], name: str) -> Optional[torch.Tensor]:
    """The (NE, F) int8 scales of an expert stack, either flavour: no kernel
    takes expert-batched int8 at decode, so "_s" and "_sp" route alike."""
    s = lp.get(name + "_s")
    return lp.get(name + "_sp") if s is None else s


def routing_weights(cfg: LlamaConfig, lp: Dict[str, torch.Tensor],
                    h: torch.Tensor) -> torch.Tensor:
    """(n, NE) fp32 weights of the dense route: softmax router, top-k
    experts renormalised, the others 0."""
    probs = _router_probs(lp, h)
    top_i = probs.topk(cfg.experts_per_tok, dim=-1).indices
    rw = probs * torch.zeros_like(probs).scatter_(1, top_i, 1.0)
    return rw / rw.sum(dim=-1, keepdim=True)


def moe_dense_sum(lp: Dict[str, torch.Tensor], h: torch.Tensor,
                  rw: torch.Tensor, act=torch.nn.functional.silu) -> torch.Tensor:
    """sum_e rw[:, e] * expert_e(h) over the experts stacked in lp (all of
    them, or a rank's slice with its columns of rw), fp32 (n, E)."""

    def emm(x, name, eq):
        y = torch.einsum(eq, x, lp[name].to(x.dtype))
        s = _expert_scale(lp, name)
        if s is not None:
            y = (y.float() * s[:, None, :]).to(x.dtype)
        return y

    g = emm(h, "wg", "re,neo->nro")  # (NE, R, I)
    u = emm(h, "wu", "re,neo->nro")
    z = act(g.float()).to(h.dtype) * u
    o = emm(z, "wdown", "nri,nie->nre")  # (NE, R, E)
    return torch.einsum("nre,rn->re", o.float(), rw.float())


def _moe_mlp(cfg: LlamaConfig, lp: Dict[str, torch.Tensor],
             h: torch.Tensor) -> torch.Tensor:
    """Mixtral-family sparse MoE block, DENSE over the stacked experts
    (deft_tpu llama.py:188): softmax router, top-k experts with renormalised
    weights, every expert computed and the unselected ones weighted 0.  At
    decode widths nearly every expert is hit each step, so streaming all of
    them is the read the step needs anyway.  int8 experts are widened to
    h's dtype for the product, which is rounded, then scaled in fp32 and cast
    (``emm``; deft_tpu has no expert-batched int8 kernel)."""
    return moe_dense_sum(lp, h, routing_weights(cfg, lp, h),
                         _act_fn(cfg.hidden_act)).to(h.dtype)


# Row tile of the grouped-matmul dispatch; the gmm route engages when the
# padded-group layout wastes at most ~50% of its rows (n * k >= 2 * NE * tile)
_GMM_TILE_M = gmm_op.TILE_M


def _moe_gmm_ok(cfg: LlamaConfig, n: int) -> bool:
    """deft_tpu's gate (llama.py:232): prefill-scale token counts whose
    expert widths the grouped matmul tiles."""
    NE, K = cfg.num_experts, cfg.experts_per_tok
    if n * K < 2 * NE * _GMM_TILE_M:
        return False
    E, I = cfg.hidden_size, cfg.intermediate_size
    return (gmm_op.gmm_eligible(_GMM_TILE_M, E, I, _GMM_TILE_M)
            and gmm_op.gmm_eligible(_GMM_TILE_M, I, E, _GMM_TILE_M))


def moe_dispatch(top_i: torch.Tensor, top_w: torch.Tensor, num_experts: int,
                 tm: int = _GMM_TILE_M):
    """The grouped layout of deft_tpu llama.py:258-287 for top-k choices
    top_i (n, K) with weights top_w (n, K): routed slots sorted by expert
    (stable, so token-major within an expert) into groups that start on
    tm-row tiles, in a static worst case of M_pad = ceil((n K + NE (tm - 1))
    / tm) tm rows.  Returns (row_src, tok_pos, w_pos, tile_eid): each row's
    source token (0 on pad rows), its combine target (n on pad rows: a row
    that is dropped), its combine weight (0 on pad rows) and each tile's
    expert (tiles past the last group take the last expert; their rows are
    pad rows).  No host sync: the group sizes come from scatter_add_ (CUDA
    bincount reads the max on the host) and no shape depends on the data."""
    n, K = top_i.shape
    nK, NE, dev = n * K, num_experts, top_i.device
    M_pad = -(-(nK + NE * (tm - 1)) // tm) * tm
    flat_e = top_i.reshape(-1)
    flat_t = torch.arange(n, device=dev).repeat_interleave(K)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    g = torch.zeros(NE, dtype=torch.long, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    gstart = torch.cumsum(g, 0) - g
    padded = (g + tm - 1) // tm * tm
    pstart = torch.cumsum(padded, 0) - padded
    pos = pstart[se] + torch.arange(nK, device=dev) - gstart[se]
    src = flat_t[order]
    row_src = torch.zeros(M_pad, dtype=torch.long, device=dev).scatter_(0, pos, src)
    tok_pos = torch.full((M_pad,), n, dtype=torch.long, device=dev).scatter_(0, pos, src)
    w_pos = torch.zeros(M_pad, dtype=torch.float32, device=dev).scatter_(
        0, pos, top_w.reshape(-1).float()[order])
    tiles = torch.arange(M_pad // tm, device=dev) * tm
    tile_eid = (torch.searchsorted(pstart, tiles, right=True) - 1).to(torch.int32)
    return row_src, tok_pos, w_pos, tile_eid


def _moe_mlp_gmm(cfg: LlamaConfig, lp: Dict[str, torch.Tensor],
                 h: torch.Tensor) -> torch.Tensor:
    """Top-k MoE for prefill-scale token counts (deft_tpu llama.py:245): the
    routing math of _moe_mlp, the rows of each token's top-k experts in the
    grouped layout (``moe_dispatch``), three grouped matmuls (kernel B10,
    ops/gmm.py; int8 experts pass their (NE, F) scales to it), and an fp32
    weighted ``index_add_`` combine into n + 1 rows, whose last row takes the
    pad rows and is dropped.  FLOPs and expert-weight reads scale with k, not
    NE."""
    top_i, top_w = top_k_routes(cfg, lp, h)
    return moe_grouped_sum(lp, h, *moe_dispatch(top_i, top_w, cfg.num_experts),
                           act=_act_fn(cfg.hidden_act)).to(h.dtype)


def top_k_routes(cfg: LlamaConfig, lp: Dict[str, torch.Tensor], h: torch.Tensor):
    """Each token's top-k experts (n, K) and their renormalised weights."""
    top_p, top_i = _router_probs(lp, h).topk(cfg.experts_per_tok, dim=-1)
    return top_i, top_p / top_p.sum(dim=-1, keepdim=True)


def moe_grouped_sum(lp: Dict[str, torch.Tensor], h: torch.Tensor, row_src,
                    tok_pos, w_pos, tile_eid,
                    act=torch.nn.functional.silu) -> torch.Tensor:
    """The grouped route's three B10 launches over the experts stacked in lp
    (all of them, or a rank's slice) on a dispatch layout, combined in fp32
    into (n, E); rows with tok_pos == n are dropped."""
    n, E = h.shape
    xs = h[row_src]  # (M_pad, E)
    gx = gmm_op.gmm(xs, lp["wg"], tile_eid, _expert_scale(lp, "wg"))
    ux = gmm_op.gmm(xs, lp["wu"], tile_eid, _expert_scale(lp, "wu"))
    zx = act(gx.float()).to(h.dtype) * ux
    yx = gmm_op.gmm(zx, lp["wdown"], tile_eid, _expert_scale(lp, "wdown"))
    out = torch.zeros((n + 1, E), dtype=torch.float32, device=h.device)
    out.index_add_(0, tok_pos, yx.float() * w_pos[:, None])
    return out[:n]


AttnFn = Callable[..., torch.Tensor]

_LAYER_KEYS = ("ln1", "wqkv", "bqkv", "ln_q", "ln_k", "wo", "ln2", "wgu", "wdown",
               "wrt", "wg", "wu")


def layer_params(params: Dict[str, torch.Tensor], li: int) -> Dict[str, torch.Tensor]:
    """Layer li's slices of the stacked parameters, int8 scales included."""
    return {k: params[k][li] for base in _LAYER_KEYS
            for k in (base, base + "_s", base + "_sp") if k in params}


def forward_layers(cfg: LlamaConfig, params: Dict[str, torch.Tensor],
                   rope_tbl: torch.Tensor, k_pool: KVPool, v_pool: KVPool,
                   tokens: torch.Tensor, positions: torch.Tensor,
                   out_loc: torch.Tensor, attn: AttnFn, batch,
                   shard=None, rows=None) -> torch.Tensor:
    """Embed, run every decoder layer (writing each layer's new K/V into the
    pools before its attention reads them), final norm; returns (n, E).
    A MoE layer takes the grouped-matmul route when the token count passes
    _moe_gmm_ok (prefill), else the dense route (decode widths), as
    deft_tpu llama.py:383-398 with its single-chip runner's dispatch on.

    ``shard`` (parallel/engine.py ShardedModel) runs one rank of a grid:
    params hold the rank's slices, so its head and MLP widths are read off
    ``wo`` and ``wqkv``; the row-parallel ``wo`` and ``wdown`` products are
    summed over tp (``shard.reduce_tp``) and a MoE layer runs
    ``shard.moe``.  ``rows`` (parallel/sharding.py RowWindow) is the
    rank's window of the step's rows: ``tokens`` and ``positions`` are that
    window's, ``out_loc`` every row's, and the result the window's rows.
    Over dp (a decode step) each layer joins the windows' new K/V rows
    before the store, and attention takes and returns the rank's q rows;
    over sp (a prefill) it joins q, k and v, attention runs over every
    token, and the rank keeps its rows of o.  Without ``rows`` every rank
    runs every row.  ``forward_layers.last_rows`` keeps the rows of the
    last call.

    Families (deft_tpu llama.py:331-375): Gemma scales the embedding by
    sqrt(hidden) rounded to the model dtype and takes gemma_rms_norm; the
    MLP gate takes the config's activation; a Qwen2 qkv bias is added to
    the fused product; Qwen3 RMS-normalises each head of q and k before
    RoPE."""
    x = params["embed"][tokens]
    if cfg.gemma_norm:
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=x.dtype)
    norm = gemma_rms_norm if cfg.gemma_norm else rms_norm
    act = _act_fn(cfg.hidden_act)
    n = x.shape[0]
    D = cfg.head_dim
    hq = params["wo"].shape[-2] // D  # the rank's heads (all without a grid)
    hkv = (params["wqkv"].shape[-1] // D - hq) // 2
    nq_d, nkv_d = hq * D, hkv * D
    scale = D ** -0.5
    eps = cfg.rms_norm_eps
    reduce = shard.reduce_tp if shard is not None else (lambda y: y)
    forward_layers.last_rows = n
    for li in range(cfg.num_layers):
        lp = layer_params(params, li)
        h = norm(x, lp["ln1"], eps)
        qkv = mm(h, lp, "wqkv")
        if cfg.qkv_bias:
            qkv = qkv + lp["bqkv"].to(qkv.dtype)
        q = qkv[:, :nq_d].reshape(n, hq, D)
        k = qkv[:, nq_d:nq_d + nkv_d].reshape(n, hkv, D)
        v = qkv[:, nq_d + nkv_d:].reshape(n, hkv, D)
        if cfg.qk_norm:
            q = rms_norm(q, lp["ln_q"], eps)
            k = rms_norm(k, lp["ln_k"], eps)
        qk = apply_rope(torch.cat([q, k], dim=1), positions, rope_tbl)
        q, k = qk[:, :hq], qk[:, hq:]
        if rows is not None and rows.axis == "dp":
            kv = rows.join(torch.cat([k, v], dim=1))
            k, v = kv[:, :hkv], kv[:, hkv:]
        elif rows is not None:
            qkv = rows.join(torch.cat([q, k, v], dim=1))
            q, k, v = qkv[:, :hq], qkv[:, hq:hq + hkv], qkv[:, hq + hkv:]
        kv_store(k_pool, li, out_loc, k)
        kv_store(v_pool, li, out_loc, v)
        o = attn(q, k, v, k_pool, v_pool, li, batch, scale)
        if rows is not None and rows.axis == "sp":
            o = rows.take(o)
        x = x + reduce(mm(o.reshape(n, -1).to(x.dtype), lp, "wo"))
        h = norm(x, lp["ln2"], eps)
        if cfg.num_experts > 0:
            if shard is not None:
                x = x + shard.moe(cfg, lp, h, rows)
            elif _moe_gmm_ok(cfg, n):
                x = x + _moe_mlp_gmm(cfg, lp, h)
            else:
                x = x + _moe_mlp(cfg, lp, h)
            continue
        gu = mm(h, lp, "wgu")
        I = gu.shape[-1] // 2
        g, u = gu[:, :I], gu[:, I:]
        x = x + reduce(mm(act(g.float()).to(x.dtype) * u, lp, "wdown"))
    return norm(x, params["ln_f"], eps)


# the rows the last forward ran through each layer's dense products (wqkv,
# wo, the MLP's wgu and wdown): a grid rank's window, or every row
forward_layers.last_rows = 0


def lm_head(params, x: torch.Tensor, shard=None) -> torch.Tensor:
    """(rows, V) fp32 logits; a grid's vocab blocks joined first."""
    logits = mm(x, params, "lm_head")
    if shard is not None:
        logits = shard.join_vocab(logits)
    return logits.float()


def decode_forward(cfg: LlamaConfig, params, rope_tbl, k_pool: KVPool,
                   v_pool: KVPool, batch, attn: AttnFn, shard=None,
                   compute_logits: bool = True) -> torch.Tensor:
    """One tree-decode step over ``batch`` (q_tokens, q_pos, out_loc and the
    attention plan's arrays); returns (R, V) fp32 logits.  On a grid the
    batch's ``dp_rows`` is the rank's window of the R rows, q_tokens and
    q_pos are its rows, and the logits are its rows' (the runner joins
    their top-K).

    compute_logits=False (deft_tpu llama.py:433-452) skips the lm_head
    product and returns the final hidden state (R, E): steps whose tokens
    are fixed ahead (a speculative accept schedule) need only the KV the
    step writes."""
    x = forward_layers(cfg, params, rope_tbl, k_pool, v_pool, batch.q_tokens,
                       batch.q_pos, batch.out_loc, attn, batch, shard,
                       getattr(batch, "dp_rows", None))
    if not compute_logits:
        return x
    return lm_head(params, x, shard)


def prefill_forward(cfg: LlamaConfig, params, rope_tbl, k_pool: KVPool,
                    v_pool: KVPool, tokens: torch.Tensor, out_loc: torch.Tensor,
                    attn: AttnFn, shard=None) -> torch.Tensor:
    """Prefill one prompt (positions 0..n-1); returns the last token's (V,)
    fp32 logits.  ``attn`` is causal attention over the in-flight
    projections (the pool rows are written, not re-read).  On a grid a
    rank runs its sp window of the tokens (``shard.prefill_rows``); the
    ranks holding the last token make its logits, and the others' zeros
    are summed with them over sp."""
    N = tokens.shape[0]
    positions = torch.arange(N, device=tokens.device)
    if shard is None:
        x = forward_layers(cfg, params, rope_tbl, k_pool, v_pool, tokens,
                           positions, out_loc, attn, None)
        return lm_head(params, x[-1:])[0]
    rows = shard.prefill_rows(N)
    x = forward_layers(cfg, params, rope_tbl, k_pool, v_pool, rows.take(tokens),
                       rows.take(positions), out_loc, attn, None, shard, rows)
    last = N - 1 - rows.r0  # the last token's row in this window
    if 0 <= last < rows.rows:
        logits = lm_head(params, x[last:last + 1], shard)
    else:
        logits = torch.zeros((1, cfg.vocab_size), dtype=torch.float32, device=x.device)
    return rows.reduce(logits)[0]


def ragged_prefill_forward(cfg: LlamaConfig, params, rope_tbl, k_pool: KVPool,
                           v_pool: KVPool, batch: RaggedPrefillBatch,
                           attn: AttnFn, shard=None) -> torch.Tensor:
    """Prefill B prompts joined on the token axis in one forward; returns
    each prompt's last-token logits, (B, V) fp32.  ``attn`` masks pairs of
    tokens from different prompts through batch.seg_ids."""
    x = forward_layers(cfg, params, rope_tbl, k_pool, v_pool, batch.tokens,
                       batch.positions, batch.out_loc, attn, batch, shard)
    return lm_head(params, x[batch.last_idx], shard)
