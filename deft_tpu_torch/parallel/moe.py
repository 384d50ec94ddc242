"""Expert-parallel MoE block on the grid (the grouped matmul on each rank).

Port of deft_tpu/parallel/moe.py:49-187.  Expert stacks keep their stored
slices (parallel/sharding.py): the expert axis over sp when sp divides the
expert count (expert parallelism), each expert's inner dims cut over tp
(wg, wu column-parallel on I, wdown row-parallel).  Each rank

- routes its own dp window of rows (deft_tpu's in_specs ``P("dp", None)``)
  with the replicated router (the routing math of models/llama.py): at
  decode the rows the rank holds; at prefill, whose tokens are cut over sp
  (and not over dp), the sp windows' h is joined first, so that every
  rank of the sum over sp holds the same tokens, and the rank's rows are
  taken back after it;
- at prefill-scale token counts (``sharded_gmm_ok``): groups the routed
  slots of its own ne_local = NE / sp experts into the tile-aligned layout
  (``moe_dispatch_local``; slots owned by other ranks go to a drop bucket,
  an exact zero contribution) and runs B10's three launches on its
  (ne_local, E, I/tp) slice;
- at decode widths: the dense route over its local experts, weighted by
  its columns of the routing weights;

then the fp32 partial sums are all-reduced over sp and tp together (over tp
alone when the experts are replicated).  The block makes no dp
collective: each dp window is routed on its own ranks.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from deft_tpu_torch.models.config import LlamaConfig
from deft_tpu_torch.models.llama import (_GMM_TILE_M, _act_fn, moe_dense_sum,
                                         moe_grouped_sum, routing_weights,
                                         top_k_routes)
from deft_tpu_torch.ops.gmm import gmm_eligible
from deft_tpu_torch.parallel.mesh import Grid
from deft_tpu_torch.parallel.sharding import RowWindow


def _axes(grid: Grid):
    return grid.axis_size("dp"), grid.axis_size("sp"), grid.axis_size("tp")


def sharded_gmm_ok(grid: Grid, cfg: LlamaConfig, n: int) -> bool:
    """Eligibility of the expert-parallel grouped route for the n rows a
    rank routes, its dp window (deft_tpu moe.py:49-69, which takes the
    whole token count and divides it by dp)."""
    _, sp, tp = _axes(grid)
    NE, K = cfg.num_experts, cfg.experts_per_tok
    tm = _GMM_TILE_M
    if NE % sp:
        return False
    ne_local = NE // sp
    cap = min(K, ne_local)
    # engage when the tile-padded local layout wastes <= ~50% rows
    # (mirrors the single-chip _moe_gmm_ok threshold)
    if n * cap < 2 * ne_local * tm:
        return False
    E, I = cfg.hidden_size, cfg.intermediate_size
    if I % tp:
        return False
    return gmm_eligible(tm, E, I // tp, tm) and gmm_eligible(tm, I // tp, E, tm)


def moe_dispatch_local(top_i: torch.Tensor, top_w: torch.Tensor, e0: int,
                       ne_local: int, tm: int = _GMM_TILE_M):
    """models/llama.py moe_dispatch for the experts [e0, e0 + ne_local) of
    one rank (deft_tpu moe.py:84-121): the slots routed to them, sorted by
    local expert into groups that start on tm-row tiles, in a static worst
    case of M_pad = ceil((n cap + ne_local (tm - 1)) / tm) tm rows, cap =
    min(K, ne_local); foreign slots go to bucket ne_local, which sorts last
    and scatters past M_pad (dropped).  Returns (row_src, tok_pos, w_pos,
    tile_eid) as moe_dispatch does, with tile_eid local."""
    n, K = top_i.shape
    nK, dev = n * K, top_i.device
    cap = min(K, ne_local)
    M_pad = -(-(n * cap + ne_local * (tm - 1)) // tm) * tm
    flat_g = top_i.reshape(-1)
    local = (flat_g >= e0) & (flat_g < e0 + ne_local)
    flat_e = torch.where(local, flat_g - e0, ne_local)
    flat_t = torch.arange(n, device=dev).repeat_interleave(K)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    g = torch.zeros(ne_local + 1, dtype=torch.long, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))[:ne_local]
    gstart = torch.cumsum(g, 0) - g
    padded = (g + tm - 1) // tm * tm
    pstart = torch.cumsum(padded, 0) - padded
    sec = se.clamp(0, ne_local - 1)
    pos = pstart[sec] + torch.arange(nK, device=dev) - gstart[sec]
    pos = torch.where(se < ne_local, pos, M_pad)  # the drop row
    src = flat_t[order]

    def scatter(fill, values, dtype):
        buf = torch.full((M_pad + 1,), fill, dtype=dtype, device=dev)
        return buf.scatter_(0, pos, values)[:M_pad]

    row_src = scatter(0, src, torch.long)
    tok_pos = scatter(n, src, torch.long)
    w_pos = scatter(0.0, top_w.reshape(-1).float()[order], torch.float32)
    tiles = torch.arange(M_pad // tm, device=dev) * tm
    tile_eid = (torch.searchsorted(pstart, tiles, right=True) - 1).clamp(
        0, ne_local - 1).to(torch.int32)
    return row_src, tok_pos, w_pos, tile_eid


def make_sharded_moe(grid: Grid):
    """The MoE block of a rank, for ModelRunner(mesh=grid): the grouped
    route on the rank's experts where sharded_gmm_ok passes, the dense
    route on them otherwise, then the sum over the ranks holding the
    other experts and column blocks.  moe_fn(cfg, lp, h, rows) -> (n, E) in
    h's dtype, for the n rows of h the rank holds: with ``rows``, an sp
    window of a prefill's tokens (parallel/sharding.py RowWindow), the
    windows are joined before the block and the rank's rows taken after
    it."""
    _, sp, _ = _axes(grid)

    def moe_fn(cfg: LlamaConfig, lp: Dict[str, torch.Tensor], h: torch.Tensor,
               rows: Optional[RowWindow] = None) -> torch.Tensor:
        if rows is not None and rows.axis == "sp":
            return rows.take(moe_fn(cfg, lp, rows.join(h)))
        NE = cfg.num_experts
        ep = sp > 1 and NE % sp == 0
        ne_local = NE // sp if ep else NE
        e0 = grid.index("sp") * ne_local if ep else 0
        if sharded_gmm_ok(grid, cfg, h.shape[0]):
            top_i, top_w = top_k_routes(cfg, lp, h)
            out = moe_grouped_sum(lp, h, *moe_dispatch_local(top_i, top_w, e0,
                                                             ne_local),
                                  act=_act_fn(cfg.hidden_act))
        else:
            rw = routing_weights(cfg, lp, h)
            out = moe_dense_sum(lp, h, rw[:, e0:e0 + ne_local],
                                _act_fn(cfg.hidden_act))
        return grid.all_reduce(out, ("sp", "tp") if ep else "tp").to(h.dtype)

    return moe_fn
