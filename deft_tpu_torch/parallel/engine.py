"""Sharded attention and model collectives for ModelRunner(mesh=grid).

Port of deft_tpu/parallel/engine.py:76-246.  deft_tpu swaps shard_map'ed
AttnFns into its jitted steps; here every rank runs the same eager step on
its own slices, and the AttnFns below cut the step's plan to the rank's
window, run the rank's partial kernel and merge the ranks' states:

- ``tp``: a rank's q, k and v are its heads (the model's projections are
  sliced, parallel/sharding.py); attention is independent per head, so
  nothing crosses tp inside attention;
- ``sp``: the plan's blocks up to the last live one (the bucket padding
  after it dropped) are padded to a multiple of sp and each rank
  takes one contiguous span (its part of ``seg_src`` or ``kv_idx``,
  ``tok_lo/hi`` and ``blk_lo/hi``), reads only that KV (global KV reads
  stay exactly-once) and computes the partial (acc, m, l); ``lse_merge``
  recovers the exact softmax over the sp group;
- ``dp``: the query rows (leaves) are padded to a multiple of dp and each
  rank holds one window of them through the whole step (parallel/
  sharding.py ``RowWindow``, the batch's ``dp_rows``): its q rows come in,
  and only its rows of o go out; leaf intervals are global leaf indices,
  so they are shifted into the window (``shift_window``), and blocks
  outside it are marked empty so the kernel skips them before any read.

Per rank the kernels are the partial entries: B1p (paged plans) or B4p
(paged plans over int8 pools), and B11 where the plan is not
segment-aligned, over bf16/fp32 or int8 pools (deft_tpu's mesh path takes
XLA attention for int8 pools under a gather plan; the port runs B11's int8
form).  Prefill takes the single-device AttnFn as it is: B3 on the rank's
heads, with no collective.

Every collective is an all_reduce, so gloo with several ranks on one card
runs the code NCCL runs with a card per rank: the sp merge is one MAX and
one SUM over a packed [l, acc] buffer; row windows and vocab blocks (tp)
are joined exactly by summing zero-padded buffers in which each rank
wrote its own block.

``ShardedModel`` holds the model's own collectives: tp sums after ``wo``
and ``wdown``, the vocab join of ``lm_head``, the MoE block of
parallel/moe.py, and the join of each window's top-K (or, where the
runner keeps them, its logits) over dp, so that every rank branches the
same way.  A rank runs its row window through every dense layer
(models/llama.py ``forward_layers``): the K/V rows of all windows are
joined before the store, as every rank's pools hold every slot.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, Optional

import numpy as np
import torch

from deft_tpu_torch.ops.paged_flatten_attn import (paged_flatten_attention_partial,
                                                   row_tile_tiles, unfold_rows)
from deft_tpu_torch.ops.paged_quant import paged_flatten_attention_q_partial
from deft_tpu_torch.ops.sharded_flatten import flatten_attention_partial
from deft_tpu_torch.parallel.mesh import Grid
from deft_tpu_torch.parallel.sharding import RowWindow, row_window

EMPTY_LO = 2 ** 30  # an empty leaf interval is [EMPTY_LO, 0)


def _pad_to(x: torch.Tensor, n: int, value: int = 0) -> torch.Tensor:
    if x.shape[0] == n:
        return x
    pad = torch.full((n - x.shape[0],) + x.shape[1:], value, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad])


def shift_window(r0: int, rows: int, blo: torch.Tensor, bhi: torch.Tensor):
    """Shift block leaf intervals into the dp window [r0, r0 + rows) and
    mark the blocks outside it empty, so the kernel skips them before any
    read (deft_tpu engine.py:112-119).  FULL_BLOCK_LO, -(1 << 24), stays
    below the kernels' -(1 << 20) threshold after the shift."""
    blo, bhi = blo - r0, bhi - r0
    live = (blo < rows) & (bhi > 0)
    return torch.where(live, blo, EMPTY_LO), torch.where(live, bhi, 0)


def last_live(live) -> int:
    """1 + the index of the last True of a 1-D host mask (1 when there is
    none): the blocks a rank window must cover."""
    idx = np.flatnonzero(np.asarray(live))
    return int(idx[-1]) + 1 if len(idx) else 1


def host_window(grid: Grid, blk_lo: np.ndarray, blk_hi: np.ndarray, R: int, block_len: int,
                qpk: Optional[int] = None) -> SimpleNamespace:
    """The cut of this rank's flatten window, counted on the host from the
    numpy plan's (nb,) blk_lo / blk_hi: B, the blocks up to the last one a
    leaf reads (FULL or live); the sp span [b0, b0 + span) of those padded
    to a multiple of sp; the dp row window (rows, r0); and with ``qpk`` the
    window's row tiles (paged_flatten_attn.row_tile_tiles over its blocks,
    shifted as ``shift_window`` shifts them on the device), which B11's span
    rule takes.  Nothing is read from the device."""
    sp = grid.axis_size("sp")
    blk_lo, blk_hi = np.asarray(blk_lo), np.asarray(blk_hi)
    B = last_live((blk_lo < blk_hi) | (blk_lo < -(1 << 20)))
    B_pad = -(-B // sp) * sp
    span = B_pad // sp
    b0 = grid.index("sp") * span
    w = row_window(grid, "dp", R)
    rows, r0 = w.rows, w.r0
    win = SimpleNamespace(B=B, B_pad=B_pad, span=span, b0=b0, rows=rows, r0=r0,
                          row_tiles=None)
    if qpk is not None:
        def cut(x, value):
            return np.concatenate([x[:B], np.full(B_pad - B, value, x.dtype)])[b0:b0 + span]

        blo, bhi = shift_window(r0, rows, torch.from_numpy(cut(blk_lo, EMPTY_LO)),
                                torch.from_numpy(cut(blk_hi, 0)))
        win.row_tiles = row_tile_tiles(blo.numpy(), bhi.numpy(), rows * qpk, qpk, block_len)
    return win


def flatten_window(grid: Grid, batch, R: int, paged: bool,
                   qpk: Optional[int] = None) -> SimpleNamespace:
    """This rank's part of a flatten plan: its dp row window and its sp
    span of blocks, pads carrying empty intervals (deft_tpu
    engine.py:100-119).  sp splits the blocks up to the last one a leaf
    reads, so the plan's bucket padding at its end falls to no rank and
    every span holds a share of the live KV (deft_tpu splits the padded
    plan: its last spans may hold nothing live).  The cut is counted on the
    host (``host_window``) from the numpy plan's blk_lo / blk_hi, which the
    batch carries as ``blk_host`` (the runner's _step_batch puts them
    there), so nothing is read from the device.  Single-tree, multi-tree
    (plan/multi.py: each tree's leaf intervals shifted by its leaf offset)
    and node-aligned (node, node_chunk, tree_index) plans take the same
    cut: a dp window may start inside any tree's leaves.  Returns rows, r0,
    the span's arrays (seg_src or kv_idx, tok_lo, tok_hi, blk_lo, blk_hi)
    and, for a gather plan with ``qpk``, the window's row tiles
    (``row_tiles``; else None)."""
    block_len = batch.tok_lo.shape[0] // batch.blk_lo.shape[0]
    h = host_window(grid, *batch.blk_host, R, block_len, None if paged else qpk)
    B, B_pad, span, b0, rows, r0 = h.B, h.B_pad, h.span, h.b0, h.rows, h.r0

    def cut(x, per_block, value=0):
        """The span's part of x, per_block entries a block, past B padded."""
        return _pad_to(x[:B * per_block], B_pad * per_block, value)[
            b0 * per_block:(b0 + span) * per_block]

    blo, bhi = shift_window(r0, rows, cut(batch.blk_lo, 1, EMPTY_LO), cut(batch.blk_hi, 1))
    win = SimpleNamespace(
        rows=rows, r0=r0, block_len=block_len, row_tiles=h.row_tiles,
        tok_lo=cut(batch.tok_lo, block_len, EMPTY_LO) - r0,
        tok_hi=cut(batch.tok_hi, block_len) - r0,
        blk_lo=blo, blk_hi=bhi)
    if paged:
        nseg = batch.seg_src.shape[0] // batch.blk_lo.shape[0]
        win.seg_src = cut(batch.seg_src, nseg)
        win.seg_len = block_len // nseg
    else:
        win.kv_idx = cut(batch.kv_idx, block_len)
    return win


def lse_merge(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
              reduce: Callable) -> torch.Tensor:
    """The exact softmax from the ranks' unnormalised states (acc (..., D);
    m, l (...); m natural-log), deft_tpu engine.py:63-73: M = max m,
    corr = exp(m - M), o = sum(acc corr) / sum(l corr), 0 where the sum of
    l is 0.  ``reduce(t, op)`` all-reduces t in place over the ranks merged
    ("max" on m, then one "sum" over [l corr, acc corr] packed together).
    Returns o, fp32."""
    m_g = reduce(m.clone(), "max")
    corr = torch.exp(m - m_g)
    packed = reduce(torch.cat([(l * corr)[..., None], acc * corr[..., None]], dim=-1),
                    "sum")
    l_g = packed[..., :1]
    return packed[..., 1:] / torch.where(l_g == 0, torch.ones_like(l_g), l_g)


def sp_reduce(grid: Grid) -> Callable:
    return lambda t, op: grid.all_reduce(t, "sp", op)


def _cached(fn: Callable) -> Callable:
    """fn(batch, *args) computed once a step: the layers of one step share
    the batch, and the window of its plan."""
    last = {}

    def get(batch, *args):
        if last.get("batch") is not batch:
            last["batch"], last["win"] = batch, fn(batch, *args)
        return last["win"]
    return get


def make_sharded_tree_attn(grid: Grid, paged: bool):
    """AttnFn for flatten plans on the grid: q holds the rank's dp window of
    rows (batch.dp_rows); the rank's partial kernel over its window (B1p /
    B4p for paged plans, B11 otherwise), the LSE merge over sp; returns the
    window's rows.  B11 takes its window's row tiles, counted on the host
    (``host_window``), for its span rule; paged windows keep q_spans.
    Matches the single-device flatten AttnFns exactly
    (tests/test_torch_parallel.py)."""
    window = _cached(lambda batch, R, qpk: flatten_window(grid, batch, R, paged, qpk))

    def attn(q, k_new, v_new, k_pool, v_pool, li, batch, scale):
        w = window(batch, batch.dp_rows.n,
                   q.shape[1] // (k_pool.data.shape[-1] // q.shape[-1]))
        if paged and k_pool.quantized:
            acc, m, l = paged_flatten_attention_q_partial(
                q, k_pool.data, v_pool.data, k_pool.scale, v_pool.scale, li,
                w.seg_src, w.tok_lo, w.tok_hi, w.blk_lo, w.blk_hi, scale,
                w.block_len, w.seg_len)
        elif paged:
            acc, m, l = paged_flatten_attention_partial(
                q, k_pool.data, v_pool.data, li, w.seg_src, w.tok_lo, w.tok_hi,
                w.blk_lo, w.blk_hi, scale, w.block_len, w.seg_len)
        else:
            acc, m, l = flatten_attention_partial(
                q, k_pool.data, v_pool.data, li, w.kv_idx, w.tok_lo, w.tok_hi,
                w.blk_lo, w.blk_hi, scale, k_pool.scale, v_pool.scale,
                row_tiles=w.row_tiles)
        return unfold_rows(lse_merge(acc, m, l, sp_reduce(grid)), w.rows).to(q.dtype)

    return attn


class ShardedModel:
    """The model's collectives on a grid, which models/llama.py's forwards
    and the runner call where a rank holds a slice: ``reduce_tp`` after the
    row-parallel ``wo`` and ``wdown`` (summed in fp32, then cast),
    ``join_vocab`` for the vocab-sharded ``lm_head``, ``moe`` for a MoE
    layer (parallel/moe.py), ``prefill_rows`` for the rank's window of a
    prefill's tokens, and ``join_topk`` for a decode step's windows'
    top-K, after which every rank holds the same top-K of every row, so
    every rank branches the same way."""

    def __init__(self, grid: Grid):
        from deft_tpu_torch.parallel.moe import make_sharded_moe

        self.grid = grid
        self.moe = make_sharded_moe(grid)

    def prefill_rows(self, N: int) -> RowWindow:
        """The rank's window of a prefill's N tokens (sp)."""
        return row_window(self.grid, "sp", N)

    @staticmethod
    def join_topk(rows: RowWindow, vals: torch.Tensor, ids: torch.Tensor) -> tuple:
        """Every row's (vals fp32, ids int32) top-K from the windows' (rows,
        K) ones, in one int32 join: vals travel as their bits, and an
        integer sum of one value and zeros is that value."""
        K = vals.shape[-1]
        packed = rows.join(torch.cat([vals.float().contiguous().view(torch.int32),
                                      ids.to(torch.int32)], dim=-1))
        return packed[:, :K].contiguous().view(torch.float32), packed[:, K:]

    def reduce_tp(self, y: torch.Tensor) -> torch.Tensor:
        if self.grid.axis_size("tp") == 1:
            return y
        return self.grid.all_reduce(y.float(), "tp").to(y.dtype)

    def join_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """(rows, V/tp) column blocks -> (rows, V), in the logits' dtype."""
        tp = self.grid.axis_size("tp")
        if tp == 1:
            return logits
        width = logits.shape[-1]
        buf = torch.zeros(logits.shape[:-1] + (width * tp,), dtype=logits.dtype,
                          device=logits.device)
        c0 = self.grid.index("tp") * width
        buf[..., c0:c0 + width] = logits
        return self.grid.all_reduce(buf, "tp")
