"""Sharded sequential (per-leaf) baseline attention.

Port of deft_tpu/parallel/seq_engine.py:25-116.  The fair flatten-vs-seq
comparison holds under a grid too: each rank runs the paged seq kernel's
partial entry (B2p, or B5p over int8 pools) over its own sp span of every
leaf's path blocks — the per-leaf segment tables viewed (R, nb, spb), leaves
padded to a multiple of dp and the blocks up to the last live one to a
multiple of sp, the rank's dp
rows and sp block window taken — and the softmax is recovered with the
flatten path's LSE merge; q comes in, and o goes out, as the rank's dp
window of rows (batch.dp_rows).  Pads
carry blk_live = 0, so no read is issued for them, and no rank copies a
gathered path.  Seq plans that are not segment-aligned take B7 on the
rank's heads over its dp window of leaves (the runner cuts the paths and
seq_lens to it; replicated over sp; deft_tpu's mesh path runs XLA
attention there, runner.py:438-447): the runner's route for
unpaged seq modes (UNPAGED_FD) and for seq plans at head widths that do not
pack.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch.nn.functional as F

from deft_tpu_torch.ops.paged_seq_attn import (paged_seq_attention_partial,
                                               paged_seq_attention_q_partial)
from deft_tpu_torch.parallel.engine import _cached, last_live, lse_merge, sp_reduce
from deft_tpu_torch.parallel.mesh import Grid
from deft_tpu_torch.parallel.sharding import row_window


def seq_window(grid: Grid, batch, R: int) -> SimpleNamespace:
    """This rank's part of a paged seq plan: its dp rows and sp block
    window of the (R, nb, spb) segment tables, contiguous and flat.  As in
    flatten, sp splits the path blocks up to the last one a leaf reads,
    counted on the host from the numpy plan's blk_live, which the batch
    carries as ``live_host`` (the runner's _step_batch puts it there), so
    nothing is read from the device.  Multi-tree seq plans (plan/multi.py)
    are per-leaf tables too and take the same cut."""
    sp = grid.axis_size("sp")
    nb_all = batch.blk_live.shape[0] // R
    nb = last_live((np.asarray(batch.live_host).reshape(R, nb_all) > 0).any(axis=0))
    nb_pad = -(-nb // sp) * sp
    span = nb_pad // sp
    b0 = grid.index("sp") * span
    w = row_window(grid, "dp", R)
    R_pad, rows, r0 = w.n_pad, w.rows, w.r0

    def cut(x):
        x = x.view(R, nb_all, -1)[:, :nb]
        x = F.pad(x, (0, 0, 0, nb_pad - nb, 0, R_pad - R))
        return x[r0:r0 + rows, b0:b0 + span].contiguous().view(-1)

    return SimpleNamespace(rows=rows, r0=r0, seg_src=cut(batch.seg_src),
                           seg_off=cut(batch.seg_off), seg_live=cut(batch.seg_live),
                           blk_live=cut(batch.blk_live))


def make_sharded_seq_attn(grid: Grid):
    """AttnFn for paged seq plans on the grid (see the module docstring)."""
    window = _cached(lambda batch, R: seq_window(grid, batch, R))

    def attn(q, k_new, v_new, k_pool, v_pool, li, batch, scale):
        w = window(batch, batch.dp_rows.n)
        tables = (w.seg_src, w.seg_off, w.seg_live, w.blk_live)
        if k_pool.quantized:
            acc, m, l = paged_seq_attention_q_partial(
                q, k_pool.data, v_pool.data, k_pool.scale, v_pool.scale, li,
                *tables, scale, batch.seg_len)
        else:
            acc, m, l = paged_seq_attention_partial(
                q, k_pool.data, v_pool.data, li, *tables, scale, batch.seg_len)
        return lse_merge(acc, m, l, sp_reduce(grid)).to(q.dtype)

    return attn
