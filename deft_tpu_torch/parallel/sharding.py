"""Which slice of every parameter and KV pool a rank holds.

Port of deft_tpu/parallel/sharding.py:24-182.  deft_tpu places whole arrays
on its mesh with NamedShardings; here each rank keeps its own slice, cut by
the same specs (one entry an axis: None, "tp" or "sp"):

- ``wq/wk/wv/wg/wu`` column-parallel on the output axis (tp); ``wo`` and
  ``wdown`` row-parallel on the input axis (tp), their partial sums joined
  by an all-reduce over tp after the product (engine.ShardedModel);
- ``lm_head`` vocab-sharded (tp), its rows joined before the top-k; embed,
  norms (Qwen3's per-head ``ln_q``/``ln_k`` too) and the MoE router
  replicated;
- Qwen2's qkv biases follow their projections' output columns (tp);
- int8 per-output-column scales follow their weight's output axis; the
  row-parallel weights' scales span the whole input axis, so a rank keeps
  the whole scale vector beside its slice of the codes (a layer is
  quantised whole, then cut: a row slice is never quantised on its own);
- MoE expert stacks carry an extra expert axis after the layer axis, which
  shards over sp (expert parallelism) when sp divides the expert count
  (``_widen_for_experts``);
- KV pools (L, S, Hkv*D) shard their head-flattened axis over tp, with all
  slots on every sp and dp rank; int8 scale pools (L, Hkv, S) their head
  axis.

A step's batch (``batch_shardings``, deft_tpu sharding.py:121-162): a
decode step's query rows (leaves) over dp, a prefill's tokens over sp.  A
rank runs its ``RowWindow`` of them through every dense layer; the rows
padded to a multiple of the axis and cut into equal windows
(``row_window``); ``shard_decode_args`` cuts a step's numpy plan into a
rank's windows, as deft_tpu's places a batch with those specs.

The port keeps q/k/v and gate/up fused (``wqkv``, ``wgu``; models/llama.py)
where deft_tpu unfuses them before sharding (sharding.py:101-103): a fused
tensor is cut block by block, the q, k and v column blocks (g and u) each
cut over tp, so a rank's ``wqkv`` is [its q heads | its k heads | its v
heads], the columns deft_tpu's unfused shards hold.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from deft_tpu_torch.models.config import LlamaConfig
from deft_tpu_torch.models.llama import KVPool
from deft_tpu_torch.models.loader import generator_params, random_params
from deft_tpu_torch.parallel.mesh import Grid

Spec = Tuple[Optional[str], ...]


def param_shardings() -> Dict[str, Spec]:
    """name -> spec over the parameter's axes, stacked layer axis first,
    for every name the loader produces (dense, int8 and int8-pallas
    weights, MoE routers and expert stacks; expert stacks widened by
    _widen_for_experts), and deft_tpu's unfused names."""
    col, row, rep2, rep3 = (None, None, "tp"), (None, "tp", None), (None, None), \
        (None, None, None)
    specs: Dict[str, Spec] = {
        "embed": rep2, "ln1": rep2, "ln2": rep2, "ln_f": (None,),
        "ln_q": rep2, "ln_k": rep2,  # Qwen3 per-head norms (L, D)
        "wq": col, "wk": col, "wv": col, "wqkv": col,
        # Qwen2 biases (L, out): the output columns of their projection
        "bq": (None, "tp"), "bk": (None, "tp"), "bv": (None, "tp"),
        "bqkv": (None, "tp"),
        "wg": col, "wu": col, "wgu": col,
        "wo": row, "wdown": row,
        "lm_head": (None, "tp"),
        # Mixtral router (L, E, NE): tiny, replicated
        "wrt": rep3,
    }
    # weight-only int8 per-output-column scales, (L, out) or (V,), follow
    # their weight's output axis; row-parallel weights' outputs are whole
    for w in ("wq", "wk", "wv", "wqkv", "wg", "wu", "wgu"):
        for suf in ("_s", "_sp"):
            specs[w + suf] = (None, "tp")
    for w in ("wo", "wdown"):
        for suf in ("_s", "_sp"):
            specs[w + suf] = (None, None)
    specs["lm_head_s"] = specs["lm_head_sp"] = ("tp",)
    return specs


# Names whose tensors gain an expert axis under MoE configs.
_EXPERT_NAMES = frozenset(
    w + suf for w in ("wg", "wu", "wdown") for suf in ("", "_s", "_sp"))


def _widen_for_experts(grid: Grid, name: str, spec: Spec, shape) -> Spec:
    """MoE expert tensors carry an extra (num_experts) axis after the
    stacked-layer axis on top of the dense-MLP layout (deft_tpu
    sharding.py:79-94).  That axis shards over sp — expert parallelism —
    when sp divides the expert count, else it is replicated; tp keeps the
    Megatron cut of every expert's inner dims."""
    if name in _EXPERT_NAMES and len(shape) == len(spec) + 1:
        sp = grid.axis_size("sp")
        ep = "sp" if sp > 1 and shape[1] % sp == 0 else None
        return (spec[0], ep, *spec[1:])
    return spec


def fused_blocks(cfg: LlamaConfig) -> Dict[str, Tuple[int, ...]]:
    """Column blocks of the fused tensors, each cut over tp on its own:
    wqkv = [q | k | v], wgu = [g | u] (and their scales), and Qwen2's
    bqkv = [q | k | v] as wqkv."""
    D = cfg.head_dim
    qkv = (cfg.num_q_heads * D, cfg.num_kv_heads * D, cfg.num_kv_heads * D)
    gu = (cfg.intermediate_size,) * 2
    return {n + suf: b for n, b in (("wqkv", qkv), ("wgu", gu))
            for suf in ("", "_s", "_sp")} | {"bqkv": qkv}


def slice_tensor(grid: Grid, t: torch.Tensor, spec: Spec,
                 blocks: Optional[Sequence[int]] = None) -> torch.Tensor:
    """This rank's slice of ``t`` under ``spec``: along each named axis,
    chunk index(axis) of axis_size(axis) equal chunks, or of each of the
    ``blocks`` of the last axis in turn.  A contiguous copy."""
    if len(spec) != t.dim():
        raise ValueError(f"spec {spec} for a tensor of shape {tuple(t.shape)}")
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n, i = grid.axis_size(axis), grid.index(axis)
        parts = (t.split(list(blocks), dim=dim)
                 if blocks is not None and dim == t.dim() - 1 else (t,))
        cut = []
        for part in parts:
            size = part.shape[dim]
            if size % n:
                raise ValueError(f"axis {dim} of {size} does not split over {axis}={n}")
            cut.append(part.narrow(dim, i * (size // n), size // n))
        t = torch.cat(cut, dim=dim) if len(cut) > 1 else cut[0]
    return t.contiguous()


def _spec_of(grid: Grid, name: str, shape) -> Spec:
    specs = param_shardings()
    if name not in specs:
        raise KeyError(f"no sharding rule for parameter {name!r}")
    return _widen_for_experts(grid, name, specs[name], shape)


def shard_params(grid: Grid, params: Dict[str, torch.Tensor],
                 cfg: LlamaConfig) -> Dict[str, torch.Tensor]:
    """This rank's slices of a whole parameter dict (the loader's fused
    layout, bf16/fp32 or weight-only int8), on the grid's device."""
    blocks = fused_blocks(cfg)
    return {name: slice_tensor(grid, t, _spec_of(grid, name, t.shape),
                               blocks.get(name)).to(grid.device)
            for name, t in params.items()}


def random_shard_params(cfg: LlamaConfig, seed: int, grid: Grid, device,
                        dtype: torch.dtype,
                        weight_dtype: str = "inherit") -> Dict[str, torch.Tensor]:
    """This rank's slices of random_params(cfg, seed, device, dtype,
    weight_dtype): on a GPU the loader's CUDA draws replayed one layer at a
    time (loader.generator_params), each layer quantised whole before it is
    cut, so a rank holds its slice of the single-card weights with one
    layer's fp32 transient; on the CPU the numpy stream, sliced."""
    device = torch.device(device)
    if device.type == "cpu":
        return shard_params(grid, random_params(cfg, seed, device, dtype,
                                                weight_dtype), cfg)
    blocks = fused_blocks(cfg)

    def keep(name, x, stacked):
        spec = _spec_of(grid, name, ((0,) if stacked else ()) + tuple(x.shape))
        return slice_tensor(grid, x, spec[1:] if stacked else spec, blocks.get(name))

    return generator_params(cfg, seed, device, dtype, weight_dtype, keep)


def pool_specs() -> Dict[str, Spec]:
    """KV pool data (L, S, Hkv*D) and int8 scales (L, Hkv, S): heads over
    tp, every slot on every rank."""
    return {"data": (None, None, "tp"), "scale": (None, "tp", None)}


def shard_pool(grid: Grid, pool: KVPool) -> KVPool:
    """This rank's slice of a whole KV pool."""
    specs = pool_specs()
    return KVPool(slice_tensor(grid, pool.data, specs["data"]).to(grid.device),
                  None if pool.scale is None else
                  slice_tensor(grid, pool.scale, specs["scale"]).to(grid.device))


@dataclasses.dataclass(frozen=True)
class RowWindow:
    """This rank's window of a step's ``n`` rows over grid ``axis``: the rows
    padded to ``n_pad``, a multiple of the axis size, and cut into equal
    windows of ``rows``, this rank's starting at ``r0``."""

    grid: Grid
    axis: str
    n: int
    n_pad: int
    rows: int
    r0: int

    @property
    def size(self) -> int:
        return self.grid.axis_size(self.axis)

    def take(self, x):
        """Rows [r0, r0 + rows) of x (a tensor or a numpy array over the n
        rows), zero rows past its end."""
        part = x[self.r0:self.r0 + self.rows]
        if part.shape[0] == self.rows:
            return part
        if isinstance(x, np.ndarray):
            out = np.zeros((self.rows,) + x.shape[1:], x.dtype)
            out[:len(part)] = part
            return out
        pad = torch.zeros((self.rows - part.shape[0],) + x.shape[1:], dtype=x.dtype,
                          device=x.device)
        return torch.cat([part, pad])

    def join(self, x: torch.Tensor) -> torch.Tensor:
        """The n rows from every rank's window x (rows, ...): each rank writes
        its window into a zero buffer of n_pad rows, summed over the axis
        (exact: one term of each sum is not zero); the pad rows dropped."""
        if self.size == 1:
            return x[:self.n]
        buf = torch.zeros((self.n_pad,) + x.shape[1:], dtype=x.dtype, device=x.device)
        buf[self.r0:self.r0 + self.rows] = x
        return self.grid.all_reduce(buf, self.axis)[:self.n]

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the axis (a value one window holds, zeros on the
        others)."""
        return self.grid.all_reduce(x, self.axis)


def row_window(grid: Grid, axis: str, n: int) -> RowWindow:
    """This rank's window of n rows over ``axis``."""
    size = grid.axis_size(axis)
    rows = -(-n // size)
    return RowWindow(grid, axis, n, rows * size, rows, grid.index(axis) * rows)


def batch_shardings(kind: str) -> Dict[str, Spec]:
    """deft_tpu's specs of a step's batch, by its kind (sharding.py:121-162):
    a decode step's query rows on dp and its flatten plan's tokens on sp
    ("DecodeBatch"), a seq plan's leaves on dp and their paths on (dp, sp)
    ("SeqBatch"), a prefill's tokens on sp ("PrefillBatch"); the paged
    segment tables replicated.  A RaggedPrefillBatch has none (TypeError),
    so the batched prefill runs every token on every rank.

    How the port lays them out: ``shard_decode_args`` and the runner cut
    the dp and sp row arrays into the rank's windows; every rank keeps
    ``out_loc`` whole as well, since the pools hold every slot on every
    rank and the K/V rows of all windows are joined before the store (the
    gather GSPMD puts before deft_tpu's scatter); the sp cut of a plan's
    tokens and blocks is taken inside the grid's AttnFns
    (parallel/engine.py, seq_engine.py), which count their spans on the
    host; B7's paths (a seq plan that is not segment-aligned) keep every
    block on every sp rank."""
    dp, sp, rep = ("dp",), ("sp",), (None,)
    if kind == "DecodeBatch":
        return {"q_tokens": dp, "q_pos": dp, "out_loc": dp, "kv_idx": sp, "tok_lo": sp,
                "tok_hi": sp, "blk_lo": rep, "blk_hi": rep, "seg_src": rep}
    if kind == "SeqBatch":
        return {"q_tokens": dp, "q_pos": dp, "out_loc": dp, "paths": ("dp", "sp"),
                "seq_lens": dp, "seg_src": rep, "seg_off": rep, "seg_live": rep,
                "blk_live": rep}
    if kind == "PrefillBatch":
        return {"tokens": sp, "positions": sp, "out_loc": sp, "length": ()}
    raise TypeError(kind)


# the per-row arrays of a decode step that a rank holds as its dp window of
# the rows (B7's paths and seq_lens among them, and a chain's q_select)
DP_ROWS = ("q_tokens", "q_pos", "q_rows", "q_cols", "paths", "seq_lens")


def shard_batch(grid: Grid, parts: Dict[str, np.ndarray], n: int
                ) -> Tuple[Dict[str, np.ndarray], RowWindow]:
    """A decode step's numpy plan arrays over n rows cut to this rank: the
    ``DP_ROWS`` arrays to its dp window of the rows, zero rows past n (their
    K/V rows are dropped at the join, and no row reads them); every other
    array whole.  Returns the parts and the window."""
    rows = row_window(grid, "dp", n)
    return {k: rows.take(np.asarray(v)) if k in DP_ROWS else v
            for k, v in parts.items()}, rows


def shard_decode_args(grid: Grid, params: Dict[str, torch.Tensor], k_pool: KVPool,
                      v_pool: KVPool, parts: Dict[str, np.ndarray], cfg: LlamaConfig,
                      n: int):
    """Place (params, pools, batch) on this rank (deft_tpu sharding.py:
    175-182): the rank's slices of the whole params and pools, and its
    windows of a decode step's n-row numpy plan arrays (``shard_batch``).
    Returns (params, k_pool, v_pool, parts, rows)."""
    return (shard_params(grid, params, cfg), shard_pool(grid, k_pool),
            shard_pool(grid, v_pool), *shard_batch(grid, parts, n))
