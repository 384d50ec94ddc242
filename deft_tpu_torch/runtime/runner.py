"""Model runner: owns the device state (params, KV pools) and runs the
prefill and tree-decode steps.

Port of deft_tpu/runtime/runner.py: LogitsView (:66),
the constructor (:194, a local checkpoint or random weights :223-239, int8
KV pools :273-279, the tree-index pool :293-299), pool sizing (:382, here from
``torch.cuda.mem_get_info``), the kernel choice (_attn_fn :418-477),
forward_prefill (:1125), forward_prefill_batch (:1154), build_plan
(:1205-1273: flatten, node, node_chunk and tree_index plans, seq plans
asking for the paged layout where the head width allows it, and the int8
segment rules), _use_paged (:1275) and
forward_tree_decode (:2004; logits kinds "topk", "greedy" and "skip"; q
tokens from the plan, from a previous step's greedy ids or gathered from
its top-K, and ``block=False`` to enqueue without waiting), which takes
single-tree and multi-tree plans (plan/multi.py) alike, after draining the
tree's queued merge copies (apply_kv_copies :1727); MoE layers take the
grouped-matmul route wherever the token count allows it (deft_tpu's
single-chip dispatch, :302-317; models/llama.py's _moe_gmm_ok).  PyTorch
runs eagerly, so there are no jitted steps: a step runs the forward on
torch's current stream from one packed int32 plan buffer on the device.

Plan uploads, as deft_tpu makes them:

- ``_pack_plan`` (:1745-1795) packs a plan into one buffer; a paged
  flatten-family plan goes in the compact form (DEFT_COMPACT_PLAN, on by
  default): a header, its query arrays and its run table, whose per-token
  arrays ``expand_compact`` re-expands on the device with plain torch ops.
  ``_unpack`` (deft_tpu's _make_unpack :502-659) turns a buffer on the
  device into the AttnFn batch, with the host's row tiles, block bounds
  and live blocks (``_plan_meta``) beside it, so no wrapper reads the
  device;
- ``_upload_plan`` (:1801-1860; DEFT_PLAN_PATCH, on by default) keeps the
  last buffer of each kind and length on the device and ships only its
  changed 128-int chunks, ids and data in one pinned copy; counted in
  ``plan_upload_bytes`` against ``plan_full_bytes`` (and ``plan_copies``);
- ``build_plan``'s monotone bucket floors (:1214-1216) and the run-table
  pad's floor (:1766-1768) keep a span in one signature.

Two multi-step paths on one device (both off on a grid): the decode
window (``forward_tree_decode_window``, :875-1036; WindowLogits :144): up
to 8 greedy steps of one bucket from one upload of their chunk patches,
enqueued back to back with no host read; and the replay executor
(``execute_recorded``, :1322-1725): a recorded span's buffers uploaded as
slabs, one stream a buffer length in chunks of up to SLAB_M rows, run as
windows of up to WK sub-steps of uniform greedy, skip and top-K-select
runs and single slab steps, KV relocations applied before each sub-step,
outputs copied to the host in stacked chunks and a host wait every
DEFT_REPLAY_DRAIN (256) sub-steps.  deft_tpu's scans over a device counter
become Python loops over slab rows here; a loop needs no fixed trip
count, so a short window runs its live sub-steps only, where deft_tpu's
scan pads it to WK with DUMP_SLOT rows.

The host waits for the device only where it means to: a step run with
``block=True``, and the first read of a LogitsView's values (``host_wait``,
which counts them).  Nothing else on the decode step synchronises, so the
generation loop (runtime/generate.py) can build the next plan while the
device runs the step before it.

Every plan runs through a kernel: segment-aligned (paged) plans through the
paged kernels, the others through the gather kernels, over bf16/fp32 or
int8 pools (ops/attn_impls.py's table); node and tree_index plans are
flatten plans with node-aligned blocks and take the flatten kernels.  The
one exception is deft_tpu's: UNPAGED_MEDUSA is the dense masked-attention
baseline, plain attention over the plan's kv_idx in both packages
(deft_tpu runner.py:448-453, its _use_paged excludes the mode at :1293).

``measure_attention`` (deft_tpu runner.py:365-379, :1895-2002): before a
decode step, outside its timed span, the runner times the step's AttnFn
and its KV stores alone, once per shape bucket, and keeps the estimate in
``last_attn_estimate``; tree_generate charges it to the step's
``attn_mem`` / ``attn_comp``.  On a GPU the estimate is device time (CUDA
events, a sleep kernel keeping the queue ahead of the device), on the CPU
host time.

``ModelRunner(mesh=grid)`` (deft_tpu runner.py:206-317, :420-447, :482) runs
one rank of a (dp, sp, tp) grid (parallel/): the params and pools are the
rank's slices, made once.  A step is laid out as deft_tpu's batch specs
state (parallel/sharding.py ``batch_shardings``): a decode step's rows
over dp, the rank running its window of them through every layer (its q
tokens and positions, cut on the host in ``_step_batch``, or on the
device from a chain's ids), the windows' top-K joined over dp in
``_logits_view``; a prefill's tokens over sp (models/llama.py
``prefill_forward``).  Decode attention takes the sharded AttnFns of
parallel/engine.py and parallel/seq_engine.py (B1p, B4p, B11; B2p, B5p; B7
on the rank's heads and rows for seq plans that are not segment-aligned;
Medusa's dense baseline on the rank's heads and rows), prefill B3 on the
rank's heads over every token, and batched prefill B8 on the rank's heads,
every token on every rank (deft_tpu has no spec for a ragged batch), and
the forwards take the grid's collectives (ShardedModel).  Every decode mode
runs on a grid, and so does the batched engine.  A grid of size 1 counts
as no mesh.
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys
import time
from types import SimpleNamespace
from typing import Dict, Optional

import numpy as np
import torch

from deft_tpu_torch.config import EngineConfig
from deft_tpu_torch.core import (ReqToTokenPool, TokenKVPool, TreeCache,
                                 TreeIndexPool)
from deft_tpu_torch.core.kv_pool import DUMP_SLOT
from deft_tpu_torch.models.config import LlamaConfig
from deft_tpu_torch.models.llama import (KVPool, RaggedPrefillBatch,
                                         decode_forward, kv_store,
                                         prefill_forward,
                                         ragged_prefill_forward)
from deft_tpu_torch.models.loader import load_params, random_params
from deft_tpu_torch.models.rope import rope_table
from deft_tpu_torch.obs import create_logger
from deft_tpu_torch.obs.timers import sync_check_lowered
from deft_tpu_torch.ops import attn_impls
from deft_tpu_torch.ops.paged_flatten_attn import row_tile_tiles
from deft_tpu_torch.plan import (build_flatten_plan, build_node_plan,
                                 build_seq_plan, build_tree_index_plan, next_pow2)
from deft_tpu_torch.plan.flatten import _EMPTY_LO, FULL_BLOCK_LO, FlattenPlan
from deft_tpu_torch.plan.seq import SeqPlan
from deft_tpu_torch.runtime.modes import ForwardMode

logger = create_logger("deft_tpu_torch.runner")


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; raises when CUDA is asked for and absent —
    the port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for but no GPU is "
                           "available (pass device='cpu' to run on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def topk_lowest_index(probs: torch.Tensor, k: int) -> tuple:
    """Top-k of each row of (R, V) fp32 ``probs`` with ties lowest index
    first, the order of ``jax.lax.top_k`` (and of ``max``), which
    ``torch.topk`` does not keep.  Exact, and on the device with no host
    read: each entry's int64 key holds its value's order-preserving int32
    image (the bits of a non-negative float; a negative one's with its
    magnitude bits flipped) in the high half and 2**31 - 1 - index in the
    low half, so the largest keys are the largest values, ties lowest index
    first.  One topk of the keys, then the values gathered."""
    bits = probs.float().contiguous().view(torch.int32)
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    low = (1 << 31) - 1 - torch.arange(probs.shape[-1], device=probs.device)
    keys = (bits.to(torch.int64) << 32) | low
    ids = low[0] - (torch.topk(keys, k, dim=-1).values & 0xFFFFFFFF)
    return probs.gather(-1, ids), ids


def host_wait(event: Optional[torch.cuda.Event]) -> None:
    """Every deliberate host wait of the decode path goes through here: it
    counts them (``host_wait.waits``, as the ops wrappers count launches)
    and waits for ``event`` (None: a CPU copy, landed already) with torch's
    sync debug mode lowered, so that a run under
    ``torch.cuda.set_sync_debug_mode("error")`` fails on any other wait."""
    host_wait.waits += 1
    if event is None:
        return
    with sync_check_lowered():
        event.synchronize()


host_wait.waits = 0


def bench_wait(event: torch.cuda.Event) -> None:
    """The attention microbench's wait for its last event, once a shape
    bucket: like host_wait, with torch's sync debug mode lowered, but
    counted apart (``bench_wait.waits``), so that ``host_wait.waits`` keeps
    counting the decode path's own waits."""
    bench_wait.waits += 1
    with sync_check_lowered():
        event.synchronize()


bench_wait.waits = 0

# the microbench's rep counts (deft_tpu runner.py:1939): a quantity's cost
# a step is (t(REPS_HI) - t(REPS_LO)) / (REPS_HI - REPS_LO), each t the best
# of two, so the constant cost of a timed call cancels
REPS_LO, REPS_HI = 4, 36
# clock cycles a second that the sleep kernel ahead of a timed rep assumes:
# the H100's 1.98 GHz boost clock rounded up (a slower clock sleeps longer)
SLEEP_HZ = 2e9
# the longest sleep ahead of one rep (0.1 s): a rep whose enqueueing
# outlasts it is timed as it is
MAX_SLEEP_CYCLES = int(0.1 * SLEEP_HZ)


def rep_seconds(quantities, device: torch.device, retry: bool = True) -> list:
    """Seconds that one call of each function in ``quantities`` (one decode
    step's worth of a quantity) costs, by deft_tpu's two-point difference,
    after REPS_LO calls of each to warm up.  On the CPU each rep count is
    timed on the host clock, as deft_tpu times it there.  On a GPU every
    rep is timed alone by CUDA events behind a sleep kernel twice as long
    as the host's quickest enqueueing of a rep so far, so that the device
    finds the whole rep queued when it starts it, and the events time its
    work and not the host's launch pace (an eager 8B step leaves the
    device idle most of the time).  A rep whose start event had passed
    before the host finished enqueueing it is timed again, and every later
    rep sleeps twice as long; ``retry=False`` (a grid's ranks, whose
    collectives need the same calls on every rank) times it as it is.
    The host waits once, for the last event (bench_wait)."""
    counts = (REPS_LO, REPS_LO, REPS_HI, REPS_HI)
    quickest = []  # per quantity: the host's quickest enqueueing of a rep
    for run_rep in quantities:  # warm-up, as deft_tpu's compile call
        best = float("inf")
        for _ in range(REPS_LO):
            t0 = time.perf_counter()
            run_rep()
            best = min(best, time.perf_counter() - t0)
        quickest.append(best)
    if device.type != "cuda":
        totals = []
        for run_rep in quantities:
            t = []
            for n in counts:
                t0 = time.perf_counter()
                for _ in range(n):
                    run_rep()
                t.append(time.perf_counter() - t0)
            totals.append(t)
    else:
        events = []  # per quantity and count: its reps' (start, end) events
        for run_rep, best in zip(quantities, quickest):
            boost = 2.0
            for n in counts:
                reps = []
                while len(reps) < n:
                    cycles = min(int(boost * best * SLEEP_HZ) + 1, MAX_SLEEP_CYCLES)
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    torch.cuda._sleep(cycles)
                    start.record()
                    t0 = time.perf_counter()
                    run_rep()
                    best = min(best, time.perf_counter() - t0)
                    end.record()
                    if retry and start.query() and cycles < MAX_SLEEP_CYCLES:
                        boost *= 2  # the device caught up: time it again
                        continue
                    reps.append((start, end))
                events.append(reps)
        bench_wait(events[-1][-1][1])
        with sync_check_lowered():
            ms = [sum(a.elapsed_time(b) for a, b in reps) for reps in events]
        totals = [[x / 1e3 for x in ms[i:i + len(counts)]]
                  for i in range(0, len(ms), len(counts))]
    return [max(min(t[2], t[3]) - min(t[0], t[1]), 0.0) / (REPS_HI - REPS_LO)
            for t in totals]


def plan_sizes(plan, paged: bool, r_pad: int = 0) -> tuple:
    """The shape of a step's packed plan buffer, as deft_tpu's _pack_plan
    gives it (runner.py:1745-1795): the attention microbench's bucket key,
    with the plan kind and the layout.  ``r_pad``, the padded run-table
    length of a compact plan, gives the compact form (l_pad, t_pad,
    num_blocks, r_pad, seg_len); 0 the full form."""
    if isinstance(plan, SeqPlan):
        if paged:
            nb = len(plan.blk_live) // plan.l_pad
            return (plan.l_pad, len(plan.seg_src) // plan.l_pad, nb,
                    plan.c_pad // nb, plan.seg_len)
        return (plan.l_pad, plan.c_pad)
    if r_pad:
        return (plan.l_pad, plan.t_pad, plan.num_blocks, r_pad, plan.seg_len)
    tail = plan.seg_src if paged else plan.kv_idx
    return (plan.l_pad, plan.t_pad, plan.num_blocks, len(tail))


def env_on(name: str) -> bool:
    """deft_tpu's reading of its on/off switches: on unless the variable
    is set to something other than "1"."""
    return os.environ.get(name, "1") == "1"


# the chunk of a plan patch, 128 int32 (deft_tpu runner.py:1796-1799): an
# append step changes O(leaves) chunks of an O(tokens) buffer
PATCH_CHUNK = 128
# the replay executor's slab chunk rows and most sub-steps a window
# (deft_tpu runner.py:1363, :1372)
SLAB_M = 1024
WK = 32


def plan_fields(kind: str, sizes: tuple, paged: bool, select: bool) -> list:
    """(name, length) of each array of a packed plan buffer, in order
    (deft_tpu runner.py:502-659): the plan kind ("seq" or a flatten-family
    kind) and the sizes tell the layout; ``select`` appends the rows and
    columns of a q_select gather."""
    L = sizes[0]
    if kind == "seq" and len(sizes) == 5:
        _, nseg, nb, _, _ = sizes
        fields = [("q_tokens", L), ("q_pos", L), ("out_loc", L), ("seq_lens", L),
                  ("seg_src", L * nseg), ("seg_off", L * nseg),
                  ("seg_live", L * nseg), ("blk_live", L * nb)]
    elif kind == "seq":
        fields = [("q_tokens", L), ("q_pos", L), ("out_loc", L), ("seq_lens", L),
                  ("paths", L * sizes[1])]
    elif len(sizes) == 5:
        R = sizes[3]
        fields = [("hdr", 2), ("q_tokens", L), ("q_pos", L), ("out_loc", L),
                  ("run_off", R), ("run_src", R), ("run_lo", R), ("run_hi", R)]
    else:
        _, T, B, tail = sizes
        fields = [("q_tokens", L), ("q_pos", L), ("out_loc", L), ("tok_lo", T),
                  ("tok_hi", T), ("blk_lo", B), ("blk_hi", B),
                  ("seg_src" if paged else "kv_idx", tail)]
    if select:
        fields += [("q_rows", L), ("q_cols", L)]
    return fields


def expand_compact(f: Dict[str, torch.Tensor], sizes: tuple) -> dict:
    """A compact plan's per-token arrays, re-expanded on the device from
    its header and run table (deft_tpu runner.py:569-635): each token takes
    the last run whose offset it has reached (``torch.searchsorted`` and
    gathers, where deft_tpu builds a one-hot product for its TPU), tokens
    past the live layout the bucket tail's empty intervals, seg_src each
    segment's first row, and the blocks' bounds and FULL sentinel from the
    intervals.  Exact, and no host read: the header stays on the device."""
    L, T, B, R, seg_len = sizes
    n_live, n_leaves = f["hdr"][0], f["hdr"][1]
    off = f["run_off"]
    idx = torch.arange(T, dtype=torch.int32, device=off.device)
    r = torch.searchsorted(off, idx, right=True) - 1
    covered = r >= 0
    r = r.clamp_min(0)
    tok_lo = torch.where(covered, f["run_lo"][r], 0)
    tok_hi = torch.where(covered, f["run_hi"][r], 0)
    addr = torch.where(covered, f["run_src"][r] + (idx - off[r]), idx)
    tail = idx >= n_live
    tok_lo = torch.where(tail, int(_EMPTY_LO), tok_lo)
    tok_hi = torch.where(tail, 0, tok_hi)
    addr = torch.where(tail, idx % seg_len, addr)
    tl2, th2 = tok_lo.view(B, T // B), tok_hi.view(B, T // B)
    full = (tl2 == 0).all(dim=1) & (th2 == n_leaves).all(dim=1) & (n_leaves > 0)
    return {"tok_lo": tok_lo, "tok_hi": tok_hi,
            "blk_lo": torch.where(full, int(FULL_BLOCK_LO), tl2.amin(dim=1)),
            "blk_hi": th2.amax(dim=1),
            "seg_src": addr.view(-1, seg_len)[:, 0].contiguous()}


class CopyOrder:
    """The device-to-host copies of a runner's LogitsViews, numbered in the
    order they were enqueued on its stream: once the host has waited for
    copy n, every copy before it has landed too."""

    def __init__(self):
        self.enqueued = 0
        self.landed = 0


def packs_heads(head_dim: int) -> bool:
    """deft_tpu's gate of its paged kernels (runner.py:1262-1295): a head's
    row packs into 128 lanes (128 % head_dim == 0).  Other widths (Phi-3's
    96, Gemma's 256) take gather plans and the gather kernels B6 and B7 in
    both packages, so the port builds deft_tpu's plans at every width."""
    return 128 % head_dim == 0


class LogitsView:
    """Per-leaf next-token distribution; row order == DFS leaf_to_q
    (deft_tpu runner.py:66).  The top-K stays on the step's device
    (``_vals`` probabilities, softmax + 1e-6, descending; ``_ids`` int32)
    until it is read: ``fetch_async`` enqueues one copy of both, packed
    (``pack_top``, deft_tpu's packed view), into pinned host memory behind
    the step (a HostCopy in the runner's ``CopyOrder``), and the first read
    of ``vals`` or ``ids`` waits for it (``host_wait``) unless a wait for a
    later copy has seen it land.  ``greedy_ids_device`` and ``ids_device``
    feed a next step's q tokens on the device (runtime/generate.py's
    chains) with no read at all.  On the CPU the same code runs with plain
    copies; numpy arrays are taken as they are."""

    def __init__(self, vals, ids, full: Optional[torch.Tensor] = None,
                 order: Optional[CopyOrder] = None):
        self._vals = vals  # (R, K) probabilities, a tensor or numpy
        self._ids = ids    # (R, K) int32 token ids
        self._full = full  # optional (R, V) fp32 logits
        self._order = order if order is not None else CopyOrder()
        self._copy = None  # the HostCopy of pack_top(vals, ids)
        self._host = None  # (vals, ids) numpy, once landed

    def fetch_async(self) -> None:
        """Enqueue the copy of the top-K to the host (once)."""
        if self._copy is None and not isinstance(self._vals, np.ndarray):
            self._copy = HostCopy(pack_top(self._vals, self._ids), self._order)

    def wait(self) -> None:
        """Return once the host copy has landed (a counted host_wait, unless
        a wait for this or a later copy has passed already)."""
        if isinstance(self._vals, np.ndarray):
            return
        self.fetch_async()
        self._copy.wait()

    def _landed(self) -> tuple:
        if self._host is None:
            if isinstance(self._vals, np.ndarray):
                self._host = (self._vals, self._ids)
            else:
                self.fetch_async()
                packed = self._copy.array
                k = packed.shape[-1] // 2
                self._host = (packed[:, k:].view(np.float32), packed[:, :k])
        return self._host

    @property
    def vals(self) -> np.ndarray:
        return self._landed()[0]

    @property
    def ids(self) -> np.ndarray:
        return self._landed()[1]

    @property
    def greedy_ids_device(self) -> torch.Tensor:
        """(R,) top-1 ids on the device: the next step's q tokens when the
        rows keep their order (a greedy chain)."""
        return self._ids[:, 0]

    @property
    def ids_device(self) -> torch.Tensor:
        """(R, K) top-K ids on the device: the next step gathers its q
        tokens from them (forward_tree_decode's q_select)."""
        return self._ids

    @property
    def k(self) -> int:
        return self._vals.shape[-1]

    def topk(self, row: int, k: int):
        """Top-k (probs, token_ids) for one leaf row."""
        assert k <= self.k, f"asked top-{k}, step computed top-{self.k}"
        return self.vals[row, :k], self.ids[row, :k]

    def argmax(self):
        """(token_ids, probs) of the greedy token per row."""
        return self.ids[:, 0], self.vals[:, 0]

    def full_logits(self) -> torch.Tensor:
        assert self._full is not None, "full logits not retained"
        return self._full


def pack_top(vals: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(R, k) top-k as one (R, 2k) int32 tensor [ids | bits of the fp32
    probabilities] (deft_tpu's packed view, runner.py:745-748), so a run
    of steps' outputs stacks into one copy to the host."""
    return torch.cat([ids.to(torch.int32), vals.float().view(torch.int32)], dim=-1)


class HostCopy:
    """One device tensor's copy into pinned host memory, enqueued on
    torch's current stream when it is made and numbered in ``order``;
    ``array`` waits for it (a counted host_wait) unless a wait for this or
    a later copy of the same order has seen it land."""

    def __init__(self, t: torch.Tensor, order: CopyOrder):
        cuda = t.device.type == "cuda"
        self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=cuda)
        self._host.copy_(t, non_blocking=cuda)
        self._event = None
        if cuda:
            self._event = torch.cuda.Event()
            self._event.record()
        order.enqueued += 1
        self._n, self._order = order.enqueued, order

    def wait(self) -> None:
        if self._n > self._order.landed:
            host_wait(self._event)
            self._order.landed = self._n

    @functools.cached_property
    def array(self) -> np.ndarray:
        self.wait()
        return self._host.numpy()


class WindowLogits:
    """A decode window's greedy results (deft_tpu runner.py:144): each
    sub-step's (R, 1) ids and probabilities packed as one (W, R, 2) device
    tensor, copied to the host in one copy, and the last sub-step's (R,)
    ids on the device for the next step's chain."""

    def __init__(self, packed: torch.Tensor, last_ids: torch.Tensor,
                 order: CopyOrder):
        self._packed, self._last_ids, self._order = packed, last_ids, order
        self._copy = None

    def fetch_async(self) -> None:
        if self._copy is None:
            self._copy = HostCopy(self._packed, self._order)

    def wait(self) -> None:
        self.fetch_async()
        self._copy.wait()

    @property
    def _host(self) -> np.ndarray:
        self.fetch_async()
        return self._copy.array

    @property
    def greedy_ids_device(self) -> torch.Tensor:
        return self._last_ids

    def step_view(self, j: int) -> "ChunkStepView":
        return ChunkStepView(self, j, 1)


class ChunkStepView:
    """The LogitsView-like reader (``ids``, ``vals``, ``k``) of row j of a
    stacked (n, R, 2k) packed output: a window's sub-step (deft_tpu
    WindowStepView :174) or a replayed step (its _ChunkStepView :1547);
    ``chunk`` is a WindowLogits or a HostCopy, whose copy the first read
    waits for."""

    def __init__(self, chunk, j: int, k: int):
        self._chunk, self._j, self.k = chunk, j, k

    def _row(self) -> np.ndarray:
        host = (self._chunk._host if isinstance(self._chunk, WindowLogits)
                else self._chunk.array)
        return host[self._j]

    @property
    def ids(self) -> np.ndarray:
        return self._row()[:, :self.k]

    @property
    def vals(self) -> np.ndarray:
        return self._row()[:, self.k:].view(np.float32)


class ChainView:
    """Where the step after a replayed span takes its q tokens: a window's
    last greedy ids (``greedy_ids_device``) or its last top-``wtop`` ids
    (``ids_device``), on the device.  The executor drained the span before
    it returned, so ``wait`` has nothing left to wait for."""

    def __init__(self, greedy_ids_device=None, ids_device=None):
        self.greedy_ids_device, self.ids_device = greedy_ids_device, ids_device
        self.k = 0 if ids_device is None else ids_device.shape[-1]

    def wait(self) -> None:
        pass


class ModelRunner:
    def __init__(
        self,
        model_config: LlamaConfig,
        engine_config: EngineConfig = EngineConfig(),
        device="cuda",
        params: Optional[Dict[str, torch.Tensor]] = None,
        model_path: Optional[str] = None,
        seed: int = 0,
        topk_k: int = 64,
        retain_full_logits: bool = False,
        mesh=None,
        use_tree_index: bool = False,
        measure_attention: Optional[bool] = None,
    ):
        """``params``: the port's parameter dict; else ``model_path``: a
        local HF checkpoint (models/loader.py load_params); else random
        weights from ``seed``.  ``measure_attention``: time each shape
        bucket's attention (see the module's notes); None is on for a GPU
        and off on the CPU, as deft_tpu is on for its TPU only, and off on
        a grid whose collectives gloo stages through the host (several
        ranks on one card), where the reps would time the staging."""
        self.cfg = model_config
        self.ecfg = engine_config
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.device = resolve_device(device if self.mesh is None else mesh.device)
        self.topk_k = min(topk_k, model_config.vocab_size)
        self.retain_full_logits = retain_full_logits
        self._copies = CopyOrder()  # the order of its views' host copies
        self.dtype = (torch.bfloat16 if engine_config.dtype == "bfloat16"
                      else torch.float32)
        self._tp = tp = 1 if self.mesh is None else self.mesh.axis_size("tp")
        if model_config.num_kv_heads % tp:
            raise ValueError(f"tp={tp} must divide the {model_config.num_kv_heads} "
                             "KV heads")
        self._shard = None
        if self.mesh is not None:
            from deft_tpu_torch.parallel.engine import ShardedModel
            from deft_tpu_torch.parallel.sharding import (random_shard_params,
                                                          shard_params)

            self._shard = ShardedModel(self.mesh)
            if params is None and model_path is not None:
                params = shard_params(self.mesh, load_params(
                    model_path, model_config, "cpu", self.dtype,
                    engine_config.weight_dtype), model_config)
            elif params is None:
                params = random_shard_params(model_config, seed, self.mesh,
                                             self.device, self.dtype,
                                             engine_config.weight_dtype)
            else:
                params = shard_params(self.mesh, params, model_config)
        elif params is None and model_path is not None:
            logger.info("loading weights from %s (weights=%s)", model_path,
                        engine_config.weight_dtype)
            params = load_params(model_path, model_config, self.device,
                                 self.dtype, engine_config.weight_dtype)
        elif params is None:
            logger.info("random-init params (seed=%d, weights=%s)", seed,
                        engine_config.weight_dtype)
            params = random_params(model_config, seed, self.device, self.dtype,
                                   engine_config.weight_dtype)
        self.params = params

        max_pos = min(self.cfg.context_len, engine_config.max_context_len)
        self._rope_tbl = torch.from_numpy(rope_table(
            self.cfg.head_dim, max_pos, self.cfg.rope_theta,
            self.cfg.rope_scaling,
            orig_max_pos=self.cfg.max_position_embeddings)).to(self.device)

        self.kv_quantized = engine_config.kv_dtype == "int8"
        slots = engine_config.kv_pool_slots or self._profile_slots()
        logger.info("KV pool: %d slots (%.1f MB per side)", slots,
                    slots * self._kv_cell_bytes() / 2 / 1e6)
        # a rank's pools hold its tp heads, every slot (deft_tpu
        # P(None, None, "tp"))
        L, D = self.cfg.num_layers, self.cfg.head_dim
        Hkv = self.cfg.num_kv_heads // tp
        shape = (L, slots, Hkv * D)
        if self.kv_quantized:
            # scales start at ones, so a slot never written dequantises to 0
            self.k_pool, self.v_pool = (
                KVPool(torch.zeros(shape, dtype=torch.int8, device=self.device),
                       torch.ones((L, Hkv, slots), dtype=torch.float32,
                                  device=self.device))
                for _ in range(2))
        else:
            self.k_pool, self.v_pool = (
                KVPool(torch.zeros(shape, dtype=self.dtype, device=self.device))
                for _ in range(2))

        self.token_to_kv_pool = TokenKVPool(slots)
        self.req_to_token_pool = ReqToTokenPool(
            engine_config.max_requests, engine_config.max_context_len)
        # tree_index mode: a fixed row of KV indices per tree node
        # (deft_tpu runner.py:293-299)
        self.tree_index_pool = (
            TreeIndexPool(engine_config.max_requests, engine_config.max_context_len)
            if use_tree_index else None)
        self.tree = TreeCache(self.token_to_kv_pool, self.req_to_token_pool,
                              self.tree_index_pool)

        if measure_attention is None:
            measure_attention = self.device.type == "cuda" and not (
                self.mesh is not None and self.mesh.host_staged)
        self.measure_attention = measure_attention
        # (plan kind, paged, plan_sizes) -> (store_s, attn_s)
        self._attn_bench_cache: Dict[tuple, tuple] = {}
        # (store_s, attn_s) of the last decode step's bucket; None unmeasured
        self.last_attn_estimate: Optional[tuple] = None

        # plan uploads (deft_tpu runner.py:319-364), both off on a grid:
        # DEFT_PLAN_PATCH keeps the last packed plan of each (kind, length)
        # on the device and ships only its changed chunks; DEFT_COMPACT_PLAN
        # ships a paged flatten-family plan as its run table, re-expanded on
        # the device (expand_compact)
        self._plan_patch = env_on("DEFT_PLAN_PATCH") and self.mesh is None
        self._compact_plan = env_on("DEFT_COMPACT_PLAN") and self.mesh is None
        # (kind, padded length) -> [host mirror, device buffer]
        self._plan_dev_cache: Dict[tuple, list] = {}
        # monotone bucket floors a plan kind (deft_tpu :352-360): leaf, token
        # and run-table buckets only grow, so a span keeps one signature
        self._bucket_floors: Dict[str, dict] = {}
        self._rpad_floor: Dict[str, int] = {}
        # the plan bytes shipped against what full uploads would have
        # shipped, and the plan copies made (full buffers, patches, window
        # patches, slab chunks)
        self.plan_upload_bytes = 0
        self.plan_full_bytes = 0
        self.plan_copies = 0
        # the replay executor's windows, per-step items and sub-steps (pads
        # included) over the runner's life
        self.replay_stats = {"win": 0, "step": 0, "subs": 0}

    # -- sizing ------------------------------------------------------------------
    def _kv_cell_bytes(self) -> int:
        """K and V bytes of one slot over all layers (deft_tpu runner.py
        :384-394): int8 pools count 1 + 4 / D bytes an element (the fp32
        scale of each (token, head) spread over its D codes)."""
        elem = torch.tensor([], dtype=self.dtype).element_size()
        if self.kv_quantized:
            elem = 1 + 4.0 / self.cfg.head_dim
        return int(self.cfg.num_layers * self.cfg.num_kv_heads // self._tp
                   * self.cfg.head_dim * 2 * elem)

    def _profile_slots(self) -> int:
        """KV slots from free device memory (deft_tpu runner.py:382); an
        assumed 2 GiB on the CPU, as deft_tpu assumes without memory stats."""
        cell = self._kv_cell_bytes()
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
        else:
            free = 2 << 30
            logger.warning("sizing the KV pool from an assumed %d MiB on the "
                           "CPU: pass EngineConfig(kv_pool_slots=...)", free >> 20)
        slots = max(4096, min(int(free * self.ecfg.mem_fraction) // cell, 1 << 21))
        if self.mesh is not None:
            # every rank of a grid holds the same slots, so their allocators
            # (and so their collectives) stay in step: the least over the
            # world, as deft_tpu sizes one pool for the whole mesh (:382-415)
            import torch.distributed as dist

            t = torch.tensor([slots], dtype=torch.int64, device=self.device)
            dist.all_reduce(t, op=dist.ReduceOp.MIN)
            slots = int(t)
        return slots

    # -- helpers -----------------------------------------------------------------
    def _attn_fn(self, mode: ForwardMode, paged: bool):
        """The step's attention entry, from the mode, the plan's layout and
        the pools' dtype (deft_tpu runner.py:448-477): flatten, node and
        tree_index plans take the flatten kernels, UNPAGED_MEDUSA the dense
        masked attention over kv_idx."""
        kind = mode.plan_kind
        if mode is ForwardMode.UNPAGED_MEDUSA:
            return attn_impls.flatten_attn_xla
        if self.mesh is not None:
            return self._sharded_attn_fn(kind, paged)
        if kind == "seq":
            if not paged:
                return attn_impls.seq_gather_attn
            return (attn_impls.seq_attn_q if self.kv_quantized
                    else attn_impls.seq_attn)
        if not paged:
            return attn_impls.flatten_gather_attn
        return (attn_impls.flatten_attn_q if self.kv_quantized
                else attn_impls.flatten_attn)

    def _sharded_attn_fn(self, kind: str, paged: bool):
        """The grid's AttnFn (deft_tpu runner.py:420-447): flatten, node and
        tree_index plans (node_chunk and the unpaged flatten and node modes
        among them) through B1p / B4p (paged) or B11 (gather plans, either
        pool type); paged seq plans through B2p / B5p; other seq plans
        (UNPAGED_FD among them) through B7 on the rank's heads, every row
        (deft_tpu runs XLA attention there).  UNPAGED_MEDUSA takes the dense
        baseline on the rank's heads, every row, as on one card (_attn_fn)."""
        from deft_tpu_torch.parallel.engine import make_sharded_tree_attn
        from deft_tpu_torch.parallel.seq_engine import make_sharded_seq_attn

        if kind != "seq":
            return make_sharded_tree_attn(self.mesh, paged)
        return (make_sharded_seq_attn(self.mesh) if paged
                else attn_impls.seq_gather_attn)

    def _stage(self, arr: np.ndarray) -> torch.Tensor:
        """One host-to-device copy of an int32 array.  On a GPU the array
        is staged in a fresh block of torch's pinned allocator and copied
        without waiting: the allocator hands the block out again only once
        its copy has run."""
        arr = np.asarray(arr, dtype=np.int32)
        cuda = self.device.type == "cuda"
        host = torch.empty(arr.shape, dtype=torch.int32, pin_memory=cuda)
        host.numpy()[...] = arr
        return host.to(self.device, non_blocking=cuda)

    def _upload(self, parts: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """One host-to-device copy (``_stage``) of the concatenated int32
        arrays; returns views by name."""
        arrs = [np.asarray(a, dtype=np.int32).reshape(-1) for a in parts.values()]
        buf = self._stage(np.concatenate(arrs))
        out, o = {}, 0
        for name, a in zip(parts, arrs):
            out[name] = buf[o:o + a.size]
            o += a.size
        return out

    def _top(self, logits: torch.Tensor, kind: str, k: int = 0) -> tuple:
        """(vals, ids int32) of (R, V) logits, on the device (deft_tpu
        runner.py:731-744): softmax + 1e-6 top-k (k, else the runner's
        topk_k) for "topk", the top-1 alone for "greedy"."""
        if kind == "greedy":
            m, ids = logits.max(dim=-1, keepdim=True)
            lse = torch.logsumexp(logits, dim=-1, keepdim=True)
            return torch.exp(m - lse) + 1e-6, ids.to(torch.int32)
        probs = torch.softmax(logits, dim=-1) + 1e-6
        vals, ids = topk_lowest_index(probs, k or self.topk_k)
        return vals, ids.to(torch.int32)

    def _logits_view(self, logits: torch.Tensor, kind: str,
                     rows=None) -> LogitsView:
        """Softmax + 1e-6 top-K ("topk") or top-1 ("greedy") of (R, V)
        logits, left on the device (``_top``).  ``rows``, a grid's dp
        window (parallel/sharding.py RowWindow), says that the logits are
        the window's rows: their top-K is joined over dp, or, where the
        runner keeps full logits, the logits are joined first."""
        if rows is not None and self.retain_full_logits:
            logits, rows = rows.join(logits), None
        vals, ids = self._top(logits, kind)
        if rows is not None:
            vals, ids = self._shard.join_topk(rows, vals, ids)
        full = logits if self.retain_full_logits else None
        return LogitsView(vals, ids.to(torch.int32), full, self._copies)

    # -- public API ----------------------------------------------------------------
    def reset_state(self) -> None:
        """Release all tree/KV bookkeeping for a fresh generation (the device
        pools are reused: slots are written before they are read)."""
        if self.tree.root is not None:
            self.tree.free()
        self.token_to_kv_pool.clear()
        self.req_to_token_pool.clear()
        if self.tree_index_pool is not None:
            self.tree_index_pool.clear()
        self._plan_dev_cache.clear()

    def forward_prefill(self, prompt_ids, tree: Optional[TreeCache] = None
                        ) -> LogitsView:
        """Prefill a prompt into ``tree`` (default: the runner's own tree;
        the batched engine passes its requests' trees); returns the last
        token's distribution as a 1-row view."""
        tree = tree if tree is not None else self.tree
        cache_loc = tree.init_prompt(list(map(int, prompt_ids)))
        dev = self._upload({"tokens": tree.root.token_ids, "out_loc": cache_loc})
        # on a grid too: B3 over the rank's tp heads needs no collective
        logits = prefill_forward(self.cfg, self.params, self._rope_tbl,
                                 self.k_pool, self.v_pool, dev["tokens"],
                                 dev["out_loc"].long(), attn_impls.prefill_attn,
                                 self._shard)
        view = self._logits_view(logits[None, :], "topk")
        view.fetch_async()
        return view

    def forward_prefill_batch(self, prompts, trees) -> LogitsView:
        """Prefill B prompts, each into its own tree, in ONE forward: the
        prompts are joined on the token axis and told apart by per-token
        segment ids (ragged attention, kernel B8).  Row i of the returned
        view is prompt i's last-token distribution.  The forward runs
        eagerly at the true token count, so no bucket padding.  On a grid
        B8 runs on the rank's tp heads with no collective inside attention
        (every rank holds the same pool slots), and the last-token logits'
        vocab blocks are joined."""
        if not prompts or len(prompts) != len(trees):
            raise ValueError(f"{len(prompts)} prompts for {len(trees)} trees")
        tokens, positions, out_loc, seg, last = [], [], [], [], []
        o = 0
        for i, (ids, tree) in enumerate(zip(prompts, trees)):
            loc = tree.init_prompt(list(map(int, ids)))
            n = len(loc)
            tokens.append(tree.root.token_ids)
            positions.append(np.arange(n))
            out_loc.append(loc)
            seg.append(np.full(n, i))
            o += n
            last.append(o - 1)
        dev = self._upload({name: np.concatenate(parts) for name, parts in (
            ("tokens", tokens), ("positions", positions), ("out_loc", out_loc),
            ("seg_ids", seg))} | {"last_idx": np.asarray(last)})
        batch = RaggedPrefillBatch(
            tokens=dev["tokens"], positions=dev["positions"],
            out_loc=dev["out_loc"].long(), seg_ids=dev["seg_ids"],
            last_idx=dev["last_idx"].long())
        logits = ragged_prefill_forward(self.cfg, self.params, self._rope_tbl,
                                        self.k_pool, self.v_pool, batch,
                                        attn_impls.ragged_prefill_attn, self._shard)
        view = self._logits_view(logits, "topk")
        view.fetch_async()
        return view

    def apply_kv_copies(self, tree: Optional[TreeCache] = None) -> None:
        """Drain a tree's queued merge compactions (TreeCache.merge_nodes)
        into the pools, rows and int8 scales (deft_tpu runner.py:1727).
        Runs before the next forward step; all sources are read before any
        destination is written, as XLA's gather-then-scatter does."""
        tree = tree if tree is not None else self.tree
        pairs = tree.drain_kv_copies()
        if pairs is None:
            return
        self._relocate(*self._upload({"src": pairs[0], "dst": pairs[1]}).values())

    def build_plan(self, mode: ForwardMode):
        """Host-side attention plan for the current tree (call after alloc);
        the paged layouts are asked for, with the configured bucket sizes.
        int8 pools take deft_tpu's int8 segment rules (runner.py:1227-1246),
        made for its TPU kernels' 128-lane scale reads and kept so both
        packages build the same plans: flatten-family (flatten, node,
        tree_index) segments of 512, 256 or 128 tokens at waste limits 1.1,
        1.2 and 3.0, seq segments of 128 at 32.  Seq plans ask for the
        paged layout only where the head width packs (``packs_heads``), as
        deft_tpu's do.  The kind's bucket floors (deft_tpu :1214-1216,
        :1257-1258, :1270-1271) hold the token and leaf buckets at the most
        any earlier plan of the kind took, so after a branch/prune cycle
        l_pad and t_pad (c_pad for seq) only grow."""
        a = self.ecfg.attention
        kind = mode.plan_kind
        fl = self._bucket_floors.setdefault(kind, {"t": 0, "l": 0})
        kw = dict(q_per_kv=self.cfg.q_per_kv, block_len=a.block_len,
                  min_token_bucket=max(self.ecfg.min_token_bucket, fl["t"]),
                  min_leaf_bucket=fl["l"])
        if self.kv_quantized and kind == "seq":
            kw.update(seg_len=(128,), waste_limit=32.0)
        elif self.kv_quantized:
            kw.update(seg_len=(512, 256, 128), waste_limit=(1.1, 1.2, 3.0))
        if kind == "flatten":
            plan = build_flatten_plan(self.tree, **kw)
        elif kind == "node":
            plan = build_node_plan(self.tree, chunk_len=a.node_chunk_len, **kw)
        elif kind == "tree_index":
            plan = build_tree_index_plan(self.tree, **kw)
        else:
            plan = build_seq_plan(self.tree, want_paged=packs_heads(self.cfg.head_dim),
                                  **kw)
        fl["t"] = max(fl["t"], plan.c_pad if kind == "seq" else plan.t_pad)
        fl["l"] = max(fl["l"], plan.l_pad)
        return plan

    def _use_paged(self, plan, mode: Optional[ForwardMode] = None) -> bool:
        """Paged-kernel eligibility (deft_tpu runner.py:1275): a seg-aligned
        plan, in any mode but UNPAGED_MEDUSA, at a head width that packs
        (``packs_heads``).  A flatten plan at another width is segment-
        aligned and gathers all the same: it runs B6 over its kv_idx, as
        deft_tpu runs it there; the paged kernels are built for head_dim 64
        and 128 only."""
        return (isinstance(plan, (FlattenPlan, SeqPlan)) and plan.paged
                and mode is not ForwardMode.UNPAGED_MEDUSA
                and packs_heads(self.cfg.head_dim))

    def _pack(self, plan, paged: bool, kind: str) -> tuple:
        """(packed int32 buffer, sizes, paged) of a plan (deft_tpu
        runner.py:1745-1795): the query arrays and the segment tables of a
        paged seq plan, or a gather seq plan's seq_lens and paths; a paged
        flatten-family plan in the compact form (a header [n_live_pad,
        n_leaves], the query arrays and its run table padded to a power of
        two, at least 64 rows and the kind's floor, column-major) where the
        runner ships compact plans, else in the full form (tok_lo/tok_hi,
        blk_lo/blk_hi and seg_src, or kv_idx for a gather plan)."""
        if isinstance(plan, SeqPlan):
            if paged:
                buf = np.concatenate([
                    plan.q_tokens, plan.q_pos, plan.out_loc, plan.seq_lens,
                    plan.seg_src, plan.seg_off, plan.seg_live, plan.blk_live])
                return buf.astype(np.int32), plan_sizes(plan, True), True
            buf = np.concatenate([plan.q_tokens, plan.q_pos, plan.out_loc,
                                  plan.seq_lens, plan.paths.reshape(-1)])
            return buf.astype(np.int32), plan_sizes(plan, False), False
        if paged and self._compact_plan and plan.run_table is not None:
            R = len(plan.run_table)
            r_pad = max(64, next_pow2(R), self._rpad_floor.get(kind, 0))
            self._rpad_floor[kind] = r_pad
            rt = np.zeros((r_pad, 4), np.int32)
            rt[:R] = plan.run_table
            # pad rows: an offset past every live token, an empty interval
            rt[R:, 0] = plan.n_live_pad
            rt[R:, 2] = _EMPTY_LO
            buf = np.concatenate([
                np.asarray([plan.n_live_pad, plan.n_leaves], np.int32),
                plan.q_tokens, plan.q_pos, plan.out_loc, rt.T.reshape(-1)])
            return buf.astype(np.int32), plan_sizes(plan, True, r_pad), True
        tail = plan.seg_src if paged else plan.kv_idx
        buf = np.concatenate([plan.q_tokens, plan.q_pos, plan.out_loc, plan.tok_lo,
                              plan.tok_hi, plan.blk_lo, plan.blk_hi, tail])
        return buf.astype(np.int32), plan_sizes(plan, paged), paged

    def _pack_plan(self, mode: ForwardMode, plan) -> tuple:
        """``_pack`` in the step's layout (``_use_paged``)."""
        return self._pack(plan, self._use_paged(plan, mode), mode.plan_kind)

    def _plan_meta(self, plan, paged: bool) -> dict:
        """What a step takes from the numpy plan on the host besides its
        buffer: the block and segment lengths, a gather flatten plan's row
        tiles (B6's span rule), a flatten plan's blk_lo / blk_hi (a grid's
        rank windows, parallel/engine.py host_window) and a paged seq
        plan's blk_live (its sp span, parallel/seq_engine.py seq_window),
        so that no wrapper reads the device."""
        meta = {"seg_len": plan.seg_len, "block_len": None}
        if isinstance(plan, SeqPlan):
            if paged:
                meta["block_len"] = plan.c_pad // (len(plan.blk_live) // plan.l_pad)
                meta["live_host"] = plan.blk_live
            return meta
        meta["block_len"] = plan.block_len
        meta["blk_host"] = (plan.blk_lo, plan.blk_hi)
        if not paged:
            qpk = self.cfg.q_per_kv
            meta["row_tiles"] = row_tile_tiles(plan.blk_lo, plan.blk_hi,
                                               plan.l_pad * qpk, qpk, plan.block_len)
        return meta

    def _upload_plan(self, kind: str, buf: np.ndarray) -> torch.Tensor:
        """A packed plan buffer on the device, padded to whole chunks
        (deft_tpu runner.py:1801-1860): against the device-resident copy
        of the kind's last buffer of that length, only the changed
        PATCH_CHUNK-int chunks are shipped, their ids and data in one
        copy, and scattered into the resident buffer on torch's stream
        (the steps that read it before run first, in stream order).  A
        full upload on first use, on a new length, or when more than a
        quarter of the chunks changed: deft_tpu's rule."""
        CH = PATCH_CHUNK
        n_pad = -(-len(buf) // CH) * CH
        buf = np.concatenate([buf, np.zeros(n_pad - len(buf), np.int32)])
        self.plan_full_bytes += buf.nbytes
        key = (kind, n_pad)
        cached = self._plan_dev_cache.get(key)
        nb = n_pad // CH
        changed = (None if cached is None else np.flatnonzero(
            (buf.reshape(nb, CH) != cached[0].reshape(nb, CH)).any(axis=1)))
        if changed is not None and len(changed) == 0:
            return cached[1]
        if changed is None or len(changed) > nb // 4:
            dev = self._stage(buf)
            self._plan_dev_cache[key] = [buf, dev]
            self.plan_upload_bytes += buf.nbytes
            self.plan_copies += 1
            return dev
        host, dev = cached
        # a power-of-two count of chunks; repeated ids carry the same data
        k_pad = max(1, next_pow2(len(changed)))
        idx = np.full(k_pad, changed[0], np.int32)
        idx[:len(changed)] = changed
        chunks = buf.reshape(nb, CH)[idx]
        fused = np.concatenate([idx, chunks.reshape(-1)])
        staged = self._stage(fused)
        dev.view(nb, CH).index_copy_(0, staged[:k_pad].long(),
                                     staged[k_pad:].view(k_pad, CH))
        self.plan_upload_bytes += fused.nbytes
        self.plan_copies += 1
        host.reshape(nb, CH)[idx] = chunks
        return dev

    def _unpack(self, dev: torch.Tensor, kind: str, sizes: tuple, fields: list,
                meta: dict, q_override=None, window=None) -> SimpleNamespace:
        """The step's AttnFn batch from its packed buffer on the device
        (deft_tpu _make_unpack :502-659): views of the fields, a compact
        plan's per-token arrays re-expanded (expand_compact), out_loc
        widened for the store, and the host's ``meta``.  q tokens: the
        buffer's, or ``q_override`` — a previous step's (R,) greedy ids
        (on a grid cut to the rank's ``window``), or, where the buffer
        holds q_rows / q_cols, the (R_prev, K) top-K ids gathered there."""
        f, o = {}, 0
        for name, n in fields:
            f[name] = dev[o:o + n]
            o += n
        if kind != "seq" and len(sizes) == 5:
            f.update(expand_compact(f, sizes))
        if "q_rows" in f:
            f["q_tokens"] = q_override[f.pop("q_rows").long(), f.pop("q_cols").long()]
        elif q_override is not None:
            if q_override.shape[0] != sizes[0]:
                raise ValueError(f"{q_override.shape[0]} chained q tokens for a "
                                 f"plan of {sizes[0]} rows")
            f["q_tokens"] = q_override if window is None else window.take(q_override)
        for name in ("hdr", "run_off", "run_src", "run_lo", "run_hi"):
            f.pop(name, None)
        f["out_loc"] = f["out_loc"].long()
        if "paths" in f:
            f["paths"] = f["paths"].view(-1, sizes[1])
        return SimpleNamespace(**f, **meta, dp_rows=window)

    def _step_batch(self, plan, paged: Optional[bool] = None,
                    q_tokens_override: Optional[torch.Tensor] = None,
                    q_select=None, mode: Optional[ForwardMode] = None,
                    patch: bool = False) -> SimpleNamespace:
        """The step's plan on the device, as the AttnFn batch: the plan
        packed (``_pack``; ``paged=False`` asks for the kv_idx of a
        segment-aligned flatten plan, as UNPAGED_MEDUSA takes it), with
        q_select's rows and cols appended, in one upload (with ``patch``,
        through ``_upload_plan``, whose DEFT_PLAN_PATCH ships changed
        chunks), then unpacked (``_unpack``).  On a grid the buffer is the
        rank's (parallel/sharding.py shard_batch): its dp window of the
        plan's rows (``dp_rows``), out_loc and the plan's tables whole."""
        paged = self._use_paged(plan, mode) if paged is None else paged
        kind = (mode.plan_kind if mode is not None
                else "seq" if isinstance(plan, SeqPlan) else "flatten")
        buf, sizes, paged = self._pack(plan, paged, kind)
        if q_select is not None:
            buf = np.concatenate([buf, np.asarray(q_select[1], np.int32),
                                  np.asarray(q_select[2], np.int32)])
        fields = plan_fields(kind, sizes, paged, q_select is not None)
        window = None
        if self.mesh is not None:
            buf, fields, window = self._grid_cut(buf, fields, sizes)
        if patch and self._plan_patch:
            dev = self._upload_plan(kind, buf)
        else:
            dev = self._stage(buf)
            if patch:
                self.plan_upload_bytes += buf.nbytes
                self.plan_full_bytes += buf.nbytes
                self.plan_copies += 1
        override = q_select[0] if q_select is not None else q_tokens_override
        return self._unpack(dev, kind, sizes, fields, self._plan_meta(plan, paged),
                            override, window)

    def _grid_cut(self, buf: np.ndarray, fields: list, sizes: tuple) -> tuple:
        """A packed buffer cut to this rank (shard_batch): its dp window of
        the row arrays, the rest whole; returns (buffer, fields, window)."""
        from deft_tpu_torch.parallel.sharding import shard_batch

        parts, o = {}, 0
        for name, n in fields:
            parts[name] = buf[o:o + n]
            o += n
        if "paths" in parts:
            parts["paths"] = parts["paths"].reshape(sizes[0], -1)
        parts, window = shard_batch(self.mesh, parts, sizes[0])
        arrs = {k: np.asarray(v, np.int32).reshape(-1) for k, v in parts.items()}
        return (np.concatenate(list(arrs.values())),
                [(k, a.size) for k, a in arrs.items()], window)

    def _measure_attention_bucket(self, mode: ForwardMode, plan, paged: bool,
                                  sizes: Optional[tuple] = None) -> tuple:
        """(store_s, attn_s) a decode step for this plan's shape bucket
        (deft_tpu runner.py:1895-2002), cached by (plan kind, paged, the
        packed sizes: ``sizes``, else ``_pack``'s): the step's AttnFn over
        every layer, on the step's plan arrays and deft_tpu's
        deterministic filler q / k_new / v_new, and the K and V kv_store of
        every layer into DUMP_SLOT (over int8 pools its scale too, which is
        reserved as well), so no live row or scale changes.  A grid's
        AttnFn runs with its collectives, on the rank's heads.  Both are
        timed by rep_seconds, which waits once.  The plan goes up in a copy
        of its own, outside the plan-patch cache and its byte counts."""
        if sizes is None:
            sizes = self._pack(plan, paged, mode.plan_kind)[1]
        key = (mode.plan_kind, paged, sizes)
        hit = self._attn_bench_cache.get(key)
        if hit is not None:
            return hit
        attn = self._attn_fn(mode, paged)
        batch = self._step_batch(plan, paged, mode=mode)
        R, D, dev = plan.l_pad, self.cfg.head_dim, self.device
        hq = self.params["wo"].shape[-2] // D  # the rank's heads on a grid
        hkv = self.k_pool.data.shape[-1] // D
        rows = batch.q_tokens.shape[0]  # the rank's dp window on a grid

        def filler(*shape):  # deft_tpu's arange % 7 / 7, made on the device
            n = int(np.prod(shape))
            x = torch.arange(n, dtype=torch.float64, device=dev) % 7 / 7.0
            return x.reshape(shape).to(self.dtype)

        q, k_new, v_new = filler(rows, hq, D), filler(R, hkv, D), filler(R, hkv, D)
        dump = torch.full((R,), DUMP_SLOT, dtype=torch.long, device=dev)
        scale = D ** -0.5
        layers = range(self.cfg.num_layers)

        def attn_rep():
            for li in layers:
                attn(q, k_new, v_new, self.k_pool, self.v_pool, li, batch, scale)

        def store_rep():
            for li in layers:
                kv_store(self.k_pool, li, dump, k_new)
                kv_store(self.v_pool, li, dump, v_new)

        t0 = time.perf_counter()
        attn_s, store_s = rep_seconds((attn_rep, store_rep), dev,
                                      retry=self.mesh is None)
        self._attn_bench_cache[key] = result = (store_s, attn_s)
        logger.info("attn microbench %s: store %.3f ms, attn %.3f ms a step "
                    "(measured in %.2f s)", key, store_s * 1e3, attn_s * 1e3,
                    time.perf_counter() - t0)
        return result

    def _forward(self, mode: ForwardMode, paged: bool, batch,
                 logits_kind: str) -> torch.Tensor:
        """decode_forward of one step on the runner's state: the (R, V)
        logits, or the hidden state for "skip" (no lm_head product)."""
        return decode_forward(self.cfg, self.params, self._rope_tbl, self.k_pool,
                              self.v_pool, batch, self._attn_fn(mode, paged),
                              self._shard, compute_logits=logits_kind != "skip")

    def forward_tree_decode(self, mode: ForwardMode, plan,
                            q_tokens_override: Optional[torch.Tensor] = None,
                            q_select=None, block: bool = True,
                            logits_kind: str = "topk") -> tuple:
        """Run one tree-decode step (deft_tpu runner.py:2004).  Returns
        (LogitsView, forward_seconds).

        q_tokens_override: (R,) token ids on the device, a previous step's
        greedy ids in the same row order: chains steps with no host read.
        q_select: (prev_ids (R_prev, K) on the device, rows (R,), cols (R,)):
        q_tokens = prev_ids[rows, cols], gathered on the device, so steps
        chain across branches and prunes (row order changes, branch children
        take column c > 0 of their parent's top-K); rows and cols ride the
        plan's upload.  block=True waits for the step and its top-K's copy
        to the host (one host_wait), and the time runs from the plan upload
        to then; block=False returns once the step is enqueued, and the
        time is the enqueue time.
        logits_kind: "topk" (softmax + top-K), "greedy" (top-1 only) or
        "skip" (no lm_head product; an (R, 1) view of zeros, for steps that
        read no logits).  retain_full_logits turns "skip" into "topk"
        (deft_tpu runner.py:2033-2036).  With measure_attention, the plan's
        bucket is measured before the timed span (last_attn_estimate).  The
        plan goes up through _upload_plan (DEFT_PLAN_PATCH)."""
        paged = self._use_paged(plan, mode)
        if logits_kind == "skip" and self.retain_full_logits:
            logits_kind = "topk"
        self.apply_kv_copies()  # merge compactions land before the step
        self.last_attn_estimate = (
            self._measure_attention_bucket(mode, plan, paged)
            if self.measure_attention else None)
        t0 = time.perf_counter()
        batch = self._step_batch(plan, paged, q_tokens_override, q_select, mode,
                                 patch=True)
        out = self._forward(mode, paged, batch, logits_kind)
        if logits_kind == "skip":
            zeros = torch.zeros((plan.l_pad, 1), device=out.device)
            view = LogitsView(zeros, zeros.to(torch.int32), order=self._copies)
        else:
            view = self._logits_view(out, logits_kind, batch.dp_rows)
        if block:
            view.fetch_async()
            view.wait()
        return view, time.perf_counter() - t0

    def forward_tree_decode_window(self, mode: ForwardMode, plans,
                                   q0_device: Optional[torch.Tensor] = None,
                                   span=None) -> tuple:
        """len(plans) chained greedy decode steps from one upload (deft_tpu
        runner.py:950-1036, its _decode_window :875-948).  The plans share
        one bucket (the caller splits windows at bucket growth and at
        structural iterations).  Each sub-step's changed chunks against the
        one before (the first against the resident buffer, or the first
        plan whole where more than a quarter changed) ship as one (W, kc,
        CH+1) int32 upload, column 0 the chunk id; then each sub-step is
        enqueued on torch's stream: it patches the resident buffer,
        unpacks it, runs the forward and the greedy top-1, and its ids are
        the next sub-step's q tokens.  Sub-step 0 takes ``q0_device`` (a
        previous step's greedy ids) or its plan's tokens.  No host read.
        ``span``: a context for each sub-step (the tracer's).  Returns
        (WindowLogits, enqueue seconds)."""
        if not self._plan_patch or self.mesh is not None:
            raise RuntimeError("decode windows need the plan-patch path on one device")
        self.apply_kv_copies()
        kind = mode.plan_kind
        packs = [self._pack_plan(mode, p) for p in plans]
        _, sizes, paged = packs[0]
        if any(s != sizes or pg != paged for _, s, pg in packs[1:]):
            raise ValueError("window plans must share one shape bucket")
        CH = PATCH_CHUNK
        n = len(packs[0][0])
        n_pad = -(-n // CH) * CH
        nb = n_pad // CH
        bufs = [np.concatenate([b, np.zeros(n_pad - n, np.int32)]) for b, _, _ in packs]
        ckey = (kind, n_pad)
        cached = self._plan_dev_cache.get(ckey)
        if cached is None:
            base, prev = self._stage(bufs[0]), bufs[0]
            self.plan_upload_bytes += bufs[0].nbytes
            self.plan_copies += 1
        else:
            prev, base = cached
        changed = []
        for b in bufs:
            changed.append(np.flatnonzero(
                (b.reshape(nb, CH) != prev.reshape(nb, CH)).any(axis=1)))
            prev = b
        if len(changed[0]) > nb // 4:
            # after a structural step the first sub-step's diff can be most
            # of the buffer: ship it whole, and size kc by the appends
            base = self._stage(bufs[0])
            self.plan_upload_bytes += bufs[0].nbytes
            self.plan_copies += 1
            changed[0] = np.zeros(0, np.int64)
        kc = min(nb, max(1, next_pow2(max(len(c) for c in changed))))
        W = len(bufs)
        patches = np.zeros((W, kc, CH + 1), np.int32)
        for j, (b, c) in enumerate(zip(bufs, changed)):
            idx = np.zeros(kc, np.int64)
            idx[:len(c)] = c
            if len(c):
                idx[len(c):] = c[0]  # repeated ids carry the same data
            patches[j, :, 0] = idx
            patches[j, :, 1:] = b.reshape(nb, CH)[idx]
        if self.measure_attention:
            self.last_attn_estimate = self._measure_attention_bucket(
                mode, plans[0], paged, sizes)
        fields = plan_fields(kind, sizes, paged, False)
        t0 = time.perf_counter()
        dev = self._stage(patches)
        self.plan_upload_bytes += patches.nbytes
        self.plan_full_bytes += sum(b.nbytes for b in bufs)
        self.plan_copies += 1
        q, out = q0_device, []
        for j, plan in enumerate(plans):
            with span("decode_step") if span else contextlib.nullcontext():
                base.view(nb, CH).index_copy_(0, dev[j, :, 0].long(), dev[j, :, 1:])
                batch = self._unpack(base, kind, sizes, fields,
                                     self._plan_meta(plan, paged), q)
                vals, ids = self._top(self._forward(mode, paged, batch, "greedy"),
                                      "greedy")
                out.append(pack_top(vals, ids))
                q = ids[:, 0]
        self._plan_dev_cache[ckey] = [bufs[-1], base]
        view = WindowLogits(torch.stack(out), q, self._copies)
        return view, time.perf_counter() - t0

    def _relocate(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        """pool[:, dst] = pool[:, src] on both pools, rows and int8 scales,
        every source read before any destination is written (deft_tpu
        _relocate_step :1297-1321); DUMP_SLOT -> DUMP_SLOT pairs pad it."""
        src, dst = src.long(), dst.long()
        for pool in (self.k_pool, self.v_pool):
            pool.data.index_copy_(1, dst, pool.data.index_select(1, src))
            if pool.scale is not None:
                pool.scale.index_copy_(2, dst, pool.scale.index_select(2, src))

    def _partition(self, records, prev_view) -> list:
        """The replay executor's items (deft_tpu runner.py:1388-1455):
        ("win", start, L, wtop) for up to WK records of a uniform run —
        greedy records chained on ids (or a first one on its buffer's
        tokens), skip records, or topk records chained by select — and
        ("step", i) for the rest: every record under
        DEFT_REPLAY_WINDOWS=0, and a chained run's first record where its
        predecessor's rows or top-K width differ from the run's.  A topk
        run's wtop is a power of two (at least 2, at most topk_k) wide
        enough for every selection in it and at its entry."""
        use_windows = env_on("DEFT_REPLAY_WINDOWS")
        n = len(records)
        items = []
        prev_w = getattr(prev_view, "k", 0) if prev_view is not None else 0
        follows = {"greedy": "ids", "skip": "none", "topk": "select"}

        def sig(r):
            return len(r["buf"]), r["sizes"], r["paged"], r["logits_kind"]

        i = 0
        while i < n:
            r = records[i]
            lk, ok = r["logits_kind"], r["override_kind"]
            if not (use_windows and ((lk in ("greedy", "skip") and ok in ("ids", "none"))
                                     or (lk == "topk" and ok == "select"))):
                items.append(("step", i))
                if lk == "topk":
                    prev_w = self.topk_k
                i += 1
                continue
            j = i + 1
            while (j < n and sig(records[j]) == sig(r)
                   and records[j]["override_kind"] == follows[lk]):
                j += 1
            k0, L, wrun = i, j - i, 0
            if lk == "topk":
                wrun = max(records[t].get("wtop", 1) for t in range(max(0, i - 1), j))
                wrun = min(self.topk_k, max(2, next_pow2(wrun)))
            if ok in ("ids", "select"):
                pr = records[k0 - 1] if k0 else None
                if not (pr is not None and pr["sizes"][0] == r["sizes"][0]
                        and pr["logits_kind"] in ("greedy", "topk")
                        and (lk != "topk" or prev_w >= wrun)):
                    items.append(("step", k0))
                    prev_w = self.topk_k
                    k0, L = k0 + 1, L - 1
            while L:
                take = min(L, WK)
                items.append(("win", k0, take, wrun))
                k0, L = k0 + take, L - take
                if wrun:
                    prev_w = wrun
            i = j
        return items

    def _slab_step(self, mode: ForwardMode, r: dict, buf: torch.Tensor, prev) -> tuple:
        """One recorded step from its slab row (deft_tpu's slab variant of
        the decode step, runner.py:752-766): q tokens from the buffer, the
        previous view's greedy ids or its top-K gathered by the buffer's
        q_rows / q_cols.  Returns (LogitsView, packed output)."""
        ok, lk = r["override_kind"], r["logits_kind"]
        override = {"ids": lambda: prev.greedy_ids_device,
                    "select": lambda: prev.ids_device}.get(ok, lambda: None)()
        kind = mode.plan_kind
        fields = plan_fields(kind, r["sizes"], r["paged"], ok == "select")
        batch = self._unpack(buf, kind, r["sizes"], fields, r["meta"], override)
        out = self._forward(mode, r["paged"], batch, lk)
        if lk == "skip":
            vals = torch.zeros((r["sizes"][0], 1), device=out.device)
            ids = vals.to(torch.int32)
        else:
            vals, ids = self._top(out, lk)
        return LogitsView(vals, ids, order=self._copies), pack_top(vals, ids)

    def _slab_window(self, mode: ForwardMode, records, start: int, L: int, wtop: int,
                     slab: torch.Tensor, row: int, prev, span) -> tuple:
        """L sub-steps over slab rows row .. row + L - 1, records start ..
        start + L - 1 (deft_tpu runner.py:771-873, whose scan pads them to
        WK).  Each sub-step applies its KV relocations (their rows for the
        window in one copy), unpacks its row and runs the forward; greedy
        sub-steps chain their top-1 ids (the first takes its buffer's
        tokens or the previous view's ids), topk ones their top-``wtop``
        ids through the next buffer's q_rows / q_cols, skip ones take
        their buffer's tokens.  Returns (the chain view, the (L, R, 2k)
        packed outputs or None for skip)."""
        proto = records[start]
        lk, sizes, paged = proto["logits_kind"], proto["sizes"], proto["paged"]
        kind = mode.plan_kind
        greedy, topk = lk == "greedy", lk == "topk"
        pairs = [records[start + t].get("kv_pairs") for t in range(L)]
        cp = max((len(p[0]) for p in pairs if p is not None), default=0)
        moves = None
        if cp:
            cs = np.full((2, L, cp), DUMP_SLOT, np.int32)
            for t, p in enumerate(pairs):
                if p is not None:
                    cs[:, t, :len(p[0])] = p
            moves = self._stage(cs)
        fields = plan_fields(kind, sizes, paged, topk)
        q = None
        if greedy and proto["override_kind"] == "ids":
            q = prev.greedy_ids_device
        elif topk:
            q = prev.ids_device[:, :wtop]
        out = []
        for t in range(L):
            with span("decode_step"):
                if moves is not None:
                    self._relocate(moves[0, t], moves[1, t])
                batch = self._unpack(slab[row + t], kind, sizes, fields,
                                     records[start + t]["meta"],
                                     q if (greedy or topk) else None)
                logits = self._forward(mode, paged, batch, lk)
                if greedy:
                    vals, ids = self._top(logits, "greedy")
                    q = ids[:, 0]
                elif topk:
                    vals, ids = self._top(logits, "topk", wtop)
                    q = ids
                else:
                    continue
                out.append(pack_top(vals, ids))
        if not out:
            return ChainView(), None
        chain = (ChainView(greedy_ids_device=q) if greedy
                 else ChainView(greedy_ids_device=q[:, 0], ids_device=q))
        return chain, torch.stack(out)

    def execute_recorded(self, mode: ForwardMode, records, prev_view=None,
                         span=None) -> tuple:
        """Run a recorded span of decode steps from plan slabs resident on
        the device (deft_tpu runner.py:1322-1725).

        records: dicts of buf (the packed plan, q_select's rows and cols
        appended), sizes, paged, meta (``_plan_meta``), override_kind
        ("none", "ids" or "select"), logits_kind ("greedy", "topk" or
        "skip"), kv_pairs (None, or power-of-two-padded (src, dst) int32
        KV relocations to apply before the step), fetch (the step's output
        is read on the host) and wtop (the widest top-K column it selects).
        prev_view: the view the first record chains from.

        Uniform runs execute as windows of up to WK sub-steps over slab
        rows, the others one by one (``_partition``).  Each buffer length
        has one slab stream, uploaded in chunks of up to SLAB_M rows (a
        window never straddles two: it opens the next chunk where it does
        not fit), one copy a chunk, whose rows are then read in place with
        no transfer.  Outputs are copied to the host in stacked chunks; the
        host waits for the device every DEFT_REPLAY_DRAIN (256) sub-steps
        and at the end, and writes a line to stderr at a wait a minute or
        more after its last one.  A step that fails raises.  ``span``: a
        context for each record's sub-step (the tracer's).

        Returns (views, last_view, seconds): views[i] reads record i's ids
        and probabilities on the host (None without fetch); last_view
        carries the last record's ids on the device for the caller's
        chain."""
        D = max(1, int(os.environ.get("DEFT_REPLAY_DRAIN", "256")))
        items = self._partition(records, prev_view)

        chunks: Dict[int, list] = {}  # buffer length -> its slab chunks' rows
        where = []                    # each item's (buffer length, chunk, row)
        for item in items:
            n = item[2] if item[0] == "win" else 1
            blen = len(records[item[1]]["buf"])
            stream = chunks.setdefault(blen, [[]])
            if len(stream[-1]) + n > SLAB_M:
                stream.append([])
            where.append((blen, len(stream) - 1, len(stream[-1])))
            stream[-1].extend(records[item[1] + t]["buf"] for t in range(n))
        t0 = time.perf_counter()
        slabs = {}
        for blen, stream in chunks.items():
            slabs[blen] = [self._stage(np.stack(c)) for c in stream]
            self.plan_upload_bytes += 4 * blen * sum(map(len, stream))
            self.plan_copies += len(stream)
        self.plan_full_bytes += sum(
            4 * (-(-len(r["buf"]) // PATCH_CHUNK) * PATCH_CHUNK) for r in records)

        views = [None] * len(records)
        pending = []  # (record, packed) of single steps whose output is read

        def close_chunk():
            by_shape: Dict[tuple, list] = {}
            for ri, packed in pending:
                by_shape.setdefault(tuple(packed.shape), []).append((ri, packed))
            for group in by_shape.values():
                copy = HostCopy(torch.stack([p for _, p in group]), self._copies)
                for j, (ri, packed) in enumerate(group):
                    views[ri] = ChunkStepView(copy, j, packed.shape[-1] // 2)
            pending.clear()

        beat = [t0]

        def drain():
            event = None
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record()
            host_wait(event)
            self._copies.landed = self._copies.enqueued
            now = time.perf_counter()
            if now - beat[0] >= 60.0:  # deft_tpu's liveness line (:1562-1579)
                print(f"[execute_recorded] alive, {now - t0:.0f} s into the span",
                      file=sys.stderr, flush=True)
                beat[0] = now

        ctx = span or (lambda name: contextlib.nullcontext())
        prev, since = prev_view, 0
        for item, (blen, chunk, row) in zip(items, where):
            slab = slabs[blen][chunk]
            if item[0] == "step":
                r = records[item[1]]
                with ctx("decode_step"):
                    if r.get("kv_pairs") is not None:
                        pair = self._stage(np.stack(r["kv_pairs"]))
                        self._relocate(pair[0], pair[1])
                    prev, packed = self._slab_step(mode, r, slab[row], prev)
                if r.get("fetch"):
                    pending.append((item[1], packed))
                    if len(pending) >= 64:
                        close_chunk()
                n_subs = 1
                self.replay_stats["step"] += 1
            else:
                _, start, n_subs, wtop = item
                prev, packed = self._slab_window(mode, records, start, n_subs, wtop,
                                                 slab, row, prev, ctx)
                if packed is not None:
                    copy = HostCopy(packed, self._copies)
                    for t in range(n_subs):
                        if records[start + t].get("fetch"):
                            views[start + t] = ChunkStepView(
                                copy, t, packed.shape[-1] // 2)
                self.replay_stats["win"] += 1
            self.replay_stats["subs"] += n_subs
            since += n_subs
            if since >= D:
                drain()
                since = 0
        if pending:
            close_chunk()
        if isinstance(prev, LogitsView):
            prev.fetch_async()
        drain()
        return views, prev, time.perf_counter() - t0
