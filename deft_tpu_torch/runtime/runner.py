"""Model runner: owns the device state (params, KV pools) and runs the
prefill and tree-decode steps.

Port of the per-step path of deft_tpu/runtime/runner.py: LogitsView (:66),
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
runs eagerly, so there are no jitted steps, shape-bucket floors, plan
patches or replay slabs: each step stages its plan arrays in pinned host
memory, uploads them in one copy that does not wait, and runs the forward
on torch's current stream.

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
                                 build_seq_plan, build_tree_index_plan)
from deft_tpu_torch.plan.flatten import FlattenPlan
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


def plan_sizes(plan, paged: bool) -> tuple:
    """The shape of a step's plan arrays, as deft_tpu's _pack_plan builds
    it in its non-compact form (runner.py:1745-1795): the attention
    microbench's bucket key, with the plan kind and the layout."""
    if isinstance(plan, SeqPlan):
        if paged:
            nb = len(plan.blk_live) // plan.l_pad
            return (plan.l_pad, len(plan.seg_src) // plan.l_pad, nb,
                    plan.c_pad // nb, plan.seg_len)
        return (plan.l_pad, plan.c_pad)
    tail = plan.seg_src if paged else plan.kv_idx
    return (plan.l_pad, plan.t_pad, plan.num_blocks, len(tail))


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
    until it is read: ``fetch_async`` enqueues its copy into pinned host
    memory behind the step and records an event, and the first read of
    ``vals`` or ``ids`` waits for that copy (``host_wait``) unless a wait for
    a later copy of the same ``CopyOrder`` (the runner's) has seen it land.  ``greedy_ids_device`` and
    ``ids_device`` feed a next step's q tokens on the device
    (runtime/generate.py's chains) with no read at all.  On the CPU the
    same code runs with plain copies; numpy arrays are taken as they are."""

    def __init__(self, vals, ids, full: Optional[torch.Tensor] = None,
                 order: Optional[CopyOrder] = None):
        self._vals = vals  # (R, K) probabilities, a tensor or numpy
        self._ids = ids    # (R, K) int32 token ids
        self._full = full  # optional (R, V) fp32 logits
        self._order = order if order is not None else CopyOrder()
        self._copy = None  # (vals, ids) host tensors, their event, their number
        self._host = None  # (vals, ids) numpy, once landed

    def fetch_async(self) -> None:
        """Enqueue the copy of the top-K to the host (once)."""
        if self._copy is not None or isinstance(self._vals, np.ndarray):
            return
        cuda = self._vals.device.type == "cuda"
        host = []
        for t in (self._vals, self._ids):
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=cuda)
            h.copy_(t, non_blocking=cuda)
            host.append(h)
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record()
        self._order.enqueued += 1
        self._copy = (host, event, self._order.enqueued)

    def wait(self) -> None:
        """Return once the host copy has landed (a counted host_wait, unless
        a wait for this or a later copy has passed already)."""
        if isinstance(self._vals, np.ndarray):
            return
        self.fetch_async()
        _, event, n = self._copy
        if n > self._order.landed:
            host_wait(event)
            self._order.landed = n

    def _landed(self) -> tuple:
        if self._host is None:
            if isinstance(self._vals, np.ndarray):
                self._host = (self._vals, self._ids)
            else:
                self.wait()
                self._host = tuple(h.numpy() for h in self._copy[0])
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

    def _upload(self, parts: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """One host-to-device copy of the concatenated int32 arrays; returns
        views by name.  On a GPU the arrays are staged in a fresh block of
        torch's pinned allocator and copied without waiting: the allocator
        hands the block out again only once its copy has run."""
        arrs = [np.asarray(a, dtype=np.int32).reshape(-1) for a in parts.values()]
        cuda = self.device.type == "cuda"
        host = torch.empty(sum(a.size for a in arrs), dtype=torch.int32,
                           pin_memory=cuda)
        np.concatenate(arrs, out=host.numpy())
        buf = host.to(self.device, non_blocking=cuda)
        out, o = {}, 0
        for name, a in zip(parts, arrs):
            out[name] = buf[o:o + a.size]
            o += a.size
        return out

    def _logits_view(self, logits: torch.Tensor, kind: str,
                     rows=None) -> LogitsView:
        """Softmax + 1e-6 top-K ("topk") or top-1 ("greedy") of (R, V)
        logits, left on the device (deft_tpu runner.py:731-744).  ``rows``,
        a grid's dp window (parallel/sharding.py RowWindow), says that the
        logits are the window's rows: their top-K is joined over dp, or,
        where the runner keeps full logits, the logits are joined first."""
        if rows is not None and self.retain_full_logits:
            logits, rows = rows.join(logits), None
        if kind == "greedy":
            m, ids = logits.max(dim=-1, keepdim=True)
            lse = torch.logsumexp(logits, dim=-1, keepdim=True)
            vals = torch.exp(m - lse) + 1e-6
        else:
            probs = torch.softmax(logits, dim=-1) + 1e-6
            vals, ids = topk_lowest_index(probs, self.topk_k)
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
        src, dst = (t.long() for t in self._upload(
            {"src": pairs[0], "dst": pairs[1]}).values())
        for pool in (self.k_pool, self.v_pool):
            pool.data.index_copy_(1, dst, pool.data.index_select(1, src))
            if pool.scale is not None:
                pool.scale.index_copy_(2, dst, pool.scale.index_select(2, src))

    def build_plan(self, mode: ForwardMode):
        """Host-side attention plan for the current tree (call after alloc);
        the paged layouts are asked for, with the configured bucket sizes.
        int8 pools take deft_tpu's int8 segment rules (runner.py:1227-1246),
        made for its TPU kernels' 128-lane scale reads and kept so both
        packages build the same plans: flatten-family (flatten, node,
        tree_index) segments of 512, 256 or 128 tokens at waste limits 1.1,
        1.2 and 3.0, seq segments of 128 at 32.  Seq plans ask for the
        paged layout only where the head width packs (``packs_heads``), as
        deft_tpu's do."""
        a = self.ecfg.attention
        kw = dict(q_per_kv=self.cfg.q_per_kv, block_len=a.block_len,
                  min_token_bucket=self.ecfg.min_token_bucket)
        kind = mode.plan_kind
        if self.kv_quantized and kind == "seq":
            kw.update(seg_len=(128,), waste_limit=32.0)
        elif self.kv_quantized:
            kw.update(seg_len=(512, 256, 128), waste_limit=(1.1, 1.2, 3.0))
        if kind == "flatten":
            return build_flatten_plan(self.tree, **kw)
        if kind == "node":
            return build_node_plan(self.tree, chunk_len=a.node_chunk_len, **kw)
        if kind == "tree_index":
            return build_tree_index_plan(self.tree, **kw)
        return build_seq_plan(self.tree, want_paged=packs_heads(self.cfg.head_dim),
                              **kw)

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

    def _step_batch(self, plan, paged: Optional[bool] = None,
                    q_tokens_override: Optional[torch.Tensor] = None,
                    q_select=None) -> SimpleNamespace:
        """The step's plan arrays on the device, as the AttnFn batch: the
        segment tables of a paged plan, else the gather plan's kv_idx (flatten)
        or paths and seq_lens (seq).  ``paged=False`` asks for kv_idx of a
        flatten plan that is segment-aligned (UNPAGED_MEDUSA).  The q tokens
        are the plan's, or ``q_tokens_override``, or gathered as
        prev_ids[rows, cols] from ``q_select``, whose rows and cols ride the
        same upload (forward_tree_decode).  On a grid the batch is the
        rank's (parallel/sharding.py shard_batch): its dp window of the
        plan's rows (``dp_rows``), out_loc and the plan's tables whole."""
        paged = plan.paged if paged is None else paged
        parts = {"q_tokens": plan.q_tokens, "q_pos": plan.q_pos,
                 "out_loc": plan.out_loc}
        if q_select is not None:
            parts.update(q_rows=q_select[1], q_cols=q_select[2])
        block_len = None
        if isinstance(plan, SeqPlan) and plan.paged:
            parts.update(seg_src=plan.seg_src, seg_off=plan.seg_off,
                         seg_live=plan.seg_live, blk_live=plan.blk_live)
            block_len = plan.c_pad // (len(plan.blk_live) // plan.l_pad)
        elif isinstance(plan, SeqPlan):
            parts.update(paths=plan.paths, seq_lens=plan.seq_lens)
        else:
            parts.update(tok_lo=plan.tok_lo, tok_hi=plan.tok_hi,
                         blk_lo=plan.blk_lo, blk_hi=plan.blk_hi)
            parts.update({"seg_src": plan.seg_src} if paged
                         else {"kv_idx": plan.kv_idx})
            block_len = plan.block_len
        window = None
        if self.mesh is not None:
            from deft_tpu_torch.parallel.sharding import shard_batch

            parts, window = shard_batch(self.mesh, parts, plan.l_pad)
        dev = self._upload(parts)
        dev["out_loc"] = dev["out_loc"].long()
        if q_select is not None:
            rows, cols = dev.pop("q_rows").long(), dev.pop("q_cols").long()
            dev["q_tokens"] = q_select[0][rows, cols]
        elif q_tokens_override is not None:
            if q_tokens_override.shape[0] != plan.l_pad:
                raise ValueError(f"{q_tokens_override.shape[0]} chained q tokens "
                                 f"for a plan of {plan.l_pad} rows")
            dev["q_tokens"] = (q_tokens_override if window is None
                               else window.take(q_tokens_override))
        if "paths" in dev:
            dev["paths"] = dev["paths"].view(-1, plan.paths.shape[1])
        if isinstance(plan, FlattenPlan) and not paged:
            # B6's span rule reads the row tiles' work from the numpy plan,
            # so the wrapper reads nothing back from the device
            qpk = self.cfg.q_per_kv
            dev["row_tiles"] = row_tile_tiles(plan.blk_lo, plan.blk_hi,
                                              plan.l_pad * qpk, qpk, plan.block_len)
        if isinstance(plan, FlattenPlan):
            # a grid's rank windows are cut on the host from the numpy plan
            # (parallel/engine.py host_window): B11's row tiles and the sp
            # span's blocks, with nothing read back from the device
            dev["blk_host"] = (plan.blk_lo, plan.blk_hi)
        elif isinstance(plan, SeqPlan) and plan.paged:
            # and a paged seq plan's sp span (parallel/seq_engine.py seq_window)
            dev["live_host"] = plan.blk_live
        return SimpleNamespace(**dev, block_len=block_len, seg_len=plan.seg_len,
                               dp_rows=window)

    def _measure_attention_bucket(self, mode: ForwardMode, plan,
                                  paged: bool) -> tuple:
        """(store_s, attn_s) a decode step for this plan's shape bucket
        (deft_tpu runner.py:1895-2002), cached by (plan kind, paged,
        plan_sizes): the step's AttnFn over every layer, on the step's plan
        arrays and deft_tpu's deterministic filler q / k_new / v_new, and
        the K and V kv_store of every layer into DUMP_SLOT (over int8 pools
        its scale too, which is reserved as well), so no live row or scale
        changes.  A grid's AttnFn runs with its collectives, on the rank's
        heads.  Both are timed by rep_seconds, which waits once."""
        key = (mode.plan_kind, paged, plan_sizes(plan, paged))
        hit = self._attn_bench_cache.get(key)
        if hit is not None:
            return hit
        attn = self._attn_fn(mode, paged)
        batch = self._step_batch(plan, paged)
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
        bucket is measured before the timed span (last_attn_estimate)."""
        paged = self._use_paged(plan, mode)
        attn = self._attn_fn(mode, paged)
        if logits_kind == "skip" and self.retain_full_logits:
            logits_kind = "topk"
        self.apply_kv_copies()  # merge compactions land before the step
        self.last_attn_estimate = (
            self._measure_attention_bucket(mode, plan, paged)
            if self.measure_attention else None)
        t0 = time.perf_counter()
        batch = self._step_batch(plan, paged, q_tokens_override, q_select)
        out = decode_forward(self.cfg, self.params, self._rope_tbl, self.k_pool,
                             self.v_pool, batch, attn, self._shard,
                             compute_logits=logits_kind != "skip")
        if logits_kind == "skip":
            zeros = torch.zeros((plan.l_pad, 1), device=out.device)
            view = LogitsView(zeros, zeros.to(torch.int32), order=self._copies)
        else:
            view = self._logits_view(out, logits_kind, batch.dp_rows)
        if block:
            view.fetch_async()
            view.wait()
        return view, time.perf_counter() - t0
