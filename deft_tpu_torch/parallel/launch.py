"""Start a (dp, sp, tp) grid of ranks on this host and run a function in each.

deft_tpu needs no launcher: one JAX process drives every device.  The port
runs one process per rank: ``launch(fn, grid_shape, device, backend, args)``
starts dp * sp * tp processes with torch.multiprocessing (start method
"spawn", a free localhost port), joins them to one process group
(multihost.init_runtime), builds each rank's Grid (mesh.make_mesh) and runs
``fn(grid, *args)`` in every rank; it returns rank 0's result.  A failure in
any rank raises in the caller with that rank's traceback, and the other
ranks are stopped.

``fn`` must be importable by a spawned child, so worker functions live in
this package (``run_all``, ``generate_tokens`` in any decode mode,
``batched_tokens``, ``greedy_waits``, ``attn_estimates``, ``first_step``,
``pool_slots``, ``spec_step``, ``counted_rows``),
never in a test file or a module that imports jax.
"""

from __future__ import annotations

import math
import os
import pickle
import queue
import socket
import time
import traceback
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from deft_tpu_torch.parallel.mesh import Grid, make_mesh
from deft_tpu_torch.parallel.multihost import check_backend, init_runtime


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, shape: Tuple[int, int, int], device: str,
               backend: Optional[str], port: int, fn: Callable, args: tuple,
               results) -> None:
    n = math.prod(shape)
    try:
        if device == "cpu":  # ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        init_runtime(backend, rank=rank, world_size=n,
                     init_method=f"tcp://127.0.0.1:{port}", device=device)
        grid = make_mesh(n, shape=shape, device=device)
        out = fn(grid, *args)
        # plain pickle: a queue would share tensors through file descriptors
        # that die with this process
        results.put((rank, True, pickle.dumps(out) if rank == 0 else None))
    except BaseException:  # noqa: BLE001 — reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, grid_shape: Sequence[int], device: str = "cuda",
           backend: Optional[str] = None, args: tuple = (),
           timeout: Optional[float] = None):
    """Run ``fn(grid, *args)`` on every rank of a ``grid_shape`` (dp, sp,
    tp) grid started on this host; returns rank 0's result.  One rank runs
    in this process, with no process group.  ``backend`` defaults to nccl
    on cuda and gloo on cpu; ``timeout`` (seconds) bounds the whole run."""
    shape = tuple(int(x) for x in grid_shape)
    n = math.prod(shape)
    if n == 1:
        return fn(make_mesh(1, shape=shape, device=device), *args)
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    check_backend(backend, n, device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, shape, device, backend, port, fn, args, results))
             for r in range(n)]
    for p in procs:
        p.start()
    done, failure, gone = {}, None, {}
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while len(done) < n and failure is None:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                now = time.monotonic()
                for r, p in enumerate(procs):
                    if p.exitcode is not None and r not in done:
                        # a result put just before exit may still be in the pipe
                        gone.setdefault(r, now)
                        if p.exitcode != 0 or now - gone[r] > 10:
                            failure = (f"rank {r} exited with code {p.exitcode} "
                                       "without a result")
                if deadline is not None and now > deadline:
                    failure = f"the ranks did not finish within {timeout} s"
                continue
            if ok:
                done[rank] = payload
            else:
                failure = f"rank {rank} of grid {shape} failed:\n{payload}"
    finally:
        for p in procs:
            if failure is not None and p.is_alive():
                p.terminate()
            p.join()
        results.close()
    if failure is not None:
        raise RuntimeError(failure)
    return pickle.loads(done[0])


def run_all(grid: Grid, calls: Sequence[Tuple[Callable, dict]]) -> list:
    """Worker: ``[fn(grid, **kwargs) for fn, kwargs in calls]``, so that one
    launch runs several cases in order on every rank."""
    return [fn(grid, **kwargs) for fn, kwargs in calls]


def _runner(grid: Grid, cfg, ecfg, seed: int, model_path=None,
            use_tree_index: bool = False):
    from deft_tpu_torch.runtime import ModelRunner

    return ModelRunner(cfg, ecfg, device=grid.device, seed=seed, mesh=grid,
                       model_path=model_path, use_tree_index=use_tree_index)


def generate_tokens(grid: Grid, cfg, ecfg, prompt, mode: str = "flatten",
                    width: int = 3, max_seq_len: int = 32, depth: int = 0,
                    seed: int = 0, mem: str = "paged"):
    """Worker: one Simple_Tree tree_generate on the grid (random weights
    from ``seed``) in the CLI's ``--mode`` / ``--mem`` (tree_index takes
    the runner's tree-index pool; node_chunk its chunk from ``ecfg``);
    returns the branches' token ids and each decode step's plan.paged."""
    from deft_tpu_torch.control import Branch_Controller, workloads
    from deft_tpu_torch.runtime import mode_from_cli, tree_generate

    runner = _runner(grid, cfg, ecfg, seed, use_tree_index=mode == "tree_index")
    paged = []
    build = runner.build_plan

    def recording_build(m):
        plan = build(m)
        paged.append(plan.paged)
        return plan

    runner.build_plan = recording_build
    tree_generate(runner, mode_from_cli(mode, mem), None, prompt,
                  max_seq_len=max_seq_len, width=width, depth=depth,
                  branch_controller=Branch_Controller(workloads.simple_tree))
    return [tuple(s.token_ids) for s in runner.tree.all_finished_seqs], paged


def batched_tokens(grid: Grid, cfg, ecfg, prompts, mode: str = "flatten",
                   width: int = 2, gen: int = 10, seed: int = 0):
    """Worker: each prompt a Simple_Tree request of ``gen`` tokens through
    BatchedEngine on the grid (one ragged prefill, then multi-tree steps,
    the all-greedy ones chained); returns each request's branches' token
    ids, sorted, and each step's (block, plan.paged)."""
    from deft_tpu_torch.control import Branch_Controller, workloads
    from deft_tpu_torch.runtime import mode_from_cli
    from deft_tpu_torch.runtime.batched import BatchedEngine, Request

    runner = _runner(grid, cfg, ecfg, seed)
    eng = BatchedEngine(runner, mode_from_cli(mode))
    steps = []
    forward = runner.forward_tree_decode

    def recording_forward(m, plan, **kw):
        steps.append((kw.get("block", True), plan.paged))
        return forward(m, plan, **kw)

    runner.forward_tree_decode = recording_forward
    reqs = [Request(p, Branch_Controller(workloads.simple_tree), len(p) + gen,
                    width=width) for p in prompts]
    eng.add_requests(reqs)
    eng.run()
    return [sorted(tuple(s.token_ids) for s in r.finished_seqs) for r in reqs], steps


def greedy_waits(grid: Grid, cfg, ecfg, prompt, gen: int, width: int = 3,
                 chained: bool = True, seed: int = 0):
    """Worker: a greedy Simple_Tree tree_generate of ``gen`` tokens in
    flatten mode, chained, or (``chained=False``) with the workload's
    declarations hidden so that every step reads host logits; returns the
    branches' token ids, the runner's host waits after the prefill, and each
    decode step's (block, host waits during the call)."""
    from deft_tpu_torch.control import Branch_Controller, workloads
    from deft_tpu_torch.runtime import mode_from_cli, tree_generate
    from deft_tpu_torch.runtime.runner import host_wait

    runner = _runner(grid, cfg, ecfg, seed)
    forward = runner.forward_tree_decode
    calls, start = [], []

    def recording_forward(m, plan, **kw):
        before = host_wait.waits
        if not start:
            start.append(before)  # the prefill's read is behind us
        out = forward(m, plan, **kw)
        calls.append((kw.get("block", True), host_wait.waits - before))
        return out

    def per_step(*a, deferred=None, **k):
        return workloads.simple_tree(*a, **k)

    runner.forward_tree_decode = recording_forward
    tree_generate(runner, mode_from_cli("flatten"), None, prompt,
                  max_seq_len=len(prompt) + gen, width=width, depth=1,
                  branch_controller=Branch_Controller(
                      workloads.simple_tree if chained else per_step))
    return ([tuple(s.token_ids) for s in runner.tree.all_finished_seqs],
            host_wait.waits - start[0], calls)


def attn_estimates(grid: Grid, cfg, ecfg, prompt, gen: int, width: int = 3,
                   mode: str = "flatten", measure_attention=None, seed: int = 0):
    """Worker: a Simple_Tree tree_generate of ``gen`` tokens with the
    runner's ``measure_attention``; returns the branches' token ids and, of
    every rank in rank order, (the bucket keys it measured, its
    attn_comp_per_iter, attn_mem_per_iter, attn_is_estimate)."""
    from deft_tpu_torch.control import Branch_Controller, workloads
    from deft_tpu_torch.runtime import ModelRunner, mode_from_cli, tree_generate

    runner = ModelRunner(cfg, ecfg, device=grid.device, seed=seed, mesh=grid,
                         measure_attention=measure_attention)
    pm = tree_generate(runner, mode_from_cli(mode), None, prompt,
                       max_seq_len=len(prompt) + gen, width=width, depth=1,
                       branch_controller=Branch_Controller(workloads.simple_tree))
    mine = (list(runner._attn_bench_cache), pm.attn_comp_per_iter,
            pm.attn_mem_per_iter, pm.attn_is_estimate)
    ranks = [None] * grid.size
    dist.all_gather_object(ranks, mine)
    return [tuple(s.token_ids) for s in runner.tree.all_finished_seqs], ranks


def first_step(grid: Grid, cfg, ecfg, prompt, mode: str = "flatten",
               width: int = 5, seed: int = 0, first_token: int = 100,
               model_path=None):
    """Worker: prefill ``prompt``, branch the root into ``width`` leaves
    with tokens first_token + i, run one decode step; returns its
    plan.paged and the top-K ids and probabilities of the leaves' rows.
    ``model_path``: a local HF checkpoint in place of random weights."""
    from deft_tpu_torch.runtime import mode_from_cli

    runner = _runner(grid, cfg, ecfg, seed, model_path)
    runner.forward_prefill(prompt)
    tree = runner.tree
    for i, c in enumerate(tree.branch(tree.root, width)):
        c.append_token(first_token + i)
    tree.alloc()
    plan = runner.build_plan(mode_from_cli(mode))
    view, _ = runner.forward_tree_decode(mode_from_cli(mode), plan)
    return plan.paged, view.ids[:width], view.vals[:width]


def pool_slots(grid: Grid, cfg, ecfgs, seed: int = 0) -> list:
    """Worker: a runner on each rank from that rank's EngineConfig
    ``ecfgs[rank]`` (so ranks may size their pools from different memory);
    returns every rank's KV slot count, in rank order."""
    runner = _runner(grid, cfg, ecfgs[grid.rank], seed)
    out = [None] * grid.size
    dist.all_gather_object(out, runner.token_to_kv_pool.size)
    return out


def spec_step(grid: Grid, cfg, params, pools, parts, n: int, route: str,
              seg_len: int = 0):
    """Worker: one decode step laid out by deft_tpu's batch specs: the whole
    numpy ``params`` (the port's fused names) and ``pools`` ((k, v), (L, S,
    Hkv*D) fp32) and a step's numpy plan ``parts`` over n rows (``seg_len``
    its segment length), placed on the rank by parallel/sharding.py
    shard_decode_args, then models/llama.py
    decode_forward through the route's AttnFn: "flatten" (a paged flatten
    plan: B1p), "seq" (a paged seq plan: B2p) or "seq gather" (B7 on the
    rank's rows).  Returns the step's fp32 logits (the windows joined over
    dp) and, of every rank in rank order, its rows through the dense
    layers and its (k, v) pool slices after the step."""
    from types import SimpleNamespace

    from deft_tpu_torch.models.llama import KVPool, decode_forward, forward_layers
    from deft_tpu_torch.models.rope import rope_table
    from deft_tpu_torch.ops import attn_impls
    from deft_tpu_torch.parallel.engine import ShardedModel, make_sharded_tree_attn
    from deft_tpu_torch.parallel.seq_engine import make_sharded_seq_attn
    from deft_tpu_torch.parallel.sharding import shard_decode_args

    whole = {k: torch.from_numpy(v) for k, v in params.items()}
    p, k_pool, v_pool, local, rows = shard_decode_args(
        grid, whole, KVPool(torch.from_numpy(pools[0])), KVPool(torch.from_numpy(pools[1])),
        parts, cfg, n)
    batch = SimpleNamespace(**{k: torch.from_numpy(np.asarray(v, np.int32))
                               for k, v in local.items()}, dp_rows=rows, seg_len=seg_len)
    batch.out_loc = batch.out_loc.long()
    if route == "flatten":
        attn = make_sharded_tree_attn(grid, paged=True)
        batch.blk_host = (parts["blk_lo"], parts["blk_hi"])
        batch.block_len = len(parts["tok_lo"]) // len(parts["blk_lo"])
    elif route == "seq":
        attn = make_sharded_seq_attn(grid)
        batch.live_host = parts["blk_live"]
    else:
        attn = attn_impls.seq_gather_attn
    rope = torch.from_numpy(rope_table(cfg.head_dim, 2048, cfg.rope_theta, cfg.rope_scaling,
                                       orig_max_pos=cfg.max_position_embeddings))
    logits = decode_forward(cfg, p, rope, k_pool, v_pool, batch, attn, ShardedModel(grid))
    mine = (forward_layers.last_rows, k_pool.data.numpy(), v_pool.data.numpy())
    ranks = [None] * grid.size
    dist.all_gather_object(ranks, mine)
    return rows.join(logits).numpy(), ranks


def counted_rows(grid: Grid, cfg, ecfg, prompts, width: int = 5, seed: int = 0):
    """Worker: the rows this runner's rank sends through the dense layers
    (models/llama.py forward_layers.last_rows) at the prefill of
    prompts[0], at the first decode step of ``width`` leaves after it, and
    at the ragged prefill of all ``prompts``; every rank's, in rank order,
    with the decode step's plan.l_pad."""
    from deft_tpu_torch.models.llama import forward_layers
    from deft_tpu_torch.runtime import ForwardMode

    runner = _runner(grid, cfg, ecfg, seed)
    runner.forward_prefill(prompts[0])
    prefill = forward_layers.last_rows
    tree = runner.tree
    for i, c in enumerate(tree.branch(tree.root, width)):
        c.append_token(100 + i)
    tree.alloc()
    plan = runner.build_plan(ForwardMode.TREE_DECODE_FLATTEN)
    runner.forward_tree_decode(ForwardMode.TREE_DECODE_FLATTEN, plan)
    decode = forward_layers.last_rows
    runner.reset_state()
    from deft_tpu_torch.core import TreeCache

    trees = [TreeCache(runner.token_to_kv_pool, runner.req_to_token_pool) for _ in prompts]
    runner.forward_prefill_batch(prompts, trees)
    mine = dict(prefill=prefill, decode=decode, ragged=forward_layers.last_rows,
                l_pad=plan.l_pad)
    out = [None] * grid.size
    dist.all_gather_object(out, mine)
    return out
