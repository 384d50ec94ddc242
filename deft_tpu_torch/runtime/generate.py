"""The tree-decoding generation loop, with deft_tpu's device chains.

Port of deft_tpu/runtime/generate.py:68 (tree_generate) on its per-step path
(:526-731): prefill, then per iteration alloc one KV slot per leaf, build the
attention plan, run one decode step, apply the branch controller and record
PerfMetrics; stop on the controller's signal or at max_gen_len.  deft_tpu's
decode windows and replay slabs (:189-525), built for its remote TPU link,
are not ported.

Steps whose tokens the host need not read are chained on the device, as
deft_tpu chains them (DeferredSelect :23, resolve_backfills :51, the chain
:526-717), on torch's current stream:

- iterations outside the workload's ``structural_iters`` append each leaf's
  greedy token: the step computes the top-1 only ("greedy"), is enqueued
  without waiting, and its device ids are the next step's q tokens; the
  leaves take placeholder tokens whose values (and logprobs) are backfilled
  from the step's copy to pinned host memory later;
- structural iterations in ``logits_free_iters`` read no logits values.  A
  workload with ``supports_deferred`` (ToT replay, the random tree) records
  each appended token as (row, top-K column) of the step's view
  (DeferredSelect), the step computes the top-K, and the next step gathers
  its q tokens from those device ids; without it (speculative decoding's
  accept schedule) the step skips the lm_head ("skip");
- the other iterations read logits on the host ("topk"): the step waits,
  and outstanding backfills land before the workload runs.

The host waits for the device every ``SYNC_PERIOD`` (8) chained steps and
once at the end (the drain), each wait charged to the forward time of the
step that waits: a chained step's forward time is its enqueue time, so
``decode_latency`` and TPOT sum enqueue times and waits on chained runs, as
in deft_tpu.  A workload that declares none of the three attributes runs
every step with host logits (the per-step path).

Each step charges the runner's attention estimate (``last_attn_estimate``,
runner.py's per-bucket microbench; deft_tpu :676-697) to ``attn_mem`` and
``attn_comp`` and marks the metrics ``attn_is_estimate``; without one the
fields take GlobalTimer's ``attn_mem`` / ``attn_comp``, which nothing
starts, so 0 as in deft_tpu.  On a chained run the microbench runs only
at a bucket change, and waits there once.

Every 60 s of a long run a progress line goes to stderr and, where the
metrics have an output file, a ``.partial`` dump (deft_tpu :270-296).

A ``tracer`` (obs/tracing.py) brackets the prefill, each step's alloc and
plan build, and each decode step with the spans deft_tpu names
(generate.py:81-88, :106, :540, :587): ``prefill``, ``plan_build`` and
``decode_step``.
"""

from __future__ import annotations

import sys
import time
from typing import Optional

import numpy as np

from deft_tpu_torch.obs import GlobalTimer, PerfMetrics, Tracer
from deft_tpu_torch.runtime.modes import ForwardMode
from deft_tpu_torch.runtime.runner import ModelRunner

# chained steps between two host waits (deft_tpu generate.py:186)
SYNC_PERIOD = 8
# seconds between two progress beats (deft_tpu generate.py:278)
HEARTBEAT_S = 60.0


class DeferredSelect:
    """A structural step's token selections, made without reading logits
    values (deft_tpu generate.py:23): each appended token is recorded as
    (row, top-K column) of the step's LogitsView.  The loop turns the
    records into the next step's q tokens, gathered on the device
    (forward_tree_decode's q_select), and into backfills of the
    placeholders from the view's host copy later.  A workload that opts in
    (``supports_deferred``) copies no token values in the iterations it
    defers (branch and cut are fine; merge_nodes and output_branch copy, so
    those iterations stay out of its ``logits_free_iters``)."""

    def __init__(self, k: int):
        self.k = k
        self.backfills = []  # (node, token_index, row, col) records
        self.qsrc = {}       # leaf id -> (row, col)

    def append(self, leaf, row: int, col: int) -> None:
        """leaf.append_token(ids[row, col]), deferred."""
        assert col < self.k, f"column {col} >= step top-K {self.k}"
        leaf.append_token(0)
        self.backfills.append((leaf, len(leaf.token_ids) - 1, row, col))
        self.qsrc[leaf.id] = (row, col)


def resolve_backfills(pending) -> None:
    """Write the token ids and logprobs of queued steps into their
    placeholders (deft_tpu generate.py:51).  ``pending`` is a list of
    (LogitsView, [(node, token_index, row, col)]): records, since two
    leaves may select the same (row, column) of one view.  Shared by
    tree_generate and BatchedEngine."""
    for view, fills in pending:
        ids, vals = view.ids, view.vals
        for node, ti, q, col in fills:
            node.token_ids[ti] = int(ids[q, col])
            node.cumulative_logprob += float(np.log(vals[q, col]))
    pending.clear()


def timed_wait(view) -> float:
    """Wait for ``view``'s host copy (runner.host_wait); returns the
    seconds waited, which the caller charges to a step's forward time."""
    t0 = time.perf_counter()
    view.wait()
    return time.perf_counter() - t0


def tree_generate(
    model: ModelRunner,
    mode: ForwardMode,
    tokenizer,
    prompt_ids,
    max_seq_len: int,
    width: int,
    depth: int,
    branch_controller,
    tree_template=None,
    output_file: Optional[str] = None,
    perf_metrics: Optional[PerfMetrics] = None,
    print_branches: bool = False,
    rng=None,
    seed: Optional[int] = None,
    tracer: Optional[Tracer] = None,
) -> PerfMetrics:
    """Generate a tree from ``prompt_ids``; finished branches end up in
    ``model.tree.all_finished_seqs`` (read them before the next run).
    ``rng`` (a np.random.RandomState) and ``seed``, when given, are passed
    to every call of the branching function (sampled simple_tree,
    random_tree); otherwise the workloads' own defaults hold.  ``tracer``:
    the spans of a torch.profiler session (run inside tracer.session())."""
    if tracer is None:
        tracer = Tracer(None)
    if perf_metrics is None:
        perf_metrics = PerfMetrics(output_file)
    prompt_ids = [int(t) for t in prompt_ids]
    prompt_len = len(prompt_ids)
    max_gen_len = max_seq_len - prompt_len
    assert max_gen_len > 0, "max_seq_len must exceed prompt length"

    branch_controller.set_execution_graph(tree_template)
    # K+V bytes per token over all layers, as deft_tpu counts them
    # (generate.py:98-103): 2 bytes an element whatever the dtype, or for
    # int8 pools 1 byte plus the fp32 (token, head) scale spread over D
    kv_elem = 2.0
    if model.kv_quantized:
        kv_elem = 1.0 + 4.0 / model.cfg.head_dim
    kv_bytes_per_tok = int(model.cfg.num_kv_heads * model.cfg.head_dim * 2
                           * kv_elem) * model.cfg.num_layers

    extra = {k: v for k, v in (("rng", rng), ("seed", seed)) if v is not None}
    start_time = time.perf_counter()
    with tracer.span("prefill"):
        logits = model.forward_prefill(prompt_ids)
    stop = branch_controller.apply_branching(
        model=model, iter=0, max_gen_len=max_gen_len, width=width,
        depth=depth, logits=logits,
        execution_graph=branch_controller.tree_templates, **extra,
    )
    perf_metrics.TTFT = (time.perf_counter() - start_time) * 1000

    # iterations outside structural_iters append each leaf's greedy token
    # and chain on the device; structural ones in logits_free_iters read no
    # logits values (deferred selection, or no lm_head at all)
    fn = branch_controller.branching_function
    template = branch_controller.tree_templates
    structural_fn = getattr(fn, "structural_iters", None)
    structural = (structural_fn(template, max_gen_len)
                  if structural_fn is not None else None)
    logits_free_fn = getattr(fn, "logits_free_iters", None)
    logits_free = (logits_free_fn(template, max_gen_len)
                   if logits_free_fn is not None else frozenset())
    supports_deferred = getattr(fn, "supports_deferred", False)

    pending = []  # (LogitsView, [(node, token_index, row, col)])
    # where the next step's q tokens come from: None, the plan (host token
    # values); ("ids", view), view's greedy ids in the same row order;
    # ("sel", view, qsrc), view's top-K ids gathered by leaf -> (row, col)
    chain = None
    it = 0
    beat = time.perf_counter()
    while not stop and it + 1 < max_gen_len:
        it += 1
        now = time.perf_counter()
        if now - beat > HEARTBEAT_S:
            beat = now
            print(f"[tree_generate] iter {it}/{max_gen_len} "
                  f"tokens={model.tree.get_tree_token_number()}",
                  file=sys.stderr, flush=True)
            if perf_metrics.output_file is not None:
                perf_metrics.generated_len = (
                    model.tree.get_tree_token_number() - prompt_len)
                perf_metrics.update_decode_latency()
                perf_metrics.update_attention_latency()
                perf_metrics.compute_tpot()
                perf_metrics.dump_partial()
        for name in ("prepare", "branch", "attn_mem", "attn_comp", "alloc",
                     "tree_metadata"):
            GlobalTimer.reset(name)
        step_start = time.perf_counter()
        if chain is None and pending:
            # the plan carries host token values: the placeholders land first
            resolve_backfills(pending)
        if chain is not None and chain[0] == "sel" and any(
                leaf_id not in chain[2] for leaf_id in model.tree.leaves):
            # a live leaf made no deferred selection last step (deft_tpu
            # generate.py:531-537): its token comes from the host
            resolve_backfills(pending)
            chain = None

        GlobalTimer.start("prepare")
        with tracer.span("plan_build"):
            GlobalTimer.start("alloc")
            model.tree.alloc()
            GlobalTimer.stop("alloc")
            GlobalTimer.start("tree_metadata")
            plan = model.build_plan(mode)
            GlobalTimer.stop("tree_metadata")
        GlobalTimer.stop("prepare")

        is_struct = structural is None or it in structural
        needs_logits = is_struct and it not in logits_free
        if not is_struct:
            logits_kind = "greedy"
        elif not needs_logits and not supports_deferred:
            logits_kind = "skip"
        else:
            logits_kind = "topk"
        override = select = None
        if chain is not None and chain[0] == "ids":
            override = chain[1].greedy_ids_device
        elif chain is not None:
            _, prev, qsrc = chain
            rows = np.zeros(plan.l_pad, np.int32)  # pad rows take (0, 0)
            cols = np.zeros(plan.l_pad, np.int32)
            for leaf_id, q in model.tree.leaf_to_q.items():
                rows[q], cols[q] = qsrc[leaf_id]
            select = (prev.ids_device, rows, cols)
        with tracer.span("decode_step"):
            logits, fwd_t = model.forward_tree_decode(
                mode, plan, q_tokens_override=override, q_select=select,
                block=needs_logits, logits_kind=logits_kind)

        # analytic KV / mask IO accounting (per layer x layers)
        if mode.is_sequential:
            perf_metrics.KV_IO += plan.total_kv * kv_bytes_per_tok
        elif mode is ForwardMode.UNPAGED_MEDUSA:
            # the dense masked baseline: KV, materialised scores, mask and
            # softmax intermediates, per layer
            for _ in range(model.cfg.num_layers):
                perf_metrics.update_dense_tree_attn_IO(
                    plan.n_leaves, plan.n_tokens,
                    model.cfg.num_kv_heads * model.cfg.head_dim,
                    model.cfg.num_q_heads)
        else:
            perf_metrics.KV_IO += plan.n_tokens * kv_bytes_per_tok
            perf_metrics.Mask_IO += plan.n_tokens * 8 * model.cfg.num_layers

        GlobalTimer.start("branch")
        if is_struct:
            deferred = (DeferredSelect(logits.k)
                        if not needs_logits and supports_deferred else None)
            if needs_logits or (pending and deferred is None):
                # backfills land before the tree changes (speculative
                # decoding queues none, so its steps never wait here)
                resolve_backfills(pending)
            stop = branch_controller.apply_branching(
                model=model, iter=it, max_gen_len=max_gen_len, width=width,
                depth=depth, logits=logits,
                execution_graph=branch_controller.tree_templates,
                deferred=deferred, **extra,
            )
            if deferred is not None and deferred.qsrc:
                logits.fetch_async()
                pending.append((logits, deferred.backfills))
                chain = ("sel", logits, deferred.qsrc)
            else:
                chain = None
            if not needs_logits and it % SYNC_PERIOD == 0:
                fwd_t += timed_wait(logits)
        else:
            # greedy append: placeholders now, values from the copy later
            tree = model.tree
            backfills = []
            for leaf in tree.leaves.values():
                leaf.append_token(0)
                backfills.append((leaf, len(leaf.token_ids) - 1,
                                  tree.leaf_to_q[leaf.id], 0))
            logits.fetch_async()
            pending.append((logits, backfills))
            chain = ("ids", logits)
            if it % SYNC_PERIOD == 0:
                fwd_t += timed_wait(logits)
        GlobalTimer.stop("branch")
        attn_est = model.last_attn_estimate
        if attn_est:
            perf_metrics.attn_is_estimate = True
        perf_metrics.update(
            iter_time=(time.perf_counter() - step_start) * 1000,
            prepare=GlobalTimer.get("prepare"),
            forward=fwd_t * 1000,
            branch=GlobalTimer.get("branch"),
            attn_mem=(attn_est[0] * 1000 if attn_est
                      else GlobalTimer.get("attn_mem")),
            attn_comp=(attn_est[1] * 1000 if attn_est
                       else GlobalTimer.get("attn_comp")),
            alloc=GlobalTimer.get("alloc"),
            tree_metadata=GlobalTimer.get("tree_metadata"),
        )

    if it:
        # the drain: the last enqueued steps' device time, charged to the
        # last step's forward time before the e2e clock stops
        waited = timed_wait(logits)
        perf_metrics.forward_per_iter[-1] += waited * 1000
        resolve_backfills(pending)

    perf_metrics.update_e2e_latency((time.perf_counter() - start_time) * 1000)
    perf_metrics.prompt_len = prompt_len
    perf_metrics.generated_len = model.tree.get_tree_token_number() - prompt_len
    perf_metrics.update_decode_latency()
    perf_metrics.update_attention_latency()
    perf_metrics.compute_tpot()
    perf_metrics.dump()
    if print_branches:
        model.tree.print_finished_branches(tokenizer)
    model.tree.free()
    model.token_to_kv_pool.clear()
    model.req_to_token_pool.clear()
    return perf_metrics
