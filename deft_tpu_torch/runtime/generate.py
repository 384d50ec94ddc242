"""The tree-decoding generation loop, with deft_tpu's device chains, decode
windows and replayed spans.

Port of deft_tpu/runtime/generate.py:68 (tree_generate): prefill, then per
iteration alloc one KV slot per leaf, build the attention plan, run the
decode step, apply the branch controller and record PerfMetrics; stop on
the controller's signal or at max_gen_len.  An iteration takes one of
three paths, as in deft_tpu, all on torch's current stream:

- the record path (:189-254, :301-431; DEFT_REPLAY_EXEC, on by default,
  off on a grid and with retain_full_logits): an iteration that reads no
  logits values on the host (a greedy append, a deferred selection, a
  logits-free accept step) is packed and recorded, and the span of such
  iterations runs from plan slabs on the device
  (runner.execute_recorded) before the next iteration that reads logits,
  or at the end.  Greedy appends of a workload with ``supports_deferred``
  are recorded as top-K selections of column 0 (DEFT_REPLAY_UNIFORM, on
  by default), so its span is one uniform run.  The span's time is spread
  evenly over its records;
- the window path (:158-187, :255-268, :436-525; a workload with
  ``structural_iters``, plan patching and one device): up to WINDOW (8)
  greedy iterations in one plan bucket run from one upload
  (runner.forward_tree_decode_window), at most DEFT_PIPE_WINDOWS (1)
  windows in flight;
- the per-step path (:526-717): one step a call of forward_tree_decode,
  chained on the device where the host need not read its tokens
  (DeferredSelect :23, resolve_backfills :51):

  - iterations outside ``structural_iters`` append each leaf's greedy
    token: the step computes the top-1 only ("greedy"), is enqueued
    without waiting, and its device ids are the next step's q tokens; the
    leaves take placeholder tokens whose values (and logprobs) are
    backfilled from the step's copy to pinned host memory later;
  - structural iterations in ``logits_free_iters`` read no logits values.
    A workload with ``supports_deferred`` (ToT replay, the random tree)
    records each appended token as (row, top-K column) of the step's view
    (DeferredSelect), the step computes the top-K, and the next step
    gathers its q tokens from those device ids; without it (speculative
    decoding's accept schedule) the step skips the lm_head ("skip");
  - the other iterations read logits on the host ("topk"): the step
    waits, and outstanding backfills land before the workload runs.

  The host waits for the device every DEFT_SYNC_PERIOD (8) chained steps
  and once at the end (the drain), each wait charged to the forward time
  of the step that waits: a chained step's forward time is its enqueue
  time, so ``decode_latency`` and TPOT sum enqueue times and waits on
  chained runs, as in deft_tpu.  A workload that declares none of the
  three attributes runs every step with host logits.

``DEFT_REPLAY_EXEC=0`` leaves the record path (windows and per-step steps
remain); ``DEFT_REPLAY_EXEC=0 DEFT_PLAN_PATCH=0`` leaves the windows too
(the per-step chain).  KV_IO and Mask_IO are counted on every path as
deft_tpu counts them: UNPAGED_MEDUSA's dense model on the per-step path
only, the flatten mask on the other two.

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
``decode_step`` (a recorded step's plan_build when it is recorded, its
decode_step when its span runs), and a window's plan builds and dispatch
with ``plan_build_window`` and ``decode_window``.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional

import numpy as np

from deft_tpu_torch.core.kv_pool import DUMP_SLOT
from deft_tpu_torch.obs import GlobalTimer, PerfMetrics, Tracer
from deft_tpu_torch.plan import next_pow2
from deft_tpu_torch.runtime.modes import ForwardMode
from deft_tpu_torch.runtime.runner import ModelRunner, env_on

# seconds between two progress beats (deft_tpu generate.py:278)
HEARTBEAT_S = 60.0
# greedy iterations a decode window runs at most (deft_tpu generate.py:166)
WINDOW = 8


def sync_period() -> int:
    """Chained steps between two host waits: DEFT_SYNC_PERIOD, 8 unless
    set (deft_tpu generate.py:186); BatchedEngine's fast path reads it
    too."""
    return max(1, int(os.environ.get("DEFT_SYNC_PERIOD", "8")))


class _RecordView:
    """The view a recorded structural step hands its workload (deft_tpu
    generate.py:221): a workload on the record path reads no values, only
    the top-K width."""

    def __init__(self, k: int):
        self.k = k


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
    """Wait for ``view``'s host copy (runner.host_wait; a replayed span's
    chain view has none left to wait for); returns the seconds waited,
    which the caller charges to a step's forward time."""
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
    period = sync_period()
    pipe_depth = max(1, int(os.environ.get("DEFT_PIPE_WINDOWS", "1")))
    use_windows = (structural is not None and model._plan_patch
                   and model.mesh is None)
    replay = (env_on("DEFT_REPLAY_EXEC") and model.mesh is None
              and not model.retain_full_logits)
    uniform = env_on("DEFT_REPLAY_UNIFORM")

    def count_io(plan, dense: bool) -> None:
        """deft_tpu's analytic KV / mask IO of one step (generate.py
        :406-411, :495-503, :594-608): the dense masked baseline's only on
        its per-step path (``dense``)."""
        if mode.is_sequential:
            perf_metrics.KV_IO += plan.total_kv * kv_bytes_per_tok
        elif dense:
            for _ in range(model.cfg.num_layers):
                perf_metrics.update_dense_tree_attn_IO(
                    plan.n_leaves, plan.n_tokens,
                    model.cfg.num_kv_heads * model.cfg.head_dim,
                    model.cfg.num_q_heads)
        else:
            perf_metrics.KV_IO += plan.n_tokens * kv_bytes_per_tok
            perf_metrics.Mask_IO += plan.n_tokens * 8 * model.cfg.num_layers

    def timed_plan():
        """alloc one slot a leaf and build the step's plan, timed."""
        GlobalTimer.start("alloc")
        model.tree.alloc()
        GlobalTimer.stop("alloc")
        GlobalTimer.start("tree_metadata")
        plan = model.build_plan(mode)
        GlobalTimer.stop("tree_metadata")
        return plan

    pending = []  # (view, [(node, token_index, row, col)])
    # where the next step's q tokens come from: None, the plan (host token
    # values); ("ids", view), view's greedy ids in the same row order;
    # ("sel", view, qsrc), view's top-K ids gathered by leaf -> (row, col)
    chain = None
    rec = []         # the recorded span (runner.execute_recorded's records)
    rec_fills = []   # (record index, [(node, token_index, row, col)])
    rec_chain = None  # the chain inside the span: None, "ids", ("sel", qsrc)
    rec_prev = None  # the view the span's first record chains from
    rec_start = 0    # the metrics row of its first record
    windows = []     # decode windows in flight, oldest first
    pre_plan = None  # a plan built (and alloc'd) past a window's bucket

    def flush() -> None:
        """Run the recorded span, backfill its tokens, spread its time over
        its records evenly (deft_tpu generate.py:228-253), and chain on."""
        nonlocal chain, logits, rec_chain, rec_prev
        if not rec:
            return
        views, last, exec_s = model.execute_recorded(mode, rec, prev_view=rec_prev,
                                                     span=tracer.span)
        for i, fills in rec_fills:
            pending.append((views[i], fills))
        resolve_backfills(pending)
        per = exec_s * 1000 / len(rec)
        for j in range(rec_start, rec_start + len(rec)):
            perf_metrics.forward_per_iter[j] += per
            perf_metrics.iter_time[j] += per
        chain = (None if rec_chain is None else ("ids", last) if rec_chain == "ids"
                 else ("sel", last, rec_chain[1]))
        logits = last
        rec.clear()
        rec_fills.clear()
        rec_chain = rec_prev = None

    def drain_windows(keep: int) -> None:
        """Wait until at most ``keep`` windows are in flight; the wait is
        earlier windows' device time, charged to the last step's forward."""
        if len(windows) <= keep:
            return
        t0 = time.perf_counter()
        while len(windows) > keep:
            windows.pop(0).wait()
        if perf_metrics.forward_per_iter:
            perf_metrics.forward_per_iter[-1] += (time.perf_counter() - t0) * 1000

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
        is_struct = structural is None or it in structural
        needs_logits = is_struct and it not in logits_free

        # ---- the record path (deft_tpu generate.py:301-431): the step is
        # packed and recorded, to run with its span from slabs
        if replay and pre_plan is None and not needs_logits:
            if not rec:
                rec_prev = chain[1] if chain is not None else None
                rec_chain = (None if chain is None else "ids" if chain[0] == "ids"
                             else ("sel", chain[2]))
                rec_start = len(perf_metrics.iter_time)
            if isinstance(rec_chain, tuple) and any(
                    leaf_id not in rec_chain[1] for leaf_id in model.tree.leaves):
                # a live leaf made no deferred selection last step: the span
                # runs, and the plan packs host token values
                flush()
                resolve_backfills(pending)
                chain = rec_chain = rec_prev = None
                rec_start = len(perf_metrics.iter_time)
            GlobalTimer.start("prepare")
            with tracer.span("plan_build"):
                plan = timed_plan()
            buf, sizes, paged = model._pack_plan(mode, plan)
            pairs = model.tree.drain_kv_copies()
            if pairs is not None:
                n_pad = max(8, next_pow2(len(pairs[0])))
                padded = np.full((2, n_pad), DUMP_SLOT, np.int32)
                padded[0, :len(pairs[0])], padded[1, :len(pairs[1])] = pairs
                pairs = (padded[0], padded[1])
            if rec_chain is None:
                ovr = "none"
            elif rec_chain == "ids":
                ovr = "ids"
            else:
                rows = np.zeros(plan.l_pad, np.int32)
                cols = np.zeros(plan.l_pad, np.int32)
                for leaf_id, q in model.tree.leaf_to_q.items():
                    rows[q], cols[q] = rec_chain[1][leaf_id]
                buf = np.concatenate([buf, rows, cols])
                ovr = "select"
            GlobalTimer.stop("prepare")
            model.last_attn_estimate = (
                model._measure_attention_bucket(mode, plan, paged, sizes)
                if model.measure_attention else None)

            GlobalTimer.start("branch")
            if is_struct:
                deferred = DeferredSelect(model.topk_k) if supports_deferred else None
                stop = branch_controller.apply_branching(
                    model=model, iter=it, max_gen_len=max_gen_len, width=width,
                    depth=depth, logits=_RecordView(model.topk_k),
                    execution_graph=branch_controller.tree_templates,
                    deferred=deferred, **extra,
                )
                if deferred is not None and deferred.qsrc:
                    kind, fetch = "topk", True
                    rec_fills.append((len(rec), deferred.backfills))
                    rec_chain = ("sel", deferred.qsrc)
                    wtop = max(c for _, c in deferred.qsrc.values()) + 1
                else:
                    kind, fetch, rec_chain, wtop = "skip", False, None, 1
            else:
                tree, fills, qsrc = model.tree, [], {}
                for leaf in tree.leaves.values():
                    q = tree.leaf_to_q[leaf.id]
                    leaf.append_token(0)
                    fills.append((leaf, len(leaf.token_ids) - 1, q, 0))
                    qsrc[leaf.id] = (q, 0)
                if supports_deferred and uniform:
                    # uniform-select recording: the greedy append as a
                    # top-K step selecting column 0 (DEFT_REPLAY_UNIFORM)
                    kind, rec_chain = "topk", ("sel", qsrc)
                else:
                    kind, rec_chain = "greedy", "ids"
                fetch, wtop = True, 1
                rec_fills.append((len(rec), fills))
            GlobalTimer.stop("branch")
            count_io(plan, dense=False)
            rec.append(dict(buf=buf, sizes=sizes, paged=paged,
                            meta=model._plan_meta(plan, paged), override_kind=ovr,
                            logits_kind=kind, kv_pairs=pairs, fetch=fetch, wtop=wtop))
            attn_est = model.last_attn_estimate
            if attn_est:
                perf_metrics.attn_is_estimate = True
            perf_metrics.update(
                iter_time=(time.perf_counter() - step_start) * 1000,
                prepare=GlobalTimer.get("prepare"), forward=0.0,
                branch=GlobalTimer.get("branch"),
                attn_mem=attn_est[0] * 1000 if attn_est else 0.0,
                attn_comp=attn_est[1] * 1000 if attn_est else 0.0,
                alloc=GlobalTimer.get("alloc"),
                tree_metadata=GlobalTimer.get("tree_metadata"),
            )
            if stop:
                flush()
                break
            continue
        # a step that reads logits follows: the span runs first, its time
        # spread over its own records (deft_tpu also counts it in this
        # iteration's iter_time; here the iteration's clock starts after it)
        if rec:
            flush()
            step_start = time.perf_counter()

        # ---- the window path (deft_tpu generate.py:436-525): up to WINDOW
        # greedy iterations in one bucket run from one upload
        if (use_windows and pre_plan is None
                and (chain is None or chain[0] == "ids")):
            W = 0
            while (it + W < max_gen_len and W < WINDOW
                   and (it + W) not in structural and (it + W) not in logits_free):
                W += 1
            if W >= 2:
                tree = model.tree
                plans, fills_per, sig = [], [], None
                GlobalTimer.start("prepare")
                with tracer.span("plan_build_window"):
                    for _ in range(W):
                        plan = timed_plan()
                        _, sizes, paged = model._pack_plan(mode, plan)
                        if sig is None:
                            sig = (sizes, paged)
                        elif (sizes, paged) != sig:
                            # the bucket grew: this sub-step, alloc'd
                            # already, runs per step below
                            pre_plan = plan
                            break
                        plans.append(plan)
                        fills = []
                        for leaf in tree.leaves.values():
                            leaf.append_token(0)
                            fills.append((leaf, len(leaf.token_ids) - 1,
                                          tree.leaf_to_q[leaf.id], 0))
                        fills_per.append(fills)
                GlobalTimer.stop("prepare")
                Wd = len(plans)
                if Wd:
                    # earlier windows' waits come here: after this window's
                    # plans were built, before its dispatch
                    drain_windows(pipe_depth - 1)
                    q0 = chain[1].greedy_ids_device if chain is not None else None
                    with tracer.span("decode_window"):
                        view, fwd_t = model.forward_tree_decode_window(mode, plans, q0)
                        view.fetch_async()
                    windows.append(view)
                    for j, fills in enumerate(fills_per):
                        pending.append((view.step_view(j), fills))
                    chain, logits = ("ids", view), view
                    for plan in plans:
                        count_io(plan, dense=False)
                    iter_cost = (time.perf_counter() - step_start) * 1000
                    attn_est = model.last_attn_estimate
                    if attn_est:
                        perf_metrics.attn_is_estimate = True
                    for _ in range(Wd):
                        perf_metrics.update(
                            iter_time=iter_cost / Wd,
                            prepare=GlobalTimer.get("prepare") / Wd,
                            forward=fwd_t * 1000 / Wd,
                            attn_mem=attn_est[0] * 1000 if attn_est else 0.0,
                            attn_comp=attn_est[1] * 1000 if attn_est else 0.0,
                            alloc=GlobalTimer.get("alloc") / Wd,
                            tree_metadata=GlobalTimer.get("tree_metadata") / Wd,
                        )
                    it += Wd - 1
                    continue

        # ---- the per-step path
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
            if pre_plan is not None:
                plan, pre_plan = pre_plan, None  # built by a window's split
            else:
                plan = timed_plan()
        GlobalTimer.stop("prepare")
        drain_windows(pipe_depth - 1)

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
        count_io(plan, dense=mode is ForwardMode.UNPAGED_MEDUSA)

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
            if not needs_logits and it % period == 0:
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
            if it % period == 0:
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
        # the drain: the span still recorded, the windows in flight and the
        # last enqueued steps' device time, charged to the last step's
        # forward time before the e2e clock stops
        flush()
        drain_windows(0)
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
