"""The tree-decoding generation loop, per-step path.

Port of deft_tpu/runtime/generate.py:68 (tree_generate) on its per-step path
(:526-731): prefill, then per iteration alloc one KV slot per leaf, build the
attention plan, run one decode step, apply the branch controller and record
PerfMetrics; stop on the controller's signal or at max_gen_len.  The device
chains, decode windows and replay slabs of deft_tpu were built for its remote
TPU link and are not ported: every step here reads its logits on the host.

How much of the logits head a step computes follows deft_tpu's per-step rule
(:559-574), from the workload's ``structural_iters``, ``logits_free_iters``
and ``supports_deferred``: "greedy" (top-1) on iterations that only append
each leaf's greedy token, "skip" (no lm_head) on structural iterations that
read no logits (a speculative accept schedule), "topk" otherwise.  A
workload that supports deferred selection reads its tokens on the host here,
so its logits-free iterations take "topk".

A ``tracer`` (obs/tracing.py) brackets the prefill, each step's alloc and
plan build, and each decode step with the spans deft_tpu names
(generate.py:81-88, :106, :540, :587): ``prefill``, ``plan_build`` and
``decode_step``.
"""

from __future__ import annotations

import time
from typing import Optional

from deft_tpu_torch.obs import GlobalTimer, PerfMetrics, Tracer
from deft_tpu_torch.runtime.modes import ForwardMode
from deft_tpu_torch.runtime.runner import ModelRunner


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

    # iterations that branch or prune need the top-K; the others append
    # each leaf's greedy token and need the top-1 only; structural
    # iterations that read no logits values need none
    fn = branch_controller.branching_function
    template = branch_controller.tree_templates
    structural_fn = getattr(fn, "structural_iters", None)
    structural = (structural_fn(template, max_gen_len)
                  if structural_fn is not None else None)
    logits_free_fn = getattr(fn, "logits_free_iters", None)
    logits_free = (logits_free_fn(template, max_gen_len)
                   if logits_free_fn is not None else frozenset())
    supports_deferred = getattr(fn, "supports_deferred", False)

    it = 0
    while not stop and it + 1 < max_gen_len:
        it += 1
        for name in ("prepare", "branch", "alloc", "tree_metadata"):
            GlobalTimer.reset(name)
        step_start = time.perf_counter()
        GlobalTimer.start("prepare")
        with tracer.span("plan_build"):
            GlobalTimer.start("alloc")
            model.tree.alloc()
            GlobalTimer.stop("alloc")
            GlobalTimer.start("tree_metadata")
            plan = model.build_plan(mode)
            GlobalTimer.stop("tree_metadata")
        GlobalTimer.stop("prepare")

        if structural is not None and it not in structural:
            logits_kind = "greedy"
        elif it in logits_free and not supports_deferred:
            logits_kind = "skip"
        else:
            logits_kind = "topk"
        with tracer.span("decode_step"):
            logits, fwd_t = model.forward_tree_decode(mode, plan,
                                                      logits_kind=logits_kind)

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
        stop = branch_controller.apply_branching(
            model=model, iter=it, max_gen_len=max_gen_len, width=width,
            depth=depth, logits=logits,
            execution_graph=branch_controller.tree_templates, **extra,
        )
        GlobalTimer.stop("branch")
        perf_metrics.update(
            iter_time=(time.perf_counter() - step_start) * 1000,
            prepare=GlobalTimer.get("prepare"),
            forward=fwd_t * 1000,
            branch=GlobalTimer.get("branch"),
            alloc=GlobalTimer.get("alloc"),
            tree_metadata=GlobalTimer.get("tree_metadata"),
        )

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
