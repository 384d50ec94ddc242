"""Batched multi-tree decoding (continuous batching).

Port of deft_tpu/runtime/batched.py: _RowWindowView (:23), Request (:64),
BatchedEngine (:96; add_requests :130, feed :119, step :169, run :268) and
_TreeFacade (:276), on the per-step path.  N requests, each with its own
tree, share the runner's KV pools; they are admitted together by one ragged
prefill (runner.forward_prefill_batch, kernel B8), and every step decodes
all trees with one multi-tree plan (plan/multi.py) through the decode
kernels; each request's branch controller sees its own row window of the
logits.  Requests join (feed) and finish between steps.

A step in which no request makes a structural decision takes deft_tpu's
all-greedy fast path (batched.py:170-250): it computes the top-1 only, is
enqueued without waiting, takes the previous all-greedy step's device ids
as its q tokens, and gives every leaf a placeholder token, backfilled from
the step's host copy at the next admission or structural step
(runtime/generate.py resolve_backfills); the host waits every
DEFT_SYNC_PERIOD (8) such steps.
Other steps read their logits on the host.  Each tree's queued merge copies
(speculative decoding) land before its alloc (batched.py:190).  Node mode
runs on the multi-tree flatten plan, as in deft_tpu (:101, :209-212);
node-aligned multi-tree plans are ROADMAP A6.

On a (dp, sp, tp) grid (``ModelRunner(mesh=...)``) every rank runs this
same engine: it admits the same requests in the same order and branches
on the same joined logits, so the ranks' allocators, trees and plans stay
in step; the admission's ragged prefill runs B8 on the rank's heads and
each step the runner's sharded AttnFns (parallel/engine.py,
parallel/seq_engine.py), as deft_tpu's engine runs under its mesh.
"""

from __future__ import annotations

from typing import List, Optional

from deft_tpu_torch.core.tree import TreeCache
from deft_tpu_torch.plan.multi import build_multi_flatten_plan, build_multi_seq_plan
from deft_tpu_torch.runtime.generate import resolve_backfills, sync_period
from deft_tpu_torch.runtime.modes import ForwardMode
from deft_tpu_torch.runtime.runner import LogitsView, ModelRunner, packs_heads


class _RowWindowView:
    """LogitsView proxy exposing rows [off, off + n) of a global view."""

    def __init__(self, base: LogitsView, off: int, n: int):
        self._base = base
        self._off = off
        self._n = n

    @property
    def k(self) -> int:
        return self._base.k

    @property
    def vals(self):
        return self._base.vals[self._off:self._off + self._n]

    @property
    def ids(self):
        return self._base.ids[self._off:self._off + self._n]

    def topk(self, row: int, k: int):
        return self._base.topk(self._off + row, k)

    def argmax(self):
        return (self._base.ids[self._off:self._off + self._n, 0],
                self._base.vals[self._off:self._off + self._n, 0])


class Request:
    """One in-flight generation: a tree and its branching policy."""

    def __init__(self, prompt_ids, branch_controller, max_seq_len: int,
                 width: int = 4, depth: int = 10, template=None):
        self.prompt_ids = [int(t) for t in prompt_ids]
        self.controller = branch_controller
        self.controller.set_execution_graph(template)
        self.max_seq_len = max_seq_len
        self.width = width
        self.depth = depth
        self.tree: Optional[TreeCache] = None
        self.iter = 0
        self.done = False
        self.finished_seqs: list = []  # BranchSequence outputs, kept past free
        # iterations where the policy makes structural decisions (None:
        # every iteration); the others need each leaf's top-1 only
        fn = getattr(branch_controller, "branching_function", None)
        s = getattr(fn, "structural_iters", None)
        self.structural = (s(branch_controller.tree_templates,
                             max_seq_len - len(self.prompt_ids))
                           if s is not None else None)

    @property
    def max_gen(self) -> int:
        return self.max_seq_len - len(self.prompt_ids)

    def is_structural(self, it: int) -> bool:
        return (self.structural is None or it in self.structural
                or it + 1 >= self.max_gen)


class BatchedEngine:
    """Drives several Requests through the runner's shared pools, one
    multi-tree decode step per global iteration."""

    def __init__(self, runner: ModelRunner,
                 mode: ForwardMode = ForwardMode.TREE_DECODE_FLATTEN):
        if mode.plan_kind not in ("flatten", "node", "seq"):
            raise ValueError(f"batched {mode.name}: the engine takes flatten, "
                             "node or seq modes (deft_tpu batched.py:101)")
        self.runner = runner
        self.mode = mode
        self.active: List[Request] = []
        self.waiting: List[Request] = []  # feed() queue, admitted between steps
        # the all-greedy fast path: placeholders waiting for their values,
        # the last all-greedy step's view (the next step's q tokens) and
        # the steps enqueued since the host last waited
        self._pending: list = []  # (view, [(node, token_index, row, col)])
        self._chain = None
        self._steps_since_wait = 0

    def add_request(self, req: Request) -> None:
        """Admit one request (see add_requests)."""
        self.add_requests([req])

    def feed(self, reqs: List[Request]) -> None:
        """Queue requests for admission at the next step boundary; step()
        admits the whole queue with one ragged prefill."""
        self.waiting.extend(reqs)

    def add_requests(self, reqs: List[Request]) -> None:
        """Admit requests with ONE ragged prefill forward: every prompt's KV
        lands in the shared pools at once, then each request's controller
        branches on its own row of the batched logits."""
        if not reqs:
            return
        # the placeholders land and the chain ends: admission changes the
        # rows of the next step
        resolve_backfills(self._pending)
        self._chain = None
        r = self.runner
        for req in reqs:
            req.tree = TreeCache(r.token_to_kv_pool, r.req_to_token_pool,
                                 r.tree_index_pool)
        view = r.forward_prefill_batch([req.prompt_ids for req in reqs],
                                       [req.tree for req in reqs])
        for i, req in enumerate(reqs):
            req.done = req.controller.apply_branching(
                model=_TreeFacade(r, req.tree), iter=0, max_gen_len=req.max_gen,
                width=req.width, depth=req.depth, logits=_RowWindowView(view, i, 1),
                execution_graph=req.controller.tree_templates)
            req.iter = 1
            # tree_generate's loop bound (range(1, max_gen)): a request with
            # max_gen <= 1 is finished after iteration 0
            if req.done or req.iter >= req.max_gen:
                self._finish(req)
            else:
                self.active.append(req)

    @staticmethod
    def _finish(req: Request) -> None:
        req.done = True
        req.finished_seqs = list(req.tree.all_finished_seqs)
        req.tree.free()

    def build_plan(self, trees: List[TreeCache]):
        """The multi-tree plan of this step, with deft_tpu's batched rules
        (batched.py:192-212): seq plans ask for the paged layout where the
        head dim packs (128 % D == 0), flatten and node modes take the
        multi-tree flatten plan, and int8 pools take 128-token segments at
        a waste limit of 3."""
        r = self.runner
        a = r.ecfg.attention
        kw = dict(q_per_kv=r.cfg.q_per_kv, block_len=a.block_len,
                  min_token_bucket=r.ecfg.min_token_bucket)
        if r.kv_quantized:
            kw.update(seg_len=(128,), waste_limit=3.0)
        if self.mode.plan_kind == "seq":
            return build_multi_seq_plan(
                trees, want_paged=packs_heads(r.cfg.head_dim), **kw)
        return build_multi_flatten_plan(trees, **kw)

    def step(self) -> None:
        """One global decode step across every active tree (admitting the
        feed() queue first).  When no active request's iteration is
        structural, the step only enqueues (the all-greedy fast path)."""
        if self.waiting:
            reqs, self.waiting = self.waiting, []
            self.add_requests(reqs)
            if not self.active:
                return
        if not self.active:
            raise RuntimeError("step() with no active or waiting request")
        r = self.runner
        all_greedy = not any(req.is_structural(req.iter) for req in self.active)
        trees = [req.tree for req in self.active]
        for t in trees:
            r.apply_kv_copies(t)  # merge compactions (spec decode)
            t.alloc()
        plan = self.build_plan(trees)
        override = (self._chain.greedy_ids_device if self._chain is not None
                    else None)
        view, _ = r.forward_tree_decode(
            self.mode, plan, q_tokens_override=override, block=not all_greedy,
            logits_kind="greedy" if all_greedy else "topk")
        if all_greedy:
            backfills = []
            for tree, off in zip(trees, plan.leaf_offsets):
                for leaf in tree.leaves.values():
                    leaf.append_token(0)
                    backfills.append((leaf, len(leaf.token_ids) - 1,
                                      off + tree.leaf_to_q[leaf.id], 0))
            view.fetch_async()
            self._pending.append((view, backfills))
            self._chain = view
            for req in self.active:
                req.iter += 1
            self._steps_since_wait += 1
            if self._steps_since_wait >= sync_period():
                view.wait()
                self._steps_since_wait = 0
            return
        # a structural step: the placeholders land before any controller
        # reads its window or changes its tree
        resolve_backfills(self._pending)
        self._chain = None
        still = []
        for req, off in zip(self.active, plan.leaf_offsets):
            sub = _RowWindowView(view, off, len(req.tree.leaves))
            req.done = req.controller.apply_branching(
                model=_TreeFacade(self.runner, req.tree), iter=req.iter,
                max_gen_len=req.max_gen, width=req.width, depth=req.depth,
                logits=sub, execution_graph=req.controller.tree_templates,
            ) or req.iter + 1 >= req.max_gen
            req.iter += 1
            if req.done:
                self._finish(req)
            else:
                still.append(req)
        self.active = still

    def run(self, max_steps: int = 10_000) -> int:
        """Step until every request finished (or max_steps); returns the
        number of steps taken."""
        steps = 0
        while (self.active or self.waiting) and steps < max_steps:
            self.step()
            steps += 1
        resolve_backfills(self._pending)
        return steps


class _TreeFacade:
    """The 'model' the branch workloads expect (they use model.tree only)."""

    def __init__(self, runner: ModelRunner, tree: TreeCache):
        self.runner = runner
        self.tree = tree
