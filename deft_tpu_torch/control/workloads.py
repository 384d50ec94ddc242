"""The branching workloads.

Port of deft_tpu/control/workloads.py: simple_tree (:20, greedy or sampled
through runtime/sampling.py), practical_tree (:60, ToT template replay),
speculative_decoding (:151, mock Medusa), beam_search (:210, with
_path_logprob :202), random_tree (:255), their ``structural_iters``,
``logits_free_iters`` and ``supports_deferred`` attributes, and the
reference-name aliases (:320-323).  Policies consume a LogitsView whose rows
are ordered by the tree's current leaf_to_q.

practical_tree and random_tree decide on the host which leaf branches or is
pruned; only the tokens come from the step.  Given ``deferred`` (a
runtime/generate.py DeferredSelect), they record each appended token as
(row, top-K column) of the view instead of reading it, so the generation
loop gathers the next step's q tokens on the device and backfills the
values later (deft_tpu workloads.py:60-148, :255-316).  Their output
iterations copy token values and never take ``deferred``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from deft_tpu_torch.data.loader import ExecuteTree
from deft_tpu_torch.runtime.sampling import sample_token


def simple_tree(model, iter, max_gen_len, width, depth, logits,
                execution_graph=None, sampling_params=None, rng=None,
                **kw) -> bool:
    """Few-shot prompting: branch the root into `width` top-k continuations at
    prefill, then append per leaf — greedy by default, or sampled through
    ``sampling_params`` (runtime/sampling.py) when provided."""
    tree = model.tree
    if iter + 1 == max_gen_len:
        for leaf in list(tree.leaves.values()):
            tree.output_branch(leaf)
        return True
    if iter == 0:
        probs, ids = logits.topk(0, width)
        children = tree.branch(tree.root, width)
        for cnt, child in enumerate(children):
            child.append_token(int(ids[cnt]), logprob=float(np.log(probs[cnt])))
    elif sampling_params is not None:
        if rng is None:
            rng = np.random.RandomState(iter)
        for leaf in list(tree.leaves.values()):
            q = tree.leaf_to_q[leaf.id]
            tok, p = sample_token(logits, q, sampling_params, rng)
            leaf.append_token(tok, logprob=float(np.log(p)))
    else:
        ids, probs = logits.argmax()
        for leaf in list(tree.leaves.values()):
            q = tree.leaf_to_q[leaf.id]
            leaf.append_token(int(ids[q]), logprob=float(np.log(probs[q])))
    return False


def _simple_tree_structural(template, max_gen_len):
    return {0, max_gen_len - 1}


simple_tree.structural_iters = _simple_tree_structural


def practical_tree(model, iter, max_gen_len, width, depth, logits,
                   execution_graph: Optional[ExecuteTree] = None,
                   deferred=None, **kw) -> bool:
    """Multi-step (ToT) reasoning: replay an ExecuteTree's branch/prune
    schedule; greedy generation on untouched leaves.  With ``deferred``,
    each appended token is recorded as (row, top-K column) and read by
    nothing on the host."""
    assert execution_graph is not None
    tree = model.tree
    branch_pairs = execution_graph.branch_record.get(iter, {})
    prune_nodes = execution_graph.prune_record.get(iter, [])
    stop = False
    ROOT_ID = 0
    if ROOT_ID in prune_nodes:
        # output iterations copy token values: never deferred
        assert deferred is None, "output iteration must not be deferred"
        stop = True
        for leaf in list(tree.leaves.values()):
            tree.output_branch(leaf)

    leaves = [tree.root] if iter == 0 else list(tree.leaves.values())
    greedy_ids = greedy_probs = None
    for leaf in leaves:
        l_id = leaf.id
        if l_id in branch_pairs:
            children_ids = branch_pairs[l_id]
            w = len(children_ids)
            assert w > 0
            q_idx = 0 if iter == 0 else tree.leaf_to_q[l_id]
            children = tree.branch(tree.nodes[l_id], w)
            if deferred is not None:
                for c, child in enumerate(children):
                    deferred.append(child, q_idx, c)
                continue
            probs, ids = logits.topk(q_idx, w)
            for c, child in enumerate(children):
                child.append_token(int(ids[c]), logprob=float(np.log(probs[c])))
        elif l_id in prune_nodes:
            tree.cut(tree.nodes[l_id], record_deleted=True)
        else:
            # iter 0 == prefill: one logits row for the root, leaf_to_q not
            # built yet (templates may run the root greedily before branching)
            q = 0 if iter == 0 else tree.leaf_to_q[leaf.id]
            if deferred is not None:
                deferred.append(leaf, q, 0)
                continue
            if greedy_ids is None:
                greedy_ids, greedy_probs = logits.argmax()
            leaf.append_token(
                int(greedy_ids[q]), logprob=float(np.log(greedy_probs[q]))
            )
    if iter == max_gen_len - 1:
        assert deferred is None, "output iteration must not be deferred"
        for leaf in list(tree.leaves.values()):
            tree.output_branch(leaf)
        stop = True
    return stop


def _practical_tree_structural(template, max_gen_len):
    s = {0, max_gen_len - 1}
    if template is not None:
        s |= set(template.branch_record) | set(template.prune_record)
    return s


def _practical_tree_logits_free(template, max_gen_len):
    """Every replay iteration except the ones that copy token values
    (output_branch at root-prune / final iter): which leaf branches or
    prunes is fixed by the template, only the tokens come from the step, so
    their selection is deferred to the device."""
    out_iters = {max_gen_len - 1}
    if template is not None:
        for it, nodes in template.prune_record.items():
            if 0 in nodes:
                out_iters.add(it)
    return frozenset(range(1, max_gen_len)) - out_iters


practical_tree.structural_iters = _practical_tree_structural
practical_tree.logits_free_iters = _practical_tree_logits_free
practical_tree.supports_deferred = True


def speculative_decoding(model, iter, max_gen_len, width, depth, logits,
                         execution_graph: Optional[ExecuteTree] = None,
                         **kw) -> bool:
    """Mock Medusa: prefill branches the root into a token tree; each step
    "accepts" accepted_len_list[iter] leaves by squeezing their KV into the
    root, then resets every leaf's KV — exercising merge/reset on the KV pool
    exactly like the reference mock (branch_func_example.py:374-442)."""
    assert execution_graph is not None
    assert execution_graph.accepted_len_list is not None
    tree = model.tree
    last_step = len(execution_graph.accepted_len_list)
    token_tree_size = execution_graph.node_num
    if iter == last_step:
        for leaf in list(tree.leaves.values()):
            tree.output_branch(leaf)
        return True
    verified_num = execution_graph.accepted_len_list[iter]
    if iter == 0:
        probs, ids = logits.topk(0, token_tree_size)
        children = tree.branch(tree.root, token_tree_size)
        for cnt, child in enumerate(children):
            child.append_token(int(ids[cnt]), logprob=float(np.log(probs[cnt])))
    else:
        leaves = list(tree.leaves.values())
        assert len(leaves) == token_tree_size
        kv_before = tree.root.kv_len
        for i in range(min(verified_num, len(leaves))):
            tree.merge_nodes(tree.root, leaves[i], prune_b=False)
        kv_after = tree.root.kv_len
        diff = kv_after - kv_before
        for leaf in leaves:
            tree.reset_node_KV(leaf, diff)
        assert kv_before + verified_num == kv_after
        # merge/reset bypass per-leaf page-table maintenance
        tree.sync_page_table()
    return False


def _speculative_logits_free(template, max_gen_len):
    """Every loop iteration is structural (merge/reset) but reads no logits
    values: the accept schedule is fixed by the template and leaves keep
    their iter-0 tokens (reference mock semantics,
    branch_func_example.py:374-442).  The generation loop skips the
    lm_head of these steps."""
    return range(1, max_gen_len)


speculative_decoding.logits_free_iters = _speculative_logits_free


def _path_logprob(leaf) -> float:
    total, node = 0.0, leaf
    while node is not None:
        total += node.cumulative_logprob
        node = node.parent
    return total


def beam_search(model, iter, max_gen_len, width, depth, logits,
                execution_graph=None, **kw) -> bool:
    """Real beam search over the tree (beam size = width): each step expands
    every live beam with its top-k continuations, keeps the global top
    `width` by cumulative logprob, branching/cutting the tree to match."""
    tree = model.tree
    beam = width
    if iter + 1 == max_gen_len:
        for leaf in list(tree.leaves.values()):
            tree.output_branch(leaf)
        return True
    if iter == 0:
        probs, ids = logits.topk(0, beam)
        for c, child in enumerate(tree.branch(tree.root, beam)):
            child.append_token(int(ids[c]), logprob=float(np.log(probs[c])))
        return False

    leaves = list(tree.leaves.values())
    cands = []  # (score, leaf_idx, token, logprob)
    for idx, leaf in enumerate(leaves):
        q = tree.leaf_to_q[leaf.id]
        probs, ids = logits.topk(q, min(beam, logits.k))
        base = _path_logprob(leaf)
        for p, t in zip(probs, ids):
            lp = float(np.log(p))
            cands.append((base + lp, idx, int(t), lp))
    cands.sort(key=lambda c: -c[0])
    top = cands[:beam]

    for idx, leaf in enumerate(leaves):
        sel = [(t, lp) for (_, i, t, lp) in top if i == idx]
        if not sel:
            # record pruned tokens so generated_len counts the work the
            # decode steps actually did (TPOT comparability with the
            # template workloads, which also record)
            tree.cut(leaf, record_deleted=True)
        elif len(sel) == 1:
            leaf.append_token(sel[0][0], logprob=sel[0][1])
        else:
            for (t, lp), child in zip(sel, tree.branch(leaf, len(sel))):
                child.append_token(t, logprob=lp)
    assert len(tree.leaves) == min(beam, len(top))
    return False


def random_tree(model, iter, max_gen_len, width, depth, logits,
                execution_graph=None, rng=None, seed=0, deferred=None,
                **kw) -> bool:
    """Random branch/prune stress workload (the reference CLI lists a
    Random_Tree controller choice without shipping one).

    Reproducible by construction: with no explicit ``rng`` the stream is
    derived from (seed, iter), so a rerun with the same seed replays the
    same branch/prune schedule.  Pass a shared np.random.RandomState to
    correlate decisions across iterations instead.  The decisions are the
    rng's, known on the host, so with ``deferred`` the tokens are recorded
    as (row, top-K column) as in practical_tree."""
    if rng is None:
        rng = np.random.RandomState((seed * 1_000_003 + iter) & 0x7FFFFFFF)
    tree = model.tree
    if iter + 1 == max_gen_len:
        assert deferred is None, "output iteration must not be deferred"
        for leaf in list(tree.leaves.values()):
            tree.output_branch(leaf)
        return True
    if iter == 0:
        probs, ids = logits.topk(0, width)
        for c, child in enumerate(tree.branch(tree.root, width)):
            child.append_token(int(ids[c]), logprob=float(np.log(probs[c])))
        return False
    if deferred is None:
        ids, probs = logits.argmax()
    for leaf in list(tree.leaves.values()):
        q = tree.leaf_to_q[leaf.id]
        r = rng.rand()
        if r < 0.08 and len(tree.leaves) < width * 4:
            k = int(rng.randint(2, 4))
            children = tree.branch(leaf, k)
            if deferred is not None:
                for c, child in enumerate(children):
                    deferred.append(child, q, c)
                continue
            probs_k, ids_k = logits.topk(q, k)
            for c, child in enumerate(children):
                child.append_token(int(ids_k[c]),
                                   logprob=float(np.log(probs_k[c])))
        elif r > 0.96 and len(tree.leaves) > 2:
            tree.cut(leaf, record_deleted=True)
        elif deferred is not None:
            deferred.append(leaf, q, 0)
        else:
            leaf.append_token(int(ids[q]), logprob=float(np.log(probs[q])))
    return False


def _random_tree_logits_free(template, max_gen_len):
    return frozenset(range(1, max_gen_len - 1))


# no structural_iters: every iteration may branch/prune (rng decides)
random_tree.logits_free_iters = _random_tree_logits_free
random_tree.supports_deferred = True


# Reference-name aliases (branch_func_example.py).
example_branch_Func1_SimpleTree = simple_tree
example_branch_Func2_BeamSearch = beam_search
example_branch_Func3_FromTreeTemplate = practical_tree
example_branch_Func4_SpeculativeDecoding = speculative_decoding
