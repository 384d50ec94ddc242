"""The branching workloads.

Port of deft_tpu/control/workloads.py:20-57: ``simple_tree`` (few-shot
Simple_Tree) with its ``structural_iters``.  Sampled decoding and the other
workloads (practical_tree, speculative_decoding, beam_search, random_tree)
come in a later slice.  Policies consume a LogitsView whose rows are ordered
by the tree's current leaf_to_q.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from deft_tpu_torch.data.loader import ExecuteTree


def simple_tree(model, iter, max_gen_len, width, depth, logits,
                execution_graph: Optional[ExecuteTree] = None,
                sampling_params=None, **kw) -> bool:
    """Few-shot prompting: branch the root into `width` top-k continuations at
    prefill, then append each leaf's greedy token (deft_tpu
    control/workloads.py:20)."""
    if sampling_params is not None:
        raise NotImplementedError("sampled Simple_Tree is not ported yet")
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
    else:
        ids, probs = logits.argmax()
        for leaf in list(tree.leaves.values()):
            q = tree.leaf_to_q[leaf.id]
            leaf.append_token(int(ids[q]), logprob=float(np.log(probs[q])))
    return False


def _simple_tree_structural(template, max_gen_len):
    return {0, max_gen_len - 1}


simple_tree.structural_iters = _simple_tree_structural
