"""Port of deft_tpu/data/synthetic.py: synth_tot_tree (:24), synth_spec_tree
(:69), tot_tree_to_record, save_tot_json and save_spec_json, a copy with the
same behaviour (Python's random.Random(seed), so both packages give the same
templates).

Synthetic workload templates.

The reference ships Graph-of-Thoughts traces and Medusa accept-length records
as JSON assets (DeFT's dataset/generation/...); this module
generates statistically similar schedules programmatically (no assets
needed), in the same ExecuteTree schema the loaders produce — so the
Practical_Tree and Speculative_Decoding workloads run self-contained, and
``save_tot_json`` round-trips through ``load_trees`` for format parity tests.

Replay constraint: ExecuteTree node ids must match the ids TreeCache assigns
during replay (creation order).  The generator therefore branches at most one
node per iteration, which makes creation order unambiguous.
"""

from __future__ import annotations

import json
import random
from typing import Dict, List, Optional

from deft_tpu_torch.data.loader import ExecuteTree, ExecuteTreeNode


def synth_tot_tree(
    seed: int = 0,
    width: int = 4,
    max_leaves: int = 16,
    total_iters: int = 64,
    mean_run: int = 8,
    prompt: Optional[str] = None,
) -> ExecuteTree:
    """Random multi-step reasoning schedule: branch/prune events on a growing
    tree, one structural event per iteration.  width < 2 degenerates to a
    single chain (no branch events) instead of crashing randint(2, 1)."""
    rng = random.Random(seed)
    root = ExecuteTreeNode(0, start_offset=0)
    nodes = [root]
    # leaves in creation order (replay iterates leaves in insertion order)
    open_leaves: List[ExecuteTreeNode] = [root]

    t = 0
    while t < total_iters - 1:
        t += rng.randint(max(1, mean_run // 2), mean_run * 2)
        if t >= total_iters:
            break
        # one event: branch a leaf, or prune one (keep >= 1)
        do_prune = len(open_leaves) > 2 and rng.random() < 0.3
        if do_prune:
            victim = rng.choice(open_leaves[1:])
            victim.end_offset = t
            open_leaves.remove(victim)
        elif width >= 2 and len(open_leaves) + width - 1 <= max_leaves:
            parent = rng.choice(open_leaves)
            parent.end_offset = t
            open_leaves.remove(parent)
            w = rng.randint(2, width)
            for _ in range(w):
                child = ExecuteTreeNode(len(nodes), start_offset=t)
                parent.children.append(child)
                nodes.append(child)
                open_leaves.append(child)
    for leaf in open_leaves:
        leaf.end_offset = total_iters - 1
    for n in nodes:
        n.value = max(0, n.end_offset - n.start_offset)
    return ExecuteTree(root, nodes, prompt)


def synth_spec_tree(
    token_tree_size: int = 64,
    gen_len: int = 256,
    seed: int = 0,
    mean_accept: float = 2.0,
    prompt: Optional[str] = None,
) -> ExecuteTree:
    """Mock Medusa record: flat token tree + per-step accepted lengths
    (reference dataset/generation/Speculative_Decoding schema)."""
    rng = random.Random(seed)
    nodes = [ExecuteTreeNode(i) for i in range(token_tree_size)]
    for n in nodes[1:]:
        nodes[0].children.append(n)
    tree = ExecuteTree(nodes[0], nodes, prompt)
    accepts: List[int] = []
    total = 0
    while total < gen_len:
        a = min(max(1, int(rng.gauss(mean_accept, 1.0))), 8)
        accepts.append(a)
        total += a
    tree.accepted_len_list = accepts
    return tree


def tot_tree_to_record(tree: ExecuteTree) -> Dict:
    """Serialize to the reference Reasoning JSON schema
    (data_loader.py:80-96: {"prompt", "data": {id: {id, value, start, end,
    children}}})."""
    data = {
        str(n.id): {
            "id": n.id,
            "value": n.value,
            "start": n.start_offset,
            "end": n.end_offset,
            "children": [c.id for c in n.children],
        }
        for n in tree.nodes
    }
    return {"prompt": tree.prompt or "", "data": data}


def save_tot_json(trees: List[ExecuteTree], path: str) -> None:
    with open(path, "w") as f:
        json.dump([tot_tree_to_record(t) for t in trees], f)


def save_spec_json(trees: List[ExecuteTree], path: str) -> None:
    """Reference Speculative_Decoding schema (data_loader.py:181-197)."""
    assert trees
    size = trees[0].node_num
    out = {
        "Token_Tree_size": size,
        "Records": [
            {"prompt": t.prompt or "", "Accept_length": t.accepted_len_list}
            for t in trees
        ],
    }
    with open(path, "w") as f:
        json.dump(out, f)
