"""Tree-template dataset loaders.

Port of deft_tpu/data/loader.py: ExecuteTreeNode (:25), ExecuteTree (:43),
_load_dataset (:85), _build_nodes (:95), load_trees (:107), load_prompts
(:123) and generate_accepted_len_list (:137), a copy with the same
behaviour.  The two on-disk formats of the reference workloads (DeFT's
deft/data_loader.py):

1. Reasoning / Graph-of-Thoughts traces (dataset/generation/Reasoning/*.json):
   a list of records with "prompt" and "data" = {node_id: {id, value(seq len),
   start, end, children}}.  From (start, end) iteration offsets an ExecuteTree
   derives branch_record[iter] = {parent: [children]} and prune_record[iter]
   = [node ids] replayed by the Practical_Tree branch controller.
2. Speculative-decoding records (dataset/generation/Speculative_Decoding/
   *.json): {Tree_ID, Tree_Structure, Token_Tree_size, Records: [{prompt,
   Accept_length}]} — the mock Medusa workload needs the token-tree size and
   the per-step accepted lengths.
"""

from __future__ import annotations

import json
import pickle
import random
from typing import Any, Dict, List, Optional


class ExecuteTreeNode:
    def __init__(
        self, node_id: int, value: int = 0, start_offset: int = 0, end_offset: int = 0
    ):
        self.id = node_id
        self.value = value  # token run length in this node
        self.children: List["ExecuteTreeNode"] = []
        self.start_offset = start_offset  # iteration the node starts at
        self.end_offset = end_offset      # iteration the node finishes at
        self.depth = 0
        self.width = 0

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"ExecuteTreeNode(id={self.id}, value={self.value}, "
            f"start={self.start_offset}, end={self.end_offset})"
        )


class ExecuteTree:
    """A replayable branching schedule (reference data_loader.py:31-77)."""

    def __init__(
        self,
        root: ExecuteTreeNode,
        nodes: List[ExecuteTreeNode],
        prompt: Optional[str] = None,
    ):
        self.root = root
        self.nodes = nodes
        self.prompt = prompt
        self.branch_record: Dict[int, Dict[int, List[int]]] = {}
        self.prune_record: Dict[int, List[int]] = {}
        self.max_depth = 0
        self.max_width = 0
        self.width_per_depth: Dict[int, int] = {}
        self.node_num = len(nodes)
        self.accepted_len_list: Optional[List[int]] = None
        self._build_metadata(root, 0)

    def _build_metadata(self, node: ExecuteTreeNode, depth: int) -> int:
        self.max_depth = max(self.max_depth, depth)
        node.depth = depth
        node.width = self.width_per_depth.get(depth, 0)
        self.width_per_depth[depth] = node.width + 1
        self.max_width = max(self.max_width, self.width_per_depth[depth])

        end_iter = node.end_offset
        if not node.children:
            self.prune_record.setdefault(end_iter, []).append(node.id)
            return end_iter
        self.branch_record.setdefault(end_iter, {})[node.id] = [
            c.id for c in node.children
        ]
        for child in node.children:
            end_iter = max(end_iter, self._build_metadata(child, depth + 1))
        self.prune_record.setdefault(end_iter, []).append(node.id)
        return end_iter


def _load_dataset(path: str) -> Any:
    if path.endswith(".json"):
        with open(path) as f:
            return json.load(f)
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            return pickle.load(f)
    raise NotImplementedError(f"unsupported dataset format: {path}")


def _build_nodes(data: Dict[str, Any]) -> List[ExecuteTreeNode]:
    nodes = [ExecuteTreeNode(i) for i in range(len(data))]
    for item in data.values():
        n = nodes[int(item["id"])]
        n.value = int(item["value"])
        n.start_offset = int(item["start"])
        n.end_offset = int(item["end"])
        for child in item["children"]:
            n.children.append(nodes[int(child)])
    return nodes


def load_trees(path: str) -> List[ExecuteTree]:
    """Load reasoning/ToT templates; incomplete traces are skipped (matching
    build_trees, data_loader.py:100-120)."""
    dataset = _load_dataset(path)
    trees: List[ExecuteTree] = []
    for item in dataset:
        if "data" in item:
            if item.get("incompleted"):
                continue
            nodes = _build_nodes(item["data"])
        else:
            nodes = _build_nodes(item)
        trees.append(ExecuteTree(nodes[0], nodes, item.get("prompt")))
    return trees


def load_prompts(path: str) -> List[ExecuteTree]:
    """Load speculative-decoding records: one flat ExecuteTree per record,
    node_num == Token_Tree_size, with the accepted-length schedule."""
    dataset = _load_dataset(path)
    tree_size = dataset["Token_Tree_size"]
    trees: List[ExecuteTree] = []
    for rec in dataset["Records"]:
        nodes = [ExecuteTreeNode(i) for i in range(tree_size)]
        tree = ExecuteTree(nodes[0], nodes, rec["prompt"])
        tree.accepted_len_list = list(rec["Accept_length"])
        trees.append(tree)
    return trees


def generate_accepted_len_list(max_gen_len: int, tree: ExecuteTree,
                               seed: int = 0) -> None:
    """Pad/trim the accept schedule to sum to max_gen_len (reference
    data_loader.py:200-235).  Seeded (reproducible runs) and bounded: an
    all-zero recorded schedule would otherwise pad zeros forever."""
    assert tree.accepted_len_list
    m1, m2 = max(tree.accepted_len_list), min(tree.accepted_len_list)
    if m1 == 0:
        # degenerate record: nothing was ever accepted; keep it as-is
        return
    rng = random.Random(seed)
    out: List[int] = []
    s = 0
    for length in tree.accepted_len_list:
        if s + length <= max_gen_len:
            out.append(length)
            s += length
        else:
            break
    while s < max_gen_len:
        r = rng.randint(max(m2, 1), m1)
        r = min(r, max_gen_len - s)
        out.append(r)
        s += r
    tree.accepted_len_list = out
