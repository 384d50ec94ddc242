"""Tree-template records.

Port of the part of deft_tpu/data/loader.py:25-82 (ExecuteTreeNode,
ExecuteTree) that control/workloads.py imports: a copy with the same
behaviour.  The dataset readers (load_trees, load_prompts) come with the
Practical_Tree and Speculative_Decoding workloads in a later slice.
"""

from __future__ import annotations

from typing import Dict, List, Optional


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
