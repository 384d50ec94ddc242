"""Generation-state checkpoint and restore: the tokens are the checkpoint.

Port of deft_tpu/runtime/checkpoint.py: tree_snapshot (:19), save_checkpoint
(:52) and restore (:57), with the same JSON, so a file written by either
package restores in the other.  A decoding tree's structure and token ids
determine its KV cache, so the snapshot holds no KV: restore rebuilds the
skeleton with the snapshot's node ids, position offsets and pending tokens,
gives every node's executed tokens fresh KV slots, and re-prefills each
root-to-leaf path into them (shared prefixes are recomputed identically, so
their rows are rewritten with the same values).  deft_tpu pads each path to
its prefill bucket; the port runs eagerly at the path's length, through the
prefill attention (kernel B3) on the runner's device or grid.
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np

from deft_tpu_torch.core.tree import BranchSequence, TreeCache, TreeNode
from deft_tpu_torch.models.llama import forward_layers
from deft_tpu_torch.ops import attn_impls


def tree_snapshot(tree: TreeCache) -> Dict:
    """Serializable skeleton: per node (id, parent, token_ids, position
    offset, cumulative logprob, kv_len, prompt_len) and the finished
    branches.  KV indices are not saved: re-prefill derives them."""
    nodes = [{
        "id": n.id,
        "parent": n.parent.id if n.parent is not None else None,
        "token_ids": list(n.token_ids),
        "position_offset": n.position_offset,
        "cumulative_logprob": n.cumulative_logprob,
        # a leaf's newest token has no KV slot until the next alloc()
        "kv_len": n.kv_len,
        # root only: the prompt / merged-token boundary (output accounting)
        "prompt_len": n.prompt_len,
    } for n in tree.nodes.values()]
    return {
        "nodes": nodes,
        "node_cnt": tree.node_cnt,
        "deleted_token_num": tree.deleted_token_num,
        "finished": [{
            "id": s.id,
            "token_ids": list(s.token_ids),
            "cumulative_logprob": s.cumulative_logprob,
            "PPL": s.PPL,
        } for s in tree.all_finished_seqs],
    }


def save_checkpoint(tree: TreeCache, path: str) -> None:
    with open(path, "w") as f:
        json.dump(tree_snapshot(tree), f)


def _chain(leaf: TreeNode) -> List[TreeNode]:
    """The nodes from the root to ``leaf``."""
    chain = []
    while leaf is not None:
        chain.append(leaf)
        leaf = leaf.parent
    return chain[::-1]


def _restore_skeleton(tree: TreeCache, snap: Dict) -> None:
    """The snapshot's nodes with their ids, offsets and pending tokens, each
    node's executed tokens on fresh KV slots, and the leaves' page-table
    rows (deft_tpu checkpoint.py:76-160)."""
    order = sorted(snap["nodes"], key=lambda n: n["id"])
    root_rec = order[0]
    if root_rec["parent"] is not None:
        raise ValueError("the snapshot's lowest node id is not the root")
    # root KV only for its executed tokens: a pending newest token stays
    # pending, or the next alloc() would give it a second slot
    root_kv = int(root_rec["kv_len"])
    tree.init_prompt(root_rec["token_ids"][:root_kv])
    for t in root_rec["token_ids"][root_kv:]:
        tree.root.append_token(int(t))
    tree.root.position_offset = root_rec["position_offset"]
    tree.root.cumulative_logprob = root_rec["cumulative_logprob"]
    # init_prompt counted merged (accepted) tokens as prompt
    tree.root.prompt_len = int(root_rec.get("prompt_len", root_kv))
    id_map = {root_rec["id"]: tree.root}
    for rec in order[1:]:
        parent = id_map[rec["parent"]]
        if parent.id in tree.leaves:  # the parent's first child: no longer a leaf
            tree.leaves.pop(parent.id)
            req = tree.leaf_to_req.pop(parent.id, None)
            if req is not None:
                tree.req_to_token_pool.free(req)
            tree.remove_ref(parent)
            tree.token_to_kv_pool.close_owner((tree._owner_tag, parent.id))
        node = TreeNode(int(rec["id"]))
        node.parent = parent
        node.position_offset = int(rec["position_offset"])
        parent.children[node.id] = node
        tree.nodes[node.id] = node
        if tree.tree_index_pool is not None:
            row = tree.tree_index_pool.alloc(1)
            if row is None:
                raise RuntimeError("tree-index pool exhausted during restore")
            node.node_index_row = int(row[0])
        id_map[rec["id"]] = node
        tree.leaves[node.id] = node
        tree.add_ref(node)
        for t in rec["token_ids"]:
            node.append_token(int(t))
        node.cumulative_logprob = rec["cumulative_logprob"]
        if rec["kv_len"]:  # slots for the node's executed tokens
            locs = tree.token_to_kv_pool.alloc_for((tree._owner_tag, node.id),
                                                   rec["kv_len"])
            if locs is None:
                raise RuntimeError("KV pool exhausted during restore")
            node.extend_indices(locs, tree.tree_index_pool)
        tree.token_to_kv_pool.close_owner((tree._owner_tag, node.id))
        if tree.req_to_token_pool is not None:
            req = tree.req_to_token_pool.alloc(1)
            if req is None:
                raise RuntimeError("request pool exhausted during restore")
            tree.leaf_to_req[node.id] = int(req[0])
    if tree.req_to_token_pool is not None:  # each leaf's root-to-leaf KV row
        for leaf in tree.leaves.values():
            kv = np.concatenate([c.kv_indices for c in _chain(leaf) if c.kv_len])
            tree.req_to_token_pool.req_to_token[tree.leaf_to_req[leaf.id], :len(kv)] = kv


def restore(runner, path: str) -> None:
    """Rebuild ``runner``'s tree and KV pools from a snapshot file by
    re-prefilling every root-to-leaf path (deft_tpu checkpoint.py:57)."""
    with open(path) as f:
        snap = json.load(f)
    runner.reset_state()
    tree = runner.tree
    _restore_skeleton(tree, snap)
    for leaf in sorted(tree.leaves.values(), key=lambda x: x.id):
        chain = _chain(leaf)
        tokens = [t for c in chain for t in c.token_ids[:c.kv_len]]
        positions = [p for c in chain for p in c.positions[:c.kv_len]]
        locs = np.concatenate([c.kv_indices for c in chain if c.kv_len])
        if len(locs) != len(tokens):
            raise RuntimeError(f"leaf {leaf.id}: {len(tokens)} tokens on "
                               f"{len(locs)} KV slots")
        dev = runner._upload({"tokens": tokens, "positions": positions,
                              "out_loc": locs})
        forward_layers(runner.cfg, runner.params, runner._rope_tbl, runner.k_pool,
                       runner.v_pool, dev["tokens"], dev["positions"].long(),
                       dev["out_loc"].long(), attn_impls.prefill_attn, None,
                       runner._shard)
    for rec in snap["finished"]:
        seq = BranchSequence(rec["id"])
        seq.token_ids = list(rec["token_ids"])
        seq.cumulative_logprob = rec["cumulative_logprob"]
        seq.PPL = rec["PPL"]
        tree.all_finished_seqs.append(seq)
    tree.node_cnt = snap["node_cnt"]
    tree.deleted_token_num = snap["deleted_token_num"]
