"""Port of deft_tpu/core/tree.py:197 (TreeCache): a copy, with the same
behaviour, owned by deft_tpu_torch.

Host-side decoding-tree runtime.

Capability parity with the reference TreeCache / TreeNode / BranchSequence
(DeFT's deft/tree_decoding/tree_cache.py:94-584): a token tree
whose nodes own token ids, RoPE positions and KV-pool slot indices, with
branch / cut / merge / reset operations maintaining per-slot refcounts for
prefix sharing.

TPU-first differences from the reference:

- Node KV indices are numpy arrays with amortized growth (the plan builders
  concatenate them every step; python lists + torch.tensor() per step is the
  reference's acknowledged ~15% framework overhead, README.md:207).
- ``dfs_plan_order`` numbers leaves in DFS order and computes, per node, the
  half-open interval [leaf_lo, leaf_hi) of descendant leaves.  With KV laid
  out in the same DFS order, "query q attends token t" becomes
  ``leaf_lo[node(t)] <= q < leaf_hi[node(t)]`` — a contiguous-range mask.
  This replaces the reference's per-token int64 query bitmasks and ≤32-query
  partial packing (tree_cache.py:591-1018) with two int32s per token, and is
  what lets the TPU kernel be a single flash-attention pass with tile
  skipping instead of a two-stage atomic reduction.
- Refcounts are integers (#descendant leaves), not sets of leaf objects.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from deft_tpu_torch.core.kv_pool import TokenKVPool
from deft_tpu_torch.core.page_table import ReqToTokenPool
from deft_tpu_torch.core.tree_index import TreeIndexPool


class _IndexVec:
    """int32 vector with amortized append/extend."""

    __slots__ = ("_buf", "_len")

    def __init__(self, capacity: int = 16):
        self._buf = np.empty(capacity, dtype=np.int32)
        self._len = 0

    def __len__(self) -> int:
        return self._len

    def _grow(self, need: int) -> None:
        if need > self._buf.shape[0]:
            new_cap = max(need, 2 * self._buf.shape[0])
            new_buf = np.empty(new_cap, dtype=np.int32)
            new_buf[: self._len] = self._buf[: self._len]
            self._buf = new_buf

    def append(self, value: int) -> None:
        self._grow(self._len + 1)
        self._buf[self._len] = value
        self._len += 1

    def extend(self, values: np.ndarray) -> None:
        n = len(values)
        self._grow(self._len + n)
        self._buf[self._len : self._len + n] = values
        self._len += n

    def view(self) -> np.ndarray:
        return self._buf[: self._len]

    def clear(self) -> None:
        self._len = 0

    def tolist(self) -> List[int]:
        return self.view().tolist()


class TreeNode:
    """One tree node: a run of tokens on a root-to-leaf path."""

    __slots__ = (
        "id",
        "parent",
        "children",
        "token_ids",
        "positions",
        "position_offset",
        "_kv",
        "kv_runs",
        "ref_count",
        "cumulative_logprob",
        "node_index_row",
        "was_reset",
        "prompt_len",
    )

    def __init__(self, node_id: int):
        self.id = node_id
        self.parent: Optional[TreeNode] = None
        self.children: Dict[int, TreeNode] = {}
        self.token_ids: List[int] = []
        self.positions: List[int] = []
        self.position_offset = 0
        self._kv = _IndexVec()
        # pool-contiguous spans of _kv as [start, len] pairs, maintained
        # incrementally so plan assembly is O(runs), not O(tokens)
        self.kv_runs: List[List[int]] = []
        self.ref_count = 0  # number of leaves descending through this node
        self.cumulative_logprob = 0.0
        self.node_index_row: Optional[int] = None  # TreeIndexPool row
        # set by reset_node_KV; alloc() group-allocates flagged empty
        # leaves' slots contiguously (speculative decoding fast path)
        self.was_reset = False
        # root only: how many leading token_ids are the prompt (tokens past
        # it were MERGED in, e.g. spec-decode accepts, and count as output)
        self.prompt_len = 0

    # -- token / kv ops ------------------------------------------------------
    def get_len(self) -> int:
        return len(self.token_ids)

    @property
    def kv_len(self) -> int:
        return len(self._kv)

    @property
    def kv_indices(self) -> np.ndarray:
        return self._kv.view()

    def append_token(self, token: int, logprob: Optional[float] = None) -> None:
        self.positions.append(self.position_offset + len(self.token_ids))
        self.token_ids.append(int(token))
        if logprob is not None:
            self.cumulative_logprob += logprob

    def _runs_push(self, index: int) -> None:
        if self.kv_runs and self.kv_runs[-1][0] + self.kv_runs[-1][1] == index:
            self.kv_runs[-1][1] += 1
        else:
            self.kv_runs.append([int(index), 1])

    def append_index(self, index: int, tree_index: Optional[TreeIndexPool] = None) -> None:
        self._kv.append(index)
        self._runs_push(int(index))
        if tree_index is not None and self.node_index_row is not None:
            tree_index.node_to_kv[self.node_index_row, len(self._kv) - 1] = index

    def extend_indices(
        self, indices: np.ndarray, tree_index: Optional[TreeIndexPool] = None
    ) -> None:
        start = len(self._kv)
        self._kv.extend(indices)
        arr = np.asarray(indices)
        if len(arr):
            breaks = np.flatnonzero(np.diff(arr) != 1) + 1
            bounds = np.concatenate([[0], breaks, [len(arr)]])
            for a, b in zip(bounds[:-1], bounds[1:]):
                first = int(arr[a])
                if (
                    self.kv_runs
                    and self.kv_runs[-1][0] + self.kv_runs[-1][1] == first
                ):
                    self.kv_runs[-1][1] += int(b - a)
                else:
                    self.kv_runs.append([first, int(b - a)])
        if tree_index is not None and self.node_index_row is not None:
            tree_index.node_to_kv[self.node_index_row, start : start + len(indices)] = (
                indices
            )

    def clear_indices(self) -> None:
        self._kv.clear()
        self.kv_runs.clear()

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"TreeNode(id={self.id}, tokens={len(self.token_ids)}, "
            f"kv={self.kv_len}, refs={self.ref_count})"
        )


class BranchSequence:
    """A finished root-to-leaf branch (reference tree_cache.py:132-144)."""

    def __init__(self, seq_id: int):
        self.id = seq_id
        self.token_ids: List[int] = []
        self.cumulative_logprob = 0.0
        self.PPL = 0.0

    def get_len(self) -> int:
        return len(self.token_ids)

    def append_tokens(self, tokens: List[int]) -> None:
        self.token_ids.extend(tokens)


class TreeCache:
    """The decoding tree + its KV bookkeeping.

    Operations mirror the reference (file:line cites are into
    DeFT's deft/tree_decoding/tree_cache.py):
    init_prompt (:192-240), alloc (:261-297), branch (:338-370),
    cut (:374-403), merge_nodes (:300-325), reset_node_KV (:327-336),
    output_branch (:525-541), get_tree_token_number (:569-584).
    """

    _owner_tag_counter = 0

    def __init__(
        self,
        token_to_kv_pool: TokenKVPool,
        req_to_token_pool: Optional[ReqToTokenPool] = None,
        tree_index_pool: Optional[TreeIndexPool] = None,
    ):
        # distinct chunk-owner namespace per tree: several trees may share
        # one TokenKVPool (batched decoding) and node ids repeat across trees
        TreeCache._owner_tag_counter += 1
        self._owner_tag = TreeCache._owner_tag_counter
        self.token_to_kv_pool = token_to_kv_pool
        self.req_to_token_pool = req_to_token_pool
        self.tree_index_pool = tree_index_pool
        self.root: Optional[TreeNode] = None
        self.nodes: Dict[int, TreeNode] = {}
        self.leaves: Dict[int, TreeNode] = {}
        self.leaf_to_req: Dict[int, int] = {}
        self.leaf_to_q: Dict[int, int] = {}
        self.node_cnt = 0
        self.deleted_token_num = 0
        self.all_finished_seqs: List[BranchSequence] = []
        # merge-compaction row copies queued for the runner (drain_kv_copies)
        self.pending_kv_copies: List[tuple] = []

    # -- refcount maintenance (integer counts; reference uses leaf sets,
    #    tree_cache.py:504-516) ---------------------------------------------
    def add_ref(self, node: TreeNode) -> None:
        cur: Optional[TreeNode] = node
        while cur is not None:
            cur.ref_count += 1
            cur = cur.parent

    def remove_ref(self, node: TreeNode) -> None:
        cur: Optional[TreeNode] = node
        while cur is not None:
            cur.ref_count -= 1
            assert cur.ref_count >= 0
            cur = cur.parent

    # -- construction ----------------------------------------------------------
    def init_prompt(self, prompt_ids: List[int]) -> np.ndarray:
        """Create the root node holding the prompt; allocate its KV slots.

        Returns the prompt's KV slot indices (contiguous by construction of
        the bump allocator) — the caller scatters prefill K/V to these rows.
        """
        assert self.root is None, "init_prompt called twice"
        # a new generation: clear run-scoped outputs/counters (kept through
        # free() so callers can read results after tree_generate returns)
        self.deleted_token_num = 0
        self.all_finished_seqs = []
        root = TreeNode(0)
        self.node_cnt = 1
        self.root = root
        self.nodes[0] = root
        prompt_ids = [int(t) for t in prompt_ids]
        root.token_ids = list(prompt_ids)
        root.positions = list(range(len(prompt_ids)))
        root.prompt_len = len(prompt_ids)
        self.leaves[root.id] = root
        self.add_ref(root)

        cache_loc = self.token_to_kv_pool.alloc(len(prompt_ids))
        assert cache_loc is not None, "KV pool exhausted at prompt"
        if self.tree_index_pool is not None:
            row = self.tree_index_pool.alloc(1)
            assert row is not None
            root.node_index_row = int(row[0])
        root.extend_indices(cache_loc, self.tree_index_pool)

        if self.req_to_token_pool is not None:
            req = self.req_to_token_pool.alloc(1)
            assert req is not None
            req_id = int(req[0])
            self.leaf_to_req[root.id] = req_id
            self.req_to_token_pool.req_to_token[req_id, : len(prompt_ids)] = cache_loc
        return cache_loc

    def new_node(self, parent: TreeNode) -> TreeNode:
        node = TreeNode(self.node_cnt)
        self.node_cnt += 1
        node.parent = parent
        node.position_offset = parent.position_offset + len(parent.positions)
        parent.children[node.id] = node
        self.nodes[node.id] = node
        if self.tree_index_pool is not None:
            row = self.tree_index_pool.alloc(1)
            assert row is not None
            node.node_index_row = int(row[0])
        return node

    # -- per-step allocation -----------------------------------------------------
    def alloc(self) -> np.ndarray:
        """Allocate one KV slot per leaf (sorted by leaf id, matching the
        reference's ordering, tree_cache.py:261-297); append to each leaf and
        to its page-table row.  Returns the slots in that order.

        Slots come from each leaf's private chunk (TokenKVPool.alloc_for), so
        a leaf's appended KV stays pool-contiguous — the property the flatten
        plan's DMA segment tables rely on.

        Exception: when many leaves were just KV-RESET (speculative decoding
        squeezes accepts into the root then resets every leaf each step),
        their slots come from ONE aligned contiguous group
        (TokenKVPool.alloc_group) in leaf-id == DFS order, so the whole leaf
        set coalesces into a single DMA run in the flatten plan instead of
        one seg-padded run per leaf."""
        leaves = sorted(self.leaves.values(), key=lambda x: x.id)
        out_cache_loc = np.empty(len(leaves), dtype=np.int32)
        grouped = [
            l for l in leaves if l.was_reset and l.kv_len == 0
        ] if len(leaves) >= 8 else []
        group_slots = None
        if len(grouped) >= 8:
            group_slots = self.token_to_kv_pool.alloc_group(len(grouped))
        group_of = (
            {l.id: int(s) for l, s in zip(grouped, group_slots)}
            if group_slots is not None else {}
        )
        for idx, leaf in enumerate(leaves):
            if leaf.id in group_of:
                loc = group_of[leaf.id]
                leaf.was_reset = False
            else:
                loc_arr = self.token_to_kv_pool.alloc_for(
                    (self._owner_tag, leaf.id), 1
                )
                assert loc_arr is not None, "KV pool exhausted"
                loc = int(loc_arr[0])
            out_cache_loc[idx] = loc
            leaf.append_index(loc, self.tree_index_pool)
            if self.req_to_token_pool is not None:
                req = self.leaf_to_req[leaf.id]
                self.req_to_token_pool.req_to_token[req, leaf.positions[-1]] = loc
        return out_cache_loc

    # -- structural ops ------------------------------------------------------------
    def branch(self, node: TreeNode, branch_cnt: int) -> List[TreeNode]:
        """Split a leaf into ``branch_cnt`` children.  The first child
        inherits the parent's page-table row; the rest copy the path prefix."""
        assert node.id in self.leaves
        self.leaves.pop(node.id)
        path_len = node.positions[-1] + 1 if node.positions else 0
        req = self.leaf_to_req.pop(node.id, None)

        new_nodes: List[TreeNode] = []
        first = True
        for _ in range(branch_cnt):
            child = self.new_node(node)
            new_nodes.append(child)
            self.leaves[child.id] = child
            if self.req_to_token_pool is not None and req is not None:
                if first:
                    self.leaf_to_req[child.id] = req
                    first = False
                else:
                    new_req = self.req_to_token_pool.alloc(1)
                    assert new_req is not None
                    new_req_id = int(new_req[0])
                    self.req_to_token_pool.copy(req, new_req_id, path_len)
                    self.leaf_to_req[child.id] = new_req_id

        self.remove_ref(node)
        for child in new_nodes:
            self.add_ref(child)
        # node stops appending: recycle its open chunk tail
        self.token_to_kv_pool.close_owner((self._owner_tag, node.id))
        return new_nodes

    def cut(self, node: TreeNode, record_deleted: bool = False) -> List[TreeNode]:
        """Prune a leaf; walk up freeing ancestors with no remaining leaves."""
        assert len(node.children) == 0
        assert node.id in self.leaves
        self.leaves.pop(node.id)
        self.token_to_kv_pool.close_owner((self._owner_tag, node.id))
        self.remove_ref(node)
        if self.req_to_token_pool is not None:
            req = self.leaf_to_req.pop(node.id, None)
            if req is not None:
                self.req_to_token_pool.free(req)
        assert node.ref_count == 0

        deleted: List[TreeNode] = []
        cur: Optional[TreeNode] = node
        while cur is not None and cur.ref_count == 0:
            deleted.append(self.nodes.pop(cur.id))
            # interior nodes can hold an open chunk too (merge_nodes
            # alloc_for targets): recycle its unused tail or the chunk
            # leaks until pool.clear()
            self.token_to_kv_pool.close_owner((self._owner_tag, cur.id))
            if cur.kv_len:
                self.token_to_kv_pool.free(cur.kv_indices)
            if self.tree_index_pool is not None and cur.node_index_row is not None:
                self.tree_index_pool.free(cur.node_index_row)
            parent = cur.parent
            if parent is not None:
                parent.children.pop(cur.id)
            cur = parent
        if record_deleted:
            for d in deleted:
                self.deleted_token_num += len(d.token_ids)
        return deleted

    def merge_nodes(
        self, node_a: TreeNode, node_b: TreeNode, prune_b: bool = True
    ) -> None:
        """Squeeze node_b's tokens + KV into node_a (speculative-decoding
        accept path, reference tree_cache.py:300-325).

        TPU-first change vs the reference: the reference re-links node_b's
        KV indices into node_a (aliasing — free on a GPU whose kernels
        gather per token).  Here node_b's rows are COPIED into fresh slots
        from node_a's chunked allocation run: accepted tokens land
        pool-contiguous with node_a's existing KV, so the tree's plans stay
        seg-aligned and keep the paged DMA kernels after arbitrarily many
        accepts (aliasing fragments the root's runs within a few spec-decode
        steps and forces the gather fallback).  The device-side row copies
        are recorded in ``pending_kv_copies`` and drained as ONE batched
        gather/scatter by the runner before its next forward — O(accepted)
        rows per step, negligible next to the step's KV traffic."""
        for token_id in node_b.token_ids:
            node_a.append_token(token_id)
        # carry node_b's accumulated logprob so output_branch/PPL accounting
        # survives the merge (the tokens now live in node_a)
        node_a.cumulative_logprob += node_b.cumulative_logprob
        if node_b.kv_len:
            src = np.asarray(node_b.kv_indices, dtype=np.int32).copy()
            dst = self.token_to_kv_pool.alloc_for(
                (self._owner_tag, node_a.id), len(src)
            )
            if dst is None:
                # pool exhausted — reference aliasing semantics (plans then
                # degrade to the gather kernel, correctness unchanged)
                node_a.extend_indices(src, self.tree_index_pool)
                self.token_to_kv_pool.add_refs(src)
            else:
                node_a.extend_indices(dst, self.tree_index_pool)
                self.pending_kv_copies.append((src, dst))
        if prune_b:
            self.cut(node_b)

    def drain_kv_copies(self):
        """(src, dst) int32 arrays of queued merge compactions, or None.
        The caller (runner) must apply them to the device pools BEFORE its
        next decode/prefill step executes: sources stay valid until that
        step's kv_store scatters (freed slots are only rewritten by later
        allocations' stores, never asynchronously)."""
        if not self.pending_kv_copies:
            return None
        src = np.concatenate([s for s, _ in self.pending_kv_copies])
        dst = np.concatenate([d for _, d in self.pending_kv_copies])
        self.pending_kv_copies.clear()
        return src, dst

    def reset_node_KV(self, node: TreeNode, diff: int) -> None:
        """Free a node's KV and shift its positions by ``diff`` (after a
        merge extended its ancestor)."""
        if node.kv_len:
            self.token_to_kv_pool.free(node.kv_indices)
        node.clear_indices()
        node.was_reset = True
        node.position_offset += diff
        node.positions = [p + diff for p in node.positions]

    def sync_page_table(self) -> None:
        """Rewrite every leaf's ReqToTokenPool row from its node chain.
        merge_nodes / reset_node_KV restructure KV ownership without
        maintaining the per-leaf rows (unlike alloc/branch/cut); callers
        that mutate via merge/reset must call this before a seq-mode step
        reads the page table."""
        if self.req_to_token_pool is None:
            return
        for leaf in self.leaves.values():
            chain = []
            cur = leaf
            while cur is not None:
                chain.append(cur)
                cur = cur.parent
            chain.reverse()
            parts = [c.kv_indices for c in chain if c.kv_len]
            req = self.leaf_to_req[leaf.id]
            if parts:
                kv = np.concatenate(parts)
                self.req_to_token_pool.req_to_token[req, : len(kv)] = kv

    def free(self) -> None:
        """Drop the whole tree, releasing every node's KV and request slots."""
        for node in self.nodes.values():
            if node.kv_len:
                self.token_to_kv_pool.free(node.kv_indices)
            if self.tree_index_pool is not None and node.node_index_row is not None:
                self.tree_index_pool.free(node.node_index_row)
        if self.req_to_token_pool is not None:
            for req in self.leaf_to_req.values():
                self.req_to_token_pool.free(req)
        for node_id in list(self.nodes):
            # every node id, not just leaves: merge_nodes opens a chunk for
            # the merge TARGET (typically the root), whose tail must recycle
            self.token_to_kv_pool.close_owner((self._owner_tag, node_id))
        self.pending_kv_copies.clear()
        self.root = None
        self.nodes.clear()
        self.leaves.clear()
        self.leaf_to_req.clear()
        self.leaf_to_q.clear()
        self.node_cnt = 0

    # -- outputs -----------------------------------------------------------------
    def output_branch(self, dstnode: TreeNode) -> BranchSequence:
        """Record a finished branch (generated tokens only; the PROMPT is
        excluded, matching _find_path_to_node, tree_cache.py:542-549).

        Delta vs the reference: tokens MERGED into the root (spec-decode
        accepts, merge_nodes) are generated output and are included —
        root.token_ids[root.prompt_len:] — where the reference's root-
        exclusion silently drops them from every branch."""
        path: List[TreeNode] = []
        node: Optional[TreeNode] = dstnode
        while node is not None and node.parent is not None:
            path.append(node)
            node = node.parent
        path.reverse()

        seq = BranchSequence(len(self.all_finished_seqs))
        root = self.root
        if root is not None and len(root.token_ids) > root.prompt_len:
            seq.append_tokens(root.token_ids[root.prompt_len:])
            seq.cumulative_logprob += root.cumulative_logprob
        for n in path:
            seq.append_tokens(n.token_ids)
            seq.cumulative_logprob += n.cumulative_logprob
        if seq.token_ids:
            seq.PPL = math.exp(-seq.cumulative_logprob / len(seq.token_ids))
        self.all_finished_seqs.append(seq)
        return seq

    def print_finished_branches(self, tokenizer=None) -> None:
        print(f"Total number of generated branches={len(self.all_finished_seqs)}!")
        for branch in self.all_finished_seqs:
            text = (
                tokenizer.decode(branch.token_ids, skip_special_tokens=True)
                if tokenizer is not None
                else ""
            )
            print(
                f" Branch ID: {branch.id}\n",
                f"Generated Text: {text}\n",
                f"Tokens in this path:{branch.token_ids}\n",
                f"Token length : {len(branch.token_ids)}\n",
                f"Perplexity: {branch.PPL}\n",
            )

    def get_tree_token_number(self) -> int:
        return sum(len(n.token_ids) for n in self.nodes.values()) + self.deleted_token_num

    def get_tree_kv_len(self) -> int:
        return sum(n.kv_len for n in self.nodes.values())

    # -- plan-order traversal ------------------------------------------------------
    def dfs_plan_order(
        self,
    ) -> Tuple[List[TreeNode], Dict[int, int], np.ndarray, np.ndarray]:
        """DFS over live nodes.

        Returns (nodes_in_dfs_order, leaf_to_q, node_leaf_lo, node_leaf_hi):
        leaves are numbered 0..L-1 in DFS visit order, and node_leaf_lo/hi[i]
        give node i's (DFS position) half-open descendant-leaf interval.
        Every query numbered q attends node i's tokens iff
        lo[i] <= q < hi[i] — the contiguous-interval property the flatten
        kernel's range mask relies on.  Also refreshes ``self.leaf_to_q``.
        """
        assert self.root is not None
        order: List[TreeNode] = []
        lo_list: List[int] = []
        hi_map: Dict[int, int] = {}
        leaf_to_q: Dict[int, int] = {}
        leaf_counter = 0

        # Iterative DFS (trees can be deep: one node per branch segment).
        # A (node, True) marker pops after the node's whole subtree, at which
        # point hi = current leaf counter.
        stack: List[Tuple[TreeNode, bool]] = [(self.root, False)]
        while stack:
            node, post = stack.pop()
            if post:
                hi_map[node.id] = leaf_counter
                continue
            order.append(node)
            lo_list.append(leaf_counter)
            if not node.children:
                leaf_to_q[node.id] = leaf_counter
                leaf_counter += 1
                hi_map[node.id] = leaf_counter
            else:
                stack.append((node, True))
                # push children in reverse id order so DFS visits ascending ids
                for child in sorted(node.children.values(), key=lambda c: -c.id):
                    stack.append((child, False))

        lo_arr = np.array(lo_list, dtype=np.int32)
        hi_arr = np.array([hi_map[n.id] for n in order], dtype=np.int32)
        self.leaf_to_q = leaf_to_q
        return order, leaf_to_q, lo_arr, hi_arr
