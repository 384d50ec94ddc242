from deft_tpu_torch.core.kv_pool import TokenKVPool
from deft_tpu_torch.core.page_table import ReqToTokenPool
from deft_tpu_torch.core.tree_index import TreeIndexPool
from deft_tpu_torch.core.tree import TreeCache, TreeNode, BranchSequence

__all__ = [
    "TokenKVPool",
    "ReqToTokenPool",
    "TreeIndexPool",
    "TreeCache",
    "TreeNode",
    "BranchSequence",
]
