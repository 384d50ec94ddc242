from deft_tpu_torch.data.loader import (
    ExecuteTree,
    ExecuteTreeNode,
    generate_accepted_len_list,
    load_prompts,
    load_trees,
)

__all__ = [
    "ExecuteTree",
    "ExecuteTreeNode",
    "load_trees",
    "load_prompts",
    "generate_accepted_len_list",
]
