from deft_tpu_torch.plan.padding import (
    next_pow2,
    pad_leaf_count,
    pad_token_count,
)
from deft_tpu_torch.plan.flatten import FlattenPlan, build_flatten_plan
from deft_tpu_torch.plan.seq import SeqPlan, build_seq_plan
from deft_tpu_torch.plan.node import build_node_plan, build_tree_index_plan
from deft_tpu_torch.plan.multi import (build_multi_flatten_plan,
                                       build_multi_seq_plan)

__all__ = [
    "next_pow2",
    "pad_leaf_count",
    "pad_token_count",
    "FlattenPlan",
    "build_flatten_plan",
    "SeqPlan",
    "build_seq_plan",
    "build_node_plan",
    "build_tree_index_plan",
    "build_multi_flatten_plan",
    "build_multi_seq_plan",
]
