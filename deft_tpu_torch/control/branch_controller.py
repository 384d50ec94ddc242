"""Port of deft_tpu/control/branch_controller.py:9: a copy, with the same
behaviour, owned by deft_tpu_torch.

Branch controller: strategy holder for user-defined branching policies
(parity: DeFT's deft/tree_decoding/branch_controller.py:10-31)."""

from __future__ import annotations

from typing import Callable


class Branch_Controller:
    def __init__(self, branching_function: Callable):
        self.branching_function = branching_function
        self.tree_templates = None

    def set_execution_graph(self, tree_templates=None) -> None:
        self.tree_templates = tree_templates

    def apply_branching(self, **kwargs) -> bool:
        """Run the policy; returns True when generation should stop."""
        return self.branching_function(**kwargs)
