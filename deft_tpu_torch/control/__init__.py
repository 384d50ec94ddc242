from deft_tpu_torch.control.branch_controller import Branch_Controller
from deft_tpu_torch.control import workloads

__all__ = ["Branch_Controller", "workloads"]
