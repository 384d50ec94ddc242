from deft_tpu_torch.runtime.modes import ForwardMode, mode_from_cli
from deft_tpu_torch.runtime.runner import ModelRunner
from deft_tpu_torch.runtime.generate import tree_generate

__all__ = ["ForwardMode", "mode_from_cli", "ModelRunner", "tree_generate"]
