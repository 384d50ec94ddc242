from deft_tpu_torch.models.config import PRESETS, LlamaConfig

__all__ = ["PRESETS", "LlamaConfig"]
