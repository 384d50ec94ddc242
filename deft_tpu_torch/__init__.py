"""deft_tpu_torch: the PyTorch/CUDA port of deft_tpu for one NVIDIA H100.

deft_tpu (JAX/Pallas, TPU) stays the reference; every module here names its
counterpart there (file:line).  This package imports torch and numpy only —
never jax and never deft_tpu.  Its entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; on the CPU each hand-written kernel's wrapper
runs the kernel's plain torch version instead.
"""

from deft_tpu_torch.config import AttentionConfig, EngineConfig
from deft_tpu_torch.models.config import PRESETS, LlamaConfig

__all__ = ["AttentionConfig", "EngineConfig", "LlamaConfig", "PRESETS"]
