"""Port of deft_tpu/config.py:15,40 (AttentionConfig, EngineConfig): a copy, with the same
behaviour, owned by deft_tpu_torch.

Engine-wide configuration.

Replaces the reference's mutable module globals BLOCK_CONFIG / TRAVERSAL_CONFIG
(DeFT's deft/tree_decoding/tree_cache.py:587-588) with a typed,
immutable config threaded through the stack.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

WEIGHT_DTYPES = ("inherit", "int8", "int8-pallas")


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    """Static attention-plan / kernel parameters.

    block_len: tokens per flattened KV block (the reference default is 128,
        tree_cache.py:587).  Default 256, deft_tpu's choice for its TPU
        kernels, kept so both packages build the same plans; the Hopper
        kernels take any multiple of 64.
    node_chunk_len: when set, DeFT-Node plans chunk node KV runs to at most
        this many tokens (the reference's MAX_BLOCK_LEN node_chunk mode,
        examples/run_DeFT_llama_paged.py:145-150).

    deft_tpu's max_q_tile is not here: no ported code reads it.
    """

    block_len: int = 256
    node_chunk_len: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Top-level engine knobs.  deft_tpu's max_leaves comes with the code
    that reads it."""

    attention: AttentionConfig = dataclasses.field(default_factory=AttentionConfig)
    # KV pool sizing: number of token slots.  None -> from free device memory.
    kv_pool_slots: Optional[int] = None
    max_requests: int = 1024
    max_context_len: int = 32768
    # Plan shape buckets: pad token counts to these granularities.
    min_token_bucket: int = 1024
    dtype: str = "bfloat16"
    # KV cache element type (deft_tpu config.py:54): "inherit" (dtype) or
    # "int8" (per-(token, head) fp32 scales; halves the KV bytes).
    kv_dtype: str = "inherit"
    # Matmul weight element type (deft_tpu config.py:58): "inherit" (dtype),
    # "int8" (weight-only int8, per-output-channel fp32 scales; every matmul
    # runs the plain torch expression) or "int8-pallas" (the same codes and
    # scales; decode-sized matmuls run the hand-written kernel B9,
    # ops/int8_matmul.py, in the port — deft_tpu's name for its Pallas
    # kernel is kept so one command line drives both packages).
    weight_dtype: str = "inherit"
    # Fraction of free device memory the KV pool may claim when
    # kv_pool_slots is None.
    mem_fraction: float = 0.8

    def __post_init__(self):
        if self.kv_dtype not in ("inherit", "int8"):
            raise ValueError(f"kv_dtype {self.kv_dtype!r}: 'inherit' or 'int8'")
        if self.weight_dtype not in WEIGHT_DTYPES:
            raise ValueError(f"weight_dtype {self.weight_dtype!r}: one of "
                             f"{', '.join(WEIGHT_DTYPES)}")
