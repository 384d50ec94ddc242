"""Port of deft_tpu/runtime/modes.py:15 (ForwardMode): a copy, with the same
behaviour, owned by deft_tpu_torch.

Forward-mode enumeration (parity:
DeFT's deft/model_runner.py:31-42).

On TPU the paged/unpaged distinction collapses: every mode reads KV from the
single paged pool; the reference's "unpaged" modes differ only in *how much*
KV they materialize per step, which here is captured by each mode's gather
plan and IO accounting.  The names are kept for CLI / API parity.
"""

from __future__ import annotations

import enum


class ForwardMode(enum.Enum):
    PREFILL = enum.auto()
    # Sequential per-leaf decode (Flash-Decoding / Radix baseline).
    DECODE = enum.auto()
    # DeFT modes.
    TREE_DECODE_FLATTEN = enum.auto()
    TREE_DECODE_NODE = enum.auto()
    TREE_DECODE_INDEX_NODE = enum.auto()
    # "Unpaged" baselines (reference deft_attention.py:190-347).
    UNPAGED_MEDUSA = enum.auto()       # dense masked tree attention
    UNPAGED_FD = enum.auto()           # per-leaf flash decoding
    UNPAGED_DEFT_NODE = enum.auto()
    UNPAGED_DEFT_FLATTEN = enum.auto()

    @property
    def is_deft(self) -> bool:
        return self in (
            ForwardMode.TREE_DECODE_FLATTEN,
            ForwardMode.TREE_DECODE_NODE,
            ForwardMode.TREE_DECODE_INDEX_NODE,
            ForwardMode.UNPAGED_DEFT_NODE,
            ForwardMode.UNPAGED_DEFT_FLATTEN,
        )

    @property
    def is_sequential(self) -> bool:
        return self in (ForwardMode.DECODE, ForwardMode.UNPAGED_FD)

    @property
    def plan_kind(self) -> str:
        """Which plan builder feeds this mode."""
        if self in (ForwardMode.TREE_DECODE_FLATTEN, ForwardMode.UNPAGED_DEFT_FLATTEN,
                    ForwardMode.UNPAGED_MEDUSA):
            return "flatten"
        if self in (ForwardMode.TREE_DECODE_NODE, ForwardMode.UNPAGED_DEFT_NODE):
            return "node"
        if self is ForwardMode.TREE_DECODE_INDEX_NODE:
            return "tree_index"
        if self.is_sequential:
            return "seq"
        raise ValueError(self)


def mode_from_cli(mode: str, mem: str = "paged") -> ForwardMode:
    """CLI mapping, matching run_DeFT_llama_paged.py:124-150."""
    table = {
        ("paged", "seq"): ForwardMode.DECODE,
        ("paged", "flatten"): ForwardMode.TREE_DECODE_FLATTEN,
        ("paged", "node"): ForwardMode.TREE_DECODE_NODE,
        ("paged", "node_chunk"): ForwardMode.TREE_DECODE_NODE,
        ("paged", "tree_index"): ForwardMode.TREE_DECODE_INDEX_NODE,
        ("unpaged", "tree"): ForwardMode.UNPAGED_MEDUSA,
        ("unpaged", "seq"): ForwardMode.UNPAGED_FD,
        ("unpaged", "flatten"): ForwardMode.UNPAGED_DEFT_FLATTEN,
        ("unpaged", "node"): ForwardMode.UNPAGED_DEFT_NODE,
    }
    key = (mem, mode)
    if key not in table:
        raise NotImplementedError(f"mode={mode} mem={mem}")
    return table[key]
