"""Per-iteration latency and analytic IO-byte accounting.

Port of deft_tpu/obs/perf_metrics.py:16 (PerfMetrics), trimmed to what the
port calls (update_dense_tree_attn_IO :94 and dump_partial :173 among it),
with the same JSON
schema: the dump keeps the reference
PerfMetrics's keys (DeFT's deft/tree_decoding/perf_metrics.py:62-92), so
dumps of deft_tpu, of the port and of the reference compare directly.
Counters are per instance (no class-level state shared across runs).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional


class PerfMetrics:
    def __init__(self, output_file: Optional[str] = None):
        self.output_file = output_file
        self.e2e_latency: float = 0.0
        self.decode_latency: float = 0.0
        self.attention_latency: float = 0.0
        self.prompt_len: int = 0
        self.generated_len: int = 0
        self.TTFT: float = 0.0
        self.TPOT: float = 0.0
        # True when attn_mem/attn_comp are the runner's per-bucket
        # microbench estimates (runtime/runner.py), not per-iteration timings
        self.attn_is_estimate: bool = False
        # Analytic IO counters (bytes), same semantics as the reference:
        # KV_IO counts K+V bytes read by attention; Mask_IO counts mask
        # metadata bytes; QO_IO query+output bytes; QK_IO / softmax terms
        # model the dense-attention baseline (UNPAGED_MEDUSA only).
        self.KV_IO: float = 0.0
        self.QO_IO: float = 0.0
        self.Mask_IO: float = 0.0
        self.QK_IO: float = 0.0
        self.QK_scale_IO: float = 0.0
        self.QK_scale_masked_IO: float = 0.0
        self.SoftMax_IO: float = 0.0
        # Per-iteration latency vectors (ms).
        self.iter_time: List[float] = []
        self.prepare_per_iter: List[float] = []
        self.forward_per_iter: List[float] = []
        self.branch_per_iter: List[float] = []
        self.attn_mem_per_iter: List[float] = []
        self.attn_comp_per_iter: List[float] = []
        self.traversal_per_iter: List[float] = []
        self.alloc_per_iter: List[float] = []
        self.positions_per_iter: List[float] = []
        self.tree_metadata_per_iter: List[float] = []
        self.input_metadata_per_iter: List[float] = []

    # -- per-iter update ---------------------------------------------------
    def update(
        self,
        iter_time: float = 0.0,
        prepare: float = 0.0,
        forward: float = 0.0,
        branch: float = 0.0,
        attn_mem: float = 0.0,
        attn_comp: float = 0.0,
        traversal: float = 0.0,
        alloc: float = 0.0,
        positions: float = 0.0,
        tree_metadata: float = 0.0,
        input_metadata: float = 0.0,
    ) -> None:
        self.iter_time.append(iter_time)
        self.prepare_per_iter.append(prepare)
        self.forward_per_iter.append(forward)
        self.branch_per_iter.append(branch)
        self.attn_mem_per_iter.append(attn_mem)
        self.attn_comp_per_iter.append(attn_comp)
        self.traversal_per_iter.append(traversal)
        self.alloc_per_iter.append(alloc)
        self.positions_per_iter.append(positions)
        self.tree_metadata_per_iter.append(tree_metadata)
        self.input_metadata_per_iter.append(input_metadata)

    # -- IO accounting (bytes; KV assumed 2-byte elements, K+V => *4) -------
    def update_dense_tree_attn_IO(
        self, q_len: int, kv_len: int, hidden_size: int, head_num: int
    ) -> None:
        """IO model for the dense masked-attention (Medusa) baseline
        (deft_tpu perf_metrics.py:94): materialized QK^T, scaled+masked
        scores, and softmax intermediates, mirroring the reference's
        update_Causal_Tree_Attn_IO (perf_metrics.py:124-163)."""
        score_bytes = q_len * kv_len * head_num * 2
        self.QK_IO += score_bytes * 2          # write + read
        self.QK_scale_IO += score_bytes * 2
        self.QK_scale_masked_IO += score_bytes * 2
        self.SoftMax_IO += score_bytes * 2
        self.Mask_IO += q_len * kv_len * 2     # dense mask reads
        self.KV_IO += kv_len * hidden_size * 4
        self.QO_IO += q_len * hidden_size * 4

    # -- aggregates ----------------------------------------------------------
    def update_e2e_latency(self, e2e_latency: float) -> None:
        self.e2e_latency = e2e_latency

    def update_decode_latency(self) -> float:
        """Sum of per-iteration forward time (each ends after the device)."""
        self.decode_latency = sum(self.forward_per_iter)
        return self.decode_latency

    def update_attention_latency(self) -> float:
        self.attention_latency = sum(self.attn_mem_per_iter) + sum(
            self.attn_comp_per_iter
        )
        return self.attention_latency

    def get_attention_mem_latency(self) -> float:
        return sum(self.attn_mem_per_iter)

    def get_attention_comp_latency(self) -> float:
        return sum(self.attn_comp_per_iter)

    def compute_tpot(self) -> float:
        if self.generated_len > 0:
            self.TPOT = self.decode_latency / self.generated_len
        return self.TPOT

    # -- output ----------------------------------------------------------------
    def as_dict(self) -> dict:
        return {
            "e2e_latency": self.e2e_latency,
            "decode_latency": self.decode_latency,
            "attention_latency": self.attention_latency,
            "prompt_len": self.prompt_len,
            "generated_len": self.generated_len,
            "TTFT": self.TTFT,
            "TPOT": self.TPOT,
            "attn_is_estimate": self.attn_is_estimate,
            "KV_IO": self.KV_IO,
            "QO_IO": self.QO_IO,
            "Mask_IO": self.Mask_IO,
            "QK_IO": self.QK_IO,
            "QK_scale_IO": self.QK_scale_IO,
            "QK_scale_masked_IO": self.QK_scale_masked_IO,
            "SoftMax_IO": self.SoftMax_IO,
            "iter_time": self.iter_time,
            "prepare_per_iter": self.prepare_per_iter,
            "forward_per_iter": self.forward_per_iter,
            "branch_per_iter": self.branch_per_iter,
            "attn_mem_per_iter": self.attn_mem_per_iter,
            "attn_comp_per_iter": self.attn_comp_per_iter,
            "traversal_per_iter": self.traversal_per_iter,
            "alloc_per_iter": self.alloc_per_iter,
            "positions_per_iter": self.positions_per_iter,
            "tree_metadata_per_iter": self.tree_metadata_per_iter,
            "input_metadata_per_iter": self.input_metadata_per_iter,
        }

    def dump(self) -> None:
        if self.output_file is not None:
            with open(self.output_file, "w") as f:
                json.dump(self.as_dict(), f)

    def dump_partial(self) -> None:
        """The aggregates so far, with ``"partial": true``, written to
        ``output_file + ".partial"`` atomically (a temporary file, then a
        rename), so that a run killed mid-write leaves no truncated JSON
        (deft_tpu perf_metrics.py:173-184).  dump() still writes the
        output file itself."""
        if self.output_file is None:
            return
        d = self.as_dict()
        d["partial"] = True
        tmp = self.output_file + ".partial.tmp"
        with open(tmp, "w") as f:
            json.dump(d, f)
        os.replace(tmp, self.output_file + ".partial")

    def print_latency(self) -> str:
        """Human-readable latency summary (reference: tabulated table,
        perf_metrics.py:165-219)."""
        self.update_decode_latency()
        self.update_attention_latency()
        self.compute_tpot()
        rows = [
            ("e2e latency (ms)", self.e2e_latency),
            ("TTFT (ms)", self.TTFT),
            ("decode latency (ms)", self.decode_latency),
            ("attention latency (ms)", self.attention_latency),
            ("attn mem mgmt (ms)", self.get_attention_mem_latency()),
            ("attn compute (ms)", self.get_attention_comp_latency()),
            ("TPOT (ms/token)", self.TPOT),
            ("generated tokens", self.generated_len),
            ("prompt tokens", self.prompt_len),
            ("KV IO (bytes)", self.KV_IO),
            ("Mask IO (bytes)", self.Mask_IO),
        ]
        width = max(len(name) for name, _ in rows)
        lines = [f"{name:<{width}} : {val:,.3f}" if isinstance(val, float)
                 else f"{name:<{width}} : {val:,}" for name, val in rows]
        out = "\n".join(lines)
        print(out)
        return out
