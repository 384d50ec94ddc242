"""The multi-device engine: one tree over a (dp, sp, tp) grid of ranks.

Port of deft_tpu/parallel/ over torch.distributed (mesh, multihost,
sharding, engine, seq_engine, moe; the exports of deft_tpu/parallel/
__init__.py:9-27 under the port's names), plus ``launch``, which starts the
ranks of a grid on one host, and ``dryrun_multichip``, the analogue of
deft_tpu's __graft_entry__.py:76-122.
"""

from __future__ import annotations

from deft_tpu_torch.parallel.engine import make_sharded_tree_attn
from deft_tpu_torch.parallel.launch import generate_tokens, launch
from deft_tpu_torch.parallel.mesh import Grid, _factor, make_mesh
from deft_tpu_torch.parallel.multihost import init_runtime, is_primary, make_pod_mesh
from deft_tpu_torch.parallel.seq_engine import make_sharded_seq_attn
from deft_tpu_torch.parallel.sharding import (RowWindow, batch_shardings, param_shardings,
                                              pool_specs, row_window, shard_batch,
                                              shard_decode_args, shard_params, shard_pool)

def dryrun_multichip(n_devices: int, device: str = "cuda", backend=None) -> None:
    """Full multi-device generation dryrun: an n-rank (dp, sp, tp) grid
    (deft_tpu's factoring for the tiny preset's 2 KV heads) started on this
    host, weights and pools sharded once at runner init, a short
    tree_generate through the grid engine (tiny preset, fp32, a 400-token
    prompt whose flatten plans stay segment-aligned, so each rank runs the
    partial paged kernel B1p and the LSE merge over sp), and its tokens held
    equal to one process's."""
    from deft_tpu_torch.config import EngineConfig
    from deft_tpu_torch.models import PRESETS

    cfg = PRESETS["tiny"]
    ecfg = EngineConfig(kv_pool_slots=4096, max_requests=16, max_context_len=512,
                        min_token_bucket=128, dtype="float32")
    prompt = [7 + (i % 97) for i in range(400)]
    args = (cfg, ecfg, prompt, "flatten", 4, len(prompt) + 12)
    want, _ = launch(generate_tokens, (1, 1, 1), device, args=args)
    dp, tp, sp = _factor(n_devices, cfg.num_kv_heads)
    got, paged = launch(generate_tokens, (dp, sp, tp), device, backend, args=args,
                        timeout=600)
    assert got == want and len(got) == 4, "sharded generation diverged from one process"
    assert all(paged), "the dryrun's plans were not segment-aligned (no paged kernel)"


__all__ = ["Grid", "RowWindow", "batch_shardings", "dryrun_multichip", "init_runtime",
           "is_primary", "launch", "make_mesh", "make_pod_mesh", "make_sharded_seq_attn",
           "make_sharded_tree_attn", "param_shardings", "pool_specs", "row_window",
           "shard_batch", "shard_decode_args", "shard_params", "shard_pool"]
