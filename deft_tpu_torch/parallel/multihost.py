"""Process-group start-up for multi-process runs.

Port of deft_tpu/parallel/multihost.py:45-132.  deft_tpu's single
controller sees every device after ``jax.distributed.initialize``; the
port runs one process per rank, so ``init_runtime`` joins this process to a
``torch.distributed`` process group, from the caller's settings or from
torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT,
LOCAL_WORLD_SIZE).  Every rank then runs the same tree_generate loop: the
tree state and the plans are host numpy built from identical inputs, and
every rank holds the same logits, so every rank branches the same way.

The backend is explicit, "nccl" or "gloo" (default: nccl on cuda, gloo on
cpu).  NCCL refuses two ranks on one card ("Duplicate GPU detected"), so
asking for it with more ranks on a host than cards raises, naming gloo; the
port never switches backend on its own.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from deft_tpu_torch.parallel.mesh import Grid, make_mesh

BACKENDS = ("nccl", "gloo")


def check_backend(backend: str, ranks_on_host: int, device: str) -> None:
    """Refuse a backend that cannot run ``ranks_on_host`` ranks of this
    host on ``device``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {', '.join(BACKENDS)}")
    if backend != "nccl":
        return
    if device != "cuda":
        raise ValueError("the nccl backend runs on cuda; pass backend='gloo' for "
                         "ranks on the CPU")
    cards = torch.cuda.device_count()
    if ranks_on_host > cards:
        raise ValueError(
            f"nccl cannot run {ranks_on_host} ranks on {cards} GPU(s) of this host: "
            "it refuses two ranks on one card ('Duplicate GPU detected'); pass "
            "backend='gloo', which moves CUDA tensors through the host")


def init_runtime(backend: Optional[str] = None, *, rank: Optional[int] = None,
                 world_size: Optional[int] = None,
                 init_method: Optional[str] = None,
                 device: str = "cuda") -> bool:
    """Join the process group.  Returns True when a multi-process group is
    active after the call.  Settings not given come from torchrun's
    environment; a no-op when a group already exists or there is one
    process."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    world = world_size if world_size is not None else int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    rank = rank if rank is not None else int(os.environ["RANK"])
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    on_host = (world if world_size is not None
               else int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    check_backend(backend, on_host, device)
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world)
    return True


def is_primary() -> bool:
    """True on exactly one process (rank 0): the gate for logs and dumps."""
    return not dist.is_initialized() or dist.get_rank() == 0


def make_pod_mesh(*, num_kv_heads: Optional[int] = None,
                  shape: Optional[Tuple[int, int, int]] = None,
                  device: str = "cuda") -> Grid:
    """This rank's (dp, sp, tp) grid over every rank of the process group
    (one rank without a group): make_mesh over the whole world, tp
    innermost, so tp and sp stay on neighbouring ranks (one host under
    torchrun's rank order) and dp strides across hosts."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh(world, num_kv_heads=num_kv_heads, shape=shape, device=device)
