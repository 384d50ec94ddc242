"""The (dp, sp, tp) grid of ranks.

Port of deft_tpu/parallel/mesh.py:26-62.  deft_tpu builds one JAX ``Mesh``
over the devices a single controller drives; on the GPU the grid is one
process per rank over ``torch.distributed``, and each rank holds a ``Grid``:
its coordinates, its device, and one process group per axis (a
``DeviceMesh`` with mesh_dim_names ("dp", "sp", "tp"), tp innermost as in
deft_tpu, so tensor-parallel collectives join neighbouring ranks), plus the
(sp, tp) group the expert-parallel MoE block reduces over.

- ``tp`` shards attention heads and the Megatron columns and rows;
- ``sp`` shards the flattened tree-KV blocks (flatten) or each leaf's path
  blocks (seq), and the experts of a MoE layer;
- ``dp`` shards a decode step's query rows (leaves) through every layer;
  ``sp`` also shards a prefill's tokens (parallel/sharding.py).

Every collective of the port is an ``all_reduce`` (or a broadcast), so the
same code runs over NCCL with a card per rank and over gloo with several
ranks on one card (gloo moves CUDA tensors through the host).
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from deft_tpu_torch.obs.timers import sync_check_lowered

AXES = ("dp", "sp", "tp")
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _factor(n: int, num_kv_heads: int) -> Tuple[int, int, int]:
    """Pick (dp, tp, sp) for n devices: tp as large as the KV-head count
    allows (TP attention is embarrassingly parallel over kv heads — the
    reference kernel's grid axis 0), then sp, then dp."""
    tp = 1
    while (tp * 2 <= n and n % (tp * 2) == 0
           and num_kv_heads % (tp * 2) == 0 and tp < 8):
        tp *= 2
    rest = n // tp
    sp = 1
    while sp * 2 <= rest and rest % (sp * 2) == 0 and sp < 4:
        sp *= 2
    dp = rest // sp
    assert dp * tp * sp == n, (n, dp, tp, sp)
    return dp, tp, sp


def rank_device(rank: int, device: str) -> torch.device:
    """Rank r's device: cuda:{r % device_count}, or the CPU when asked."""
    if device == "cpu":
        return torch.device("cpu")
    if device != "cuda":
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for but no GPU is available "
                           "(pass device='cpu' to run on the CPU)")
    return torch.device("cuda", rank % torch.cuda.device_count())


class Grid:
    """One rank's view of the (dp, sp, tp) grid: ``shape`` and ``coords``
    by axis name, its ``device`` and the process groups of its axes.  A grid
    of size 1 has no groups and runs no collective."""

    def __init__(self, shape: Sequence[int], rank: int, device: torch.device,
                 groups: Optional[Dict[Union[str, Tuple[str, ...]], object]] = None):
        self.shape = dict(zip(AXES, (int(x) for x in shape)))
        self.size = math.prod(self.shape.values())
        self.rank = rank
        dp, sp, tp = (self.shape[a] for a in AXES)
        self.coords = {"dp": rank // (sp * tp), "sp": rank // tp % sp, "tp": rank % tp}
        self.device = device
        self._groups = groups or {}
        # collectives gloo staged through the host, and the seconds they
        # took: CUDA tensors over gloo (several ranks on one card), which
        # NCCL with a card per rank runs on the device
        self.staged = 0
        self.staged_s = 0.0

    def __repr__(self) -> str:
        return (f"Grid(shape={self.shape}, rank={self.rank}, coords={self.coords}, "
                f"device={self.device})")

    def axis_size(self, *axes: str) -> int:
        return math.prod(self.shape[a] for a in axes)

    @property
    def host_staged(self) -> bool:
        """True where the grid's collectives on its device's tensors go
        through the host: CUDA tensors over gloo."""
        return (self.device.type == "cuda" and dist.is_initialized()
                and dist.get_backend() == "gloo")

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def all_reduce(self, t: torch.Tensor, axes: Union[str, Tuple[str, ...]],
                   op: str = "sum") -> torch.Tensor:
        """All-reduce ``t`` in place over the ranks that share this rank's
        coordinates off ``axes`` (one axis name or a tuple); returns t."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        if self.axis_size(*names) == 1:
            return t
        group = self._groups[names if len(names) > 1 else names[0]]
        if t.is_cuda and dist.get_backend(group) == "gloo":
            # gloo copies a CUDA tensor to the host and waits for that copy
            # in its own thread: the backend's wait, not the port's, so it
            # runs with torch's sync debug mode lowered, and is counted
            self.staged += 1
            t0 = time.perf_counter()
            with sync_check_lowered():
                dist.all_reduce(t, op=_OPS[op], group=group)
            self.staged_s += time.perf_counter() - t0
            return t
        dist.all_reduce(t, op=_OPS[op], group=group)
        return t


def make_mesh(n_devices: Optional[int] = None, *, num_kv_heads: Optional[int] = None,
              shape: Optional[Tuple[int, int, int]] = None,
              device: str = "cuda") -> Grid:
    """This rank's (dp, sp, tp) grid over the first ``n_devices`` ranks of
    the process group (all of them by default; one rank without a group).
    ``shape`` (dp, sp, tp) defaults to deft_tpu's factoring of n over the
    model's ``num_kv_heads``, which is then required.  Every rank calls it,
    in the same order as its other group constructors."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = n_devices or world
    if shape is None:
        if num_kv_heads is None:
            raise ValueError("make_mesh needs the model's num_kv_heads to factor "
                             "the grid when no shape is given")
        dp, tp, sp = _factor(n, num_kv_heads)
        shape = (dp, sp, tp)
    shape = tuple(int(x) for x in shape)
    if math.prod(shape) != n:
        raise ValueError(f"grid {shape} does not hold {n} ranks")
    if n > world:
        raise ValueError(f"a grid of {n} ranks in a process group of {world} "
                         "(start the ranks with parallel.launch or torchrun)")
    rank = dist.get_rank() if dist.is_initialized() else 0
    dev = rank_device(rank, device)
    if n == 1:
        return Grid(shape, 0, dev)
    if n != world:
        raise ValueError(f"a grid of {n} ranks must span the process group of "
                         f"{world}")
    from torch.distributed.device_mesh import init_device_mesh

    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = init_device_mesh(dev.type, shape, mesh_dim_names=AXES)
    groups: Dict[Union[str, Tuple[str, ...]], object] = {
        a: mesh.get_group(a) for a in AXES}
    dp, sp, tp = shape
    for d in range(dp):  # the (sp, tp) plane of each dp index, in order on every rank
        g = dist.new_group(list(range(d * sp * tp, (d + 1) * sp * tp)))
        if rank // (sp * tp) == d:
            groups[("sp", "tp")] = g
    return Grid(shape, rank, dev, groups)
