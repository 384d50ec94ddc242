"""Named wall-clock timers.

Port of deft_tpu/obs/timers.py:17 (GlobalTimer).  ``stop(name, sync=device)``
waits for the device's queued work first: ``torch.cuda.synchronize`` where
the device is a GPU, nothing on the CPU (PyTorch's CPU ops are synchronous).
``sync_check_lowered`` lets a deliberate wait pass a run under torch's sync
debug mode.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch


def synchronize(device) -> None:
    """Wait for every kernel queued on ``device`` (no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def sync_check_lowered():
    """torch.cuda's sync debug mode off while the block runs, restored
    after: the decode path's deliberate waits (runtime/runner.py host_wait,
    gloo's staging of CUDA tensors in parallel/mesh.py) pass a run under
    ``torch.cuda.set_sync_debug_mode("error")``, which fails on any other."""
    debug = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(debug)


class GlobalTimer:
    """Static accumulating timers, milliseconds."""

    _starts: Dict[str, float] = {}
    _accum: Dict[str, float] = {}

    @staticmethod
    def start(name: str) -> None:
        GlobalTimer._starts[name] = time.perf_counter()

    @staticmethod
    def stop(name: str, sync=None) -> float:
        """Stop a span; if ``sync`` names a device, wait for it first."""
        if sync is not None:
            synchronize(sync)
        t0 = GlobalTimer._starts.pop(name, None)
        if t0 is None:
            return 0.0
        dt_ms = (time.perf_counter() - t0) * 1e3
        GlobalTimer._accum[name] = GlobalTimer._accum.get(name, 0.0) + dt_ms
        return dt_ms

    @staticmethod
    def get(name: str) -> float:
        return GlobalTimer._accum.get(name, 0.0)

    @staticmethod
    def reset(name: Optional[str] = None) -> None:
        if name is None:
            GlobalTimer._accum.clear()
            GlobalTimer._starts.clear()
        else:
            GlobalTimer._accum.pop(name, None)
            GlobalTimer._starts.pop(name, None)
