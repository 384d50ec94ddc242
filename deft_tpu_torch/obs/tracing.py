"""Device-level tracing of a run: named spans around prefill, plan build
and decode steps, and a Chrome trace of the host and the device.

Port of deft_tpu/obs/tracing.py:15 (Tracer), which wraps jax.profiler: here
``torch.profiler`` records the CPU and (where a GPU is present) CUDA
activity of a session and writes it under ``trace_dir`` as a Chrome trace
(chrome://tracing, Perfetto), and ``span`` is a
``torch.profiler.record_function`` range.  ``Tracer(None)`` is a no-op:
no profiler, and spans that cost nothing.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


class Tracer:
    """Optional torch.profiler session with named spans.

    Usage:
        tracer = Tracer("traces")   # or Tracer(None): a no-op
        with tracer.session():
            with tracer.span("decode_step"):
                ...
        tracer.trace_file           # the Chrome trace the session wrote
    """

    def __init__(self, trace_dir: Optional[str] = None):
        self.trace_dir = trace_dir
        self.trace_file: Optional[str] = None

    @contextlib.contextmanager
    def session(self) -> Iterator[None]:
        if self.trace_dir is None:
            yield
            return
        os.makedirs(self.trace_dir, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            yield
        self.trace_file = os.path.join(
            self.trace_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
        prof.export_chrome_trace(self.trace_file)

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        if self.trace_dir is None:
            yield
            return
        with torch.profiler.record_function(name):
            yield

    def annotate_fn(self, name: str, fn):
        """``fn`` with every call inside ``span(name)``."""
        def wrapped(*a, **k):
            with self.span(name):
                return fn(*a, **k)

        return wrapped
