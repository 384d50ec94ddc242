"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds).  Libraries land in ``build/`` at the root of the checkout,
named by a hash of the sources, so an edited source is rebuilt and an
unchanged one is reused.  Nothing here runs at import: the first launch
builds what it needs, and ``build_all`` builds every kernel at once, one
``nvcc`` per source, in parallel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("prefill", "paged_flatten", "paged_seq", "flatten_gather", "seq_gather",
           "int8_matmul", "gmm", "lab_flatten", "lab_probe")
HEADERS = ("flash_common.cuh", "flatten_body.cuh", "flat_q_body.cuh", "seq_body.cuh",
           "seq_q_body.cuh", "hopper.cuh")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# ptxas register / shared-memory report of each build, by source name (a
# library built before is read back from the .log file beside it)
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (set CUDA_HOME)")


def library_path(name: str) -> Path:
    """Where the library of csrc/<name>.cu is (or will be) built: named by
    a hash of the source, the headers and the flags."""
    h = hashlib.sha256()
    for f in [CSRC / f"{name}.cu"] + [CSRC / x for x in HEADERS]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str) -> Optional[tuple]:
    """Start nvcc for ``name`` unless its library is already built (then
    its build's ptxas report is read back into build_log)."""
    out = library_path(name)
    if out.exists():
        report = out.with_suffix(".log")
        if report.exists():
            build_log.setdefault(name, report.read_text())
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return name, proc, tmp, out


def _finish(job: tuple) -> None:
    name, proc, tmp, out = job
    log, _ = proc.communicate()
    build_log[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)


def build_all(names: Iterable[str] = SOURCES) -> None:
    """Build every listed kernel library, all nvcc processes at once."""
    with _lock:
        jobs = [j for j in (_start(n) for n in names) if j is not None]
        errors = []
        for job in jobs:
            try:
                _finish(job)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(library_path(name)))
                _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (read once)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(dtype) -> int:
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"CUDA kernels take float32 or bfloat16, not {dtype}")
    return codes[dtype]


def bind(name: str, entry: str, argtypes: list):
    """The C function ``entry`` of csrc/<name>.cu, its argument types set
    once (ctypes passes an unset pointer argument as a 32-bit int)."""
    fn = getattr(library(name), entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """Device address of a tensor, None (a null pointer) for None."""
    return None if t is None else t.data_ptr()


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it at a 16-byte aligned address (a view at an odd
    offset): TMA and 16-byte cp.async read from such addresses only."""
    return t.clone() if t.data_ptr() % 16 else t


def require_device(first: torch.Tensor, *rest: torch.Tensor) -> None:
    """Every tensor on the CUDA device of ``first``."""
    require(first.device.type == "cuda"
            and all(t.device == first.device for t in rest),
            f"the kernel takes tensors on one CUDA device, got "
            f"{sorted({str(t.device) for t in (first, *rest)})}")
