"""The flatten kernel lab's exp2 probe, as the Hopper kernel B15.

Port of _probe_kernel (deft_tpu experiments/kernel_lab.py:763, launched by
make_exp2_probe's pallas_call :790): ``nb`` steps of ``passes`` sweeps of
x <- exp2(-0.9999 x) over an (Rq, width) fp32 tile carried from step to
step; the first ``d`` columns come out as (1, Rq, d).  The TPU kernel starts
its tile at -0.5 inside the kernel; here the start tile ``x0`` is the input
(the lab passes -0.5 everywhere), so the wrapper can tell a CUDA call from a
CPU one.  CUDA tensors launch csrc/lab_probe.cu (its header gives the bound:
the card's exp2 rate) or raise; CPU tensors run the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from deft_tpu_torch.ops import _cuda

_P, _I = ctypes.c_void_p, ctypes.c_int
_PROBE_ARGS = [_P, _P, _P, _I, _I, _I, _I, _I, _P]
# the factor of each sweep (kernel_lab.py:775)
DECAY = -0.9999


def lab_exp2_probe_plain(x0: torch.Tensor, nb: int, passes: int, d: int) -> torch.Tensor:
    """B15's function in plain torch."""
    x = x0.float()
    for _ in range(nb * passes):
        x = torch.exp2(x * DECAY)
    return x[None, :, :d].contiguous()


def lab_exp2_probe(x0: torch.Tensor, nb: int, passes: int, d: int) -> torch.Tensor:
    """B15: the (1, Rq, d) fp32 first columns of the (Rq, width) fp32 tile
    ``x0`` after nb * passes exp2 sweeps.  CUDA tensors launch
    csrc/lab_probe.cu; CPU tensors run the plain version."""
    if x0.device.type == "cpu":
        return lab_exp2_probe_plain(x0, nb, passes, d)
    rq, width = x0.shape
    _cuda.require(x0.dtype == torch.float32 and x0.is_contiguous(),
                  "the probe takes a contiguous fp32 tile")
    _cuda.require(0 < d <= width and nb > 0 and passes > 0,
                  "the probe takes nb, passes > 0 and d <= width")
    _cuda.require_device(x0)
    o = torch.empty((1, rq, d), dtype=torch.float32, device=x0.device)
    tile = torch.empty_like(x0)  # the carried tile, written back whole
    fn = _cuda.bind("lab_probe", "deft_lab_probe", _PROBE_ARGS)
    err = fn(x0.data_ptr(), o.data_ptr(), tile.data_ptr(), rq, width, d, nb, passes,
             _cuda.stream_ptr(x0.device))
    _cuda.check(err, "deft_lab_probe")
    lab_exp2_probe.launches += 1
    return o


lab_exp2_probe.launches = 0
