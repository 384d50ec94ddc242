from deft_tpu_torch.obs.logger import create_logger
from deft_tpu_torch.obs.timers import GlobalTimer
from deft_tpu_torch.obs.perf_metrics import PerfMetrics
from deft_tpu_torch.obs.tracing import Tracer

__all__ = ["create_logger", "GlobalTimer", "PerfMetrics", "Tracer"]
