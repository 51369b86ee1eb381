from cudasbmp_torch.utils.metrics import (
    iteration_metrics_table,
    region_entropy,
    summarize_result,
)
from cudasbmp_torch.utils.profiling import Timer, phase_scope, trace_to

__all__ = ["Timer", "iteration_metrics_table", "phase_scope", "region_entropy",
           "summarize_result", "trace_to"]
