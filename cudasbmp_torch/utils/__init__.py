from cudasbmp_torch.utils.metrics import (
    iteration_metrics_table,
    region_entropy,
    summarize_result,
)

__all__ = ["iteration_metrics_table", "region_entropy", "summarize_result"]
