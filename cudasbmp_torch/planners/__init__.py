from cudasbmp_torch.planners.kgmt import (
    KGMT,
    KGMTResult,
    KGMTState,
    PathlessState,
)

__all__ = ["KGMT", "KGMTResult", "KGMTState", "PathlessState"]
