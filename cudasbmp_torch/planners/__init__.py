from cudasbmp_torch.planners.base import Planner
from cudasbmp_torch.planners.costprop import CostPropPlanner
from cudasbmp_torch.planners.kgmt import (
    KGMT,
    KGMTResult,
    KGMTState,
    PathlessState,
)
from cudasbmp_torch.planners.naive import NaivePlanner, ProbeResult

__all__ = ["KGMT", "KGMTResult", "KGMTState", "PathlessState", "Planner",
           "NaivePlanner", "CostPropPlanner", "ProbeResult"]
