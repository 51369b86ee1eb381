"""cost_p50: the median trajectory time (the planner's cost) of every path
solved in the window."""

import numpy as np


def read(window):
    costs = np.concatenate([c.costs for c in window.calls])
    return float(np.median(costs)) if costs.size else None
