"""Planner-state invariant checks (counterpart of
cudasbmp_tpu/utils/validate.py): after a solve, or in tests, that the tree
is well formed. The state's tensors are read to the host once.

Run it on a single-query KGMTState: the sharded tree's parents are global
ids (shard * M + slot) that may point into another shard, so "a parent
precedes its child" does not hold there (the JAX package checks sharded
results through their stitched paths instead).
"""

from __future__ import annotations

import numpy as np

from cudasbmp_torch.config import KGMTConfig
from cudasbmp_torch.planners.kgmt import KGMTState


class InvariantViolation(AssertionError):
    pass


def validate_state(state: KGMTState, cfg: KGMTConfig) -> dict:
    """Check the structural invariants; returns {"tree_size", "max_depth",
    "solved"} or raises InvariantViolation naming the broken one."""
    from cudasbmp_torch.convert import state_to_numpy

    host = state_to_numpy(state)
    n = int(host["tree_size"])
    M = cfg.max_tree_size
    parents = host["tree_parent"]
    costs = host["costs"]
    samples = host["tree_samples"]
    frontier_lo = int(host["frontier_lo"])

    def check(cond: bool, msg: str) -> None:
        if not cond:
            raise InvariantViolation(msg)

    check(1 <= n <= M, f"tree_size {n} outside [1, {M}]")
    # topological order: every non-root node's parent precedes it
    check(parents[0] == -1, "root parent must be -1")
    if n > 1:
        idx = np.arange(1, n)
        check((parents[1:n] >= 0).all(), "committed node with unset parent")
        check((parents[1:n] < idx).all(), "parent does not precede child")
        # cost recurrence: cost[child] = cost[parent] + duration(child)
        expect = costs[parents[1:n]] + samples[1:n, 6]
        check(np.allclose(costs[1:n], expect, rtol=1e-5, atol=1e-5),
              "cost[child] != cost[parent] + duration")
    check((parents[n:] == -1).all(), "parent set beyond tree_size")
    check(0 <= frontier_lo <= n, "frontier range outside tree")
    # committed samples inside the workspace (bounds are exclusive)
    xy = samples[1:n, :2]
    check((xy > 0).all() and (xy[:, 0] < cfg.width).all()
          and (xy[:, 1] < cfg.height).all(),
          "committed sample outside workspace")
    # region stats: valid + invalid == total per R1 cell
    r1t, r1v, r1i = host["r1_total"], host["r1_valid"], host["r1_invalid"]
    check((r1v + r1i == r1t).all(), "R1 valid+invalid != total")
    avail = host["r1_avail"]
    check((avail <= 1).all() and (avail >= 0).all(), "R1Avail not boolean")
    cost_to_goal = float(host["cost_to_goal"])
    goal_node = int(host["goal_node"])
    if np.isfinite(cost_to_goal):
        check(0 <= goal_node < n, "goal_node outside tree")
        check(np.isclose(costs[goal_node], cost_to_goal, rtol=1e-6),
              "cost_to_goal != costs[goal_node]")
    else:
        check(goal_node == -1, "goal_node set while unsolved")
    return {
        "tree_size": n,
        "max_depth": _max_depth(parents, n),
        "solved": bool(np.isfinite(cost_to_goal)),
    }


def _max_depth(parents: np.ndarray, n: int) -> int:
    depth = np.zeros(n, np.int32)
    for i in range(1, n):
        depth[i] = depth[parents[i]] + 1
    return int(depth.max()) if n else 0
