"""The vmapped multi-query planner (cudasbmp_torch/parallel/multi_query.py)
on the CPU against the port's own single-query solve: every batched problem
equals kgmt_solve + extract_path on its key fold_in(key(seed), b) bit for
bit, the state the solve reads included, under every rollout backend
(options: tests/test_torch_multi_query_options.py; box sets, budgets and
refusals: tests/test_torch_multi_query_boxes.py, split for the 60 s a file
of the 6-worker run)."""

import numpy as np
import pytest
import torch

from cudasbmp_torch import rng
from cudasbmp_torch.config import KGMTConfig, Scenario
from cudasbmp_torch.parallel import MultiQueryPlanner
from cudasbmp_torch.planners import kgmt as tk

torch.set_num_threads(2)
SMALL = dict(num_iterations=100, max_tree_size=16384, rollouts_per_iter=2048)
STATE_FIELDS = ("tree_samples", "tree_parent", "costs", "r1_total", "r1_valid",
                "r1_invalid", "r1_avail", "r1_score", "r2_avail")


def demo_batch(n: int, jitter_seed: int = 0):
    base = Scenario.demo()
    inits = np.tile(base.init, (n, 1)).astype(np.float32)
    goals = np.tile(base.goal, (n, 1)).astype(np.float32)
    goals[:, :2] += np.random.default_rng(jitter_seed).uniform(
        -1.0, 1.0, (n, 2)).astype(np.float32)
    return inits, goals, base.padded_obstacles(8)[0]


def bits(t) -> np.ndarray:
    a = np.asarray(t.numpy() if isinstance(t, torch.Tensor) else t)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_equals_single_solves(planner, res, inits, goals, obstacles, seed) -> list:
    """Problem b of the batch against the single solve on its key, bit for
    bit: the result, the path and the final state the solve reads. Returns
    the single solves' states."""
    cfg, s = planner.config, planner.last_state
    obstacles = np.broadcast_to(obstacles, (len(inits),) + obstacles.shape[-2:])
    singles = []
    for b in range(len(inits)):
        one = tk.kgmt_solve(cfg, planner.system, planner.grid,
                            torch.tensor(inits[b]), torch.tensor(goals[b]),
                            torch.tensor(np.ascontiguousarray(obstacles[b])),
                            rng.fold_in(rng.key(seed), b))
        nodes, samples, length = tk.extract_path(cfg, one)
        assert (res.iterations[b], res.tree_sizes[b], res.path_lengths[b]) == (
            one.itr, one.tree_size, int(length)), b
        assert bits(res.costs[b:b + 1]) == bits(one.cost_to_goal.reshape(1)), b
        np.testing.assert_array_equal(bits(res.paths[b]), bits(samples))
        for f in STATE_FIELDS:
            np.testing.assert_array_equal(bits(getattr(s, f)[b]),
                                          bits(getattr(one, f)), err_msg=f)
        assert (int(s.frontier_lo[b]), bool(s.stalled[b]), int(s.goal_node[b])) == (
            one.frontier_lo, one.stalled, int(one.goal_node))
        singles.append(one)
    return singles


def waves(cfg, one) -> int:
    """Waves a single solve ran: per iteration ceil(min(fanout * frontier, M
    - tree size at its start) / R), or 1 with fixed waves, from its metrics.
    The batched loop's trips are the most of any problem, as a vmapped
    while_loop's."""
    it = one.itr
    frontier = one.m_frontier_size[:it].astype(np.int64)
    start = np.concatenate([[1], one.m_tree_size[:it - 1]])
    n_tgt = np.minimum(cfg.fanout * frontier, cfg.max_tree_size - start)
    if not cfg.adaptive_waves:
        return int(np.minimum(n_tgt, 1).sum())
    return int((-(-n_tgt // cfg.rollouts_per_iter)).sum())


@pytest.mark.parametrize("name,options", [
    ("auto", {}),
    ("cuda_rng", dict(rollout_backend="cuda_rng")),
    ("torch", dict(rollout_backend="torch")),
])
def test_each_problem_equals_the_single_solve_bitwise(name, options):
    cfg = KGMTConfig(**{**SMALL, **options})
    inits, goals, obstacles = demo_batch(3, jitter_seed=1)
    planner = MultiQueryPlanner(cfg, device="cpu")
    res = planner.plan_batch(inits, goals, obstacles, seed=3)
    singles = assert_equals_single_solves(planner, res, inits, goals, obstacles, 3)
    assert planner.last_state.trips == max(waves(cfg, one) for one in singles)
    assert res.solves_per_sec > 0 and res.wall_time_s > 0
