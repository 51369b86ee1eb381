"""Statistical parity of the port's sharded-tree planner with the jitted JAX
one (shard_map over a 2-shard tree axis of the 8-device CPU mesh), over 16
seeds of the demo in two configurations: one wave an iteration in small
shards (some seeds fail), and adaptive waves. Jitted JAX contracts FMAs,
so its trajectories part from the port's within a few iterations
(tests/test_torch_kgmt_parity.py); the bands are those of
tests/test_torch_kgmt_seeds.py, with the solve count's allowance scaled to
the seed count and the unsolved seeds."""

import numpy as np
import pytest
import torch

import cudasbmp_torch as ct
import cudasbmp_tpu as jt
from cudasbmp_torch.parallel import ShardedTreePlanner, make_planner_mesh
from cudasbmp_tpu.parallel import ShardedTreePlanner as JaxShardedTreePlanner
from cudasbmp_tpu.parallel import make_planner_mesh as jax_mesh

torch.set_num_threads(2)
SEEDS = range(16)


@pytest.mark.parametrize("cfg,solve_slack", [
    (dict(num_iterations=60, max_tree_size=4096, rollouts_per_iter=512,
          adaptive_waves=False), 3),
    (dict(num_iterations=40, max_tree_size=8192, rollouts_per_iter=1024), 2),
])
def test_solve_rate_cost_and_iterations_over_16_seeds(cfg, solve_slack):
    jp = JaxShardedTreePlanner(jt.KGMTConfig(**cfg), mesh=jax_mesh(n_scenario=4, n_tree=2))
    tp = ShardedTreePlanner(ct.KGMTConfig(**cfg),
                            mesh=make_planner_mesh(n_tree=2, device="cpu"))
    j = [jp.plan(jt.Scenario.demo(), seed=s) for s in SEEDS]
    t = [tp.plan(ct.Scenario.demo(), seed=s) for s in SEEDS]
    j_solved, t_solved = sum(r.solved for r in j), sum(r.solved for r in t)
    assert abs(j_solved - t_solved) <= solve_slack, (j_solved, t_solved)
    assert t_solved >= len(SEEDS) // 2
    j_med = np.median([r.cost for r in j if r.solved])
    t_med = np.median([r.cost for r in t if r.solved])
    assert abs(t_med - j_med) <= 0.10 * j_med, (j_med, t_med)
    j_it = np.mean([r.iterations for r in j])
    t_it = np.mean([r.iterations for r in t])
    assert abs(t_it - j_it) <= 0.15 * j_it, (j_it, t_it)
    for r in t:
        assert r.r1_scores_by_shard.shape == (2, 256)
        np.testing.assert_array_equal(r.r1_scores_by_shard[0], r.r1_scores_by_shard[1])
        if r.solved:
            assert abs(r.path[1:, 6].sum() - r.cost) < 1e-3
            assert np.hypot(r.path[-1, 0] - 2.0, r.path[-1, 1] - 18.0) < 1.0
