"""The Monte-Carlo sweep (cudasbmp_torch/parallel/monte_carlo.py) on the
CPU: ``random_scenarios`` bit for bit against the JAX package's, run op by
op (jax.disable_jit; jitted, XLA:CPU may fuse the uniform draws'
multiply-add), the sweep over the batched arena, and the default vmap
sweep, each scenario against the single-query solve on its own box set."""

import jax
import numpy as np
import pytest
import torch

from cudasbmp_torch import rng
from cudasbmp_torch.config import KGMTConfig
from cudasbmp_torch.parallel import MonteCarloPlanner, make_planner_mesh, random_scenarios
from cudasbmp_torch.planners.kgmt import kgmt_solve
from cudasbmp_tpu import KGMTConfig as JConfig
from cudasbmp_tpu.parallel.monte_carlo import random_scenarios as j_random_scenarios

torch.set_num_threads(2)
ARENA = dict(rollouts_per_iter=128, max_tree_size=128 * 31, num_iterations=30)
VMAP = dict(rollouts_per_iter=512, max_tree_size=8192, num_iterations=40)


@pytest.mark.parametrize("seed,batch,num_obstacles", [(0, 16, 8), (3, 5, 5), (11, 9, 12)])
def test_random_scenarios_bitwise_against_op_by_op_jax(seed, batch, num_obstacles):
    with jax.disable_jit():
        want = j_random_scenarios(jax.random.key(seed), batch, JConfig(),
                                  num_obstacles=num_obstacles)
    got = random_scenarios(rng.key(seed), batch, KGMTConfig(),
                           num_obstacles=num_obstacles)
    for w, g in zip(want, got):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))
    inits, _, obstacles = got
    assert obstacles.shape[1] == max(8, -(-num_obstacles // 8) * 8)
    assert ((inits[:, :2] > 0.5) & (inits[:, :2] < 19.5)).all()


def test_random_scenarios_reject_too_many_obstacles():
    with pytest.raises(ValueError, match="obstacles"):
        random_scenarios(rng.key(0), 2, KGMTConfig(max_obstacles=8), num_obstacles=9)


def test_arena_sweep_over_random_scenarios():
    mc = MonteCarloPlanner(KGMTConfig(**ARENA), impl="arena", device="cpu")
    s = mc.run(num_scenarios=8, seed=3, num_obstacles=5, max_extensions=1)
    assert s.num_scenarios == 8 and s.costs.shape == (8,)
    assert s.solve_rate >= 0.5, s.costs
    assert np.isfinite(s.costs[s.solved]).all() and (s.costs[s.solved] > 0).all()
    assert s.num_budget_exhausted == int((~s.solved).sum())
    again = mc.run(num_scenarios=8, seed=3, num_obstacles=5, max_extensions=1)
    np.testing.assert_array_equal(again.costs, s.costs)


def test_vmap_sweep_equals_single_solves_on_each_box_set():
    """impl='vmap' (the default): every scenario with the whole single-query
    solve on its own box set and the key fold_in(key(seed + 1), b), bit for
    bit; max_extensions belongs to the arena."""
    cfg = KGMTConfig(**VMAP)
    mc = MonteCarloPlanner(cfg, device="cpu")
    s = mc.run(num_scenarios=5, seed=3, num_obstacles=5)
    assert s.costs.shape == (5,) and s.solve_rate >= 0.6, s.costs
    assert s.num_budget_exhausted == int((~s.solved).sum())
    inits, goals, obstacles = random_scenarios(rng.key(3), 5, cfg, num_obstacles=5)
    planner = mc.planner
    for b in range(5):
        one = kgmt_solve(cfg, planner.system, planner.grid, torch.tensor(inits[b]),
                         torch.tensor(goals[b]), torch.tensor(obstacles[b]),
                         rng.fold_in(rng.key(4), b))
        assert s.costs[b:b + 1].view(np.uint32) == one.cost_to_goal.reshape(1).numpy().view(
            np.uint32), b
        assert planner.last_state.tree_size[b] == one.tree_size, b
    with pytest.raises(ValueError, match="max_extensions requires impl='arena'"):
        mc.run(num_scenarios=2, seed=3, num_obstacles=5, max_extensions=1)


@pytest.mark.parametrize("impl", ["vmap", "arena"])
def test_one_process_mesh_equals_no_mesh(impl):
    """MonteCarloPlanner(mesh=...) hands the mesh to its planner: two
    scenario slots on one process give mesh=None's sweep to the bit, and an
    odd count of scenarios does not split over them."""
    cfg = KGMTConfig(**dict(ARENA, num_iterations=8) if impl == "arena" else
                     dict(VMAP, num_iterations=10))
    mesh = make_planner_mesh(n_scenario=2, device="cpu")
    got = MonteCarloPlanner(cfg, impl=impl, mesh=mesh).run(4, seed=3, num_obstacles=5)
    want = MonteCarloPlanner(cfg, impl=impl, device="cpu").run(4, seed=3, num_obstacles=5)
    np.testing.assert_array_equal(got.costs, want.costs)
    np.testing.assert_array_equal(got.solved, want.solved)
    assert got.mean_tree_size == want.mean_tree_size
    with pytest.raises(ValueError, match="divisible by the scenario-axis size 2"):
        MonteCarloPlanner(cfg, impl=impl, mesh=mesh).run(3, seed=3, num_obstacles=5)
