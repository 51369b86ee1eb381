"""The vmapped multi-query planner with one box set per problem (a wall in
problem 1 changes problem 1 only; stacked scenarios of different box counts
against their single solves), budget_exhausted, zero iterations, the
refusals and a one-process mesh (helpers:
tests/test_torch_multi_query_batch.py)."""

import numpy as np
import pytest
import torch

from cudasbmp_torch.config import KGMTConfig, Scenario
from cudasbmp_torch.parallel import MultiQueryPlanner, make_planner_mesh, stack_scenarios
from test_torch_multi_query_batch import SMALL, assert_equals_single_solves, demo_batch

torch.set_num_threads(2)


def test_per_problem_boxes_stay_apart():
    """Obstacles [B, K, 4]: a wall across the workspace in problem 1 changes
    problem 1 only (each problem against its single solve on its own set:
    test_plan_scenarios_pads_box_sets_to_one_shape)."""
    cfg = KGMTConfig(**SMALL)
    inits, goals, shared = demo_batch(3, jitter_seed=2)
    per = np.stack([shared] * 3)
    planner = MultiQueryPlanner(cfg, device="cpu")
    base = planner.plan_batch(inits, goals, per, seed=4)
    walled = per.copy()
    walled[1, 6] = (0.0, 9.0, 20.0, 10.0)  # across the whole workspace
    res = planner.plan_batch(inits, goals, walled, seed=4)
    for f in ("solved", "costs", "iterations", "tree_sizes", "paths", "path_lengths"):
        np.testing.assert_array_equal(getattr(res, f)[[0, 2]], getattr(base, f)[[0, 2]])
    assert base.solved[1] and not res.solved[1]
    assert (res.iterations[1], res.tree_sizes[1]) != (base.iterations[1], base.tree_sizes[1])


def test_budget_exhausted_marks_the_unsolved_out_of_budget():
    """A tree too small to reach the goal fills (budget_exhausted); a goal
    reached in time does not; with an iteration cap the unsolved are marked
    too (cudasbmp_tpu/parallel/multi_query.py:140-141)."""
    inits, goals, obstacles = demo_batch(3, jitter_seed=1)
    goals[2, :2] = (16.0, 3.0)  # near the start: solved early
    res = MultiQueryPlanner(KGMTConfig(**{**SMALL, "max_tree_size": 6000}),
                            device="cpu").plan_batch(inits, goals, obstacles, seed=3)
    assert res.solved[2] and not res.budget_exhausted[2]
    np.testing.assert_array_equal(
        res.budget_exhausted, ~res.solved & ((res.iterations >= 100)
                                             | (res.tree_sizes >= 6000)))
    assert res.budget_exhausted[:2].all() and (res.tree_sizes[:2] == 6000).all()
    assert (res.path_lengths[:2] == 0).all() and not res.paths[:2].any()
    capped = MultiQueryPlanner(KGMTConfig(**{**SMALL, "num_iterations": 3}),
                               device="cpu").plan_batch(inits, goals, obstacles, seed=3)
    assert (capped.iterations <= 3).all()
    np.testing.assert_array_equal(capped.budget_exhausted, ~capped.solved)


def test_plan_scenarios_pads_box_sets_to_one_shape():
    """Scenarios of 5 and 12 boxes stacked to 16 rows each: every problem
    equals its single solve on its own padded set."""
    cfg = KGMTConfig(**{**SMALL, "max_obstacles": 32})
    scenarios = [Scenario.demo(), Scenario.dense(12, seed=1), Scenario.demo()]
    planner = MultiQueryPlanner(cfg, device="cpu")
    res = planner.plan_scenarios(scenarios, seed=2)
    inits, goals, obstacles = stack_scenarios(cfg, scenarios)
    assert obstacles.shape == (3, 16, 4)
    assert_equals_single_solves(planner, res, inits, goals, obstacles, 2)


def test_zero_iterations_and_the_refusals():
    inits, goals, obstacles = demo_batch(2)
    res = MultiQueryPlanner(KGMTConfig(**{**SMALL, "num_iterations": 0}),
                            device="cpu").plan_batch(inits, goals, obstacles)
    assert (res.iterations == 0).all() and (res.tree_sizes == 1).all()
    assert res.paths.shape == (2, 1, 7) and res.budget_exhausted.all()
    with pytest.raises(ValueError, match="batch size 2 must be divisible by the "
                       "scenario-axis size 4"):
        MultiQueryPlanner(KGMTConfig(**SMALL), mesh=make_planner_mesh(
            n_scenario=4, device="cpu")).plan_batch(inits, goals, obstacles)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            MultiQueryPlanner(KGMTConfig(**SMALL))


def test_one_process_mesh_equals_no_mesh():
    """A mesh of two scenario slots on one process: the batch solved as with
    mesh=None, field for field (tests/test_parallel.py:77-92 asserts the
    same for the JAX planner)."""
    cfg = KGMTConfig(**SMALL)
    inits, goals, obstacles = demo_batch(4, jitter_seed=5)
    got = MultiQueryPlanner(cfg, mesh=make_planner_mesh(n_scenario=2, device="cpu")
                            ).plan_batch(inits, goals, obstacles, seed=5)
    want = MultiQueryPlanner(cfg, device="cpu").plan_batch(inits, goals, obstacles, seed=5)
    for f in ("solved", "costs", "tree_sizes", "iterations", "paths", "path_lengths",
              "budget_exhausted"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
