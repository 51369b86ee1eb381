"""Whole-solve parity with the planner options on: goal bias (top-k parent
pick) and the oriented-footprint narrow phase, in tree mode, seeds 0-1, at
small_config, against the JAX planner run op by op (jax.disable_jit; see
tests/test_torch_kgmt_parity.py for why not jitted). Equal (solved,
iterations, tree_size, cost) and path nodes, and per-iteration metrics."""

import jax
import numpy as np
import pytest
import torch

import cudasbmp_torch as ct
import cudasbmp_tpu as jt

torch.set_num_threads(2)
OPTIONS = dict(num_iterations=100, max_tree_size=16384, rollouts_per_iter=2048,
               goal_bias=0.25, footprint_width=0.5)


def jax_plan(cfg: dict, seed: int):
    with jax.disable_jit():
        return jt.KGMT(jt.KGMTConfig(**cfg)).plan(jt.Scenario.demo(), seed=seed)


def assert_same_solve(got, want):
    assert (got.solved, got.iterations, got.tree_size) == (
        want.solved, want.iterations, want.tree_size)
    assert got.cost == want.cost
    for k in ("frontier_size", "valid", "accepted", "tree_size"):
        np.testing.assert_array_equal(got.metrics[k], want.metrics[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 1])
def test_tree_solve_with_options_matches_jax(seed):
    want = jax_plan(OPTIONS, seed)
    got = ct.KGMT(ct.KGMTConfig(**OPTIONS), device="cpu").plan(ct.Scenario.demo(), seed=seed)
    assert want.solved
    assert_same_solve(got, want)
    np.testing.assert_array_equal(got.path_nodes, want.path_nodes)
    np.testing.assert_allclose(got.path, want.path, atol=1e-3, rtol=0)


def test_anytime_mode_keeps_the_cheapest_goal_hit():
    """stop_on_first_solution=False runs through the budget (or a full tree)
    and keeps the cheapest goal hit: never dearer than the first one, and
    its path ends in the goal region."""
    cfg = ct.KGMTConfig(**dict(OPTIONS, num_iterations=20))
    first = ct.KGMT(cfg, device="cpu").plan(ct.Scenario.demo(), seed=0)
    any_ = ct.KGMT(cfg.replace(stop_on_first_solution=False), device="cpu").plan(
        ct.Scenario.demo(), seed=0)
    assert first.solved and any_.solved
    assert any_.iterations == 20 or any_.tree_size == cfg.max_tree_size
    assert any_.iterations > first.iterations and any_.cost <= first.cost
    goal = ct.Scenario.demo().goal
    assert np.hypot(*(any_.path[-1, :2] - goal[:2])) < cfg.goal_threshold
    assert float(any_.state.costs[int(any_.path_nodes[-1])]) == any_.cost
