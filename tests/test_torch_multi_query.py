"""The vmapped multi-query planner (cudasbmp_torch/parallel/multi_query.py)
on the CPU against the JAX package: each batched problem against the JAX
single solve (kgmt_solve + extract_path) on its key fold_in(key(seed), b),
run op by op (jax.disable_jit). A vmapped JAX while_loop cannot run op by
op, and jitted, XLA:CPU contracts FMAs and the trajectories part; the JAX
MultiQueryPlanner computes exactly vmap of that single solve, so the single
solve per problem is the reference.

Parity, as tests/test_torch_kgmt_parity.py holds the single solve: solved,
iterations and tree sizes equal; costs within rel 1e-5; path nodes equal
and paths within 1e-3 (glibc and SLEEF trig differ by an ulp)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cudasbmp_tpu as jt
from cudasbmp_torch.config import KGMTConfig, Scenario
from cudasbmp_torch.parallel import MultiQueryPlanner
from cudasbmp_tpu.geometry.grid import RegionGrid as JGrid
from cudasbmp_tpu.planners.kgmt import extract_path, kgmt_solve
from cudasbmp_tpu.systems.registry import get_system as jget_system

torch.set_num_threads(2)
SMALL = dict(num_iterations=100, max_tree_size=16384, rollouts_per_iter=2048)
B, SEED = 3, 5


def demo_batch(n: int, jitter_seed: int = 0):
    """n demo pairs, each goal jittered by U(-1, 1) (the CLI's multi)."""
    base = Scenario.demo()
    inits = np.tile(base.init, (n, 1)).astype(np.float32)
    goals = np.tile(base.goal, (n, 1)).astype(np.float32)
    goals[:, :2] += np.random.default_rng(jitter_seed).uniform(
        -1.0, 1.0, (n, 2)).astype(np.float32)
    return inits, goals, base.padded_obstacles(8)[0]


def test_each_problem_equals_the_op_by_op_jax_single_solve():
    inits, goals, obstacles = demo_batch(B)
    res = MultiQueryPlanner(KGMTConfig(**SMALL), device="cpu").plan_batch(
        inits, goals, obstacles, seed=SEED)
    jcfg = jt.KGMTConfig(**SMALL)
    grid = JGrid(width=jcfg.width, height=jcfg.height, N=jcfg.N, n=jcfg.n)
    system = jget_system(jcfg.system)
    assert res.paths.shape == (B, SMALL["num_iterations"] + 1, 7)
    for b in range(B):
        with jax.disable_jit():
            final = kgmt_solve(jcfg, system, grid, jnp.asarray(inits[b]),
                               jnp.asarray(goals[b]), jnp.asarray(obstacles),
                               jax.random.fold_in(jax.random.key(SEED), b))
            nodes, samples, length = extract_path(jcfg, final)
        cost = float(final.cost_to_goal)
        assert res.solved[b] == np.isfinite(cost), b
        assert res.iterations[b] == int(final.itr), b
        assert res.tree_sizes[b] == int(final.tree_size), b
        assert res.costs[b] == pytest.approx(cost, rel=1e-5), b
        assert res.path_lengths[b] == int(length), b
        np.testing.assert_allclose(res.paths[b], np.asarray(samples), atol=1e-3, rtol=0)
    assert res.solved.all() and not res.budget_exhausted.any()
    assert len(set(res.iterations.tolist())) > 1  # problems finish on different trips
