"""The Monte-Carlo sweep (cudasbmp_torch/parallel/monte_carlo.py) on the
CPU: ``random_scenarios`` bit for bit against the JAX package's, run op by
op (jax.disable_jit; jitted, XLA:CPU may fuse the uniform draws'
multiply-add), and the sweep over the batched arena."""

import jax
import numpy as np
import pytest
import torch

from cudasbmp_torch import rng
from cudasbmp_torch.config import KGMTConfig
from cudasbmp_torch.parallel import MonteCarloPlanner, random_scenarios
from cudasbmp_tpu import KGMTConfig as JConfig
from cudasbmp_tpu.parallel.monte_carlo import random_scenarios as j_random_scenarios

torch.set_num_threads(2)
ARENA = dict(rollouts_per_iter=128, max_tree_size=128 * 31, num_iterations=30)


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


def test_vmap_impl_and_mesh_are_not_yet_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP item 22"):
        MonteCarloPlanner(KGMTConfig(**ARENA), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 23"):
        MonteCarloPlanner(KGMTConfig(**ARENA), impl="arena", mesh=object(),
                          device="cpu")
