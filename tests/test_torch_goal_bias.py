"""Goal-biased parent selection: pathless parity with a goal_bias_k larger
than the R-row frontier buffer, against the JAX planner run op by op, and
the top-k's tie order against ``jax.lax.top_k``."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import cudasbmp_torch as ct
from cudasbmp_torch.planners import kgmt as tk
from test_torch_options_parity import assert_same_solve, jax_plan

torch.set_num_threads(2)


def test_pathless_goal_bias_k_above_R_matches_jax():
    """goal_bias_k = 1024 > R = 512: the biased slots index the top-k with
    modulus min(goal_bias_k, M) = 1024 (the JAX pathless loop's ``k_m``),
    so with 384 biased slots and a frontier of 32 (iteration 1), slots
    32-383 keep their round-robin parent."""
    cfg = dict(num_iterations=40, max_tree_size=8192, rollouts_per_iter=512,
               goal_bias=0.75, goal_bias_k=1024, need_path=False)
    want = jax_plan(cfg, 1)
    got = ct.KGMT(ct.KGMTConfig(**cfg), device="cpu").plan(ct.Scenario.demo(), seed=1)
    assert want.solved
    assert_same_solve(got, want)
    assert want.metrics["frontier_size"][1] < 384


def test_goal_bias_tie_order_matches_top_k():
    """Equal distances (duplicated rows) come out lowest index first, as
    ``jax.lax.top_k`` orders them; ``torch.topk`` promises no order, so the
    port sorts stably."""
    cfg = ct.KGMTConfig(rollouts_per_iter=64, goal_bias=0.5, goal_bias_k=8,
                        max_tree_size=4096)
    r = np.random.default_rng(0)
    rows = r.integers(0, 4, (40, 2)).astype(np.float32)  # many exact ties
    goal = np.array([1.0, 2.0], np.float32)
    d2 = ((rows[:, 0] - goal[0]) ** 2 + (rows[:, 1] - goal[1]) ** 2).astype(np.float32)
    _, near = jax.lax.top_k(-jnp.asarray(d2), 8)
    rr = torch.arange(64) % 40
    got = tk._goal_biased(cfg, torch.tensor(rows), torch.tensor(goal), rr, 100)
    n_biased = 32
    want = 100 + np.asarray(near)[np.arange(n_biased) % 8]
    np.testing.assert_array_equal(got[:n_biased].numpy(), want)
    np.testing.assert_array_equal(got[n_biased:].numpy(), rr[n_biased:].numpy())
