"""Statistical parity of the port with the jitted JAX planner over 32 seeds
at small_config: solve counts within 2, median costs within 10%."""

import numpy as np
import torch

import cudasbmp_torch as ct
import cudasbmp_tpu as jt

torch.set_num_threads(2)
SMALL = dict(num_iterations=100, max_tree_size=16384, rollouts_per_iter=2048)


def test_solve_rate_and_cost_band_over_32_seeds():
    jp = jt.KGMT(jt.KGMTConfig(**SMALL))
    tp = ct.KGMT(ct.KGMTConfig(**SMALL))
    j = [jp.plan(jt.Scenario.demo(), seed=s) for s in range(32)]
    t = [tp.plan(ct.Scenario.demo(), seed=s) for s in range(32)]
    j_solved = sum(r.solved for r in j)
    t_solved = sum(r.solved for r in t)
    assert abs(j_solved - t_solved) <= 2, (j_solved, t_solved)
    j_med = np.median([r.cost for r in j if r.solved])
    t_med = np.median([r.cost for r in t if r.solved])
    assert abs(t_med - j_med) <= 0.10 * j_med, (j_med, t_med)
    assert all(5.0 < r.cost < 25.0 for r in t if r.solved)
