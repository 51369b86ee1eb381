"""Pathless-mode parity with the planner options on (goal bias and the
footprint), seeds 0-1, against the JAX planner run op by op."""

import numpy as np
import pytest
import torch

import cudasbmp_torch as ct
from test_torch_options_parity import OPTIONS, assert_same_solve, jax_plan

torch.set_num_threads(2)


@pytest.mark.parametrize("seed", [0, 1])
def test_pathless_solve_with_options_matches_jax(seed):
    cfg = dict(OPTIONS, need_path=False)
    want = jax_plan(cfg, seed)
    got = ct.KGMT(ct.KGMTConfig(**cfg), device="cpu").plan(ct.Scenario.demo(), seed=seed)
    assert want.solved
    assert_same_solve(got, want)
    acc = got.metrics["accepted"]  # past R rows both drop; the port counts
    np.testing.assert_array_equal(got.metrics["dropped"],
                                  acc - np.minimum(acc, cfg["rollouts_per_iter"]))
