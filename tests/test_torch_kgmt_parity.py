"""Whole-solve parity of the port with the JAX planner at small_config,
seeds 0-3 (fixed), tree mode, and pathless mode on one seed.

The JAX planner runs op by op (jax.disable_jit). Jitted on XLA:CPU it also
contracts multiply-adds into FMAs and replaces division by a constant with
a reciprocal multiply; those ulps move lanes across cell edges and the
acceptance threshold, and the jitted trajectory then parts from the
op-by-op one within a few iterations (tests/test_torch_kgmt_seeds.py
compares the port with it statistically instead)."""

import jax
import numpy as np
import pytest
import torch

import cudasbmp_torch as ct
import cudasbmp_tpu as jt

torch.set_num_threads(2)
SMALL = dict(num_iterations=100, max_tree_size=16384, rollouts_per_iter=2048)


def _first_difference(a, b) -> str:
    for k in ("frontier_size", "valid", "accepted", "tree_size"):
        x, y = a.metrics[k], b.metrics[k]
        n = min(len(x), len(y))
        d = np.nonzero(x[:n] != y[:n])[0]
        if len(d):
            return (f"first differing iteration {d[0]} in '{k}' ({x[d[0]]} vs "
                    f"{y[d[0]]}): an ulp-level rollout or score-sum difference "
                    "moved a lane across a cell edge or the acceptance draw")
    return "metrics equal"


def _jax_plan(cfg, seed):
    with jax.disable_jit():
        return jt.KGMT(jt.KGMTConfig(**cfg)).plan(jt.Scenario.demo(), seed=seed)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_whole_solve_matches_jax(seed):
    want = _jax_plan(SMALL, seed)
    got = ct.KGMT(ct.KGMTConfig(**SMALL)).plan(ct.Scenario.demo(), seed=seed)
    why = _first_difference(want, got)
    assert got.solved == want.solved, why
    assert got.iterations == want.iterations, why
    assert got.tree_size == want.tree_size, why
    assert got.cost == pytest.approx(want.cost, rel=1e-5), why
    np.testing.assert_array_equal(got.path_nodes, want.path_nodes)
    np.testing.assert_allclose(got.path, want.path, atol=1e-3, rtol=0)


def test_pathless_solve_matches_jax():
    cfg = dict(SMALL, need_path=False)
    want = _jax_plan(cfg, 3)
    got = ct.KGMT(ct.KGMTConfig(**cfg)).plan(ct.Scenario.demo(), seed=3)
    why = _first_difference(want, got)
    assert (got.solved, got.iterations, got.tree_size) == (
        want.solved, want.iterations, want.tree_size), why
    assert got.cost == pytest.approx(want.cost, rel=1e-5), why
    np.testing.assert_array_equal(got.metrics["accepted"], want.metrics["accepted"])
