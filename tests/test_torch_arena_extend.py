"""One extension round of the batched arena (cudasbmp_torch/parallel/
batch_kgmt.py::ArenaMultiQueryPlanner._extend) on the CPU against the JAX
package's ArenaMultiQueryPlanner with the ``jnp`` backend run op by op
(jax.disable_jit), on the problems of tests/test_torch_arena.py.

With W = 5 windows and seed 2 the first round solves problem 1 and
exhausts the other three, so ``max_extensions=1`` re-plans those in a
bucket of 8 problems (padded with the first of them) with 2W windows and
the seed ``seed + 104729``: it solves problem 0 and leaves 2 and 3
exhausted. The merge keeps problem 1's first-round result and pads the
path axis to the longer budget. Parity as in test_torch_arena.py:
solved, iterations, tree sizes, path lengths, budget_exhausted and the
bucket equal; costs within rel 1e-5; paths within 1e-3."""

import jax
import numpy as np
import pytest
import torch

from cudasbmp_torch.config import KGMTConfig
from cudasbmp_torch.parallel import ArenaMultiQueryPlanner
from cudasbmp_tpu import KGMTConfig as JConfig
from cudasbmp_tpu.parallel.batch_kgmt import ArenaMultiQueryPlanner as JArena
from test_torch_arena import ARENA, problems

torch.set_num_threads(2)
W = 5  # first-round windows: the extension round runs 2W
EXTEND = dict(ARENA, num_iterations=W, max_tree_size=ARENA["rollouts_per_iter"] * (W + 1))
SEED = 2


def batch_sizes(planner_cls, monkeypatch) -> list[int]:
    """Record the batch of every plan_batch call of ``planner_cls``: the
    first round's, then each extension round's bucket."""
    seen, orig = [], planner_cls.plan_batch

    def spy(self, inits, *a, **k):
        seen.append(int(np.asarray(inits).shape[0]))
        return orig(self, inits, *a, **k)

    monkeypatch.setattr(planner_cls, "plan_batch", spy)
    return seen


@pytest.mark.parametrize("layout", ["shared", "per_problem"])
def test_extension_round_matches_op_by_op_jax(layout, monkeypatch):
    inits, goals, shared, per = problems()
    obstacles = shared if layout == "shared" else per
    want_batches = batch_sizes(JArena, monkeypatch)
    with jax.disable_jit():
        jplanner = JArena(JConfig(rollout_backend="jnp", **EXTEND), auto_capacity=True)
        want = jplanner.plan_batch(inits, goals, obstacles, seed=SEED, max_extensions=1)
    planner = ArenaMultiQueryPlanner(KGMTConfig(rollout_backend="torch", **EXTEND),
                                     auto_capacity=True, device="cpu")
    first = planner.plan_batch(inits, goals, obstacles, seed=SEED)
    got_batches = batch_sizes(ArenaMultiQueryPlanner, monkeypatch)
    got = planner.plan_batch(inits, goals, obstacles, seed=SEED, max_extensions=1)
    # the first round left a problem exhausted, so the round ran, in a bucket of 8
    assert first.budget_exhausted.any()
    assert want_batches == got_batches == [4, 8]
    assert set(planner._extensions) == set(jplanner._extensions) == {2 * W}
    np.testing.assert_array_equal(got.solved, want.solved)
    np.testing.assert_array_equal(got.iterations, want.iterations)
    np.testing.assert_array_equal(got.tree_sizes, want.tree_sizes)
    np.testing.assert_array_equal(got.path_lengths, want.path_lengths)
    np.testing.assert_array_equal(got.budget_exhausted, want.budget_exhausted)
    np.testing.assert_allclose(got.costs, want.costs, rtol=1e-5)
    assert got.paths.shape == want.paths.shape == (len(inits), 2 * W + 1, 7)
    np.testing.assert_allclose(got.paths, want.paths, atol=1e-3, rtol=0)
    # the merge: problems solved in the first round keep their first-round
    # result; the re-planned ones carry the extension's
    kept = ~first.budget_exhausted
    np.testing.assert_array_equal(got.iterations[kept], first.iterations[kept])
    np.testing.assert_array_equal(got.costs[kept], first.costs[kept])
    assert (got.iterations[~kept] > 0).all()
    assert list(first.solved) == [False, True, False, False]
    assert list(got.solved) == [True, True, False, False]
