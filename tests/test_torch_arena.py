"""The batched arena (cudasbmp_torch/parallel/batch_kgmt.py) on the CPU:
whole solves against the JAX package's ArenaMultiQueryPlanner with the
``jnp`` backend run op by op (jax.disable_jit; jitted, XLA:CPU contracts
FMAs and the trajectories part), and the cases of tests/test_arena.py
that run in the tier-1 suite.

Parity: solved, iterations and tree sizes equal; costs within rel 1e-5;
paths within 1e-3 (glibc and SLEEF trig differ by an ulp). One problem of
each case stays unsolved, so the loop runs its whole window budget and the
unsolved iteration count is the global counter's."""

import warnings

import jax
import numpy as np
import pytest
import torch

from cudasbmp_torch.config import KGMTConfig, Scenario
from cudasbmp_torch.ops.rollout import rollout_batch
from cudasbmp_torch.parallel import ArenaMultiQueryPlanner, make_planner_mesh, stack_scenarios
from cudasbmp_torch.systems import get_system
from cudasbmp_tpu import KGMTConfig as JConfig
from cudasbmp_tpu.parallel.batch_kgmt import ArenaMultiQueryPlanner as JArena

torch.set_num_threads(2)
B, R, W = 4, 128, 12
ARENA = dict(rollouts_per_iter=R, max_tree_size=R * (W + 1), num_iterations=W,
             goal_bias_k=8)


def problems():
    """Four demo starts; three goals below the long wall within a dozen
    waves, one the demo goal (unsolved within W). Shared demo boxes, or a
    per-problem set with one extra box that differs per problem."""
    base = Scenario.demo()
    inits = np.tile(base.init, (B, 1)).astype(np.float32)
    goals = np.tile(base.goal, (B, 1)).astype(np.float32)
    r = np.random.default_rng(1)
    goals[:, 0] = r.uniform(8, 11, B)
    goals[:, 1] = r.uniform(2.5, 5, B)
    goals[3, :2] = (2.0, 18.0)
    shared, _ = base.padded_obstacles(8)
    per = np.stack([shared] * B)
    for b in range(B):
        per[b, 5] = (12.0 + b, 9.0, 13.0 + b, 14.0)
    return inits, goals, shared, per


def replay_error(path: np.ndarray) -> float:
    """Largest state error of an exact control replay of a stored path."""
    system = get_system("bicycle")
    p = torch.tensor(path)
    x1, _ = rollout_batch(system, p[:-1, :4], p[1:, 4:], 10,
                          torch.tensor(Scenario.demo().padded_obstacles(8)[0]),
                          20.0, 20.0)
    return float((x1 - p[1:, :4]).abs().max())


@pytest.mark.parametrize("layout,goal_bias,backend", [
    ("shared", 0.0, "torch"), ("shared", 0.25, "auto"),
    ("per_problem", 0.0, "auto"), ("per_problem", 0.25, "torch")])
def test_whole_arena_solve_matches_op_by_op_jax(layout, goal_bias, backend):
    inits, goals, shared, per = problems()
    obstacles = shared if layout == "shared" else per
    with jax.disable_jit():
        want = JArena(JConfig(rollout_backend="jnp", goal_bias=goal_bias, **ARENA)
                      ).plan_batch(inits, goals, obstacles, seed=5)
    got = ArenaMultiQueryPlanner(
        KGMTConfig(rollout_backend=backend, goal_bias=goal_bias, **ARENA),
        device="cpu").plan_batch(inits, goals, obstacles, seed=5)
    np.testing.assert_array_equal(got.solved, want.solved)
    np.testing.assert_array_equal(got.iterations, want.iterations)
    np.testing.assert_array_equal(got.tree_sizes, want.tree_sizes)
    np.testing.assert_array_equal(got.path_lengths, want.path_lengths)
    np.testing.assert_array_equal(got.budget_exhausted, want.budget_exhausted)
    np.testing.assert_allclose(got.costs, want.costs, rtol=1e-5)
    np.testing.assert_allclose(got.paths, want.paths, atol=1e-3, rtol=0)
    assert got.solved[:3].sum() >= 2 and not got.solved[3]
    assert got.iterations[3] == W and got.budget_exhausted[3]
    for b in np.flatnonzero(got.solved):
        path = got.paths[b, :got.path_lengths[b]]
        if layout == "shared":
            assert replay_error(path) < 1e-4
        assert got.costs[b] == pytest.approx(path[1:, 6].sum(), rel=1e-5)
        assert np.hypot(*(path[-1, :2] - goals[b, :2])) < 0.5


def test_arena_zero_iteration_budget():
    inits, goals, shared, _ = problems()
    cfg = KGMTConfig(**dict(ARENA, num_iterations=0))
    res = ArenaMultiQueryPlanner(cfg, device="cpu").plan_batch(inits, goals, shared)
    assert not res.solved.any()
    assert (res.path_lengths == 0).all()
    assert (res.tree_sizes == 1).all()  # just the root


def test_arena_start_in_goal_region():
    base = Scenario.demo()
    inits = np.tile(base.init, (2, 1)).astype(np.float32)
    goals = inits.copy()
    goals[:, 0] += 0.3
    cfg = KGMTConfig(**dict(ARENA, num_iterations=5, max_tree_size=R * 6))
    res = ArenaMultiQueryPlanner(cfg, device="cpu").plan_batch(
        inits, goals, base.padded_obstacles(8)[0], seed=0)
    assert res.solved.all() and (res.iterations == 1).all()


def test_arena_auto_capacity_derivation():
    cfg = KGMTConfig(**dict(ARENA, num_iterations=13, max_tree_size=1))
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the window-clamp warning must not fire
        p = ArenaMultiQueryPlanner(cfg, auto_capacity=True, device="cpu")
    assert p.n_windows == 13 and p.M == 14 * R
    with pytest.warns(UserWarning, match="windows < num_iterations"):
        q = ArenaMultiQueryPlanner(cfg.replace(max_tree_size=R * 5), device="cpu")
    assert q.n_windows == 4


def test_arena_budget_exhausted_flag():
    inits, goals, shared, _ = problems()
    cfg = KGMTConfig(**dict(ARENA, num_iterations=2, max_tree_size=R * 3))
    res = ArenaMultiQueryPlanner(cfg, device="cpu").plan_batch(inits, goals, shared)
    assert (res.budget_exhausted == ~res.solved).all()
    assert res.budget_exhausted.any()


def test_arena_progressive_extension_solves():
    """max_extensions: budget-exhausted problems restart with a doubled
    window budget; the merge pads paths to the longer budget."""
    inits, goals, shared, _ = problems()
    cfg = KGMTConfig(**dict(ARENA, num_iterations=4))
    planner = ArenaMultiQueryPlanner(cfg, auto_capacity=True, device="cpu")
    base = planner.plan_batch(inits, goals, shared, seed=2)
    assert base.budget_exhausted.any() and base.paths.shape[1] == 5
    ext = planner.plan_batch(inits, goals, shared, seed=2, max_extensions=2)
    assert ext.solved.sum() > base.solved.sum()
    assert ext.budget_exhausted.sum() < base.budget_exhausted.sum()
    assert ext.paths.shape[1] == 17 and set(planner._extensions) == {8, 16}
    for b in range(B):
        if ext.solved[b] and not base.solved[b]:
            L = int(ext.path_lengths[b])
            assert L >= 2 and replay_error(ext.paths[b, :L]) < 1e-4
        if base.solved[b]:  # solved in the first round: kept as it was
            assert ext.costs[b] == base.costs[b]


def test_plan_scenarios_stacks_to_one_padded_shape():
    scenarios = [Scenario.demo(), Scenario.dense(12, seed=0)]
    cfg = KGMTConfig(**dict(ARENA, num_iterations=2))
    obstacles = stack_scenarios(cfg, scenarios)[2]
    assert obstacles.shape == (2, 16, 4)
    res = ArenaMultiQueryPlanner(cfg, device="cpu").plan_scenarios(scenarios)
    assert res.solved.shape == (2,) and (res.tree_sizes >= 1).all()


def test_arena_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ArenaMultiQueryPlanner(KGMTConfig(**ARENA))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ArenaMultiQueryPlanner(KGMTConfig(**ARENA), mesh=make_planner_mesh(n_scenario=2))


@pytest.mark.parametrize("layout,backend", [("shared", "auto"), ("per", "cuda_rng")])
def test_one_process_mesh_equals_no_mesh(layout, backend):
    """A mesh of two scenario slots on one process solves the batch as
    mesh=None does, to the bit (tests/test_arena.py:85-98 asserts the same
    for the JAX arena), and a batch that does not split evenly over the
    scenario axis raises the JAX package's ValueError."""
    cfg = KGMTConfig(**dict(ARENA, num_iterations=6, rollout_backend=backend))
    inits, goals, shared, per = problems()
    obstacles = shared if layout == "shared" else per
    mesh = make_planner_mesh(n_scenario=2, device="cpu")
    got = ArenaMultiQueryPlanner(cfg, mesh=mesh).plan_batch(inits, goals, obstacles, seed=2)
    want = ArenaMultiQueryPlanner(cfg, device="cpu").plan_batch(inits, goals, obstacles,
                                                                seed=2)
    for f in ("solved", "costs", "tree_sizes", "iterations", "paths", "path_lengths",
              "budget_exhausted"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    with pytest.raises(ValueError, match="must be divisible by the scenario-axis size 3"):
        ArenaMultiQueryPlanner(cfg, mesh=make_planner_mesh(n_scenario=3, device="cpu")
                               ).plan_batch(inits, goals, obstacles)


@pytest.mark.parametrize("layout,backend", [("shared", "auto"), ("shared", "cuda_rng"),
                                            ("per", "cuda_rng"), ("shared", "torch")])
def test_a_share_of_a_wave_is_its_rows_of_the_whole_wave(layout, backend):
    """A rank's share of the arena's wave, problems [row0, B) under the one
    wave key, gives the whole wave's rows from row0 on, bit for bit: the
    shared-box draws of B2 from lane row0 * R (its ``lane0``), of the other
    backends from the same offset of the batch-wide draw, B6's keys from
    split's row0-th."""
    from cudasbmp_torch import rng
    from cudasbmp_torch.parallel import batch_kgmt as bk

    cfg = KGMTConfig(**dict(ARENA, rollout_backend=backend))
    inits, _, shared, per = problems()
    gen = np.random.default_rng(4)
    x0 = (np.tile(inits[:, None, :4], (1, R, 1))
          + gen.uniform(-0.5, 0.5, (B, R, 4))).astype(np.float32)
    x0, key = torch.tensor(x0), rng.key(11, "cpu")
    boxes = torch.tensor(shared if layout == "shared" else per)
    system = get_system("bicycle")
    whole = bk._rollout_wave(cfg, system, x0, boxes, key)
    for row0 in (1, 3):
        share = bk._rollout_wave(cfg, system, x0[row0:], boxes if layout == "shared"
                                 else boxes[row0:], key, row0=row0)
        for got, want in zip(share, whole):
            assert torch.equal(got, want[row0:]), (row0, got.dtype)
    with pytest.raises(ValueError, match="lane0"):
        bk._rollout_wave(cfg.replace(rollout_backend="cuda_rng"), system, x0,
                         torch.tensor(shared), key, row0=-1)
