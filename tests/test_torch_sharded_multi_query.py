"""The port's sharded multi-query planner (cudasbmp_torch/parallel/
sharded_multi_query.py) on the CPU: B problems of D shards each, stacked
as B*D trees on one device.

- Each problem equals, bit for bit, the port's ShardedTreePlanner solve of
  that problem under its key ``fold_in(key(seed), b)`` (the problems end at
  different iterations, so the early ones stay frozen while the rest run).
- One iteration at B = 2 x D = 2, against each problem's iteration in
  op-by-op JAX (``jax.disable_jit``; ``kgmt_iteration`` under ``vmap`` over
  the tree axis, its sub-wave loop as masked trips:
  tests/test_torch_sharded_tree.py's helpers), every field bitwise but the
  rolled-out states and the scores, within STATE_TOL (glibc's and SLEEF's
  trig an ulp apart, XLA's own order for the score sum).
- The whole solve against the JAX package's jitted ShardedMultiQueryPlanner
  at tests/test_parallel.py:261-320's config and mesh (4 x 2 on the 8-device
  CPU mesh), over 16 problems: jitted XLA contracts FMAs (ROADMAP.md,
  parity rules), so the trajectories part within a few iterations and the
  comparison is statistical: solve counts within 3, the median cost within
  10% and the mean iterations within 15% (the bands of
  tests/test_torch_sharded_tree_stats.py).
- Two runs give the same bits; the refusals."""

import time

import jax
import numpy as np
import pytest
import torch

import cudasbmp_torch as ct
import cudasbmp_tpu as jt
from cudasbmp_torch import rng
from cudasbmp_torch.parallel import (
    ShardedMultiQueryPlanner,
    ShardedTreePlanner,
    make_planner_mesh,
)
from cudasbmp_torch.parallel import sharded_tree as st
from cudasbmp_tpu.parallel.mesh import make_planner_mesh as jax_mesh
from cudasbmp_tpu.parallel.sharded_multi_query import (
    ShardedMultiQueryPlanner as JaxShardedMultiQueryPlanner,
)
from test_torch_sharded_tree import SMALL, _jax_config, _masked_while_loop, assert_fields_equal

torch.set_num_threads(2)
PARALLEL = dict(num_iterations=60, max_tree_size=8192, rollouts_per_iter=1024,
                adaptive_waves=False)  # tests/test_parallel.py:271-272


def batch(B: int, seed: int = 0):
    """B demo starts with goals near the demo goal (tests/test_parallel.py's
    draws)."""
    base = ct.Scenario.demo()
    r = np.random.default_rng(seed)
    inits = np.tile(base.init, (B, 1)).astype(np.float32)
    goals = np.tile(base.goal, (B, 1)).astype(np.float32)
    goals[:, 0] = r.uniform(1.0, 3.0, B)
    goals[:, 1] = r.uniform(16.5, 18.5, B)
    return inits, goals, base.padded_obstacles(8)[0]


def planner(cfg: dict, D: int, n_scenario: int = 1) -> ShardedMultiQueryPlanner:
    return ShardedMultiQueryPlanner(ct.KGMTConfig(**cfg), mesh=make_planner_mesh(
        n_scenario=n_scenario, n_tree=D, device="cpu"))


def test_each_problem_is_the_sharded_tree_under_its_key():
    """Three problems of two shards, one box set each (problem 1's with an
    extra box), goal bias and adaptive waves; problems 0 and 1 reach goals
    below the long wall within a few iterations, problem 2 runs out of
    budget on the demo goal, so 0 and 1 are frozen for its last
    iterations."""
    cfg = dict(num_iterations=8, max_tree_size=4096, rollouts_per_iter=256,
               goal_bias=0.25)
    D, seed = 2, 7
    inits, goals, boxes = batch(3)
    goals[0, :2], goals[1, :2], goals[2, :2] = (9.0, 3.0), (10.5, 4.5), (2.0, 18.0)
    per = np.stack([boxes] * 3)
    per[1, 6] = (6.0, 8.0, 7.0, 9.0)
    p = planner(cfg, D)
    res = p.plan_batch(inits, goals, per, seed=seed)
    assert res.solved[:2].all() and not res.solved[2]
    assert res.iterations[2] == cfg["num_iterations"] > max(res.iterations[:2])
    one = ShardedTreePlanner(ct.KGMTConfig(**cfg),
                             mesh=make_planner_mesh(n_tree=D, device="cpu"))
    for b in range(3):
        sc = ct.Scenario(init=inits[b], goal=goals[b], obstacles=per[b])
        s = one._init(sc, None, None, key=rng.fold_in(rng.key(seed), b))
        st.sharded_run(one.config, one.system, one.grid, torch.as_tensor(goals[b]),
                       torch.as_tensor(per[b]).expand(D, -1, -1).contiguous(), s)
        want = one._build_result(s, time.perf_counter())
        assert res.solved[b] == want.solved and res.iterations[b] == want.iterations, b
        assert res.costs[b:b + 1].view(np.uint32) == np.float32(want.cost).view(np.uint32)
        assert res.total_tree_sizes[b] == want.total_tree_size, b
        np.testing.assert_array_equal(res.paths[b].view(np.uint32),
                                      want.path.view(np.uint32), err_msg=str(b))
        np.testing.assert_array_equal(res.path_shards[b], want.path_shards)
        if want.solved:
            assert res.best_shards[b] == want.best_shard


def problem_fields(s: st.ShardedState, b: int, D: int) -> dict:
    """Problem b's trees as the JAX package's stacked KGMTState arrays."""
    out = {}
    for name in st.STATE_FIELDS:
        if name == "itr":
            out[name] = np.full(D, s.itr, np.int32)
            continue
        v = getattr(s, name)[b * D:(b + 1) * D].numpy().copy()
        if name == "key":
            v = v.astype(np.uint32)
        elif name in ("frontier_lo", "tree_size"):
            v = v.astype(np.int32)
        out[name] = v
    return out


def test_one_iteration_at_two_by_two_matches_op_by_op_jax():
    from functools import partial

    import jax.numpy as jnp

    from cudasbmp_tpu.geometry.grid import RegionGrid as JGrid
    from cudasbmp_tpu.planners import kgmt as jk
    from cudasbmp_tpu.systems.registry import get_system as jget_system
    from test_torch_sharded_tree import to_jax, jax_fields

    cfg = dict(SMALL, goal_bias=0.25)
    D, start = 2, 1
    inits, goals, boxes = batch(2, seed=3)
    p = planner(cfg, D)
    roots, goal_rows, tree_boxes = p._inputs(inits, goals, boxes)
    s = p._init(2, roots, seed=4)
    for _ in range(start):
        _, trips = st.sharded_readout(p.config, s)
        st.sharded_iteration(p.config, p.system, p.grid, goal_rows, tree_boxes, s, trips)
    before = [problem_fields(s, b, D) for b in range(2)]
    _, trips = st.sharded_readout(p.config, s)
    st.sharded_iteration(p.config, p.system, p.grid, goal_rows, tree_boxes, s, trips)
    jcfg = _jax_config(cfg)
    grid = JGrid(width=jcfg.width, height=jcfg.height, N=jcfg.N, n=jcfg.n)
    for b in range(2):
        step = jax.vmap(partial(jk.kgmt_iteration, jcfg, jget_system(jcfg.system), grid,
                                jnp.asarray(boxes), jnp.asarray(goals[b]),
                                axis_name="tree"), axis_name="tree")
        with jax.disable_jit(), _masked_while_loop(trips) as conds:
            want = jax_fields(step(to_jax(before[b])))
        assert conds[trips] and not any(conds[trips])
        got = problem_fields(s, b, D)
        assert_fields_equal(got, want, states=True)
        assert (got["tree_size"] > before[b]["tree_size"]).all()
    # the two problems' trees differ: each problem its own statistics
    assert not np.array_equal(problem_fields(s, 0, D)["r1_score"],
                              problem_fields(s, 1, D)["r1_score"])


def test_whole_solve_against_the_jax_planner():
    inits = np.concatenate([batch(8, seed=0)[0], batch(8, seed=1)[0]])
    goals = np.concatenate([batch(8, seed=0)[1], batch(8, seed=1)[1]])
    boxes = batch(1)[2]
    j = JaxShardedMultiQueryPlanner(jt.KGMTConfig(**PARALLEL),
                                    mesh=jax_mesh(n_scenario=4, n_tree=2)).plan_batch(
        inits, goals, boxes, seed=3)
    t = planner(PARALLEL, 2, n_scenario=4).plan_batch(inits, goals, boxes, seed=3)
    assert abs(int(j.solved.sum()) - int(t.solved.sum())) <= 3, (j.solved, t.solved)
    assert t.solved.sum() >= 12
    j_med, t_med = np.median(j.costs[j.solved]), np.median(t.costs[t.solved])
    assert abs(t_med - j_med) <= 0.10 * j_med, (j_med, t_med)
    assert abs(t.iterations.mean() - j.iterations.mean()) <= 0.15 * j.iterations.mean()
    for b in np.flatnonzero(t.solved):
        path = t.paths[b]
        np.testing.assert_allclose(path[0, :2], inits[b, :2])
        assert np.hypot(*(path[-1, :2] - goals[b, :2])) < PARALLEL.get("goal_threshold", 1.0)
        assert abs(path[1:, 6].sum() - t.costs[b]) < 1e-3
        assert t.path_shards[b].shape == (len(path),) and t.path_shards[b][-1] == t.best_shards[b]
    assert (t.total_tree_sizes > 1).all()


def test_deterministic_and_the_refusals():
    cfg = dict(SMALL, num_iterations=8)
    inits, goals, boxes = batch(2, seed=5)
    a = planner(cfg, 4).plan_batch(inits, goals, boxes, seed=9)
    b = planner(cfg, 4).plan_batch(inits, goals, boxes, seed=9)
    np.testing.assert_array_equal(a.costs, b.costs)
    np.testing.assert_array_equal(a.total_tree_sizes, b.total_tree_sizes)
    for x, y in zip(a.paths, b.paths):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="divisible by the scenario-axis size 4"):
        planner(cfg, 1, n_scenario=4).plan_batch(inits, goals, boxes)
    with pytest.raises(ValueError, match="requires a"):
        ShardedMultiQueryPlanner(ct.KGMTConfig(**cfg))
