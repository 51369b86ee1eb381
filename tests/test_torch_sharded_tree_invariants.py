"""The sharded-tree planner's invariants on the port, on the CPU: those
of tests/test_parallel.py:96-186, 224-260 and 323 at their sizes (eight
shards of 2,048 slots, one wave of 512 an iteration): identical global
score rows, determinism, one path chain across shards, a walled-in shard
that grows only through the exchange, plan_checkpointed equal to plan()
and resumable, and the stop flag; checkpoints each package reads from the
other; the mesh and the planner's refusals."""

import dataclasses

import numpy as np
import pytest
import torch

import cudasbmp_torch as ct
from cudasbmp_torch.parallel import ShardedTreePlanner, make_planner_mesh
from cudasbmp_torch.parallel import sharded_tree as st
from test_torch_sharded_tree import (
    assert_fields_equal,
    jax_fields,
    planner,
    port_state,
    to_jax,
)

torch.set_num_threads(2)
# tests/test_parallel.py's sharded sizes
SHARDED = dict(num_iterations=60, max_tree_size=2048, rollouts_per_iter=512,
               adaptive_waves=False)



@pytest.fixture(scope="module")
def eight_shards():
    return planner(SHARDED, 8).plan(ct.Scenario.demo())


def test_solves_with_identical_global_scores(eight_shards):
    res = eight_shards
    assert res.solved and res.cost > 0
    assert res.total_tree_size > SHARDED["max_tree_size"] // 2
    assert res.path.shape[1] == 7
    assert np.hypot(res.path[-1, 0] - 2.0, res.path[-1, 1] - 18.0) < 1.0
    scores = res.r1_scores_by_shard
    assert scores.shape == (8, 256)
    for i in range(1, 8):
        np.testing.assert_array_equal(scores[0], scores[i])


def test_deterministic(eight_shards):
    again = planner(SHARDED, 8).plan(ct.Scenario.demo())
    assert again.cost == eight_shards.cost and again.best_shard == eight_shards.best_shard
    np.testing.assert_array_equal(again.path, eight_shards.path)


def test_path_is_one_chain_across_shards(eight_shards):
    res = eight_shards
    assert res.path_shards.shape[0] == res.path.shape[0]
    np.testing.assert_allclose(res.path[0, :2], [5.0, 5.0])
    assert abs(res.path[1:, 6].sum() - res.cost) < 1e-3
    assert res.path_shards[-1] == res.best_shard
    assert len(set(res.path_shards.tolist())) > 1, "the path stays in one shard"


def test_sterile_shard_rescued_by_exchange():
    base = ct.Scenario.demo()
    trap = np.array([[14.0, 14.0, 16.0, 16.0]], np.float32)
    sc = ct.Scenario(init=base.init, goal=base.goal,
                     obstacles=np.concatenate([base.obstacles, trap]))
    inits = np.tile(base.init, (8, 1)).astype(np.float32)
    inits[1, 0], inits[1, 1] = 15.0, 15.0  # inside the trap
    with_ex = planner(SHARDED, 8).plan(sc, inits=inits)
    assert with_ex.solved
    assert with_ex.tree_sizes_by_shard[1] > 1
    no_ex = planner(dict(SHARDED, exchange_frac=0.0), 8).plan(sc, inits=inits)
    assert no_ex.tree_sizes_by_shard[1] == 1


def test_plan_checkpointed_matches_plan_and_resumes(tmp_path, eight_shards):
    p = planner(SHARDED, 8)
    r = p.plan_checkpointed(ct.Scenario.demo(), tmp_path, checkpoint_every=3)
    assert r.solved and r.cost == eight_shards.cost
    np.testing.assert_array_equal(r.path, eight_shards.path)
    ckpts = sorted(tmp_path.glob("sharded_checkpoint_*.npz"),
                   key=lambda q: int(q.stem.split("_")[-1]))
    assert len(ckpts) >= 2
    r2 = p.plan_checkpointed(ct.Scenario.demo(), tmp_path / "resumed",
                             checkpoint_every=3, resume_from=ckpts[0])
    assert r2.solved and r2.cost == eight_shards.cost
    np.testing.assert_array_equal(r2.path, eight_shards.path)
    np.testing.assert_array_equal(r2.tree_sizes_by_shard, eight_shards.tree_sizes_by_shard)
    bad = planner(SHARDED, 4)
    with pytest.raises(ValueError, match="tree shards"):
        bad.plan_checkpointed(ct.Scenario.demo(), tmp_path / "bad", resume_from=ckpts[0])


def test_stop_on_first_solution_flag():
    cfg = dict(num_iterations=20, max_tree_size=8192, rollouts_per_iter=1024,
               adaptive_waves=False, stop_on_first_solution=False)
    r = planner(cfg, 8).plan(ct.Scenario.demo())
    assert r.iterations == 20
    r2 = planner(dict(cfg, stop_on_first_solution=True), 8).plan(ct.Scenario.demo())
    assert r2.solved and r2.iterations < 20


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A port checkpoint loads with the JAX loader, field for field; a JAX
    one (the stacked state saved by the JAX package) resumes in the port to
    the bits of an uninterrupted port solve."""
    from cudasbmp_tpu.io.checkpoint import load_checkpoint as jload
    from cudasbmp_tpu.io.checkpoint import save_checkpoint as jsave

    cfg = dict(num_iterations=12, max_tree_size=1024, rollouts_per_iter=256)
    p, s, _, _ = port_state(cfg, 2, 3, seed=5)
    st.save_sharded_checkpoint(s, tmp_path / "port")
    assert_fields_equal(jax_fields(jload(tmp_path / "port.npz")),
                         st.sharded_state_to_numpy(s))
    jsave(to_jax(st.sharded_state_to_numpy(s)), tmp_path / "jax.npz")
    resumed = p.plan_checkpointed(ct.Scenario.demo(), tmp_path / "ck",
                                  resume_from=tmp_path / "jax.npz")
    whole = p.plan(ct.Scenario.demo(), seed=5)
    assert dataclasses.astuple(resumed)[:5] == dataclasses.astuple(whole)[:5]
    np.testing.assert_array_equal(resumed.path, whole.path)


def test_mesh_and_refusals():
    mesh = make_planner_mesh(n_tree=4, device="cpu")
    assert mesh.shape == {"scenario": 1, "tree": 4} and mesh.device == "cpu"
    assert make_planner_mesh(2, 3).shape == {"scenario": 2, "tree": 3}
    with pytest.raises(ValueError):
        make_planner_mesh(n_scenario=0)
    with pytest.raises(ValueError, match="requires a mesh"):
        ShardedTreePlanner(ct.KGMTConfig())
    with pytest.raises(ValueError, match="inits must be"):
        planner(SHARDED, 2).plan(ct.Scenario.demo(), inits=np.zeros((3, 7), np.float32))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            ShardedTreePlanner(ct.KGMTConfig(), mesh=make_planner_mesh(n_tree=2))
