"""The streaming Monte-Carlo sweep (cudasbmp_torch/parallel/streaming_mc.py)
on the CPU: per-scenario (cost, iterations) bit for bit against the JAX
package's StreamingMonteCarloPlanner run op by op (jax.disable_jit), its
scenario generator bit for bit, the invariances the JAX tests assert
(pool size, id-range partitions), the zero budget, and that a drained
slot, which draws from scenario 0's stream as in the JAX package, reaches
no output."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudasbmp_torch import rng
from cudasbmp_torch.config import KGMTConfig
from cudasbmp_torch.geometry.grid import RegionGrid
from cudasbmp_torch.parallel import StreamingMonteCarloPlanner, make_planner_mesh
from cudasbmp_torch.parallel import streaming_mc as tsm
from cudasbmp_torch.systems import get_system
from cudasbmp_tpu import KGMTConfig as JConfig
from cudasbmp_tpu.geometry.grid import RegionGrid as JGrid
from cudasbmp_tpu.parallel import streaming_mc as jsm

torch.set_num_threads(2)
CFG = dict(rollouts_per_iter=128, num_iterations=12, adaptive_waves=False,
           max_tree_size=2)  # the streaming planner keeps no tree
TCFG = KGMTConfig(rollout_backend="auto", **CFG)
GRID = RegionGrid(20.0, 20.0, 16, 8)


def planner(pool: int, cfg: KGMTConfig = TCFG) -> StreamingMonteCarloPlanner:
    return StreamingMonteCarloPlanner(cfg, pool=pool, device="cpu")


def test_per_scenario_results_match_op_by_op_jax():
    with jax.disable_jit():
        want = jsm.StreamingMonteCarloPlanner(
            JConfig(rollout_backend="jnp", **CFG), pool=4).run(
                num_scenarios=10, seed=0, num_obstacles=5)
    got = planner(4).run(num_scenarios=10, seed=0, num_obstacles=5)
    np.testing.assert_array_equal(got.costs, want.costs)
    np.testing.assert_array_equal(got.iters, want.iters)
    assert 0.3 <= got.solve_rate < 1.0  # solved and exhausted scenarios both
    assert got.num_budget_exhausted == want.num_budget_exhausted
    assert got.cost_quantiles == want.cost_quantiles


def test_scenario_generator_bitwise_against_op_by_op_jax():
    ids = np.array([0, 1, 5, 17, 4096, 2**20], np.int32)
    jcfg = JConfig(**CFG)
    with jax.disable_jit():
        want = jsm._gen_scenarios(jcfg, JGrid(20.0, 20.0, 16, 8), jax.random.key(3),
                                  jnp.asarray(ids), 5, 8, 4)
    got = tsm._gen_scenarios(TCFG, GRID, rng.key(3), torch.tensor(ids), 5, 8, 4)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(w).view(np.uint32))
    j1, j2 = jsm._init_region_onehots(jcfg, JGrid(20.0, 20.0, 16, 8),
                                      jnp.asarray(got[1].numpy()[:, 0:2]))
    t1, t2 = tsm._init_region_onehots(TCFG, GRID, got[1][:, 0:2])
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(j2))


def test_stream_more_scenarios_than_pool():
    s = planner(4).run(num_scenarios=10, seed=1, num_obstacles=5)
    assert s.costs.shape == (10,) and s.iters.shape == (10,)
    assert (np.isfinite(s.costs) | (s.iters >= CFG["num_iterations"])).all()
    assert (s.iters[np.isfinite(s.costs)] >= 1).all()
    assert s.num_budget_exhausted == int((~np.isfinite(s.costs)).sum())


@pytest.mark.parametrize("backend", ["auto", "cuda_rng"])
def test_pool_size_and_partitions_give_the_same_results(backend):
    """Scenario ids key the generator and the search streams, so the pool
    size and an id-range partition change nothing, bit for bit; under
    ``cuda_rng`` too (each slot's Philox stream is keyed by its own key)."""
    cfg = TCFG.replace(rollout_backend=backend)
    single = planner(4, cfg).run(num_scenarios=12, seed=7, num_obstacles=5)
    wide = planner(8, cfg).run(num_scenarios=12, seed=7, num_obstacles=5)
    np.testing.assert_array_equal(wide.costs, single.costs)
    np.testing.assert_array_equal(wide.iters, single.iters)
    parts = [planner(4, cfg).run(num_scenarios=4, seed=7, num_obstacles=5, id_lo=lo)
             for lo in (0, 4, 8)]
    np.testing.assert_array_equal(np.concatenate([p.costs for p in parts]), single.costs)
    np.testing.assert_array_equal(np.concatenate([p.iters for p in parts]), single.iters)
    assert np.isfinite(single.costs).any()


def test_stream_zero_budget():
    s = planner(4, TCFG.replace(num_iterations=0)).run(num_scenarios=4, seed=0,
                                                       num_obstacles=5)
    assert s.solve_rate == 0.0 and s.num_budget_exhausted == 4


def test_drained_slots_draw_scenario_0s_stream_but_write_nothing():
    """ROADMAP section C: a slot with no scenario left (scn_id -1) keys its
    waves with scenario 0's id, as ``maximum(scn_id, 0)`` does in the JAX
    package. Its lanes are masked invalid, so its counts, frontier, cost and
    the per-scenario rows stay as they were."""
    system = get_system("bicycle")
    s = tsm.stream_init(TCFG, GRID, rng.key(2), 4, 128, 2, 5, 8, 4)
    assert s.scn_id.tolist() == [0, 1, -1, -1]
    keys = rng.fold_in(rng.fold_in(s.key, s.scn_id.clamp(min=0)), s.slot_it)
    assert torch.equal(keys[2], keys[0]) and torch.equal(keys[3], keys[0])
    before = {f.name: getattr(s, f.name) for f in dataclasses.fields(s)
              if isinstance(getattr(s, f.name), torch.Tensor)}
    before = {k: v.clone() for k, v in before.items()}
    tsm.stream_iteration(TCFG, system, GRID, 128, 2, 5, 8, s)
    for name in ("p_x0", "p_cost", "n_parents", "obstacles", "init", "goal",
                 "scn_id", "slot_it", "cost_to_goal", "r1_total", "r1_valid",
                 "r2_valid"):
        now, was = getattr(s, name)[2:], before[name][2:]
        assert torch.equal(now, was), name
    assert not torch.equal(s.r1_total[:2], before["r1_total"][:2])  # live slots moved
    # the whole sweep: drained slots (pool 8 over 3 scenarios) change nothing
    small = planner(3).run(num_scenarios=3, seed=4, num_obstacles=5)
    padded = planner(8).run(num_scenarios=3, seed=4, num_obstacles=5)
    np.testing.assert_array_equal(padded.costs, small.costs)
    np.testing.assert_array_equal(padded.iters, small.iters)


def test_run_sharded_equals_one_pool_and_the_refusals():
    """run_sharded over a one-process mesh of 4 scenario slots (one pool of
    2 a slot, ids [2k, 2k + 2)) is bitwise run() on one pool
    (tests/test_streaming_mc.py:75-83 for the JAX planner); an uneven split
    raises the JAX package's ValueError (tests/test_streaming_mc.py:85-90),
    as do too many obstacles; mesh= does not shard run()."""
    mesh = make_planner_mesh(n_scenario=4, device="cpu")
    sharded = planner(2).run_sharded(num_scenarios=8, mesh=mesh, seed=5, num_obstacles=5)
    single = planner(4).run(num_scenarios=8, seed=5, num_obstacles=5)
    np.testing.assert_array_equal(sharded.costs, single.costs)
    np.testing.assert_array_equal(sharded.iters, single.iters)
    assert sharded.num_scenarios == 8 and sharded.solve_rate == single.solve_rate
    with pytest.raises(ValueError, match="divide evenly"):
        planner(4).run_sharded(num_scenarios=6, mesh=mesh, seed=0, num_obstacles=5)
    with pytest.raises(ValueError, match="obstacles"):
        planner(4).run(num_scenarios=2, num_obstacles=40)
    on_mesh = StreamingMonteCarloPlanner(TCFG, pool=4, mesh=mesh).run(
        num_scenarios=8, seed=5, num_obstacles=5)
    np.testing.assert_array_equal(on_mesh.costs, single.costs)