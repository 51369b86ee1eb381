"""The port's KGMT planner against the JAX package, wave by wave, plus the
port's own invariants (path replay, pathless equivalence, dispatch).

The JAX side runs op by op (jax.disable_jit) wherever the two are compared
bit for bit: jitted on XLA:CPU, the JAX planner also contracts
multiply-adds into FMAs and divides by constants with a reciprocal, which
rounds differently from the op-by-op semantics the port (and its CUDA
kernel) keep."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cudasbmp_torch as ct
from cudasbmp_torch import convert, rng
from cudasbmp_torch.ops import rollout_cuda as rc
from cudasbmp_torch.ops.rollout import rollout_batch as t_rollout
from cudasbmp_torch.planners import kgmt as tk
from cudasbmp_tpu.config import KGMTConfig as JConfig
from cudasbmp_tpu.geometry.grid import RegionGrid as JGrid
from cudasbmp_tpu.planners import kgmt as jk
from cudasbmp_tpu.systems.bicycle import KinematicBicycle as JBike

torch.set_num_threads(2)
SMALL = dict(num_iterations=100, max_tree_size=16384, rollouts_per_iter=2048)
JCFG, TCFG = JConfig(**SMALL), ct.KGMTConfig(**SMALL)
JG, TG = JGrid(20.0, 20.0, 16, 8), ct.KGMT(TCFG, device="cpu").grid


@pytest.fixture(scope="module")
def mid_solve():
    """A JAX KGMTState three iterations into a small_config solve (seed 1),
    its numpy image, and the wave-0 context of iteration 3."""
    sc = ct.Scenario.demo()
    obs = jnp.asarray(sc.padded_obstacles(32)[0])
    goal = jnp.asarray(sc.goal)
    s = jk.init_state(JCFG, JG, jnp.asarray(sc.init), jax.random.key(1))
    step = jax.jit(lambda s: jk.kgmt_iteration(JCFG, JBike(), JG, obs, goal, s))
    for _ in range(3):
        s = step(s)
    d = jax.device_get({**s._asdict(), "key": jax.random.key_data(s.key)})
    fl0, ts0 = int(s.frontier_lo), int(s.tree_size)
    n_tgt = min(JCFG.fanout * (ts0 - fl0), JCFG.max_tree_size - ts0)
    assert n_tgt > JCFG.rollouts_per_iter  # a multi-wave iteration
    return s, d, obs, goal, (fl0, ts0, n_tgt)


def _port_state(d):
    return convert.state_from_numpy(tk.KGMTState, d, "cpu")


def test_convert_round_trip(mid_solve):
    s, d, *_ = mid_solve
    back = convert.state_to_numpy(_port_state(d))
    assert set(back) == set(d)
    for k, v in d.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
        assert back[k].dtype == np.asarray(v).dtype, k
    js = jk.KGMTState(**{k: (jax.random.wrap_key_data(back[k]) if k == "key"
                             else jnp.asarray(back[k])) for k in back})
    assert int(js.tree_size) == int(s.tree_size)


def test_convert_pathless_round_trip():
    """A JAX PathlessState (no m_dropped field) carries over and back."""
    sc = ct.Scenario.demo()
    js = jk.init_pathless_state(JCFG, JG, jnp.asarray(sc.init), jax.random.key(4))
    d = jax.device_get({**js._asdict(), "key": jax.random.key_data(js.key)})
    ps = convert.state_from_numpy(tk.PathlessState, d, "cpu")
    assert ps.n_frontier == 1 and ps.m_dropped.shape == ps.m_valid.shape
    want = tk.init_pathless_state(TCFG, TG, torch.tensor(sc.init), rng.key(4))
    back = convert.state_to_numpy(ps)
    for k, v in convert.state_to_numpy(want).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    for k, v in d.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)


def test_region_scores_match_jax(mid_solve):
    """rtol 1e-6: the 256-cell score sum may be reduced in another order by
    XLA than by torch, which moves the normaliser (and so every score) by an
    ulp; the formula itself is the same product/quotient chain."""
    s, d, *_ = mid_solve
    js, jt = jk.update_region_scores(JCFG, s)
    ts, tt = tk.update_region_scores(TCFG, _port_state(d))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-6)


def test_stats_and_accept_bitwise(mid_solve):
    """Same x1, valid and key: d1, d2, accept and r2_seen bitwise equal, on
    every wave of the iteration."""
    s, d, obs, goal, (fl0, ts0, n_tgt) = mid_solve
    r1_score, _ = jk.update_region_scores(JCFG, s)
    R = JCFG.rollouts_per_iter
    for w in range(-(-n_tgt // R)):
        (act, _, _, x1, _, valid, _, k_acc) = jk.expansion_wave(
            JCFG, JBike(), obs, goal, s, wave=w, frontier_lo=jnp.int32(fl0),
            frontier_size=jnp.int32(ts0 - fl0), n_target=jnp.int32(n_tgt))
        want = jk._region_stats_and_accept(JCFG, JG, x1, act, valid, r1_score,
                                           s.r2_avail, k_acc)
        got = tk._region_stats_and_accept(
            TCFG, TG, torch.tensor(np.asarray(x1)), torch.tensor(np.asarray(act)),
            torch.tensor(np.asarray(valid)), torch.tensor(np.asarray(r1_score)),
            torch.tensor(np.asarray(s.r2_avail)),
            torch.tensor(np.asarray(jax.random.key_data(k_acc)).astype(np.int64)))
        for name, a, b in zip(("d1", "d2", "accept", "r2_seen"), want, got):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=f"wave {w}: {name}")


def test_one_wave_step_matches_jax(mid_solve):
    """One full _wave_step from identical state. Rollouts differ only by
    trig ulps, so integer fields and goal fields are bitwise equal and the
    committed samples agree to 1e-3."""
    s, d, obs, goal, (fl0, ts0, n_tgt) = mid_solve
    r1_score, _ = jk.update_region_scores(JCFG, s)
    with jax.disable_jit():
        _, js, jseen = jk._wave_step(JCFG, JBike(), JG, obs, goal,
                                     jnp.int32(fl0), jnp.int32(ts0),
                                     jnp.int32(n_tgt), r1_score, 0, None,
                                     (jnp.int32(0), s, s.r2_avail))
    ps = _port_state(d)
    w, ps, tseen, solved = tk._wave_step(
        TCFG, ct.KGMT(TCFG, device="cpu").system, TG, torch.tensor(np.asarray(obs)),
        torch.tensor(np.asarray(goal)), fl0, ts0, n_tgt,
        torch.tensor(np.asarray(r1_score)), (0, ps, ps.r2_avail.clone()))
    assert w == 1 and solved == bool(np.isfinite(js.cost_to_goal))
    got = convert.state_to_numpy(ps)
    want = jax.device_get(js._asdict())
    assert got["tree_size"] == int(want["tree_size"]) > ts0
    for k in ("tree_parent", "r1_total", "r1_valid", "r1_invalid", "r1_avail",
              "r2_total", "r2_valid", "r2_invalid", "r2_avail", "u_parent",
              "m_valid", "m_accepted", "goal_node"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    np.testing.assert_array_equal(tseen.numpy(), np.asarray(jseen))
    np.testing.assert_array_equal(got["cost_to_goal"], np.asarray(want["cost_to_goal"]))
    for k in ("tree_samples", "u_samples", "costs"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-3,
                                   rtol=0, err_msg=k)


@pytest.fixture(scope="module")
def port_solved():
    planner = ct.KGMT(TCFG, device="cpu")
    return planner, planner.plan(ct.Scenario.demo(), seed=0)


def test_path_replays_at_finer_discretization(port_solved):
    """Each edge's stored control re-integrated from its parent through the
    plain rollout reproduces the child, and stays valid at 4x num_disc."""
    planner, r = port_solved
    assert r.solved and len(r.path) >= 2
    sc, cfg, sys_ = ct.Scenario.demo(), planner.config, planner.system
    obs = torch.tensor(sc.obstacles)
    np.testing.assert_allclose(r.path[0], sc.init, atol=1e-6)
    assert np.hypot(*(r.path[-1, :2] - sc.goal[:2])) < cfg.goal_threshold
    assert r.path_nodes[0] == 0 and (np.diff(r.path_nodes) > 0).all()
    x0 = torch.tensor(r.path[:-1, :4])
    ctrl = torch.tensor(r.path[1:, 4:])
    x1, valid = t_rollout(sys_, x0, ctrl, cfg.num_disc, obs, cfg.width, cfg.height)
    assert valid.all()
    np.testing.assert_allclose(x1.numpy(), r.path[1:, :4], rtol=1e-5, atol=1e-5)
    _, fine = t_rollout(sys_, x0, ctrl, 4 * cfg.num_disc, obs, cfg.width, cfg.height)
    assert fine.all()
    costs = r.state.costs[torch.tensor(r.path_nodes).long()].numpy()
    np.testing.assert_allclose(np.diff(costs), r.path[1:, 6], rtol=1e-5, atol=1e-6)
    assert costs[-1] == np.float32(r.cost)


def test_pathless_matches_tree_mode():
    """Non-adaptive single waves accept at most R children per iteration, so
    the R-row frontier never overflows and the two modes agree exactly."""
    cfg = ct.KGMTConfig(num_iterations=80, max_tree_size=8192,
                        rollouts_per_iter=512, adaptive_waves=False)
    tree = ct.KGMT(cfg, device="cpu").plan(ct.Scenario.demo(), seed=9)
    pathless = ct.KGMT(cfg.replace(need_path=False), device="cpu").plan(ct.Scenario.demo(), seed=9)
    assert tree.solved and pathless.solved
    assert (pathless.cost, pathless.iterations, pathless.tree_size) == (
        tree.cost, tree.iterations, tree.tree_size)
    assert len(pathless.path) == 0 and pathless.metrics["dropped"].sum() == 0
    np.testing.assert_array_equal(pathless.metrics["accepted"],
                                  tree.metrics["accepted"])
    assert torch.equal(pathless.state.r1_score, tree.state.r1_score)


def test_pathless_counts_what_it_drops():
    """Adaptive waves can accept more than R children in one iteration; the
    pathless loop keeps the first R (as the JAX one does) and counts the
    rest in metrics['dropped']. Without drops it equals the tree mode."""
    for seed in range(4):
        tree = ct.KGMT(TCFG, device="cpu").plan(ct.Scenario.demo(), seed=seed)
        p = ct.KGMT(TCFG.replace(need_path=False), device="cpu").plan(ct.Scenario.demo(), seed=seed)
        acc = p.metrics["accepted"]
        frontier_next = np.minimum(acc, TCFG.rollouts_per_iter)
        np.testing.assert_array_equal(p.metrics["dropped"], acc - frontier_next)
        if p.metrics["dropped"].sum() == 0:
            assert (p.cost, p.iterations, p.tree_size) == (
                tree.cost, tree.iterations, tree.tree_size)


def test_default_backend_takes_the_kernel_wrapper(monkeypatch):
    """'auto' goes through rollout_cuda (the plain version runs inside it
    only because the tensors are on the CPU), 'cuda_rng' through
    sample_and_rollout_cuda, and only 'torch' calls rollout_batch directly."""
    calls = {"wrapper": 0, "rng_wrapper": 0, "plain": 0}

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tk, "rollout_cuda", count("wrapper", rc.rollout_cuda))
    monkeypatch.setattr(tk, "sample_and_rollout_cuda",
                        count("rng_wrapper", rc.sample_and_rollout_cuda))
    monkeypatch.setattr(tk, "rollout_batch", count("plain", t_rollout))
    cfg = ct.KGMTConfig(num_iterations=3, max_tree_size=2048, rollouts_per_iter=256)
    assert cfg.rollout_backend == "auto"
    for backend, key in (("auto", "wrapper"), ("cuda", "wrapper"),
                         ("cuda_rng", "rng_wrapper"), ("torch", "plain")):
        for k in calls:
            calls[k] = 0
        r = ct.KGMT(cfg.replace(rollout_backend=backend), device="cpu").plan(ct.Scenario.demo())
        m = r.metrics
        ts_start = np.concatenate([[1], m["tree_size"][:-1]])
        n_tgt = np.minimum(cfg.fanout * m["frontier_size"],
                           cfg.max_tree_size - ts_start)
        waves = int(np.sum(-(-n_tgt // cfg.rollouts_per_iter)))
        assert calls[key] == waves > 0, (backend, calls)
        assert sum(calls.values()) == calls[key], (backend, calls)


def test_off_grid_root_seeds_no_phantom_stats():
    cfg = ct.KGMTConfig(width=10.0, height=30.0, max_tree_size=64,
                        rollouts_per_iter=32)
    grid = ct.KGMT(cfg, device="cpu").grid
    init = torch.tensor([5.0, 25.0, 0, 0, 0, 0, 0])
    s0 = tk.init_state(cfg, grid, init, rng.key(0))
    assert int(s0.r1_total.sum()) == int(s0.r1_avail.sum()) == 0
    assert int(s0.r2_avail.sum()) == 0
    assert int(s0.r1_total[-1]) == 0 and int(s0.r2_avail[-1]) == 0


def test_capacity_clamp_and_zero_budget():
    cfg = ct.KGMTConfig(num_iterations=30, max_tree_size=300, rollouts_per_iter=256)
    r = ct.KGMT(cfg, device="cpu").plan(ct.Scenario.demo())
    assert r.tree_size <= 300
    parents = r.state.tree_parent.numpy()
    assert (parents[1:r.tree_size] >= 0).all()
    assert (parents[1:r.tree_size] < np.arange(1, r.tree_size)).all()
    z = ct.KGMT(dataclasses.replace(cfg, num_iterations=0), device="cpu").plan(ct.Scenario.demo())
    assert not z.solved and z.tree_size == 1 and z.iterations == 0
    assert len(z.path) == 0
