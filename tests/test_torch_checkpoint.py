"""Checkpoint and resume (cudasbmp_torch/io/checkpoint.py, KGMT.resume)
against the JAX package's io/checkpoint.py, on the CPU, for both state kinds
(the tree state and the pathless one):

- port -> npz -> port gives the same state, field for field and bit for
  bit; the write leaves no ``.tmp.npz`` behind;
- a JAX checkpoint (written by the JAX package from its jitted planner at
  iteration 15 of the demo, one wave an iteration) resumed in the port ends
  where the JAX resume of the same file, op by op, ends: solved,
  iterations, tree size, cost within rtol 1e-5 and the path's nodes (its
  samples within 1e-3: glibc and SLEEF trig differ by an ulp);
- a port checkpoint loads in the JAX package's ``load_checkpoint`` with
  equal fields;
- a state of the wrong kind for the planner's ``need_path`` raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cudasbmp_torch as ct
import cudasbmp_tpu as jt
from cudasbmp_torch.convert import state_to_numpy
from cudasbmp_torch.io.checkpoint import load_checkpoint, save_checkpoint
from cudasbmp_tpu.io import checkpoint as jckpt
from cudasbmp_tpu.planners import kgmt as jk

torch.set_num_threads(2)
K_SAVED = 15  # the JAX checkpoint's iteration
# the demo at one wave an iteration: seed 0 solves in 17 iterations (jitted
# JAX); the budget stops a resume three iterations after the checkpoint
FIXED = dict(num_iterations=K_SAVED + 3, max_tree_size=16384, rollouts_per_iter=2048,
             adaptive_waves=False)
MODES = {"tree": True, "pathless": False}


def _port_state(need_path: bool, num_iterations: int = 3):
    cfg = ct.KGMTConfig(num_iterations=num_iterations, max_tree_size=8192,
                        rollouts_per_iter=1024, need_path=need_path)
    return ct.KGMT(cfg, device="cpu").plan(ct.Scenario.demo(), seed=2).state


def _assert_fields_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("mode", list(MODES))
def test_port_round_trip_is_exact_and_atomic(tmp_path, mode):
    state = _port_state(MODES[mode])
    save_checkpoint(state, tmp_path / "ckpt")  # .npz appended
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt.npz"]
    back = load_checkpoint(tmp_path / "ckpt.npz", device="cpu")
    assert type(back) is type(state)
    _assert_fields_equal(state_to_numpy(back), state_to_numpy(state))


def _jax_checkpoint(path, need_path: bool):
    """The JAX package's state at iteration K_SAVED of the demo (seed 0),
    from its jitted drivers, written by its save_checkpoint."""
    cfg = jt.KGMTConfig(**FIXED, need_path=need_path)
    planner = jt.KGMT(cfg)
    sc = jt.Scenario.demo()
    obs = jnp.asarray(sc.padded_obstacles(cfg.max_obstacles)[0])
    init, goal, key = jnp.asarray(sc.init), jnp.asarray(sc.goal), jax.random.key(0)
    upto = dataclasses.replace(cfg, num_iterations=K_SAVED)  # same state arrays
    if need_path:
        s0 = jk.init_state(cfg, planner.grid, init, key)
        run = jax.jit(lambda s: jk.kgmt_run(upto, planner.system, planner.grid, goal,
                                            obs, s))
    else:
        s0 = jk.init_pathless_state(cfg, planner.grid, init, key)
        run = jax.jit(lambda s: jk.kgmt_run_pathless(upto, planner.system, planner.grid,
                                                     goal, obs, s))
    state = run(s0)
    assert int(state.itr) == K_SAVED and not np.isfinite(float(state.cost_to_goal))
    jckpt.save_checkpoint(state, path)
    return cfg


@pytest.mark.parametrize("mode", list(MODES))
def test_jax_checkpoint_resumes_in_the_port_as_in_jax(tmp_path, mode):
    need_path = MODES[mode]
    path = tmp_path / "jax.npz"
    jcfg = _jax_checkpoint(path, need_path)
    with jax.disable_jit():
        want = jt.KGMT(jcfg).resume(jckpt.load_checkpoint(path), jt.Scenario.demo())
    cfg = ct.KGMTConfig(**FIXED, need_path=need_path)
    state = load_checkpoint(path, device="cpu")
    assert type(state).__name__ == type(want.state).__name__
    got = ct.KGMT(cfg, device="cpu").resume(state, ct.Scenario.demo())
    assert (got.solved, got.iterations, got.tree_size) == (
        want.solved, want.iterations, want.tree_size)
    assert got.solved and got.iterations > K_SAVED
    assert got.cost == pytest.approx(want.cost, rel=1e-5)
    np.testing.assert_array_equal(got.path_nodes, np.asarray(want.path_nodes))
    np.testing.assert_allclose(got.path, np.asarray(want.path), atol=1e-3, rtol=0)
    for k in ("valid", "accepted", "tree_size", "frontier_size"):
        np.testing.assert_array_equal(got.metrics[k], np.asarray(want.metrics[k]),
                                      err_msg=k)


@pytest.mark.parametrize("mode", list(MODES))
def test_port_checkpoint_loads_in_jax(tmp_path, mode):
    state = _port_state(MODES[mode])
    save_checkpoint(state, tmp_path / "port.npz")
    loaded = jckpt.load_checkpoint(tmp_path / "port.npz")
    assert type(loaded).__name__ == type(state).__name__
    want = state_to_numpy(state)
    for name in loaded._fields:
        v = getattr(loaded, name)
        if name == "key":
            v = jax.random.key_data(v)
        np.testing.assert_array_equal(np.asarray(v), want[name], err_msg=name)
    assert set(want) - set(loaded._fields) <= {"m_dropped"}


def test_a_state_of_the_wrong_kind_raises(tmp_path):
    tree = _port_state(True, num_iterations=1)
    pathless = _port_state(False, num_iterations=1)
    sc = ct.Scenario.demo()
    small = dict(max_tree_size=8192, rollouts_per_iter=1024)
    with pytest.raises(ValueError, match="need_path=False"):
        ct.KGMT(ct.KGMTConfig(**small, need_path=False), device="cpu").resume(tree, sc)
    with pytest.raises(ValueError, match="need_path=True"):
        ct.KGMT(ct.KGMTConfig(**small), device="cpu").resume(pathless, sc)
    # a file without the marker is a tree state
    np.savez(tmp_path / "old.npz", **state_to_numpy(tree))
    assert type(load_checkpoint(tmp_path / "old.npz", device="cpu")).__name__ == "KGMTState"
