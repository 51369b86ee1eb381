"""Batched states across the two packages (cudasbmp_torch/convert.py): a
JAX ArenaState after three op-by-op iterations, converted to the port, and
one more iteration in both packages reach the same state; the same for the
streaming sweep's StreamState. The port's state goes back to numpy with
the JAX field names and dtypes.

Integer and boolean fields are equal; float fields within 1e-5 (the
rollouts' trig differs by an ulp between glibc and SLEEF)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cudasbmp_torch import convert
from cudasbmp_torch.config import KGMTConfig, Scenario
from cudasbmp_torch.geometry.grid import RegionGrid
from cudasbmp_torch.parallel import batch_kgmt as tbk
from cudasbmp_torch.parallel import streaming_mc as tsm
from cudasbmp_torch.systems import get_system
from cudasbmp_tpu import KGMTConfig as JConfig
from cudasbmp_tpu.geometry.grid import RegionGrid as JGrid
from cudasbmp_tpu.parallel import batch_kgmt as jbk
from cudasbmp_tpu.parallel import streaming_mc as jsm
from cudasbmp_tpu.systems import get_system as j_get_system

torch.set_num_threads(2)
R = 128
CFG = dict(rollouts_per_iter=R, max_tree_size=R * 9, num_iterations=8,
           goal_bias=0.25, goal_bias_k=8)
JGRID, TGRID = JGrid(20.0, 20.0, 16, 8), RegionGrid(20.0, 20.0, 16, 8)


def jax_numpy(state) -> dict:
    state = state._replace(key=jax.random.key_data(state.key))
    return {k: np.asarray(v) for k, v in jax.device_get(state)._asdict().items()}


def assert_same_state(got: dict, want: dict):
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        if np.issubdtype(w.dtype, np.floating):
            assert g.dtype == w.dtype, name
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64),
                                          err_msg=name)


def test_arena_state_round_trip_and_next_iteration():
    base = Scenario.demo()
    B = 3
    inits = np.tile(base.init, (B, 1)).astype(np.float32)
    goals = np.tile(base.goal, (B, 1)).astype(np.float32)
    goals[:, 0] = (9.0, 10.0, 11.0)
    goals[:, 1] = 3.0
    obstacles = np.stack([base.padded_obstacles(8)[0]] * B)
    obstacles[1, 5] = (12.0, 9.0, 13.0, 14.0)
    jcfg = JConfig(rollout_backend="jnp", **CFG)
    jsys, M = j_get_system("bicycle"), R * 9
    with jax.disable_jit():
        s = jbk.arena_init(jcfg, JGRID, jnp.asarray(inits), jax.random.key(5), M, R, 4)
        for _ in range(3):
            s = jbk.arena_iteration(jcfg, jsys, JGRID, jnp.asarray(obstacles),
                                    jnp.asarray(goals), R, s)
        nxt = jbk.arena_iteration(jcfg, jsys, JGRID, jnp.asarray(obstacles),
                                  jnp.asarray(goals), R, s)
    ts = convert.state_from_numpy(None, jax_numpy(s), "cpu")
    assert isinstance(ts, tbk.ArenaState) and ts.it == 3
    assert_same_state(convert.state_to_numpy(ts), jax_numpy(s))
    tbk.arena_iteration(KGMTConfig(rollout_backend="torch", **CFG),
                        get_system("bicycle"), TGRID, torch.tensor(obstacles),
                        torch.tensor(goals), R, ts)
    assert_same_state(convert.state_to_numpy(ts), jax_numpy(nxt))
    assert int(np.asarray(nxt.tree_valid).sum()) > B  # the waves accepted children


def test_stream_state_round_trip_and_next_iteration():
    jcfg = JConfig(rollout_backend="jnp", **dict(CFG, goal_bias=0.0, num_iterations=3))
    tcfg = KGMTConfig(rollout_backend="auto", **dict(CFG, goal_bias=0.0, num_iterations=3))
    B, n_scn, n_obs, pad_to = 3, 5, 5, 8
    jsys = j_get_system("bicycle")
    with jax.disable_jit():
        s = jsm.stream_init(jcfg, JGRID, jax.random.key(9), B, R, n_scn, n_obs, pad_to, 4)
        for _ in range(3):  # the budget of 3 completes every slot once: refills
            s = jsm.stream_iteration(jcfg, jsys, JGRID, R, n_scn, n_obs, pad_to, s)
        nxt = jsm.stream_iteration(jcfg, jsys, JGRID, R, n_scn, n_obs, pad_to, s)
    ts = convert.state_from_numpy(None, jax_numpy(s), "cpu")
    assert isinstance(ts, tsm.StreamState) and ts.it == 3
    assert int(ts.n_done) == 3 and (ts.scn_id.numpy() >= 3).sum() == 2
    tsm.stream_iteration(tcfg, get_system("bicycle"), TGRID, R, n_scn, n_obs,
                         pad_to, ts)
    assert_same_state(convert.state_to_numpy(ts), jax_numpy(nxt))
