"""shortcut_batch (cudasbmp_torch/shortcut.py) on the CPU against the JAX
package's, run op by op (jax.disable_jit), on two paths of the port's
small_config demo solves and an unsolved row, one box set per path (kernel
B6's layout), two rounds: edge counts equal, paths and costs within 1e-4.
(A file of its own: the op-by-op vmapped JAX rounds take half a minute.)"""

import jax
import numpy as np
import pytest
import torch

import cudasbmp_torch as ct
from cudasbmp_torch import shortcut as ts
from cudasbmp_tpu import shortcut as js
from cudasbmp_tpu.systems.registry import get_system as jget_system
from test_torch_shortcut import CFG, DEMO, JCFG, replays

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def planner():
    return ct.KGMT(CFG, device="cpu")


def test_shortcut_batch_against_op_by_op_jax(planner):
    """Two solved paths and an unsolved row (length 0, untouched), one box
    set per path (B6's layout), padded to 14 nodes."""
    B, L = 3, 14
    paths = np.zeros((B, L, 7), np.float32)
    lengths = np.zeros(B, np.int32)
    for b, seed in enumerate((1, 3)):
        p = planner.plan(DEMO, seed=seed).path
        paths[b, :len(p)], lengths[b] = p, len(p)
    goals = np.tile(DEMO.goal, (B, 1)).astype(np.float32)
    obstacles = np.stack([DEMO.padded_obstacles(8)[0]] * B)
    scfg = dict(rounds=2, candidates=256)
    got = ts.shortcut_batch(planner.system, CFG, paths, lengths, goals, obstacles,
                            ts.ShortcutConfig(**scfg), seed=12, device="cpu")
    with jax.disable_jit():
        want = js.shortcut_batch(jget_system("bicycle"), JCFG, paths, lengths, goals,
                                 obstacles, js.ShortcutConfig(**scfg), seed=12)
    np.testing.assert_array_equal(got["path_lengths"], want["path_lengths"])
    np.testing.assert_allclose(got["paths"], want["paths"], atol=1e-4, rtol=0)
    for k in ("cost_before", "cost_after"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=0)
    assert (got["path_lengths"][:2] < lengths[:2]).all()
    assert got["path_lengths"][2] == 0 and not got["paths"][2].any()
    for b in range(2):
        n = got["path_lengths"][b]
        ok, err = replays(got["paths"][b, :n], obstacles[b])
        assert ok and err < 1e-4
        assert not got["paths"][b, n:].any()
        assert got["cost_after"][b] == pytest.approx(got["paths"][b, 1:n, 6].sum(), rel=1e-6)
