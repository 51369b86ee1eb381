"""Path shortcutting (cudasbmp_torch/shortcut.py) on the CPU against the
JAX package's shortcut_path and shortcut_batch run op by op
(jax.disable_jit), on paths of the port's small_config demo solves, with
few rounds and candidates: edge counts equal, paths and costs within 1e-4
(the replaced time is a float sum whose order may differ)."""

import jax
import numpy as np
import pytest
import torch

import cudasbmp_torch as ct
import cudasbmp_tpu as jt
from cudasbmp_torch import shortcut as ts
from cudasbmp_torch.ops.rollout import rollout_batch
from cudasbmp_tpu import shortcut as js
from cudasbmp_tpu.systems.registry import get_system as jget_system

torch.set_num_threads(2)
SMALL = dict(num_iterations=100, max_tree_size=16384, rollouts_per_iter=2048)
CFG, JCFG = ct.KGMTConfig(**SMALL), jt.KGMTConfig(**SMALL)
DEMO = ct.Scenario.demo()


@pytest.fixture(scope="module")
def planner():
    return ct.KGMT(CFG, device="cpu")


def replays(path: np.ndarray, obstacles: np.ndarray) -> tuple[bool, float]:
    """(every edge valid, largest state error) of an exact control replay."""
    p = torch.tensor(path)
    x1, valid = rollout_batch(ct.KGMT(CFG, device="cpu").system, p[:-1, :4],
                              p[1:, 4:], CFG.num_disc, torch.tensor(obstacles),
                              CFG.width, CFG.height)
    return bool(valid.all()), float((x1 - p[1:, :4]).abs().max())


def test_shortcut_path_against_op_by_op_jax(planner):
    path = planner.plan(DEMO, seed=1).path
    got = ts.shortcut_path(planner.system, CFG, path, DEMO.goal, DEMO.obstacles,
                           ts.ShortcutConfig(rounds=3, candidates=256), seed=3,
                           device="cpu")
    with jax.disable_jit():
        want = js.shortcut_path(jget_system("bicycle"), JCFG, path, DEMO.goal,
                                DEMO.obstacles, js.ShortcutConfig(rounds=3, candidates=256),
                                seed=3)
    assert got["n_edges"] == want["n_edges"] == len(path) - 2  # one edge saved
    np.testing.assert_allclose(got["path"], want["path"], atol=1e-4, rtol=0)
    assert got["cost_before"] == pytest.approx(want["cost_before"], abs=1e-4)
    assert got["cost_after"] == pytest.approx(want["cost_after"], abs=1e-4)
    assert got["cost_after"] < got["cost_before"] - 0.5
    ok, err = replays(got["path"], DEMO.obstacles)
    assert ok and err < 1e-4
    end = got["path"][-1]
    assert np.hypot(end[0] - DEMO.goal[0], end[1] - DEMO.goal[1]) < CFG.goal_threshold
    with pytest.raises(ValueError, match="at least one edge"):
        ts.shortcut_path(planner.system, CFG, path[:1], DEMO.goal, DEMO.obstacles,
                         device="cpu")


def test_shortcut_batch_takes_a_shared_box_set(planner):
    """[K, 4] obstacles broadcast to every path: the same result as the
    stacked [B, K, 4]."""
    p = planner.plan(DEMO, seed=3).path
    paths = np.stack([p, p])
    lengths = np.array([len(p)] * 2)
    goals = np.tile(DEMO.goal, (2, 1)).astype(np.float32)
    boxes = DEMO.padded_obstacles(8)[0]
    scfg = ts.ShortcutConfig(rounds=4, candidates=64)
    shared = ts.shortcut_batch(planner.system, CFG, paths, lengths, goals, boxes, scfg,
                               seed=7, device="cpu")
    stacked = ts.shortcut_batch(planner.system, CFG, paths, lengths, goals,
                                np.stack([boxes, boxes]), scfg, seed=7, device="cpu")
    for k in shared:
        np.testing.assert_array_equal(shared[k], stacked[k])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            ts.shortcut_batch(planner.system, CFG, paths, lengths, goals, boxes, scfg)
