"""The CUDA kernels on the card, against their plain PyTorch versions, and
the planner's main path through them. Every test here is marked ``cuda``
and skips without a GPU. This file imports no JAX, so it also runs on a
machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import cudasbmp_torch as ctt
from cudasbmp_torch import rng
from cudasbmp_torch.config import Scenario
from cudasbmp_torch.ops import rollout_cuda as rc
from cudasbmp_torch.ops.rollout import rollout_batch
from cudasbmp_torch.systems.bicycle import KinematicBicycle

pytestmark = pytest.mark.cuda
KW = dict(num_disc=10, width=20.0, height=20.0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def demo_batch(B: int, seed: int, dev):
    """Parents spread over the free demo workspace, controls uniform in the
    bicycle's control box (numpy generator)."""
    r = np.random.default_rng(seed)
    xy = r.uniform(0.05, 19.95, size=(4 * B, 2))
    free = np.ones(len(xy), bool)
    for x0, y0, x1, y1 in Scenario.demo().obstacles:
        free &= ~((xy[:, 0] > x0) & (xy[:, 0] < x1) & (xy[:, 1] > y0) & (xy[:, 1] < y1))
    xy = xy[free][:B]
    x0 = np.concatenate([xy, r.uniform(-np.pi, np.pi, (B, 1)),
                         r.uniform(-3, 3, (B, 1))], -1).astype(np.float32)
    ctrl = np.stack([r.uniform(-5, 5, B), r.uniform(-np.pi, np.pi, B),
                     r.uniform(0.05, 1.05, B)], -1).astype(np.float32)
    return torch.tensor(x0, device=dev), torch.tensor(ctrl, device=dev)


def _obstacles(dev):
    return torch.tensor(Scenario.demo().padded_obstacles(32)[0], device=dev)


@pytest.mark.parametrize("B", [1, 4096, 2 ** 17])
def test_rollout_kernel_matches_plain_version(dev, B):
    """Both round every operation once and share CUDA's cosf/sinf/tanf, so
    they agree to the bit."""
    x0, ctrl = demo_batch(B, 5, dev)
    obs = _obstacles(dev)
    x1, valid = rc.rollout_cuda(KinematicBicycle(), x0, ctrl, obs, **KW)
    px1, pvalid = rollout_batch(KinematicBicycle(), x0, ctrl, KW["num_disc"], obs,
                                KW["width"], KW["height"])
    assert torch.equal(valid, pvalid)
    assert torch.equal(x1.view(torch.int32), px1.view(torch.int32))


@pytest.mark.parametrize("B", [4096, 2 ** 17])
def test_sample_and_rollout_kernel_matches_twin(dev, B):
    x0, _ = demo_batch(B, 6, dev)
    obs, key = _obstacles(dev), rng.key(9, dev)
    x1, c, valid = rc.sample_and_rollout_cuda(KinematicBicycle(), key, x0, obs, **KW)
    tx1, tc, tvalid = rc.sample_and_rollout_torch(KinematicBicycle(), key, x0, obs, **KW)
    assert torch.equal(c.view(torch.int32), tc.view(torch.int32))
    assert torch.equal(valid, tvalid)
    assert torch.equal(x1.view(torch.int32), tx1.view(torch.int32))
    # the CPU twin draws the same controls
    cpu = rc.sample_and_rollout_cuda(KinematicBicycle(), key.cpu(), x0.cpu(),
                                     obs.cpu(), **KW)[1]
    assert torch.equal(cpu.view(torch.int32), c.cpu().view(torch.int32))


def test_wrappers_reject_bad_inputs(dev):
    x0, ctrl = demo_batch(64, 7, dev)
    obs = _obstacles(dev)
    with pytest.raises(ValueError, match="several devices"):
        rc.rollout_cuda(KinematicBicycle(), x0, ctrl.cpu(), obs, **KW)
    with pytest.raises(ValueError, match="contiguous"):
        rc.rollout_cuda(KinematicBicycle(), x0.t().contiguous().t(), ctrl, obs, **KW)
    with pytest.raises(ValueError, match="float32"):
        rc.rollout_cuda(KinematicBicycle(), x0.double(), ctrl, obs, **KW)
    with pytest.raises(ValueError, match="obstacles"):
        rc.rollout_cuda(KinematicBicycle(), x0, ctrl, obs.repeat(5, 1), **KW)


@pytest.mark.parametrize("backend,kernel", [("auto", "rollout_cuda"),
                                            ("cuda_rng", "sample_and_rollout_cuda")])
def test_planner_runs_every_wave_through_the_kernel(dev, backend, kernel):
    cfg = ctt.KGMTConfig(num_iterations=100, max_tree_size=16384,
                         rollouts_per_iter=2048, rollout_backend=backend)
    rc.reset_launch_counts()
    r = ctt.KGMT(cfg, device=dev).plan(ctt.Scenario.demo(), seed=0)
    assert r.solved and len(r.path) >= 2
    m = r.metrics
    ts_start = np.concatenate([[1], m["tree_size"][:-1]])
    n_tgt = np.minimum(cfg.fanout * m["frontier_size"], cfg.max_tree_size - ts_start)
    waves = int((-(-n_tgt // cfg.rollouts_per_iter)).sum())
    launches = {"rollout_cuda": rc.rollout_cuda.launches,
                "sample_and_rollout_cuda": rc.sample_and_rollout_cuda.launches}
    assert launches.pop(kernel) == waves
    assert set(launches.values()) == {0}


def test_kernel_and_plain_backends_solve_identically(dev):
    """B1 equals its plain version bit for bit, so whole solves agree."""
    cfg = ctt.KGMTConfig(num_iterations=100, max_tree_size=16384,
                         rollouts_per_iter=2048)
    a = ctt.KGMT(cfg, device=dev).plan(ctt.Scenario.demo(), seed=1)
    b = ctt.KGMT(cfg.replace(rollout_backend="torch"), device=dev).plan(
        ctt.Scenario.demo(), seed=1)
    assert (a.solved, a.iterations, a.tree_size, a.cost) == (
        b.solved, b.iterations, b.tree_size, b.cost)
    np.testing.assert_array_equal(a.path, b.path)
