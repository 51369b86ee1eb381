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
from cudasbmp_torch.systems import get_system
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
        rc.rollout_cuda(KinematicBicycle(), x0, ctrl, obs[:, :3].contiguous(), **KW)
    # 40 boxes run (the block's dynamic shared memory holds them); past what
    # one block can hold is refused
    rc.rollout_cuda(KinematicBicycle(), x0, ctrl, obs.repeat(5, 1), **KW)
    too_many = obs[:1].repeat(rc.max_kernel_obstacles(x0.device.index or 0) + 1, 1)
    with pytest.raises(ValueError, match="obstacles"):
        rc.rollout_cuda(KinematicBicycle(), x0, ctrl, too_many, **KW)


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


SYSTEMS = ["bicycle", "point2d", "double_integrator", "unicycle", "dubins"]
FP = (0.5, 0.25)


def system_batch(name: str, B: int, seed: int, dev):
    """Parents over the demo workspace (headings and speeds where the system
    has them), controls uniform in the system's control box."""
    r = np.random.default_rng(seed)
    system = get_system(name)
    spec = system.control_spec
    x0 = np.zeros((B, 4), np.float32)
    x0[:, 0] = r.uniform(0.5, 19.5, B)
    x0[:, 1] = r.uniform(0.5, 19.5, B)
    if name != "point2d":
        x0[:, 2] = r.uniform(-np.pi, np.pi, B)
    if name in ("bicycle", "double_integrator"):
        x0[:, 3] = r.uniform(-3, 3, B)
    u = r.uniform(0, 1, (B, spec.dim))
    c = np.asarray(spec.lo) + u * (np.asarray(spec.hi) - np.asarray(spec.lo))
    return (system, torch.tensor(x0, device=dev),
            torch.tensor(c.astype(np.float32), device=dev))


def _bitwise(a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("fast_math", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("footprint", [None, FP], ids=["broad", "footprint"])
@pytest.mark.parametrize("name", SYSTEMS)
def test_every_instantiation_matches_its_plain_twin(dev, name, footprint, fast_math):
    """B1 and B2 (with B3/B4 as set) against rollout_soa / the Philox twin
    on the same card: bitwise states, equal masks, equal B2 controls."""
    system, x0, c = system_batch(name, 4096, SYSTEMS.index(name), dev)
    obs = _obstacles(dev)
    opts = dict(KW, footprint=footprint, fast_math=fast_math)
    x1, valid = rc.rollout_cuda(system, x0, c, obs, **opts)
    px1, pvalid = rc.rollout_soa(system, x0, c, obs, **opts)
    assert torch.equal(valid, pvalid) and _bitwise(x1, px1)
    assert 0.05 < valid.float().mean() < 0.99
    key = rng.key(21, dev)
    x1, c2, valid = rc.sample_and_rollout_cuda(system, key, x0, obs, **opts)
    tx1, tc2, tvalid = rc.sample_and_rollout_torch(system, key, x0, obs, **opts)
    assert _bitwise(c2, tc2) and torch.equal(valid, tvalid) and _bitwise(x1, tx1)


@pytest.mark.parametrize("name", ["point2d", "double_integrator"])
def test_fast_math_without_hooks_is_the_exact_kernel(dev, name):
    system, x0, c = system_batch(name, 4096, 40, dev)
    obs = _obstacles(dev)
    for fp in (None, FP):
        a = rc.rollout_cuda(system, x0, c, obs, **KW, footprint=fp)
        b = rc.rollout_cuda(system, x0, c, obs, **KW, footprint=fp, fast_math=True)
        assert _bitwise(a[0], b[0]) and torch.equal(a[1], b[1])


def test_forty_boxes_run_on_the_kernel(dev):
    """More boxes than the 32 a static shared array once held: 40 boxes,
    max_obstacles=64. Both kernels equal their plain versions, and a
    demo-width solve runs every wave through B1."""
    sc = ctt.Scenario.dense(40, seed=0)
    obs = torch.tensor(sc.padded_obstacles(64)[0], device=dev)
    assert obs.shape == (40, 4)
    system, x0, c = system_batch("bicycle", 4096, 41, dev)
    for fp in (None, FP):
        x1, valid = rc.rollout_cuda(system, x0, c, obs, **KW, footprint=fp)
        px1, pvalid = rc.rollout_soa(system, x0, c, obs, **KW, footprint=fp)
        assert torch.equal(valid, pvalid) and _bitwise(x1, px1)
        key = rng.key(2, dev)
        x1, c2, valid = rc.sample_and_rollout_cuda(system, key, x0, obs, **KW, footprint=fp)
        tx1, tc2, tvalid = rc.sample_and_rollout_torch(system, key, x0, obs, **KW,
                                                       footprint=fp)
        assert _bitwise(c2, tc2) and torch.equal(valid, tvalid) and _bitwise(x1, tx1)
    cfg = ctt.KGMTConfig(max_obstacles=64)
    rc.reset_launch_counts()
    r = ctt.KGMT(cfg, device=dev).plan(sc, seed=0)
    assert r.solved and rc.rollout_cuda.launches > 0


def test_obstacle_limit_is_what_one_block_holds(dev):
    limit = rc.max_kernel_obstacles(dev.index or 0)
    assert limit >= 48 * 1024 // 16
    system, x0, c = system_batch("bicycle", 256, 42, dev)
    big = torch.zeros((limit + 1, 4), device=dev)
    big[:, :2] = 1.0  # padding boxes
    with pytest.raises(ValueError, match=str(limit)):
        rc.rollout_cuda(system, x0, c, big, **KW)
    # the most it holds still launches (> 48 KB of dynamic shared memory)
    x1, valid = rc.rollout_cuda(system, x0, c, big[:limit], **KW)
    px1, pvalid = rc.rollout_soa(system, x0, c, big[:limit], **KW)
    assert torch.equal(valid, pvalid) and _bitwise(x1, px1)


def test_all_options_solve_kernel_equals_twin_and_torch(dev, monkeypatch):
    """The all-options bicycle solve: the kernel (auto) equals its plain twin
    driven on the same card; with exact math it equals the 'torch' backend
    (which, as the JAX package's jnp backend, ignores fast_math)."""
    from cudasbmp_torch.planners import kgmt as tk

    cfg = ctt.KGMTConfig(num_iterations=100, max_tree_size=16384,
                         rollouts_per_iter=2048, footprint_width=0.5,
                         fast_math=True, goal_bias=0.25)

    def solve(c):
        r = ctt.KGMT(c, device=dev).plan(ctt.Scenario.demo(), seed=0)
        return r.solved, r.iterations, r.tree_size, r.cost

    kernel = solve(cfg)
    assert kernel[0]
    exact_kernel = solve(cfg.replace(fast_math=False))
    assert exact_kernel == solve(cfg.replace(fast_math=False, rollout_backend="torch"))
    monkeypatch.setattr(tk, "rollout_cuda", rc.rollout_soa)
    assert solve(cfg) == kernel
