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
from torch_user_systems import BicycleCopy, Drift, DriftNoBack, DriftStruct

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



@pytest.mark.parametrize("lane0", [1, 4096 * 3, 2 ** 20 + 37])
def test_sample_and_rollout_kernel_at_a_lane_offset(dev, lane0):
    """B2 launched over lanes [lane0, lane0 + B) draws the Philox words of
    those lanes (``philox_uniform_lanes(..., lane0)``) and rolls them out as
    the twin does: a rank's share of the arena's batch-wide wave."""
    B = 4096
    x0, _ = demo_batch(B, 8, dev)
    obs, key = _obstacles(dev), rng.key(9, dev)
    x1, c, valid = rc.sample_and_rollout_cuda(KinematicBicycle(), key, x0, obs,
                                              lane0=lane0, **KW)
    lo, hi = KinematicBicycle().control_spec.bounds(dev)
    u = rng.philox_uniform_lanes(key, B, 3, lane0=lane0)
    assert torch.equal(c.view(torch.int32), (lo + u * (hi - lo)).view(torch.int32))
    tx1, tc, tvalid = rc.sample_and_rollout_torch(KinematicBicycle(), key, x0, obs,
                                                  lane0=lane0, **KW)
    assert torch.equal(c.view(torch.int32), tc.view(torch.int32))
    assert torch.equal(valid, tvalid)
    assert torch.equal(x1.view(torch.int32), tx1.view(torch.int32))
    # the rows of a launch over the whole batch from lane 0
    whole = torch.cat([demo_batch(lane0, 9, dev)[0], x0]) if lane0 <= 4096 * 3 else None
    if whole is not None:
        w1, wc, wvalid = rc.sample_and_rollout_cuda(KinematicBicycle(), key, whole, obs,
                                                    **KW)
        assert torch.equal(wc[lane0:], c) and torch.equal(wvalid[lane0:], valid)
        assert torch.equal(w1[lane0:].view(torch.int32), x1.view(torch.int32))


@pytest.mark.parametrize("row0", [1, 37])
def test_arena_share_from_row0_launches_b2(dev, row0):
    """The arena's shared-box wave under cuda_rng on a rank's share of the
    batch (problems from row0 on) is one launch of B2 at lane0 = row0 * R,
    no launch of B1, and equals the twin's rows over the whole batch bit
    for bit."""
    from cudasbmp_torch.parallel import batch_kgmt as bk

    cfg = ctt.KGMTConfig(rollouts_per_iter=128, rollout_backend="cuda_rng", **KW)
    P, R = 64, cfg.rollouts_per_iter
    x0 = demo_batch(P * R, 10, dev)[0].view(P, R, 4)
    obs, key = _obstacles(dev), rng.key(13, dev)
    system = KinematicBicycle()
    rc.reset_launch_counts()
    got = bk._rollout_wave(cfg, system, x0[row0:], obs, key, row0=row0)
    assert rc.sample_and_rollout_cuda.launches == 1
    assert rc.rollout_cuda.launches == 0
    want = rc.sample_and_rollout_torch(system, key, x0.view(P * R, 4), obs, **KW)
    for g, w in zip(got, want):
        assert torch.equal(g.reshape(w[row0 * R:].shape), w[row0 * R:])

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
    # the rule's G for the wave's 2,048 lanes: 4 threads a rollout on an H100
    G = rc.lanes_per_rollout(cfg.rollouts_per_iter, rc.sm_count(dev.index or 0))
    assert getattr(rc, kernel).splits == {G: waves}


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
    on the same card, at the rule's G and every forced G: bitwise states,
    equal masks, equal B2 controls."""
    system, x0, c = system_batch(name, 4096, SYSTEMS.index(name), dev)
    obs = _obstacles(dev)
    opts = dict(KW, footprint=footprint, fast_math=fast_math)
    px1, pvalid = rc.rollout_soa(system, x0, c, obs, **opts)
    assert 0.05 < pvalid.float().mean() < 0.99
    key = rng.key(21, dev)
    tx1, tc2, tvalid = rc.sample_and_rollout_torch(system, key, x0, obs, **opts)
    for G in (None, *rc.SPLITS):
        x1, valid = rc.rollout_cuda(system, x0, c, obs, **opts, split=G)
        assert torch.equal(valid, pvalid) and _bitwise(x1, px1), G
        y1, c2, v2 = rc.sample_and_rollout_cuda(system, key, x0, obs, **opts, split=G)
        assert _bitwise(c2, tc2) and torch.equal(v2, tvalid) and _bitwise(y1, tx1), G


@pytest.mark.parametrize("R", [1, 33, 4097])
@pytest.mark.parametrize("K", [1, 5, 8, 9, 40])
def test_thread_groups_at_ragged_widths_and_many_boxes(dev, R, K):
    """Lanes past R inside a group's warp (R = 33, 4,097), K = 40 (no
    multiple of G; past the register cap) and K = 1, 5, 9 (no multiple of
    the one-thread walk's 4 boxes a pass): both kernels at every G equal
    their twins, for every bicycle option."""
    system, x0, c = system_batch("bicycle", R, 44 + K, dev)
    obs = _obstacles(dev)[:8] if K == 8 else torch.tensor(
        ctt.Scenario.dense(40, seed=0).padded_obstacles(64)[0][:K], device=dev)
    assert obs.shape == (K, 4)
    key = rng.key(R, dev)
    for fp in (None, FP):
        for fast in (False, True):
            opts = dict(KW, footprint=fp, fast_math=fast)
            px1, pvalid = rc.rollout_soa(system, x0, c, obs, **opts)
            tx1, tc2, tvalid = rc.sample_and_rollout_torch(system, key, x0, obs, **opts)
            for G in rc.SPLITS:
                x1, valid = rc.rollout_cuda(system, x0, c, obs, **opts, split=G)
                assert torch.equal(valid, pvalid) and _bitwise(x1, px1), G
                y1, c2, v2 = rc.sample_and_rollout_cuda(system, key, x0, obs, **opts,
                                                        split=G)
                assert _bitwise(c2, tc2) and torch.equal(v2, tvalid), G
                assert _bitwise(y1, tx1), G


def test_split_counts_and_checks_on_the_card(dev):
    """Each launch counts under the G it ran at; the culled body runs at
    G = 1 and refuses any other."""
    system, x0, c = system_batch("bicycle", 512, 45, dev)
    obs = _obstacles(dev)
    rc.reset_launch_counts()
    for G in rc.SPLITS:
        rc.rollout_cuda(system, x0, c, obs, **KW, split=G)
    rc.rollout_cuda(system, x0, c, obs, **KW, cull=2)
    rc.rollout_cuda(system, x0, c, obs, **KW)
    G = rc.lanes_per_rollout(512, rc.sm_count(dev.index or 0))
    assert rc.rollout_cuda.splits == {1: 2 + (G == 1), 2: 1 + (G == 2), 4: 1 + (G == 4),
                                      8: 1 + (G == 8)}
    with pytest.raises(ValueError, match="culled"):
        rc.rollout_cuda(system, x0, c, obs, **KW, cull=2, split=4)
    with pytest.raises(ValueError, match="split"):
        rc.rollout_cuda(system, x0, c, obs, **KW, split=16)
    # sub-lanes read their boxes as float4 from device memory
    odd = torch.zeros(obs.numel() + 1, device=dev)[1:].view(obs.shape)
    with pytest.raises(ValueError, match="16-byte"):
        rc.rollout_cuda(system, x0, c, odd, **KW)


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


def problem_batch(name: str, B: int, R: int, K: int, seed: int, dev, padding: int = 2):
    """(system, x0 [B, R, 4], controls [B, R, 3], obstacles [B, K, 4]): a
    distinct random box field per problem, its last ``padding`` rows
    padding boxes."""
    system, x0, c = system_batch(name, B * R, seed, dev)
    r = np.random.default_rng(seed + 1000)
    lo = r.uniform(0.0, 17.0, (B, K, 2))
    boxes = np.concatenate([lo, lo + r.uniform(0.5, 3.0, (B, K, 2))], -1)
    boxes[:, K - padding:] = (1.0, 1.0, 0.0, 0.0)
    return (system, x0.reshape(B, R, 4), c.reshape(B, R, -1),
            torch.tensor(boxes.astype(np.float32), device=dev))


@pytest.mark.parametrize("shape", [(8, 512), (1024, 128)], ids=["8x512", "1024x128"])
@pytest.mark.parametrize("fast_math", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("footprint", [None, FP], ids=["broad", "footprint"])
@pytest.mark.parametrize("name", SYSTEMS)
def test_batched_kernel_matches_its_plain_twin(dev, name, footprint, fast_math, shape):
    """B6, both forms, with B3/B4 as set, against its plain twins on the same
    card at B=8 problems x R=512 lanes and at the sweeps' launch shape,
    B=1024 x R=128 (one block per problem): bitwise states, equal masks,
    equal Philox controls."""
    nb, nr = shape
    system, x0, c, obs = problem_batch(name, nb, nr, 8, SYSTEMS.index(name), dev)
    opts = dict(KW, footprint=footprint, fast_math=fast_math)
    px1, pvalid = rc.rollout_soa(system, x0, c, obs, **opts)
    assert 0.05 < pvalid.float().mean() < 0.99
    keys = rng.split(rng.key(31, dev), nb)
    tx1, tc2, tvalid = rc.sample_and_rollout_torch(system, keys, x0, obs, **opts)
    for G in (None, 2, 4):  # the rule's G and two forced ones
        x1, valid = rc.rollout_batched_cuda(system, x0, c, obs, **opts, split=G)
        assert torch.equal(valid, pvalid) and _bitwise(x1, px1), G
        y1, c2, v2 = rc.sample_and_rollout_batched_cuda(system, keys, x0, obs, **opts,
                                                        split=G)
        assert _bitwise(c2, tc2) and torch.equal(v2, tvalid) and _bitwise(y1, tx1), G


@pytest.mark.parametrize("K", [1, 5, 8, 9, 40])
def test_batched_kernel_at_any_box_count_and_problem_width(dev, K):
    """B6, both forms, in every instantiation, at 8 problems of R in {1,
    127, 128, 129, 512} lanes with K boxes each: at G = 1 (the one-thread
    walk, which pads K to a multiple of 4 with neutral boxes) and at the
    rule's G, bitwise equal to the plain twins."""
    for R in (1, 127, 128, 129, 512):
        for name in SYSTEMS:
            system, x0, c, obs = problem_batch(name, 8, R, K, K + R, dev,
                                               padding=min(2, K - 1))
            keys = rng.split(rng.key(K * R, dev), 8)
            for fp in (None, FP):
                for fast in (False, True):
                    opts = dict(KW, footprint=fp, fast_math=fast)
                    px1, pvalid = rc.rollout_soa(system, x0, c, obs, **opts)
                    tx1, tc2, tvalid = rc.sample_and_rollout_torch(system, keys, x0, obs,
                                                                   **opts)
                    for G in (None, 1):
                        what = (R, name, fp, fast, G)
                        x1, valid = rc.rollout_batched_cuda(system, x0, c, obs, **opts,
                                                            split=G)
                        assert torch.equal(valid, pvalid) and _bitwise(x1, px1), what
                        y1, c2, v2 = rc.sample_and_rollout_batched_cuda(
                            system, keys, x0, obs, **opts, split=G)
                        assert _bitwise(c2, tc2) and torch.equal(v2, tvalid), what
                        assert _bitwise(y1, tx1), what


def test_batched_kernel_takes_more_problems_than_a_grid_column(dev):
    """70,000 problems of 2 lanes: more than the 65,535 blocks of a grid's
    y extent, all on grid.x, each against its own boxes."""
    system, x0, c, obs = problem_batch("bicycle", 70_000, 2, 4, 11, dev)
    x1, valid = rc.rollout_batched_cuda(system, x0, c, obs, **KW)
    px1, pvalid = rc.rollout_soa(system, x0, c, obs, **KW)
    assert torch.equal(valid, pvalid) and _bitwise(x1, px1)
    keys = rng.split(rng.key(32, dev), 70_000)
    x1, c2, valid = rc.sample_and_rollout_batched_cuda(system, keys, x0, obs, **KW)
    tx1, tc2, tvalid = rc.sample_and_rollout_torch(system, keys, x0, obs, **KW)
    assert _bitwise(c2, tc2) and torch.equal(valid, tvalid) and _bitwise(x1, tx1)


def test_batched_kernel_isolates_problems_and_keys(dev):
    """A wall added to problem 1 changes only problem 1's lanes; a key gives
    the same rows at B=4 and at B=8 in another slot; a ragged R launches a
    partial block."""
    system, x0, c, obs = problem_batch("bicycle", 8, 300, 8, 7, dev)
    x1, valid = rc.rollout_batched_cuda(system, x0, c, obs, **KW)
    walled = obs.clone()
    walled[1, -1] = torch.tensor([0.0, 9.0, 20.0, 11.0], device=dev)
    wx1, wvalid = rc.rollout_batched_cuda(system, x0, c, walled, **KW)
    others = [b for b in range(8) if b != 1]
    assert torch.equal(wvalid[others], valid[others]) and _bitwise(wx1[others], x1[others])
    assert (wvalid[1] != valid[1]).any()
    keys = rng.split(rng.key(5, dev), 8)
    _, c8, _ = rc.sample_and_rollout_batched_cuda(system, keys, x0, obs, **KW)
    perm = [6, 2, 0, 3]
    _, c4, _ = rc.sample_and_rollout_batched_cuda(system, keys[perm].contiguous(),
                                                  x0[perm].contiguous(),
                                                  obs[perm].contiguous(), **KW)
    assert _bitwise(c4, c8[perm])


def test_batched_wrappers_reject_bad_inputs(dev):
    system, x0, c, obs = problem_batch("bicycle", 4, 128, 8, 9, dev)
    with pytest.raises(ValueError, match="obstacles"):
        rc.rollout_batched_cuda(system, x0, c, obs[0], **KW)  # shared set
    with pytest.raises(ValueError, match="x0"):
        rc.rollout_batched_cuda(system, x0.reshape(-1, 4), c, obs, **KW)
    with pytest.raises(ValueError, match="keys"):
        rc.sample_and_rollout_batched_cuda(system, rng.key(1, dev), x0, obs, **KW)
    rc.reset_launch_counts()
    rc.rollout_batched_cuda(system, x0, c, obs, **KW)
    rc.rollout_batched_cuda(system, x0.cpu(), c.cpu(), obs.cpu(), **KW)  # the twin
    assert rc.rollout_batched_cuda.launches == 1
    assert rc.rollout_batched_cuda.instantiations == {("bicycle", False, False): 1}


@pytest.mark.parametrize("backend,kernel", [
    ("auto", "rollout_batched_cuda"), ("cuda_rng", "sample_and_rollout_batched_cuda")])
def test_sweeps_run_every_wave_through_b6(dev, backend, kernel):
    """The Monte-Carlo sweep (one arena iteration per wave) and the
    streaming sweep (one pool iteration per wave) launch B6 once a wave."""
    from cudasbmp_torch.parallel import MonteCarloPlanner, StreamingMonteCarloPlanner

    cfg = ctt.KGMTConfig(rollouts_per_iter=128, num_iterations=30,
                         max_tree_size=128 * 31, rollout_backend=backend)
    rc.reset_launch_counts()
    s = MonteCarloPlanner(cfg, impl="arena", device=dev).run(16, seed=1, num_obstacles=5)
    assert s.solve_rate >= 0.5
    assert getattr(rc, kernel).launches > 0
    # 16 x 128 lanes a wave: the rule's G, G > 1 on an H100
    G = rc.lanes_per_rollout(16 * 128, rc.sm_count(dev.index or 0))
    assert getattr(rc, kernel).splits == {G: getattr(rc, kernel).launches}
    assert rc.rollout_cuda.launches == rc.sample_and_rollout_cuda.launches == 0
    rc.reset_launch_counts()
    st = StreamingMonteCarloPlanner(cfg, pool=8, device=dev).run(24, seed=2, num_obstacles=5)
    assert st.solve_rate >= 0.5 and getattr(rc, kernel).launches > 0
    parts = [StreamingMonteCarloPlanner(cfg, pool=8, device=dev).run(
        12, seed=2, num_obstacles=5, id_lo=lo) for lo in (0, 12)]
    np.testing.assert_array_equal(np.concatenate([p.costs for p in parts]), st.costs)
    np.testing.assert_array_equal(np.concatenate([p.iters for p in parts]), st.iters)


# ---- B5, the culled broad phase; P1/P2, the calibration chains ----------

WINDOWS = [1, 2, 4, 5]


def dense_field(K: int, dev):
    """Scenario.dense(K)'s boxes, padded to a multiple of 8 with padding rows."""
    sc = ctt.Scenario.dense(K, seed=0)
    return torch.tensor(sc.padded_obstacles(K + 8)[0], device=dev)


def grouped(x0, c):
    from cudasbmp_torch.probes.throughput import morton_order

    order = morton_order(x0)
    return x0[order].contiguous(), c[order].contiguous()


@pytest.mark.parametrize("fast_math", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("footprint", [None, FP], ids=["broad", "footprint"])
@pytest.mark.parametrize("name", SYSTEMS)
def test_culled_kernel_is_b1_in_every_instantiation(dev, name, footprint, fast_math):
    """B5 (both kernels) equals B1/B2 to the bit, states and masks, on the
    dense-24 field at R=4097, for W in {1, 2, 4, 5}, on random and on
    Morton-grouped lanes; and its twin at W=4 on the grouped lanes."""
    system, x0, c = system_batch(name, 4097, 50 + SYSTEMS.index(name), dev)
    obs = dense_field(24, dev)
    opts = dict(KW, footprint=footprint, fast_math=fast_math)
    key = rng.key(23, dev)
    for lanes in ((x0, c), grouped(x0, c)):
        x1, valid = rc.rollout_cuda(system, *lanes, obs, **opts)
        y1, c2, v2 = rc.sample_and_rollout_cuda(system, key, lanes[0], obs, **opts)
        assert 0.05 < valid.float().mean() < 0.99
        for W in WINDOWS:
            cx1, cvalid = rc.rollout_cuda(system, *lanes, obs, **opts, cull=W)
            assert torch.equal(cvalid, valid) and _bitwise(cx1, x1)
            cy1, cc2, cv2 = rc.sample_and_rollout_cuda(system, key, lanes[0], obs,
                                                       **opts, cull=W)
            assert _bitwise(cc2, c2) and torch.equal(cv2, v2) and _bitwise(cy1, y1)
    # the twin on the grouped lanes, the last of the loop
    tx1, tvalid = rc.rollout_culled_soa(system, *lanes, obs, cull=4, group=rc.WARP,
                                        **opts)
    assert torch.equal(tvalid, valid) and _bitwise(tx1, x1)


@pytest.mark.parametrize("R", [33, 2 ** 17])
@pytest.mark.parametrize("K", [24, 100])
def test_culled_kernel_at_ragged_and_full_width(dev, R, K):
    """R=33 (a ragged last warp) and R=2^17 (the probe's width), 24 and 100
    boxes (four ballot chunks), every bicycle option, W in {1, 2, 4, 5},
    random and grouped lanes: B5 equals B1 to the bit."""
    system, x0, c = system_batch("bicycle", R, 60 + K, dev)
    obs = dense_field(K, dev)
    for fp in (None, FP):
        for fast in (False, True):
            opts = dict(KW, footprint=fp, fast_math=fast)
            for lanes in ((x0, c), grouped(x0, c)):
                x1, valid = rc.rollout_cuda(system, *lanes, obs, **opts)
                for W in WINDOWS:
                    cx1, cvalid = rc.rollout_cuda(system, *lanes, obs, **opts, cull=W)
                    assert torch.equal(cvalid, valid) and _bitwise(cx1, x1)
            if R == 33:
                tx1, tvalid = rc.rollout_culled_soa(system, x0, c, obs, cull=2,
                                                    group=rc.WARP, **opts)
                cx1, cvalid = rc.rollout_cuda(system, x0, c, obs, **opts, cull=2)
                assert torch.equal(tvalid, cvalid) and _bitwise(tx1, cx1)


@pytest.mark.parametrize("R", [33, 300])
def test_culled_batched_kernel_is_b6(dev, R):
    """B5 in B6's form (a box set and key per problem; a warp never spans
    two problems): equal to B6 and to the culled twin."""
    system, x0, c, obs = problem_batch("bicycle", 16, R, 24, 13, dev)
    keys = rng.split(rng.key(33, dev), 16)
    for fp in (None, FP):
        opts = dict(KW, footprint=fp)
        x1, valid = rc.rollout_batched_cuda(system, x0, c, obs, **opts)
        y1, c2, v2 = rc.sample_and_rollout_batched_cuda(system, keys, x0, obs, **opts)
        for W in WINDOWS:
            cx1, cvalid = rc.rollout_batched_cuda(system, x0, c, obs, **opts, cull=W)
            assert torch.equal(cvalid, valid) and _bitwise(cx1, x1)
            cy1, cc2, cv2 = rc.sample_and_rollout_batched_cuda(system, keys, x0, obs,
                                                               **opts, cull=W)
            assert _bitwise(cc2, c2) and torch.equal(cv2, v2) and _bitwise(cy1, y1)
        tx1, tvalid = rc.rollout_culled_soa(system, x0, c, obs, cull=4, group=rc.WARP,
                                            **opts)
        assert torch.equal(tvalid, valid) and _bitwise(tx1, x1)


@pytest.mark.parametrize("num_disc", [25, 40])
def test_culled_kernel_past_its_window_cap(dev, num_disc):
    """Windows longer than the kernel keeps (rc.CULL_STEPS steps), cut by
    the wrapper's plan: B5 still equals B1/B2 to the bit, grouped lanes,
    every bicycle option."""
    system, x0, c = system_batch("bicycle", 4097, 70 + num_disc, dev)
    obs = dense_field(24, dev)
    key = rng.key(25, dev)
    assert len(rc.cull_plan(1, num_disc)) > 2
    lanes = grouped(x0, c)
    for fp in (None, FP):
        for fast in (False, True):
            opts = dict(KW, num_disc=num_disc, footprint=fp, fast_math=fast)
            x1, valid = rc.rollout_cuda(system, *lanes, obs, **opts)
            y1, c2, v2 = rc.sample_and_rollout_cuda(system, key, lanes[0], obs, **opts)
            for W in (1, 2):
                cx1, cvalid = rc.rollout_cuda(system, *lanes, obs, **opts, cull=W)
                assert torch.equal(cvalid, valid) and _bitwise(cx1, x1)
                cy1, cc2, cv2 = rc.sample_and_rollout_cuda(system, key, lanes[0], obs,
                                                           **opts, cull=W)
                assert _bitwise(cc2, c2) and torch.equal(cv2, v2) and _bitwise(cy1, y1)


@pytest.mark.parametrize("footprint", [None, FP], ids=["broad", "footprint"])
def test_culled_box_cap_is_the_window_stores_less(dev, footprint):
    """B5 keeps its window beside the boxes: its cap is the one-pass cap
    less the store's bytes / 16. At the cap it launches and equals cull
    off; one box more raises."""
    limit = rc.max_kernel_obstacles(dev.index or 0, culled=True,
                                    footprint=footprint is not None)
    assert (rc.max_kernel_obstacles(dev.index or 0) - limit
            == rc.cull_state_bytes(footprint is not None) // 16)
    system, x0, c = system_batch("bicycle", 512, 44, dev)
    r = np.random.default_rng(limit)
    lo = r.uniform(0, 19.8, (limit + 1, 2))
    boxes = torch.tensor(np.concatenate([lo, lo + r.uniform(0.01, 0.2, (limit + 1, 2))], -1)
                         .astype(np.float32), device=dev)
    opts = dict(KW, footprint=footprint)
    x1, valid = rc.rollout_cuda(system, *grouped(x0, c), boxes[:limit], **opts)
    cx1, cvalid = rc.rollout_cuda(system, *grouped(x0, c), boxes[:limit], **opts, cull=4)
    assert torch.equal(cvalid, valid) and _bitwise(cx1, x1)
    with pytest.raises(ValueError, match=f"{limit + 1} obstacles > {limit}"):
        rc.rollout_cuda(system, x0, c, boxes, **opts, cull=4)


def test_culled_launches_are_counted(dev):
    system, x0, c = system_batch("bicycle", 512, 3, dev)
    obs = dense_field(24, dev)
    rc.reset_launch_counts()
    rc.rollout_cuda(system, x0, c, obs, **KW)
    rc.rollout_bicycle_cuda(x0, c, obs, **KW, cull=True)
    rc.sample_and_rollout_bicycle_cuda(rng.key(1, dev), x0, obs, **KW, cull=5)
    assert (rc.rollout_cuda.launches, rc.rollout_cuda.culled) == (2, 1)
    assert (rc.sample_and_rollout_cuda.launches, rc.sample_and_rollout_cuda.culled) == (1, 1)


def test_chains_match_their_twins(dev):
    """P1a within rtol 1e-5 at 64 links (FMA against two roundings) and
    2e-3 at the full 16,384 (a link's rounding difference, under 1.2e-7
    relative, is damped by m = 0.99993 only over some 1/(1 - m) = 14,500
    links), and at 64 links on 7 programs of 37 rows (not a whole round of
    its grid); cos and sin within 1e-5 at the full 2,048 links; tan at 2
    links (it amplifies any difference); P2 to the bit at 1, 3, 8, 128,
    1,024 and the most rows one block holds, on the calibration's 2,048
    rows of idx and on 1,003 (not a multiple of a block's rows) with
    negative and large indices; one table row more raises."""
    from cudasbmp_torch.ops import chains_cuda as cc
    from cudasbmp_torch.probes import roofline as rf

    x = rf.chain_inputs(dev)
    cc.reset_launch_counts()
    for chain, rtol in ((64, 1e-5), (rf.ALU_CHAIN, 2e-3)):
        torch.testing.assert_close(cc.alu_chain_cuda(x, chain),
                                   cc.alu_chain_torch(x, chain), rtol=rtol, atol=0)
    ragged = torch.rand(7 * 37, 128, generator=torch.Generator().manual_seed(3)).to(dev) + 0.5
    torch.testing.assert_close(cc.alu_chain_cuda(ragged, 64, program_rows=37),
                               cc.alu_chain_torch(ragged, 64, program_rows=37),
                               rtol=1e-5, atol=0)
    for op, chain in (("cos", rf.TRANS_CHAIN), ("sin", rf.TRANS_CHAIN), ("tan", 2)):
        torch.testing.assert_close(cc.trans_chain_cuda(x, chain, op),
                                   cc.trans_chain_torch(x, chain, op), rtol=1e-5, atol=0)
    limit = cc.gather_max_rows(rc.smem_optin(dev.index or 0))
    sizes = (1, 3, *rf.GATHER_ROWS, limit)
    for rows in sizes:
        _, tbl, idx = rf.chain_inputs(dev, rows)
        idx[0, :8] = -rows - 3  # the floor modulo of negative indices
        idx[0, 8:16] = -2 ** 31
        idx[0, 16:24] = 2 ** 31 - 1 - rf.GATHER_CHAIN  # large: idx + i stays an int32
        for i in (idx, idx[:1003].contiguous()):
            assert _bitwise(cc.gather_chain_cuda(tbl, i, rf.GATHER_CHAIN),
                            cc.gather_chain_torch(tbl, i, rf.GATHER_CHAIN))
    assert [w.launches for w in cc.WRAPPERS] == [3, 3, 2 * len(sizes)]
    _, tbl, idx = rf.chain_inputs(dev, 8)
    with pytest.raises(ValueError, match="rows"):
        cc.gather_chain_cuda(torch.zeros(limit + 1, 128, device=dev), idx, 4)


def test_sincos_rounds_as_torch_sin_and_cos_for_every_float(dev):
    """The rollout kernels take a heading's cosine and sine from one
    sincosf; the plain twins call torch.cos and torch.sin apart. Every one
    of the 2^32 float bit patterns gives both the same bits."""
    from cudasbmp_torch.ops import chains_cuda as cc

    cc.reset_launch_counts()
    assert cc.sincos_differences(dev) == 0
    assert cc.sincos_cuda.launches == 64


def test_chain_wrappers_reject_bad_inputs(dev):
    from cudasbmp_torch.ops import chains_cuda as cc

    x = torch.rand(512, 128, device=dev)
    tbl, idx = torch.rand(8, 128, device=dev), torch.zeros(64, 128, dtype=torch.int32,
                                                           device=dev)
    with pytest.raises(ValueError, match="float32"):
        cc.alu_chain_cuda(x.double(), 4)
    with pytest.raises(ValueError, match="programs"):
        cc.trans_chain_cuda(x[:300], 4, "cos")
    with pytest.raises(ValueError, match="several devices"):
        cc.gather_chain_cuda(tbl.cpu(), idx, 4)
    with pytest.raises(ValueError, match="int32"):
        cc.gather_chain_cuda(tbl, idx.long(), 4)
    with pytest.raises(ValueError, match="tbl"):
        cc.gather_chain_cuda(tbl[:, :64].contiguous(), idx, 4)
    with pytest.raises(ValueError, match="idx"):
        cc.gather_chain_cuda(tbl, idx[:, :100].contiguous(), 4)


@pytest.mark.parametrize("backend", ["auto", "cuda_rng"])
def test_multi_query_problems_equal_their_single_solves(dev, backend):
    """The vmapped planner on the card: every trip one launch of B6 (or its
    Philox form), and each problem equals the single solve on its key
    (B1/B2 at the single solve's width), bit for bit."""
    from cudasbmp_torch.parallel import MultiQueryPlanner
    from cudasbmp_torch.planners import kgmt as tk

    cfg = ctt.KGMTConfig(num_iterations=100, max_tree_size=16384,
                         rollouts_per_iter=2048, rollout_backend=backend)
    base = Scenario.demo()
    B = 6
    inits = np.tile(base.init, (B, 1)).astype(np.float32)
    goals = np.tile(base.goal, (B, 1)).astype(np.float32)
    goals[:, :2] += np.random.default_rng(2).uniform(-1, 1, (B, 2)).astype(np.float32)
    obstacles = base.padded_obstacles(8)[0]
    planner = MultiQueryPlanner(cfg, device=dev)
    rc.reset_launch_counts()
    res = planner.plan_batch(inits, goals, obstacles, seed=11)
    kernel = (rc.sample_and_rollout_batched_cuda if backend == "cuda_rng"
              else rc.rollout_batched_cuda)
    assert kernel.launches == planner.last_state.trips > 0
    for b in range(B):
        s = tk.kgmt_solve(cfg, planner.system, planner.grid,
                          torch.tensor(inits[b], device=dev),
                          torch.tensor(goals[b], device=dev),
                          torch.tensor(obstacles, device=dev),
                          rng.fold_in(rng.key(11, dev), b))
        _, samples, length = tk.extract_path(cfg, s)
        assert (res.iterations[b], res.tree_sizes[b], res.path_lengths[b]) == (
            s.itr, s.tree_size, int(length))
        assert res.costs[b] == float(s.cost_to_goal)
        np.testing.assert_array_equal(res.paths[b].view(np.uint32),
                                      samples.cpu().numpy().view(np.uint32))


def test_shortcut_on_the_card_equals_its_twin(dev, monkeypatch):
    """shortcut_batch through B6 and shortcut_path through B1 give what the
    plain twin gives driven on the card."""
    from cudasbmp_torch import shortcut as sc

    cfg = ctt.KGMTConfig(num_iterations=100, max_tree_size=16384, rollouts_per_iter=2048)
    planner = ctt.KGMT(cfg, device=dev)
    base = Scenario.demo()
    path = planner.plan(base, seed=1).path
    scfg = sc.ShortcutConfig(rounds=16, candidates=256)
    paths = np.stack([path] * 4)
    lengths = np.array([len(path)] * 4)
    goals = np.tile(base.goal, (4, 1)).astype(np.float32)
    obstacles = base.padded_obstacles(8)[0]
    rc.reset_launch_counts()
    card = (sc.shortcut_path(planner.system, cfg, path, base.goal, base.obstacles,
                             scfg, seed=3, device=dev),
            sc.shortcut_batch(planner.system, cfg, paths, lengths, goals, obstacles,
                              scfg, seed=3, device=dev))
    assert rc.rollout_cuda.launches > 0 and rc.rollout_batched_cuda.launches > 0
    monkeypatch.setattr(sc, "rollout_cuda", rc.rollout_soa)
    monkeypatch.setattr(sc, "rollout_batched_cuda", rc.rollout_soa)
    twin = (sc.shortcut_path(planner.system, cfg, path, base.goal, base.obstacles,
                             scfg, seed=3, device=dev),
            sc.shortcut_batch(planner.system, cfg, paths, lengths, goals, obstacles,
                              scfg, seed=3, device=dev))
    for a, b in zip(card, twin):
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def refine_inputs(name: str, B: int, L: int, num_disc: int, seed: int, dev,
                  masked: bool, per_problem: bool):
    """R1's inputs from a numpy generator: starts in the middle of the
    workspace, controls in the system's box, the last third of each
    problem's edges masked (duration 0, weight 0) with ``masked``, goals in
    the workspace, the demo's boxes shared or 8 random boxes per problem."""
    system = get_system(name)
    r = np.random.default_rng(seed)
    lo = np.asarray(system.control_spec.lo, np.float32)
    hi = np.asarray(system.control_spec.hi, np.float32)
    x0 = np.zeros((B, 4), np.float32)
    x0[:, :2] = r.uniform(6.0, 14.0, (B, 2))
    if name in ("bicycle", "double_integrator", "unicycle", "dubins"):
        x0[:, 2] = r.uniform(-np.pi, np.pi, B) if name != "double_integrator" \
            else r.uniform(-1.0, 1.0, B)
    if name in ("bicycle", "double_integrator"):
        x0[:, 3] = r.uniform(-1.0, 1.0, B)
    controls = (lo + (hi - lo) * r.uniform(size=(B, L, 3))).astype(np.float32)
    controls[..., 2] *= np.float32(0.3)
    wts = np.ones((B, L), np.float32)
    if masked:
        keep = np.maximum(1, L - L // 3 - r.integers(0, 2, B))
        wts = (np.arange(L)[None] < keep[:, None]).astype(np.float32)
        controls[..., 2] *= wts
    goal = r.uniform(2.0, 18.0, (B, 2)).astype(np.float32)
    if per_problem:
        c = r.uniform(2.0, 18.0, (B, 8, 2))
        h = r.uniform(0.3, 2.0, (B, 8, 2))
        obs = np.concatenate([c - h, c + h], -1).astype(np.float32)
    else:
        obs = Scenario.demo().padded_obstacles(8)[0]
    return system, [torch.tensor(a, device=dev) for a in (x0, controls, wts, goal, obs)]


REFINE_KW = dict(num_disc=10, width=20.0, height=20.0, margin=0.05, goal_threshold=1.0,
                 collision_weight=30.0, goal_weight=10.0)


@pytest.mark.parametrize("per_problem", [False, True], ids=["shared", "per_problem"])
@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("L,num_disc", [(1, 1), (1, 10), (6, 10), (151, 10)])
@pytest.mark.parametrize("name", SYSTEMS)
def test_refine_kernel_matches_its_twin(dev, name, L, num_disc, masked, per_problem):
    """R1's forward states equal the twin's positions to the bit; the
    penalty agrees within rtol 1e-5 (sums of positive terms in another
    order) and the gradient within 1e-4 of its norm (the reverse sweep
    accumulates in another order than autograd)."""
    from cudasbmp_torch.ops import refine_cuda as rf

    system, (x0, c, w, goal, obs) = refine_inputs(name, 8, L, num_disc, L, dev, masked,
                                                  per_problem)
    kw = dict(REFINE_KW, num_disc=num_disc)
    loss, grad, states = rf._launch(system, x0, c, w, goal, obs, **kw)
    pts = rf.unroll_positions(system, x0, c, num_disc)
    assert torch.equal(states[:, 1:, :2].contiguous().view(torch.int32),
                       pts.contiguous().view(torch.int32))
    cr = c.clone().requires_grad_()
    twin = rf.refine_penalty_torch(system, x0, cr, w, goal, obs, **kw)
    (tgrad,) = torch.autograd.grad(twin.sum(), cr)
    torch.testing.assert_close(loss, twin.detach(), rtol=1e-5, atol=1e-6)
    err = (grad - tgrad).flatten(1).norm(dim=1)
    assert bool((err <= 1e-4 * tgrad.flatten(1).norm(dim=1) + 1e-6).all()), err
    # under autograd: one launch, the gradient scaled by the cotangent
    cr = c.clone().requires_grad_()
    n = rf.refine_penalty_cuda.launches
    out = rf.refine_penalty_cuda(system, x0, cr, w, goal, obs, **kw)
    (g2,) = torch.autograd.grad((out * 2.0).sum(), cr)
    assert rf.refine_penalty_cuda.launches == n + 1
    assert torch.equal(out, loss) and torch.equal(g2, 2.0 * grad)


def test_refine_path_and_batch_run_on_r1_and_b1_b6(dev):
    """On the card a refinement is one launch of the whole refinement's
    kernel (no R1 launch); refine_path's revalidation is B1's, an edge,
    refine_batch's B6's, an edge of its longest real path; a batch row
    equals refine_path on its path."""
    from cudasbmp_torch import refine as tr
    from cudasbmp_torch.ops import refine_cuda as rf

    cfg = ctt.KGMTConfig(num_iterations=100, max_tree_size=16384, rollouts_per_iter=2048)
    planner = ctt.KGMT(cfg, device=dev)
    base = Scenario.demo()
    paths = [planner.plan(base, seed=s).path for s in (1, 2)]
    rcfg = tr.RefineConfig(iterations=20)
    rc.reset_launch_counts()
    rf.refine_penalty_cuda.launches = rf.refine_adam_cuda.launches = 0
    one = tr.refine_path(planner.system, cfg, paths[0], base.goal, base.obstacles, rcfg,
                         device=dev)
    assert rf.refine_adam_cuda.launches == 1 and rf.refine_penalty_cuda.launches == 0
    assert rc.rollout_cuda.launches == len(paths[0]) - 1
    assert rc.rollout_batched_cuda.launches == 0
    Lmax = max(map(len, paths)) + 1
    batch = np.zeros((3, Lmax, 7), np.float32)
    for i, p in enumerate(paths):
        batch[i, :len(p)] = p
    lengths = np.array([len(paths[0]), len(paths[1]), 0])
    goals = np.tile(base.goal, (3, 1)).astype(np.float32)
    rc.reset_launch_counts()
    out = tr.refine_batch(planner.system, cfg, batch, lengths, goals, base.obstacles, rcfg,
                          device=dev)
    assert rf.refine_adam_cuda.launches == 2 and rf.refine_penalty_cuda.launches == 0
    assert rc.rollout_batched_cuda.launches == lengths.max() - 1
    assert rc.rollout_cuda.launches == 0
    n = len(paths[0]) - 1
    np.testing.assert_array_equal(out["controls"][0, :n], one["controls"])
    np.testing.assert_array_equal(out["losses"][0], one["losses"])
    assert out["valid"][0] == one["valid"] and not out["valid"][2]
    np.testing.assert_array_equal(out["controls"][2], batch[2, 1:, 4:])


def adam_inputs(name: str, B: int, L: int, seed: int, dev, per_problem: bool):
    """The whole refinement's inputs: refine_inputs' starts, controls (every
    duration real) and boxes, and a mask of each problem's path: row 0 of a
    batch unsolved (all masked), row 1 whole, row 2 with its first edge
    masked too, the rest a random prefix; B = 1 a prefix of L - 2 edges."""
    system, (x0, c, _, goal, obs) = refine_inputs(name, B, L, 10, seed, dev, False,
                                                  per_problem)
    r = np.random.default_rng(seed + 1)
    lengths = r.integers(0, L + 1, B) if B > 1 else np.array([max(L - 2, 1)])
    if B > 2:
        lengths[:3] = (0, L, L)
    mask = np.arange(L)[None] < lengths[:, None]
    if B > 2:
        mask[2, 0] = False
    return system, x0, c, torch.tensor(mask, device=dev), goal, obs


def _adam(system, x0, c, mask, goal, obs, rcfg):
    """The whole refinement through refine.py's entry: one launch of
    refine_adam_kernel."""
    from cudasbmp_torch import refine as tr

    return tr._refine_core(system, ctt.KGMTConfig(), rcfg, x0, goal, obs, c, mask)


@pytest.mark.parametrize("iterations", [20, 400])
@pytest.mark.parametrize("B,L", [(1, 9), (128, 24)])
@pytest.mark.parametrize("per_problem", [False, True], ids=["shared", "per_problem"])
@pytest.mark.parametrize("name", SYSTEMS)
def test_whole_refinement_is_the_step_path(dev, name, per_problem, B, L, iterations):
    """One launch of refine_adam_kernel gives the losses [iterations, B]
    and the refined controls of the step path (R1 and torch's Adam ops, a
    launch of R1 a step) to the bit, unsolved rows and masked edges
    included."""
    from cudasbmp_torch import refine as tr
    from cudasbmp_torch.ops import refine_cuda as rf

    system, x0, c, mask, goal, obs = adam_inputs(name, B, L, 3 + B, dev, per_problem)
    rcfg = tr.RefineConfig(iterations=iterations)
    want = tr._refine_core(system, ctt.KGMTConfig(), rcfg, x0, goal, obs, c, mask,
                           penalty=rf.refine_penalty_cuda)
    n = rf.refine_adam_cuda.launches
    got = _adam(system, x0, c, mask, goal, obs, rcfg)
    assert rf.refine_adam_cuda.launches == n + 1
    assert _bitwise(got[1], want[1]), (got[1] - want[1]).abs().max()
    assert _bitwise(got[0], want[0]), (got[0] - want[0]).abs().max()


@pytest.mark.parametrize("per_problem", [False, True], ids=["shared", "per_problem"])
@pytest.mark.parametrize("name", SYSTEMS)
def test_whole_refinement_agrees_with_its_twin(dev, name, per_problem):
    """Against the plain twin (the penalty under autograd) at 3 steps,
    within tests/test_torch_refine.py's tolerances: controls rtol and atol
    1e-5, the first two losses rtol 1e-5."""
    from cudasbmp_torch import refine as tr
    from cudasbmp_torch.ops import refine_cuda as rf

    system, x0, c, mask, goal, obs = adam_inputs(name, 16, 9, 5, dev, per_problem)
    rcfg = tr.RefineConfig(iterations=3)
    want = tr._refine_core(system, ctt.KGMTConfig(), rcfg, x0, goal, obs, c, mask,
                           penalty=rf.refine_penalty_torch)
    got = _adam(system, x0, c, mask, goal, obs, rcfg)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[1][:2], want[1][:2], rtol=1e-5, atol=0)


def test_whole_refinement_workspaces_agree(dev):
    """Either side of the switch, the working set in shared memory below it
    and in global scratch past it (the wrapper picks by size), the whole
    refinement gives the step path's bits, so the two instantiations
    agree."""
    from cudasbmp_torch import refine as tr
    from cudasbmp_torch.ops import refine_cuda as rf

    system = get_system("bicycle")
    limit = rf.adam_workspace(system, 1, 10, dev)[1]
    assert 0 < rf.adam_workspace(system, 24, 10, dev)[0] <= limit
    L = 1
    while rf.adam_workspace(system, L, 10, dev)[0] <= limit:
        L *= 2
    lo, hi = L // 2, L
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if rf.adam_workspace(system, mid, 10, dev)[0] <= limit else (lo, mid)
    rcfg = tr.RefineConfig(iterations=3)
    for edges, where in ((lo, "shared"), (hi, "global")):
        system, x0, c, mask, goal, obs = adam_inputs("bicycle", 3, edges, 8, dev, False)
        want = tr._refine_core(system, ctt.KGMTConfig(), rcfg, x0, goal, obs, c, mask,
                               penalty=rf.refine_penalty_cuda)
        rf.refine_adam_cuda.workspaces.clear()
        got = _adam(system, x0, c, mask, goal, obs, rcfg)
        assert rf.refine_adam_cuda.workspaces == {where: 1}
        assert _bitwise(got[0], want[0]) and _bitwise(got[1], want[1]), edges


def test_refine_wrapper_rejects_bad_inputs(dev):
    """R1's wrapper checks what the kernel takes and raises; nothing falls
    back to the twin on a CUDA tensor."""
    from cudasbmp_torch.ops import refine_cuda as rf

    system, (x0, c, w, goal, obs) = refine_inputs("bicycle", 2, 3, 10, 0, dev, False, False)
    with pytest.raises(ValueError, match="controls"):
        rf.refine_penalty_cuda(system, x0, c.double(), w, goal, obs, **REFINE_KW)
    with pytest.raises(ValueError, match="wts"):
        rf.refine_penalty_cuda(system, x0, c, w[:, :2].contiguous(), goal, obs, **REFINE_KW)
    with pytest.raises(ValueError, match="obstacles"):
        rf.refine_penalty_cuda(system, x0, c, w, goal, obs[None].expand(3, -1, -1).contiguous(),
                               **REFINE_KW)
    with pytest.raises(ValueError, match="points a problem"):
        rf._launch(system, x0, c, w, goal, obs, **dict(REFINE_KW, num_disc=2 ** 30))
    with pytest.raises(ValueError, match="several devices"):
        rf.refine_penalty_cuda(system, x0.cpu(), c, w, goal, obs, **REFINE_KW)
    rcfg_kw = dict(iterations=2, learning_rate=1e-3, clip_norm=1.0, time_weight=1.0)
    system, x0, c, mask, goal, obs = adam_inputs("bicycle", 3, 4, 0, dev, False)
    with pytest.raises(ValueError, match="controls0"):
        rf.refine_adam_cuda(system, x0, goal, obs, c.double(), mask, **REFINE_KW, **rcfg_kw)
    with pytest.raises(ValueError, match="mask"):
        rf.refine_adam_cuda(system, x0, goal, obs, c, mask.float(), **REFINE_KW, **rcfg_kw)
    with pytest.raises(ValueError, match="obstacles"):
        rf.refine_adam_cuda(system, x0, goal, obs[None].expand(2, -1, -1).contiguous(), c,
                            mask, **REFINE_KW, **rcfg_kw)
    with pytest.raises(ValueError, match="points a problem"):
        rf.refine_adam_cuda(system, x0, goal, obs, c, mask,
                            **dict(REFINE_KW, num_disc=2 ** 30), **rcfg_kw)
    with pytest.raises(ValueError, match="iterations"):
        rf.refine_adam_cuda(system, x0, goal, obs, c, mask, **REFINE_KW,
                            **dict(rcfg_kw, iterations=-1))
    with pytest.raises(ValueError, match="several devices"):
        rf.refine_adam_cuda(system, x0.cpu(), goal, obs, c, mask, **REFINE_KW, **rcfg_kw)


@pytest.mark.parametrize("backend", ["auto", "cuda_rng"])
@pytest.mark.parametrize("D", [1, 4])
def test_sharded_trips_equal_the_twin(dev, D, backend, monkeypatch):
    """ShardedTreePlanner at KGMTConfig()'s widths (8 iterations): every
    trip is one launch of B6 (auto) or of B6's Philox form (cuda_rng) over
    D shards x 4,096 lanes with the one box set given to every shard, and
    its rows equal the plain twin's on the same card and inputs to the
    bit."""
    from cudasbmp_torch.parallel import ShardedTreePlanner, make_planner_mesh
    from cudasbmp_torch.parallel import multi_query as mq

    calls = []
    rollout = mq._rollout

    def spy(cfg, system, k_ctrl, x0, obstacles):
        out = rollout(cfg, system, k_ctrl, x0, obstacles)
        calls.append((system, k_ctrl, x0, obstacles, *out))
        return out

    monkeypatch.setattr(mq, "_rollout", spy)
    rc.reset_launch_counts()
    cfg = ctt.KGMTConfig(num_iterations=8, rollout_backend=backend)
    planner = ShardedTreePlanner(cfg, mesh=make_planner_mesh(n_tree=D))
    planner.plan(Scenario.demo())
    wrapper = (rc.rollout_batched_cuda if backend == "auto"
               else rc.sample_and_rollout_batched_cuda)
    assert wrapper.launches == len(calls) == planner.last_state.trips > 0
    for system, k_ctrl, x0, obstacles, x1, controls, valid in calls:
        assert x0.shape == (D, cfg.rollouts_per_iter, 4) and obstacles.shape[0] == D
        assert bool((obstacles == obstacles[0]).all())
        if backend == "auto":
            tx1, tvalid = rc.rollout_soa(system, x0, controls, obstacles, **KW)
        else:
            tx1, tc, tvalid = rc.sample_and_rollout_torch(system, k_ctrl, x0, obstacles,
                                                          **KW)
            assert _bitwise(tc, controls)
        assert _bitwise(tx1, x1) and torch.equal(tvalid, valid)


# -- user systems: a system's own device struct in a library of its own ------

@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("fast_math", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("footprint", [None, FP], ids=["broad", "footprint"])
def test_bicycle_copy_struct_is_the_builtin_kernel(dev, footprint, fast_math, G):
    """The built-in bicycle's struct, copied into a user library, gives the
    built-in kernels' bits: B1 and B2 at 4,096 lanes, B6 and B6 Philox at 8
    problems x 512 lanes, at G = 1 and 4; its launches count in
    ``user_systems``, not ``instantiations``."""
    system, x0, c = system_batch("bicycle", 4096, 0, dev)
    copy, obs, key = BicycleCopy(), _obstacles(dev), rng.key(3, dev)
    opts = dict(KW, footprint=footprint, fast_math=fast_math, split=G)
    rc.reset_launch_counts()
    x1, v = rc.rollout_cuda(system, x0, c, obs, **opts)
    ux1, uv = rc.rollout_cuda(copy, x0, c, obs, **opts)
    assert torch.equal(v, uv) and _bitwise(x1, ux1)
    y1, c2, v2 = rc.sample_and_rollout_cuda(system, key, x0, obs, **opts)
    uy1, uc2, uv2 = rc.sample_and_rollout_cuda(copy, key, x0, obs, **opts)
    assert _bitwise(c2, uc2) and torch.equal(v2, uv2) and _bitwise(y1, uy1)
    _, bx0, bc, bobs = problem_batch("bicycle", 8, 512, 8, 1, dev)
    keys = rng.split(key, 8)
    x1, v = rc.rollout_batched_cuda(system, bx0, bc, bobs, **opts)
    ux1, uv = rc.rollout_batched_cuda(copy, bx0, bc, bobs, **opts)
    assert torch.equal(v, uv) and _bitwise(x1, ux1)
    y1, c2, v2 = rc.sample_and_rollout_batched_cuda(system, keys, bx0, bobs, **opts)
    uy1, uc2, uv2 = rc.sample_and_rollout_batched_cuda(copy, keys, bx0, bobs, **opts)
    assert _bitwise(c2, uc2) and torch.equal(v2, uv2) and _bitwise(y1, uy1)
    inst = ("bicycle_copy", footprint is not None, fast_math)
    for w in rc.WRAPPERS:
        assert w.launches == 2 and w.user_systems == {inst: 1}, w.__name__
        assert sum(w.instantiations.values()) == 1 and w.splits == {G: 2}


@pytest.mark.parametrize("fast_math", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("footprint", [None, FP], ids=["broad", "footprint"])
def test_bicycle_copy_struct_culled_is_the_builtin(dev, footprint, fast_math):
    """B5 of the copy at W = 4 on the dense-24 field's Morton-grouped lanes
    equals the built-in's B5, both kernels."""
    system, x0, c = system_batch("bicycle", 4097, 50, dev)
    x0, c = grouped(x0, c)
    obs, key = dense_field(24, dev), rng.key(23, dev)
    opts = dict(KW, footprint=footprint, fast_math=fast_math, cull=4)
    x1, v = rc.rollout_cuda(system, x0, c, obs, **opts)
    ux1, uv = rc.rollout_cuda(BicycleCopy(), x0, c, obs, **opts)
    assert 0.05 < v.float().mean() < 0.99
    assert torch.equal(v, uv) and _bitwise(x1, ux1)
    y1, c2, v2 = rc.sample_and_rollout_cuda(system, key, x0, obs, **opts)
    uy1, uc2, uv2 = rc.sample_and_rollout_cuda(BicycleCopy(), key, x0, obs, **opts)
    assert _bitwise(c2, uc2) and torch.equal(v2, uv2) and _bitwise(y1, uy1)


@pytest.mark.parametrize("footprint", [None, FP], ids=["broad", "footprint"])
def test_user_dynamics_struct_matches_its_twin(dev, footprint):
    """A struct of new dynamics (the damped double integrator) against its
    torch hooks: B1 and B2 at every G, B6 and B6 Philox, B5 at W = 4."""
    system = DriftStruct()
    r = np.random.default_rng(11)
    x0 = np.zeros((4096, 4), np.float32)
    x0[:, :2] = r.uniform(0.5, 19.5, (4096, 2))
    x0[:, 2:] = r.uniform(-3, 3, (4096, 2))
    c = r.uniform(0, 1, (4096, 3)) * (6.0, 6.0, 1.0) + (-3.0, -3.0, 0.05)
    x0, c = torch.tensor(x0, device=dev), torch.tensor(c.astype(np.float32), device=dev)
    obs, key = _obstacles(dev), rng.key(5, dev)
    opts = dict(KW, footprint=footprint)
    px1, pv = rc.rollout_soa(system, x0, c, obs, **opts)
    assert 0.05 < pv.float().mean() < 0.99
    tx1, tc2, tv = rc.sample_and_rollout_torch(system, key, x0, obs, **opts)
    for G in (None, *rc.SPLITS):
        x1, v = rc.rollout_cuda(system, x0, c, obs, **opts, split=G)
        assert torch.equal(v, pv) and _bitwise(x1, px1), G
        y1, c2, v2 = rc.sample_and_rollout_cuda(system, key, x0, obs, **opts, split=G)
        assert _bitwise(c2, tc2) and torch.equal(v2, tv) and _bitwise(y1, tx1), G
    bx0, bc = x0.view(8, 512, 4), c.view(8, 512, 3)
    bobs = problem_batch("bicycle", 8, 512, 8, 2, dev)[3]
    keys = rng.split(key, 8)
    px1, pv = rc.rollout_soa(system, bx0, bc, bobs, **opts)
    x1, v = rc.rollout_batched_cuda(system, bx0, bc, bobs, **opts)
    assert torch.equal(v, pv) and _bitwise(x1, px1)
    tx1, tc2, tv = rc.sample_and_rollout_torch(system, keys, bx0, bobs, **opts)
    y1, c2, v2 = rc.sample_and_rollout_batched_cuda(system, keys, bx0, bobs, **opts)
    assert _bitwise(c2, tc2) and torch.equal(v2, tv) and _bitwise(y1, tx1)
    x0, c = grouped(x0, c)
    dense = dense_field(24, dev)
    px1, pv = rc.rollout_culled_soa(system, x0, c, dense, cull=4, group=rc.WARP, **opts)
    x1, v = rc.rollout_cuda(system, x0, c, dense, **opts, cull=4)
    assert torch.equal(v, pv) and _bitwise(x1, px1)


def test_user_refine_kernel_with_and_without_back(dev):
    """R1 of the bicycle copy is the built-in R1 to the bit; of the damped
    double integrator, its autograd twin's (states bitwise, penalty rtol
    1e-5, gradient 1e-4 of its norm); a struct without back() raises,
    naming the hook."""
    from cudasbmp_torch.ops import refine_cuda as rf

    system, (x0, c, w, goal, obs) = refine_inputs("bicycle", 8, 6, 10, 4, dev, True, False)
    want = rf._launch(system, x0, c, w, goal, obs, **REFINE_KW)
    rf.refine_penalty_cuda.user_systems.clear()
    got = rf._launch(BicycleCopy(), x0, c, w, goal, obs, **REFINE_KW)
    assert all(_bitwise(a, b) for a, b in zip(want, got))
    assert rf.refine_penalty_cuda.user_systems == {"bicycle_copy": 1}
    _, (x0, c, w, goal, obs) = refine_inputs("double_integrator", 8, 6, 10, 5, dev, True,
                                             True)
    drift = DriftStruct()
    loss, grad, states = rf._launch(drift, x0, c, w, goal, obs, **REFINE_KW)
    pts = rf.unroll_positions(drift, x0, c, 10)
    assert _bitwise(states[:, 1:, :2].contiguous(), pts.contiguous())
    cr = c.clone().requires_grad_()
    twin = rf.refine_penalty_torch(drift, x0, cr, w, goal, obs, **REFINE_KW)
    (tgrad,) = torch.autograd.grad(twin.sum(), cr)
    torch.testing.assert_close(loss, twin.detach(), rtol=1e-5, atol=1e-6)
    err = (grad - tgrad).flatten(1).norm(dim=1)
    assert bool((err <= 1e-4 * tgrad.flatten(1).norm(dim=1) + 1e-6).all()), err
    with pytest.raises(NotImplementedError, match="back"):
        rf.refine_penalty_cuda(DriftNoBack(), x0, c, w, goal, obs, **REFINE_KW)
    with pytest.raises(NotImplementedError, match="no device struct"):
        rf.refine_penalty_cuda(Drift(), x0, c, w, goal, obs, **REFINE_KW)


def test_user_whole_refinement_with_and_without_back(dev):
    """The whole refinement of the bicycle copy is the built-in's to the
    bit, in the copy's library; of the damped double integrator, its step
    path's (R1 of its struct and torch's Adam); a struct without back()
    raises, naming the hook, and a system without a struct too."""
    from cudasbmp_torch import refine as tr
    from cudasbmp_torch.ops import refine_cuda as rf

    system, x0, c, mask, goal, obs = adam_inputs("bicycle", 8, 6, 4, dev, False)
    rcfg = tr.RefineConfig(iterations=20)
    want = _adam(system, x0, c, mask, goal, obs, rcfg)
    rf.refine_adam_cuda.user_systems.clear()
    got = _adam(BicycleCopy(), x0, c, mask, goal, obs, rcfg)
    assert _bitwise(want[0], got[0]) and _bitwise(want[1], got[1])
    assert rf.refine_adam_cuda.user_systems == {"bicycle_copy": 1}
    _, x0, c, mask, goal, obs = adam_inputs("double_integrator", 8, 6, 5, dev, True)
    drift = DriftStruct()
    want = tr._refine_core(drift, ctt.KGMTConfig(), rcfg, x0, goal, obs, c, mask,
                           penalty=rf.refine_penalty_cuda)
    got = _adam(drift, x0, c, mask, goal, obs, rcfg)
    assert _bitwise(want[0], got[0]) and _bitwise(want[1], got[1])
    with pytest.raises(NotImplementedError, match="back"):
        _adam(DriftNoBack(), x0, c, mask, goal, obs, rcfg)
    with pytest.raises(NotImplementedError, match="no device struct"):
        _adam(Drift(), x0, c, mask, goal, obs, rcfg)


def test_a_broken_struct_raises_with_nvccs_text(dev):
    """No fallback: a struct that does not compile raises at its first
    launch with the compiler's output, and leaves no library."""
    from cudasbmp_torch.ops import _build

    class Broken(DriftStruct):
        cuda_struct = DriftStruct.cuda_struct.replace("return make_float4", "retrun make_float4", 1)

    x0, c = demo_batch(64, 0, dev)
    with pytest.raises(RuntimeError, match="(?s)nvcc failed.*retrun"):
        rc.rollout_cuda(Broken(), x0, c, _obstacles(dev), **KW)
    assert not _build.library_path(Broken.cuda_struct).exists()


@pytest.mark.parametrize("backend", ["auto", "cuda_rng"])
def test_user_struct_solves_equal_the_builtin(dev, backend):
    """The demo solve with the bicycle copy equals the built-in's field for
    field, every wave a user-struct launch."""
    cfg = ctt.KGMTConfig(rollout_backend=backend)
    want = ctt.KGMT(cfg, device="cuda").plan(Scenario.demo(), seed=0)
    rc.reset_launch_counts()
    got = ctt.KGMT(cfg, system=BicycleCopy(), device="cuda").plan(Scenario.demo(), seed=0)
    assert (got.solved, got.iterations, got.tree_size, got.cost) == (
        want.solved, want.iterations, want.tree_size, want.cost)
    assert got.path.tobytes() == want.path.tobytes()
    wrapper = rc.sample_and_rollout_cuda if backend == "cuda_rng" else rc.rollout_cuda
    assert wrapper.launches > 0 and sum(wrapper.user_systems.values()) == wrapper.launches
    assert not wrapper.instantiations and got.metrics["rollout"] == "kernel"


def test_generic_route_on_the_card(dev):
    """A system without a struct solves under ``auto`` through its step and
    launches no kernel; ``cuda`` refuses it."""
    cfg = ctt.KGMTConfig()
    rc.reset_launch_counts()
    r = ctt.KGMT(cfg, system=Drift(), device="cuda").plan(Scenario.demo(), seed=0)
    assert r.metrics["rollout"] == "generic" and r.iterations > 0
    assert all(w.launches == 0 for w in rc.WRAPPERS)
    with pytest.raises(NotImplementedError, match="'auto'"):
        ctt.KGMT(cfg.replace(rollout_backend="cuda"), system=Drift(),
                 device="cuda").plan(Scenario.demo())

