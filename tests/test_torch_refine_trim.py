"""Each problem of a refinement trimmed to its own path (cudasbmp_torch/
refine.py, ops/refine_cuda.py), on the CPU: the properties the whole
refinement's kernel (csrc/refine.cu::refine_adam_kernel) relies on.

- ``_refine_core`` on a batch of mixed lengths (unsolved rows among them),
  with shared and per-problem boxes, equals each row's own unpadded run to
  the bit at 3 Adam steps, for every system: padded edges (duration 0,
  weight 0) leave the states, the penalty's sums, the time term, the
  gradient norm's pairwise tree and the adjoint as they are; an unsolved
  row scores the goal term at x0 every step;
- the bias tables are the ones the loop always used (torch's pow in f32);
- ``refine_batch``, which refines and replays its batch cut to the longest
  real path, equals the untrimmed run to the bit on rows of 0, 1, 3 and 12
  edges, and ``_revalidate`` cut there gives the untrimmed states; with
  torch's own sigmoid and log, within tests/test_torch_refine.py's
  tolerances and with the same verdicts;
- on the CPU the whole refinement's entry is its plain twin's loop.

torch's CPU sigmoid (and log) take a vectorised path for most elements of
a tensor and a scalar one for its tail, which can round differently in the
last bit, so an element's bits depend on where it lies; the tests here
apply them one element at a time (``elementwise``), as every element of a
CUDA tensor takes one path on the card.
"""

import numpy as np
import pytest
import torch

import cudasbmp_torch as ct
from cudasbmp_torch import refine as tr
from cudasbmp_torch.ops import refine_cuda as rf
from cudasbmp_torch.systems.registry import get_system

torch.set_num_threads(2)
CFG = ct.KGMTConfig(num_iterations=100, max_tree_size=16384, rollouts_per_iter=2048)
DEMO = ct.Scenario.demo()
SYSTEMS = ("bicycle", "point2d", "double_integrator", "unicycle", "dubins")
FEW = tr.RefineConfig(iterations=3)
EDGES = (0, 1, 3, 12)  # a row's real edges; 0: unsolved


@pytest.fixture
def elementwise(monkeypatch):
    """torch.sigmoid and torch.log one element at a time (autograd through
    each), so an element's bits do not depend on its place in the tensor."""
    for name in ("sigmoid", "log"):
        fn = getattr(torch, name)

        def one_at_a_time(x, fn=fn):
            return torch.stack([fn(e) for e in x.reshape(-1).unbind()]).reshape(x.shape)

        monkeypatch.setattr(torch, name, one_at_a_time)


def _batch(name: str, seed: int, width: int):
    """A batch of rows with EDGES real edges, padded to ``width`` edges:
    starts in the workspace, controls in the system's box (short
    durations), the demo's goal; padding is finite controls, masked."""
    system = get_system(name)
    r = np.random.default_rng(seed)
    lo = np.asarray(system.control_spec.lo, np.float32)
    hi = np.asarray(system.control_spec.hi, np.float32)
    B = len(EDGES)
    x0 = np.zeros((B, 4), np.float32)
    x0[:, :2] = r.uniform(3.0, 6.0, (B, 2))
    if name in ("bicycle", "unicycle", "dubins"):
        x0[:, 2] = r.uniform(-np.pi, np.pi, B)
    elif name == "double_integrator":
        x0[:, 2] = r.uniform(-1.0, 1.0, B)
    if name in ("bicycle", "double_integrator"):
        x0[:, 3] = r.uniform(0.0, 1.0, B)
    controls = (lo + (hi - lo) * r.uniform(0.05, 0.95, (B, width, 3))).astype(np.float32)
    controls[..., 2] = r.uniform(0.1, 0.4, (B, width)).astype(np.float32)
    mask = np.arange(width)[None] < np.asarray(EDGES)[:, None]
    goal = np.tile(np.asarray(DEMO.goal[:2], np.float32), (B, 1))
    return system, x0, controls, mask, goal


def _boxes(per_problem: bool, B: int, seed: int):
    if not per_problem:
        return DEMO.padded_obstacles(8)[0]
    r = np.random.default_rng(seed)
    c = r.uniform(2.0, 18.0, (B, 8, 2))
    h = r.uniform(0.3, 2.0, (B, 8, 2))
    return np.concatenate([c - h, c + h], -1).astype(np.float32)


def _core(system, x0, c, mask, goal, obs, rcfg=FEW):
    return tr._refine_core(system, CFG, rcfg, torch.tensor(x0), torch.tensor(goal),
                           torch.tensor(obs), torch.tensor(c), torch.tensor(mask))


def _bits(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a, np.float32)).tobytes()


@pytest.mark.parametrize("per_problem", [False, True], ids=["shared", "per_problem"])
@pytest.mark.parametrize("name", SYSTEMS)
def test_each_row_equals_its_own_unpadded_run(name, per_problem, elementwise):
    system, x0, c, mask, goal = _batch(name, 1, 14)
    obs = _boxes(per_problem, len(EDGES), 2)
    refined, losses = _core(system, x0, c, mask, goal, obs)
    for b, n in enumerate(EDGES):
        width = max(n, 1)  # an unsolved row: one masked edge
        own = _core(system, x0[b:b + 1], c[b:b + 1, :width].copy(), mask[b:b + 1, :width],
                    goal[b:b + 1], obs[b:b + 1] if per_problem else obs)
        assert _bits(losses[:, b]) == _bits(own[1][:, 0]), (name, n)
        assert _bits(refined[b, :width]) == _bits(own[0][0]), (name, n)
        assert _bits(refined[b, width:]) == _bits(c[b, width:])  # padding: controls0
    # an unsolved row scores the goal term at x0, the same every step
    assert len(set(losses[:, 0].tolist())) == 1 and float(losses[0, 0]) > 0
    # on the CPU the whole refinement's entry is the loop around the twin
    again = tr._refine_core(system, CFG, FEW, torch.tensor(x0), torch.tensor(goal),
                            torch.tensor(obs), torch.tensor(c), torch.tensor(mask),
                            penalty=rf.refine_penalty_torch)
    assert _bits(again[0]) == _bits(refined) and _bits(again[1]) == _bits(losses)


def test_bias_tables_are_the_loops():
    """The tables the kernel takes are the step path's: 1 - 0.9^t and
    1 - 0.999^t by torch's f32 pow, t = 1 to n (within 2 ulp of 1 of the
    exact values)."""
    for n in (0, 1, 3, 400):
        b1, b2 = rf.bias_tables(n, "cpu")
        steps = torch.arange(1, n + 1, dtype=torch.float32)
        assert _bits(b1) == _bits(1 - torch.full_like(steps, 0.9) ** steps)
        assert _bits(b2) == _bits(1 - torch.full_like(steps, 0.999) ** steps)
        t = np.arange(1, n + 1)
        for got, base in ((b1, 0.9), (b2, 0.999)):
            np.testing.assert_allclose(got.numpy(), 1 - np.float32(base) ** t.astype(np.float64),
                                       rtol=0, atol=2.4e-7)


def _untrimmed_refine_batch(system, paths, lengths, goals, obstacles, rcfg):
    """refine_batch without its cut: every padded edge refined and replayed."""
    S = system.state_dim
    Lmax = paths.shape[1]
    x0s = torch.tensor(paths[:, 0, :S])
    controls0 = torch.tensor(np.ascontiguousarray(paths[:, 1:, S:]))
    goal_xys = torch.tensor(goals[:, :2])
    masks = torch.tensor(np.arange(Lmax - 1)[None, :] < (lengths[:, None] - 1))
    shared = torch.tensor(obstacles)
    refined, losses = tr._refine_core(system, CFG, rcfg, x0s, goal_xys, shared, controls0,
                                      masks)
    per_problem = shared.expand(len(paths), *obstacles.shape).contiguous()
    states, ok, in_goal = tr._revalidate(system, CFG, x0s, goal_xys, per_problem, refined,
                                         masks)
    return refined, losses, states, ok, in_goal


def _paths(name: str):
    """refine_batch's inputs for rows of EDGES real edges padded to 20, the
    first unsolved (no path), the demo's boxes."""
    system, x0, c, mask, goal = _batch(name, 3, 20)
    S = system.state_dim
    lengths = np.asarray(EDGES) + 1
    lengths[0] = 0  # an unsolved row: no path
    paths = np.zeros((len(EDGES), 21, S + 3), np.float32)
    paths[:, 0, :S] = x0
    paths[:, 1:, S:] = c
    goals = np.concatenate([goal, np.zeros((len(EDGES), 2), np.float32)], -1)
    return system, x0, goal, paths, lengths, goals, np.asarray(DEMO.obstacles, np.float32)


@pytest.mark.parametrize("name", ["bicycle", "double_integrator"])
def test_trimmed_refine_batch_equals_the_untrimmed_run(name, elementwise):
    system, x0, goal, paths, lengths, goals, obs = _paths(name)
    out = tr.refine_batch(system, CFG, paths, lengths, goals, obs, FEW, device="cpu")
    refined, losses, states, ok, in_goal = _untrimmed_refine_batch(
        system, paths, lengths, goals, obs, FEW)
    assert _bits(out["controls"]) == _bits(refined)
    assert _bits(out["losses"]) == _bits(losses.T)
    valid = (ok & in_goal).numpy() & (lengths >= 2)
    assert np.array_equal(out["valid"], valid)
    n = int(lengths.max()) - 1
    masks = torch.tensor(np.arange(20)[None, :] < (lengths[:, None] - 1))
    per_problem = torch.tensor(np.broadcast_to(obs, (len(EDGES), *obs.shape)).copy())
    cut = tr._revalidate(system, CFG, torch.tensor(x0), torch.tensor(goal), per_problem,
                         refined, masks, edges=n)
    assert _bits(cut[0]) == _bits(states)
    assert torch.equal(cut[1], ok) and torch.equal(cut[2], in_goal)


@pytest.mark.parametrize("name", ["bicycle", "double_integrator"])
def test_trimmed_refine_batch_is_close_to_the_untrimmed_run_on_plain_torch(name):
    """Without ``elementwise``: torch's CPU sigmoid and log round a cut row
    as they like, so the trimmed run is held to the untrimmed one within
    tests/test_torch_refine.py's tolerances against JAX (controls 1e-5, the
    first two losses rtol 1e-5), with the same verdicts."""
    system, x0, goal, paths, lengths, goals, obs = _paths(name)
    out = tr.refine_batch(system, CFG, paths, lengths, goals, obs, FEW, device="cpu")
    refined, losses, _, ok, in_goal = _untrimmed_refine_batch(
        system, paths, lengths, goals, obs, FEW)
    np.testing.assert_allclose(out["controls"], refined.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out["losses"][:, :2], losses.T.numpy()[:, :2], rtol=1e-5)
    assert np.array_equal(out["valid"], (ok & in_goal).numpy() & (lengths >= 2))
