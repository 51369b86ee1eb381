"""Trajectory refinement (cudasbmp_torch/refine.py, the plain twin of kernel
R1 in ops/refine_cuda.py) on the CPU against the JAX package's refine.py.

- ``_loss`` value and gradient against ``jax.value_and_grad`` of the JAX
  ``_loss`` run op by op, for every system, on 5 edges of 10 steps with the
  last edge masked (a padded problem): the unrolled positions equal op-by-op
  JAX's bit for bit on the same controls; the loss within rtol 1e-5 and the
  gradient within 1e-4 of its norm (the two sigmoids differ in the last bit
  on some inputs, and the sums run in other orders);
- a padded problem's objective is the unpadded one's, to the bit: padded
  edges add exact zeros in ``row_sum``'s order;
- ``_refine_core`` at 2 Adam steps on a 3-edge path against the op-by-op
  JAX core: losses within rtol 1e-5, refined controls within 1e-6;
- ``refine_path`` and ``refine_batch`` at 3 Adam steps against the jitted
  JAX functions (the op-by-op JAX scan of value_and_grad takes tens of
  seconds for 3 steps of a 12-edge path): controls within 1e-5, the same verdicts,
  the first two losses within rtol 1e-5. Jitted XLA contracts FMAs, and
  Adam scales each gradient component to about the learning rate whatever
  its size, so a near-zero component whose sign an ulp flips moves its raw
  entry by 2e-3: the third loss of jitted JAX already differs from op-by-op
  JAX's by 7e-5 of itself on this path, while the port's is op-by-op JAX's
  to 1e-6. Longer runs part ways (the chained Euler gradients are chaotic)
  and are held on the card by chip_smoke.py [28];
- a batch row equals ``refine_path`` on its path within rtol 1e-4 (as
  tests/test_refine.py holds the JAX pair); unsolved rows are skipped; a
  path without an edge raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cudasbmp_torch as ct
import cudasbmp_tpu as jt
from cudasbmp_torch import refine as tr
from cudasbmp_torch.systems.registry import get_system as tget
from cudasbmp_tpu import refine as jr
from cudasbmp_tpu.systems.registry import get_system as jget

torch.set_num_threads(2)
SMALL = dict(num_iterations=100, max_tree_size=16384, rollouts_per_iter=2048)
CFG, JCFG = ct.KGMTConfig(**SMALL), jt.KGMTConfig(**SMALL)
DEMO = ct.Scenario.demo()
OBSTACLES = DEMO.padded_obstacles(8)[0]
SYSTEMS = ("bicycle", "point2d", "double_integrator", "unicycle", "dubins")
FEW = 3  # Adam steps held element for element


@pytest.fixture(scope="module")
def paths():
    planner = ct.KGMT(CFG, device="cpu")
    return [planner.plan(DEMO, seed=s).path for s in (1, 2, 3)]


def test_refine_config_matches_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(jr.RefineConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tr.RefineConfig)]
    assert jf == tf
    with pytest.raises(dataclasses.FrozenInstanceError):
        tr.RefineConfig().iterations = 1


def _problem(name: str, seed: int):
    r = np.random.default_rng(seed)
    x0 = np.array([3.0, 3.0, 0.3, 0.5], np.float32)
    if name == "point2d":
        x0[2:] = 0.0
    elif name in ("unicycle", "dubins"):
        x0[3] = 0.0
    raw = r.normal(0.0, 1.0, (5, 3)).astype(np.float32)
    mask = np.array([True, True, True, True, False])
    return x0, raw, mask, np.array([5.0, 4.0], np.float32)


def _torch_loss(system, x0, raw, mask, goal):
    lo, hi = system.control_spec.bounds("cpu")
    r = torch.tensor(raw)[None].requires_grad_()
    loss = tr._loss(system, CFG, tr.RefineConfig(), torch.tensor(x0)[None],
                    torch.tensor(goal)[None], torch.tensor(OBSTACLES), r, lo, hi,
                    torch.tensor(mask)[None])
    (g,) = torch.autograd.grad(loss.sum(), r)
    return float(loss[0].detach()), g[0].numpy()


@pytest.mark.parametrize("name", SYSTEMS)
def test_loss_value_and_gradient_match_jax(name):
    js, ts = jget(name), tget(name)
    x0, raw, mask, goal = _problem(name, 0)
    lo = np.asarray(ts.control_spec.lo, np.float32)
    hi = np.asarray(ts.control_spec.hi, np.float32)
    controls = (lo + (hi - lo) * np.random.default_rng(1).uniform(size=(5, 3))).astype(np.float32)
    with jax.disable_jit():
        want_pts = np.asarray(jr._unroll_positions(js, jnp.asarray(x0), jnp.asarray(controls),
                                                   CFG.num_disc))
        want_loss, want_grad = jax.value_and_grad(
            lambda r: jr._loss(js, JCFG, jr.RefineConfig(), jnp.asarray(x0),
                               jnp.asarray(goal), jnp.asarray(OBSTACLES), r,
                               jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(mask)))(
            jnp.asarray(raw))
    pts = tr._unroll_positions(ts, torch.tensor(x0)[None], torch.tensor(controls)[None],
                               CFG.num_disc)[0].numpy()
    np.testing.assert_array_equal(pts, want_pts)
    loss, grad = _torch_loss(ts, x0, raw, mask, goal)
    assert loss == pytest.approx(float(want_loss), rel=1e-5)
    want_grad = np.asarray(want_grad)
    assert np.linalg.norm(grad - want_grad) <= 1e-4 * np.linalg.norm(want_grad)
    assert not grad[~mask].any()  # the padded edge's raw entries are fixed


@pytest.mark.parametrize("name", ["bicycle", "double_integrator"])
def test_padded_objective_is_the_unpadded_one(name):
    ts = tget(name)
    x0, raw, mask, goal = _problem(name, 2)
    loss, grad = _torch_loss(ts, x0, raw, mask, goal)
    short, short_grad = _torch_loss(ts, x0, raw[:4], mask[:4], goal)
    assert loss == short
    np.testing.assert_allclose(grad[:4], short_grad, rtol=1e-6, atol=0)


def _assert_close_to_jax(got: dict, want: dict, keys) -> None:
    for k in keys:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(got["losses"][..., :2],
                               np.asarray(want["losses"])[..., :2], rtol=1e-5)


def test_refine_core_matches_op_by_op_jax(paths):
    path = paths[1][:4]  # 3 edges
    x0, c0 = path[0, :4], path[1:, 4:]
    goal, rcfg = DEMO.goal[:2], tr.RefineConfig(iterations=2)
    with jax.disable_jit():
        want, want_losses = jr._refine_core(
            jget("bicycle"), JCFG, jr.RefineConfig(iterations=2), jnp.asarray(x0),
            jnp.asarray(goal), jnp.asarray(DEMO.obstacles), jnp.asarray(c0),
            jnp.ones(3, bool))
    got, losses = tr._refine_core(tget("bicycle"), CFG, rcfg, torch.tensor(x0)[None],
                                  torch.tensor(goal)[None], torch.tensor(DEMO.obstacles),
                                  torch.tensor(c0)[None], torch.ones((1, 3), dtype=torch.bool))
    np.testing.assert_allclose(losses[:, 0].numpy(), np.asarray(want_losses), rtol=1e-5)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_refine_path_matches_jax(paths):
    path = paths[0]
    got = tr.refine_path(tget("bicycle"), CFG, path, DEMO.goal, DEMO.obstacles,
                         tr.RefineConfig(iterations=FEW), device="cpu")
    want = jr.refine_path(jget("bicycle"), JCFG, path, DEMO.goal, DEMO.obstacles,
                          jr.RefineConfig(iterations=FEW))
    assert got["controls"].shape == (len(path) - 1, 3)
    assert got["states"].shape == (len(path), 4) and got["losses"].shape == (FEW,)
    _assert_close_to_jax(got, want, ("controls", "cost_before", "cost_after"))
    # the exact checker's states: op-by-op JAX's replay of the same controls
    # (jitted JAX contracts the rollout's FMAs: 5e-4 of a state over 12 edges)
    with jax.disable_jit():
        states, _, _ = jr._revalidate_jit(
            jget("bicycle"), JCFG, jnp.asarray(path[None, 0, :4]),
            jnp.asarray(DEMO.goal[None, :2]), jnp.asarray(DEMO.obstacles[None]),
            jnp.asarray(got["controls"][None]), jnp.ones((1, len(path) - 1), bool))
    np.testing.assert_allclose(got["states"][1:], np.asarray(states[0]), rtol=1e-6,
                               atol=1e-5)
    assert got["valid"] == bool(want["valid"])
    # the first loss is the input's: its time and penalties
    assert got["losses"][0] >= got["cost_before"] - 1e-4


def _batch(paths, extra: int = 2):
    B = len(paths) + 1
    Lmax = max(len(p) for p in paths) + extra
    out = np.zeros((B, Lmax, 7), np.float32)
    lengths = np.zeros(B, np.int64)
    for i, p in enumerate(paths):
        out[i, :len(p)] = p
        lengths[i] = len(p)
    out[-1, 0, :2] = [5.0, 5.0]  # an unsolved row: one node
    lengths[-1] = 1
    return out, lengths, np.tile(DEMO.goal, (B, 1)).astype(np.float32)


def test_refine_batch_matches_jax_and_its_rows_refine_path(paths):
    batch, lengths, goals = _batch(paths)
    rcfg = tr.RefineConfig(iterations=FEW)
    got = tr.refine_batch(tget("bicycle"), CFG, batch, lengths, goals, OBSTACLES, rcfg,
                          device="cpu")
    want = jr.refine_batch(jget("bicycle"), JCFG, batch, lengths, goals, OBSTACLES,
                           jr.RefineConfig(iterations=FEW))
    assert set(got) == set(want)
    for k in got:
        assert got[k].shape == np.asarray(want[k]).shape, k
    _assert_close_to_jax(got, want, ("controls", "cost_before", "cost_after"))
    np.testing.assert_array_equal(got["valid"], np.asarray(want["valid"]))
    np.testing.assert_array_equal(got["improved"], np.asarray(want["improved"]))
    # the unsolved row: skipped, its controls untouched
    assert not got["valid"][-1] and not got["improved"][-1]
    np.testing.assert_array_equal(got["controls"][-1], batch[-1, 1:, 4:])
    for i, p in enumerate(paths):
        one = tr.refine_path(tget("bicycle"), CFG, p, DEMO.goal, OBSTACLES, rcfg,
                             device="cpu")
        n = len(p) - 1
        np.testing.assert_allclose(got["controls"][i, :n], one["controls"], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(got["losses"][i], one["losses"], rtol=1e-4)
        assert got["valid"][i] == one["valid"]


def test_refine_batch_takes_per_problem_boxes(paths):
    """[B, K, 4] gives what the shared [K, 4] gives when the sets are the
    same."""
    batch, lengths, goals = _batch(paths[:2], extra=0)
    rcfg = tr.RefineConfig(iterations=2)
    shared = tr.refine_batch(tget("bicycle"), CFG, batch, lengths, goals, OBSTACLES, rcfg,
                             device="cpu")
    stacked = tr.refine_batch(tget("bicycle"), CFG, batch, lengths, goals,
                              np.stack([OBSTACLES] * 3), rcfg, device="cpu")
    for k in shared:
        np.testing.assert_array_equal(shared[k], stacked[k], err_msg=k)


def test_too_short_paths_raise_and_the_card_is_the_default():
    with pytest.raises(ValueError, match="at least one edge"):
        tr.refine_path(tget("bicycle"), CFG, np.zeros((1, 7), np.float32), DEMO.goal,
                       DEMO.obstacles, device="cpu")
    with pytest.raises(ValueError, match="at least one edge"):
        tr.refine_batch(tget("bicycle"), CFG, np.zeros((2, 1, 7), np.float32),
                        np.array([1, 1]), np.zeros((2, 7), np.float32), OBSTACLES,
                        device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            tr.refine_path(tget("bicycle"), CFG, np.zeros((3, 7), np.float32), DEMO.goal,
                           DEMO.obstacles)
