"""The plain twins of kernel B6 (``rollout_soa`` and
``sample_and_rollout_torch`` given one obstacle set per problem, as the B6
wrappers call them on the CPU): one obstacle set per problem, against the JAX package's ``rollout_batch`` under ``jax.vmap`` over
the problems (what the arena's vmapped kernel computes,
cudasbmp_tpu/parallel/batch_kgmt.py:238-242), and against the single-problem
twin problem by problem.

Tolerance against JAX: states within 1e-3, masks equal except on lanes
whose path passes within 1e-3 of a bound or an obstacle edge (glibc and
SLEEF trig differ by an ulp; see tests/test_torch_rollout_soa.py). Against
the port's own single-problem twin: bitwise. The kernel itself runs only on
the card (tests/test_torch_cuda.py, marked ``cuda``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudasbmp_torch import rng
from cudasbmp_torch.ops import rollout_cuda as rc
from cudasbmp_torch.ops.rollout import rollout_batch
from cudasbmp_torch.systems import get_system
from cudasbmp_tpu.ops.rollout import rollout_batch as j_rollout_batch
from cudasbmp_tpu.systems import get_system as j_get_system
from test_torch_rollout_soa import EDGE, FP, KW, NAMES, batch, edge_margin

torch.set_num_threads(2)
B, R, K = 6, 256, 8


def problem_boxes(seed: int) -> np.ndarray:
    """[B, K, 4]: a distinct random box field per problem, two padding rows
    each (min 1, max 0)."""
    r = np.random.default_rng(seed)
    lo = r.uniform(0.0, 17.0, (B, K, 2))
    boxes = np.concatenate([lo, lo + r.uniform(0.5, 3.0, (B, K, 2))], -1)
    boxes[:, -2:] = (1.0, 1.0, 0.0, 0.0)
    return boxes.astype(np.float32)


def lanes(name: str, seed: int) -> tuple[np.ndarray, np.ndarray]:
    x0, c = batch(name, B * R, seed)
    return x0.reshape(B, R, 4), c.reshape(B, R, -1)


@pytest.mark.parametrize("footprint", [None, FP], ids=["broad", "footprint"])
@pytest.mark.parametrize("name", ["bicycle", "unicycle", "point2d"])
def test_batched_twin_matches_vmapped_jax_rollout(name, footprint):
    x0, c = lanes(name, 40 + NAMES.index(name))
    obs = problem_boxes(NAMES.index(name))
    want_x1, want_v = jax.vmap(
        lambda x, cc, o: j_rollout_batch(j_get_system(name), x, cc, KW["num_disc"], o,
                                         KW["width"], KW["height"], footprint=footprint)
    )(jnp.asarray(x0), jnp.asarray(c), jnp.asarray(obs))
    want_x1, want_v = np.asarray(want_x1), np.asarray(want_v)
    system = get_system(name)
    x1, v = rc.rollout_batched_cuda(system, torch.tensor(x0), torch.tensor(c),
                                    torch.tensor(obs), **KW, footprint=footprint)
    x1, v = x1.numpy(), v.numpy()
    assert x1.shape == (B, R, 4) and v.shape == (B, R)
    for b in range(B):
        mis = v[b] != want_v[b]
        if mis.any():
            m = edge_margin(system, torch.tensor(x0[b][mis]), torch.tensor(c[b][mis]),
                            torch.tensor(obs[b]), footprint)
            assert (m <= EDGE).all(), f"problem {b}: margins {m.max():.3g}"
        assert mis.mean() < 0.02
        np.testing.assert_allclose(x1[b][~mis], want_x1[b][~mis], atol=EDGE, rtol=0)
    assert 0.05 < v.mean() < 0.98


@pytest.mark.parametrize("fast_math", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("footprint", [None, FP], ids=["broad", "footprint"])
@pytest.mark.parametrize("name", NAMES)
def test_batched_twin_rows_equal_the_single_problem_twin(name, footprint, fast_math):
    system = get_system(name)
    x0, c = (torch.tensor(a) for a in lanes(name, 50))
    obs = torch.tensor(problem_boxes(7))
    x1, v = rc.rollout_soa(system, x0, c, obs, **KW, footprint=footprint,
                           fast_math=fast_math)
    for b in range(B):
        bx1, bv = rc.rollout_soa(system, x0[b], c[b], obs[b], **KW,
                                 footprint=footprint, fast_math=fast_math)
        assert torch.equal(v[b], bv) and torch.equal(x1[b], bx1)
    if not fast_math:  # the exact twin is the plain rollout, batched or not
        px1, pv = rollout_batch(system, x0, c, KW["num_disc"], obs[:, None],
                                KW["width"], KW["height"], footprint=footprint)
        assert torch.equal(v, pv) and torch.equal(x1, px1)


def test_a_wall_in_one_problem_changes_only_that_problem():
    system = get_system("bicycle")
    x0, c = (torch.tensor(a) for a in lanes("bicycle", 60))
    obs = torch.tensor(problem_boxes(3))
    x1, v = rc.rollout_batched_cuda(system, x0, c, obs, **KW)
    walled = obs.clone()
    walled[1, -1] = torch.tensor([0.0, 9.0, 20.0, 11.0])  # a full-width wall
    wx1, wv = rc.rollout_batched_cuda(system, x0, c, walled, **KW)
    others = [b for b in range(B) if b != 1]
    assert torch.equal(wv[others], v[others]) and torch.equal(wx1[others], x1[others])
    assert (wv[1] != v[1]).any() and not (wv[1] & ~v[1]).any()


def test_philox_form_draws_per_problem_streams():
    """Problem b's controls depend only on its key and lane: the same key
    gives the same rows at another batch size and in another slot."""
    system = get_system("bicycle")
    x0, _ = (torch.tensor(a) for a in lanes("bicycle", 70))
    obs = torch.tensor(problem_boxes(4))
    keys = rng.split(rng.key(8), B)
    x1, c, v = rc.sample_and_rollout_batched_cuda(system, keys, x0, obs, **KW)
    lo, hi = torch.tensor(system.control_spec.lo), torch.tensor(system.control_spec.hi)
    assert ((c >= lo) & (c <= hi)).all()
    bx1, bv = rc.rollout_soa(system, x0, c, obs, **KW)
    assert torch.equal(v, bv) and torch.equal(x1, bx1)
    # problem 2 alone, as the only problem of a batch of 1 and in slot 0
    y1, c2, v2 = rc.sample_and_rollout_batched_cuda(system, keys[2:3], x0[2:3],
                                                    obs[2:3], **KW)
    assert torch.equal(c2[0], c[2]) and torch.equal(v2[0], v[2])
    assert torch.equal(y1[0], x1[2])
    # one problem's draws equal the single-problem B2 twin under its key
    _, c3, _ = rc.sample_and_rollout_cuda(system, keys[4], x0[4], obs[4], **KW)
    assert torch.equal(c3, c[4])
    assert not torch.equal(c[0], c[1])


def test_batched_launch_arguments_are_checked_on_the_host():
    """What the wrappers refuse before a launch is decided on the host: B6
    takes lanes [B, R, 4] and one obstacle set per problem [B, K, 4], B1
    lanes [B, 4] and one shared set [K, 4]; the twin path refuses the same
    mix-ups."""
    system = get_system("bicycle")
    x0, c = (torch.tensor(a) for a in lanes("bicycle", 80))
    obs = torch.tensor(problem_boxes(5))
    with pytest.raises(ValueError, match="obstacles"):
        rc._kernel_args(system, x0, obs[0], None, False, True)  # a shared set
    with pytest.raises(ValueError, match=r"\[B, R, state_dim\]"):
        rc._kernel_args(system, x0.reshape(-1, 4), obs, None, False, True)
    with pytest.raises(ValueError, match="obstacles"):
        rc._kernel_args(system, x0[0], obs, None, False, False)  # per-problem sets
    with pytest.raises(ValueError, match="obstacles"):
        rc.rollout_batched_cuda(system, x0, c, obs[0], **KW)
    with pytest.raises(ValueError, match="keys"):
        rc.sample_and_rollout_batched_cuda(system, rng.key(1), x0, obs, **KW)
