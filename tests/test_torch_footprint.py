"""The oriented-footprint narrow phase (kernel branch B3's plain version):
the truth tables of tests/test_footprint.py on the port's footprint_clear,
the port against cudasbmp_tpu/geometry/footprint.py on the same inputs, and
rollouts with a footprint against the JAX rollout. (The twin against the
TPU kernel in interpret mode: tests/test_torch_footprint_kernel.py.)"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudasbmp_torch.config import Scenario
from cudasbmp_torch.geometry.footprint import footprint_clear, footprint_corners
from cudasbmp_torch.ops.rollout import rollout_batch
from cudasbmp_torch.ops.rollout_cuda import rollout_soa
from cudasbmp_torch.systems import get_system
from cudasbmp_tpu.geometry import footprint as jfp
from cudasbmp_tpu.ops.rollout import rollout_batch as j_rollout
from cudasbmp_tpu.systems import get_system as j_get_system
from test_torch_rollout_soa import batch

torch.set_num_threads(2)
KW = dict(num_disc=10, width=20.0, height=20.0)
OBS = Scenario.demo().padded_obstacles(32)[0]  # 5 boxes + 3 padding rows


def clear1(x, y, theta, hl, hw, boxes) -> bool:
    return bool(footprint_clear(torch.tensor([x], dtype=torch.float32),
                                torch.tensor([y], dtype=torch.float32),
                                torch.tensor([theta], dtype=torch.float32),
                                hl, hw, torch.tensor(boxes, dtype=torch.float32))[0])


def test_axis_aligned_reduces_to_aabb():
    hl, hw = 0.5, 0.25  # body 1.0 x 0.5
    box = [[2.0, 2.0, 3.0, 3.0]]
    assert clear1(0.5, 2.5, 0.0, hl, hw, box)
    assert not clear1(1.5, 2.5, 0.0, hl, hw, box)
    assert not clear1(2.5, 1.9, 0.0, hl, hw, box)
    assert clear1(2.5, 1.7, 0.0, hl, hw, box)
    assert clear1(1.0, 2.5, 0.0, hl, hw, box)  # touching does not collide
    assert clear1(2.5, 1.75, 0.0, hl, hw, box)


def test_rotated_quarter_turn():
    hl, hw = 0.5, 0.25
    box = [[2.0, 2.0, 3.0, 3.0]]
    assert not clear1(2.5, 1.5, math.pi / 2, hl, hw, box)
    assert clear1(2.5, 0.5, math.pi / 2, hl, hw, box)
    assert clear1(1.5, 2.5, math.pi / 2, hl, hw, box)


def test_diagonal_narrow_phase_beats_broad_phase():
    hl, hw, theta = 1.0, 0.05, math.pi / 4
    assert clear1(0.0, 0.0, theta, hl, hw, [[1.0, 0.0, 1.4, 0.4]])
    assert not clear1(0.0, 0.0, theta, hl, hw, [[0.6, 0.6, 1.0, 1.0]])


def test_zero_thickness_wall_still_hits():
    wall = [[3.0, 1.0, 3.0, 5.0]]
    assert not clear1(2.6, 3.0, 0.0, 0.5, 0.25, wall)
    assert clear1(1.0, 3.0, 0.0, 0.5, 0.25, wall)
    assert not clear1(3.2, 2.0, math.pi, 0.5, 0.25, wall)


def test_degenerate_padding_boxes_never_hit():
    pad = np.zeros((4, 4), np.float32)
    pad[:, 0:2] = 1.0  # min 1, max 0 (Scenario.padded_obstacles)
    for theta in (0.0, 0.3, 2.0):
        assert clear1(0.5, 0.5, theta, 5.0, 5.0, pad)


def test_footprint_clear_and_corners_match_jax():
    """20k random poses against the demo boxes, a wall and padding rows:
    equal verdicts on every pose, corners within trig ulps."""
    r = np.random.default_rng(0)
    n = 20000
    x = r.uniform(0, 20, n).astype(np.float32)
    y = r.uniform(0, 20, n).astype(np.float32)
    th = r.uniform(-4, 4, n).astype(np.float32)
    boxes = np.concatenate([OBS, [[10.0, 12.0, 10.0, 16.0]]]).astype(np.float32)
    with jax.disable_jit():
        want = jfp.footprint_clear(jnp.asarray(x), jnp.asarray(y), jnp.asarray(th),
                                   0.5, 0.25, jnp.asarray(boxes))
        wc = jfp.footprint_corners(jnp.asarray(x), jnp.asarray(y), jnp.asarray(th),
                                   0.5, 0.25)
    got = footprint_clear(torch.tensor(x), torch.tensor(y), torch.tensor(th), 0.5,
                          0.25, torch.tensor(boxes))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0.05 < 1 - got.float().mean() < 0.5  # both verdicts occur
    gc = footprint_corners(torch.tensor(x), torch.tensor(y), torch.tensor(th), 0.5, 0.25)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), atol=1e-5, rtol=1e-5)


def test_rollout_footprint_blocks_side_passage():
    """A point path clear of the broad phase whose axis-aligned body (point2d
    has no heading) clips the box beside it."""
    system = get_system("point2d")
    x0 = torch.tensor([[2.0, 1.0, 0.0, 0.0]])
    controls = torch.tensor([[2.0, 0.0, 1.0]])
    obstacles = torch.tensor([[2.5, 1.3, 3.5, 3.0]])
    _, valid_point = rollout_batch(system, x0, controls, 10, obstacles, 20.0, 20.0)
    assert bool(valid_point[0])
    _, valid_body = rollout_batch(system, x0, controls, 10, obstacles, 20.0, 20.0,
                                  footprint=(0.5, 0.5))
    assert not bool(valid_body[0])
    for fast in (False, True):
        _, v = rollout_soa(system, x0, controls, obstacles, **KW,
                           footprint=(0.5, 0.5), fast_math=fast)
        assert not bool(v[0])


@pytest.mark.parametrize("name", ["bicycle", "point2d", "double_integrator",
                                  "unicycle", "dubins"])
def test_rollout_with_footprint_matches_jax_rollout_batch(name):
    """rollout_batch(footprint) against the JAX function, op by op: equal
    masks, states within trig ulps; and the kernel's plain twin (exact
    path) equals rollout_batch to the bit."""
    x0, c = batch(name, 512, 3)
    fp = (0.5, 0.25)
    with jax.disable_jit():
        jx1, jv = j_rollout(j_get_system(name), jnp.asarray(x0), jnp.asarray(c), 10,
                            jnp.asarray(OBS), 20.0, 20.0, footprint=fp)
    sys_ = get_system(name)
    x1, v = rollout_batch(sys_, torch.tensor(x0), torch.tensor(c), 10,
                          torch.tensor(OBS), 20.0, 20.0, footprint=fp)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_allclose(x1.numpy(), np.asarray(jx1), atol=1e-3, rtol=1e-5)
    _, v_broad = rollout_batch(sys_, torch.tensor(x0), torch.tensor(c), 10,
                               torch.tensor(OBS), 20.0, 20.0)
    assert int(v_broad.sum()) > int(v.sum())  # the body rejects more
    sx1, sv = rollout_soa(sys_, torch.tensor(x0), torch.tensor(c), torch.tensor(OBS),
                          **KW, footprint=fp)
    assert torch.equal(sv, v) and torch.equal(sx1, x1)
