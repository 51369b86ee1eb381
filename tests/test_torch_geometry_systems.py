"""cudasbmp_torch geometry and bicycle dynamics against the JAX package:
the truth tables of tests/test_geometry.py on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudasbmp_torch.geometry import aabb as taabb
from cudasbmp_torch.geometry.grid import RegionGrid as TGrid
from cudasbmp_torch.systems import get_system
from cudasbmp_torch.systems.bicycle import KinematicBicycle as TBike
from cudasbmp_tpu.geometry import aabb as jaabb
from cudasbmp_tpu.geometry.grid import RegionGrid as JGrid
from cudasbmp_tpu.systems.bicycle import KinematicBicycle as JBike

torch.set_num_threads(2)
OBS = np.array([[2.0, 2.0, 4.0, 4.0], [7.0, 2.0, 9.0, 5.0],
                [1.0, 1.0, 0.0, 0.0]], np.float32)  # last row: padding


def _t(a):
    return torch.tensor(np.asarray(a))


def test_segment_clear_matches_jax():
    rng = np.random.default_rng(0)
    p0 = rng.uniform(0, 10, size=(4000, 2)).astype(np.float32)
    p1 = (p0 + rng.uniform(-1, 1, size=(4000, 2))).astype(np.float32)
    # snap some endpoints onto obstacle edges: touching must stay clear
    p1[:200] = np.round(p1[:200])
    want = np.asarray(jaabb.segments_clear_batch(jnp.asarray(p0), jnp.asarray(p1),
                                                 jnp.asarray(OBS)))
    got = taabb.segments_clear_batch(_t(p0), _t(p1), _t(OBS)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < len(want)


def test_touching_and_degenerate_boxes():
    obs = _t([[2.0, 2.0, 4.0, 4.0]])
    assert bool(taabb.segments_clear_batch(_t([[1.0, 1.0]]), _t([[2.0, 2.0]]), obs)[0])
    pad = _t([[1.0, 1.0, 0.0, 0.0]])
    assert bool(taabb.segments_clear_batch(_t([[0.0, 0.0]]), _t([[5.0, 5.0]]), pad)[0])
    lo, hi = taabb.segment_aabb(_t([3.0, 1.0]), _t([2.0, 4.0]))
    assert lo.tolist() == [2.0, 1.0] and hi.tolist() == [3.0, 4.0]


@pytest.mark.parametrize("width,height,N,n", [(20.0, 20.0, 16, 8),
                                              (10.0, 30.0, 16, 8),
                                              (20.0, 20.0, 4, 2)])
def test_region_indices_match_jax(width, height, N, n):
    rng = np.random.default_rng(1)
    pts = rng.uniform(-2.5, max(width, height) + 2.5, size=(20000, 2)).astype(np.float32)
    # exact cell edges, the far edge, negatives inside (-cell, 0)
    edges = np.arange(-2, 2 * N + 2) * (width / N) / 2
    pts[:len(edges), 0] = edges
    pts[len(edges):2 * len(edges), 1] = edges
    jg, tg = JGrid(width, height, N, n), TGrid(width, height, N, n)
    jr1, jr2 = jg.region_indices(jnp.asarray(pts))
    tr1, tr2 = tg.region_indices(_t(pts))
    assert tr1.dtype == torch.int32 and tr2.dtype == torch.int32
    np.testing.assert_array_equal(tr1.numpy(), np.asarray(jr1))
    np.testing.assert_array_equal(tr2.numpy(), np.asarray(jr2))
    assert (tr1.numpy() == -1).any() and (tr2.numpy() >= 0).any()


def test_r2_index_at_r1_minus_one_floors():
    """r1 = -1: floor // and % give cell (-1, N-1); the lane masks to -1."""
    tg, jg = TGrid(20.0, 20.0, 16, 8), JGrid(20.0, 20.0, 16, 8)
    r1 = torch.tensor([-1, -1, 0, 255], dtype=torch.int32)
    assert (r1 // 16).tolist() == [-1, -1, 0, 15]
    assert (r1 % 16).tolist() == [15, 15, 0, 15]
    x = torch.tensor([19.0, 0.5, 0.1, 19.9])
    y = torch.tensor([-0.5, 0.5, 0.1, 19.9])
    want = jg.r2_index(jnp.asarray(x.numpy()), jnp.asarray(y.numpy()),
                       jnp.asarray(r1.numpy()))
    np.testing.assert_array_equal(tg.r2_index(x, y, r1).numpy(), np.asarray(want))
    assert tg.r2_index(x, y, r1).tolist()[:2] == [-1, -1]


def test_region_grid_boundaries():
    g = TGrid(20.0, 20.0, 16, 8)
    f = lambda x, y: int(g.r1_index(torch.tensor(x), torch.tensor(y)))
    assert f(20.0, 1.0) == -1
    assert f(0.0, 0.0) == 0
    assert f(-0.5, 1.0) == 0  # truncation toward zero, like static_cast<int>
    assert f(-5.0, 1.0) == -1


def test_bicycle_step_and_soa_match_jax():
    rng = np.random.default_rng(2)
    B = 8192
    state = np.stack([rng.uniform(0, 20, B), rng.uniform(0, 20, B),
                      rng.uniform(-30, 30, B), rng.uniform(-10, 10, B)], -1
                     ).astype(np.float32)
    ctrl = np.stack([rng.uniform(-5, 5, B), rng.uniform(-np.pi, np.pi, B)], -1
                    ).astype(np.float32)
    dt = rng.uniform(0.005, 0.105, B).astype(np.float32)
    for L in (1.0, 2.5):
        want = np.asarray(JBike(agent_length=L).step(jnp.asarray(state),
                                                     jnp.asarray(ctrl),
                                                     jnp.asarray(dt)))
        tb = TBike(agent_length=L)
        got = tb.step(_t(state), _t(ctrl), _t(dt)).numpy()
        # trig differs by <= 1 ulp between XLA:CPU (libm) and torch (SLEEF)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got[:, 3], want[:, 3])  # v: no trig
        soa = tb.soa_step(list(_t(state).unbind(-1)),
                          tb.soa_prepare(list(_t(ctrl).unbind(-1))), _t(dt))
        np.testing.assert_array_equal(torch.stack(soa, -1).numpy(), got)


def test_registry():
    assert isinstance(get_system("car"), TBike)
    assert get_system("bicycle", agent_length=2.0).agent_length == 2.0
    with pytest.raises(KeyError, match="unknown"):
        get_system("hovercraft")
