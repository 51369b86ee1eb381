"""The plain rollout (kernel B1's plain version), the B2 plain twin and the
wrappers' dispatch rule, against the JAX package on the same inputs.

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
holds them against their plain versions there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudasbmp_torch import rng
from cudasbmp_torch.config import Scenario
from cudasbmp_torch.ops import rollout_cuda as rc
from cudasbmp_torch.ops.rollout import rollout_batch as t_rollout
from cudasbmp_torch.systems.bicycle import KinematicBicycle as TBike
from cudasbmp_tpu.ops.rollout import rollout_batch as j_rollout
from cudasbmp_tpu.ops.rollout_pallas import rollout_pallas
from cudasbmp_tpu.systems.bicycle import KinematicBicycle as JBike

torch.set_num_threads(2)
OBS = Scenario.demo().padded_obstacles(32)[0]  # [8, 4], 3 padding rows
KW = dict(num_disc=10, width=20.0, height=20.0)


def demo_batch(B: int, seed: int = 0):
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
    return x0, ctrl


def _port(x0, ctrl, obs=OBS):
    x1, valid = t_rollout(TBike(), torch.tensor(x0), torch.tensor(ctrl),
                          KW["num_disc"], torch.tensor(obs), KW["width"], KW["height"])
    return x1.numpy(), valid.numpy()


def test_rollout_matches_jax_rollout_batch():
    """2^14 demo lanes. Op by op (jax.disable_jit) the JAX function rounds
    like the port, so masks are equal on every lane and states differ only
    by trig ulps (libm in XLA:CPU, SLEEF in torch). The jitted scan also
    contracts multiply-adds into FMAs and divides by constants with a
    reciprocal; its masks may then differ on lanes that graze an edge."""
    x0, ctrl = demo_batch(2 ** 14)
    x1, valid = _port(x0, ctrl)
    with jax.disable_jit():
        jx1, jvalid = j_rollout(JBike(), jnp.asarray(x0), jnp.asarray(ctrl),
                                KW["num_disc"], jnp.asarray(OBS), KW["width"],
                                KW["height"])
    np.testing.assert_array_equal(valid, np.asarray(jvalid))
    np.testing.assert_allclose(x1, np.asarray(jx1), atol=1e-3, rtol=0)
    assert 0.2 < valid.mean() < 0.95
    jx1, jvalid = jax.jit(j_rollout, static_argnums=(0, 3, 5, 6))(
        JBike(), jnp.asarray(x0), jnp.asarray(ctrl), KW["num_disc"],
        jnp.asarray(OBS), KW["width"], KW["height"])
    assert (valid != np.asarray(jvalid)).mean() < 1e-3
    close = valid == np.asarray(jvalid)
    np.testing.assert_allclose(x1[close & valid], np.asarray(jx1)[close & valid],
                               atol=1e-3, rtol=0)


def test_rollout_matches_interpret_mode_pallas_kernel():
    """B=1024 against the TPU kernel itself, run in interpret mode on the CPU
    as tests/test_pallas.py runs it."""
    x0, ctrl = demo_batch(1024, seed=1)
    x1, valid = _port(x0, ctrl)
    px1, pvalid = rollout_pallas(JBike(), jnp.asarray(x0), jnp.asarray(ctrl),
                                 jnp.asarray(OBS), interpret=True, **KW)
    np.testing.assert_array_equal(valid, np.asarray(pvalid))
    np.testing.assert_allclose(x1, np.asarray(px1), atol=1e-3, rtol=0)


def test_padding_lanes_are_dropped():
    x0, ctrl = demo_batch(1000, seed=2)
    x1, valid = _port(x0, ctrl)
    assert x1.shape == (1000, 4) and valid.shape == (1000,)
    for B in (1, 37, 999):
        x1b, vb = _port(x0[:B], ctrl[:B])
        np.testing.assert_array_equal(x1b, x1[:B])
        np.testing.assert_array_equal(vb, valid[:B])
    # padding obstacle rows change nothing
    x1c, vc = _port(x0, ctrl, Scenario.demo().obstacles)
    np.testing.assert_array_equal(x1c, x1)
    np.testing.assert_array_equal(vc, valid)


def test_wrappers_take_the_plain_version_for_cpu_tensors():
    x0, ctrl = demo_batch(512, seed=3)
    before = (rc.rollout_cuda.launches, rc.sample_and_rollout_cuda.launches)
    x1, valid = rc.rollout_cuda(TBike(), torch.tensor(x0), torch.tensor(ctrl),
                                torch.tensor(OBS), **KW)
    px1, pvalid = _port(x0, ctrl)
    np.testing.assert_array_equal(x1.numpy(), px1)
    np.testing.assert_array_equal(valid.numpy(), pvalid)
    rc.sample_and_rollout_cuda(TBike(), rng.key(0), torch.tensor(x0),
                               torch.tensor(OBS), **KW)
    assert (rc.rollout_cuda.launches, rc.sample_and_rollout_cuda.launches) == before
    with pytest.raises(ValueError, match="device"):
        rc.rollout_cuda(TBike(), torch.tensor(x0, device="meta"),
                        torch.tensor(ctrl, device="meta"),
                        torch.tensor(OBS, device="meta"), **KW)


def _b2(key, B, seed=4):
    x0, _ = demo_batch(B, seed=seed)
    x1, ctrl, valid = rc.sample_and_rollout_cuda(
        TBike(), key, torch.tensor(x0), torch.tensor(OBS), **KW)
    return x0, x1.numpy(), ctrl.numpy(), valid.numpy()


def test_b2_plain_twin_deterministic_and_distinct_streams():
    _, x1a, ca, va = _b2(rng.key(7), 4096)
    _, x1b, cb, vb = _b2(rng.key(7), 4096)
    np.testing.assert_array_equal(ca, cb)
    np.testing.assert_array_equal(x1a, x1b)
    np.testing.assert_array_equal(va, vb)
    _, _, cc, _ = _b2(rng.fold_in(rng.key(7), 1), 4096)
    assert (ca != cc).all(axis=1).mean() > 0.999  # another key, another stream
    assert len(np.unique(ca[:, 0])) > 4000  # distinct streams per lane
    _, _, c_short, _ = _b2(rng.key(7), 100)
    np.testing.assert_array_equal(c_short, ca[:100])  # lane i's draw is fixed


def test_b2_controls_in_range_with_uniform_moments():
    _, _, c, _ = _b2(rng.key(11), 2 ** 15)
    lo = np.array([-5.0, -np.pi, 0.05], np.float32)
    hi = np.array([5.0, np.pi, 1.05], np.float32)
    assert (c >= lo).all() and (c <= hi).all()
    n = len(c)
    u = (c - lo) / (hi - lo)
    # uniform: mean 1/2, variance 1/12; 3-sigma bands of the estimators
    assert np.all(np.abs(u.mean(0) - 0.5) < 3 * np.sqrt(1 / 12 / n))
    assert np.all(np.abs(u.var(0) - 1 / 12) < 3 * np.sqrt(1 / 180 / n))


def test_b2_rollout_equals_b1_on_returned_controls():
    x0, x1, c, valid = _b2(rng.key(3), 4096)
    bx1, bvalid = _port(x0, c)
    np.testing.assert_array_equal(x1, bx1)
    np.testing.assert_array_equal(valid, bvalid)
