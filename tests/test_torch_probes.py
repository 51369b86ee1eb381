"""The throughput-probe planners of the port (planners/naive.py,
planners/costprop.py, ops/rollout.py::rollout_unchecked): the four cases of
tests/test_probes.py, and the samples against the JAX planners run op by
op. Controls are the same threefry draws, to the bit; states are bitwise
for the double integrator (no trig) and, for the bicycle, within 1e-6 with
at least 98% of values bitwise (torch's CPU trig, SLEEF, and XLA:CPU's
differ by one ulp on a few percent of inputs)."""

import jax
import numpy as np
import pytest
import torch

from cudasbmp_torch.config import KGMTConfig, Scenario
from cudasbmp_torch.ops.rollout import rollout_batch, rollout_unchecked
from cudasbmp_torch.planners import CostPropPlanner, NaivePlanner, Planner
from cudasbmp_torch.systems import get_system
from cudasbmp_tpu.config import Scenario as JScenario
from cudasbmp_tpu.planners.costprop import CostPropPlanner as JCostProp
from cudasbmp_tpu.planners.naive import NaivePlanner as JNaive
from cudasbmp_tpu.systems import get_system as j_get_system

torch.set_num_threads(2)
DEMO = Scenario.demo()


def test_naive_tree_shape_and_ranges():
    p = NaivePlanner(KGMTConfig(), width_rollouts=256, rows=4, device="cpu")
    assert isinstance(p, Planner)
    r = p.plan(DEMO)
    assert r.samples.shape == (4, 256, 7)
    assert r.num_rollouts == 1024
    assert r.rollouts_per_sec > 0
    a, steer, dur = r.samples[..., 4], r.samples[..., 5], r.samples[..., 6]
    assert a.min() >= -2.5 and a.max() <= 2.5
    assert steer.min() >= -np.pi / 2 and steer.max() <= np.pi / 2
    assert dur.min() >= 0.0 and dur.max() <= 0.3


def test_naive_rows_start_from_root():
    r = NaivePlanner(KGMTConfig(), width_rollouts=64, rows=3, device="cpu").plan(DEMO)
    d = np.hypot(r.samples[..., 0] - 5.0, r.samples[..., 1] - 5.0)
    assert d.max() < 1.0


def test_costprop_chains_rows():
    r = CostPropPlanner(KGMTConfig(), width_rollouts=128, rows=5, group_size=32,
                        device="cpu").plan(DEMO)
    assert r.samples.shape == (5, 128, 7)
    d = np.hypot(r.samples[..., 0] - 5.0, r.samples[..., 1] - 5.0)
    assert d[-1].mean() >= d[0].mean()


def test_costprop_reference_scale_runs():
    """The 524,288-rollout probe shape, scaled by 16 for CPU test time."""
    r = CostPropPlanner(KGMTConfig(), width_rollouts=32768, rows=1, device="cpu").plan(DEMO)
    assert r.num_rollouts == 32768
    assert np.isfinite(r.samples).all()


def _samples(kind, system, seed, **kw):
    """(port samples, op-by-op JAX samples) of one probe planner."""
    port = {"naive": NaivePlanner, "costprop": CostPropPlanner}[kind]
    jax_p = {"naive": JNaive, "costprop": JCostProp}[kind]
    ours = port(system=get_system(system), device="cpu", **kw).plan(DEMO, seed=seed)
    with jax.disable_jit():
        theirs = jax_p(system=j_get_system(system), **kw).plan(JScenario.demo(), seed=seed)
    return ours.samples, theirs.samples


@pytest.mark.parametrize("kind,kw", [
    ("naive", dict(width_rollouts=64, rows=3)),
    ("costprop", dict(width_rollouts=128, rows=4, group_size=32))])
def test_samples_are_the_jax_planners(kind, kw):
    ours, theirs = _samples(kind, "bicycle", 3, **kw)
    np.testing.assert_array_equal(ours[..., 4:].view(np.int32), theirs[..., 4:].view(np.int32))
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6)
    assert (ours.view(np.int32) == theirs.view(np.int32)).mean() >= 0.98
    ours, theirs = _samples(kind, "double_integrator", 4, **kw)
    np.testing.assert_array_equal(ours.view(np.int32), theirs.view(np.int32))


def test_rollout_unchecked_skips_every_test():
    """No bounds or boxes: a rollout that leaves the workspace keeps going,
    and where nothing fails it is rollout_batch's result to the bit."""
    system = get_system("bicycle")
    x0 = torch.tensor([[0.5, 10.0, np.pi, 2.0], [10.0, 10.0, 0.0, 1.0]])
    c = torch.tensor([[0.0, 0.0, 1.0], [0.5, 0.1, 0.5]])
    x1 = rollout_unchecked(system, x0, c, 10)
    assert float(x1[0, 0]) < 0.0
    bx, bv = rollout_batch(system, x0, c, 10, torch.zeros(0, 4), 20.0, 20.0)
    assert not bv[0] and bv[1] and torch.equal(x1[1], bx[1])


def test_probe_planners_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for p in (NaivePlanner, CostPropPlanner):
        with pytest.raises(RuntimeError, match="is_available"):
            p(width_rollouts=64)
