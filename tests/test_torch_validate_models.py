"""The port's host data model (cudasbmp_torch/models.py) and state validator
(cudasbmp_torch/utils/validate.py) against the JAX package's, mirroring
tests/test_models_validate.py: Sample round trips, Agent's step by the
bicycle dynamics, its footprint, validate_state on a solve, the same
corruptions raising the same messages, a JAX state carried over by
convert.py giving JAX's summary, and the invariants over random
scenarios."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import cudasbmp_torch as ct
import cudasbmp_tpu as jt
from cudasbmp_torch.convert import state_from_numpy, state_to_numpy
from cudasbmp_torch.models import Agent, Sample
from cudasbmp_torch.planners.kgmt import KGMTState
from cudasbmp_torch.utils.validate import InvariantViolation, validate_state
from cudasbmp_tpu import models as jmodels
from cudasbmp_tpu.utils import validate as jvalidate

torch.set_num_threads(2)
SMALL = dict(num_iterations=100, max_tree_size=16384, rollouts_per_iter=2048)


@pytest.fixture(scope="module")
def solved():
    cfg = ct.KGMTConfig(**SMALL)
    return cfg, ct.KGMT(cfg, device="cpu").plan(ct.Scenario.demo())


def test_sample_roundtrip_matches_jax():
    s = Sample(1, 2, 0.5, 1.5, -2.0, 0.3, 0.7)
    js = jmodels.Sample(1, 2, 0.5, 1.5, -2.0, 0.3, 0.7)
    arr = s.to_array()
    np.testing.assert_array_equal(arr, js.to_array())
    assert Sample.from_array(arr) == Sample(*dataclasses.astuple(jmodels.Sample.from_array(arr)))
    np.testing.assert_array_equal(s.state, js.state)
    np.testing.assert_array_equal(s.control, js.control)


@pytest.mark.parametrize("pose,control", [((1.0, 2.0, 0.7, 1.5), (2.0, 0.3, 0.05)),
                                          ((9.0, 3.0, -2.5, -0.4), (-4.0, -1.1, 0.31))])
def test_agent_update_matches_jax(pose, control):
    """Agent::updateState (Agent.cpp:19-25) through each package's bicycle
    step: equal within an ulp of float32 trig."""
    a = Agent(*pose, length=1.5)
    ja = jmodels.Agent(*pose, length=1.5)
    a.update_state(*control)
    ja.update_state(*control)
    np.testing.assert_allclose([a.x, a.y, a.theta, a.v], [ja.x, ja.y, ja.theta, ja.v],
                               rtol=1e-6, atol=1e-6)
    assert a.v == pytest.approx(pose[3] + control[0] * control[2], rel=1e-6)


def test_agent_footprint_matches_jax():
    for theta in (0.0, np.pi / 2, -0.8):
        a = Agent(x=5.0, y=5.0, theta=theta, length=2.0, width=1.0)
        ja = jmodels.Agent(x=5.0, y=5.0, theta=theta, length=2.0, width=1.0)
        np.testing.assert_array_equal(a.footprint_ccw(), ja.footprint_ccw())
    a = Agent(x=5.0, y=5.0, theta=np.pi / 2, length=2.0, width=1.0)
    np.testing.assert_allclose(a.footprint_ccw()[1], [5.5, 7.0], atol=1e-6)


def test_validate_state_passes_on_a_port_solve(solved):
    cfg, result = solved
    summary = validate_state(result.state, cfg)
    assert summary["solved"]
    assert summary["tree_size"] == result.tree_size
    assert summary["max_depth"] >= len(result.path) - 1


def _corrupt(state: KGMTState, field: str, index, value) -> KGMTState:
    host = state_to_numpy(state)
    host[field] = np.array(host[field])
    host[field][index] = value
    return state_from_numpy(KGMTState, host, "cpu")


def _jax_state(fields: dict):
    from cudasbmp_tpu.planners.kgmt import KGMTState as JState

    return JState(**{k: jax.numpy.asarray(v) for k, v in fields.items() if k != "key"},
                  key=jax.random.wrap_key_data(jax.numpy.asarray(fields["key"])))


@pytest.mark.parametrize("field,index,value", [
    ("tree_parent", 5, 100000),  # tests/test_models_validate.py:58
    ("costs", 10, -5.0),  # :62
    ("tree_parent", 0, 3),
    ("tree_parent", -1, 0),
    ("r1_invalid", 7, 99),
    ("r1_avail", 3, 2),
    ("goal_node", (), 16383),
    ("frontier_lo", (), 16384),
])
def test_corruptions_raise_jaxs_messages(solved, field, index, value):
    cfg, result = solved
    bad = _corrupt(result.state, field, index, value)
    with pytest.raises(InvariantViolation) as got:
        validate_state(bad, cfg)
    with pytest.raises(jvalidate.InvariantViolation) as want:
        jvalidate.validate_state(_jax_state(state_to_numpy(bad)),
                                 jt.KGMTConfig(**SMALL))
    assert str(got.value) == str(want.value)


def test_jax_state_converted_gives_jaxs_summary():
    cfg = dict(num_iterations=40, max_tree_size=4096, rollouts_per_iter=512)
    jcfg = jt.KGMTConfig(**cfg)
    jres = jt.KGMT(jcfg).plan(jt.Scenario.demo(), seed=2)
    fields = {k: np.asarray(v) for k, v in jres.state._asdict().items() if k != "key"}
    fields["key"] = np.asarray(jax.random.key_data(jres.state.key))
    port = state_from_numpy(KGMTState, fields, "cpu")
    want = jvalidate.validate_state(jres.state, jcfg)
    assert want["tree_size"] > 1
    assert validate_state(port, ct.KGMTConfig(**cfg)) == want


def test_invariants_fuzz_random_scenarios():
    """tests/test_models_validate.py:100 on the port: every invariant on
    random obstacle fields, depth within the iterations."""
    from cudasbmp_torch.parallel.monte_carlo import random_scenarios

    cfg = ct.KGMTConfig(num_iterations=40, max_tree_size=4096, rollouts_per_iter=512)
    inits, goals, obstacles = random_scenarios(ct.rng.key(42), 6, cfg, num_obstacles=8)
    planner = ct.KGMT(cfg, device="cpu")
    solved = 0
    for i in range(6):
        sc = ct.Scenario(init=np.asarray(inits[i]), goal=np.asarray(goals[i]),
                         obstacles=np.asarray(obstacles[i])[:8])
        result = planner.plan(sc, seed=i)
        summary = validate_state(result.state, cfg)
        assert summary["max_depth"] <= result.iterations
        solved += int(result.solved)
    assert solved >= 3
