"""The port's five dynamical systems against the JAX package's: the Euler
step, the per-component (SoA) hooks of the rollout kernels and the
fast-math hooks, on the same numpy inputs; and the registry.

Tolerance: states at atol 1e-5, rtol 1e-5. Both sides round every
operation once in the same order (JAX runs op by op here); what differs is
the last bit of cos/sin/tan (glibc in XLA:CPU, SLEEF in torch)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudasbmp_torch import systems as tsys
from cudasbmp_tpu import systems as jsys

torch.set_num_threads(2)
NAMES = ["bicycle", "point2d", "double_integrator", "unicycle", "dubins"]
TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(name: str, B: int = 4096, seed: int = 0):
    """States over the demo workspace with headings and speeds in range,
    controls uniform in the system's box; dt from durations / 10."""
    r = np.random.default_rng(seed)
    spec = jsys.get_system(name).control_spec
    x = np.stack([r.uniform(0.5, 19.5, B), r.uniform(0.5, 19.5, B),
                  r.uniform(-np.pi, np.pi, B), r.uniform(-3, 3, B)], -1)
    if name == "point2d":
        x[:, 2:] = 0.0
    if name in ("unicycle", "dubins"):
        x[:, 3] = 0.0
    u = r.uniform(0, 1, (B, spec.dim))
    c = np.asarray(spec.lo) + u * (np.asarray(spec.hi) - np.asarray(spec.lo))
    return x.astype(np.float32), c.astype(np.float32)


def _np(ts):
    return [np.asarray(t) for t in ts]


def _close(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **TOL,
                                   err_msg=f"{what}[{i}]")


def test_registry_matches_jax():
    assert tsys.available_systems() == jsys.available_systems()
    for name in tsys.available_systems():
        t, j = tsys.get_system(name), jsys.get_system(name)
        assert (t.name, t.state_dim) == (j.name, j.state_dim)
        assert t.control_spec.lo == j.control_spec.lo
        assert t.control_spec.hi == j.control_spec.hi
        assert getattr(t, "heading_index", None) == getattr(j, "heading_index", None)
        assert hasattr(t, "soa_step_fast") == hasattr(j, "soa_step_fast")
    assert isinstance(tsys.get_system("car"), tsys.KinematicBicycle)
    assert tsys.get_system("bicycle", agent_length=2.5).agent_length == 2.5
    with pytest.raises(KeyError, match="unknown system"):
        tsys.get_system("quadrotor")


@pytest.mark.parametrize("name", NAMES)
def test_step_and_soa_step_match_jax(name):
    """``step`` and ``soa_prepare``/``soa_step`` agree with JAX, and the
    port's SoA step equals its own ``step`` to the bit (the kernel's plain
    twin relies on that for the exact path)."""
    x, c = _inputs(name)
    dt = (c[:, -1] / np.float32(10)).astype(np.float32)
    ts, js = tsys.get_system(name), jsys.get_system(name)
    with jax.disable_jit():
        jstep = js.step(jnp.asarray(x), jnp.asarray(c[:, :-1]), jnp.asarray(dt))
        jsoa = js.soa_step(list(jnp.asarray(x.T)),
                           js.soa_prepare(list(jnp.asarray(c[:, :-1].T))),
                           jnp.asarray(dt))
    tstep = ts.step(torch.tensor(x), torch.tensor(c[:, :-1]), torch.tensor(dt))
    tsoa = ts.soa_step(list(torch.tensor(x).unbind(-1)),
                       ts.soa_prepare(list(torch.tensor(c[:, :-1]).unbind(-1))),
                       torch.tensor(dt))
    np.testing.assert_allclose(tstep.numpy(), np.asarray(jstep), **TOL)
    _close(tsoa, jsoa, "soa_step")
    assert torch.equal(torch.stack(tsoa, -1), tstep)
    if name in ("point2d", "unicycle", "dubins"):  # zero padding dims stay 0
        pad = slice(2, 4) if name == "point2d" else slice(3, 4)
        assert (tstep[:, pad] == 0).all()


@pytest.mark.parametrize("name", ["bicycle", "unicycle", "dubins"])
def test_fast_hooks_match_jax(name):
    """``soa_prepare_fast`` and ten ``soa_step_fast`` steps: the states and
    every carried cos/sin against JAX's, and carry[0:2] stays (cos, sin) of
    the heading the state reached (the footprint test reads it)."""
    x, c = _inputs(name, seed=1)
    dt = (c[:, -1] / np.float32(10)).astype(np.float32)
    ts, js = tsys.get_system(name), jsys.get_system(name)
    tcomps = list(torch.tensor(x).unbind(-1))
    with jax.disable_jit():
        jcomps = list(jnp.asarray(x.T))
        jcarry, jaux = js.soa_prepare_fast(jcomps, list(jnp.asarray(c[:, :-1].T)),
                                           jnp.asarray(dt))
        tcarry, taux = ts.soa_prepare_fast(tcomps, list(torch.tensor(c[:, :-1]).unbind(-1)),
                                           torch.tensor(dt))
        _close(tcarry, jcarry, "carry0")
        _close(taux, jaux, "aux")
        for k in range(10):
            jcomps, jcarry = js.soa_step_fast(jcomps, jcarry, jaux, jnp.asarray(dt))
            tcomps, tcarry = ts.soa_step_fast(tcomps, tcarry, taux, torch.tensor(dt))
            _close(tcomps, jcomps, f"state step {k}")
            _close(tcarry, jcarry, f"carry step {k}")
    # the recurrence drifts from exact trig by rounding: about 1e-4 after 10
    # steps where tan(steering) is near-singular (the JAX config's note)
    th = tcomps[2].double()
    np.testing.assert_allclose(tcarry[0].numpy(), torch.cos(th).numpy(), atol=1e-3)
    np.testing.assert_allclose(tcarry[1].numpy(), torch.sin(th).numpy(), atol=1e-3)


@pytest.mark.parametrize("name", ["point2d", "double_integrator"])
def test_systems_without_heading_have_no_fast_hooks(name):
    s = tsys.get_system(name)
    assert not hasattr(s, "soa_step_fast") and not hasattr(s, "heading_index")


def test_bicycle_fast_prepare_divides_by_the_wheelbase():
    """v / L and a*dt / L are true divisions (``_math.div``), as in the
    kernel: with L = 3 a reciprocal multiply would round differently on
    some lanes; the port's values equal float32 division exactly."""
    x, c = _inputs("bicycle", seed=2)
    dt = torch.tensor((c[:, -1] / np.float32(10)).astype(np.float32))
    L = 3.0
    bike = tsys.KinematicBicycle(agent_length=L)
    comps = list(torch.tensor(x).unbind(-1))
    ctrl = list(torch.tensor(c[:, :-1]).unbind(-1))
    carry, aux = bike.soa_prepare_fast(comps, ctrl, dt)
    tan_s = torch.tan(ctrl[1]).numpy()
    v, a, d = x[:, 3], c[:, 0], dt.numpy()
    np.testing.assert_array_equal(carry[4].numpy(), (v / np.float32(L)) * tan_s * d)
    np.testing.assert_array_equal(aux[3].numpy(), ((a * d) / np.float32(L)) * tan_s * d)
