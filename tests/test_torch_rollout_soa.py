"""The plain SoA twin of the rollout kernels (``rollout_soa``, the plain
version of B1-B4) against the JAX kernel body, for every system x
{broad phase, footprint} x {exact, fast math}:

- against ``_integrate`` (cudasbmp_tpu/ops/rollout_pallas.py:66-140), the
  body the TPU kernel runs, called on the same component arrays outside
  Pallas;
- against ``rollout_pallas(..., interpret=True)``, the TPU kernel itself as
  tests/test_pallas.py runs it on the CPU (broad phase here; the footprint
  cases are in tests/test_torch_footprint.py).

Tolerance: states within 1e-3; masks equal except on lanes whose path
passes within 1e-3 of a workspace bound or an obstacle edge, where trig
ulps (glibc in XLA:CPU, SLEEF in torch) and XLA's fused multiply-adds may
decide either way. Fast math on a system without the fast hooks is the
exact path, to the bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudasbmp_torch import rng
from cudasbmp_torch._math import div
from cudasbmp_torch.config import Scenario
from cudasbmp_torch.ops import rollout_cuda as rc
from cudasbmp_torch.ops.rollout import rollout_batch
from cudasbmp_torch.systems import get_system
from cudasbmp_tpu.ops.rollout_pallas import _integrate, rollout_pallas
from cudasbmp_tpu.systems import get_system as j_get_system

torch.set_num_threads(2)
NAMES = ["bicycle", "point2d", "double_integrator", "unicycle", "dubins"]
KW = dict(num_disc=10, width=20.0, height=20.0)
OBS = Scenario.demo().padded_obstacles(32)[0]  # 5 boxes + 3 padding rows
FP = (0.5, 0.25)
EDGE = 1e-3


def batch(name: str, B: int, seed: int):
    """Parents over the demo workspace (headings and speeds where the system
    has them), controls uniform in the system's box; numpy generator."""
    r = np.random.default_rng(seed)
    spec = j_get_system(name).control_spec
    x0 = np.zeros((B, 4), np.float32)
    x0[:, 0] = r.uniform(0.5, 19.5, B)
    x0[:, 1] = r.uniform(0.5, 19.5, B)
    if name != "point2d":
        x0[:, 2] = r.uniform(-np.pi, np.pi, B)
    if name in ("bicycle", "double_integrator"):
        x0[:, 3] = r.uniform(-3, 3, B)
    u = r.uniform(0, 1, (B, spec.dim))
    c = np.asarray(spec.lo) + u * (np.asarray(spec.hi) - np.asarray(spec.lo))
    return x0, c.astype(np.float32)


def edge_margin(system, x0, c, obs, footprint) -> torch.Tensor:
    """Per lane, the least slack over all steps of the unfrozen exact path:
    the workspace bounds, the swept-AABB separation and, with a footprint,
    the body's separating-axis slack, against every real box."""
    o = obs[(obs[:, 2] >= obs[:, 0]) & (obs[:, 3] >= obs[:, 1])]
    dt = div(c[:, -1], KW["num_disc"])
    s = x0
    margin = torch.full((x0.shape[0],), float("inf"))
    hi_ = getattr(system, "heading_index", None)
    for _ in range(KW["num_disc"]):
        n = system.step(s, c[:, :-1], dt)
        nx, ny = n[:, 0], n[:, 1]
        m = torch.stack([nx, KW["width"] - nx, ny, KW["height"] - ny]).abs().amin(0)
        lo, hi = torch.minimum(s[:, :2], n[:, :2]), torch.maximum(s[:, :2], n[:, :2])
        sep = torch.stack([o[None, :, 0] - hi[:, None, 0], lo[:, None, 0] - o[None, :, 2],
                           o[None, :, 1] - hi[:, None, 1], lo[:, None, 1] - o[None, :, 3]])
        m = torch.minimum(m, sep.amax(0).abs().amin(1))
        if footprint is not None:
            hl, hw = footprint
            th = n[:, hi_] if hi_ is not None else torch.zeros_like(nx)
            ct, st = torch.cos(th)[:, None], torch.sin(th)[:, None]
            act, ast = ct.abs(), st.abs()
            dx = (nx[:, None] + hl * ct) - (o[None, :, 0] + o[None, :, 2]) * 0.5
            dy = (ny[:, None] + hl * st) - (o[None, :, 1] + o[None, :, 3]) * 0.5
            bhx, bhy = (o[None, :, 2] - o[None, :, 0]) * 0.5, (o[None, :, 3] - o[None, :, 1]) * 0.5
            axes = torch.stack([dx.abs() - (bhx + hl * act + hw * ast),
                                dy.abs() - (bhy + hl * ast + hw * act),
                                (dx * ct + dy * st).abs() - (hl + bhx * act + bhy * ast),
                                (dy * ct - dx * st).abs() - (hw + bhx * ast + bhy * act)])
            m = torch.minimum(m, axes.amax(0).abs().amin(1))
        margin = torch.minimum(margin, m)
        s = n
    return margin


def assert_twin_matches(name, x0, c, obs, footprint, fast_math, want_x1, want_v):
    """The port's twin on (x0, c) against a JAX result (see module doc)."""
    system = get_system(name)
    x1, v = rc.rollout_soa(system, torch.tensor(x0), torch.tensor(c),
                           torch.tensor(obs), **KW, footprint=footprint,
                           fast_math=fast_math)
    x1, v = x1.numpy(), v.numpy()
    mis = v != want_v
    if mis.any():
        m = edge_margin(system, torch.tensor(x0[mis]), torch.tensor(c[mis]),
                        torch.tensor(obs), footprint)
        assert (m <= EDGE).all(), f"{mis.sum()} mask flips; margins {m.max():.3g}"
    assert mis.mean() < 0.01
    np.testing.assert_allclose(x1[~mis], want_x1[~mis], atol=EDGE, rtol=0)
    assert 0.05 < v.mean() < 0.98  # both verdicts occur


def _integrate_jax(name, x0, c, obs, footprint, fast_math):
    """The TPU kernel body on [B] component arrays, op by op (compiling the
    unrolled footprint loop would take XLA:CPU 10-15 s per case)."""
    x0, c = jnp.asarray(x0), jnp.asarray(c)
    boxes = [tuple(jnp.float32(v) for v in row) for row in obs]
    with jax.disable_jit():
        comps, alive = _integrate(j_get_system(name), [x0[:, i] for i in range(4)],
                                  [c[:, 0], c[:, 1]], c[:, 2], boxes,
                                  KW["num_disc"], KW["width"], KW["height"],
                                  footprint, fast_math)
    return np.asarray(jnp.stack(comps, -1)), np.asarray(alive)


@pytest.mark.parametrize("fast_math", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("footprint", [None, FP], ids=["broad", "footprint"])
@pytest.mark.parametrize("name", NAMES)
def test_twin_matches_kernel_body(name, footprint, fast_math):
    x0, c = batch(name, 2048, NAMES.index(name))
    want_x1, want_v = _integrate_jax(name, x0, c, OBS, footprint, fast_math)
    assert_twin_matches(name, x0, c, OBS, footprint, fast_math, want_x1, want_v)


@pytest.mark.parametrize("fast_math", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("name", NAMES)
def test_twin_matches_interpret_mode_kernel(name, fast_math):
    x0, c = batch(name, 1024, 10 + NAMES.index(name))
    px1, pv = rollout_pallas(j_get_system(name), jnp.asarray(x0), jnp.asarray(c),
                             jnp.asarray(OBS), interpret=True, fast_math=fast_math,
                             **KW)
    assert_twin_matches(name, x0, c, OBS, None, fast_math, np.asarray(px1),
                        np.asarray(pv))


@pytest.mark.parametrize("footprint", [None, FP], ids=["broad", "footprint"])
@pytest.mark.parametrize("name", NAMES)
def test_exact_twin_equals_rollout_batch_and_fast_noop_without_hooks(name, footprint):
    """The twin's exact path is rollout_batch to the bit; fast math changes
    nothing on the systems without the fast hooks."""
    system = get_system(name)
    x0, c = (torch.tensor(a) for a in batch(name, 2048, 20))
    obs = torch.tensor(OBS)
    x1, v = rc.rollout_soa(system, x0, c, obs, **KW, footprint=footprint)
    bx1, bv = rollout_batch(system, x0, c, KW["num_disc"], obs, KW["width"],
                            KW["height"], footprint=footprint)
    assert torch.equal(v, bv) and torch.equal(x1, bx1)
    fx1, fv = rc.rollout_soa(system, x0, c, obs, **KW, footprint=footprint,
                             fast_math=True)
    if hasattr(system, "soa_step_fast"):
        assert not torch.equal(fx1, x1)  # the recurrence rounds differently
        assert (fv == v).float().mean() > 0.99
    else:
        assert torch.equal(fv, v) and torch.equal(fx1, x1)


@pytest.mark.parametrize("name", NAMES)
def test_b2_twin_every_system(name):
    """B2's plain twin: Philox controls inside each system's control box,
    then the B1 twin on them, with the options passed through."""
    system = get_system(name)
    x0, _ = batch(name, 4096, 30)
    obs = torch.tensor(OBS)
    x1, c, v = rc.sample_and_rollout_cuda(system, rng.key(5), torch.tensor(x0), obs,
                                          **KW, footprint=FP, fast_math=True)
    lo = torch.tensor(system.control_spec.lo)
    hi = torch.tensor(system.control_spec.hi)
    assert ((c >= lo) & (c <= hi)).all()
    bx1, bv = rc.rollout_soa(system, torch.tensor(x0), c, obs, **KW, footprint=FP,
                             fast_math=True)
    assert torch.equal(v, bv) and torch.equal(x1, bx1)


def test_kernel_inputs_are_checked_before_launch():
    """What the CUDA wrappers refuse is decided on the host, so it shows on
    the CPU too: an unknown system class has no kernel."""
    class Other:
        name, state_dim = "other", 4

    with pytest.raises(NotImplementedError, match="SoA"):
        rc.rollout_soa(Other(), torch.zeros(4, 4), torch.zeros(4, 3),
                       torch.tensor(OBS), **KW)
    assert rc.supports_system(get_system("dubins"))
    assert set(rc.SYSTEM_IDS.values()) == set(range(5))
