"""Kernel B5's plain twin, ``rollout_culled_soa`` (the culled broad phase),
against the JAX body it transcribes, ``_integrate_culled``
(cudasbmp_tpu/ops/rollout_pallas.py:143-328), run operator by operator
under ``jax.disable_jit()`` (interpret-mode Pallas with a footprint takes
XLA:CPU 10-25 s to compile), and against the one-pass twin ``rollout_soa``.

The field is tests/test_pallas.py's: 16 random boxes with two padding rows,
256 lanes, for the seven (fast_math, footprint, cull) cases of
test_culled_broad_phase_bit_identical and W = 5.

Tolerances: valid masks equal exactly, everywhere. States: the twin equals
``rollout_soa`` to the bit, for any grouping, and so does JAX's culled body
its one-pass body; against JAX, states are bitwise for the systems without
trig (point2d, double integrator), and for the bicycle within 1e-5 with at
least 90% of rows bitwise, because torch's CPU cos/sin/tan (SLEEF) and
XLA:CPU's differ by one ulp on a few percent of inputs (ROADMAP parity
rules).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudasbmp_torch.ops import rollout_cuda as rc
from cudasbmp_torch.systems import get_system
from cudasbmp_tpu.ops.rollout_pallas import _integrate, _integrate_culled
from cudasbmp_tpu.systems import get_system as j_get_system

torch.set_num_threads(2)
KW = dict(num_disc=10, width=20.0, height=20.0)
FP = (0.5, 0.25)
CASES = [(False, None, True), (True, None, True), (False, FP, True),
         (False, None, 2), (False, None, 4), (True, None, 2), (False, FP, 2),
         (False, None, 5)]


def field(seed: int = 1234):
    """tests/test_pallas.py's dense field and lanes, from a numpy generator."""
    r = np.random.default_rng(seed)
    K, B = 16, 256
    obs = np.empty((K, 4), np.float32)
    lo = r.uniform(0, 18, (K, 2))
    obs[:, :2] = lo
    obs[:, 2:] = lo + r.uniform(0.3, 3.0, (K, 2))
    obs[-2:] = [1.0, 1.0, 0.0, 0.0]  # degenerate padding rows
    x0 = np.zeros((B, 4), np.float32)
    x0[:, 0] = r.uniform(0.5, 19.5, B)
    x0[:, 1] = r.uniform(0.5, 19.5, B)
    x0[:, 2] = r.uniform(-3, 3, B)
    x0[:, 3] = r.uniform(-2, 2, B)
    c = np.zeros((B, 3), np.float32)
    c[:, 0] = r.uniform(-5, 5, B)
    c[:, 1] = r.uniform(-np.pi, np.pi, B)
    c[:, 2] = r.uniform(0.05, 1.05, B)
    return obs, x0, c


def jax_bodies(name, x0, c, obs, footprint, fast_math, cull, num_disc=KW["num_disc"]):
    """(culled, one-pass) results of the JAX kernel bodies, op by op, with
    all lanes in one program."""
    xj, cj = jnp.asarray(x0), jnp.asarray(c)
    boxes = [tuple(jnp.float32(v) for v in row) for row in obs]
    args = (j_get_system(name), [xj[:, i] for i in range(4)], [cj[:, 0], cj[:, 1]],
            cj[:, 2], boxes, num_disc, KW["width"], KW["height"], footprint,
            fast_math)
    with jax.disable_jit():
        culled = _integrate_culled(*args, cull_windows=int(cull))
        one_pass = _integrate(*args)
    return [(np.asarray(jnp.stack(comps, -1)), np.asarray(alive))
            for comps, alive in (culled, one_pass)]


def bits(a) -> np.ndarray:
    return np.asarray(a).view(np.int32)


@pytest.mark.parametrize("fast_math,footprint,cull", CASES)
def test_culled_twin_matches_the_jax_body(fast_math, footprint, cull):
    obs, x0, c = field()
    (jx, jv), (ox, ov) = jax_bodies("bicycle", x0, c, obs, footprint, fast_math, cull)
    # the JAX claim, op by op: the culled body is the one-pass body
    assert np.array_equal(jv, ov) and np.array_equal(bits(jx), bits(ox))
    system = get_system("bicycle")
    args = (system, torch.tensor(x0), torch.tensor(c), torch.tensor(obs))
    opts = dict(KW, footprint=footprint, fast_math=fast_math)
    sx, sv = rc.rollout_soa(*args, **opts)
    for group in (len(x0), rc.WARP, 8):
        tx, tv = rc.rollout_culled_soa(*args, cull=cull, group=group, **opts)
        assert torch.equal(tv, sv) and torch.equal(tx.view(torch.int32),
                                                   sx.view(torch.int32))
        np.testing.assert_array_equal(tv.numpy(), jv)
        np.testing.assert_allclose(tx.numpy(), jx, rtol=0, atol=1e-5)
        assert (bits(tx) == bits(jx)).all(1).mean() >= 0.9
    # the field must kill some rollouts or the test proves nothing
    assert 0.0 < jv.mean() < 1.0


@pytest.mark.parametrize("name", ["point2d", "double_integrator"])
@pytest.mark.parametrize("footprint,cull", [(None, True), (FP, 2), (None, 5)])
def test_culled_twin_is_the_jax_body_to_the_bit_without_trig(name, footprint, cull):
    obs, x0, c = field(7)
    spec = get_system(name).control_spec
    c[:, :2] = np.random.default_rng(8).uniform(spec.lo[:2], spec.hi[:2],
                                                (len(c), 2)).astype(np.float32)
    (jx, jv), _ = jax_bodies(name, x0, c, obs, footprint, False, cull)
    tx, tv = rc.rollout_culled_soa(get_system(name), torch.tensor(x0), torch.tensor(c),
                                   torch.tensor(obs), cull=cull, group=rc.WARP,
                                   footprint=footprint, **KW)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(bits(tx), bits(jx))
    assert 0.0 < jv.mean() < 1.0


@pytest.mark.parametrize("num_disc", [1, 3, 7, 10, 20])
def test_window_split_is_the_jax_bodys(num_disc):
    """cull=None/False/0 is off; True is one window; W windows at
    Python's round(w * n / W) (halves to even), at most one per step."""
    assert [rc.cull_windows(c, num_disc) for c in (None, False, 0)] == [0, 0, 0]
    assert rc.cull_windows(True, num_disc) == 1
    assert rc.cull_windows(10 * num_disc, num_disc) == num_disc
    for W in range(1, num_disc + 1):
        b = rc.window_bounds(W, num_disc)
        assert b == [round(w * num_disc / W) for w in range(W + 1)]
        assert b[0] == 0 and b[-1] == num_disc and all(np.diff(b) >= 1)
    assert rc.window_bounds(4, 10) == [0, 2, 5, 8, 10]  # 2.5 -> 2, 7.5 -> 8


@pytest.mark.parametrize("num_disc", [1, 7, 10, 11, 20, 40, 97])
def test_cull_plan_cuts_windows_to_the_kernels_cap(num_disc):
    """The kernel's windows (cull_plan): every step once, in order, no window
    longer than CULL_STEPS; each of window_bounds' windows is kept or cut,
    never merged; where none is longer than the cap, the plan is
    window_bounds, the JAX body's split."""
    for W in range(1, num_disc + 1):
        bounds = rc.window_bounds(W, num_disc)
        plan = rc.cull_plan(W, num_disc)
        steps = np.diff(plan)
        assert plan[0] == 0 and plan[-1] == num_disc
        assert steps.min() >= 1 and steps.max() <= rc.CULL_STEPS
        assert set(bounds) <= set(plan)
        if np.diff(bounds).max() <= rc.CULL_STEPS:
            assert plan == bounds
        else:
            assert len(plan) > len(bounds)
    assert rc.cull_plan(1, 10) == [0, 10] and rc.cull_plan(4, 10) == [0, 2, 5, 8, 10]
    assert rc.cull_plan(1, 40) == [0, 10, 20, 30, 40]
    assert rc.cull_plan(2, 25) == [0, 6, 12, 18, 25]  # 12 and 13 steps, cut in two


@pytest.mark.parametrize("name,footprint,fast_math", [
    ("bicycle", None, False), ("bicycle", FP, False), ("bicycle", FP, True),
    ("point2d", FP, False), ("double_integrator", None, False)])
@pytest.mark.parametrize("cull", [1, 2])
def test_cut_plan_twin_is_the_uncut_twin_and_the_jax_body(name, footprint, fast_math,
                                                          cull):
    """40 steps, past the kernel's cap: the culled twin on the kernel's cut
    plan equals the twin on the uncut windows and the one-pass twin, to the
    bit (and so does the wrapper's CPU path, which takes the cut plan);
    against the op-by-op JAX body, valid masks exactly and states within
    the file's tolerances (bitwise without trig). With fast math only the
    masks: its rotation recurrence carries the one-ulp difference of the
    first cos/sin through 40 steps (4.8e-5 on 14 of 1,024 values), past
    the tolerance stated for 10 steps."""
    num_disc = 40
    obs, x0, c = field(11)
    c[:, 2] *= 2.0  # the longer horizon reaches more boxes
    spec = get_system(name).control_spec
    if name != "bicycle":
        c[:, :2] = np.random.default_rng(12).uniform(spec.lo[:2], spec.hi[:2],
                                                     (len(c), 2)).astype(np.float32)
    system = get_system(name)
    args = (system, torch.tensor(x0), torch.tensor(c), torch.tensor(obs))
    opts = dict(KW, num_disc=num_disc, footprint=footprint, fast_math=fast_math)
    plan = rc.cull_plan(cull, num_disc)
    assert len(plan) > len(rc.window_bounds(cull, num_disc))
    sx, sv = rc.rollout_soa(*args, **opts)
    cut = rc.rollout_culled_soa(*args, cull=cull, group=rc.WARP, plan=plan, **opts)
    uncut = rc.rollout_culled_soa(*args, cull=cull, group=rc.WARP, **opts)
    wrapped = rc.rollout_cuda(*args, **opts, cull=cull)
    for tx, tv in (cut, uncut, wrapped):
        assert torch.equal(tv, sv) and torch.equal(tx.view(torch.int32),
                                                   sx.view(torch.int32))
    (jx, jv), _ = jax_bodies(name, x0, c, obs, footprint, fast_math, cull, num_disc)
    np.testing.assert_array_equal(sv.numpy(), jv)
    if name != "bicycle":
        np.testing.assert_array_equal(bits(sx), bits(jx))
    elif not fast_math:
        np.testing.assert_allclose(sx.numpy(), jx, rtol=0, atol=1e-5)
        assert (bits(sx) == bits(jx)).all(1).mean() >= 0.9
    assert 0.0 < jv.mean() < 1.0


def test_wrapper_constants_are_the_kernels():
    """The wrapper's copies of csrc/rollout.cu's constants: block size,
    walk padding, B5's window cap and plan length."""
    from pathlib import Path

    src = (Path(rc.__file__).resolve().parents[1] / "csrc" / "rollout.cu").read_text()
    for name, value in (("kThreads", rc.THREADS), ("kWalk", rc.WALK),
                        ("kCullSteps", rc.CULL_STEPS), ("kMaxPlan", rc.MAX_PLAN)):
        assert f"constexpr int {name} = {value};" in src


def test_culled_box_cap_gives_up_the_window_store(monkeypatch):
    """B5 keeps its window in the block's shared memory, so its box cap is
    the one-pass cap less exactly the store's bytes / 16 (broad phase and
    footprint); the wrapper's argument check raises above the launch's cap
    and passes at it."""
    optin = 232_448  # an H100's opt-in shared memory a block
    monkeypatch.setattr(rc, "smem_optin", lambda device_index: optin)
    monkeypatch.setattr(rc, "_index", lambda device: 0)
    full = rc.max_kernel_obstacles(0)
    assert full == optin // 16 == 14_528
    for footprint in (False, True):
        store = rc.cull_state_bytes(footprint)
        assert store == rc.THREADS * rc.CULL_STEPS * (24 if footprint else 16)
        culled = rc.max_kernel_obstacles(0, culled=True, footprint=footprint)
        assert full - culled == store // 16
        assert rc.max_kernel_obstacles(0, footprint=footprint) == full
    assert rc.max_kernel_obstacles(0, culled=True) == 13_248
    assert rc.max_kernel_obstacles(0, culled=True, footprint=True) == 12_608
    system = get_system("bicycle")
    x0 = torch.zeros((64, 4))
    for footprint in (None, FP):
        limit = rc.max_kernel_obstacles(0, culled=True, footprint=footprint is not None)
        for K, windows in ((limit, 1), (limit + 1, 0)):
            args = rc._kernel_args(system, x0, torch.zeros((K, 4)), footprint, False,
                                   False, windows)
            assert args[5] == K
        with pytest.raises(ValueError, match=f"{limit + 1} obstacles > {limit}"):
            rc._kernel_args(system, x0, torch.zeros((limit + 1, 4)), footprint, False,
                            False, 4)
        with pytest.raises(ValueError, match=f"> {full}"):
            rc._kernel_args(system, x0, torch.zeros((full + 1, 4)), footprint, False,
                            False, 0)


def test_plan_argument_is_one_byte_a_window():
    """The C entry points take B5's plan as one byte a window, its steps;
    cull off passes none; a plan longer than the kernel holds raises."""
    assert rc._plan_arg(None, 10) == (0, None)
    assert rc._plan_arg(4, 10) == (4, bytes([2, 3, 3, 2]))
    assert rc._plan_arg(True, 25) == (3, bytes([8, 8, 9]))
    n = rc.MAX_PLAN * rc.CULL_STEPS
    assert rc._plan_arg(1, n)[0] == rc.MAX_PLAN
    with pytest.raises(ValueError, match="windows"):
        rc._plan_arg(1, n + 1)


def test_footprint_pad_is_the_jax_bodys():
    from cudasbmp_tpu.ops.rollout_pallas import np_hypot

    assert rc.footprint_pad(None) == 0.0
    for hl, hw in ((0.5, 0.25), (0.3, 0.1), (1.0, 0.0)):
        assert rc.footprint_pad((hl, hw)) == hl + np_hypot(hl, hw)


def test_batched_culled_twin_groups_within_each_problem():
    """Lanes [B, R] with a box set per problem (B6's form): groups of lanes
    never span two problems, and the result is the one-pass twin's, for a
    ragged R."""
    obs, x0, c = field(3)
    B, R = 4, 60
    r = np.random.default_rng(4)
    boxes = np.repeat(obs[None], B, 0)
    boxes[:, :-2, :2] += r.uniform(-1, 1, (B, 1, 2)).astype(np.float32)
    boxes[:, :-2, 2:] = boxes[:, :-2, :2] + (obs[:-2, 2:] - obs[:-2, :2])
    args = (get_system("bicycle"), torch.tensor(x0[:B * R].reshape(B, R, 4)),
            torch.tensor(c[:B * R].reshape(B, R, 3)), torch.tensor(boxes))
    sx, sv = rc.rollout_soa(*args, **KW, footprint=FP)
    for cull in (True, 3):
        tx, tv = rc.rollout_culled_soa(*args, cull=cull, group=rc.WARP, **KW, footprint=FP)
        assert torch.equal(tv, sv) and torch.equal(tx, sx)
    assert 0.0 < sv.float().mean() < 1.0


def test_wrappers_on_the_cpu_take_the_culled_twin():
    """With cull, every wrapper's CPU path is B5's twin; it returns B1's
    result, and nothing counts as a launch."""
    obs, x0, c = field(5)
    system = get_system("bicycle")
    x0, c, obs = torch.tensor(x0), torch.tensor(c), torch.tensor(obs)
    rc.reset_launch_counts()
    a = rc.rollout_cuda(system, x0, c, obs, **KW)
    b = rc.rollout_cuda(system, x0, c, obs, **KW, cull=4)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    bb = rc.rollout_bicycle_cuda(x0, c, obs, **KW, cull=2)
    assert torch.equal(a[0], bb[0]) and torch.equal(a[1], bb[1])
    from cudasbmp_torch import rng

    key = rng.key(3)
    y = rc.sample_and_rollout_cuda(system, key, x0, obs, **KW, fast_math=True)
    z = rc.sample_and_rollout_bicycle_cuda(key, x0, obs, **KW, fast_math=True, cull=True)
    assert all(torch.equal(u, v) for u, v in zip(y, z))
    bounds = ((-1.0, 1.0), (-0.5, 0.5), (0.1, 0.2))
    _, cb, _ = rc.sample_and_rollout_bicycle_cuda(key, x0, obs, **KW,
                                                  control_bounds=bounds, cull=3)
    assert all(float(cb[:, j].min()) >= lo and float(cb[:, j].max()) <= hi
               for j, (lo, hi) in enumerate(bounds))
    keys = rng.split(key, 2)
    bx = x0[:256].reshape(2, 128, 4)
    bo = obs.expand(2, -1, -1).contiguous()
    u = rc.sample_and_rollout_batched_cuda(system, keys, bx, bo, **KW)
    v = rc.sample_and_rollout_batched_cuda(system, keys, bx, bo, **KW, cull=5)
    assert all(torch.equal(p, q) for p, q in zip(u, v))
    assert all(w.launches == 0 and w.culled == 0 for w in rc.WRAPPERS)
