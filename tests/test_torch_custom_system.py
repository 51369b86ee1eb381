"""User dynamics in the port, on the CPU at a small size (max_tree_size
2,048, R = 256, 5 iterations), against the JAX package:

- a system with only the generic ``step`` (``Drift``, a damped double
  integrator) solves as JAX's ``KGMT(..., system=Drift())`` does op by op
  (jax.disable_jit), bit for bit: JAX sends a system its Pallas kernel
  cannot take to ``rollout_batch``, and so does the port
  (``ops/rollout_cuda.py::rollout_route``);
- ``Drift`` with SoA hooks: the twin ``rollout_soa`` against JAX's
  ``rollout_pallas(..., interpret=True)``;
- ``register_system``: a registered name through ``KGMT``,
  ``MultiQueryPlanner`` and the CLI's ``plan``; a name shadowing a built-in
  keys its own struct;
- the kernel backends' refusal of a system without a device struct, decided
  before any launch;
- the pure parts of a user struct's build (ops/_build.py): its library's
  name, its nvcc command lines, its header, the checks of the struct
  against its Python side, two builds of one struct at once, and a build
  that fails.

Tolerances: the solves, the trees and the masks exactly; states of the
generic rollout within 1e-6 (Drift has no trig; op-by-op JAX and torch
round alike); the SoA twin against the interpreted Pallas kernel within
1e-5, whose XLA program may contract a multiply-add."""

import dataclasses
import json
import pathlib
import sys
import threading
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cudasbmp_torch as ct
from cudasbmp_torch import cli, rng
from cudasbmp_torch.io.csv import load_scenario
from cudasbmp_torch.ops import _build
from cudasbmp_torch.ops import rollout_cuda as rc
from cudasbmp_torch.ops.rollout import rollout_batch
from cudasbmp_torch.parallel import MultiQueryPlanner
from cudasbmp_torch.shortcut import ShortcutConfig, shortcut_path
from cudasbmp_torch.systems import (available_systems, device_struct, get_system,
                                    register_system, registry)
from cudasbmp_torch.utils.metrics import summarize_result
import cudasbmp_tpu as jt
from cudasbmp_tpu.ops.rollout import rollout_batch as j_rollout_batch
from cudasbmp_tpu.ops.rollout_pallas import rollout_pallas
from cudasbmp_tpu.systems import ControlSpec as JSpec
from torch_user_systems import (BICYCLE_STRUCT, BicycleCopy, Drift, DriftNoBack,
                                DriftSoA, DriftStruct)

torch.set_num_threads(2)
SMALL = dict(max_tree_size=2048, rollouts_per_iter=256, num_iterations=5)
KW = dict(num_disc=10, width=20.0, height=20.0)
OBS = ct.Scenario.demo().padded_obstacles(8)[0]
REPO = pathlib.Path(__file__).resolve().parent.parent


@dataclasses.dataclass(frozen=True)
class JDrift:
    """``Drift`` in jnp, op for op."""
    name: str = "drift"
    state_dim: int = 4
    damping: float = 0.3
    control_spec: JSpec = dataclasses.field(
        default_factory=lambda: JSpec(lo=(-3.0, -3.0, 0.05), hi=(3.0, 3.0, 1.05)))

    def step(self, state, control, dt):
        x, y, vx, vy = (state[..., i] for i in range(4))
        ax, ay = control[..., 0], control[..., 1]
        return jnp.stack([x + vx * dt, y + vy * dt, vx + (ax - self.damping * vx) * dt,
                          vy + (ay - self.damping * vy) * dt], axis=-1)


@dataclasses.dataclass(frozen=True)
class JDriftSoA(JDrift):
    def soa_prepare(self, ctrl):
        return tuple(ctrl)

    def soa_step(self, comps, aux, dt):
        x, y, vx, vy = comps
        ax, ay = aux
        return [x + vx * dt, y + vy * dt, vx + (ax - self.damping * vx) * dt,
                vy + (ay - self.damping * vy) * dt]


def drift_batch(B: int, seed: int):
    """Starts over the workspace with velocities in [-3, 3], controls
    uniform in Drift's box; numpy generator."""
    r = np.random.default_rng(seed)
    x0 = np.zeros((B, 4), np.float32)
    x0[:, :2] = r.uniform(0.5, 19.5, (B, 2))
    x0[:, 2:] = r.uniform(-3, 3, (B, 2))
    spec = Drift().control_spec
    c = np.asarray(spec.lo) + r.uniform(0, 1, (B, 3)) * (
        np.asarray(spec.hi) - np.asarray(spec.lo))
    return x0, c.astype(np.float32)


@pytest.fixture
def registered():
    """Register systems under unique names; the registry is restored after."""
    saved = dict(registry._REGISTRY)

    def add(ctor, name: str | None = None) -> str:
        name = name or f"user_{uuid.uuid4().hex[:8]}"
        register_system(name, ctor)
        return name

    yield add
    registry._REGISTRY.clear()
    registry._REGISTRY.update(saved)


# -- the repair: a system with only step solves as JAX's planner does ---------

@pytest.mark.parametrize("seed", [0, 1])
def test_hookless_system_solves_as_jax(seed):
    with jax.disable_jit():
        want = jt.KGMT(jt.KGMTConfig(**SMALL), system=JDrift()).plan(
            jt.Scenario.demo(), seed=seed)
    got = ct.KGMT(ct.KGMTConfig(**SMALL), system=Drift(), device="cpu").plan(
        ct.Scenario.demo(), seed=seed)
    assert (got.solved, got.iterations, got.tree_size, got.cost) == (
        want.solved, want.iterations, want.tree_size, want.cost)
    n = got.tree_size
    np.testing.assert_array_equal(got.state.tree_samples[:n].numpy(),
                                  np.asarray(want.state.tree_samples)[:n])
    np.testing.assert_array_equal(got.state.tree_parent[:n].numpy(),
                                  np.asarray(want.state.tree_parent)[:n])
    for k in ("frontier_size", "valid", "accepted", "tree_size"):
        np.testing.assert_array_equal(got.metrics[k], np.asarray(want.metrics[k]))
    assert got.metrics["rollout"] == "generic"


def test_generic_rollout_of_a_hookless_system_matches_jax():
    x0, c = drift_batch(1024, 3)
    with jax.disable_jit():
        wx1, wv = j_rollout_batch(JDrift(), jnp.asarray(x0), jnp.asarray(c), 10,
                                  jnp.asarray(OBS), 20.0, 20.0)
    x1, v = rollout_batch(Drift(), torch.tensor(x0), torch.tensor(c), 10,
                          torch.tensor(OBS), 20.0, 20.0)
    np.testing.assert_array_equal(v.numpy(), np.asarray(wv))
    np.testing.assert_allclose(x1.numpy(), np.asarray(wx1), atol=1e-6, rtol=0)
    assert 0 < int(v.sum()) < 1024


@pytest.mark.parametrize("footprint", [None, (0.5, 0.25)])
def test_soa_twin_of_a_user_system_matches_jax_pallas(footprint):
    x0, c = drift_batch(512, 4)
    obs = OBS[:4]  # interpret-mode Pallas with a footprint compiles slowly
    wx1, wv = rollout_pallas(JDriftSoA(), jnp.asarray(x0), jnp.asarray(c),
                             jnp.asarray(obs), **KW, interpret=True, footprint=footprint)
    x1, v = rc.rollout_soa(DriftSoA(), torch.tensor(x0), torch.tensor(c),
                           torch.tensor(obs), **KW, footprint=footprint)
    np.testing.assert_array_equal(v.numpy(), np.asarray(wv))
    np.testing.assert_allclose(x1.numpy(), np.asarray(wx1), atol=1e-5, rtol=0)


def test_a_system_with_hooks_but_no_struct_takes_the_generic_route():
    """SoA hooks admit a system to the JAX kernel; in the port only a device
    struct admits it to the kernels. Without one, ``auto`` is the generic
    step, which rounds as the twin does."""
    cfg = ct.KGMTConfig(**SMALL)
    soa = ct.KGMT(cfg, system=DriftSoA(), device="cpu").plan(ct.Scenario.demo(), seed=0)
    plain = ct.KGMT(cfg, system=Drift(), device="cpu").plan(ct.Scenario.demo(), seed=0)
    assert soa.metrics["rollout"] == plain.metrics["rollout"] == "generic"
    assert (soa.iterations, soa.tree_size) == (plain.iterations, plain.tree_size)
    np.testing.assert_array_equal(soa.state.tree_samples.numpy(),
                                  plain.state.tree_samples.numpy())
    x0, c = drift_batch(256, 5)
    x0, c, obs = torch.tensor(x0), torch.tensor(c), torch.tensor(OBS)
    x1, v = rc.rollout_soa(DriftSoA(), x0, c, obs, **KW)
    px1, pv = rollout_batch(DriftSoA(), x0, c, 10, obs, 20.0, 20.0)
    assert torch.equal(x1, px1) and torch.equal(v, pv)


def test_routes_of_every_kind_of_system():
    for name in ("bicycle", "point2d", "double_integrator", "unicycle", "dubins"):
        assert rc.rollout_route(get_system(name), "cuda") == "kernel"
    assert rc.rollout_route(BicycleCopy(), "cuda_rng") == "kernel"
    assert rc.rollout_route(DriftStruct(), "cuda") == "kernel"
    for system in (Drift(), DriftSoA()):
        assert rc.rollout_route(system, "auto") == "generic"
        assert rc.rollout_route(system, "torch") == "generic"
        for backend in ("cuda", "cuda_rng"):
            with pytest.raises(NotImplementedError, match="'auto'.*'torch'"):
                rc.rollout_route(system, backend)


# -- the kernel backends refuse a system without a device struct ---------------

@pytest.mark.parametrize("backend", ["cuda", "cuda_rng"])
def test_kernel_backends_refuse_a_system_without_a_struct(backend):
    cfg = ct.KGMTConfig(**SMALL, rollout_backend=backend)
    for system in (Drift(), DriftSoA()):
        with pytest.raises(NotImplementedError, match="no device struct.*'auto'"):
            ct.KGMT(cfg, system=system, device="cpu").plan(ct.Scenario.demo())
        with pytest.raises(NotImplementedError, match="no device struct"):
            MultiQueryPlanner(cfg, system=system, device="cpu").plan_scenarios(
                [ct.Scenario.demo()] * 2)


def test_wrappers_refuse_a_system_without_a_struct_on_the_cpu():
    x0, c = drift_batch(8, 6)
    x0, c, obs = torch.tensor(x0), torch.tensor(c), torch.tensor(OBS)
    key = rng.key(0)
    calls = [
        lambda: rc.rollout_cuda(DriftSoA(), x0, c, obs, **KW),
        lambda: rc.rollout_batched_cuda(DriftSoA(), x0[None], c[None], obs[None], **KW),
        lambda: rc.sample_and_rollout_cuda(DriftSoA(), key, x0, obs, **KW),
        lambda: rc.sample_and_rollout_batched_cuda(DriftSoA(), key[None], x0[None],
                                                   obs[None], **KW),
    ]
    for call in calls:
        with pytest.raises(NotImplementedError, match="no device struct"):
            call()
    # a struct's system goes through the twin here
    x1, v = rc.rollout_cuda(DriftStruct(), x0, c, obs, **KW)
    px1, pv = rc.rollout_soa(DriftStruct(), x0, c, obs, **KW)
    assert torch.equal(x1, px1) and torch.equal(v, pv)


def test_post_processing_of_a_hookless_path_takes_the_generic_rollout():
    """Shortcutting and refinement's revalidation launch B1/B6 on the system
    they are given; a system without a struct replays through its step."""
    from cudasbmp_torch.refine import RefineConfig, refine_path

    cfg = ct.KGMTConfig(num_iterations=20)
    sc = ct.Scenario.demo()
    r = ct.KGMT(cfg, system=Drift(), device="cpu").plan(sc, seed=0)
    assert r.solved
    out = shortcut_path(Drift(), cfg, r.path, sc.goal, sc.obstacles,
                        ShortcutConfig(rounds=4, candidates=64), device="cpu")
    assert out["cost_after"] <= out["cost_before"] == pytest.approx(r.cost, rel=1e-5)
    ref = refine_path(Drift(), cfg, r.path, sc.goal, sc.obstacles,
                      RefineConfig(iterations=3), device="cpu")
    assert np.isfinite(ref["losses"]).all()
    with pytest.raises(NotImplementedError, match="no device struct"):
        shortcut_path(Drift(), dataclasses.replace(cfg, rollout_backend="cuda"),
                      r.path, sc.goal, sc.obstacles, ShortcutConfig(rounds=1),
                      device="cpu")


# -- the registry ---------------------------------------------------------------

def test_registered_system_reaches_every_planner_and_the_cli(registered, capsys):
    name = registered(Drift)
    assert name in available_systems() and get_system(name) == Drift()
    cfg = ct.KGMTConfig(**SMALL, system=name)
    got = ct.KGMT(cfg, device="cpu").plan(ct.Scenario.demo(), seed=2)
    want = ct.KGMT(ct.KGMTConfig(**SMALL), system=Drift(), device="cpu").plan(
        ct.Scenario.demo(), seed=2)
    assert (got.iterations, got.tree_size, got.metrics["rollout"]) == (
        want.iterations, want.tree_size, "generic")
    np.testing.assert_array_equal(got.state.tree_samples.numpy(),
                                  want.state.tree_samples.numpy())

    batch = MultiQueryPlanner(cfg, device="cpu").plan_scenarios([ct.Scenario.demo()] * 2)
    direct = MultiQueryPlanner(ct.KGMTConfig(**SMALL), system=Drift(),
                               device="cpu").plan_scenarios([ct.Scenario.demo()] * 2)
    np.testing.assert_array_equal(batch.tree_sizes, direct.tree_sizes)
    np.testing.assert_array_equal(batch.iterations, direct.iterations)

    rc_, out = cli.main(["plan", "--configurations", str(REPO / "configurations"),
                         "--system", name, "--device", "cpu", "--seed", "2",
                         "--max-tree-size", "2048", "--rollouts-per-iter", "256",
                         "--num-iterations", "5"]), capsys.readouterr().out
    summary = out[out.index("{\n"):]
    summary = json.loads(summary[:summary.index("\n}") + 2])

    scenario, grid = load_scenario(str(REPO / "configurations"))
    grid = {k: v for k, v in grid.items() if v is not None}
    want = summarize_result(ct.KGMT(cfg.replace(**grid), device="cpu").plan(scenario,
                                                                          seed=2))
    for k in ("solved", "cost", "iterations", "tree_size", "path_length", "valid_rollouts"):
        assert summary[k] == want[k], k
    assert rc_ == (0 if want["solved"] else 1)


def test_a_name_shadowing_a_builtin_keys_the_user_struct(registered):
    registered(BicycleCopy, "bicycle")
    cfg = ct.KGMTConfig(**SMALL)
    planner = ct.KGMT(cfg, device="cpu")
    assert type(planner.system) is BicycleCopy
    assert planner.system.cuda_param == cfg.agent_length
    # the kernels it would launch: kUser in its own library, not the
    # built-in bicycle's id
    assert rc.kernel_system(planner.system, "its rollout") == (
        rc.USER_SYSTEM_ID, cfg.agent_length, BICYCLE_STRUCT)
    assert rc.kernel_system(get_system("car"), "its rollout") == (
        rc.SYSTEM_IDS[type(get_system("car"))], cfg.agent_length, None)
    # on the CPU its twin is the bicycle's own hooks: the built-in's solve
    got = planner.plan(ct.Scenario.demo(), seed=1)
    registry._REGISTRY["bicycle"] = ct.systems.KinematicBicycle
    want = ct.KGMT(cfg, device="cpu").plan(ct.Scenario.demo(), seed=1)
    assert got.metrics["rollout"] == want.metrics["rollout"] == "kernel"
    assert (got.solved, got.iterations, got.tree_size, got.cost) == (
        want.solved, want.iterations, want.tree_size, want.cost)


# -- the device-struct contract and the pure parts of its build -------------------

@dataclasses.dataclass(frozen=True)
class _NoHeading(BicycleCopy):
    cuda_struct = BICYCLE_STRUCT.replace("kHeading = true", "kHeading = false")


@dataclasses.dataclass(frozen=True)
class _NotFast(DriftStruct):
    cuda_struct = DriftStruct.cuda_struct.replace("kFast = false", "kFast = true")


@dataclasses.dataclass(frozen=True)
class _NoHooks(Drift):
    cuda_struct = DriftStruct.cuda_struct


@dataclasses.dataclass(frozen=True)
class _ThreeStates(DriftStruct):
    state_dim: int = 3


@dataclasses.dataclass(frozen=True)
class _Unnamed(DriftStruct):
    cuda_struct = DriftStruct.cuda_struct.replace("UserSystem", "Drift")


@dataclasses.dataclass(frozen=True)
class _Twice(DriftStruct):
    cuda_struct = DriftStruct.cuda_struct + "constexpr bool kFast = false;"


@pytest.mark.parametrize("system,match", [
    (_NoHeading(), "kHeading = False but heading_index = 2"),
    (_NotFast(), "kFast = True but the fast hooks are missing"),
    (_NoHooks(), "SoA hooks"),
    (_ThreeStates(), "float4 state"),
    (_Unnamed(), "struct UserSystem"),
    (_Twice(), "kFast once"),
])
def test_a_struct_that_disagrees_with_its_system_is_refused(system, match):
    with pytest.raises(ValueError, match=match):
        device_struct(system)
    with pytest.raises(ValueError, match=match):
        rc.rollout_cuda(system, torch.zeros(4, 4), torch.zeros(4, 3),
                        torch.tensor(OBS), **KW)


def test_device_struct_of_each_kind_of_system():
    assert device_struct(Drift()) is None and device_struct(DriftSoA()) is None
    assert all(device_struct(get_system(n)) is None for n in available_systems())
    assert device_struct(BicycleCopy()) == BICYCLE_STRUCT
    assert device_struct(DriftStruct()) == DriftStruct.cuda_struct
    assert "back(" in DriftStruct.cuda_struct and "back(" not in DriftNoBack.cuda_struct
    # without a card R1 is its autograd twin, which differentiates step: a
    # struct without back() refines on the CPU
    from cudasbmp_torch.ops.refine_cuda import refine_penalty_cuda

    x0, c = drift_batch(2, 7)
    ctrl = torch.tensor(c)[:, None].repeat(1, 3, 1).requires_grad_()
    loss = refine_penalty_cuda(
        DriftNoBack(), torch.tensor(x0), ctrl, torch.ones(2, 3), torch.zeros(2, 2),
        torch.tensor(OBS), num_disc=10, width=20.0, height=20.0, margin=0.1,
        goal_threshold=0.5, collision_weight=1.0, goal_weight=1.0)
    loss.sum().backward()
    assert torch.isfinite(ctrl.grad).all() and ctrl.grad.abs().sum() > 0


def test_user_library_name_follows_the_struct_text():
    a, b = BicycleCopy.cuda_struct, DriftStruct.cuda_struct
    paths = {_build.library_path(), _build.library_path(a), _build.library_path(b),
             _build.library_path(a + "\n// another comment\n")}
    assert len(paths) == 4
    assert _build.library_path(a) == _build.library_path(str(a))
    assert _build.library_path().name.startswith("libcudasbmp_kernels_")
    assert _build.library_path(a).name.startswith("libcudasbmp_user_")
    header = _build.user_header(a)
    assert a in header
    assert 'static_assert(UserSystem::kHeading == true, "UserSystem::kHeading")' in header
    assert 'static_assert(UserSystem::kFast == true, "UserSystem::kFast")' in header
    assert "kFast == false" in _build.user_header(b)


def _preprocess(text: str, defined: bool) -> str:
    """``text`` with its ``#ifdef CUDASBMP_USER_SYSTEM`` / ``#else`` /
    ``#endif`` blocks resolved (the sources' only conditionals)."""
    out, stack = [], []
    for line in text.splitlines():
        word = line.strip()
        if word.startswith("#ifdef"):
            assert word == f"#ifdef {_build.USER_MACRO}", word
            stack.append(defined)
        elif word == "#else":
            stack[-1] = not stack[-1]
        elif word.startswith("#endif"):
            stack.pop()
        elif all(stack):
            out.append(line)
    assert not stack
    return "\n".join(out)


def test_user_compile_commands_carry_the_macro_and_build_no_builtin_system():
    struct = DriftStruct.cuda_struct
    cmds = _build.compile_commands("nvcc", "/tmp/x", struct)
    assert [pathlib.Path(c[c.index("-c") + 1]).name for c in cmds] == ["rollout.cu",
                                                                      "refine.cu"]
    for c in cmds:
        assert f"-D{_build.USER_MACRO}" in c and c[c.index("-I") + 1] == "/tmp/x"
        assert all(f in c for f in _build.NVCC_FLAGS)
    builtin = _build.compile_commands("nvcc", "/tmp/x")
    assert [pathlib.Path(c[c.index("-c") + 1]).name for c in builtin] == list(_build.SOURCES)
    assert not any(f"-D{_build.USER_MACRO}" in c or "-I" in c for c in builtin)
    builtins = ("Bicycle{", "Point2D{}", "DoubleIntegrator{}", "Unicycle{}", "Dubins{}")
    for src, entry in (("rollout.cu", "int launch_system("),
                       ("refine.cu", 'extern "C" int cudasbmp_refine(')):
        text = (_build.CSRC_DIR / src).read_text()
        user, own = _preprocess(text, True), _preprocess(text, False)
        dispatch = user[user.index(entry):]
        assert "<UserSystem>(param" in dispatch
        assert not any(b in dispatch for b in builtins)
        assert f"#include <{_build.USER_HEADER}>" in user
        assert "UserSystem" not in own and _build.USER_HEADER not in own
        assert all(b in own[own.index(entry):] for b in builtins)


FAKE_NVCC = """#!{python}
import sys, time, pathlib
args = sys.argv[1:]
if {fail}:
    print("user_system.cuh(3): error: expected a ';'")
    sys.exit(2)
time.sleep(0.2)
out = pathlib.Path(args[args.index("-o") + 1])
out.write_text(" ".join(pathlib.Path(a).name for a in args if not a.startswith("-")))
"""


def _fake_nvcc(tmp_path, monkeypatch, fail: bool = False):
    nvcc = tmp_path / ("nvcc_fails" if fail else "nvcc")
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, fail=fail))
    nvcc.chmod(0o755)
    build_dir = tmp_path / "_build"
    monkeypatch.setattr(_build, "BUILD_DIR", build_dir)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    return build_dir


def test_two_builds_of_one_struct_at_once_each_find_a_whole_library(tmp_path, monkeypatch):
    """Each build compiles in a temporary directory of its own and moves the
    log, then the library, into place with os.replace: torchrun's ranks
    building one struct at once both end with the whole library and its
    log, and leave nothing else behind."""
    build_dir = _fake_nvcc(tmp_path, monkeypatch)
    struct = DriftStruct.cuda_struct
    results = []
    threads = [threading.Thread(target=lambda: results.append(_build.build(struct)))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(results) == 2 and results[0][0] == results[1][0] == \
        _build.library_path(struct)
    assert all(seconds > 0 for _, seconds, _ in results)
    lib = results[0][0]
    assert sorted(p.name for p in build_dir.iterdir()) == sorted(
        [lib.name, lib.with_suffix(".log").name])
    assert lib.read_text().endswith("lib.so rollout.o refine.o")
    # cached: no compiler runs
    assert _build.build(struct)[1] == 0.0


def test_a_struct_that_fails_to_build_raises_with_nvccs_output(tmp_path, monkeypatch):
    build_dir = _fake_nvcc(tmp_path, monkeypatch, fail=True)
    with pytest.raises(RuntimeError, match="(?s)nvcc failed.*expected a ';'"):
        _build.build(DriftStruct.cuda_struct)
    assert list(build_dir.iterdir()) == []
