"""The threefry kernel (csrc/threefry.cu) on the card: every mode bit for
bit the torch twin of ``rng.py`` run on the same CUDA tensors, the planners'
solves through it equal to their solves through the twin, and a wave's
draws a handful of launches. Every test here is marked ``cuda`` and skips
without a GPU; this file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_threefry_cuda.py
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import cudasbmp_torch as ctt
from cudasbmp_torch import rng
from cudasbmp_torch.config import Scenario
from cudasbmp_torch.ops import rollout_cuda as rc
from cudasbmp_torch.ops import threefry_cuda as tc
from cudasbmp_torch.parallel import MultiQueryPlanner
from cudasbmp_torch.parallel.multi_query import stack_scenarios
from cudasbmp_torch.systems.bicycle import KinematicBicycle

pytestmark = pytest.mark.cuda
B, T = 64, 4096


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _keys(dev, *batch: int) -> torch.Tensor:
    n = int(np.prod(batch)) if batch else 1
    return rng.fold_in(rng.key(17, dev), torch.arange(n, device=dev)).reshape(*batch, 2)


def _same(got, want) -> None:
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.shape == w.shape and g.dtype == w.dtype and g.device == w.device
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)


@pytest.mark.parametrize("batch", [(), (B,), (B, 3)])
@pytest.mark.parametrize("data", ["int", "past 2^32", "tensor", "int32 tensor"])
def test_fold_in_equals_the_twin(dev, batch, data):
    k = _keys(dev, *batch)
    d = {"int": 12345, "past 2^32": 2**33 + 9,
         "tensor": torch.arange(batch[-1] if batch else 7, device=dev) * 977,
         "int32 tensor": torch.arange(batch[-1] if batch else 7, device=dev,
                                      dtype=torch.int32)}[data]
    tc.reset_launch_counts()
    _same(rng.fold_in(k, d), rng.fold_in_torch(k, d))
    assert tc.fold_in_cuda.launches == 1
    # and on the CPU, the twin that the tests hold against jax.random
    cpu = d.cpu() if isinstance(d, torch.Tensor) else d
    assert torch.equal(rng.fold_in(k, d).cpu(), rng.fold_in(k.cpu(), cpu))


def test_fold_in_broadcasts_keys_against_data(dev):
    """keys [B, 1, 2] against data [T]: the sharded planner's keys."""
    k = _keys(dev, B, 1)
    d = torch.arange(5, device=dev)
    _same(rng.fold_in(k, d), rng.fold_in_torch(k, d))


@pytest.mark.parametrize("batch", [(), (B,), (B, 3)])
@pytest.mark.parametrize("num, offset", [(2, 0), (3, 0), (1024, 5), (7, 2**32 - 3)])
def test_split_equals_the_twin(dev, batch, num, offset):
    k = _keys(dev, *batch)
    _same(rng.split(k, num, offset), rng.split_torch(k, num, offset))


@pytest.mark.parametrize("batch", [(), (B,), (B, 3)])
@pytest.mark.parametrize("shape, offset", [((T, 3), 0), ((33,), 2**32 - 7),
                                           ((5, 2), 3 * 2**32 + 1)])
def test_random_bits_equal_the_twin(dev, batch, shape, offset):
    k = _keys(dev, *batch)
    _same(rng.random_bits(k, shape, offset), rng.random_bits_torch(k, shape, offset))


UNIFORM_BOUNDS = {
    "defaults": (0.0, 1.0),
    "scalars": (-3.25, 7.5),
    "tensors [2]": ("lo2", "hi2"),
    "max binds": ("hi2", -1.0),  # hi below lo: every draw is lo
    "0-d tensors": ("lo0", "hi0"),
}


@pytest.mark.parametrize("batch", [(), (B,), (B, 3)])
@pytest.mark.parametrize("bounds", UNIFORM_BOUNDS)
@pytest.mark.parametrize("offset", [0, 2**32 + 11])
def test_uniform_equals_the_twin(dev, batch, bounds, offset):
    k = _keys(dev, *batch)
    named = {"lo2": torch.tensor([0.5, -2.0], device=dev),
             "hi2": torch.tensor([19.5, 14.5], device=dev),
             "lo0": torch.tensor(0.5, device=dev), "hi0": torch.tensor(4.0, device=dev)}
    lo, hi = (named.get(b, b) for b in UNIFORM_BOUNDS[bounds])
    tc.reset_launch_counts()
    got = rng.uniform(k, (T, 2), lo, hi, offset)
    _same(got, rng.uniform_torch(k, (T, 2), lo, hi, offset))
    assert tc.uniform_cuda.launches == 1
    if bounds == "max binds":
        assert torch.equal(got, named["hi2"].expand_as(got))


def test_the_entry_refuses_2_31_outputs(dev):
    """The kernel indexes in 32 bits: a draw of 2^31 outputs is refused
    before any launch (nothing is allocated for it here)."""
    from cudasbmp_torch.ops import _build

    k = _keys(dev)
    out = torch.empty(1, device=dev)
    rc_ = _build.load().cudasbmp_threefry(
        dev.index or 0, tc.UNIFORM, k.data_ptr(), 2, 1, 1, 1, None, 0, 1, 1, 1, None, 0,
        1, 1, 1, 1, None, 0.0, 1, 1, None, 1.0, 1, 1, 1, 1, 0, 2**31, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    assert rc_ == 1  # cudaErrorInvalidValue


def test_control_sampling_equals_the_twin(dev):
    """``ControlSpec.sample`` at the demo's 4,096 and the fleet's 64 x 4,096
    lanes, and from an offset (the arena's rows)."""
    spec = KinematicBicycle().control_spec
    lo, hi = spec.bounds(dev)
    for k, shape, offset in ((_keys(dev), (T,), 0), (_keys(dev, B), (T,), 0),
                             (_keys(dev), (T,), 3 * 4096 * 7)):
        tc.reset_launch_counts()
        got = spec.sample(k, shape, offset=offset)
        _same(got, rng.scaled_uniform_torch(k, (*shape, 3), lo, hi, offset))
        _same(got, lo + rng.uniform_torch(k, (*shape, 3), offset=offset) * (hi - lo))
        assert tc.scaled_uniform_cuda.launches == 1


@pytest.mark.parametrize("itr, wave", [(0, 0), (5, 0), (5, 3)])
def test_wave_keys_equal_the_twin(dev, itr, wave):
    k = _keys(dev)
    got = rng.wave_keys(k, itr, wave)
    _same(got, tuple(t.contiguous() for t in rng.wave_keys_torch(k, itr, wave)))
    assert all(g.is_contiguous() for g in got)


def test_wave_keys_per_problem_equal_the_twin(dev):
    k = _keys(dev, B)
    itr = torch.arange(B, device=dev) % 9
    w = (torch.arange(B, device=dev) * 7) % 5
    assert bool((w == 0).any()) and bool((w > 0).any())
    tc.reset_launch_counts()
    _same(rng.wave_keys(k, itr, w), tuple(t.contiguous() for t in rng.wave_keys_torch(k, itr, w)))
    assert tc.wave_keys_cuda.launches == 1


def test_randint_is_three_launches_of_the_kernel(dev):
    k = _keys(dev, B)
    hi = torch.arange(B, device=dev) + 2
    tc.reset_launch_counts()
    got = rng.randint(k, (), 0, hi)
    assert torch.equal(got.cpu(), rng.randint(k.cpu(), (), 0, hi.cpu()))
    assert (tc.split_cuda.launches, tc.random_bits_cuda.launches) == (1, 2)


@pytest.fixture
def twin_route(monkeypatch):
    """The kernel's wrappers replaced by the twins on the same CUDA tensors."""
    def use_twins():
        monkeypatch.setattr(rng, "_kernel", lambda: SimpleNamespace(
            fold_in_cuda=rng.fold_in_torch, split_cuda=rng.split_torch,
            random_bits_cuda=rng.random_bits_torch, uniform_cuda=rng.uniform_torch,
            scaled_uniform_cuda=rng.scaled_uniform_torch,
            wave_keys_cuda=rng.wave_keys_torch))
    return use_twins


def test_a_demo_solve_through_the_kernel_equals_the_twins(dev, twin_route):
    planner = ctt.KGMT(ctt.KGMTConfig(), device="cuda")
    rc.reset_launch_counts()
    tc.reset_launch_counts()
    got = planner.plan(Scenario.demo(), seed=7)
    waves = rc.rollout_cuda.launches
    assert tc.wave_keys_cuda.launches == waves == tc.uniform_cuda.launches
    twin_route()
    rc.reset_launch_counts()
    want = planner.plan(Scenario.demo(), seed=7)
    assert got.solved and rc.rollout_cuda.launches == waves
    assert got.cost == want.cost and got.iterations == want.iterations
    assert np.array_equal(got.path, want.path)


def _fleet(seed: int):
    cfg = ctt.KGMTConfig()
    inits, goals, boxes = stack_scenarios(cfg, [Scenario.demo()] * B)
    goals = goals.copy()
    goals[:, :2] += np.random.default_rng(seed).uniform(-1, 1, (B, 2)).astype(np.float32)
    return MultiQueryPlanner(cfg, device="cuda"), inits, goals, boxes


def test_a_fleet_batch_through_the_kernel_equals_the_twins(dev, twin_route):
    planner, inits, goals, boxes = _fleet(3)
    rc.reset_launch_counts()
    got = planner.plan_batch(inits, goals, boxes, seed=11)
    trips = rc.rollout_batched_cuda.launches
    twin_route()
    rc.reset_launch_counts()
    # a planner of its own: the first one replays the trip it captured
    # through the kernel
    want = _fleet(3)[0].plan_batch(inits, goals, boxes, seed=11)
    assert rc.rollout_batched_cuda.launches == trips
    assert got.solved.all()
    for a, b in ((got.costs, want.costs), (got.paths, want.paths),
                 (got.path_lengths, want.path_lengths), (got.iterations, want.iterations)):
        assert np.array_equal(a, b)


def _launches_under_rng(run) -> tuple[int, int]:
    """(runtime launch records inside ``kgmt_rng`` spans, threefry kernel
    records on the card) of one profiled ``run``."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == "kgmt_rng")
    assert spans

    def inside(t):
        return any(s <= t <= e for s, e in spans)

    launches = sum(1 for e in events if "LaunchKernel" in e.name and inside(e.time_range.start))
    kernels = sum(1 for e in events if "threefry_kernel" in e.name
                  and e.device_type == torch.autograd.DeviceType.CUDA)
    return launches, kernels


def test_a_waves_draws_are_a_handful_of_launches(dev):
    """At most 12 launches under ``kgmt_rng`` a wave of the demo solve and a
    trip of the fleet batch (the twin made some 860-900), and the kernel's
    records on the card."""
    planner = ctt.KGMT(ctt.KGMTConfig(), device="cuda")
    planner.plan(Scenario.demo(), seed=7)  # warm
    rc.reset_launch_counts()
    launches, kernels = _launches_under_rng(lambda: planner.plan(Scenario.demo(), seed=7))
    waves = rc.rollout_cuda.launches
    assert waves > 10 and launches <= 12 * waves and kernels >= 3 * waves

    fleet, inits, goals, boxes = _fleet(5)
    fleet.plan_batch(inits, goals, boxes, seed=2)  # warm
    rc.reset_launch_counts()
    launches, kernels = _launches_under_rng(
        lambda: fleet.plan_batch(inits, goals, boxes, seed=2))
    trips = rc.rollout_batched_cuda.launches
    assert trips > 10 and launches <= 12 * trips and kernels >= 3 * trips
