"""The vmapped planner's trip on the card as two CUDA graphs around its
eager rollout launch (cudasbmp_torch/parallel/multi_query.py::TripGraphs):
``MultiQueryPlanner.plan_batch`` equals the plain eager loop
(``multi_query_solve``) on the same inputs and keys in every field of the
state and of the result, under ``auto``, ``cuda_rng``, a user's device
struct and a system on the generic rollout; the rollout wrapper still
counts one launch a trip; a planner captures once a batch shape and
replays one pair of graphs a trip. Every test here is marked ``cuda`` and
skips without a GPU; the file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_trip_graphs_cuda.py
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import cudasbmp_torch as ctt
from cudasbmp_torch import rng
from cudasbmp_torch.config import Scenario
from cudasbmp_torch.ops import rollout_cuda as rc
from cudasbmp_torch.parallel import MultiQueryPlanner, multi_query
from cudasbmp_torch.parallel.batch_kgmt import arena_extract_paths
from cudasbmp_torch.parallel.multi_query import stack_scenarios
from cudasbmp_torch.utils import profiling
from cudasbmp_torch.utils.profiling import trip_graph
from torch_user_systems import Drift, DriftStruct

pytestmark = pytest.mark.cuda
B = 64


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _fleet(cfg: ctt.KGMTConfig, batch: int, seed: int):
    """``batch`` demo pairs, each goal moved by U(-1, 1) (the CLI's multi)."""
    inits, goals, boxes = stack_scenarios(cfg, [Scenario.demo()] * batch)
    goals = goals.copy()
    goals[:, :2] += np.random.default_rng(seed).uniform(-1, 1, (batch, 2)).astype(np.float32)
    return inits, goals, boxes


def _plain(planner: MultiQueryPlanner, inits, goals, boxes, seed: int):
    """``multi_query_solve`` on ``plan_batch``'s inputs and keys."""
    dev, n = planner.device, len(inits)
    keys = rng.fold_in(rng.key(seed, dev), torch.arange(n, device=dev))
    return multi_query.multi_query_solve(
        planner.config, planner.system, planner.grid,
        torch.tensor(inits, device=dev), torch.tensor(goals, device=dev),
        torch.tensor(np.ascontiguousarray(boxes), device=dev), keys)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _check(planner: MultiQueryPlanner, inits, goals, boxes, seed: int) -> int:
    """plan_batch against the plain loop, every state tensor and result
    field to the bit; returns the trips."""
    got = planner.plan_batch(inits, goals, boxes, seed=seed)
    s = planner.last_state
    want = _plain(planner, inits, goals, boxes, seed)
    assert s.trips == want.trips > 0
    for name, t in multi_query._buffers(want).items():
        assert torch.equal(_bits(getattr(s, name)), _bits(t)), name
    _, samples, lengths = arena_extract_paths(want, planner.config.num_iterations + 1)
    costs = want.cost_to_goal.cpu().numpy()
    assert np.array_equal(got.costs.view(np.int32), costs.view(np.int32))
    assert np.array_equal(got.paths.view(np.int32), samples.cpu().numpy().view(np.int32))
    assert np.array_equal(got.path_lengths, lengths.cpu().numpy())
    assert np.array_equal(got.tree_sizes, want.tree_size.cpu().numpy().astype(np.int32))
    assert np.array_equal(got.iterations, want.itr.cpu().numpy().astype(np.int32))
    assert np.array_equal(got.solved, np.isfinite(costs))
    return s.trips


def test_the_graph_path_equals_the_plain_loop_on_four_seeds_and_another_size(dev):
    cfg = ctt.KGMTConfig()
    planner = MultiQueryPlanner(cfg, device=dev)
    profiling.reset_trip_graphs()
    trips = sum(_check(planner, *_fleet(cfg, B, seed), seed=seed) for seed in range(4))
    assert trip_graph.captures == 1 and trip_graph.replays == trips
    _check(planner, *_fleet(cfg, 24, 9), seed=9)  # another shape: captured anew
    _check(planner, *_fleet(cfg, B, 5), seed=5)  # and the first one again
    assert trip_graph.captures == 2


@pytest.mark.parametrize("backend, system", [("cuda_rng", None), ("auto", DriftStruct()),
                                             ("auto", Drift())],
                         ids=["cuda_rng", "user_struct", "generic"])
def test_the_graph_path_equals_the_plain_loop_on_every_route(dev, backend, system):
    cfg = ctt.KGMTConfig(rollout_backend=backend)
    planner = MultiQueryPlanner(cfg, system=system, device=dev)
    profiling.reset_trip_graphs()
    for seed in (1, 2):
        _check(planner, *_fleet(cfg, B, seed), seed=seed)
    assert trip_graph.captures == 1


@pytest.mark.parametrize("backend", ["auto", "cuda_rng"])
def test_the_rollout_wrapper_counts_one_launch_a_trip(dev, backend):
    cfg = ctt.KGMTConfig(rollout_backend=backend)
    planner = MultiQueryPlanner(cfg, device=dev)
    kernel = (rc.rollout_batched_cuda if backend == "auto"
              else rc.sample_and_rollout_batched_cuda)
    for seed in (3, 4):  # the first call captures
        rc.reset_launch_counts()
        planner.plan_batch(*_fleet(cfg, B, seed), seed=seed)
        assert kernel.launches == planner.last_state.trips > 10
        assert sum(w.launches for w in rc.WRAPPERS) == kernel.launches


def test_a_window_of_calls_is_one_capture_and_one_replay_pair_a_trip(dev):
    """After the warm call, no capture; a pair of graph launches and one
    rollout launch a trip, and the graphs' kernels on the card."""
    cfg = ctt.KGMTConfig()
    planner = MultiQueryPlanner(cfg, device=dev)
    planner.plan_batch(*_fleet(cfg, B, 0), seed=0)  # warm: captures
    profiling.reset_trip_graphs()
    rc.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for seed in (6, 7, 8):
            planner.plan_batch(*_fleet(cfg, B, seed), seed=seed)
        torch.cuda.synchronize()
    trips = rc.rollout_batched_cuda.launches
    assert trips > 30
    assert trip_graph.captures == 0 and trip_graph.replays == trips
    events = prof.profiler.kineto_results.events()
    host = [e.name() for e in events if e.device_type() != torch.autograd.DeviceType.CUDA]
    graph_launches = sum("GraphLaunch" in n for n in host)
    assert sum(n == "kgmt_replay" for n in host) == graph_launches == 2 * trips
    on_card = [e.name() for e in events if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert sum("rollout_kernel" in n for n in on_card) == trips
    assert sum("threefry_kernel" in n for n in on_card) >= 3 * trips
