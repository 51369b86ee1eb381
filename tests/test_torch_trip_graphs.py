"""The vmapped planner's fixed tensors (cudasbmp_torch/parallel/
multi_query.py): a planner keeps one state, goals and boxes a batch shape
and runs every call of that shape on them, so that on a CUDA device its
trips replay from CUDA graphs captured on fixed addresses. On the CPU the
same trip body runs eagerly on the same tensors, with no graph: every
call gives what a fresh planner gives, bit for bit, whatever shapes came
before it, and the graph counters stay at 0. The card's side is
tests/test_torch_trip_graphs_cuda.py."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import cudasbmp_torch as ct
from cudasbmp_torch import rng
from cudasbmp_torch.parallel import MultiQueryPlanner, multi_query
from cudasbmp_torch.utils import profiling
from cudasbmp_torch.utils.profiling import PHASES, trip_graph

torch.set_num_threads(2)
CFG = ct.KGMTConfig(num_iterations=30, max_tree_size=4096, rollouts_per_iter=512)
FIELDS = ("solved", "costs", "tree_sizes", "iterations", "paths", "path_lengths",
          "budget_exhausted")


def _batch(B: int, seed: int, boxes: int = 5):
    """B demo starts with goals drawn near the start (most solve in a few
    iterations at CFG) and the demo's first ``boxes`` boxes."""
    sc = ct.Scenario.demo()
    r = np.random.default_rng(seed)
    inits = np.tile(sc.init, (B, 1)).astype(np.float32)
    goals = np.tile(sc.goal, (B, 1)).astype(np.float32)
    goals[:, :2] = inits[:, :2] + r.uniform(1.0, 3.0, (B, 2)).astype(np.float32)
    obstacles = ct.Scenario(init=sc.init, goal=sc.goal,
                            obstacles=sc.obstacles[:boxes]).padded_obstacles(8)[0]
    return inits, goals, obstacles


def _same(a, b) -> None:
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)


def _fresh(B: int, seed: int, plan_seed: int, boxes: int = 5):
    return MultiQueryPlanner(CFG, device="cpu").plan_batch(*_batch(B, seed, boxes),
                                                          seed=plan_seed)


def test_a_second_call_gives_a_fresh_planners_bits():
    planner = MultiQueryPlanner(CFG, device="cpu")
    first = planner.plan_batch(*_batch(3, 1), seed=4)
    kept = {f: getattr(first, f).copy() for f in FIELDS}
    second = planner.plan_batch(*_batch(3, 2), seed=9)
    assert second.solved.any()
    _same(second, _fresh(3, 2, 9))
    for f in FIELDS:  # the first call's arrays are its own
        np.testing.assert_array_equal(getattr(first, f), kept[f], err_msg=f)


def test_another_shape_then_the_first_again_stays_bitwise():
    planner = MultiQueryPlanner(CFG, device="cpu")
    planner.plan_batch(*_batch(3, 1), seed=4)
    other = planner.plan_batch(*_batch(2, 3, boxes=4), seed=5)
    again = planner.plan_batch(*_batch(3, 2), seed=9)
    _same(other, _fresh(2, 3, 5, boxes=4))
    _same(again, _fresh(3, 2, 9))


def test_a_shape_keeps_its_tensors_and_the_oldest_shape_goes():
    planner = MultiQueryPlanner(CFG, device="cpu")
    planner.plan_batch(*_batch(3, 1), seed=4)
    s = planner.last_state
    tensors = multi_query._buffers(s)
    planner.plan_batch(*_batch(3, 2), seed=9)
    assert planner.last_state is s
    assert all(getattr(s, name) is t for name, t in tensors.items())
    assert s.tree_samples.data_ptr() == s.flat_samples.data_ptr()
    for B in (2, 4):
        planner.plan_batch(*_batch(B, 5), seed=1)
    assert len(planner._fixed) == multi_query.KEPT_SHAPES == 2
    assert sorted(key[1] for key in planner._fixed) == [2, 4]


def test_the_state_fields_are_tensors_of_their_own():
    """A trip writes every field in place, so no two fields of a fresh
    state share their storage (the trees are views of the flat buffers)."""
    inits, _, _ = _batch(3, 1)
    s = multi_query.init_batch_state(CFG, MultiQueryPlanner(CFG, device="cpu").grid,
                                     torch.tensor(inits),
                                     rng.fold_in(rng.key(0), torch.arange(3)))
    own = {n: t for n, t in multi_query._buffers(s).items() if n not in multi_query._VIEWS}
    ptrs = [t.untyped_storage().data_ptr() for t in own.values()]
    assert len(set(ptrs)) == len(ptrs)


def test_the_planner_equals_the_plain_loop_field_by_field():
    """``plan_batch``'s state equals ``multi_query_solve``'s on the same
    inputs and keys, every tensor and the trip count."""
    planner = MultiQueryPlanner(CFG, device="cpu")
    planner.plan_batch(*_batch(3, 1), seed=4)  # the second call runs on kept tensors
    inits, goals, obstacles = _batch(3, 2)
    planner.plan_batch(inits, goals, obstacles, seed=9)
    want = multi_query.multi_query_solve(
        CFG, planner.system, planner.grid, torch.tensor(inits), torch.tensor(goals),
        torch.tensor(np.broadcast_to(obstacles, (3, *obstacles.shape)).copy()),
        rng.fold_in(rng.key(9), torch.arange(3)))
    got = planner.last_state
    assert got.trips == want.trips > 3
    for name, t in multi_query._buffers(want).items():
        assert torch.equal(getattr(got, name), t), name


def test_no_graph_is_captured_or_replayed_on_the_cpu():
    profiling.reset_trip_graphs()
    planner = MultiQueryPlanner(CFG, device="cpu")
    for seed in (1, 2):
        planner.plan_batch(*_batch(3, seed), seed=seed)
    assert planner.last_state.trips > 3
    assert trip_graph.captures == trip_graph.replays == 0
    assert all(fixed.graphs is None for fixed in planner._fixed.values())


def test_the_replay_phase_is_listed_once():
    assert PHASES.count("kgmt_replay") == 1
    assert "kgmt_replay" in profiling.__doc__


@pytest.mark.parametrize("calls", [1, 2])
def test_every_op_of_a_kept_shapes_trips_lies_under_a_phase(calls):
    """The first call of a shape and a later one (its state, goals and boxes
    copied into the kept tensors): no op outside a phase."""
    from test_torch_tracing import _events, _innermost

    planner = MultiQueryPlanner(CFG, device="cpu")
    for seed in range(calls - 1):
        planner.plan_batch(*_batch(3, seed), seed=seed)
    spans, ops = _events(lambda: planner.plan_batch(*_batch(3, 7), seed=7))
    inner = _innermost(spans, ops)
    outside = sorted({(op[2], name) for op, name in zip(ops, inner) if name not in PHASES})
    assert not outside, outside[:10]
    names = {s[2] for s in spans}
    assert {"kgmt_trip", "kgmt_init", "kgmt_boundary", "kgmt_expand"} <= names


def test_untraced_and_traced_calls_on_kept_tensors_agree():
    planner = MultiQueryPlanner(CFG, device="cpu")
    plain = planner.plan_batch(*_batch(3, 2), seed=9)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = planner.plan_batch(*_batch(3, 2), seed=9)
    _same(plain, traced)
