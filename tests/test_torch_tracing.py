"""The span tree and counters of the port's planner loops
(cudasbmp_torch/utils/profiling.py): in the single query (tree and
pathless), the vmapped multi-query planner and the arena with a restart
round, every operator runs under a listed ``kgmt_`` phase, never with a
call or loop span innermost; ``host_read`` counts every read of the card;
the threefry ops of a wave lie under ``kgmt_rng``; a restart round's span
holds the round's iterations and identifiers; nothing is recorded without
a profiler, and a traced solve gives an untraced one's bits."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import cudasbmp_torch as ct
from cudasbmp_torch import rng
from cudasbmp_torch.parallel import MultiQueryPlanner
from cudasbmp_torch.parallel import batch_kgmt, multi_query
from cudasbmp_torch.parallel.batch_kgmt import ArenaMultiQueryPlanner
from cudasbmp_torch.planners import kgmt
from cudasbmp_torch.utils import profiling, trace_to
from cudasbmp_torch.utils.profiling import CALL_SPANS, LOOP_SPANS, PHASES, host_read

torch.set_num_threads(2)
SINGLE = dict(num_iterations=30, max_tree_size=4096, rollouts_per_iter=512)
ARENA = dict(num_iterations=6, max_tree_size=128 * 7, rollouts_per_iter=128,
             adaptive_waves=False)
BATCH = 3


def _events(fn):
    """(annotations, aten ops) of ``fn()`` traced in memory: [(start, end,
    name, thread)]."""
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        fn()
    spans, ops = [], []
    for e in prof.profiler.kineto_results.events():
        rec = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name(), e.start_thread_id())
        if e.name().startswith("aten::"):
            ops.append(rec)
        elif e.name().startswith("kgmt_"):
            spans.append(rec)
    return spans, ops


def _innermost(spans, ops) -> list[str | None]:
    """Each op's innermost enclosing span on its thread (None where none):
    one sweep over spans and ops in time order, a stack of open spans a
    thread (the spans of a thread nest)."""
    marks = sorted([(s, 0, -e, i, "span") for i, (s, e, _, _) in enumerate(spans)]
                   + [(s, 1, -e, i, "op") for i, (s, e, _, _) in enumerate(ops)])
    stacks: dict[int, list] = {}
    out: list[str | None] = [None] * len(ops)
    for start, _, neg_end, i, kind in marks:
        thread = (spans if kind == "span" else ops)[i][3]
        stack = stacks.setdefault(thread, [])
        while stack and stack[-1][0] <= start:
            stack.pop()
        if kind == "span":
            stack.append((-neg_end, spans[i][2]))
        elif stack:
            out[i] = stack[-1][1]
    return out


def _blocked_demo() -> ct.Scenario:
    """The demo with a box over its goal: no solution, so the arena runs
    every window and its restart round."""
    sc = ct.Scenario.demo()
    boxes = np.concatenate([sc.obstacles, [[1.0, 17.0, 3.0, 19.0]]]).astype(np.float32)
    return ct.Scenario(init=sc.init, goal=sc.goal, obstacles=boxes)


def _near_demo() -> ct.Scenario:
    """The demo's start and boxes with a goal close by: the arena at
    R = 128 solves it in a few iterations."""
    sc = ct.Scenario.demo()
    goal = sc.goal.copy()
    goal[0:2] = (6.0, 5.5)
    return ct.Scenario(init=sc.init, goal=goal, obstacles=sc.obstacles)


def _arena_inputs():
    scs = [_near_demo(), _blocked_demo(), _near_demo()]
    return multi_query.stack_scenarios(ct.KGMTConfig(**ARENA), scs)


def _loops():
    """name -> (planner call, the planner): the four loops the benchmark
    cells run."""
    sc = ct.Scenario.demo()
    tree = ct.KGMT(ct.KGMTConfig(**SINGLE), device="cpu")
    pathless = ct.KGMT(ct.KGMTConfig(need_path=False, **SINGLE), device="cpu")
    multi = MultiQueryPlanner(ct.KGMTConfig(**SINGLE), device="cpu")
    arena = ArenaMultiQueryPlanner(ct.KGMTConfig(**ARENA), auto_capacity=True,
                                   device="cpu")
    inits, goals, boxes = _arena_inputs()
    return {
        "single": lambda: tree.plan(sc, seed=3),
        "pathless": lambda: pathless.plan(sc, seed=3),
        "multi": lambda: multi.plan_scenarios([sc] * BATCH, seed=3),
        "arena": lambda: arena.plan_batch(inits, goals, boxes, seed=3, max_extensions=1),
    }


LOOPS = ("single", "pathless", "multi", "arena")


def test_the_span_lists_name_kgmt_spans_once():
    names = CALL_SPANS + LOOP_SPANS + PHASES
    assert len(set(names)) == len(names)
    assert all(n.startswith("kgmt_") for n in names)
    assert "PHASES" in profiling.__doc__


@pytest.mark.parametrize("loop", LOOPS)
def test_every_op_of_a_loop_lies_under_a_phase(loop):
    spans, ops = _events(_loops()[loop])
    assert ops
    inner = _innermost(spans, ops)
    outside = sorted({(op[2], name) for op, name in zip(ops, inner) if name not in PHASES})
    assert not outside, outside[:10]
    names = {s[2] for s in spans}
    calls = {"single": "kgmt_plan", "pathless": "kgmt_plan", "multi": "kgmt_plan_batch",
             "arena": "kgmt_plan_batch"}
    waves = {"single": "kgmt_wave", "pathless": "kgmt_wave", "multi": "kgmt_trip",
             "arena": "kgmt_iteration"}
    assert {calls[loop], waves[loop], "kgmt_rng", "kgmt_host_read",
            "kgmt_boundary"} <= names
    if loop == "arena":
        assert "kgmt_restart" in names


def _waves_of(monkeypatch, module, name):
    """A counter of the calls of ``module.name`` (once a wave)."""
    count = [0]
    fn = getattr(module, name)

    def counted(*a, **k):
        count[0] += 1
        return fn(*a, **k)

    monkeypatch.setattr(module, name, counted)
    return count


@pytest.mark.parametrize("loop, per_wave, per_call",
                         [("single", 2, 1 + 5), ("pathless", 1, 1 + 2)])
def test_host_reads_count_the_waves_and_the_calls_reads(monkeypatch, loop, per_wave,
                                                         per_call):
    """A solve reads once before its waves; a wave reads its readout, and
    in the tree loop the goal test's best lane too; the result reads five
    times (tree: cost, path length, path, nodes, threshold) or twice
    (pathless: cost, threshold)."""
    waves = _waves_of(monkeypatch, kgmt, "_wave_keys")
    call = _loops()[loop]
    profiling.reset_host_reads()
    call()
    assert waves[0] > 5
    assert host_read.reads == per_wave * waves[0] + per_call


def test_host_reads_count_one_a_trip():
    """The vmapped planner reads once before its trips, once a trip and
    five times for its result (costs, tree sizes, iterations, paths,
    lengths)."""
    planner = MultiQueryPlanner(ct.KGMTConfig(**SINGLE), device="cpu")
    profiling.reset_host_reads()
    planner.plan_scenarios([ct.Scenario.demo()] * BATCH, seed=3)
    assert planner.last_state.trips > 5
    assert host_read.reads == planner.last_state.trips + 1 + 5


def test_host_reads_count_one_an_arena_iteration(monkeypatch):
    """The arena reads whether every problem is done before each iteration
    (and once more where they are done before the budget ends), and five
    times for its result; a restart round is a call of its own."""
    inits, goals, boxes = _arena_inputs()
    solvable = [0, 2]
    planner = ArenaMultiQueryPlanner(ct.KGMTConfig(num_iterations=40, max_tree_size=128 * 41,
                                                   rollouts_per_iter=128,
                                                   adaptive_waves=False),
                                     auto_capacity=True, device="cpu")
    iters = _waves_of(monkeypatch, batch_kgmt, "arena_iteration")
    profiling.reset_host_reads()
    res = planner.plan_batch(inits[solvable], goals[solvable], boxes[solvable], seed=3)
    assert res.solved.all()
    assert 0 < iters[0] < planner.n_windows
    assert host_read.reads == iters[0] + 1 + 5
    # the blocked problem runs every window: no read after the last
    iters[0] = 0
    profiling.reset_host_reads()
    planner.plan_batch(inits[1:2], goals[1:2], boxes[1:2], seed=3)
    assert iters[0] == planner.n_windows
    assert host_read.reads == planner.n_windows + 5


def test_a_restart_rounds_span_holds_its_iterations(tmp_path):
    """With one restart round: the main round runs its windows, the round
    twice as many (the blocked problem never ends early), all of the
    round's iterations under its ``kgmt_restart`` span, which carries the
    round, bucket and windows in the Chrome trace's args."""
    inits, goals, boxes = _arena_inputs()
    planner = ArenaMultiQueryPlanner(ct.KGMTConfig(**ARENA), auto_capacity=True,
                                     device="cpu")
    with trace_to(tmp_path):
        res = planner.plan_batch(inits, goals, boxes, seed=3, max_extensions=1)
    assert res.budget_exhausted[1] and not res.solved[1]
    (path,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    (restart,) = [e for e in events if e.get("name") == "kgmt_restart"]
    n = planner.n_windows
    assert restart["args"]["round"] == 0 and restart["args"]["bucket"] == 8
    assert restart["args"]["windows"] == 2 * n
    iters = [e for e in events if e.get("name") == "kgmt_iteration"]
    inside = [e for e in iters if restart["ts"] <= e["ts"]
              and e["ts"] + e["dur"] <= restart["ts"] + restart["dur"]]
    assert len(iters) == n + 2 * n and len(inside) == 2 * n


def _rng_ops_alone(fn) -> int:
    return len(_events(fn)[1])


def _rng_ops_in(spans, ops, wave_span: str) -> int:
    """The ops under kgmt_rng in the first span ``wave_span``."""
    first = min((s for s in spans if s[2] == wave_span), key=lambda s: s[0])
    inner = _innermost(spans, ops)
    return sum(1 for op, name in zip(ops, inner)
               if name == "kgmt_rng" and first[0] <= op[0] and op[1] <= first[1])


def test_a_waves_threefry_ops_lie_under_kgmt_rng():
    """The single query's first wave: its keys, controls and acceptance
    uniforms, the ops rng.py makes for them traced alone."""
    cfg = ct.KGMTConfig(**SINGLE)
    planner = ct.KGMT(cfg, device="cpu")
    spans, ops = _events(lambda: planner.plan(ct.Scenario.demo(), seed=3))
    R = cfg.rollouts_per_iter

    def draws():
        k_ctrl, k_accept = kgmt._wave_keys(rng.key(3), 0, 0)
        planner.system.control_spec.sample(k_ctrl, (R,))
        rng.uniform(k_accept, (R,))

    key_ops = _rng_ops_alone(lambda: rng.key(3))
    assert _rng_ops_in(spans, ops, "kgmt_wave") == _rng_ops_alone(draws) - key_ops > 50


def test_a_trips_threefry_ops_lie_under_kgmt_rng():
    """The vmapped planner's first trip: each problem's wave keys, controls
    and acceptance uniforms, as rng.py makes them for the batch."""
    cfg = ct.KGMTConfig(**SINGLE)
    planner = MultiQueryPlanner(cfg, device="cpu")
    spans, ops = _events(lambda: planner.plan_scenarios([ct.Scenario.demo()] * BATCH,
                                                        seed=3))
    s = planner.last_state
    R = cfg.rollouts_per_iter

    def draws():
        k_ctrl, k_accept = multi_query._wave_keys(s)
        planner.system.control_spec.sample(k_ctrl, (R,))
        rng.uniform(k_accept, (R,))

    assert _rng_ops_in(spans, ops, "kgmt_trip") == _rng_ops_alone(draws) > 50


def test_untraced_solves_record_nothing_and_traced_ones_give_the_same_bits(monkeypatch):
    calls = _loops()
    traced = {}
    with profile(activities=[ProfilerActivity.CPU]):
        for name in ("single", "multi", "arena"):
            traced[name] = calls[name]()

    def refuse(name, ids):
        raise AssertionError(f"{name} recorded without a profiler")

    monkeypatch.setattr(profiling, "_record", refuse)
    plain = {name: calls[name]() for name in ("single", "multi", "arena")}
    a, b = traced["single"], plain["single"]
    assert a.cost == b.cost and a.iterations == b.iterations
    np.testing.assert_array_equal(a.path, b.path)
    for name in ("multi", "arena"):
        a, b = traced[name], plain[name]
        for field in ("costs", "paths", "path_lengths", "iterations", "tree_sizes"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


def test_the_chrome_trace_keeps_the_spans_identifiers(tmp_path):
    planner = ct.KGMT(ct.KGMTConfig(**SINGLE), device="cpu")
    with trace_to(tmp_path):
        planner.plan(ct.Scenario.demo(), seed=7)
    (path,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    plan = [e for e in events if e.get("name") == "kgmt_plan"]
    assert len(plan) == 1
    assert plan[0]["args"]["seed"] == 7 and plan[0]["args"]["problems"] == 1
    waves = [e["args"] for e in events if e.get("name") == "kgmt_wave"]
    assert waves[0]["itr"] == 0 and waves[0]["w"] == 0
    assert len({(w["itr"], w["w"]) for w in waves}) == len(waves) > 5
