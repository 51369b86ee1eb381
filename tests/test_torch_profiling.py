"""The port's tracing and timing (cudasbmp_torch/utils/profiling.py): a
``trace_to`` trace file appears and names the planners' phases under the
JAX package's scope names; ``phase_scope`` records nothing while no
profiler runs; ``Timer`` reads the wall."""

import json
import time

import torch

import cudasbmp_torch as ct
from cudasbmp_torch.parallel import ShardedTreePlanner, make_planner_mesh
from cudasbmp_torch.utils import Timer, phase_scope, trace_to

torch.set_num_threads(2)
SHARDED = dict(num_iterations=60, max_tree_size=2048, rollouts_per_iter=512,
               adaptive_waves=False)


def _traced_names(log_dir) -> set[str]:
    files = list(log_dir.glob("*.pt.trace.json"))
    assert len(files) == 1, files
    events = json.loads(files[0].read_text())["traceEvents"]
    return {e.get("name") for e in events if e.get("cat") == "user_annotation"}


def test_single_solve_trace_names_the_wave_phases(tmp_path):
    """The single query's flat loop: the JAX kgmt_run's scopes."""
    planner = ct.KGMT(ct.KGMTConfig(max_tree_size=16384, rollouts_per_iter=2048),
                      device="cpu")
    with trace_to(tmp_path):
        r = planner.plan(ct.Scenario.demo())
    assert r.solved
    assert {"kgmt_scores", "kgmt_expand", "kgmt_region_stats", "kgmt_commit",
            "kgmt_goal"} <= _traced_names(tmp_path)


def test_sharded_trace_names_the_iteration_phases(tmp_path):
    """The sharded iteration: kgmt_scores, kgmt_frontier,
    kgmt_frontier_exchange and kgmt_waves (cudasbmp_tpu/planners/kgmt.py:
    587-672), the wave phases inside the last."""
    planner = ShardedTreePlanner(ct.KGMTConfig(**SHARDED),
                                 mesh=make_planner_mesh(n_tree=2, device="cpu"))
    with trace_to(tmp_path / "trace"):
        planner.plan(ct.Scenario.demo())
    names = _traced_names(tmp_path / "trace")
    assert {"kgmt_scores", "kgmt_frontier", "kgmt_frontier_exchange", "kgmt_waves",
            "kgmt_expand", "kgmt_commit"} <= names


def test_recorded_solve_names_frontier_and_waves(tmp_path):
    planner = ct.KGMT(ct.KGMTConfig(num_iterations=3, max_tree_size=2048,
                                    rollouts_per_iter=512), device="cpu")
    with trace_to(tmp_path / "trace"):
        planner.plan_recorded(ct.Scenario.demo(), tmp_path / "rec", dump_every=10)
    assert {"kgmt_scores", "kgmt_frontier", "kgmt_waves"} <= _traced_names(tmp_path / "trace")


def test_phase_scope_records_only_under_a_profiler(tmp_path):
    with phase_scope("outside"):
        pass
    with trace_to(tmp_path):
        with phase_scope("inside"):
            torch.ones(4).sum()
    names = _traced_names(tmp_path)
    assert "inside" in names and "outside" not in names


def test_timer_reads_the_wall():
    with Timer() as t:
        time.sleep(0.01)
    assert t.elapsed_s >= 0.01
    with Timer() as t2:
        x = torch.ones(8) * 2
        assert t2.stop(x) >= 0.0
    assert t2.elapsed_s is not None
