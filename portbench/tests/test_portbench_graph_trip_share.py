"""The reader of the vmapped planner's graph counter (``graph_trip_share``):
trips replayed over trips, silent where the program has no such counter,
and reported by a traced run of the fleet cell (on the CPU, where the
planner runs its trips eagerly, as 0)."""

import sys

from portbench import cells, run
from portbench.tests._tiny import tiny
from portbench.tests.test_portbench_spans import counted_waves, traced  # noqa: F401

NAME = "graph_trip_share"


def _run() -> run.TracedRun:
    return run.TracedRun(slice=None, waves_slice=10, window_s=1.0, waves_window=10,
                         waves_total=20, solved_total=1, shape={})


def test_the_reader_is_silent_without_the_programs_counter(monkeypatch):
    monkeypatch.setitem(sys.modules, "cudasbmp_torch.utils.profiling", None)
    assert cells.reader("metrics", NAME).read(_run()) is None


def test_the_reader_gives_replays_over_rollout_launches(monkeypatch):
    from cudasbmp_torch.ops import rollout_cuda as rc
    from cudasbmp_torch.utils.profiling import trip_graph

    for w in rc.WRAPPERS:
        monkeypatch.setattr(w, "launches", 0)
    reader = cells.reader("metrics", NAME)
    assert reader.read(_run()) is None  # no trip yet
    monkeypatch.setattr(rc.rollout_batched_cuda, "launches", 60)
    monkeypatch.setattr(trip_graph, "replays", 57)
    assert reader.read(_run()) == 57 / 60


def test_only_the_fleet_cell_reports_it():
    assert NAME in {m["name"] for m in cells.load_cell("demo.fleet64").per_layer}
    assert NAME not in {m["name"] for m in cells.load_cell("demo.single").per_layer}


def test_a_traced_cpu_run_of_the_fleet_reads_no_replay(counted_waves):  # noqa: F811
    out, lines = traced(tiny("demo.fleet64"))
    assert out["correct"], lines
    assert out["metrics"][NAME]["value"] == 0.0
    assert out["metrics"][NAME]["unit"] == "trips/trip"
