"""The readers of the program's own spans and counter
(``host_reads_per_wave``, ``read_wait_ms_per_wave``, ``rng_ms_per_wave``)
in a traced run of each cell on the CPU, and their silence where the
program has no such span or counter. On the CPU the
rollout wrappers run their plain twins, which count no launch, so the
tests count a launch at each wave of the loops, as the kernels do."""

import argparse

import pytest

from portbench import cells, run, spans
from portbench.tests._tiny import tiny

NEW = ("host_reads_per_wave", "read_wait_ms_per_wave", "rng_ms_per_wave")


@pytest.fixture
def counted_waves(monkeypatch):
    """Each wave of the two loops counts one launch of the wrapper the card
    would launch; the counters start from 0, as in a run's process."""
    from cudasbmp_torch.ops import rollout_cuda as rc
    from cudasbmp_torch.parallel import multi_query
    from cudasbmp_torch.planners import kgmt
    from cudasbmp_torch.utils.profiling import host_read

    for w in rc.WRAPPERS:
        monkeypatch.setattr(w, "launches", 0)
    monkeypatch.setattr(host_read, "reads", 0)
    for module, name, wrapper in ((kgmt, "_expand_rollout", rc.rollout_cuda),
                                  (multi_query, "_rollout", rc.rollout_batched_cuda)):
        def counted(*a, _fn=getattr(module, name), _w=wrapper, **k):
            _w.launches += 1
            return _fn(*a, **k)

        monkeypatch.setattr(module, name, counted)


def traced(cell):
    args = argparse.Namespace(workload=cell.name, seed=2**31 + 11, seconds=0.1, trace=1)
    part = run.run_once(args, cell, hooks={"device": "cpu"})
    return run.result(args, cell, part, {"platform": "cpu", "count": 1})


@pytest.mark.parametrize("name", ["demo.single", "demo.fleet64"])
def test_a_traced_cpu_run_reports_the_programs_spans_and_counter(counted_waves, name):
    cell = tiny(name)
    assert set(NEW) <= {m["name"] for m in cell.per_layer}
    out, lines = traced(cell)
    assert out["correct"], lines
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(NEW) <= set(m), lines
    # two reads a wave of the single query, one a trip, and a few a call
    lo = 2.0 if name == "demo.single" else 1.0
    assert lo <= m["host_reads_per_wave"] < lo + 0.5
    assert m["rng_ms_per_wave"] > 0 and m["read_wait_ms_per_wave"] > 0
    note = next(line for line in lines if line.startswith("rng_ms_per_wave: "))
    for phase in ("kgmt_rng", "kgmt_host_read", "kgmt_expand", "kgmt_boundary"):
        assert f'"{phase}"' in note


def test_the_readers_are_silent_without_the_programs_spans_and_counter(monkeypatch):
    """A program without the spans and the counter (the parent of this
    change): every new reader gives nothing and raises nothing."""
    import sys

    from portbench import trace

    monkeypatch.setitem(sys.modules, "cudasbmp_torch.utils.profiling", None)
    torch_run = run.TracedRun(slice=None, waves_slice=10, window_s=1.0, waves_window=10,
                              waves_total=20, solved_total=1, shape={})

    class Bare:
        start_ns, end_ns = 0, 100
        _annotations = trace._segments([(0, 100, trace.CALL_SPAN), (10, 20, "kgmt_expand")])

    torch_run.slice = Bare()
    for name in NEW:
        assert cells.reader("metrics", name).read(torch_run) is None, name


def test_self_time_is_the_innermost_spans_share_of_the_slice():
    from portbench import trace

    class Sliced:
        start_ns, end_ns = 5, 95
        _annotations = trace._segments([(0, 100, "call"), (10, 40, "kgmt_wave"),
                                        (12, 20, "kgmt_rng"), (30, 35, "kgmt_rng")])

    got = spans.self_ns(Sliced())
    assert got == {"call": 5 + 55, "kgmt_wave": 30 - 13, "kgmt_rng": 13}
