"""The profiled slice's reduction: device busy time as the union of its
records, idle gaps labelled by the host activity then open, and a traced
run on the CPU end to end."""

import numpy as np

from portbench import trace
from portbench.tests._tiny import tiny


def test_union_merges_overlaps_and_keeps_gaps():
    iv = np.array([[5, 9], [0, 2], [1, 3], [8, 12], [20, 21]])
    np.testing.assert_array_equal(trace._intervals_union(iv),
                                  [[0, 3], [5, 12], [20, 21]])


def test_innermost_open_span_labels_a_time():
    spans = [(0, 100, "call"), (10, 40, "kgmt_expand"), (12, 20, "inner"),
             (50, 60, "kgmt_goal")]
    points, labels = trace._segments(spans)
    at = lambda t: trace._label_at(points, labels, t)  # noqa: E731
    assert [at(t) for t in (5, 11, 15, 30, 45, 55, 99, 150)] == [
        "call", "kgmt_expand", "inner", "kgmt_expand", "call", "kgmt_goal", "call", ""]


def test_a_traced_run_on_the_cpu():
    import argparse

    from portbench import run

    cell = tiny("demo.fleet64")
    args = argparse.Namespace(workload=cell.name, seed=2**31 + 5, seconds=0.1, trace=1)
    part = run.run_once(args, cell, hooks={"device": "cpu"})
    out, lines = run.result(args, cell, part, {"platform": "cpu", "count": 1})
    assert out["correct"], lines
    assert out["attempted"] == 4 * (len(part["window"].calls) + cell.traffic["trace_calls"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["device"]["window_s"] > 0 and out["device"]["busy_s"] == 0
    # no device record on the CPU: one gap, the slice, labelled at its middle
    label, seconds = out["breakdown"]["idle_gaps"][0]
    assert "/" in label and not label.startswith("(none)")
    assert seconds == out["device"]["window_s"]
    assert "idle_share" in out["metrics"] and list(out)[-1] == "checks"
