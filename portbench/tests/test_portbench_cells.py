"""The cell loader finds every part by name, including parts that exist
only as new files and entries."""

import json
import shutil

import pytest

from portbench import cells

NEW_METRIC = '''
def read(run):
    return 42.0
'''

# a kind of call and a kind of answer the harness has never seen: a call
# that asks the planner nothing and answers with the seed it was given
NEW_ENTRY = '''
import numpy as np


class Entry:
    problems = 3

    def __init__(self, config, traffic, device):
        self.offset = traffic["offset"]

    def inputs(self, rng):
        return {"seed": int(rng.integers(0, 1000))}

    def call(self, x):
        return {"echo": np.full(3, x["seed"] + self.offset), "seed": np.full(3, x["seed"]),
                "solved": np.ones(3, bool), "cost": np.ones(3, np.float32)}

    def launch_shape(self):
        return {}
'''

NEW_JUDGE = '''
import numpy as np


def read(answers, attempted, config):
    wrong = sum(int((a["echo"] != a["seed"] + config["offset"]).sum()) for a in answers)
    return {"wrong": wrong, "answers": 3 * len(answers)}
'''


def test_every_cell_of_the_benchmark_loads():
    bench = cells.load_json(cells.ROOT / "BENCHMARK.json")
    for w in bench["workloads"]:
        cell = cells.load_cell(w["name"])
        assert cell.chips == w["chips"] == 1
        assert {"setup_s", "solves_per_s", "cost_p50"} <= {m["name"] for m in cell.end_to_end}
        assert set(cell.limits) == {"path_gap", "unsolved_share", "missing"}
        cells.reader("entries", cell.traffic["entry"])
        assert hasattr(cells.reader("judges", cell.traffic["judge"]), "read")
        for m in cell.end_to_end:
            cells.reader("end_to_end", m["name"])
        for m in cell.per_layer:
            assert hasattr(cells.reader("metrics", m["name"]), "read")


def _new_files(tmp_path):
    """A copy of the benchmark with a new configuration, traffic mix,
    limits and metric, and a new cell on a new kind of call and answer."""
    base = tmp_path / "portbench"
    shutil.copytree(cells.HERE, base, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = cells.load_json(cells.ROOT / "BENCHMARK.json")
    config = cells.load_json(cells.HERE / "configs" / "demo.json")
    config["planner"]["fast_math"] = True
    (base / "configs" / "demo_fast.json").write_text(json.dumps(config))
    (base / "configs" / "echo.json").write_text(json.dumps({"offset": 7}))
    (base / "traffic" / "fleet8.json").write_text(json.dumps(
        {"entry": "fleet", "judge": "paths", "batch": 8, "goal_jitter": 0.5,
         "fixed_seed": 1, "trace_calls": 1}))
    (base / "traffic" / "echo3.json").write_text(json.dumps(
        {"entry": "echo", "judge": "echoes", "offset": 7, "fixed_seed": 2, "trace_calls": 1}))
    (base / "limits" / "demo_fast.fleet8.json").write_text(json.dumps(
        {"path_gap": 1e-3, "unsolved_share": 0.1, "missing": 0}))
    (base / "limits" / "echo.echo3.json").write_text(json.dumps({"wrong": 0}))
    (base / "metrics" / "answer.v2.py").write_text(NEW_METRIC)
    (base / "entries" / "echo.py").write_text(NEW_ENTRY)
    (base / "judges" / "echoes.py").write_text(NEW_JUDGE)
    for name, file in (("demo_fast", "demo_fast"), ("echo", "echo")):
        bench["configs"].append({"name": name, "source": "x", "reduced": [], "why": "x",
                                 "file": f"portbench/configs/{file}.json"})
    bench["workloads"] += [
        {"name": "demo_fast.fleet8", "config": "demo_fast", "traffic": "fleet8", "chips": 1,
         "why": "x"},
        {"name": "echo.echo3", "config": "echo", "traffic": "echo3", "chips": 1, "why": "x"}]
    bench["per_layer"].append({"name": "answer.v2", "unit": "%", "better": "higher",
                               "source": "program_counter", "layer": "x",
                               "moves": "solves_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return base


def test_a_new_configuration_traffic_and_metric_are_files_and_entries(tmp_path):
    base = _new_files(tmp_path)
    cell = cells.load_cell("demo_fast.fleet8", root=tmp_path, base=base)
    assert cell.config["planner"]["fast_math"] is True
    assert cell.traffic["batch"] == 8 and cell.base == base
    names = [m["name"] for m in cell.per_layer]
    assert "answer.v2" in names
    assert cells.reader("metrics", "answer.v2", base=base).read(None) == 42.0
    # a metric with no list of cells goes to every cell that reports what it moves
    assert "answer.v2" in [m["name"] for m in
                           cells.load_cell("demo.single", root=tmp_path, base=base).per_layer]


@pytest.mark.parametrize("offset, correct", [(7, True), (8, False)])
def test_a_new_kind_of_call_and_answer_runs_from_files_and_entries(tmp_path, offset, correct):
    """A cell on a new entry and judge runs through the harness as it is;
    its judge decides ``correct``."""
    from portbench.tests._tiny import cpu_run

    base = _new_files(tmp_path)
    cell = cells.load_cell("echo.echo3", root=tmp_path, base=base)
    cell.traffic["offset"] = offset
    out, lines = cpu_run(cell, seconds=0.05)
    assert out["correct"] is correct, lines
    assert out["attempted"] % 3 == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert lines[-1].startswith("check wrong:")


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cells.load_cell("no.such.cell")


def test_benchmark_json_keeps_to_its_limits():
    import re

    b = cells.load_json(cells.ROOT / "BENCHMARK.json")
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and len(json.dumps(b)) < 64 * 1024
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert name.match(c["name"]) and all(name.match(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert (cells.ROOT / c["file"]).is_file()
    workloads = {w["name"] for w in b["workloads"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(name.match(w[k]) for k in ("name", "config", "traffic"))
        assert 1 <= len(w["why"]) <= 200 and w["chips"] in (1, 4)
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(workloads) // 4)
    for m in b["end_to_end"] + b["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= workloads
    assert all(0.01 <= m["bound"] <= 0.25 for m in b["end_to_end"])
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
