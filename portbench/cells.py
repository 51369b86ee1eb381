"""Finding a cell's parts by name: ``BENCHMARK.json`` at the checkout's root
names each cell's configuration and traffic mix; the files are
``portbench/configs/<config>.json``, ``portbench/traffic/<traffic>.json``
and ``portbench/limits/<workload>.json`` (the limits of the numbers that
decide ``correct``); a traffic file names its entry,
``portbench/entries/<entry>.py`` (the kind of call it drives), and its
judge, ``portbench/judges/<judge>.py`` (the kind of answer it reads); each
metric's reader is ``portbench/end_to_end/<name>.py`` or
``portbench/metrics/<name>.py``. A later cell, configuration, traffic mix,
kind of call, kind of answer or metric is a new file and a new entry;
nothing here names one."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]  # BENCHMARK.json's entries this cell reports
    per_layer: list[dict]
    base: Path = HERE  # the directory the cell's modules are found in


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str, end_to_end: list[str]) -> bool:
    """Whether a cell reports a metric: where the metric lists its cells,
    the cell is among them; else every cell that reports the end-to-end
    metric it moves (an end-to-end metric without a list: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in end_to_end


def load_cell(name: str, root: Path = ROOT, base: Path = HERE) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({sorted(by_name)})")
    w = by_name[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if reports(m, name, [])]
    names = [m["name"] for m in e2e]
    return Cell(name=name, chips=w["chips"],
                config=load_json(root / cfg_entry["file"]),
                traffic=load_json(base / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(base / "limits" / f"{name}.json"),
                end_to_end=e2e,
                per_layer=[m for m in bench["per_layer"] if reports(m, name, names)],
                base=base)


def reader(kind: str, name: str, base: Path = HERE):
    """The module ``portbench/<kind>/<name>.py``, by its path (a name may
    hold dots)."""
    path = base / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
