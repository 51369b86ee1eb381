"""Cells of the benchmark cut to a size the CPU runs in seconds, and a
run of one on the CPU with the timed path changed by a hook: the harness's
look for a card skipped, everything else as a run."""

from __future__ import annotations

import argparse
import copy

from portbench import cells, run


def tiny(name: str, **planner) -> cells.Cell:
    cell = copy.deepcopy(cells.load_cell(name))
    p = cell.config["planner"]
    p.update(max_tree_size=16384, rollouts_per_iter=2048)
    p.update(planner)
    if "batch" in cell.traffic:
        cell.traffic["batch"] = 4
    cell.traffic["trace_calls"] = 1
    return cell


def cpu_run(cell: cells.Cell, seed: int = 2**31 + 7, seconds: float = 0.5, wrap=None,
            trace: int = 0):
    """(result line, check lines)."""
    import torch

    torch.set_num_threads(1)
    args = argparse.Namespace(workload=cell.name, seed=seed, seconds=seconds, trace=trace)
    hooks = {"device": "cpu"}
    if wrap is not None:
        hooks["wrap"] = wrap
    part = run.run_once(args, cell, hooks=hooks)
    return run.result(args, cell, part, {"platform": "cpu", "kind": "cpu", "count": 1})
