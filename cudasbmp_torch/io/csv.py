"""Scenario CSV input and artifact dumps, numpy only (counterpart of
cudasbmp_tpu/io/csv.py).

- ``read_obstacles_csv`` reads ``xmin,ymin,xmax,ymax`` rows, every value in
  file order, four per obstacle;
- ``load_scenario`` reads a whole ``configurations/`` directory: init, goal,
  obstacles and, where present, the grid sizes numR1 (N) and numR2 (n);
- ``write_artifacts`` dumps a tree-mode planner state as the reference's 13
  CSV files, name for name.

The JAX package may format its CSVs with a native C++ writer; these files
hold the same values (``%.9g`` round-trips every float32), not the same
bytes.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from cudasbmp_torch.config import SAMPLE_DIM, KGMTConfig, Scenario


def read_sample_csv(path: str | os.PathLike) -> np.ndarray:
    """One 7-float sample row (the configurations/init and goal format),
    zero-padded or cut to SAMPLE_DIM."""
    row = np.loadtxt(path, delimiter=",", dtype=np.float32).reshape(-1)
    out = np.zeros(SAMPLE_DIM, np.float32)
    out[: min(len(row), SAMPLE_DIM)] = row[:SAMPLE_DIM]
    return out


def read_obstacles_csv(path: str | os.PathLike) -> np.ndarray:
    """Obstacle AABBs [K, 4], one ``xmin,ymin,xmax,ymax`` row each."""
    rows = np.loadtxt(path, delimiter=",", dtype=np.float32, ndmin=2)
    return rows.reshape(-1, 4)


def _read_scalar_csv(path: Path) -> int | None:
    """First value of a one-number CSV; None when the file is absent, so an
    absent file defers to the config instead of overriding it."""
    if not path.exists():
        return None
    txt = path.read_text().strip().split(",")[0].strip()
    return int(float(txt)) if txt else None


def load_scenario(config_dir: str | os.PathLike) -> tuple[Scenario, dict]:
    """(scenario, grid_params) from a ``configurations/``-layout directory;
    grid_params holds N (numR1/numR1.csv) and n (R2/numR2.csv), or None
    for a file that is absent."""
    d = Path(config_dir)
    scenario = Scenario(
        init=read_sample_csv(d / "init" / "init.csv"),
        goal=read_sample_csv(d / "goal" / "goal.csv"),
        obstacles=read_obstacles_csv(d / "obstacles" / "obstacles.csv"),
    )
    grid_params = {
        "N": _read_scalar_csv(d / "numR1" / "numR1.csv"),
        "n": _read_scalar_csv(d / "R2" / "numR2.csv"),
    }
    return scenario, grid_params


def write_csv(array, path: str | os.PathLike, cols: int = 1) -> None:
    """Write ``array`` as CSV, ``cols`` values per row."""
    np.savetxt(path, np.asarray(array).reshape(-1, cols), delimiter=",",
               fmt="%.9g")


# The artifact set the reference planner dumps, name for name.
REFERENCE_ARTIFACT_NAMES = frozenset({
    "samples.csv", "unexploredSamples.csv", "parentRelations.csv",
    "uParentIdx.csv", "G.csv", "R2Avail.csv", "R1Avail.csv", "R1Valid.csv",
    "R2Valid.csv", "R1Invalid.csv", "R2Invalid.csv", "R1Score.csv", "R1.csv",
})


def frontier_mask(state, max_tree_size: int) -> np.ndarray:
    """The reference's boolean frontier array from the contiguous range
    ``[frontier_lo, tree_size)`` the planner keeps."""
    idx = np.arange(max_tree_size)
    return (idx >= state.frontier_lo) & (idx < state.tree_size)


def write_artifacts(state, config: KGMTConfig, out_dir: str | os.PathLike,
                    extras: bool = False) -> list[str]:
    """Dump the 13 reference artifact CSVs of a tree-mode ``KGMTState``
    (the staging buffer unexploredSamples/uParentIdx is the latest wave's R
    rollouts). ``extras`` adds R2.csv (cell totals) and costs.csv. Returns
    the paths written."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    def host(t) -> np.ndarray:
        return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)

    dumps = [
        ("samples.csv", host(state.tree_samples), SAMPLE_DIM),
        ("unexploredSamples.csv", host(state.u_samples), SAMPLE_DIM),
        ("parentRelations.csv", host(state.tree_parent), 1),
        ("uParentIdx.csv", host(state.u_parent), 1),
        ("G.csv", frontier_mask(state, config.max_tree_size).astype(np.int32), 1),
        ("R2Avail.csv", host(state.r2_avail), 1),
        ("R1Avail.csv", host(state.r1_avail), 1),
        ("R1Valid.csv", host(state.r1_valid), 1),
        ("R2Valid.csv", host(state.r2_valid), 1),
        ("R1Invalid.csv", host(state.r1_invalid), 1),
        ("R2Invalid.csv", host(state.r2_invalid), 1),
        ("R1Score.csv", host(state.r1_score), 1),
        ("R1.csv", host(state.r1_total), 1),
    ]
    if extras:
        dumps += [("R2.csv", host(state.r2_total), 1),
                  ("costs.csv", host(state.costs), 1)]
    written = []
    for name, arr, cols in dumps:
        write_csv(arr, out / name, cols)
        written.append(str(out / name))
    return written
