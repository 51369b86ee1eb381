"""The judge of served paths: what every answer of the planner has to
satisfy, worked out again from the inputs the benchmark made.

A problem is a start, a goal and a box set; the planner answers with a
solved flag, a cost and a path of samples (x, y, theta, v, a, steering,
duration), root first, each sample the state an edge ends in and the
control that made it. For every solved answer the judge replays each edge
from its stated parent with its stated control in float64 (the system's
plain step, ``num_disc`` Euler steps) and reads:

- ``replay``: the largest gap between a stated state and the replay's end,
  each component over the scale of its rounding (the system's ``scale``:
  float32 arithmetic gives some 1e-6 of it, bfloat16 some 1e-2);
- ``boxes``: how deep the swept box of a replayed step reaches into a box
  (overlap is strict: touching is clear), over the edge's position scale;
- ``bounds``: how far a replayed step lies outside the open workspace, over
  the edge's position scale;
- ``controls``: how far a control lies outside its range;
- ``start``: the root against the start; ``goal``: the last state's
  distance past the goal radius; ``cost``: the cost against the sum of the
  durations, over max(1, cost).

The replay is the program's trajectory only to within its rounding, which
grows with the position scale: where a steering near +-pi/2 has spun the
heading to some 1e5 rad, a float32 heading moves in steps of 0.01-0.03 rad,
and a float32 edge and its float64 replay part by tenths of a unit while
both end states agree to 1e-7 of that scale. So a depth into a box or past
the workspace is read in the replay's units, over the same scale: a step
clear in the program's precision is not judged by where its float64 replay
lies.

``path_gap`` is the largest of them over every solved answer: 0 for a
served path that is exact, some 1e-6 for float32 arithmetic, far more for
a path computed in a lower precision or altered. ``unsolved_share`` counts
the answers that report no path, and ``missing`` the problems with no
answer or with one that cannot be read (a path past its buffer, a number
that is not finite).
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

EDGE_BLOCK = 1 << 15  # edges replayed at once


def system_module(name: str):
    """The plain reference of a system, ``portbench/reference/<name>.py``."""
    return importlib.import_module(f"portbench.reference.{name}")


def concat_answers(parts: list[dict]) -> dict:
    """One answer set from several: paths padded to the longest."""
    L = max(p["paths"].shape[1] for p in parts)
    out = {}
    for k in parts[0]:
        if k == "paths":
            out[k] = np.concatenate([np.pad(p[k], ((0, 0), (0, L - p[k].shape[1]), (0, 0)))
                                     for p in parts])
        else:
            out[k] = np.concatenate([p[k] for p in parts])
    return out


def _edges(ans: dict, rows: np.ndarray):
    """(problem, index) of every edge of the answers ``rows``."""
    lengths = ans["lengths"][rows].astype(np.int64)
    counts = np.maximum(lengths - 1, 0)
    prob = np.repeat(rows, counts)
    start = np.repeat(np.cumsum(counts) - counts, counts)
    idx = np.arange(counts.sum()) - start + 1
    return prob, idx


def _box_depth(p0: torch.Tensor, p1: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Depth of each step's swept box into the deepest box: p0, p1 [E, S,
    2], boxes [E, K, 4] -> [E]; 0 where it overlaps none."""
    lo, hi = torch.minimum(p0, p1)[:, :, None], torch.maximum(p0, p1)[:, :, None]
    b = boxes[:, None]
    depth = torch.stack([hi[..., 0] - b[..., 0], b[..., 2] - lo[..., 0],
                         hi[..., 1] - b[..., 1], b[..., 3] - lo[..., 1]], -1)
    return depth.amin(-1).clamp(min=0).amax(dim=(1, 2))


def judge(ans: dict, cfg: dict) -> dict:
    """The numbers of the answer set ``ans`` (``init``, ``goal`` [N, 7],
    ``boxes`` [N, K, 4], ``solved`` [N], ``cost`` [N], ``paths`` [N, L, 7],
    ``lengths`` [N]; ``attempted``, the problems asked) under the planner
    configuration ``cfg``; see the module docstring."""
    ref = system_module(cfg["system"])
    n_dim = ref.STATE_DIM
    N = len(ans["solved"])
    attempted = int(ans.get("attempted", N))
    L = ans["paths"].shape[1]
    lengths = ans["lengths"].astype(np.int64)
    solved = ans["solved"].astype(bool)
    readable = (lengths >= 1) & (lengths <= L) & np.isfinite(ans["cost"])
    rows = np.flatnonzero(solved & readable)
    used = np.arange(L)[None, :] < lengths[rows, None]
    finite = np.isfinite(ans["paths"][rows]).all(-1) | ~used
    bad = rows[~finite.all(-1)]
    rows = np.setdiff1d(rows, bad)
    missing = max(attempted - N, 0) + int((solved & ~readable).sum()) + bad.size
    gaps = dict.fromkeys(("replay", "boxes", "bounds", "controls", "start", "goal",
                          "cost"), 0.0)
    if rows.size:
        f64 = torch.float64
        paths = torch.as_tensor(ans["paths"])
        init = torch.as_tensor(ans["init"][rows, :n_dim], dtype=f64)
        gaps["start"] = float((paths[rows, 0, :n_dim].to(f64) - init).abs().max())
        last = paths[rows, lengths[rows] - 1].to(f64)
        goal = torch.as_tensor(ans["goal"][rows], dtype=f64)
        dist = (last[:, :2] - goal[:, :2]).norm(dim=-1)
        gaps["goal"] = float((dist - cfg["goal_threshold"]).clamp(min=0).max())
        duration = torch.where(torch.arange(L)[None, :] < torch.as_tensor(lengths[rows])[:, None],
                               paths[rows, :, -1].to(f64), 0.0)[:, 1:].sum(-1)
        cost = torch.as_tensor(ans["cost"][rows], dtype=f64)
        gaps["cost"] = float(((cost - duration).abs() / cost.abs().clamp(min=1)).max())
        lo = torch.tensor(ref.CONTROL_LO, dtype=f64)
        hi = torch.tensor(ref.CONTROL_HI, dtype=f64)
        prob, idx = _edges(ans, rows)
        boxes_all = torch.as_tensor(ans["boxes"], dtype=f64)
        for s in range(0, prob.size, EDGE_BLOCK):
            p, i = torch.as_tensor(prob[s:s + EDGE_BLOCK]), torch.as_tensor(idx[s:s + EDGE_BLOCK])
            parent = paths[p, i - 1, :n_dim].to(f64)
            sample = paths[p, i].to(f64)
            control = sample[:, n_dim:]
            states = ref.edge_states(parent, control, cfg["num_disc"], cfg["agent_length"])
            scale = ref.scale(states, control)
            gap = (sample[:, :n_dim] - states[:, -1]).abs() / scale
            gaps["replay"] = max(gaps["replay"], float(gap.max()))
            gaps["controls"] = max(gaps["controls"], float(
                torch.maximum(lo - control, control - hi).clamp(min=0).max()))
            xy = states[:, 1:, :2]
            out = torch.stack([-xy[..., 0], xy[..., 0] - cfg["width"],
                               -xy[..., 1], xy[..., 1] - cfg["height"]], -1)
            pos = scale[:, 0]  # the replay places an edge's steps to within this
            gaps["bounds"] = max(gaps["bounds"], float(
                (out.clamp(min=0).amax(dim=(1, 2)) / pos).max()))
            gaps["boxes"] = max(gaps["boxes"], float(
                (_box_depth(states[:, :-1, :2], states[:, 1:, :2], boxes_all[p]) / pos).max()))
    return {"path_gap": max(gaps.values()),
            "unsolved_share": float((~solved).sum() + max(attempted - N, 0)) / max(attempted, 1),
            "missing": missing, "gaps": gaps, "solved_paths": int(rows.size)}


def lower_precision(ans: dict, cfg: dict, dtype=torch.bfloat16) -> dict:
    """The control: the same answers with every solved path's states
    computed by the reference in ``dtype`` (chained from the start with the
    stated controls), as a planner that integrated in that precision would
    serve them."""
    ref = system_module(cfg["system"])
    n_dim = ref.STATE_DIM
    out = {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in ans.items()}
    lengths = ans["lengths"].astype(np.int64)
    paths = torch.as_tensor(ans["paths"])
    rows = np.flatnonzero(ans["solved"] & (lengths >= 2))
    if rows.size == 0:
        return out
    state = paths[rows, 0, :n_dim].to(dtype)
    new = paths[rows].clone()
    for i in range(1, int(lengths[rows].max())):
        live = torch.as_tensor(lengths[rows] > i)
        nxt = ref.edge_states(state, paths[rows, i, n_dim:].to(dtype), cfg["num_disc"],
                              cfg["agent_length"])[:, -1]
        state = torch.where(live[:, None], nxt, state)
        new[:, i, :n_dim] = torch.where(live[:, None], state.float(), new[:, i, :n_dim])
    out["paths"][rows] = new.numpy()
    return out
