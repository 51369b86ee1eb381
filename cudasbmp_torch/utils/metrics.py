"""Per-iteration planner metrics rendered for people and for JSON logs
(counterpart of cudasbmp_tpu/utils/metrics.py)."""

from __future__ import annotations

import numpy as np
import torch


def iteration_metrics_table(metrics: dict) -> str:
    """ASCII table of the per-iteration planner counters."""
    fs = metrics["frontier_size"]
    rows = ["iter frontier    valid accepted tree_size accept_rate"]
    for i in range(len(fs)):
        v, a = metrics["valid"][i], metrics["accepted"][i]
        rate = a / max(int(v), 1)
        rows.append(
            f"{i:4d} {fs[i]:8d} {v:8d} {a:8d} {metrics['tree_size'][i]:9d} {rate:11.3f}"
        )
    return "\n".join(rows)


def region_entropy(r1_score) -> float:
    """Entropy of the normalised region-score distribution: how spread out
    the exploration guidance is."""
    if isinstance(r1_score, torch.Tensor):
        r1_score = r1_score.cpu().numpy()
    p = np.asarray(r1_score, np.float64)
    p = p / max(p.sum(), 1e-12)
    nz = p[p > 0]
    return float(-(nz * np.log(nz)).sum())


def summarize_result(result) -> dict:
    """Flat scalar summary of a KGMTResult, e.g. for JSON logging."""
    m = result.metrics
    valid_total = int(np.sum(m["valid"])) if len(m["valid"]) else 0
    return {
        "solved": result.solved,
        "cost": result.cost,
        "iterations": result.iterations,
        "tree_size": result.tree_size,
        "wall_time_s": result.wall_time_s,
        "path_length": int(len(result.path)),
        "valid_rollouts": valid_total,
        "valid_rollouts_per_sec": valid_total / max(result.wall_time_s, 1e-9),
        "region_entropy": region_entropy(result.state.r1_score),
    }
