"""Batched multi-query results and scenario stacking (counterpart of
cudasbmp_tpu/parallel/multi_query.py:32-65).

The JAX module's ``MultiQueryPlanner`` (``vmap`` of the whole single-query
solve) has no counterpart here yet: torch has no ``vmap`` of a loop whose
trip count depends on the data. The batched arena
(``parallel/batch_kgmt.py``) plans a batch of problems instead.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cudasbmp_torch.config import KGMTConfig, Scenario


def stack_scenarios(cfg: KGMTConfig, scenarios: list[Scenario]
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stack a scenario list into batched (inits, goals, obstacles) with one
    obstacle shape: every scenario is padded to the largest one's padded
    count (``padded_obstacles`` rounds to a multiple of 8)."""
    inits = np.stack([s.init for s in scenarios])
    goals = np.stack([s.goal for s in scenarios])
    pad_to = max(
        s.padded_obstacles(cfg.max_obstacles)[0].shape[0] for s in scenarios
    )
    obstacles = np.stack(
        [s.padded_obstacles(cfg.max_obstacles, pad_to=pad_to)[0]
         for s in scenarios]
    )
    return inits, goals, obstacles


@dataclasses.dataclass
class MultiQueryResult:
    solved: np.ndarray  # bool [B]
    costs: np.ndarray  # f32 [B] (inf where unsolved)
    tree_sizes: np.ndarray  # i32 [B]
    iterations: np.ndarray  # i32 [B]
    paths: np.ndarray  # f32 [B, L, SAMPLE_DIM]
    path_lengths: np.ndarray  # i32 [B]
    wall_time_s: float
    solves_per_sec: float
    # True where the problem is unsolved because it ran out of its iteration
    # or window budget (the reference stops silently in that case,
    # KGMT.cu:251-259)
    budget_exhausted: np.ndarray | None = None
