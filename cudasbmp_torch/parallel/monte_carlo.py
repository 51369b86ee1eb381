"""Monte-Carlo planning sweeps over random obstacle scenarios (counterpart
of cudasbmp_tpu/parallel/monte_carlo.py; BASELINE config 5 per chip).

Scenario generation is deterministic from a threefry key (bitwise the JAX
package's draws, op by op): a random box field, then a start and a goal
that each take the first of 32 candidates lying outside every box. The
sweep plans them all at once, each scenario against its own box set, so
every wave runs kernel B6 (or its Philox form under ``cuda_rng``): by
default (``impl="vmap"``, as in the JAX package) in the vmapped multi-query
planner, every scenario with the whole single-query solve; with
``impl="arena"`` in one batched arena, whose ``max_extensions`` re-plans
the scenarios that exhausted their window budget.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from cudasbmp_torch import rng
from cudasbmp_torch.config import KGMTConfig
from cudasbmp_torch.geometry.aabb import point_in_any_obstacle

Tensor = torch.Tensor


def pick_free(key: Tensor, obstacles: Tensor, wh: Tensor, margin: float) -> Tensor:
    """Per key [..., 2], 32 candidate points uniform in [margin, wh -
    margin); the first outside every box of obstacles [..., K, 4], or
    candidate 0 when none is (``argmax`` of the free flags). Returns
    [..., 2]."""
    cand = rng.uniform(key, (32, 2), margin, wh - margin)
    free = ~point_in_any_obstacle(cand, obstacles[..., None, :, :])
    first = free.to(torch.int32).argmax(dim=-1)
    return cand.gather(-2, first[..., None, None].expand(*first.shape, 1, 2))[..., 0, :]


def random_boxes(k_pos: Tensor, k_size: Tensor, num_obstacles: int,
                 wh: Tensor, margin: float, obstacle_max_size: float) -> Tensor:
    """[..., num_obstacles, 4] boxes: lower corners uniform in [0, wh -
    margin), sizes uniform in [0.5, obstacle_max_size), upper corners
    clipped to the workspace."""
    lo = rng.uniform(k_pos, (num_obstacles, 2), 0.0, wh - margin)
    size = rng.uniform(k_size, (num_obstacles, 2), 0.5, obstacle_max_size)
    return torch.cat([lo, torch.minimum(lo + size, wh)], dim=-1)


def padding_boxes(lead: tuple[int, ...], n: int, device) -> Tensor:
    """Degenerate boxes (min 1, max 0) that never collide: [*lead, n, 4]."""
    pad = torch.zeros((*lead, n, 4), dtype=torch.float32, device=device)
    pad[..., 0:2] = 1.0
    return pad


def random_scenarios(key: Tensor, batch: int, config: KGMTConfig,
                     num_obstacles: int = 8, obstacle_max_size: float = 4.0,
                     margin: float = 0.5
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``batch`` random scenarios from the key data ``key`` (int64 [2]):
    (inits [B, 7], goals [B, 7], obstacles [B, pad_to, 4]) as numpy, padded
    to a multiple of 8 boxes (at most ``max_obstacles``). Computed on the
    key's device."""
    cfg = config
    if num_obstacles > cfg.max_obstacles:
        raise ValueError(f"{num_obstacles} obstacles > max {cfg.max_obstacles}")
    dev = key.device
    wh = torch.tensor([cfg.width, cfg.height], dtype=torch.float32, device=dev)
    k_obs, k_init, k_goal = (rng.split(k, batch) for k in rng.split(key, 3))
    k_pos, k_size = rng.split(k_obs).unbind(-2)
    obstacles = random_boxes(k_pos, k_size, num_obstacles, wh, margin,
                             obstacle_max_size)
    inits = torch.zeros((batch, 7), dtype=torch.float32, device=dev)
    goals = torch.zeros((batch, 7), dtype=torch.float32, device=dev)
    inits[:, 0:2] = pick_free(k_init, obstacles, wh, margin)
    goals[:, 0:2] = pick_free(k_goal, obstacles, wh, margin)
    pad_to = min(cfg.max_obstacles, max(8, -(-num_obstacles // 8) * 8))
    obstacles = torch.cat(
        [obstacles, padding_boxes((batch,), pad_to - num_obstacles, dev)], dim=1)
    return inits.cpu().numpy(), goals.cpu().numpy(), obstacles.cpu().numpy()


@dataclasses.dataclass
class MonteCarloSummary:
    num_scenarios: int
    solve_rate: float
    mean_cost_solved: float
    mean_tree_size: float
    wall_time_s: float
    solves_per_sec: float
    costs: np.ndarray
    solved: np.ndarray
    # scenarios still unsolved when their window budget ran out (0 when
    # max_extensions absorbed them all)
    num_budget_exhausted: int = 0


class MonteCarloPlanner:
    """Sweep many random scenarios on one device (``cuda`` unless the caller
    asks for ``cpu``): ``impl="vmap"`` through ``MultiQueryPlanner``,
    ``impl="arena"`` through ``ArenaMultiQueryPlanner`` (fixed-width
    waves; honours cfg.goal_bias). With ``mesh`` the scenarios go over its
    scenario axis (every rank generates the same scenarios, solves its
    share and returns the whole summary)."""

    def __init__(self, config: KGMTConfig | None = None, mesh=None,
                 impl: str = "vmap", auto_capacity: bool = False,
                 device: torch.device | str = "cuda"):
        from cudasbmp_torch.parallel.batch_kgmt import ArenaMultiQueryPlanner
        from cudasbmp_torch.parallel.multi_query import MultiQueryPlanner

        self.config = config or KGMTConfig()
        if impl == "arena":
            self.planner = ArenaMultiQueryPlanner(
                self.config, mesh=mesh, auto_capacity=auto_capacity, device=device)
        else:
            self.planner = MultiQueryPlanner(self.config, mesh=mesh, device=device)

    def run(self, num_scenarios: int, seed: int = 0, num_obstacles: int = 8,
            max_extensions: int = 0) -> MonteCarloSummary:
        inits, goals, obstacles = random_scenarios(
            rng.key(seed), num_scenarios, self.config,
            num_obstacles=num_obstacles)
        kw = {}
        if max_extensions:
            from cudasbmp_torch.parallel.batch_kgmt import ArenaMultiQueryPlanner

            if not isinstance(self.planner, ArenaMultiQueryPlanner):
                raise ValueError(
                    "max_extensions requires impl='arena' (the vmap "
                    "multi-query planner has no restart mechanism)")
            kw = {"max_extensions": max_extensions}
        t0 = time.perf_counter()
        res = self.planner.plan_batch(inits, goals, obstacles, seed=seed + 1, **kw)
        wall = time.perf_counter() - t0
        solved = res.solved
        return MonteCarloSummary(
            num_scenarios=num_scenarios,
            solve_rate=float(solved.mean()),
            mean_cost_solved=float(res.costs[solved].mean()) if solved.any()
            else float("nan"),
            mean_tree_size=float(res.tree_sizes.mean()),
            wall_time_s=wall,
            solves_per_sec=num_scenarios / wall,
            costs=res.costs,
            solved=solved,
            num_budget_exhausted=int(res.budget_exhausted.sum()),
        )
