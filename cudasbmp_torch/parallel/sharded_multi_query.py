"""Multi-query over sharded trees: B planning problems, each solved by one
logical tree sharded over the mesh's ``tree`` axis, the problem batch laid
over the ``scenario`` axis (counterpart of
cudasbmp_tpu/parallel/sharded_multi_query.py; BASELINE.json config 5 in
full).

The per-problem solve is the sharded tree's own loop
(parallel/sharded_tree.py) with a problem axis: a rank stacks its P
problems x its D_l shards of each (problem-major) on its device, as B*D
trees. Each problem's statistics are summed over its D shards only, each
has its own exchange pool, goal and termination, and a problem that is done
stays frozen while the others run on, as a problem under the JAX
package's vmapped while_loop. Every collective reduces over ``tree`` only,
so the tree-axis ranks of a scenario slot run the same trips, and the
slots run on independently. A trip is one rollout launch over the B*D*R
lanes of the rank (kernel B6, or B6's Philox form under ``cuda_rng``,
through ``multi_query.batched_wave``).

Problem b's shard d keys from ``fold_in(fold_in(key(seed), b), d)`` with
global b and d, as in the JAX package, so a problem's result is bitwise
the port's ShardedTreePlanner under the key ``fold_in(key(seed), b)``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from cudasbmp_torch import rng
from cudasbmp_torch.config import SAMPLE_DIM, KGMTConfig, Scenario
from cudasbmp_torch.geometry.grid import RegionGrid
from cudasbmp_torch.parallel import collectives
from cudasbmp_torch.parallel.mesh import PlannerMesh
from cudasbmp_torch.parallel.multi_query import stack_scenarios
from cudasbmp_torch.parallel.sharded_tree import (
    ShardedState,
    gather_trees,
    init_sharded_state,
    sharded_run,
    stitch_path,
)
from cudasbmp_torch.planners.kgmt import _synchronize, resolve_device
from cudasbmp_torch.systems.registry import get_system


@dataclasses.dataclass
class ShardedMultiQueryResult:
    solved: np.ndarray  # bool [B]
    costs: np.ndarray  # f32 [B] (inf where unsolved)
    best_shards: np.ndarray  # i32 [B]
    total_tree_sizes: np.ndarray  # i32 [B] summed over shards
    iterations: np.ndarray  # i32 [B]
    paths: list  # B stitched [L_b, SAMPLE_DIM] arrays (root -> goal)
    path_shards: list  # B [L_b] shard-owner arrays
    wall_time_s: float
    solves_per_sec: float


class ShardedMultiQueryPlanner:
    """B problems x one D-shard logical tree each on a ``('scenario',
    'tree')`` mesh, on the mesh's device (or ``device``). B must be
    divisible by the scenario-axis size."""

    def __init__(self, config: KGMTConfig | None = None,
                 mesh: PlannerMesh | None = None, system=None,
                 device: torch.device | str | None = None):
        if mesh is None:
            raise ValueError("ShardedMultiQueryPlanner requires a ('scenario', "
                             "'tree') mesh (parallel.mesh.make_planner_mesh)")
        self.config = config or KGMTConfig()
        self.mesh = mesh
        self.n_tree = mesh.shape["tree"]
        self.n_scenario = mesh.shape["scenario"]
        self.system = system or get_system(self.config.system)
        cfg = self.config
        self.grid = RegionGrid(width=cfg.width, height=cfg.height, N=cfg.N, n=cfg.n)
        self.device = resolve_device(mesh.device if device is None else device)
        self.last_state: ShardedState | None = None

    def _inputs(self, inits: np.ndarray, goals: np.ndarray, obstacles: np.ndarray
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """This rank's problems of the batch: (roots [L, SAMPLE_DIM], goals
        [P, SAMPLE_DIM], boxes [L, K, 4]), a tree's rows its problem's."""
        B, dev = inits.shape[0], self.device
        lo, hi = self.mesh.batch_range(B)
        t_lo, t_hi = self.mesh.local_range("tree")
        obstacles = np.asarray(obstacles, np.float32)
        if obstacles.ndim == 2:
            obstacles = np.broadcast_to(obstacles, (B,) + obstacles.shape)

        def per_tree(x: np.ndarray) -> torch.Tensor:
            return torch.as_tensor(
                np.repeat(np.asarray(x, np.float32)[lo:hi], t_hi - t_lo, axis=0), device=dev)

        return (per_tree(inits), torch.as_tensor(np.asarray(goals, np.float32)[lo:hi],
                                                  device=dev), per_tree(obstacles))

    def _init(self, batch: int, roots: torch.Tensor, seed: int) -> ShardedState:
        """This rank's trees of a batch at iteration 0: problem b's shard d
        keyed ``fold_in(fold_in(key(seed), b), d)`` (global b and d)."""
        dev = self.device
        lo, hi = self.mesh.batch_range(batch)
        t_lo, t_hi = self.mesh.local_range("tree")
        problem_keys = rng.fold_in(rng.key(seed, dev), torch.arange(lo, hi, device=dev))
        keys = rng.fold_in(problem_keys[:, None], torch.arange(t_lo, t_hi, device=dev))
        return init_sharded_state(self.config, self.grid, roots, keys.reshape(-1, 2),
                                  shard0=t_lo, n_problems=hi - lo)

    def plan_batch(self, inits: np.ndarray, goals: np.ndarray,
                   obstacles: np.ndarray, seed: int = 0) -> ShardedMultiQueryResult:
        """inits/goals [B, SAMPLE_DIM]; obstacles [B, K, 4] or [K, 4]
        (shared). Every shard of a problem's tree roots at that problem's
        init. Every rank returns the whole result (``last_state`` holds its
        own trees)."""
        cfg, dev, mesh = self.config, self.device, self.mesh
        B = inits.shape[0]
        roots, goal_rows, boxes = self._inputs(inits, goals, obstacles)
        _synchronize(dev)
        t0 = time.perf_counter()
        s = self._init(B, roots, seed)
        sharded_run(cfg, self.system, self.grid, goal_rows, boxes, s, mesh=mesh)
        iters = torch.tensor([s.itr if d is None else d for d in s.done_at],
                             dtype=torch.int32)
        costs, sizes, goal_nodes, parents, samples = (
            collectives.axis_gather(mesh, "scenario", gather_trees(mesh, s, x))
            .cpu().numpy()
            for x in (s.cost_to_goal, s.tree_size, s.goal_node, s.tree_parent,
                      s.tree_samples))
        iters = collectives.axis_gather(mesh, "scenario", iters.to(dev)).cpu().numpy()
        wall = time.perf_counter() - t0
        self.last_state = s
        best = np.argmin(np.where(np.isfinite(costs), costs, np.inf), axis=1)
        solved = np.isfinite(costs[np.arange(B), best])
        paths, path_shards, best_shards = [], [], np.zeros(B, np.int32)
        for b in range(B):
            if solved[b]:
                gid = int(goal_nodes[b, best[b]])
                p, ps = stitch_path(parents[b], samples[b], gid, cfg.max_tree_size)
                best_shards[b] = gid // cfg.max_tree_size
            else:
                p = np.zeros((0, SAMPLE_DIM), np.float32)
                ps = np.zeros(0, np.int32)
            paths.append(p)
            path_shards.append(ps)
        return ShardedMultiQueryResult(
            solved=solved,
            costs=costs[np.arange(B), best],
            best_shards=best_shards,
            total_tree_sizes=sizes.sum(axis=1).astype(np.int32),
            iterations=iters,
            paths=paths,
            path_shards=path_shards,
            wall_time_s=wall,
            solves_per_sec=B / wall,
        )

    def plan_scenarios(self, scenarios: list[Scenario], seed: int = 0
                       ) -> ShardedMultiQueryResult:
        inits, goals, obstacles = stack_scenarios(self.config, scenarios)
        return self.plan_batch(inits, goals, obstacles, seed=seed)
