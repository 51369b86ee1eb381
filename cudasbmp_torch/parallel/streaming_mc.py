"""Streaming Monte-Carlo sweeps: a fixed pool of slots, each refilled with a
fresh random scenario the moment its current one completes (counterpart of
cudasbmp_tpu/parallel/streaming_mc.py).

Semantics are the JAX module's. A slot keeps no tree, only its compacted
frontier carry (parent states and costs) and its region counts; a slot
completes when it solves or spends ``num_iterations`` waves, writes its
(cost, iterations) to the row of its scenario id, and takes the next
unassigned id while any remain. Scenario ``i`` is generated from
``fold_in(key, i)`` and searched with keys derived from (key, i, the
slot's own iteration count), never from the pool's iteration counter, so
results do not depend on the pool size, on which slot runs a scenario, or
on how the id range is partitioned (``run(id_lo=...)``). Every wave goes
through kernel B6, each slot against its own obstacle set.

A drained slot (no scenario left, ``scn_id`` -1) keeps running masked
waves, drawing from scenario 0's stream as the JAX package does
(``maximum(scn_id, 0)``): its lanes are marked invalid before any count,
acceptance or result, so nothing it draws reaches an output.

The loop runs on the host, one device read per iteration (the completed
count). ``run_sharded`` is the multi-device form: one pool for each
position of a mesh axis, over the id range ``[k*per, (k+1)*per)`` of
position k, each rank running its positions' pools; the pools share
nothing, and the union, gathered onto every rank, is bitwise the
single-pool sweep.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from cudasbmp_torch import rng
from cudasbmp_torch.config import KGMTConfig
from cudasbmp_torch.geometry.grid import RegionGrid
from cudasbmp_torch.parallel.batch_kgmt import (
    _compact_accepted,
    _gather_rows,
    _init_region_onehots,
    _rollout_wave,
    _scores,
    _wave_regions,
)
from cudasbmp_torch.parallel import collectives
from cudasbmp_torch.parallel.mesh import PlannerMesh
from cudasbmp_torch.parallel.monte_carlo import padding_boxes, pick_free, random_boxes
from cudasbmp_torch.planners.kgmt import resolve_device
from cudasbmp_torch.systems.registry import get_system

Tensor = torch.Tensor


@dataclasses.dataclass
class StreamState:
    """Pool state; field names and meanings as cudasbmp_tpu's StreamState.
    Every tensor has a leading slot axis B except the global bookkeeping;
    the global iteration counter is a host int."""

    p_x0: Tensor  # f32 [B, R, state_dim], the compacted frontier carry
    p_cost: Tensor  # f32 [B, R]
    n_parents: Tensor  # i32 [B]
    obstacles: Tensor  # f32 [B, K, 4], the slot's scenario
    init: Tensor  # f32 [B, state_dim]
    goal: Tensor  # f32 [B, 2]
    scn_id: Tensor  # i32 [B]; -1 = slot drained
    slot_it: Tensor  # i32 [B], iterations spent on the current scenario
    cost_to_goal: Tensor  # f32 [B], +inf until solved
    r1_total: Tensor  # f32 [B, NR1], exact integer counts
    r1_valid: Tensor  # f32 [B, NR1]
    r2_valid: Tensor  # f32 [B, NR1, n*n]
    next_id: Tensor  # i32 scalar: next unassigned scenario id
    n_done: Tensor  # i32 scalar: scenarios completed
    out_cost: Tensor  # f32 [num_scenarios]
    out_iters: Tensor  # i32 [num_scenarios]
    it: int  # global iteration counter
    key: Tensor  # int64 [2], threefry key data


def _gen_scenarios(cfg: KGMTConfig, grid: RegionGrid, key: Tensor, ids: Tensor,
                   num_obstacles: int, pad_to: int, state_dim: int
                   ) -> tuple[Tensor, Tensor, Tensor]:
    """A fresh scenario per id, from fold_in(key, id): obstacles
    [n, pad_to, 4] with degenerate padding rows, init [n, state_dim], goal
    [n, 2]; the construction of monte_carlo.random_scenarios."""
    margin, obstacle_max_size = 0.5, 4.0
    wh = torch.tensor([cfg.width, cfg.height], dtype=torch.float32,
                      device=key.device)
    k_o, k_i, k_g = rng.split(rng.fold_in(key, ids), 3).unbind(-2)
    k_pos, k_size = rng.split(k_o).unbind(-2)
    obstacles = torch.cat(
        [random_boxes(k_pos, k_size, num_obstacles, wh, margin, obstacle_max_size),
         padding_boxes((ids.shape[0],), pad_to - num_obstacles, key.device)], dim=1)
    init = torch.zeros((ids.shape[0], state_dim), dtype=torch.float32,
                       device=key.device)
    init[:, 0:2] = pick_free(k_i, obstacles, wh, margin)
    return obstacles, init, pick_free(k_g, obstacles, wh, margin)


def stream_init(cfg: KGMTConfig, grid: RegionGrid, key: Tensor, B: int, R: int,
                num_scenarios: int, num_obstacles: int, pad_to: int,
                state_dim: int, id_lo: int = 0) -> StreamState:
    """Slot b starts on scenario id_lo + b (drained when b >= num_scenarios).
    Scenario ids are global: pools over disjoint ranges [id_lo, id_lo +
    num_scenarios) reproduce one big pool's results bit for bit."""
    dev = key.device
    local0 = torch.arange(B, dtype=torch.int32, device=dev)
    ids0 = id_lo + local0
    obstacles, init, goal = _gen_scenarios(cfg, grid, key, ids0, num_obstacles,
                                           pad_to, state_dim)
    oh_r1, oh_r2 = _init_region_onehots(cfg, grid, init[:, 0:2])
    return StreamState(
        p_x0=init[:, None, :].expand(B, R, state_dim).contiguous(),
        p_cost=torch.zeros((B, R), dtype=torch.float32, device=dev),
        n_parents=torch.ones(B, dtype=torch.int32, device=dev),
        obstacles=obstacles, init=init, goal=goal,
        scn_id=torch.where(local0 < num_scenarios, ids0, -1),
        slot_it=torch.zeros(B, dtype=torch.int32, device=dev),
        cost_to_goal=torch.full((B,), float("inf"), dtype=torch.float32, device=dev),
        r1_total=oh_r1, r1_valid=oh_r1.clone(), r2_valid=oh_r2,
        next_id=torch.tensor(id_lo + min(B, num_scenarios), dtype=torch.int32,
                             device=dev),
        n_done=torch.zeros((), dtype=torch.int32, device=dev),
        out_cost=torch.full((num_scenarios,), float("inf"), dtype=torch.float32,
                            device=dev),
        out_iters=torch.zeros(num_scenarios, dtype=torch.int32, device=dev),
        it=0,
        key=key,
    )


def _set_rows(out: Tensor, dst: Tensor, completed: Tensor, vals: Tensor) -> Tensor:
    """``out.at[dst].set(vals, mode="drop")`` where only completed slots
    write (their ids are distinct): the others write to a spare row past
    the end, which is dropped."""
    n = out.shape[0]
    ext = torch.cat([out, out.new_zeros(1)])
    ext.scatter_(0, torch.where(completed, dst, n).long(), vals)
    return ext[:n]


def stream_iteration(cfg: KGMTConfig, system, grid: RegionGrid, R: int,
                     num_scenarios: int, num_obstacles: int, pad_to: int,
                     s: StreamState, id_lo: int = 0) -> StreamState:
    """One pool iteration: expand every live slot one wave; complete the
    slots that solved or spent their budget; refill them while scenarios
    remain. Updates ``s`` in place and returns it."""
    S = s.p_x0.shape[-1]
    dev = s.p_x0.device
    live = s.scn_id >= 0
    r1_score = _scores(cfg, s.r1_total, s.r1_valid, s.r2_valid)

    # parents: round-robin over the compacted carry
    j = (torch.arange(R, device=dev)[None, :]
         % s.n_parents.clamp(min=1)[:, None].long())
    x0 = _gather_rows(s.p_x0, j)
    pcost = _gather_rows(s.p_cost, j)

    # expansion: per-scenario streams keyed by (key, scenario id, slot_it)
    k_slot = rng.fold_in(rng.fold_in(s.key, s.scn_id.clamp(min=0)), s.slot_it)
    k_ctrl, k_accept = rng.fold_in(k_slot, 0), rng.fold_in(k_slot, 1)
    x1, controls, valid = _rollout_wave(cfg, system, x0, s.obstacles, k_ctrl)
    valid = valid & live[:, None]

    score_r, virgin = _wave_regions(cfg, grid, x1, live, valid, r1_score,
                                    s.r1_total, s.r1_valid, s.r2_valid)
    u = rng.uniform(k_accept, (R,))
    accept = valid & ((u <= score_r) | virgin)
    child_cost = pcost + controls[..., -1]

    # goal (inGoalRegion, KGMT.cu:635-638)
    dx = x1[..., 0] - s.goal[:, None, 0]
    dy = x1[..., 1] - s.goal[:, None, 1]
    in_goal = accept & (dx * dx + dy * dy < cfg.goal_threshold ** 2)
    best_cost = torch.where(in_goal, child_cost, float("inf")).amin(dim=-1)
    cost_to_goal = torch.minimum(s.cost_to_goal, best_cost)

    # frontier refresh; a stalled slot retries its frontier
    n_acc = accept.sum(dim=-1, dtype=torch.int32)
    order = _compact_accepted(accept)
    keep = (n_acc > 0) & live
    kb = keep[:, None]
    p_x0 = torch.where(kb[..., None], _gather_rows(x1, order), s.p_x0)
    p_cost = torch.where(kb, _gather_rows(child_cost, order), s.p_cost)
    n_parents = torch.where(keep, n_acc, s.n_parents)

    # completion: per-scenario rows, indexed locally (global id - id_lo)
    slot_it = torch.where(live, s.slot_it + 1, s.slot_it)
    completed = live & (torch.isfinite(cost_to_goal)
                        | (slot_it >= cfg.num_iterations))
    dst = s.scn_id - id_lo
    s.out_cost = _set_rows(s.out_cost, dst, completed, cost_to_goal)
    s.out_iters = _set_rows(s.out_iters, dst, completed, slot_it)
    n_completed = completed.sum(dtype=torch.int32)
    s.n_done = s.n_done + n_completed

    # refill: fresh global ids for completed slots while scenarios remain
    cand_id = s.next_id + torch.cumsum(completed, 0, dtype=torch.int32) - 1
    id_hi = id_lo + num_scenarios
    fresh = completed & (cand_id < id_hi)
    s.next_id = torch.clamp(s.next_id + n_completed, max=id_hi)
    s.scn_id = torch.where(completed, torch.where(fresh, cand_id, -1), s.scn_id)
    gen_ids = torch.where(fresh, cand_id, id_lo)
    g_obs, g_init, g_goal = _gen_scenarios(cfg, grid, s.key, gen_ids,
                                           num_obstacles, pad_to, S)
    oh_r1, oh_r2 = _init_region_onehots(cfg, grid, g_init[:, 0:2])
    fb = fresh[:, None]
    fb3 = fresh[:, None, None]
    s.obstacles = torch.where(fb3, g_obs, s.obstacles)
    s.init = torch.where(fb, g_init, s.init)
    s.goal = torch.where(fb, g_goal, s.goal)
    s.p_x0 = torch.where(fb3, g_init[:, None, :], p_x0)
    s.p_cost = torch.where(fb, 0.0, p_cost)
    s.n_parents = torch.where(fresh, 1, n_parents)
    s.slot_it = torch.where(fresh, 0, slot_it)
    s.cost_to_goal = torch.where(fresh, float("inf"), cost_to_goal)
    s.r1_total = torch.where(fb, oh_r1, s.r1_total)
    s.r1_valid = torch.where(fb, oh_r1, s.r1_valid)
    s.r2_valid = torch.where(fb3, oh_r2, s.r2_valid)
    s.it += 1
    return s


def stream_solve(cfg: KGMTConfig, system, grid: RegionGrid, key: Tensor,
                 B: int, R: int, num_scenarios: int, num_obstacles: int,
                 pad_to: int, id_lo: int = 0) -> StreamState:
    """Iterate until every scenario completed, or the hard cap: each
    scenario gets at most num_iterations waves, so the pool drains within
    ceil(total / B) * budget + budget iterations even at solve rate 0."""
    s = stream_init(cfg, grid, key, B, R, num_scenarios, num_obstacles,
                    pad_to, system.state_dim, id_lo=id_lo)
    cap = (num_scenarios + B - 1) // B * cfg.num_iterations + cfg.num_iterations
    while s.it < cap and int(s.n_done) < num_scenarios:
        stream_iteration(cfg, system, grid, R, num_scenarios, num_obstacles,
                         pad_to, s, id_lo=id_lo)
    return s


@dataclasses.dataclass
class StreamingMCSummary:
    num_scenarios: int
    solve_rate: float
    mean_cost_solved: float
    cost_quantiles: dict  # p10/p50/p90 over solved scenarios
    mean_iters: float
    num_budget_exhausted: int
    wall_time_s: float
    solves_per_sec: float
    costs: np.ndarray  # f32 [num_scenarios] (inf = unsolved)
    iters: np.ndarray  # i32 [num_scenarios]


class StreamingMonteCarloPlanner:
    """Host-facing streaming sweep on one device (``cuda`` unless the caller
    asks for ``cpu``). ``pool`` is the number of resident slots;
    ``cfg.num_iterations`` the per-scenario wave budget;
    ``cfg.rollouts_per_iter`` the wave width. ``mesh``, as in the JAX
    package, does not shard ``run``'s pool (every rank sweeps the whole
    range on the mesh's device); ``run_sharded`` runs one pool a position
    of a mesh axis."""

    def __init__(self, config: KGMTConfig | None = None, pool: int = 1024,
                 mesh: PlannerMesh | None = None, system=None,
                 device: torch.device | str = "cuda"):
        cfg = self.config = config or KGMTConfig()
        self.pool = pool
        self.mesh = mesh
        self.system = system or get_system(cfg.system)
        self.device = resolve_device(device if mesh is None else mesh.device)
        self.grid = RegionGrid(width=cfg.width, height=cfg.height, N=cfg.N,
                               n=cfg.n)

    def _pad_to(self, num_obstacles: int) -> int:
        cfg = self.config
        if num_obstacles > cfg.max_obstacles:
            raise ValueError(
                f"{num_obstacles} obstacles > max {cfg.max_obstacles}")
        return min(cfg.max_obstacles, max(8, -(-num_obstacles // 8) * 8))

    def run(self, num_scenarios: int, seed: int = 0, num_obstacles: int = 8,
            id_lo: int = 0) -> StreamingMCSummary:
        """Sweep scenario ids [id_lo, id_lo + num_scenarios). ``id_lo > 0``
        runs one partition of a larger sweep: its results are bitwise the
        matching slice of the unpartitioned run with the same seed."""
        cfg = self.config
        pad_to = self._pad_to(num_obstacles)
        t0 = time.perf_counter()
        final = stream_solve(cfg, self.system, self.grid,
                             rng.key(seed, self.device), self.pool,
                             cfg.rollouts_per_iter, num_scenarios,
                             num_obstacles, pad_to, id_lo=id_lo)
        costs = final.out_cost.cpu().numpy()
        iters = final.out_iters.cpu().numpy()
        return _summary(costs, iters, time.perf_counter() - t0)

    def run_sharded(self, num_scenarios: int, mesh: PlannerMesh, seed: int = 0,
                    num_obstacles: int = 8, axis: str = "scenario"
                    ) -> StreamingMCSummary:
        """The multi-device form: one independent pool of ``pool`` slots
        for each position k of ``mesh``'s ``axis``, sweeping the global ids
        [k*per, (k+1)*per), each rank its positions' pools one after the
        other on the mesh's device, the result rows gathered over the axis.
        No collective runs but that gather (slots never communicate), and
        the union is bitwise the single-pool sweep (every stream is keyed
        by global scenario id)."""
        cfg = self.config
        pad_to = self._pad_to(num_obstacles)
        n_shards = mesh.shape[axis]
        if num_scenarios % n_shards:
            raise ValueError(
                f"num_scenarios={num_scenarios} must divide evenly over "
                f"{n_shards} '{axis}' shards")
        per = num_scenarios // n_shards
        device = resolve_device(mesh.device)
        key = rng.key(seed, device)
        lo, hi = mesh.local_range(axis)
        t0 = time.perf_counter()
        finals = [stream_solve(cfg, self.system, self.grid, key, self.pool,
                               cfg.rollouts_per_iter, per, num_obstacles, pad_to,
                               id_lo=k * per) for k in range(lo, hi)]
        costs, iters = (
            collectives.axis_gather(mesh, axis, torch.cat(parts)).cpu().numpy()
            for parts in ([f.out_cost for f in finals], [f.out_iters for f in finals]))
        return _summary(costs, iters, time.perf_counter() - t0)


def _summary(costs: np.ndarray, iters: np.ndarray, wall: float) -> StreamingMCSummary:
    solved = np.isfinite(costs)
    q = (np.quantile(costs[solved], [0.1, 0.5, 0.9]).round(3).tolist()
         if solved.any() else [float("nan")] * 3)
    return StreamingMCSummary(
        num_scenarios=costs.shape[0],
        solve_rate=float(solved.mean()),
        mean_cost_solved=float(costs[solved].mean()) if solved.any()
        else float("nan"),
        cost_quantiles={"p10": q[0], "p50": q[1], "p90": q[2]},
        mean_iters=float(iters.mean()),
        num_budget_exhausted=int((~solved).sum()),
        wall_time_s=wall,
        solves_per_sec=costs.shape[0] / wall,
        costs=costs,
        iters=iters,
    )
