"""Multi-query planning: a batch of init/goal pairs, each solved by the whole
single-query KGMT solve (counterpart of cudasbmp_tpu/parallel/multi_query.py).

The JAX module ``vmap``s ``kgmt_solve`` + ``extract_path`` over the batch:
one ``while_loop`` that runs until the last problem's condition is false,
every problem with its own trip count and frozen once done. Here the same
loop is a batched single-query driver on the host. Every tensor of the
single-query state (planners/kgmt.py) that the solve reads, and of its loop
carry (the wave counter ``w``, the iteration-start frontier ``fl0``/``ts0``,
the target ``n_tgt``, the scores and the ``r2_seen`` snapshot), takes a
leading problem axis B, and each trip applies one wave of the flat (iteration x wave) loop
to every problem whose condition held at the trip's start. A frozen
problem's lanes still run (as under ``vmap``) but change nothing: its slots
are inactive, so it accepts no child and counts nothing.

Per trip, for every problem at once:

- at wave 0 of an iteration (per problem): scores, the frontier range, the
  rollout target and the ``r2_seen`` snapshot, selected per problem;
- slot ``w*R + i`` takes parent ``fl0 + (w*R + i) % max(frontier, 1)``
  (with ``goal_bias``, the first ``round(goal_bias * R)`` slots cycle over
  the problem's goal-nearest frontier nodes: a stable sort over its tree,
  ties to the lower index, as ``lax.top_k``);
- the wave's keys ``split(fold_in(fold_in(key, itr), w))``, or
  ``split(fold_in(key, itr))`` at w = 0 (cudasbmp_tpu/planners/kgmt.py:
  378-387), per problem; controls from each problem's threefry stream and
  one launch of kernel B6 for all B x R lanes (``auto``/``cuda``), or of
  B6's Philox form keyed per problem (``cuda_rng``), whose row b equals B2's
  rows under the same key; ``torch`` runs the plain exact rollout;
- region statistics as exact integer ``index_add_`` counts into [B, ...],
  acceptance from each problem's ``k_accept`` stream;
- commit: an exclusive cumsum within each problem, children to slots
  ``tree_size_b + pos`` in lane order, those past M dropped (written to a
  scratch row of their own past the trees), the goal test with the first
  lane winning ties;
- the iteration boundary (stall, frontier, ``itr``) per problem.

A trip launches the same kernels whatever B is, and reads one value back:
whether any problem is still running. Each problem's result equals the
single-query solve (planners/kgmt.py) under the key ``fold_in(key(seed),
b)``, field for field.

With a mesh (parallel/mesh.py) the batch is laid over the scenario axis:
each rank solves its problems under their global keys, with its own trips
(the problems share nothing), and the results are gathered, so every rank
returns the whole batch, bitwise the batch solved in one process.

Spans (the tree is utils/profiling.py's): ``kgmt_plan_batch`` around
``plan_batch``, ``kgmt_trip`` around each trip, the phases inside.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from cudasbmp_torch import rng
from cudasbmp_torch._math import div, row_sum
from cudasbmp_torch.config import SAMPLE_DIM, KGMTConfig, Scenario
from cudasbmp_torch.geometry.grid import RegionGrid
from cudasbmp_torch.ops.rollout import rollout_batch
from cudasbmp_torch.ops.rollout_cuda import (
    rollout_batched_cuda,
    sample_and_rollout_batched_cuda,
)
from cudasbmp_torch.parallel import collectives
from cudasbmp_torch.parallel.mesh import PlannerMesh
from cudasbmp_torch.planners.kgmt import _fresh_target, _num_waves, rollout_kind
from cudasbmp_torch.systems.registry import get_system
from cudasbmp_torch.utils.profiling import host_read, phase_scope

Tensor = torch.Tensor


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


@dataclasses.dataclass
class MultiQueryState:
    """What the single-query KGMTState holds that the solve reads, with a
    leading problem axis B, on the device, plus the flat loop's carry. The
    observability-only fields (the r2 total/valid/invalid counters, the
    staging buffer, the threshold and the per-iteration metrics) are left
    out: the JAX MultiQueryPlanner returns none of them. The trees are views
    of flat buffers that end in B*R scratch rows, where a trip writes the
    children it drops."""

    tree_samples: Tensor  # f32 [B, M, SAMPLE_DIM]
    tree_parent: Tensor  # i32 [B, M], -1 = unset
    costs: Tensor  # f32 [B, M]
    frontier_lo: Tensor  # i64 [B]
    tree_size: Tensor  # i64 [B]
    r1_total: Tensor  # i32 [B, N*N]
    r1_valid: Tensor
    r1_invalid: Tensor
    r1_avail: Tensor
    r2_avail: Tensor  # i32 [B, N*N*n*n]
    cost_to_goal: Tensor  # f32 [B], +inf until solved
    goal_node: Tensor  # i32 [B], -1 until solved
    itr: Tensor  # i64 [B]
    key: Tensor  # int64 [B, 2]
    stalled: Tensor  # bool [B]
    # the flat loop's carry (cudasbmp_tpu/planners/kgmt.py:737-787)
    w: Tensor  # i64 [B], wave within the iteration
    fl0: Tensor  # i64 [B], iteration-start frontier_lo
    ts0: Tensor  # i64 [B], iteration-start tree_size
    n_tgt: Tensor  # i64 [B], the iteration's rollout target
    r1_score: Tensor  # f32 [B, N*N], the iteration's scores
    r2_seen: Tensor  # i32 [B, N*N*n*n]
    running: Tensor  # bool [B], the loop condition
    flat_samples: Tensor  # f32 [B*M + B*R, SAMPLE_DIM], tree + scratch rows
    flat_parent: Tensor  # i32 [B*M + B*R]
    flat_costs: Tensor  # f32 [B*M + B*R]
    trips: int = 0


def init_batch_state(cfg: KGMTConfig, grid: RegionGrid, inits: Tensor,
                     keys: Tensor) -> MultiQueryState:
    """init_state for every problem: root in slot 0, its regions marked
    (KGMT.cu:85-97; a root outside the grid seeds nothing)."""
    B, dev = inits.shape[0], inits.device
    M, R = cfg.max_tree_size, cfg.rollouts_per_iter
    nr1, nr2 = cfg.num_r1, cfg.num_r2
    flat_samples = torch.zeros((B * M + B * R, SAMPLE_DIM), dtype=torch.float32,
                               device=dev)
    flat_parent = torch.full((B * M + B * R,), -1, dtype=torch.int32, device=dev)
    flat_costs = torch.zeros(B * M + B * R, dtype=torch.float32, device=dev)
    tree_samples = flat_samples[:B * M].view(B, M, SAMPLE_DIM)
    tree_samples[:, 0] = inits
    r1_0, r2_0 = grid.region_indices(inits[:, 0:2])

    def seeded(n: int, idx: Tensor) -> Tensor:
        return torch.zeros((B, n), dtype=torch.int32, device=dev).scatter_(
            1, idx.clamp(min=0).long()[:, None], (idx >= 0).to(torch.int32)[:, None])

    zero = torch.zeros(B, dtype=torch.int64, device=dev)
    r2_avail = seeded(nr2, r2_0)
    s = MultiQueryState(
        tree_samples=tree_samples,
        tree_parent=flat_parent[:B * M].view(B, M),
        costs=flat_costs[:B * M].view(B, M),
        frontier_lo=zero,
        tree_size=torch.ones(B, dtype=torch.int64, device=dev),
        r1_total=seeded(nr1, r1_0),
        r1_valid=seeded(nr1, r1_0),
        r1_invalid=torch.zeros((B, nr1), dtype=torch.int32, device=dev),
        r1_avail=seeded(nr1, r1_0),
        r2_avail=r2_avail,
        cost_to_goal=torch.full((B,), float("inf"), dtype=torch.float32, device=dev),
        goal_node=torch.full((B,), -1, dtype=torch.int32, device=dev),
        itr=zero,
        key=keys,
        stalled=torch.zeros(B, dtype=torch.bool, device=dev),
        w=zero, fl0=zero, ts0=zero, n_tgt=zero,
        r1_score=torch.ones((B, nr1), dtype=torch.float32, device=dev),
        r2_seen=r2_avail.clone(),
        running=torch.zeros(B, dtype=torch.bool, device=dev),
        flat_samples=flat_samples, flat_parent=flat_parent, flat_costs=flat_costs,
    )
    s.running = _keep_going(cfg, s)
    return s


def _keep_going(cfg: KGMTConfig, s: MultiQueryState) -> Tensor:
    """The vmapped loop's condition per problem: mid-iteration waves always
    run; between iterations the reference's termination tests
    (KGMT.cu:118-259)."""
    keep = (s.itr < cfg.num_iterations) & (s.tree_size < cfg.max_tree_size)
    if cfg.stop_on_first_solution:
        keep = keep & ~torch.isfinite(s.cost_to_goal)
    if not cfg.keep_frontier_on_stall:
        keep = keep & ~s.stalled
    return (s.w > 0) | keep


def region_scores(cfg: KGMTConfig, s: MultiQueryState) -> Tensor:
    """planners/kgmt.py::update_region_scores per problem: [B, N*N] scores
    with the same operations in the same order (the sum is ``row_sum``'s,
    whose order does not depend on B)."""
    B, n2 = s.r1_avail.shape[0], cfg.n * cfg.n
    avail = s.r1_avail != 0
    cov_r = div(s.r2_avail.reshape(B, cfg.num_r1, n2).sum(dim=-1).to(torch.float32), n2)
    valid_f = s.r1_valid.to(torch.float32)
    invalid_f = s.r1_invalid.to(torch.float32)
    free_vol = (cfg.epsilon + valid_f) / (cfg.epsilon + valid_f + invalid_f)
    count_f = s.r1_total.to(torch.float32)
    fv2 = free_vol * free_vol
    score = (fv2 * fv2) / ((1.0 + cov_r) * (1.0 + count_f * count_f))
    score = torch.where(avail, score, 0.0)
    total = row_sum(score)
    return torch.where(avail, torch.where(total > 0, score / total, 1.0), 1.0)


def _goal_biased(cfg: KGMTConfig, s: MultiQueryState, goals: Tensor,
                 parent_idx: Tensor) -> Tensor:
    """The first round(goal_bias * R) slots cycle over each problem's
    min(goal_bias_k, M) tree nodes nearest its goal among the frontier
    [fl0, ts0) (a stable sort of d2 with inf outside it: ``lax.top_k``'s
    order); a slot whose entry is padding (inf) keeps its round-robin
    parent."""
    M = cfg.max_tree_size
    n_biased = int(round(cfg.goal_bias * cfg.rollouts_per_iter))
    if n_biased == 0:
        return parent_idx
    idx = torch.arange(M, device=goals.device)
    in_frontier = (idx >= s.fl0[:, None]) & (idx < s.ts0[:, None])
    dx = s.tree_samples[..., 0] - goals[:, None, 0]
    dy = s.tree_samples[..., 1] - goals[:, None, 1]
    d2 = torch.where(in_frontier, dx * dx + dy * dy, float("inf"))
    best, near = torch.sort(d2, dim=-1, stable=True)
    j = torch.arange(n_biased, device=goals.device) % min(cfg.goal_bias_k, M)
    ok = torch.isfinite(best[:, j])
    biased = torch.where(ok, near[:, j], parent_idx[:, :n_biased])
    return torch.cat([biased, parent_idx[:, n_biased:]], dim=1)


def _wave_keys(s: MultiQueryState) -> tuple[Tensor, Tensor]:
    """(k_ctrl, k_accept) [B, 2] of each problem's wave (itr, w)."""
    key_iter = rng.fold_in(s.key, s.itr)
    key_wave = torch.where((s.w > 0)[:, None], rng.fold_in(key_iter, s.w), key_iter)
    k = rng.split(key_wave)
    return k[:, 0].contiguous(), k[:, 1].contiguous()


def _rollout(cfg: KGMTConfig, system, k_ctrl: Tensor, x0: Tensor,
             obstacles: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """One wave of every problem: x0 [B, R, S] against obstacles [B, K, 4]
    -> (x1, controls, valid). ``cuda_rng``: kernel B6's Philox form under
    each problem's control key; else controls from each key's threefry
    stream (``ControlSpec.sample``), then kernel B6 (``auto``/``cuda``) or
    the plain exact rollout (``torch``, and ``auto`` for a system without a
    device struct: ``planners/kgmt.py::rollout_kind``). The wrappers run
    their plain twins on CPU tensors."""
    kw = dict(num_disc=cfg.num_disc, width=cfg.width, height=cfg.height,
              footprint=cfg.footprint, fast_math=cfg.fast_math)
    kind = rollout_kind(cfg, system)
    if cfg.rollout_backend == "cuda_rng":
        return sample_and_rollout_batched_cuda(system, k_ctrl, x0, obstacles, **kw)
    with phase_scope("kgmt_rng", x0.device):
        controls = system.control_spec.sample(k_ctrl, (x0.shape[1],))
    if kind == "generic":
        x1, valid = rollout_batch(system, x0, controls, cfg.num_disc,
                                  obstacles[:, None], cfg.width, cfg.height,
                                  footprint=cfg.footprint)
    else:
        x1, valid = rollout_batched_cuda(system, x0, controls, obstacles, **kw)
    return x1, controls, valid


def batched_wave(cfg: KGMTConfig, system, grid: RegionGrid, goals: Tensor,
                 obstacles: Tensor, s, slot: Tensor, parent_rows: Tensor,
                 parent_cost: Tensor, parent_ids: Tensor, slot_active: Tensor,
                 k_ctrl: Tensor, k_accept: Tensor, r1_score: Tensor, r2_seen: Tensor,
                 id_base: Tensor | None = None
                 ) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """One wave of every tree of a batch ([B, R] lanes), in place on ``s``
    (a MultiQueryState or the sharded tree's ShardedState): one rollout
    launch from ``parent_rows`` [B, R, SAMPLE_DIM], the region statistics
    as exact integer ``index_add_`` counts into [B, ...], acceptance from
    ``k_accept``, the commit (an exclusive cumsum within each tree, children
    to slots ``tree_size_b + pos`` in lane order with parent ``parent_ids``,
    those past M to a scratch row of their own past the trees) and the goal
    test, the first lane winning ties; ``slot`` is ``arange(R)`` and
    ``id_base`` [B], where given, is added to a goal node's slot. Updates tree_size, the r1 counters and r2_avail.
    Returns (d1, d2, valid, within, samples1, r2_seen with the wave's
    arrivals)."""
    B, M, _ = s.tree_samples.shape
    R = cfg.rollouts_per_iter
    dev = goals.device
    with phase_scope("kgmt_expand", dev):
        x0 = parent_rows[..., :system.state_dim].contiguous()
        x1, controls, valid = _rollout(cfg, system, k_ctrl, x0, obstacles)
        valid = valid & slot_active
        samples1 = torch.cat([x1, controls], dim=-1)

    with phase_scope("kgmt_region_stats", dev):
        r1, r2 = grid.region_indices(x1[..., 0:2])
        in_r1, in_r2 = r1 >= 0, r2 >= 0
        r1c, r2c = r1.clamp(min=0).long(), r2.clamp(min=0).long()
        pair = torch.stack([slot_active.to(torch.int32), valid.to(torch.int32)], -1)
        row = torch.arange(B, device=dev)[:, None]

        def counts(n: int, idx: Tensor, inside: Tensor) -> Tensor:
            z = torch.zeros((B * n, 2), dtype=torch.int32, device=dev)
            z.index_add_(0, (row * n + idx).reshape(-1),
                         (pair * inside[..., None]).reshape(-1, 2))
            return z.view(B, n, 2)

        d1 = counts(cfg.num_r1, r1c, in_r1)
        d2 = counts(cfg.num_r2, r2c, in_r2)
        with phase_scope("kgmt_rng", dev):
            u = rng.uniform(k_accept, (R,))
        score_r = torch.where(in_r1, r1_score.gather(1, r1c), 0.0)
        seen_r = torch.where(in_r2, r2_seen.gather(1, r2c), 0)
        accept = valid & ((u <= score_r) | ~in_r2 | (seen_r == 0))
        r2_seen = r2_seen | (d2[..., 1] > 0).to(torch.int32)

    with phase_scope("kgmt_commit", dev):
        accept_i = accept.to(torch.int64)
        pos = torch.cumsum(accept_i, dim=1) - accept_i
        ts = s.tree_size
        within = accept & (ts[:, None] + pos < M)
        child_cost = parent_cost + controls[..., -1]
        scratch = B * M + row * R + slot
        dst = torch.where(within, row * M + ts[:, None] + pos, scratch).reshape(-1)
        s.flat_samples.index_copy_(0, dst, samples1.reshape(-1, SAMPLE_DIM))
        s.flat_parent.index_copy_(0, dst, parent_ids.to(torch.int32).reshape(-1))
        s.flat_costs.index_copy_(0, dst, child_cost.reshape(-1))

    with phase_scope("kgmt_goal", dev):
        dx = x1[..., 0] - goals[:, None, 0]
        dy = x1[..., 1] - goals[:, None, 1]
        in_goal = within & (dx * dx + dy * dy < cfg.goal_threshold ** 2)
        goal_costs = torch.where(in_goal, child_cost, float("inf"))
        best = torch.argmin(goal_costs, dim=1, keepdim=True)
        best_cost = goal_costs.gather(1, best)[:, 0]
        improved = best_cost < s.cost_to_goal
        s.cost_to_goal = torch.where(improved, best_cost, s.cost_to_goal)
        node = ts + pos.gather(1, best)[:, 0]
        if id_base is not None:
            node = id_base + node
        s.goal_node = torch.where(improved, node.to(torch.int32), s.goal_node)

    with phase_scope("kgmt_boundary", dev):
        s.tree_size = ts + within.sum(dim=1)
        s.r1_total += d1[..., 0]
        s.r1_valid += d1[..., 1]
        s.r1_invalid += d1[..., 0] - d1[..., 1]
        s.r1_avail |= (d1[..., 1] > 0).to(torch.int32)
        s.r2_avail |= (d2[..., 1] > 0).to(torch.int32)
    return d1, d2, valid, within, samples1, r2_seen


def multi_query_trip(cfg: KGMTConfig, system, grid: RegionGrid, goals: Tensor,
                     obstacles: Tensor, s: MultiQueryState) -> bool:
    """One trip of the vmapped flat loop: one wave for every running
    problem, in place. Returns whether any problem still runs (the trip's
    one read from the device)."""
    B = s.tree_samples.shape[0]
    R = cfg.rollouts_per_iter
    dev = goals.device
    run = s.running
    with phase_scope("kgmt_trip", dev, trip=s.trips):
        # iteration start (w == 0): scores, frontier range, target, r2 snapshot
        with phase_scope("kgmt_scores", dev):
            is0 = run & (s.w == 0)
            s.r1_score = torch.where(is0[:, None], region_scores(cfg, s), s.r1_score)
            s.fl0 = torch.where(is0, s.frontier_lo, s.fl0)
            s.ts0 = torch.where(is0, s.tree_size, s.ts0)
            frontier_size = s.ts0 - s.fl0
            s.n_tgt = torch.where(is0, _fresh_target(cfg, frontier_size, s.ts0), s.n_tgt)
            s.r2_seen = torch.where(is0[:, None], s.r2_avail, s.r2_seen)

        # expand: round-robin parents over each frontier, then the wave
        with phase_scope("kgmt_parents", dev):
            slot = torch.arange(R, dtype=torch.int64, device=dev)
            gslot = s.w[:, None] * R + slot
            slot_active = (gslot < s.n_tgt[:, None]) & run[:, None]
            parent_idx = s.fl0[:, None] + gslot % frontier_size.clamp(min=1)[:, None]
            if cfg.goal_bias > 0.0:
                parent_idx = _goal_biased(cfg, s, goals, parent_idx)
            parent_rows = s.tree_samples.gather(
                1, parent_idx[..., None].expand(B, R, SAMPLE_DIM))
            parent_cost = s.costs.gather(1, parent_idx)
        with phase_scope("kgmt_rng", dev):
            k_ctrl, k_accept = _wave_keys(s)
        *_, s.r2_seen = batched_wave(cfg, system, grid, goals, obstacles, s, slot,
                                     parent_rows, parent_cost, parent_idx, slot_active,
                                     k_ctrl, k_accept, s.r1_score, s.r2_seen)

        # iteration boundary, per problem
        with phase_scope("kgmt_boundary", dev):
            w2 = s.w + 1
            last = run & (w2 >= _num_waves(cfg, s.n_tgt))
            stalled = s.tree_size == s.ts0
            if cfg.keep_frontier_on_stall:
                new_lo = torch.where(stalled, s.fl0, s.ts0)
            else:
                new_lo = s.ts0
            s.frontier_lo = torch.where(last, new_lo, s.frontier_lo)
            s.stalled = torch.where(last, stalled, s.stalled)
            s.itr = s.itr + last.to(torch.int64)
            s.w = torch.where(run, torch.where(last, 0, w2), s.w)
            s.running = _keep_going(cfg, s)
            s.trips += 1
            more = s.running.any()
        return host_read(more)


def multi_query_solve(cfg: KGMTConfig, system, grid: RegionGrid, inits: Tensor,
                      goals: Tensor, obstacles: Tensor, keys: Tensor
                      ) -> MultiQueryState:
    """``vmap(kgmt_solve)``: trips until no problem runs."""
    with phase_scope("kgmt_init", inits.device):
        s = init_batch_state(cfg, grid, inits, keys)
        more = host_read(s.running.any())
    while more:
        more = multi_query_trip(cfg, system, grid, goals, obstacles, s)
    return s


class MultiQueryPlanner:
    """Plan B problems at once, each by the whole single-query solve, on one
    device (``cuda`` unless the caller asks for ``cpu``), or with ``mesh``
    the batch over its scenario axis, each rank on the mesh's device."""

    def __init__(self, config: KGMTConfig | None = None,
                 mesh: PlannerMesh | None = None, system=None,
                 device: torch.device | str = "cuda"):
        from cudasbmp_torch.planners.kgmt import resolve_device

        cfg = self.config = config or KGMTConfig()
        self.mesh = mesh
        self.system = system or get_system(cfg.system)
        self.grid = RegionGrid(width=cfg.width, height=cfg.height, N=cfg.N, n=cfg.n)
        self.device = resolve_device(device if mesh is None else mesh.device)
        self.last_state: MultiQueryState | None = None

    def plan_batch(self, inits: np.ndarray, goals: np.ndarray,
                   obstacles: np.ndarray, seed: int = 0) -> MultiQueryResult:
        """inits/goals [B, SAMPLE_DIM]; obstacles [B, K, 4] or [K, 4]
        (shared). Problem b solves under the key ``fold_in(key(seed), b)``.
        With a mesh, B must be divisible by the scenario-axis size; each
        rank solves its share and returns the whole result
        (``last_state`` holds its share)."""
        from cudasbmp_torch.parallel.batch_kgmt import arena_extract_paths

        cfg, dev = self.config, self.device
        B = inits.shape[0]
        with phase_scope("kgmt_plan_batch", dev, seed=seed, problems=B):
            lo, hi = (0, B) if self.mesh is None else self.mesh.batch_range(B)
            with phase_scope("kgmt_init", dev):
                obstacles = np.asarray(obstacles, dtype=np.float32)
                if obstacles.ndim == 2:
                    obstacles = np.broadcast_to(obstacles, (B,) + obstacles.shape)
                with phase_scope("kgmt_rng", dev):
                    keys = rng.fold_in(rng.key(seed, dev),
                                       torch.arange(lo, hi, device=dev))
                t0 = time.perf_counter()
                args = (torch.as_tensor(np.asarray(inits)[lo:hi],
                                        dtype=torch.float32, device=dev),
                        torch.as_tensor(np.asarray(goals)[lo:hi],
                                        dtype=torch.float32, device=dev),
                        torch.as_tensor(np.ascontiguousarray(obstacles[lo:hi]),
                                        device=dev))
            final = multi_query_solve(cfg, self.system, self.grid, *args, keys)
            with phase_scope("kgmt_extract", dev):
                # the goal -> root walk of extract_path, per problem
                _, samples, lengths = arena_extract_paths(final, cfg.num_iterations + 1)
                costs, tree_sizes, iters, paths, lengths = (
                    host_read(collectives.axis_gather(self.mesh, "scenario", t),
                              numpy=True)
                    for t in (final.cost_to_goal, final.tree_size, final.itr, samples,
                              lengths))
            wall = time.perf_counter() - t0
            self.last_state = final
            solved = np.isfinite(costs)
            tree_sizes, iters = tree_sizes.astype(np.int32), iters.astype(np.int32)
            return MultiQueryResult(
                solved=solved,
                costs=costs,
                tree_sizes=tree_sizes,
                iterations=iters,
                paths=paths,
                path_lengths=lengths,
                wall_time_s=wall,
                solves_per_sec=B / wall,
                budget_exhausted=~solved & ((iters >= cfg.num_iterations)
                                            | (tree_sizes >= cfg.max_tree_size)),
            )

    def plan_scenarios(self, scenarios: list[Scenario], seed: int = 0
                       ) -> MultiQueryResult:
        inits, goals, obstacles = stack_scenarios(self.config, scenarios)
        return self.plan_batch(inits, goals, obstacles, seed=seed)
