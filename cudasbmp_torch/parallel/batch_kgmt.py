"""Batched-arena KGMT: many problems advanced together, one global iteration
at a time (counterpart of cudasbmp_tpu/parallel/batch_kgmt.py; BASELINE
config 4).

Semantics are the JAX arena's. One global iteration counter drives the
batch, so every problem commits its wave to the same tree window: window
``w`` of every problem is slots [w*R, (w+1)*R), and block 0 holds the root.
Every iteration spawns exactly ``rollouts_per_iter`` rollouts per problem,
round-robin over the problem's compacted frontier (the accepted children of
its last productive wave), with the reference's acceptance, guidance
scores, goal test and cost bookkeeping (KGMT.cu:394-400, 487-538, 540-593,
635-638). Rejected slots stay in the tree with ``tree_valid`` False, so
``max_tree_size`` bounds iterations at ``max_tree_size / R - 1``.

What the TPU shaped and the port does otherwise (every change computes the
same values, see tests/test_arena.py:220-263 for the JAX package's own
proof that its one-hot and gather paths agree to the bit):

- the one-hot row permutations (``_permute_rows``, the parent pick and the
  frontier compaction) are index gathers, the compaction a stable sort of
  the rejected flags;
- the region-statistics contraction is ``index_add_`` of 0/1 counts into the
  f32 count arrays: integers below 2^24 add exactly in any order, so the
  CUDA atomics give the same counts as the CPU;
- the score and seen lookups are gathers, masked where a lane lies outside
  the grid (score 0, virgin), as the zero one-hot row gives;
- the window commit writes the tree tensors IN PLACE (the JAX state is
  immutable; at the Monte-Carlo sweep's [1024, 19,328, 7] a copy per
  iteration would move 554 MB); ``arena_iteration`` updates its state and
  returns it.

The loop runs on the host, one device read per iteration: whether every
problem is done.

Spans (the tree is utils/profiling.py's): ``kgmt_plan_batch`` around
``plan_batch``, ``kgmt_restart`` around each restart round of ``_extend``
(the sub-planner's ``plan_batch`` nests inside), ``kgmt_iteration`` around
each ``arena_iteration``, the phases inside.

With a mesh (parallel/mesh.py) the problems are laid over the scenario
axis. A rank solves its share, drawing its rows of each wave's batch-wide
draws (the counters from its first problem's on: ``row0``), and every rank
runs the same iterations, ended by whether every problem of every rank is
done (one collective an iteration), so the results, gathered onto every
rank, are bitwise the batch solved in one process.
"""

from __future__ import annotations

import dataclasses
import time
import warnings

import numpy as np
import torch

from cudasbmp_torch import rng
from cudasbmp_torch._math import div, row_sum
from cudasbmp_torch.config import SAMPLE_DIM, KGMTConfig, Scenario
from cudasbmp_torch.geometry.grid import RegionGrid
from cudasbmp_torch.ops.rollout import rollout_batch
from cudasbmp_torch.ops.rollout_cuda import (
    rollout_batched_cuda,
    rollout_cuda,
    sample_and_rollout_batched_cuda,
    sample_and_rollout_cuda,
)
from cudasbmp_torch.parallel import collectives
from cudasbmp_torch.parallel.mesh import PlannerMesh
from cudasbmp_torch.parallel.multi_query import MultiQueryResult, stack_scenarios
from cudasbmp_torch.planners.kgmt import resolve_device, rollout_kind
from cudasbmp_torch.systems.registry import get_system
from cudasbmp_torch.utils.profiling import host_read, phase_scope

Tensor = torch.Tensor


@dataclasses.dataclass
class ArenaState:
    """Batched planner state; field names and meanings as cudasbmp_tpu's
    ArenaState. Every tensor has a leading problem axis B except the global
    PRNG key; the global iteration counter is a host int."""

    tree_samples: Tensor  # f32 [B, M, SAMPLE_DIM]
    tree_parent: Tensor  # i32 [B, M], -1 = unset/root
    tree_valid: Tensor  # bool [B, M]
    costs: Tensor  # f32 [B, M]
    p_x0: Tensor  # f32 [B, R, state_dim], the compacted frontier carry
    p_cost: Tensor  # f32 [B, R]
    p_gid: Tensor  # i32 [B, R], tree slot of each parent
    n_parents: Tensor  # i32 [B] >= 1
    r1_total: Tensor  # f32 [B, NR1], exact integer counts
    r1_valid: Tensor  # f32 [B, NR1]
    r2_valid: Tensor  # f32 [B, NR1, n*n]
    cost_to_goal: Tensor  # f32 [B], +inf until solved
    goal_node: Tensor  # i32 [B], -1 until solved
    solved_at: Tensor  # i32 [B], iteration of the first solution, -1 until then
    done: Tensor  # bool [B]
    it: int  # global iteration counter
    key: Tensor  # int64 [2], threefry key data


def _region_local(grid: RegionGrid, x: Tensor, y: Tensor,
                  r1: Tensor) -> tuple[Tensor, Tensor]:
    """Local n*n subcell index within an R1 cell, and whether it lies in
    range (grid.r2_index's rule, KGMT.cu:610-629, without flattening)."""
    n = grid.n
    cell_y_r1 = r1 // grid.N
    cell_x_r1 = r1 % grid.N
    local_x = x - cell_x_r1.to(torch.float32) * grid.r1_size
    local_y = y - cell_y_r1.to(torch.float32) * grid.r1_size
    cx = div(local_x, grid.r2_size).to(torch.int32)
    cy = div(local_y, grid.r2_size).to(torch.int32)
    inside = (r1 >= 0) & (cx >= 0) & (cx < n) & (cy >= 0) & (cy < n)
    return torch.where(inside, cy * n + cx, 0), inside


def _scores(cfg: KGMTConfig, r1_total: Tensor, r1_valid: Tensor,
            r2_valid: Tensor) -> Tensor:
    """Exploration-guidance scores per R1 cell (updateR1, KGMT.cu:487-538),
    batched: freeVol^4 / ((1 + covR) * (1 + total^2)) where the cell has a
    valid child (or the root), normalised by the problem's sum; 1 elsewhere.
    Powers are products, as XLA's integer_pow computes them."""
    n2 = cfg.n * cfg.n
    avail = r1_valid > 0
    cov_r = div((r2_valid > 0).sum(dim=-1).to(torch.float32), n2)
    free_vol = (cfg.epsilon + r1_valid) / (cfg.epsilon + r1_total)
    fv2 = free_vol * free_vol
    score = (fv2 * fv2) / ((1.0 + cov_r) * (1.0 + r1_total * r1_total))
    score = torch.where(avail, score, 0.0)
    total = row_sum(score)
    return torch.where(avail, torch.where(total > 0, score / total, 1.0), 1.0)


def _init_region_onehots(cfg: KGMTConfig, grid: RegionGrid, init_xy: Tensor
                         ) -> tuple[Tensor, Tensor]:
    """Root-cell indicator rows [B, NR1] and [B, NR1, n*n] (f32 0/1) that
    seed the count arrays; a root outside the grid seeds nothing."""
    nr1, n2 = cfg.num_r1, cfg.n * cfg.n
    r1_0, r2_0 = grid.region_indices(init_xy)
    r1c = r1_0.clamp(min=0).long()
    oh_r1 = (torch.nn.functional.one_hot(r1c, nr1).to(torch.float32)
             * (r1_0 >= 0)[:, None])
    loc0 = torch.where(r2_0 >= 0, r2_0 - r1c * n2, 0).long()
    oh_r2 = (oh_r1[:, :, None]
             * torch.nn.functional.one_hot(loc0, n2).to(torch.float32)[:, None, :]
             * (r2_0 >= 0)[:, None, None])
    return oh_r1, oh_r2


def _gather_rows(x: Tensor, idx: Tensor) -> Tensor:
    """out[b, r] = x[b, idx[b, r]] for x [B, R] or [B, R, D]."""
    if x.dim() == 3:
        return x.gather(1, idx[..., None].expand(-1, -1, x.shape[-1]))
    return x.gather(1, idx)


def _goal_biased_parents(cfg: KGMTConfig, p_x0: Tensor, n_parents: Tensor,
                         goals: Tensor, j: Tensor) -> Tensor:
    """The first round(goal_bias * R) slots cycle over each problem's top-k
    goal-nearest carry entries (``lax.top_k`` of -d2, ties lowest index
    first: a stable ascending sort of d2); an entry past the carry's size
    (distance inf) keeps the slot's round-robin parent."""
    R = j.shape[1]
    lane = torch.arange(R, device=j.device)
    valid_p = lane[None, :] < n_parents[:, None]
    dx = p_x0[..., 0] - goals[:, None, 0]
    dy = p_x0[..., 1] - goals[:, None, 1]
    d2 = torch.where(valid_p, dx * dx + dy * dy, float("inf"))
    k = min(cfg.goal_bias_k, R)
    best, near = torch.sort(d2, dim=-1, stable=True)
    n_biased = int(round(cfg.goal_bias * R))
    idx = lane[:n_biased] % k
    ok = torch.isfinite(best[:, idx])
    biased = torch.where(ok, near[:, idx], j[:, :n_biased])
    return torch.cat([biased, j[:, n_biased:]], dim=1)


def _rollout_wave(cfg: KGMTConfig, system, x0: Tensor, obstacles: Tensor,
                  key: Tensor, row0: int = 0) -> tuple[Tensor, Tensor, Tensor]:
    """One batched expansion wave: x0 [B, R, S] -> (x1, controls, valid).

    Shared obstacles ([K, 4]) flatten the batch into one launch of B*R
    lanes: kernel B1 (``auto``/``cuda``) or B2 (``cuda_rng``). Per-problem
    obstacles ([B, K, 4]) take kernel B6, or its Philox form under
    ``cuda_rng``; ``torch``, and ``auto`` for a system without a device
    struct (``planners/kgmt.py::rollout_kind``), run the plain exact
    rollout either way.

    ``key`` is one key [2] (the arena: one stream per wave; B6's Philox form
    then takes ``split(key, B)``) or one per slot, [B, 2] (the streaming
    sweep: streams keyed by scenario id); per-slot keys need per-problem
    obstacles, as in the JAX package. With one key, ``row0`` is the batch
    index of x0's first problem: its rows of the batch-wide draws are the
    ones from that problem's on (B2's lanes from ``row0 * R``)."""
    B, R = x0.shape[0], x0.shape[1]
    per_slot_keys = key.dim() == 2
    shared_obs = obstacles.dim() == 2
    if per_slot_keys and shared_obs:
        raise ValueError("per-slot keys need per-problem obstacles")
    kw = dict(num_disc=cfg.num_disc, width=cfg.width, height=cfg.height,
              footprint=cfg.footprint, fast_math=cfg.fast_math)
    spec = system.control_spec
    kind = rollout_kind(cfg, system)
    if cfg.rollout_backend == "cuda_rng":
        if shared_obs:
            x1, controls, valid = sample_and_rollout_cuda(
                system, key, x0.reshape(B * R, -1), obstacles, lane0=row0 * R, **kw)
            return (x1.reshape(B, R, -1), controls.reshape(B, R, -1),
                    valid.reshape(B, R))
        with phase_scope("kgmt_rng", x0.device):
            keys = key if per_slot_keys else rng.split(key, B, offset=row0)
        return sample_and_rollout_batched_cuda(system, keys, x0, obstacles, **kw)

    with phase_scope("kgmt_rng", x0.device):
        controls = (spec.sample(key, (R,)) if per_slot_keys
                    else spec.sample(key, (B, R), offset=row0 * R * spec.dim))
    if kind == "generic":
        x1, valid = rollout_batch(system, x0, controls, cfg.num_disc,
                                  obstacles if shared_obs else obstacles[:, None],
                                  cfg.width, cfg.height, footprint=cfg.footprint)
        return x1, controls, valid
    if shared_obs:
        x1, valid = rollout_cuda(system, x0.reshape(B * R, -1),
                                 controls.reshape(B * R, -1), obstacles, **kw)
        return x1.reshape(B, R, -1), controls, valid.reshape(B, R)
    x1, valid = rollout_batched_cuda(system, x0, controls, obstacles, **kw)
    return x1, controls, valid


def _wave_regions(cfg: KGMTConfig, grid: RegionGrid, x1: Tensor, live: Tensor,
                  valid: Tensor, r1_score: Tensor, r1_total: Tensor,
                  r1_valid: Tensor, r2_valid: Tensor) -> tuple[Tensor, Tensor]:
    """Look up each child's score and whether its R2 subcell was empty,
    then add the wave's counts to the count arrays IN PLACE: r1_total
    counts the live problems' lanes inside the grid, r1_valid and r2_valid
    the valid ones (KGMT.cu:392-410). Returns (score_r, virgin) [B, R]."""
    B = valid.shape[0]
    nr1, n2 = cfg.num_r1, cfg.n * cfg.n
    r1 = grid.r1_index(x1[..., 0], x1[..., 1])
    loc, in_r2 = _region_local(grid, x1[..., 0], x1[..., 1], r1)
    in_r1 = r1 >= 0
    r1c = r1.clamp(min=0).long()
    cell2 = r1c * n2 + loc
    score_r = torch.where(in_r1, r1_score.gather(1, r1c), 0.0)
    seen = r2_valid.reshape(B, nr1 * n2).gather(1, cell2) > 0
    virgin = ~in_r2 | ~seen

    row = torch.arange(B, device=x1.device)[:, None]
    touched = (live[:, None] & in_r1).to(torch.float32)
    valid_f = (valid & in_r1).to(torch.float32)
    idx1 = (row * nr1 + r1c).reshape(-1)
    r1_total.view(-1).index_add_(0, idx1, touched.reshape(-1))
    r1_valid.view(-1).index_add_(0, idx1, valid_f.reshape(-1))
    r2_valid.view(-1).index_add_(0, (row * (nr1 * n2) + cell2).reshape(-1),
                                 (valid_f * in_r2).reshape(-1))
    return score_r, virgin


def _compact_accepted(accept: Tensor) -> Tensor:
    """Per problem, the lanes of the accepted children in lane order, then
    the rejected ones: the stable argsort of ~accept."""
    return torch.argsort((~accept).to(torch.int32), dim=-1, stable=True)


def arena_init(cfg: KGMTConfig, grid: RegionGrid, inits: Tensor, key: Tensor,
               M: int, R: int, state_dim: int) -> ArenaState:
    """Seed every problem's tree with its root in slot 0 (KGMT.cu:85-97);
    the first frontier carry is the root repeated (n_parents = 1)."""
    B, dev = inits.shape[0], inits.device
    tree_samples = torch.zeros((B, M, SAMPLE_DIM), dtype=torch.float32, device=dev)
    tree_samples[:, 0] = inits
    tree_valid = torch.zeros((B, M), dtype=torch.bool, device=dev)
    tree_valid[:, 0] = True
    oh_r1, oh_r2 = _init_region_onehots(cfg, grid, inits[:, 0:2])
    return ArenaState(
        tree_samples=tree_samples,
        tree_parent=torch.full((B, M), -1, dtype=torch.int32, device=dev),
        tree_valid=tree_valid,
        costs=torch.zeros((B, M), dtype=torch.float32, device=dev),
        p_x0=inits[:, None, :state_dim].expand(B, R, state_dim).contiguous(),
        p_cost=torch.zeros((B, R), dtype=torch.float32, device=dev),
        p_gid=torch.zeros((B, R), dtype=torch.int32, device=dev),
        n_parents=torch.ones(B, dtype=torch.int32, device=dev),
        r1_total=oh_r1,
        r1_valid=oh_r1.clone(),
        r2_valid=oh_r2,
        cost_to_goal=torch.full((B,), float("inf"), dtype=torch.float32, device=dev),
        goal_node=torch.full((B,), -1, dtype=torch.int32, device=dev),
        solved_at=torch.full((B,), -1, dtype=torch.int32, device=dev),
        done=torch.zeros(B, dtype=torch.bool, device=dev),
        it=0,
        key=key,
    )


def arena_iteration(cfg: KGMTConfig, system, grid: RegionGrid,
                    obstacles: Tensor, goals: Tensor, R: int,
                    s: ArenaState, row0: int = 0) -> ArenaState:
    """One global iteration over the whole batch: score -> parents ->
    expand -> stats -> accept -> window commit -> goal -> frontier refresh.
    Updates ``s`` in place and returns it. ``row0``: the batch index of
    ``s``'s first problem (a rank's share of a larger batch), whose rows of
    the wave's batch-wide draws it takes."""
    B, M = s.tree_parent.shape
    dev = s.p_x0.device
    with phase_scope("kgmt_iteration", dev, it=s.it):
        with phase_scope("kgmt_scores", dev):
            r1_score = _scores(cfg, s.r1_total, s.r1_valid, s.r2_valid)

        # parents: round-robin over the compacted frontier carry
        with phase_scope("kgmt_parents", dev):
            lane = torch.arange(R, device=dev)
            j = lane[None, :] % s.n_parents.clamp(min=1)[:, None].long()
            if cfg.goal_bias > 0.0:
                j = _goal_biased_parents(cfg, s.p_x0, s.n_parents, goals, j)
            x0 = _gather_rows(s.p_x0, j)
            pcost = _gather_rows(s.p_cost, j)
            pgid = _gather_rows(s.p_gid, j)

        # expansion
        with phase_scope("kgmt_rng", dev):
            k_ctrl, k_accept = rng.split(rng.fold_in(s.key, s.it)).unbind(0)
        with phase_scope("kgmt_expand", dev):
            x1, controls, valid = _rollout_wave(cfg, system, x0, obstacles, k_ctrl, row0)
            live = ~s.done
            valid = valid & live[:, None]

        # region statistics and lookups; acceptance (KGMT.cu:394-400)
        with phase_scope("kgmt_region_stats", dev):
            score_r, virgin = _wave_regions(cfg, grid, x1, live, valid, r1_score,
                                            s.r1_total, s.r1_valid, s.r2_valid)
            with phase_scope("kgmt_rng", dev):
                u = rng.uniform(k_accept, (B, R), offset=row0 * R)
            accept = valid & ((u <= score_r) | virgin)

        # window commit, in place; the start clamps as dynamic_update_slice's
        with phase_scope("kgmt_commit", dev):
            win_base = (s.it + 1) * R
            lo = min(win_base, M - R)
            child_cost = pcost + controls[..., -1]  # getCost = duration
            s.tree_samples[:, lo:lo + R] = torch.cat([x1, controls], dim=-1)
            s.tree_parent[:, lo:lo + R] = torch.where(accept, pgid, -1)
            s.tree_valid[:, lo:lo + R] = accept
            s.costs[:, lo:lo + R] = torch.where(accept, child_cost, 0.0)

        # goal check (inGoalRegion, KGMT.cu:635-638): cheapest, first lane on ties
        with phase_scope("kgmt_goal", dev):
            dx = x1[..., 0] - goals[:, None, 0]
            dy = x1[..., 1] - goals[:, None, 1]
            in_goal = accept & (dx * dx + dy * dy < cfg.goal_threshold ** 2)
            goal_costs = torch.where(in_goal, child_cost, float("inf"))
            best = torch.argmin(goal_costs, dim=-1)
            best_cost = goal_costs.gather(1, best[:, None])[:, 0]
            improved = best_cost < s.cost_to_goal
            s.cost_to_goal = torch.where(improved, best_cost, s.cost_to_goal)
            s.goal_node = torch.where(improved, (win_base + best).to(torch.int32),
                                      s.goal_node)
            s.solved_at = torch.where(improved & (s.solved_at < 0), s.it + 1,
                                      s.solved_at)

        # frontier refresh: the accepted children, compacted; a stalled problem
        # retries its frontier with fresh randomness, a done one stays frozen
        with phase_scope("kgmt_boundary", dev):
            n_acc = accept.sum(dim=-1, dtype=torch.int32)
            order = _compact_accepted(accept)
            keep = (n_acc > 0) & live
            kb = keep[:, None]
            s.p_x0 = torch.where(kb[..., None], _gather_rows(x1, order), s.p_x0)
            s.p_cost = torch.where(kb, _gather_rows(child_cost, order), s.p_cost)
            s.p_gid = torch.where(kb, (win_base + order).to(torch.int32), s.p_gid)
            s.n_parents = torch.where(keep, n_acc, s.n_parents)

            if cfg.stop_on_first_solution:
                s.done = s.done | torch.isfinite(s.cost_to_goal)
            if not cfg.keep_frontier_on_stall:
                s.done = s.done | (live & (n_acc == 0))
            s.it += 1
    return s


def arena_solve(cfg: KGMTConfig, system, grid: RegionGrid, inits: Tensor,
                goals: Tensor, obstacles: Tensor, key: Tensor, M: int, R: int,
                n_windows: int, row0: int = 0, mesh: PlannerMesh | None = None
                ) -> ArenaState:
    """Iterate while ``it < n_windows`` and some problem is not done, as the
    JAX while_loop does (extra all-done iterations would change ``it``, the
    iteration count of the unsolved problems). With ``mesh``, some problem
    of any rank of the scenario axis: every rank runs the same iterations."""
    with phase_scope("kgmt_init", inits.device):
        s = arena_init(cfg, grid, inits, key, M, R, system.state_dim)
    while s.it < n_windows and not _all_done(s, mesh):
        arena_iteration(cfg, system, grid, obstacles, goals, R, s, row0)
    return s


def _all_done(s: ArenaState, mesh: PlannerMesh | None) -> bool:
    """Whether every problem is done, over the scenario axis (the
    iteration's one read)."""
    with phase_scope("kgmt_boundary", s.done.device):
        done = s.done.all()
        if mesh is not None and mesh.spans("scenario"):
            done = ~collectives.axis_any(mesh, "scenario", ~done)
        return host_read(done)


def arena_extract_paths(s: ArenaState, max_len: int
                        ) -> tuple[Tensor, Tensor, Tensor]:
    """Batched goal->root parent walk: (nodes [B, L] i32, samples
    [B, L, SAMPLE_DIM], lengths [B] i32), left-packed root->goal; entries
    past a length are -1 / zeros. Indices clamp at 0 before every lookup."""
    node = s.goal_node.long()
    rev = []
    for _ in range(max_len):
        rev.append(node)
        parent = s.tree_parent.gather(1, node.clamp(min=0)[:, None])[:, 0]
        node = torch.where(node >= 0, parent.long(), -1)
    rev_nodes = torch.stack(rev, dim=1)
    length = (rev_nodes >= 0).sum(dim=1)
    idx = torch.arange(max_len, device=node.device)
    src = (length[:, None] - 1 - idx).clamp(min=0)
    nodes = torch.where(idx < length[:, None], rev_nodes.gather(1, src), -1)
    samples = torch.where((nodes >= 0)[..., None],
                          _gather_rows(s.tree_samples, nodes.clamp(min=0)), 0.0)
    return nodes.to(torch.int32), samples, length.to(torch.int32)


class ArenaMultiQueryPlanner:
    """Host-facing batched multi-query planner on one device (``cuda``
    unless the caller asks for ``cpu``), or with ``mesh`` the problems over
    its scenario axis, each rank on the mesh's device (pure data
    parallelism: the arena exchanges nothing between problems). Fixed-wave
    semantics: see the module docstring."""

    def __init__(self, config: KGMTConfig | None = None,
                 mesh: PlannerMesh | None = None, system=None,
                 auto_capacity: bool = False,
                 device: torch.device | str = "cuda"):
        cfg = self.config = config or KGMTConfig()
        self.mesh = mesh
        self.system = system or get_system(cfg.system)
        self.auto_capacity = auto_capacity
        self.device = resolve_device(device if mesh is None else mesh.device)
        self.grid = RegionGrid(width=cfg.width, height=cfg.height, N=cfg.N,
                               n=cfg.n)
        R = cfg.rollouts_per_iter
        if auto_capacity:
            # exactly num_iterations windows plus the root block
            M = (cfg.num_iterations + 1) * R
        else:
            # window w holds iteration w's wave (block 0 the root), so
            # capacity bounds iterations
            M = max(cfg.max_tree_size // R, 2) * R
        self.n_windows = min(cfg.num_iterations, M // R - 1)
        self._extensions: dict[int, ArenaMultiQueryPlanner] = {}
        self.M, self.R = M, R
        if self.n_windows < cfg.num_iterations:
            warnings.warn(
                f"arena window layout bounds iterations at max_tree_size/R-1:"
                f" max_tree_size={cfg.max_tree_size} with rollouts_per_iter="
                f"{R} gives {self.n_windows} windows < num_iterations="
                f"{cfg.num_iterations}; raise max_tree_size or lower "
                f"rollouts_per_iter to get the full budget", stacklevel=2)

    def _solve(self, inits, goals, obstacles, key, row0: int = 0):
        final = arena_solve(self.config, self.system, self.grid, inits, goals,
                            obstacles, key, self.M, self.R, self.n_windows, row0,
                            self.mesh)
        with phase_scope("kgmt_extract", self.device):
            _, samples, lengths = arena_extract_paths(final, self.n_windows + 1)
            iters = torch.where(final.solved_at >= 0, final.solved_at, final.it)
            tree_sizes = final.tree_valid.sum(dim=-1, dtype=torch.int32)
        return final.cost_to_goal, tree_sizes, iters, samples, lengths

    def plan_batch(self, inits: np.ndarray, goals: np.ndarray,
                   obstacles: np.ndarray, seed: int = 0,
                   max_extensions: int = 0) -> MultiQueryResult:
        """inits/goals [B, SAMPLE_DIM]; obstacles [K, 4] (shared: one launch
        of B*R lanes per wave) or [B, K, 4] (one set per problem: kernel
        B6). ``max_extensions`` > 0 re-plans problems that exhausted the
        window budget unsolved as fresh searches with a doubled budget, up
        to that many times; those still unsolved carry
        ``budget_exhausted``. With a mesh, B must be divisible by the
        scenario-axis size; every rank returns the whole result."""
        B, dev = inits.shape[0], self.device
        with phase_scope("kgmt_plan_batch", dev, seed=seed, problems=B):
            lo, hi = (0, B) if self.mesh is None else self.mesh.batch_range(B)
            obstacles = np.asarray(obstacles)
            own_obs = obstacles if obstacles.ndim == 2 else obstacles[lo:hi]
            t0 = time.perf_counter()
            with phase_scope("kgmt_init", dev):
                args = (torch.as_tensor(np.asarray(inits)[lo:hi],
                                        dtype=torch.float32, device=dev),
                        torch.as_tensor(np.asarray(goals)[lo:hi],
                                        dtype=torch.float32, device=dev),
                        torch.as_tensor(own_obs, dtype=torch.float32, device=dev),
                        rng.key(seed, dev))
            outs = self._solve(*args, lo)
            with phase_scope("kgmt_extract", dev):
                costs, tree_sizes, iters, samples, lengths = (
                    host_read(collectives.axis_gather(self.mesh, "scenario", t),
                              numpy=True)
                    for t in outs)
            wall = time.perf_counter() - t0
            solved = np.isfinite(costs)
            res = MultiQueryResult(
                solved=solved,
                costs=costs,
                tree_sizes=tree_sizes,
                iterations=iters,
                paths=samples,
                path_lengths=lengths,
                wall_time_s=wall,
                solves_per_sec=B / wall,
                budget_exhausted=~solved & (iters >= self.n_windows),
            )
            if max_extensions > 0 and res.budget_exhausted.any():
                res = self._extend(res, inits, goals, obstacles, seed, max_extensions)
            return res

    def _extend(self, res: MultiQueryResult, inits, goals, obstacles,
                seed: int, max_extensions: int) -> MultiQueryResult:
        """Progressive-doubling restarts: each round re-plans only the
        budget-exhausted problems (padded to a power-of-two bucket of at
        least 8, rounded up to a multiple of the mesh's scenario axis, with
        the first of them) with twice the previous round's windows and the
        seed ``seed + 104729 * (round + 1)``; sub-planners are cached per
        budget. Every rank holds the whole result, so every rank picks the
        same problems and bucket."""
        windows = self.n_windows
        for ext in range(max_extensions):
            idx = np.flatnonzero(res.budget_exhausted)
            if idx.size == 0:
                break
            windows *= 2
            bucket = max(1 << (int(idx.size - 1)).bit_length(), 8)
            if self.mesh is not None:
                n_shard = self.mesh.n_scenario
                bucket = -(-bucket // n_shard) * n_shard
            with phase_scope("kgmt_restart", self.device, round=ext, bucket=bucket,
                             windows=windows):
                sub = self._extensions.get(windows)
                if sub is None:
                    cfg2 = dataclasses.replace(self.config, num_iterations=windows)
                    sub = ArenaMultiQueryPlanner(cfg2, mesh=self.mesh, system=self.system,
                                                 auto_capacity=True,
                                                 device=self.device)
                    self._extensions[windows] = sub
                pad_idx = np.concatenate(
                    [idx, np.full(bucket - idx.size, idx[0], np.int64)])
                sub_obs = obstacles if obstacles.ndim == 2 else obstacles[pad_idx]
                sub_res = sub.plan_batch(np.asarray(inits)[pad_idx],
                                         np.asarray(goals)[pad_idx], sub_obs,
                                         seed=seed + 104729 * (ext + 1))
            k = idx.size
            L_old, L_new = res.paths.shape[1], sub_res.paths.shape[1]
            if L_new > L_old:
                res.paths = np.pad(res.paths, ((0, 0), (0, L_new - L_old), (0, 0)))
            res.costs[idx] = sub_res.costs[:k]
            res.solved[idx] = sub_res.solved[:k]
            res.tree_sizes[idx] = sub_res.tree_sizes[:k]
            res.iterations[idx] = sub_res.iterations[:k]
            res.paths[idx] = sub_res.paths[:k]
            res.path_lengths[idx] = sub_res.path_lengths[:k]
            res.budget_exhausted[idx] = sub_res.budget_exhausted[:k]
            res.wall_time_s += sub_res.wall_time_s
            res.solves_per_sec = res.solved.shape[0] / res.wall_time_s
        return res

    def plan_scenarios(self, scenarios: list[Scenario], seed: int = 0
                       ) -> MultiQueryResult:
        inits, goals, obstacles = stack_scenarios(self.config, scenarios)
        return self.plan_batch(inits, goals, obstacles, seed=seed)
