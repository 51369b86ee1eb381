"""Sharded-tree planning: one logical KGMT planner over the mesh's ``tree``
axis (counterpart of cudasbmp_tpu/parallel/sharded_tree.py).

Each of the D shards owns a tree of ``max_tree_size`` slots, its root from
``inits[shard]`` and its keys from ``fold_in(key, shard)``. Two exchanges an
iteration make the shards one planner (cudasbmp_tpu/planners/kgmt.py:
568-697), both at the iteration's start:

1. global guidance: the shards' integer statistics ``r1_total``,
   ``r1_valid``, ``r1_invalid``, ``r1_avail`` and ``r2_avail`` are summed
   over the shards (the JAX ``psum``; integer sums are exact), the two
   ``avail`` sums become ``> 0``, and the region scores come from those
   global statistics, so every shard's ``r1_score`` row is the same
   (``ShardedTreeResult.r1_scores_by_shard`` is the witness);
2. the frontier exchange: each shard publishes its ``exchange_k``
   goal-nearest frontier nodes (``lax.top_k``'s order: a stable sort, ties
   to the lower index; padding ids -1) under global ids ``shard * M +
   slot``, and the D lists are concatenated into one pool (the JAX
   ``all_gather``). The last ``round(exchange_frac * R)`` slots of every
   wave expand pool entries (``planners.kgmt.apply_pool``), so a child may
   hang under another shard's node; parents are stored as global ids.

Then each shard runs its own ``n_waves`` sub-waves of the iteration, and
all start the next iteration together. The shards of a process are stacked
on its device on a leading axis, as MultiQueryPlanner stacks problems, with
their flat tree buffers; a parent row is read at its local row, and ids
(parents, the goal node, the pool's) are global. The host loop has two
levels: iterations, where the exchanges run and the host reads ONE small
tensor (whether the solve is done, and the most sub-waves any shard needs
next), and within an iteration, trips up to that count, each shard masked
past its own. A trip is one rollout launch over the stacked shards' lanes:
kernel B6 with the one box set given to every shard (``auto``/``cuda``),
B6's Philox form keyed per shard (``cuda_rng``), or the plain exact rollout
(``torch``).

Over several processes (a mesh whose tree axis spans ranks,
parallel/mesh.py) each rank holds its consecutive shards, keyed by their
global index, and the three exchanges an iteration go through
parallel/collectives.py: the statistics' integer sum, the pool's ordered
concatenation, and the readout's flags (done, solved, most sub-waves),
reduced in one collective before the host reads them, so every rank runs
the same trips and iterations (the JAX psum'd loop condition,
cudasbmp_tpu/parallel/sharded_tree.py:71-99). At the end the trees are
gathered once, and every rank stitches the same path. On one process the
collectives are the stacked reductions alone.

The state may also stack a problem axis ahead of the shards (problem-major,
``n_problems`` problems of the same shards): the sharded multi-query
planner's batch, each problem with its own statistics, pool, goal and
termination, a problem that is done frozen while the others run on
(parallel/sharded_multi_query.py).

The solve ends when any shard reaches the goal (with
``stop_on_first_solution``), every shard is full, or the budget is spent.
The result is the cheapest solution of any shard, its path stitched across
shards on the host by walking global parent ids. ``plan_checkpointed``
runs in chunks and writes the whole stacked state after each in the JAX
package's npz layout (every KGMTState field with a leading shard axis;
rank 0 writes, as the JAX package's process 0 does), so each package
resumes the other's files, on any number of ranks with the same tree axis.
"""

from __future__ import annotations

import dataclasses
import pathlib
import time
import types

import numpy as np
import torch

from cudasbmp_torch import rng
from cudasbmp_torch.config import SAMPLE_DIM, KGMTConfig, Scenario
from cudasbmp_torch.geometry.grid import RegionGrid
from cudasbmp_torch.parallel import collectives
from cudasbmp_torch.parallel.mesh import PlannerMesh
from cudasbmp_torch.parallel.multi_query import (
    _goal_biased,
    batched_wave,
    init_batch_state,
)
from cudasbmp_torch.planners.kgmt import (
    _fresh_target,
    _num_waves,
    _synchronize,
    apply_pool,
    resolve_device,
    update_region_scores,
)
from cudasbmp_torch.systems.registry import get_system
from cudasbmp_torch.utils.profiling import phase_scope

Tensor = torch.Tensor


@dataclasses.dataclass
class ShardedState:
    """The fields of KGMTState with a leading axis of this process's trees
    (L = n_problems x its shards, problem-major), on the device, plus the
    flat buffers the trees are views of (L * R scratch rows at the end take
    the children a trip drops). The trees move through iterations together,
    so ``itr`` is one host int (a frozen problem's trees stop at theirs)."""

    tree_samples: Tensor  # f32 [L, M, SAMPLE_DIM]
    tree_parent: Tensor  # i32 [L, M], global ids (shard * M + slot), -1 unset
    costs: Tensor  # f32 [L, M]
    frontier_lo: Tensor  # i64 [L]
    tree_size: Tensor  # i64 [L]
    r1_total: Tensor  # i32 [L, N*N], this shard's counts
    r1_valid: Tensor
    r1_invalid: Tensor
    r1_avail: Tensor
    r1_score: Tensor  # f32 [L, N*N], every row of a problem its global scores
    r2_total: Tensor  # i32 [L, N*N*n*n]
    r2_valid: Tensor
    r2_invalid: Tensor
    r2_avail: Tensor
    r1_threshold: Tensor  # f32 [L]
    u_samples: Tensor  # f32 [L, R, SAMPLE_DIM], each shard's latest wave
    u_parent: Tensor  # i32 [L, R], global ids
    cost_to_goal: Tensor  # f32 [L], +inf until solved
    goal_node: Tensor  # i32 [L], a global id, -1 until solved
    itr: int
    key: Tensor  # int64 [L, 2]
    stalled: Tensor  # bool [L]
    m_frontier_size: Tensor  # i32 [L, max(num_iterations, 1)]
    m_valid: Tensor
    m_accepted: Tensor
    m_tree_size: Tensor
    flat_samples: Tensor  # f32 [L*M + L*R, SAMPLE_DIM]
    flat_parent: Tensor  # i32 [L*M + L*R]
    flat_costs: Tensor  # f32 [L*M + L*R]
    trips: int = 0
    shard0: int = 0  # global index of this process's first shard of a problem
    n_problems: int = 1
    live: Tensor | None = None  # bool [n_problems] with n_problems > 1
    done_at: list | None = None  # each problem's last iteration, once done

    @property
    def rows_are_ids(self) -> bool:
        """Whether a tree row's flat index is its global id (one problem,
        every shard from 0 in this process)."""
        return self.n_problems == 1 and self.shard0 == 0


# ShardedState's fields that are KGMTState's (the checkpoint's arrays)
STATE_FIELDS = tuple(
    f.name for f in dataclasses.fields(ShardedState)
    if not f.name.startswith("flat_")
    and f.name not in ("trips", "shard0", "n_problems", "live", "done_at"))


@dataclasses.dataclass
class ShardedTreeResult:
    solved: bool
    cost: float
    best_shard: int  # shard owning the goal node
    iterations: int
    total_tree_size: int
    wall_time_s: float
    path: np.ndarray  # [L, SAMPLE_DIM] root -> goal, stitched across shards
    path_shards: np.ndarray  # [L] shard owning each path node
    tree_sizes_by_shard: np.ndarray  # [n_shards]
    r1_scores_by_shard: np.ndarray  # [n_shards, N*N], identical rows


def shard_ids(s: ShardedState) -> Tensor:
    """int64 [L]: each tree's shard index within its problem."""
    L = s.costs.shape[0]
    dl = L // s.n_problems
    ids = torch.arange(s.shard0, s.shard0 + dl, device=s.costs.device)
    return ids if s.n_problems == 1 else ids.repeat(s.n_problems)


def per_tree(s: ShardedState, x: Tensor) -> Tensor:
    """A problem's row [n_problems, ...] for each of its trees [L, ...]
    (a view for one problem)."""
    P = s.n_problems
    dl = s.costs.shape[0] // P
    return x[:, None].expand(P, dl, *x.shape[1:]).reshape(P * dl, *x.shape[1:])


def init_sharded_state(cfg: KGMTConfig, grid: RegionGrid, inits: Tensor,
                       keys: Tensor, shard0: int = 0, n_problems: int = 1
                       ) -> ShardedState:
    """init_state for every tree (multi_query.init_batch_state's trees,
    counters and keys: root ``inits[t]`` in slot 0 of tree t, its regions
    marked), plus the fields the sharded result and checkpoint carry."""
    b = init_batch_state(cfg, grid, inits, keys)
    L, dev = inits.shape[0], inits.device
    R, nr2 = cfg.rollouts_per_iter, cfg.num_r2

    def zeros(*shape: int) -> Tensor:
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    it = max(cfg.num_iterations, 1)
    shared = {f.name: getattr(b, f.name) for f in dataclasses.fields(ShardedState)
              if hasattr(b, f.name) and f.name not in ("itr", "trips")}
    return ShardedState(
        **shared, itr=0, shard0=shard0, n_problems=n_problems,
        done_at=[None] * n_problems,
        r2_total=zeros(L, nr2), r2_valid=zeros(L, nr2), r2_invalid=zeros(L, nr2),
        r1_threshold=torch.zeros(L, dtype=torch.float32, device=dev),
        u_samples=torch.zeros((L, R, SAMPLE_DIM), dtype=torch.float32, device=dev),
        u_parent=torch.full((L, R), -1, dtype=torch.int32, device=dev),
        m_frontier_size=zeros(L, it), m_valid=zeros(L, it),
        m_accepted=zeros(L, it), m_tree_size=zeros(L, it))


def exchange_pool(cfg: KGMTConfig, tree_samples: Tensor, costs: Tensor,
                  frontier_lo: Tensor, tree_size: Tensor, goal: Tensor,
                  shards: Tensor | None = None) -> tuple[Tensor, Tensor, Tensor]:
    """This process's share of the frontier exchange (cudasbmp_tpu/planners/
    kgmt.py:627-648): each tree's ``min(exchange_k, M)`` rows nearest the
    goal (``goal`` [SAMPLE_DIM], or one a tree) among its frontier
    [frontier_lo, tree_size), in ``lax.top_k``'s order of ``-d2`` (a stable
    ascending sort of d2 with inf outside the frontier: ties to the lower
    slot, padding past the frontier's size from the lowest slots outside
    it), under global ids ``shard * M + slot`` (``shards`` [L], default
    0..L-1). Returns the trees' lists concatenated: (rows [L*k,
    SAMPLE_DIM], global ids i32 [L*k], -1 on padding, costs [L*k]); the
    sharded iteration concatenates them over the tree axis."""
    L, M = costs.shape
    idx = torch.arange(M, device=costs.device)
    in_frontier = (idx >= frontier_lo[:, None]) & (idx < tree_size[:, None])
    gx, gy = goal[..., 0], goal[..., 1]
    if goal.dim() == 2:
        gx, gy = gx[:, None], gy[:, None]
    dx = tree_samples[..., 0] - gx
    dy = tree_samples[..., 1] - gy
    d2 = torch.where(in_frontier, dx * dx + dy * dy, float("inf"))
    k = min(cfg.exchange_k, M)
    best, cand = torch.sort(d2, dim=1, stable=True)
    best, cand = best[:, :k], cand[:, :k]
    rows = tree_samples.gather(1, cand[..., None].expand(L, k, SAMPLE_DIM))
    if shards is None:
        shards = torch.arange(L, device=cand.device)
    ids = torch.where(torch.isfinite(best), shards[:, None] * M + cand, -1)
    return (rows.reshape(L * k, SAMPLE_DIM), ids.reshape(-1).to(torch.int32),
            costs.gather(1, cand).reshape(-1))


def gather_pool(mesh: PlannerMesh | None, s: ShardedState, pool
                ) -> tuple[Tensor, Tensor, Tensor]:
    """Each problem's pool from every shard, in shard order: rows [P, 1, D*k,
    SAMPLE_DIM], ids [P, 1, D*k], costs [P, 1, D*k] (the 1 broadcasts over
    a problem's trees). Across ranks the three travel as one int32 buffer,
    bit for bit."""
    rows, ids, costs = pool
    P = s.n_problems
    if mesh is not None and mesh.spans("tree"):
        packed = torch.cat([rows.view(torch.int32), ids[:, None],
                            costs.view(torch.int32)[:, None]], dim=1)
        packed = collectives.axis_gather(mesh, "tree", packed.view(P, -1, SAMPLE_DIM + 2),
                                         dim=1)
        rows = packed[..., :SAMPLE_DIM].contiguous().view(torch.float32)
        ids = packed[..., SAMPLE_DIM].contiguous()
        costs = packed[..., SAMPLE_DIM + 1].contiguous().view(torch.float32)
    return (rows.view(P, 1, -1, SAMPLE_DIM), ids.view(P, 1, -1), costs.view(P, 1, -1))


def sharded_readout(cfg: KGMTConfig, s: ShardedState,
                    mesh: PlannerMesh | None = None) -> tuple[bool, int]:
    """The iteration's one read from the device: (done, the most sub-waves
    any running shard runs in the next iteration). A problem is done when
    every shard of it is full, the budget is spent, or (with
    ``stop_on_first_solution``) a shard of it holds a solution
    (cudasbmp_tpu/parallel/sharded_tree.py:78-99); the flags are reduced
    over the tree axis in one collective, so every rank of a problem reads
    the same. With several problems, ``s.live`` marks those still running
    and ``s.done_at`` records when each stopped."""
    n_tgt = _fresh_target(cfg, s.tree_size - s.frontier_lo, s.tree_size)
    n_waves = _num_waves(cfg, n_tgt)
    P = s.n_problems
    not_full = (s.tree_size < cfg.max_tree_size).view(P, -1).any(1)
    solved = torch.isfinite(s.cost_to_goal).view(P, -1).any(1)
    if not cfg.stop_on_first_solution:
        solved = torch.zeros_like(solved)
    flags = torch.stack([not_full.long(), solved.long(), n_waves.view(P, -1).amax(1)],
                        dim=1)
    flags = collectives.axis_max(mesh, "tree", flags)
    if P > 1:
        s.live = (flags[:, 0] > 0) & (flags[:, 1] == 0)
    budget = s.itr >= cfg.num_iterations
    live, waves = [], 0
    for p, (more, sol, w) in enumerate(flags.tolist()):
        live.append(bool(more and not sol and not budget))
        if live[-1]:
            waves = max(waves, int(w))
        elif s.done_at is not None and s.done_at[p] is None:
            s.done_at[p] = s.itr
    return not any(live), waves


def sharded_trip(cfg: KGMTConfig, system, grid: RegionGrid, goals: Tensor,
                 obstacles: Tensor, s: ShardedState, w: int, fl0: Tensor,
                 ts0: Tensor, n_tgt: Tensor, n_waves: Tensor, r1_score: Tensor,
                 r2_seen: Tensor, pool) -> Tensor:
    """Sub-wave ``w`` of the iteration for every tree whose count of
    sub-waves exceeds it and whose problem runs (the rest change nothing:
    their slots are inactive): the parents (read at their local rows; pool
    slots from the pool's own rows and costs; ids global ``shard * M +
    slot``), then the batched wave (multi_query.batched_wave), in place
    (cudasbmp_tpu/planners/kgmt.py::_wave_step with ``pool`` and
    ``gid_base = shard * M``). ``goals`` [L, SAMPLE_DIM] and ``r1_score``
    [L, N*N] are each tree's. Returns r2_seen with the trip's arrivals."""
    L, M = s.costs.shape
    P = s.n_problems
    R = cfg.rollouts_per_iter
    dev = goals.device
    run = w < n_waves
    if s.live is not None:
        run = run & per_tree(s, s.live)
    slot = torch.arange(R, dtype=torch.int64, device=dev)
    gslot = w * R + slot
    rows0 = torch.arange(L, device=dev) * M
    gid0 = rows0 if s.rows_are_ids else shard_ids(s) * M
    slot_active = gslot < n_tgt[:, None]
    parent_idx = fl0[:, None] + gslot % (ts0 - fl0).clamp(min=1)[:, None]
    if cfg.goal_bias > 0.0:
        window = types.SimpleNamespace(fl0=fl0, ts0=ts0, tree_samples=s.tree_samples)
        parent_idx = _goal_biased(cfg, window, goals, parent_idx)
    parent_row = rows0[:, None] + parent_idx
    parent_gid = parent_row if s.rows_are_ids else gid0[:, None] + parent_idx
    parent_rows = s.flat_samples[parent_row]
    parent_cost = s.flat_costs[parent_row]
    if pool is not None:
        by_problem = apply_pool(cfg, gslot, parent_rows.view(P, -1, R, SAMPLE_DIM),
                                parent_cost.view(P, -1, R), parent_gid.view(P, -1, R),
                                slot_active.view(P, -1, R), pool)
        parent_rows, parent_cost, parent_gid, slot_active = (
            x.reshape(L, *x.shape[2:]) for x in by_problem)
    slot_active = slot_active & run[:, None]
    key_wave = rng.fold_in(s.key, s.itr)
    if w:
        key_wave = rng.fold_in(key_wave, w)
    keys = rng.split(key_wave)
    d1, d2, valid, within, samples1, r2_seen = batched_wave(
        cfg, system, grid, goals, obstacles, s, slot, parent_rows, parent_cost,
        parent_gid, slot_active, keys[:, 0].contiguous(), keys[:, 1].contiguous(),
        r1_score, r2_seen, gid0)
    s.r2_total += d2[..., 0]
    s.r2_valid += d2[..., 1]
    s.r2_invalid += d2[..., 0] - d2[..., 1]
    s.u_samples = torch.where(run[:, None, None], samples1, s.u_samples)
    s.u_parent = torch.where(run[:, None], parent_gid.to(torch.int32), s.u_parent)
    s.m_valid[:, s.itr] += valid.sum(dim=1, dtype=torch.int32)
    s.m_accepted[:, s.itr] += within.sum(dim=1, dtype=torch.int32)
    s.trips += 1
    return r2_seen


def sharded_iteration(cfg: KGMTConfig, system, grid: RegionGrid, goal: Tensor,
                      obstacles: Tensor, s: ShardedState, n_trips: int,
                      mesh: PlannerMesh | None = None) -> None:
    """One iteration of every tree, in place (cudasbmp_tpu/planners/
    kgmt.py::kgmt_iteration with ``axis_name``): global scores (each
    problem's statistics summed over its shards on the tree axis), the
    iteration's frontier ranges and targets, the exchange pool (each
    problem's, concatenated over the tree axis), then ``n_trips`` trips
    (``sharded_readout``'s count: the most sub-waves of any running shard),
    then each shard's frontier moves on (or stays, on a stall with retry).
    ``goal`` is [SAMPLE_DIM], or one a problem; a problem that is done
    (``s.live``) keeps its state."""
    L = s.costs.shape[0]
    P = s.n_problems
    dev = goal.device
    goals = per_tree(s, goal.view(P, -1))
    live = None if s.live is None else per_tree(s, s.live)

    def keep(new: Tensor, old: Tensor) -> Tensor:
        if live is None:
            return new
        return torch.where(live.view(-1, *([1] * (new.dim() - 1))), new, old)

    with phase_scope("kgmt_scores", dev):
        # each problem's sums over this process's shards, then over the axis
        counts = [x.view(P, -1, x.shape[-1]).sum(1, dtype=torch.int32)
                  for x in (s.r1_total, s.r1_valid, s.r1_invalid)]
        avail = [x.view(P, -1, x.shape[-1]).sum(1) for x in (s.r1_avail, s.r2_avail)]
        r1_total, r1_valid, r1_invalid, r1_avail, r2_avail = collectives.axis_sum(
            mesh, "tree", counts + avail)
        glob = types.SimpleNamespace(
            r1_total=r1_total, r1_valid=r1_valid, r1_invalid=r1_invalid,
            r1_avail=(r1_avail > 0).to(torch.int32),
            r2_avail=(r2_avail > 0).to(torch.int32))
        r1_score, r1_thr = update_region_scores(cfg, glob)
    with phase_scope("kgmt_frontier", dev):
        fl0, ts0 = s.frontier_lo, s.tree_size
        n_tgt = _fresh_target(cfg, ts0 - fl0, ts0)
        n_waves = _num_waves(cfg, n_tgt)
    pool = None
    if cfg.exchange_frac > 0.0:
        with phase_scope("kgmt_frontier_exchange", dev):
            pool = gather_pool(mesh, s, exchange_pool(
                cfg, s.tree_samples, s.costs, fl0, ts0, goals, shard_ids(s)))
    r2_seen = per_tree(s, glob.r2_avail).clone()
    r1_tree = per_tree(s, r1_score)
    with phase_scope("kgmt_waves", dev):
        for w in range(n_trips):
            r2_seen = sharded_trip(cfg, system, grid, goals, obstacles, s, w, fl0,
                                   ts0, n_tgt, n_waves, r1_tree, r2_seen, pool)
    stalled = s.tree_size == ts0
    new_lo = torch.where(stalled, fl0, ts0) if cfg.keep_frontier_on_stall else ts0
    s.frontier_lo = keep(new_lo, s.frontier_lo)
    s.stalled = keep(stalled, s.stalled)
    s.r1_score = keep(r1_tree.clone(), s.r1_score)
    s.r1_threshold = keep(per_tree(s, r1_thr).clone(), s.r1_threshold)
    s.m_frontier_size[:, s.itr] = keep((ts0 - fl0).to(torch.int32),
                                       s.m_frontier_size[:, s.itr])
    s.m_tree_size[:, s.itr] = keep(s.tree_size.to(torch.int32), s.m_tree_size[:, s.itr])
    s.itr += 1


def sharded_run(cfg: KGMTConfig, system, grid: RegionGrid, goal: Tensor,
                obstacles: Tensor, s: ShardedState, max_iters: int | None = None,
                mesh: PlannerMesh | None = None) -> bool:
    """Iterations until done (``sharded_readout``), at most ``max_iters`` of
    them when given (a chunk of ``plan_checkpointed``); in place. Returns
    whether the solve is done. One host read an iteration, and one before
    the first; every rank of the tree axis reads the same values, so all
    run the same iterations and trips."""
    limit = cfg.num_iterations if max_iters is None else max_iters
    done, trips = sharded_readout(cfg, s, mesh)
    n = 0
    while n < limit and not done:
        sharded_iteration(cfg, system, grid, goal, obstacles, s, trips, mesh)
        done, trips = sharded_readout(cfg, s, mesh)
        n += 1
    return done


def stitch_path(parents_by_shard: np.ndarray, samples_by_shard: np.ndarray,
                goal_gid: int, max_tree_size: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """Walk global parent ids from the goal node to the root, hopping shards
    where the chain crosses them. Returns (path [L, SAMPLE_DIM] root ->
    goal, shard_of_node [L])."""
    rows, shards = [], []
    g = int(goal_gid)
    guard = parents_by_shard.size + 1
    while g >= 0 and guard > 0:
        d, i = divmod(g, max_tree_size)
        rows.append(samples_by_shard[d, i])
        shards.append(d)
        g = int(parents_by_shard[d, i])
        guard -= 1
    assert guard > 0, "parent-id cycle: corrupt stitched tree"
    return (np.asarray(rows[::-1], np.float32),
            np.asarray(shards[::-1], np.int32))


def gather_trees(mesh: PlannerMesh | None, s: ShardedState, x: Tensor) -> Tensor:
    """A per-tree field [L, ...] of every shard: [n_problems, D, ...], the
    tree axis concatenated in shard order (a view on one process)."""
    x = x.view(s.n_problems, -1, *x.shape[1:])
    return collectives.axis_gather(mesh, "tree", x, dim=1)


def sharded_state_to_numpy(s: ShardedState, mesh: PlannerMesh | None = None
                           ) -> dict[str, np.ndarray]:
    """The stacked state of one problem, every shard of it (gathered over
    the tree axis where it spans ranks), as the JAX package's stacked
    KGMTState arrays: int32 frontier_lo, tree_size and itr [D], uint32 key
    data [D, 2]."""
    out = {}
    for name in STATE_FIELDS:
        v = getattr(s, name)
        if name == "itr":
            continue
        v = gather_trees(mesh, s, v)[0].cpu().numpy()
        if name == "key":
            v = v.astype(np.uint32)
        elif name in ("frontier_lo", "tree_size"):
            v = v.astype(np.int32)
        out[name] = v
    out["itr"] = np.full(out["costs"].shape[0], s.itr, np.int32)
    return {name: out[name] for name in STATE_FIELDS}


def sharded_state_from_numpy(d, device: torch.device | str, rollouts_per_iter: int,
                             shards: tuple[int, int] | None = None) -> ShardedState:
    """A ShardedState from stacked KGMTState arrays (``sharded_state_to_numpy``
    or a JAX state's ``{**state._asdict(), 'key': key_data}``): the shards
    [lo, hi) of ``shards`` (default every one); the scratch rows are
    ``rollouts_per_iter`` a shard."""
    lo, hi = (0, np.asarray(d["costs"]).shape[0]) if shards is None else shards
    arr = {k: np.asarray(d[k])[lo:hi] for k in STATE_FIELDS}
    itr = np.unique(arr["itr"])
    if itr.size != 1:
        raise ValueError(f"shards at different iterations {itr.tolist()}")
    D, M = arr["costs"].shape
    R = rollouts_per_iter
    flat_samples = torch.zeros((D * M + D * R, SAMPLE_DIM), dtype=torch.float32,
                               device=device)
    flat_parent = torch.full((D * M + D * R,), -1, dtype=torch.int32, device=device)
    flat_costs = torch.zeros(D * M + D * R, dtype=torch.float32, device=device)
    flat_samples[:D * M] = torch.as_tensor(arr["tree_samples"].reshape(D * M, -1),
                                           device=device)
    flat_parent[:D * M] = torch.as_tensor(arr["tree_parent"].reshape(-1), device=device)
    flat_costs[:D * M] = torch.as_tensor(arr["costs"].reshape(-1), device=device)
    fields = {}
    for name in STATE_FIELDS:
        v = arr[name]
        if name == "itr":
            fields[name] = int(itr[0])
        elif name == "key":
            fields[name] = torch.as_tensor(v.astype(np.uint32).astype(np.int64),
                                           device=device)
        elif name in ("frontier_lo", "tree_size"):
            fields[name] = torch.as_tensor(v.astype(np.int64), device=device)
        elif name in ("tree_samples", "tree_parent", "costs"):
            continue
        else:
            fields[name] = torch.as_tensor(v.copy(), device=device)
    return ShardedState(
        tree_samples=flat_samples[:D * M].view(D, M, SAMPLE_DIM),
        tree_parent=flat_parent[:D * M].view(D, M),
        costs=flat_costs[:D * M].view(D, M),
        flat_samples=flat_samples, flat_parent=flat_parent, flat_costs=flat_costs,
        shard0=lo, done_at=[None], **fields)


def save_sharded_checkpoint(s: ShardedState, path, mesh: PlannerMesh | None = None
                            ) -> None:
    """The whole stacked state in the JAX package's npz layout (marker
    KGMTState, every field with a leading shard axis), written atomically by
    rank 0 after the shards are gathered; every rank waits for the write."""
    from cudasbmp_torch.io.checkpoint import write_state_npz

    fields = sharded_state_to_numpy(s, mesh)
    if mesh is None or mesh.rank == 0:
        write_state_npz(path, "KGMTState", fields)
    if mesh is not None and mesh.world > 1:
        import torch.distributed as dist

        dist.barrier()


def read_sharded_checkpoint(path) -> dict[str, np.ndarray]:
    """The stacked KGMTState arrays of a file of either package."""
    from cudasbmp_torch.io.checkpoint import read_state_npz

    name, fields = read_state_npz(path)
    if name != "KGMTState" or np.asarray(fields["costs"]).ndim != 2:
        raise ValueError(f"{path} holds no stacked (sharded) KGMTState")
    return fields


def load_sharded_checkpoint(path, device: torch.device | str,
                            rollouts_per_iter: int) -> ShardedState:
    """A stacked state file of either package, on ``device``."""
    return sharded_state_from_numpy(read_sharded_checkpoint(path), device,
                                    rollouts_per_iter)


class ShardedTreePlanner:
    """One logical KGMT planner sharded over the mesh's ``tree`` axis: this
    rank's shards on the mesh's device (``make_planner_mesh(...,
    device=...)``), the rest on the other ranks of its tree axis."""

    def __init__(self, config: KGMTConfig | None = None,
                 mesh: PlannerMesh | None = None, system=None):
        if mesh is None:
            raise ValueError("ShardedTreePlanner requires a mesh with a "
                             "'tree' axis (parallel.mesh.make_planner_mesh)")
        self.config = config or KGMTConfig()
        self.mesh = mesh
        self.n_shards = mesh.shape["tree"]
        self.shards = mesh.local_range("tree")
        self.system = system or get_system(self.config.system)
        cfg = self.config
        self.grid = RegionGrid(width=cfg.width, height=cfg.height, N=cfg.N, n=cfg.n)
        self.device = resolve_device(mesh.device)
        self.last_state: ShardedState | None = None

    def _inputs(self, scenario: Scenario) -> tuple[Tensor, Tensor]:
        """(goal [SAMPLE_DIM], the scenario's boxes once a local shard [Dl,
        K, 4])."""
        dev = self.device
        lo, hi = self.shards
        boxes = torch.as_tensor(scenario.padded_obstacles(self.config.max_obstacles)[0],
                                device=dev)
        return (torch.as_tensor(scenario.goal, device=dev),
                boxes.expand(hi - lo, -1, -1).contiguous())

    def _init(self, scenario: Scenario, seed: int | None, inits,
              key: Tensor | None = None) -> ShardedState:
        """This rank's shards at iteration 0: roots from ``inits`` (default
        the scenario's init), keys ``fold_in(key, shard)`` of their global
        indices, ``key`` defaulting to ``key(seed)``."""
        cfg, dev, D = self.config, self.device, self.n_shards
        lo, hi = self.shards
        if inits is None:
            inits = np.tile(scenario.init, (D, 1))
        inits = np.asarray(inits, np.float32)
        if inits.shape != (D, SAMPLE_DIM):
            raise ValueError(f"inits must be [{D}, {SAMPLE_DIM}]")
        if key is None:
            key = rng.key(cfg.seed if seed is None else seed, dev)
        keys = rng.fold_in(key, torch.arange(lo, hi, device=dev))
        return init_sharded_state(cfg, self.grid,
                                  torch.as_tensor(inits[lo:hi], device=dev), keys,
                                  shard0=lo)

    def plan(self, scenario: Scenario, seed: int | None = None,
             inits: np.ndarray | None = None) -> ShardedTreeResult:
        """Solve ``scenario``. ``inits`` optionally seeds each shard's root
        with its own sample ([n_shards, SAMPLE_DIM]; default: every shard
        seeds the scenario's init)."""
        goal, boxes = self._inputs(scenario)
        _synchronize(self.device)
        t0 = time.perf_counter()
        s = self._init(scenario, seed, inits)
        sharded_run(self.config, self.system, self.grid, goal, boxes, s, mesh=self.mesh)
        return self._build_result(s, t0)

    def plan_checkpointed(self, scenario: Scenario, ckpt_dir, checkpoint_every: int = 4,
                          seed: int | None = None, inits: np.ndarray | None = None,
                          resume_from=None, chunk_delay_s: float = 0.0
                          ) -> ShardedTreeResult:
        """Solve like plan(), in ``checkpoint_every``-iteration chunks, writing
        ``sharded_checkpoint_<itr>.npz`` (``save_sharded_checkpoint``) under
        ``ckpt_dir`` after each. ``resume_from`` (a file of either package,
        written on any number of ranks with this tree axis) continues a
        solve; chunked or resumed, the result is plan()'s to the bit.
        ``chunk_delay_s`` sleeps after each chunk (a test's window for a
        kill mid-solve, as the JAX package's)."""
        cfg = self.config
        ckpt_dir = pathlib.Path(ckpt_dir)
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        goal, boxes = self._inputs(scenario)
        _synchronize(self.device)
        t0 = time.perf_counter()
        if resume_from is not None:
            fields = read_sharded_checkpoint(resume_from)
            n_ck = np.asarray(fields["costs"]).shape[0]
            if n_ck != self.n_shards:
                raise ValueError(
                    f"checkpoint {resume_from} holds {n_ck} tree shards but this "
                    f"planner's mesh has n_tree={self.n_shards}; resume on a mesh "
                    "with the same tree-axis size")
            s = sharded_state_from_numpy(fields, self.device, cfg.rollouts_per_iter,
                                         self.shards)
        else:
            s = self._init(scenario, seed, inits)
        while True:
            done = sharded_run(cfg, self.system, self.grid, goal, boxes, s,
                               max_iters=checkpoint_every, mesh=self.mesh)
            save_sharded_checkpoint(s, ckpt_dir / f"sharded_checkpoint_{s.itr}.npz",
                                    self.mesh)
            if chunk_delay_s:
                time.sleep(chunk_delay_s)
            if done or s.itr >= cfg.num_iterations:
                break
        return self._build_result(s, t0)

    def _build_result(self, s: ShardedState, t0: float) -> ShardedTreeResult:
        """The host's reduction and the cross-shard path stitch, over every
        shard: the fields read are gathered once where the tree axis spans
        ranks (``last_state`` holds this rank's trees, as the sharded
        multi-query planner's does)."""
        cfg = self.config
        costs, sizes, goal_nodes, parents, samples, scores = (
            gather_trees(self.mesh, s, t)[0].cpu().numpy()
            for t in (s.cost_to_goal, s.tree_size, s.goal_node, s.tree_parent,
                      s.tree_samples, s.r1_score))
        wall = time.perf_counter() - t0
        self.last_state = s
        best = int(np.argmin(np.where(np.isfinite(costs), costs, np.inf)))
        solved = bool(np.isfinite(costs[best]))
        if solved:
            path, path_shards = stitch_path(parents, samples, int(goal_nodes[best]),
                                            cfg.max_tree_size)
            best_shard = int(goal_nodes[best]) // cfg.max_tree_size
        else:
            path = np.zeros((0, SAMPLE_DIM), np.float32)
            path_shards = np.zeros(0, np.int32)
            best_shard = best
        return ShardedTreeResult(
            solved=solved,
            cost=float(costs[best]) if solved else float("inf"),
            best_shard=best_shard,
            iterations=s.itr,
            total_tree_size=int(sizes.sum()),
            wall_time_s=wall,
            path=path,
            path_shards=path_shards,
            tree_sizes_by_shard=sizes.astype(np.int32),
            r1_scores_by_shard=scores,
        )
