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
all start the next iteration together. Here every shard lives on the one
device, stacked on a leading axis as MultiQueryPlanner stacks problems; the
global ids are the rows of the flat tree buffers. The host loop has two levels:
iterations, where the exchanges run and the host reads ONE small tensor
(whether the solve is done, and the most sub-waves any shard needs next),
and within an iteration, trips up to that count, each shard masked past
its own. A trip is one rollout launch over D x R lanes: kernel B6 with the
one box set given to every shard (``auto``/``cuda``), B6's Philox form
keyed per shard (``cuda_rng``), or the plain exact rollout (``torch``).

The solve ends when any shard reaches the goal (with
``stop_on_first_solution``), every shard is full, or the budget is spent.
The result is the cheapest solution of any shard, its path stitched across
shards on the host by walking global parent ids. ``plan_checkpointed``
runs in chunks and writes the stacked state after each in the JAX
package's npz layout (every KGMTState field with a leading shard axis), so
each package resumes the other's files.
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
    """The fields of KGMTState with a leading shard axis D, on the device,
    plus the flat buffers the trees are views of (D * R scratch rows at the
    end take the children a trip drops). The shards move through iterations
    together, so ``itr`` is one host int."""

    tree_samples: Tensor  # f32 [D, M, SAMPLE_DIM]
    tree_parent: Tensor  # i32 [D, M], global ids (shard * M + slot), -1 unset
    costs: Tensor  # f32 [D, M]
    frontier_lo: Tensor  # i64 [D]
    tree_size: Tensor  # i64 [D]
    r1_total: Tensor  # i32 [D, N*N], this shard's counts
    r1_valid: Tensor
    r1_invalid: Tensor
    r1_avail: Tensor
    r1_score: Tensor  # f32 [D, N*N], every row the global scores
    r2_total: Tensor  # i32 [D, N*N*n*n]
    r2_valid: Tensor
    r2_invalid: Tensor
    r2_avail: Tensor
    r1_threshold: Tensor  # f32 [D]
    u_samples: Tensor  # f32 [D, R, SAMPLE_DIM], each shard's latest wave
    u_parent: Tensor  # i32 [D, R], global ids
    cost_to_goal: Tensor  # f32 [D], +inf until solved
    goal_node: Tensor  # i32 [D], a global id, -1 until solved
    itr: int
    key: Tensor  # int64 [D, 2]
    stalled: Tensor  # bool [D]
    m_frontier_size: Tensor  # i32 [D, max(num_iterations, 1)]
    m_valid: Tensor
    m_accepted: Tensor
    m_tree_size: Tensor
    flat_samples: Tensor  # f32 [D*M + D*R, SAMPLE_DIM]
    flat_parent: Tensor  # i32 [D*M + D*R]
    flat_costs: Tensor  # f32 [D*M + D*R]
    trips: int = 0


# ShardedState's fields that are KGMTState's (the checkpoint's arrays)
STATE_FIELDS = tuple(f.name for f in dataclasses.fields(ShardedState)
                     if not f.name.startswith("flat_") and f.name != "trips")


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


def init_sharded_state(cfg: KGMTConfig, grid: RegionGrid, inits: Tensor,
                       keys: Tensor) -> ShardedState:
    """init_state for every shard (multi_query.init_batch_state's trees,
    counters and keys: root ``inits[d]`` in slot 0 of shard d, its regions
    marked), plus the fields the sharded result and checkpoint carry."""
    b = init_batch_state(cfg, grid, inits, keys)
    D, dev = inits.shape[0], inits.device
    R, nr2 = cfg.rollouts_per_iter, cfg.num_r2

    def zeros(*shape: int) -> Tensor:
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    it = max(cfg.num_iterations, 1)
    shared = {f.name: getattr(b, f.name) for f in dataclasses.fields(ShardedState)
              if hasattr(b, f.name) and f.name not in ("itr", "trips")}
    return ShardedState(
        **shared, itr=0,
        r2_total=zeros(D, nr2), r2_valid=zeros(D, nr2), r2_invalid=zeros(D, nr2),
        r1_threshold=torch.zeros(D, dtype=torch.float32, device=dev),
        u_samples=torch.zeros((D, R, SAMPLE_DIM), dtype=torch.float32, device=dev),
        u_parent=torch.full((D, R), -1, dtype=torch.int32, device=dev),
        m_frontier_size=zeros(D, it), m_valid=zeros(D, it),
        m_accepted=zeros(D, it), m_tree_size=zeros(D, it))


def exchange_pool(cfg: KGMTConfig, tree_samples: Tensor, costs: Tensor,
                  frontier_lo: Tensor, tree_size: Tensor, goal: Tensor
                  ) -> tuple[Tensor, Tensor, Tensor]:
    """The frontier exchange (cudasbmp_tpu/planners/kgmt.py:627-648): each
    shard's ``min(exchange_k, M)`` tree rows nearest the goal among its
    frontier [frontier_lo, tree_size), in ``lax.top_k``'s order of ``-d2``
    (a stable ascending sort of d2 with inf outside the frontier: ties to
    the lower slot, padding past the frontier's size from the lowest slots
    outside it). Returns the shards' lists concatenated: (rows [D*k,
    SAMPLE_DIM], global ids i32 [D*k], -1 on padding, costs [D*k])."""
    D, M = costs.shape
    idx = torch.arange(M, device=costs.device)
    in_frontier = (idx >= frontier_lo[:, None]) & (idx < tree_size[:, None])
    dx = tree_samples[..., 0] - goal[0]
    dy = tree_samples[..., 1] - goal[1]
    d2 = torch.where(in_frontier, dx * dx + dy * dy, float("inf"))
    k = min(cfg.exchange_k, M)
    best, cand = torch.sort(d2, dim=1, stable=True)
    best, cand = best[:, :k], cand[:, :k]
    rows = tree_samples.gather(1, cand[..., None].expand(D, k, SAMPLE_DIM))
    ids = torch.where(torch.isfinite(best),
                      torch.arange(D, device=cand.device)[:, None] * M + cand, -1)
    return (rows.reshape(D * k, SAMPLE_DIM), ids.reshape(-1).to(torch.int32),
            costs.gather(1, cand).reshape(-1))


def sharded_readout(cfg: KGMTConfig, s: ShardedState) -> tuple[bool, int]:
    """The iteration's one read from the device: (done, the most sub-waves
    any shard runs in the next iteration). Done: every shard full, the
    budget spent, or (with ``stop_on_first_solution``) a solution in any
    shard (cudasbmp_tpu/parallel/sharded_tree.py:78-99)."""
    n_tgt = _fresh_target(cfg, s.tree_size - s.frontier_lo, s.tree_size)
    n_waves = _num_waves(cfg, n_tgt)
    full = (s.tree_size >= cfg.max_tree_size).all()
    solved = torch.isfinite(s.cost_to_goal).any()
    if not cfg.stop_on_first_solution:
        solved = torch.zeros_like(solved)
    full, solved, waves = torch.stack(
        [full.long(), solved.long(), n_waves.max()]).tolist()
    return bool(full or solved or s.itr >= cfg.num_iterations), int(waves)


def sharded_trip(cfg: KGMTConfig, system, grid: RegionGrid, goal: Tensor,
                 obstacles: Tensor, s: ShardedState, w: int, fl0: Tensor,
                 ts0: Tensor, n_tgt: Tensor, n_waves: Tensor, r1_score: Tensor,
                 r2_seen: Tensor, pool) -> Tensor:
    """Sub-wave ``w`` of the iteration for every shard whose count of
    sub-waves exceeds it (the rest change nothing: their slots are
    inactive): the parents (pool slots included, global ids ``shard * M +
    slot``), then the batched wave (multi_query.batched_wave), in place
    (cudasbmp_tpu/planners/kgmt.py::_wave_step with ``pool`` and
    ``gid_base = shard * M``). Returns r2_seen with the trip's arrivals."""
    D, M = s.costs.shape
    R = cfg.rollouts_per_iter
    dev = goal.device
    run = w < n_waves
    slot = torch.arange(R, dtype=torch.int64, device=dev)
    gslot = w * R + slot
    base = torch.arange(D, device=dev) * M
    goals = goal.expand(D, -1)
    slot_active = gslot < n_tgt[:, None]
    parent_idx = fl0[:, None] + gslot % (ts0 - fl0).clamp(min=1)[:, None]
    if cfg.goal_bias > 0.0:
        window = types.SimpleNamespace(fl0=fl0, ts0=ts0, tree_samples=s.tree_samples)
        parent_idx = _goal_biased(cfg, window, goals, parent_idx)
    parent_gid = base[:, None] + parent_idx
    parent_rows = s.flat_samples[parent_gid]
    parent_cost = s.flat_costs[parent_gid]
    if pool is not None:
        parent_rows, parent_cost, parent_gid, slot_active = apply_pool(
            cfg, gslot, parent_rows, parent_cost, parent_gid, slot_active, pool)
    slot_active = slot_active & run[:, None]
    key_wave = rng.fold_in(s.key, s.itr)
    if w:
        key_wave = rng.fold_in(key_wave, w)
    keys = rng.split(key_wave)
    d1, d2, valid, within, samples1, r2_seen = batched_wave(
        cfg, system, grid, goals, obstacles, s, slot, parent_rows, parent_cost,
        parent_gid, slot_active, keys[:, 0].contiguous(), keys[:, 1].contiguous(),
        r1_score.expand(D, -1), r2_seen, base)
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
                      obstacles: Tensor, s: ShardedState, n_trips: int) -> None:
    """One iteration of every shard, in place (cudasbmp_tpu/planners/
    kgmt.py::kgmt_iteration with ``axis_name``): global scores, the
    iteration's frontier ranges and targets, the exchange pool, then
    ``n_trips`` trips (``sharded_readout``'s count: the most sub-waves of
    any shard), then each shard's frontier moves on (or stays, on a stall
    with retry)."""
    D = s.costs.shape[0]
    dev = goal.device
    with phase_scope("kgmt_scores", dev):
        glob = types.SimpleNamespace(
            r1_total=s.r1_total.sum(0, dtype=torch.int32),
            r1_valid=s.r1_valid.sum(0, dtype=torch.int32),
            r1_invalid=s.r1_invalid.sum(0, dtype=torch.int32),
            r1_avail=(s.r1_avail.sum(0) > 0).to(torch.int32),
            r2_avail=(s.r2_avail.sum(0) > 0).to(torch.int32))
        r1_score, r1_thr = update_region_scores(cfg, glob)
    with phase_scope("kgmt_frontier", dev):
        fl0, ts0 = s.frontier_lo, s.tree_size
        n_tgt = _fresh_target(cfg, ts0 - fl0, ts0)
        n_waves = _num_waves(cfg, n_tgt)
    pool = None
    if cfg.exchange_frac > 0.0:
        with phase_scope("kgmt_frontier_exchange", dev):
            pool = exchange_pool(cfg, s.tree_samples, s.costs, fl0, ts0, goal)
    r2_seen = glob.r2_avail.expand(D, -1).clone()
    with phase_scope("kgmt_waves", dev):
        for w in range(n_trips):
            r2_seen = sharded_trip(cfg, system, grid, goal, obstacles, s, w, fl0,
                                   ts0, n_tgt, n_waves, r1_score, r2_seen, pool)
    stalled = s.tree_size == ts0
    s.frontier_lo = torch.where(stalled, fl0, ts0) if cfg.keep_frontier_on_stall else ts0
    s.stalled = stalled
    s.r1_score = r1_score.expand(D, -1).clone()
    s.r1_threshold = r1_thr.expand(D).clone()
    s.m_frontier_size[:, s.itr] = (ts0 - fl0).to(torch.int32)
    s.m_tree_size[:, s.itr] = s.tree_size.to(torch.int32)
    s.itr += 1


def sharded_run(cfg: KGMTConfig, system, grid: RegionGrid, goal: Tensor,
                obstacles: Tensor, s: ShardedState,
                max_iters: int | None = None) -> bool:
    """Iterations until done (``sharded_readout``), at most ``max_iters`` of
    them when given (a chunk of ``plan_checkpointed``); in place. Returns
    whether the solve is done. One host read an iteration, and one before
    the first."""
    limit = cfg.num_iterations if max_iters is None else max_iters
    done, trips = sharded_readout(cfg, s)
    n = 0
    while n < limit and not done:
        sharded_iteration(cfg, system, grid, goal, obstacles, s, trips)
        done, trips = sharded_readout(cfg, s)
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


def sharded_state_to_numpy(s: ShardedState) -> dict[str, np.ndarray]:
    """The stacked state as the JAX package's stacked KGMTState arrays:
    int32 frontier_lo, tree_size and itr [D], uint32 key data [D, 2]."""
    D = s.costs.shape[0]
    out = {}
    for name in STATE_FIELDS:
        v = getattr(s, name)
        if name == "itr":
            out[name] = np.full(D, v, np.int32)
        elif name == "key":
            out[name] = v.cpu().numpy().astype(np.uint32)
        elif name in ("frontier_lo", "tree_size"):
            out[name] = v.cpu().numpy().astype(np.int32)
        else:
            out[name] = v.cpu().numpy()
    return out


def sharded_state_from_numpy(d, device: torch.device | str, rollouts_per_iter: int
                             ) -> ShardedState:
    """A ShardedState from stacked KGMTState arrays (``sharded_state_to_numpy``
    or a JAX state's ``{**state._asdict(), 'key': key_data}``); the scratch
    rows are ``rollouts_per_iter`` a shard."""
    arr = {k: np.asarray(d[k]) for k in STATE_FIELDS}
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
        **fields)


def save_sharded_checkpoint(s: ShardedState, path) -> None:
    """The stacked state in the JAX package's npz layout (marker KGMTState,
    every field with a leading shard axis), written atomically."""
    from cudasbmp_torch.io.checkpoint import write_state_npz

    write_state_npz(path, "KGMTState", sharded_state_to_numpy(s))


def load_sharded_checkpoint(path, device: torch.device | str,
                            rollouts_per_iter: int) -> ShardedState:
    """A stacked state file of either package, on ``device``."""
    from cudasbmp_torch.io.checkpoint import read_state_npz

    name, fields = read_state_npz(path)
    if name != "KGMTState" or np.asarray(fields["costs"]).ndim != 2:
        raise ValueError(f"{path} holds no stacked (sharded) KGMTState")
    return sharded_state_from_numpy(fields, device, rollouts_per_iter)


class ShardedTreePlanner:
    """One logical KGMT planner sharded over the mesh's ``tree`` axis, every
    shard on the mesh's device (``make_planner_mesh(..., device=...)``)."""

    def __init__(self, config: KGMTConfig | None = None,
                 mesh: PlannerMesh | None = None, system=None):
        if mesh is None:
            raise ValueError("ShardedTreePlanner requires a mesh with a "
                             "'tree' axis (parallel.mesh.make_planner_mesh)")
        self.config = config or KGMTConfig()
        self.mesh = mesh
        self.n_shards = mesh.shape["tree"]
        self.system = system or get_system(self.config.system)
        cfg = self.config
        self.grid = RegionGrid(width=cfg.width, height=cfg.height, N=cfg.N, n=cfg.n)
        self.device = resolve_device(mesh.device)
        self.last_state: ShardedState | None = None

    def _inputs(self, scenario: Scenario) -> tuple[Tensor, Tensor]:
        """(goal [SAMPLE_DIM], the scenario's boxes once a shard [D, K, 4])."""
        dev = self.device
        boxes = torch.as_tensor(scenario.padded_obstacles(self.config.max_obstacles)[0],
                                device=dev)
        return (torch.as_tensor(scenario.goal, device=dev),
                boxes.expand(self.n_shards, -1, -1).contiguous())

    def _init(self, scenario: Scenario, seed: int | None, inits) -> ShardedState:
        cfg, dev, D = self.config, self.device, self.n_shards
        if inits is None:
            inits = np.tile(scenario.init, (D, 1))
        inits = np.asarray(inits, np.float32)
        if inits.shape != (D, SAMPLE_DIM):
            raise ValueError(f"inits must be [{D}, {SAMPLE_DIM}]")
        key = rng.key(cfg.seed if seed is None else seed, dev)
        keys = rng.fold_in(key, torch.arange(D, device=dev))
        return init_sharded_state(cfg, self.grid, torch.as_tensor(inits, device=dev),
                                  keys)

    def plan(self, scenario: Scenario, seed: int | None = None,
             inits: np.ndarray | None = None) -> ShardedTreeResult:
        """Solve ``scenario``. ``inits`` optionally seeds each shard's root
        with its own sample ([n_shards, SAMPLE_DIM]; default: every shard
        seeds the scenario's init)."""
        goal, boxes = self._inputs(scenario)
        _synchronize(self.device)
        t0 = time.perf_counter()
        s = self._init(scenario, seed, inits)
        sharded_run(self.config, self.system, self.grid, goal, boxes, s)
        return self._build_result(s, t0)

    def plan_checkpointed(self, scenario: Scenario, ckpt_dir, checkpoint_every: int = 4,
                          seed: int | None = None, inits: np.ndarray | None = None,
                          resume_from=None) -> ShardedTreeResult:
        """Solve like plan(), in ``checkpoint_every``-iteration chunks, writing
        ``sharded_checkpoint_<itr>.npz`` (``save_sharded_checkpoint``) under
        ``ckpt_dir`` after each. ``resume_from`` (a file of either package)
        continues a solve; chunked or resumed, the result is plan()'s to the
        bit."""
        cfg = self.config
        ckpt_dir = pathlib.Path(ckpt_dir)
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        goal, boxes = self._inputs(scenario)
        _synchronize(self.device)
        t0 = time.perf_counter()
        if resume_from is not None:
            s = load_sharded_checkpoint(resume_from, self.device, cfg.rollouts_per_iter)
            n_ck = s.costs.shape[0]
            if n_ck != self.n_shards:
                raise ValueError(
                    f"checkpoint {resume_from} holds {n_ck} tree shards but this "
                    f"planner's mesh has n_tree={self.n_shards}; resume on a mesh "
                    "with the same tree-axis size")
        else:
            s = self._init(scenario, seed, inits)
        while True:
            done = sharded_run(cfg, self.system, self.grid, goal, boxes, s,
                               max_iters=checkpoint_every)
            save_sharded_checkpoint(s, ckpt_dir / f"sharded_checkpoint_{s.itr}.npz")
            if done or s.itr >= cfg.num_iterations:
                break
        return self._build_result(s, t0)

    def _build_result(self, s: ShardedState, t0: float) -> ShardedTreeResult:
        """The host's reduction and the cross-shard path stitch."""
        cfg = self.config
        costs, sizes, goal_nodes, parents, samples, scores = (
            t.cpu().numpy() for t in (s.cost_to_goal, s.tree_size, s.goal_node,
                                      s.tree_parent, s.tree_samples, s.r1_score))
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
