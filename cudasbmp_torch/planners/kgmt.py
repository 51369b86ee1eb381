"""KGMT: frontier-parallel kinodynamic tree search with adaptive two-level
region guidance, in PyTorch (counterpart of cudasbmp_tpu/planners/kgmt.py).

The JAX planner runs the whole solve as one jitted ``lax.while_loop``. Here
the same flat (iteration x wave) loop is a Python loop on the host that
launches tensor work on the device of the state, and reads back one small
tensor per wave: the number of accepted children, the number of valid
rollouts and whether the goal has been reached (the tree loop also reads
the goal test's best lane, which it indexes by). The host therefore holds the
planner's scalar control state (``tree_size``, ``frontier_lo``, ``itr``,
``stalled`` and the per-iteration metrics) as Python ints and numpy arrays,
and the device holds every tensor.

Per wave, as in the JAX package:

- (c) expand: ``rollouts_per_iter`` slots mapped round-robin onto the
  frontier range (with ``goal_bias``, the first ``round(goal_bias * R)``
  slots cycle over the ``goal_bias_k`` frontier nodes nearest the goal
  instead), controls from the wave's threefry key (bitwise the JAX stream,
  cudasbmp_torch.rng), one rollout kernel launch (with the footprint and
  fast-math options of the config);
- region statistics: exact integer ``index_add_`` counts on r1 and r2 (the
  JAX package's one-hot MXU contraction is a TPU workaround computing the
  same integers); score and seen looked up by direct indexing;
- acceptance: Bernoulli(score of the child's R1 cell) OR virgin R2 subcell;
- (d) commit: accepted children go to the contiguous tail of the tree in
  lane order, clamped at capacity. The tree tensors are updated IN PLACE
  (the JAX state is immutable); only rows ``[tree_size, tree_size + n)``
  are written, so nothing lands at index M;
- (e) goal: the cheapest child inside the goal radius, first lane on ties.

``KGMT.resume`` continues a (checkpointed, io/checkpoint.py) state to its
end; ``KGMT.plan_recorded`` steps ``kgmt_iteration`` with per-iteration
artifact dumps. ``expansion_wave`` also takes the sharded tree's exchange
pool and global-id base (parallel/sharded_tree.py drives the batched form).

The loops run under ``utils.profiling.phase_scope`` spans, so a
``trace_to`` trace shows them (the tree is utils/profiling.py's):

- ``kgmt_plan`` (seed, problems): ``plan``/``resume``, tree or pathless;
  ``kgmt_init`` (the inputs on the device, the key, the state, the first
  ``solved`` read), then the waves, then ``kgmt_extract`` (the path walk
  and the result's reads);
- ``kgmt_wave`` (itr, w): each wave of ``kgmt_run`` and
  ``kgmt_run_pathless``: ``kgmt_scores`` at w = 0, ``kgmt_parents``,
  ``kgmt_rng`` (the wave keys), ``kgmt_expand`` (with ``kgmt_rng`` around
  the threefry controls), ``kgmt_region_stats`` (with ``kgmt_rng`` around
  the acceptance uniforms), ``kgmt_goal``, ``kgmt_commit`` (with the wave's
  ``kgmt_host_read``; the tree loop's goal test has one too) and
  ``kgmt_boundary`` (the statistics tail and the iteration boundary);
- ``kgmt_iteration``'s stepwise form keeps ``kgmt_scores``,
  ``kgmt_frontier`` and ``kgmt_waves``, the same wave phases inside.

Every read of the card goes through ``utils.profiling.host_read``: two a
wave of the tree loop (the goal test's best lane, the readout), one a
wave of the pathless loop, and per call one before the waves and five in
the result (cost, path length, path, path nodes, threshold), two in the
pathless result.
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
from cudasbmp_torch.ops.rollout_cuda import (rollout_cuda, rollout_route,
                                             sample_and_rollout_cuda)
from cudasbmp_torch.systems.registry import get_system
from cudasbmp_torch.utils.profiling import host_read, phase_scope

Tensor = torch.Tensor


@dataclasses.dataclass
class KGMTState:
    """Planner state; field names and meanings as cudasbmp_tpu's KGMTState.
    Tensors live on the planner's device; scalars and metrics on the host."""

    tree_samples: Tensor  # f32 [M, SAMPLE_DIM]
    tree_parent: Tensor  # i32 [M], -1 = unset
    costs: Tensor  # f32 [M], trajectory time from the root
    frontier_lo: int  # the frontier is the range [frontier_lo, tree_size)
    tree_size: int
    r1_total: Tensor  # i32 [N*N]
    r1_valid: Tensor
    r1_invalid: Tensor
    r1_avail: Tensor
    r1_score: Tensor  # f32 [N*N]
    r2_total: Tensor  # i32 [N*N*n*n]
    r2_valid: Tensor
    r2_invalid: Tensor
    r2_avail: Tensor
    r1_threshold: Tensor  # f32 scalar (observability only)
    u_samples: Tensor  # f32 [R, SAMPLE_DIM], the latest wave's rollouts
    u_parent: Tensor  # i32 [R]
    cost_to_goal: Tensor  # f32 scalar, +inf until solved
    goal_node: Tensor  # i32 scalar, -1 until solved
    itr: int
    key: Tensor  # int64 [2], threefry key data
    stalled: bool
    m_frontier_size: np.ndarray  # i32 [max(num_iterations, 1)]
    m_valid: np.ndarray
    m_accepted: np.ndarray
    m_tree_size: np.ndarray


@dataclasses.dataclass
class PathlessState:
    """Feasibility-only state (``need_path=False``), as cudasbmp_tpu's
    PathlessState: the frontier lives in an R-row buffer (sample + cost) and
    ``tree_size`` is virtual. ``m_dropped`` counts, per iteration, accepted
    children that did not fit the R rows (the JAX package drops them too,
    without counting)."""

    f_rows: Tensor  # f32 [R, SAMPLE_DIM + 1]
    n_frontier: int
    tree_size: int
    r1_total: Tensor
    r1_valid: Tensor
    r1_invalid: Tensor
    r1_avail: Tensor
    r1_score: Tensor
    r2_avail: Tensor
    r1_threshold: Tensor
    cost_to_goal: Tensor
    itr: int
    key: Tensor
    stalled: bool
    m_frontier_size: np.ndarray
    m_valid: np.ndarray
    m_accepted: np.ndarray
    m_tree_size: np.ndarray
    m_dropped: np.ndarray


@dataclasses.dataclass
class KGMTResult:
    solved: bool
    cost: float
    iterations: int
    tree_size: int
    wall_time_s: float
    path: np.ndarray  # [L, SAMPLE_DIM] root -> goal node samples
    path_nodes: np.ndarray  # [L] tree indices
    state: KGMTState | PathlessState
    metrics: dict


def _metric_arrays(cfg: KGMTConfig, n: int) -> list[np.ndarray]:
    it = max(cfg.num_iterations, 1)
    return [np.zeros(it, np.int32) for _ in range(n)]


def _root_regions(cfg: KGMTConfig, grid: RegionGrid, init: Tensor):
    """Region counters seeded with the root, as KGMT.cu:85-97. A root outside
    the grid (r1 = -1) seeds nothing: the write of 0 at the clamped index 0
    is a no-op, never a negative-index wrap."""
    r1_0, r2_0 = grid.region_indices(init[0:2][None, :])
    one = (r1_0 >= 0).to(torch.int32)
    one_r2 = (r2_0 >= 0).to(torch.int32)
    r1_0 = r1_0.clamp(min=0).long()
    r2_0 = r2_0.clamp(min=0).long()
    dev = init.device

    def seeded(n: int, idx: Tensor, val: Tensor) -> Tensor:
        return torch.zeros(n, dtype=torch.int32, device=dev).scatter_(0, idx, val)

    zeros_r1 = torch.zeros(cfg.num_r1, dtype=torch.int32, device=dev)
    return dict(
        r1_total=seeded(cfg.num_r1, r1_0, one),
        r1_valid=seeded(cfg.num_r1, r1_0, one),
        r1_invalid=zeros_r1,
        r1_avail=seeded(cfg.num_r1, r1_0, one),
        r1_score=torch.ones(cfg.num_r1, dtype=torch.float32, device=dev),
        r2_avail=seeded(cfg.num_r2, r2_0, one_r2),
        r1_threshold=torch.zeros((), dtype=torch.float32, device=dev),
        cost_to_goal=torch.tensor(float("inf"), dtype=torch.float32, device=dev),
    )


def init_state(cfg: KGMTConfig, grid: RegionGrid, init: Tensor,
               key: Tensor) -> KGMTState:
    """Seed the tree with the root sample (slot 0) and mark its regions."""
    M, R, dev = cfg.max_tree_size, cfg.rollouts_per_iter, init.device
    tree_samples = torch.zeros((M, SAMPLE_DIM), dtype=torch.float32, device=dev)
    tree_samples[0] = init
    zeros_r2 = torch.zeros(cfg.num_r2, dtype=torch.int32, device=dev)
    m = _metric_arrays(cfg, 4)
    return KGMTState(
        tree_samples=tree_samples,
        tree_parent=torch.full((M,), -1, dtype=torch.int32, device=dev),
        costs=torch.zeros(M, dtype=torch.float32, device=dev),
        frontier_lo=0,
        tree_size=1,
        r2_total=zeros_r2,
        r2_valid=zeros_r2.clone(),
        r2_invalid=zeros_r2.clone(),
        u_samples=torch.zeros((R, SAMPLE_DIM), dtype=torch.float32, device=dev),
        u_parent=torch.full((R,), -1, dtype=torch.int32, device=dev),
        goal_node=torch.tensor(-1, dtype=torch.int32, device=dev),
        itr=0,
        key=key,
        stalled=False,
        m_frontier_size=m[0], m_valid=m[1], m_accepted=m[2], m_tree_size=m[3],
        **_root_regions(cfg, grid, init),
    )


def init_pathless_state(cfg: KGMTConfig, grid: RegionGrid, init: Tensor,
                        key: Tensor) -> PathlessState:
    """Root seeding as init_state, with the root in frontier row 0."""
    R, dev = cfg.rollouts_per_iter, init.device
    f_rows = torch.zeros((R, SAMPLE_DIM + 1), dtype=torch.float32, device=dev)
    f_rows[0, :SAMPLE_DIM] = init
    m = _metric_arrays(cfg, 5)
    return PathlessState(
        f_rows=f_rows, n_frontier=1, tree_size=1, itr=0, key=key,
        stalled=False, m_frontier_size=m[0], m_valid=m[1], m_accepted=m[2],
        m_tree_size=m[3], m_dropped=m[4], **_root_regions(cfg, grid, init),
    )


def rollout_kind(cfg: KGMTConfig, system) -> str:
    """Which rollout a solve under ``cfg`` runs for ``system``, as its
    result's ``metrics["rollout"]`` records: ``"kernel"``, the kernel
    wrappers (B1/B2/B6 on the card, their plain twins on the CPU), or
    ``"generic"``, the system's own ``step`` through ``rollout_batch``
    (every system under ``torch``; under ``auto`` a system without a device
    struct). Under ``cuda``/``cuda_rng`` such a system raises
    (``ops/rollout_cuda.py::rollout_route``, the one rule)."""
    if cfg.rollout_backend == "torch":
        return "generic"
    return rollout_route(system, cfg.rollout_backend)


def _dispatch_rollout(cfg: KGMTConfig, system, x0: Tensor, controls: Tensor,
                      obstacles: Tensor) -> tuple[Tensor, Tensor]:
    """``auto``/``cuda``: the B1 wrapper (the CUDA kernel on a CUDA tensor,
    its plain twin on a CPU tensor), with the config's footprint and fast
    math; ``torch``, and ``auto`` for a system without a device struct: the
    plain exact rollout of ``system.step`` on any device (fast math, as in
    the JAX package, changes only the kernel backends)."""
    if rollout_kind(cfg, system) == "generic":
        return rollout_batch(system, x0, controls, cfg.num_disc, obstacles,
                             cfg.width, cfg.height, footprint=cfg.footprint)
    return rollout_cuda(system, x0, controls, obstacles, num_disc=cfg.num_disc,
                        width=cfg.width, height=cfg.height,
                        footprint=cfg.footprint, fast_math=cfg.fast_math)


def _expand_rollout(cfg: KGMTConfig, system, key: Tensor, x0: Tensor,
                    obstacles: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Sample one control per slot and propagate; returns (x1, controls,
    valid). ``cuda_rng`` draws the controls inside the B2 kernel (Philox
    keyed by ``key``, a stream of its own); every other backend draws them
    from the threefry stream of ``key``, as the JAX planner does."""
    if cfg.rollout_backend == "cuda_rng" and rollout_kind(cfg, system) == "kernel":
        return sample_and_rollout_cuda(system, key, x0, obstacles,
                                       num_disc=cfg.num_disc, width=cfg.width,
                                       height=cfg.height,
                                       footprint=cfg.footprint,
                                       fast_math=cfg.fast_math)
    with phase_scope("kgmt_rng", x0.device):
        controls = system.control_spec.sample(key, (x0.shape[0],))
    x1, valid = _dispatch_rollout(cfg, system, x0, controls, obstacles)
    return x1, controls, valid


def frontier_mask(state: KGMTState, max_tree_size: int) -> Tensor:
    """The reference's boolean frontier array (d_G_) from the contiguous
    range ``[frontier_lo, tree_size)`` the planner keeps, on the state's
    device, for artifacts and analysis (cudasbmp_tpu/planners/kgmt.py:249;
    io/csv.py keeps a numpy copy for its writer)."""
    idx = torch.arange(max_tree_size, device=state.tree_parent.device)
    return (idx >= state.frontier_lo) & (idx < state.tree_size)


def _wave_keys(key: Tensor, itr: int, wave: int) -> tuple[Tensor, Tensor]:
    """(k_ctrl, k_accept) of sub-wave ``wave`` of iteration ``itr``. Sub-wave
    0 uses the iteration key directly, not fold_in(key, 0)."""
    key_wave = rng.fold_in(key, itr)
    if wave:
        key_wave = rng.fold_in(key_wave, wave)
    k = rng.split(key_wave)
    return k[0], k[1]


def update_region_scores(cfg: KGMTConfig, s: KGMTState | PathlessState
                         ) -> tuple[Tensor, Tensor]:
    """Exploration scores per R1 cell (updateR1, KGMT.cu:487-538):
    freeVol^4 / ((1 + covR) * (1 + count^2)) on available cells, normalised
    by their sum; untouched cells score 1. The powers are products, as XLA's
    integer_pow computes them (x^4 = (x*x)*(x*x)). The sum is ``row_sum``'s
    fixed pairwise order, so the batched planner's per-problem sums
    (parallel/multi_query.py) equal it on every device (XLA sums in an order
    of its own, an ulp away at times). The counters may carry leading axes
    (the sharded multi-query planner's problems): every problem's row is
    scored alone, and the threshold has the leading shape."""
    n2 = cfg.n * cfg.n
    lead = s.r1_avail.shape[:-1]
    avail = s.r1_avail != 0
    cov_r = div(s.r2_avail.reshape(*lead, cfg.num_r1, n2).sum(dim=-1).to(torch.float32),
                n2)
    valid_f = s.r1_valid.to(torch.float32)
    invalid_f = s.r1_invalid.to(torch.float32)
    free_vol = (cfg.epsilon + valid_f) / (cfg.epsilon + valid_f + invalid_f)
    count_f = s.r1_total.to(torch.float32)
    fv2 = free_vol * free_vol
    score = (fv2 * fv2) / ((1.0 + cov_r) * (1.0 + count_f * count_f))
    score = torch.where(avail, score, 0.0)
    total = row_sum(score)
    active = avail.sum(dim=-1).clamp(min=1)
    r1_threshold = total[..., 0] / active.to(torch.float32)
    r1_score = torch.where(avail, torch.where(total > 0, score / total, 1.0), 1.0)
    return r1_score, r1_threshold


def _goal_biased(cfg: KGMTConfig, frontier: Tensor, goal: Tensor,
                 parent_idx: Tensor, offset: int) -> Tensor:
    """Goal-biased parent pick (cudasbmp_tpu/planners/kgmt.py:333-353 and
    :930-956): the first ``n_biased = round(goal_bias * R)`` slots cycle, with
    modulus ``min(goal_bias_k, M)``, over the ``goal_bias_k`` frontier rows
    nearest the goal; a slot whose cycle entry lies past the frontier's size
    keeps its round-robin parent. ``frontier`` [F, >=2] holds the frontier
    rows, which start at index ``offset`` of the parent space.

    JAX takes ``lax.top_k`` of ``-d2`` over the whole tree (tree mode) or the
    R-row buffer (pathless mode), with ``inf`` outside the frontier. Those
    padding entries are exactly the ones past min(goal_bias_k, F), so both
    modes reduce to this one rule over the F frontier rows. ``top_k`` puts
    the lower index first on ties; a stable ascending sort of ``d2`` gives
    the same order (``torch.topk`` promises none)."""
    n_biased = int(round(cfg.goal_bias * cfg.rollouts_per_iter))
    kk = min(cfg.goal_bias_k, frontier.shape[0])
    if n_biased == 0 or kk == 0:
        return parent_idx
    dx = frontier[:, 0] - goal[0]
    dy = frontier[:, 1] - goal[1]
    near = torch.sort(dx * dx + dy * dy, stable=True).indices[:kk]
    j = torch.arange(n_biased, device=parent_idx.device) % min(
        cfg.goal_bias_k, cfg.max_tree_size)
    biased = offset + near[j.clamp(max=kk - 1)]
    out = parent_idx.clone()
    out[:n_biased] = torch.where(j < kk, biased, parent_idx[:n_biased])
    return out


def apply_pool(cfg: KGMTConfig, gslot: Tensor, parent_rows: Tensor,
               parent_cost: Tensor, parent_gid: Tensor, slot_active: Tensor,
               pool: tuple[Tensor, Tensor, Tensor]):
    """The exchange pool's share of a wave (cudasbmp_tpu/planners/kgmt.py:
    361-374): the last ``round(exchange_frac * R)`` slots of the wave take
    pool entry ``j = gslot % P`` as their parent wherever its global id is
    not the padding -1, and are active whatever ``n_target`` says (a shard
    whose own frontier is sterile still expands foreign nodes). ``gslot``
    [R] is the wave's slot numbering; the parent tensors are [..., R] (and
    [..., R, SAMPLE_DIM]); the pool is (rows [..., P, SAMPLE_DIM], ids i32
    [..., P], costs [..., P]), its leading axes broadcasting against the
    parents' (one pool a problem). Returns the four tensors with the pool
    applied."""
    pool_rows, pool_ids, pool_costs = pool
    R = cfg.rollouts_per_iter
    n_pool = int(round(cfg.exchange_frac * R))
    j = gslot % pool_ids.shape[-1]
    slot = torch.arange(R, device=gslot.device)
    use = (slot >= R - n_pool) & (pool_ids[..., j] >= 0)
    return (torch.where(use[..., None], pool_rows[..., j, :], parent_rows),
            torch.where(use, pool_costs[..., j], parent_cost),
            torch.where(use, pool_ids[..., j].to(parent_gid.dtype), parent_gid),
            slot_active | use)


def expansion_wave(cfg: KGMTConfig, system, obstacles: Tensor, goal: Tensor,
                   s: KGMTState, wave: int = 0, frontier_lo: int | None = None,
                   frontier_size: int | None = None,
                   n_target: int | None = None, pool=None, gid_base: int = 0):
    """Sub-wave ``wave`` of iteration ``s.itr``: slot ``wave*R + i`` maps
    round-robin onto the frontier range (goal-biased slots first, see
    ``_goal_biased``); slots at or past ``n_target`` are inactive. With
    ``pool`` (the sharded tree's exchange pool, ``apply_pool``) the wave's
    last slots expand pool entries; ``gid_base`` (shard * M) turns local
    parent indices into global ids. Returns (slot_active, parent_gid,
    parent_cost, x1, controls, valid, samples1, k_accept); with no pool and
    ``gid_base`` 0 the parent ids are the local indices."""
    M, R = cfg.max_tree_size, cfg.rollouts_per_iter
    dev = s.tree_samples.device
    if frontier_lo is None:
        frontier_lo = s.frontier_lo
    if frontier_size is None:
        frontier_size = s.tree_size - s.frontier_lo
    if n_target is None:
        n_target = min(cfg.fanout * frontier_size, M - s.tree_size, R)
    with phase_scope("kgmt_parents", dev):
        gslot = wave * R + torch.arange(R, dtype=torch.int64, device=dev)
        slot_active = gslot < n_target
        parent_idx = frontier_lo + gslot % max(frontier_size, 1)
        if cfg.goal_bias > 0.0:
            parent_idx = _goal_biased(
                cfg, s.tree_samples[frontier_lo:frontier_lo + frontier_size], goal,
                parent_idx, frontier_lo)
        parent_rows = s.tree_samples[parent_idx]
        parent_cost = s.costs[parent_idx]
        parent_gid = parent_idx + gid_base if gid_base else parent_idx
        if pool is not None:
            parent_rows, parent_cost, parent_gid, slot_active = apply_pool(
                cfg, gslot, parent_rows, parent_cost, parent_gid, slot_active, pool)
        x0 = parent_rows[:, :system.state_dim].contiguous()
        parent_gid = parent_gid.to(torch.int32)
    with phase_scope("kgmt_rng", dev):
        k_ctrl, k_accept = _wave_keys(s.key, s.itr, wave)
    with phase_scope("kgmt_expand", dev):
        x1, controls, valid = _expand_rollout(cfg, system, k_ctrl, x0, obstacles)
        valid = valid & slot_active
        samples1 = torch.cat([x1, controls], dim=-1)
    return (slot_active, parent_gid, parent_cost, x1,
            controls, valid, samples1, k_accept)


def _region_stats_and_accept(cfg: KGMTConfig, grid: RegionGrid, x1: Tensor,
                             slot_active: Tensor, valid: Tensor,
                             r1_score: Tensor, r2_seen: Tensor,
                             k_accept: Tensor):
    """Region statistics and the acceptance rule of one wave, shared by the
    tree and pathless loops. Counts are exact integer ``index_add_`` (order-free, so
    deterministic with GPU atomics); lanes outside the grid (index -1) add 0
    at the clamped index 0. Returns (d1 [NR1, 2], d2 [NR2, 2], accept [R],
    r2_seen'), column 0 counting active slots and column 1 valid ones."""
    R = x1.shape[0]
    r1, r2 = grid.region_indices(x1[:, 0:2])
    in_r1 = r1 >= 0
    in_r2 = r2 >= 0
    r1c = r1.clamp(min=0).long()
    r2c = r2.clamp(min=0).long()
    act = slot_active.to(torch.int32)
    val = valid.to(torch.int32)

    def counts(n: int, idx: Tensor, inside: Tensor) -> Tensor:
        z = torch.zeros((n, 2), dtype=torch.int32, device=x1.device)
        return z.index_add_(0, idx, torch.stack([act, val], -1) * inside[:, None])

    d1 = counts(cfg.num_r1, r1c, in_r1)
    d2 = counts(cfg.num_r2, r2c, in_r2)
    # acceptance (KGMT.cu:394-400): Bernoulli(score of the child's R1 cell)
    # OR its R2 subcell was never reached. Outside the grid score_r = 0 and
    # the child counts as virgin (r1 < 0 implies r2 < 0).
    with phase_scope("kgmt_rng", x1.device):
        u = rng.uniform(k_accept, (R,))
    score_r = torch.where(in_r1, r1_score[r1c], 0.0)
    seen_r = torch.where(in_r2, r2_seen[r2c], 0)
    virgin_r2 = ~in_r2 | (seen_r == 0)
    accept = valid & ((u <= score_r) | virgin_r2)
    r2_seen = r2_seen | (d2[:, 1] > 0).to(torch.int32)
    return d1, d2, accept, r2_seen


def _commit_plan(accept: Tensor, base: int, capacity: int):
    """Exclusive-cumsum commit slots: (inclusive cumsum, accept_pos, within)
    where ``within`` = accepted and ``base + accept_pos < capacity``."""
    accept_i = accept.to(torch.int64)
    incl = torch.cumsum(accept_i, 0)
    accept_pos = incl - accept_i
    return incl, accept_pos, accept & (base + accept_pos < capacity)


def _first_accepted(incl: Tensor, k: int) -> Tensor:
    """Lanes of the first k accepted children, in lane order: lane of the
    j-th is the first index where the inclusive cumsum reaches j."""
    want = torch.arange(1, k + 1, dtype=incl.dtype, device=incl.device)
    return torch.searchsorted(incl, want)


def _goal_costs(cfg: KGMTConfig, x1: Tensor, goal: Tensor, within: Tensor,
                child_cost: Tensor) -> Tensor:
    dx = x1[:, 0] - goal[0]
    dy = x1[:, 1] - goal[1]
    in_goal = within & (dx * dx + dy * dy < cfg.goal_threshold ** 2)
    return torch.where(in_goal, child_cost, float("inf"))


def _readout(accept: Tensor, valid: Tensor, cost_to_goal: Tensor
             ) -> tuple[int, int, bool]:
    """The wave's one device->host read: (accepted, valid, solved)."""
    n_sum, n_valid, solved = host_read(torch.stack(
        [accept.sum(), valid.sum(), torch.isfinite(cost_to_goal).long()]))
    return n_sum, n_valid, bool(solved)


def _wave_step(cfg: KGMTConfig, system, grid: RegionGrid, obstacles: Tensor,
               goal: Tensor, frontier_lo0: int, tree_size0: int, n_target: int,
               r1_score: Tensor, carry):
    """Expand, commit and goal-check one R-slot sub-wave over the
    iteration-start context: ``(w, state, r2_seen) -> (w + 1, state,
    r2_seen, solved)``. Updates the state in place."""
    M = cfg.max_tree_size
    w, s, r2_seen = carry
    dev = s.tree_samples.device
    (slot_active, parent_idx, parent_cost, x1, controls, valid, samples1,
     k_accept) = expansion_wave(cfg, system, obstacles, goal, s, wave=w,
                                frontier_lo=frontier_lo0,
                                frontier_size=tree_size0 - frontier_lo0,
                                n_target=n_target)
    with phase_scope("kgmt_region_stats", dev):
        d1, d2, accept, r2_seen = _region_stats_and_accept(
            cfg, grid, x1, slot_active, valid, r1_score, r2_seen, k_accept)

    ts = s.tree_size
    with phase_scope("kgmt_goal", dev):
        incl, accept_pos, within = _commit_plan(accept, ts, M)
        child_cost = parent_cost + controls[:, -1]
        goal_costs = _goal_costs(cfg, x1, goal, within, child_cost)
        # first index on ties; read, since indexing by a 0-d tensor reads it anyway
        best = host_read(torch.argmin(goal_costs))
        best_cost = goal_costs[best]
        improved = best_cost < s.cost_to_goal
        s.cost_to_goal = torch.where(improved, best_cost, s.cost_to_goal)
        s.goal_node = torch.where(improved, (ts + accept_pos[best]).to(torch.int32),
                                  s.goal_node)

    with phase_scope("kgmt_commit", dev):
        n_sum, n_valid, solved = _readout(accept, valid, s.cost_to_goal)
        n_acc = min(n_sum, M - ts)
        if n_acc:
            lanes = _first_accepted(incl, n_acc)
            s.tree_samples[ts:ts + n_acc] = samples1[lanes]
            s.tree_parent[ts:ts + n_acc] = parent_idx[lanes]
            s.costs[ts:ts + n_acc] = child_cost[lanes]
    with phase_scope("kgmt_boundary", dev):
        s.tree_size = ts + n_acc
        s.r1_total += d1[:, 0]
        s.r1_valid += d1[:, 1]
        s.r1_invalid += d1[:, 0] - d1[:, 1]
        s.r1_avail |= (d1[:, 1] > 0).to(torch.int32)
        s.r2_total += d2[:, 0]
        s.r2_valid += d2[:, 1]
        s.r2_invalid += d2[:, 0] - d2[:, 1]
        s.r2_avail |= (d2[:, 1] > 0).to(torch.int32)
        s.u_samples = samples1
        s.u_parent = parent_idx
        s.m_valid[s.itr] += n_valid
        s.m_accepted[s.itr] += n_acc
    return w + 1, s, r2_seen, solved


def _keep_going(cfg: KGMTConfig, s, solved: bool) -> bool:
    """The reference loop's termination tests (KGMT.cu:118-259)."""
    if cfg.stop_on_first_solution and solved:
        return False
    if not cfg.keep_frontier_on_stall and s.stalled:
        return False
    return s.itr < cfg.num_iterations and s.tree_size < cfg.max_tree_size


def _minimum(a, b):
    return a.clamp(max=b) if isinstance(a, Tensor) else min(a, b)


def _fresh_target(cfg: KGMTConfig, frontier_size, tree_size):
    """The iteration's rollout target: ``fanout`` children a frontier node,
    at most the free slots (and one wave's R without adaptive waves). Host
    ints, or int64 tensors of one target a tree (the batched planners)."""
    n_tgt = _minimum(cfg.fanout * frontier_size, cfg.max_tree_size - tree_size)
    return n_tgt if cfg.adaptive_waves else _minimum(n_tgt, cfg.rollouts_per_iter)


def _num_waves(cfg: KGMTConfig, n_tgt):
    """The iteration's sub-waves for target ``n_tgt`` (int or tensor)."""
    R = cfg.rollouts_per_iter
    return (n_tgt + R - 1) // R if cfg.adaptive_waves else _minimum(n_tgt, 1)


def kgmt_run(cfg: KGMTConfig, system, grid: RegionGrid, goal: Tensor,
             obstacles: Tensor, s: KGMTState) -> KGMTState:
    """Iterate until the first solution, a full tree, a stall (when retry
    is off) or the iteration budget: the flat (iteration x wave) loop of the
    JAX kgmt_run, one host sync per wave. Iteration-start context: fl0, ts0,
    n_tgt, r1_score, r2_seen."""
    dev = s.tree_samples.device
    with phase_scope("kgmt_init", dev):
        solved = host_read(torch.isfinite(s.cost_to_goal))
    w = fl0 = ts0 = n_tgt = 0
    r1_score, r1_thr, r2_seen = s.r1_score, s.r1_threshold, s.r2_avail
    while w > 0 or _keep_going(cfg, s, solved):
        with phase_scope("kgmt_wave", dev, itr=s.itr, w=w):
            if w == 0:
                with phase_scope("kgmt_scores", dev):
                    r1_score, r1_thr = update_region_scores(cfg, s)
                    fl0, ts0 = s.frontier_lo, s.tree_size
                    n_tgt = _fresh_target(cfg, ts0 - fl0, ts0)
                    r2_seen = s.r2_avail.clone()
            it = s.itr
            w, s, r2_seen, solved = _wave_step(cfg, system, grid, obstacles, goal,
                                               fl0, ts0, n_tgt, r1_score,
                                               (w, s, r2_seen))
            with phase_scope("kgmt_boundary", dev):
                s.r1_score, s.r1_threshold = r1_score, r1_thr
                s.m_frontier_size[it] = ts0 - fl0
                s.m_tree_size[it] = s.tree_size
                if w >= _num_waves(cfg, n_tgt):
                    s.stalled = s.tree_size == ts0
                    if cfg.keep_frontier_on_stall and s.stalled:
                        s.frontier_lo = fl0
                    else:
                        s.frontier_lo = ts0
                    s.itr = it + 1
                    w = 0
    return s


def kgmt_iteration(cfg: KGMTConfig, system, grid: RegionGrid, obstacles: Tensor,
                   goal: Tensor, s: KGMTState) -> KGMTState:
    """One planner iteration: the region scores, then every sub-wave of the
    iteration (the same ``_wave_step`` as ``kgmt_run``) until the target
    of ``fanout`` children a frontier node is met, then the frontier moves
    on (or stays, on a stall with retry). The body of the reference's host
    loop (KGMT.cu:118-292), for ``KGMT.plan_recorded``'s step-by-step
    dumps; ``kgmt_run`` runs the same waves. Updates the state in place."""
    dev = s.tree_samples.device
    with phase_scope("kgmt_scores", dev):
        r1_score, r1_thr = update_region_scores(cfg, s)
    with phase_scope("kgmt_frontier", dev):
        fl0, ts0 = s.frontier_lo, s.tree_size
        n_tgt = _fresh_target(cfg, ts0 - fl0, ts0)
        carry = (0, s, s.r2_avail.clone())
    it = s.itr
    with phase_scope("kgmt_waves", dev):
        for _ in range(_num_waves(cfg, n_tgt)):
            w, s, r2_seen, _ = _wave_step(cfg, system, grid, obstacles, goal, fl0,
                                          ts0, n_tgt, r1_score, carry)
            carry = (w, s, r2_seen)
    s.stalled = s.tree_size == ts0
    s.frontier_lo = fl0 if cfg.keep_frontier_on_stall and s.stalled else ts0
    s.r1_score, s.r1_threshold = r1_score, r1_thr
    s.m_frontier_size[it] = ts0 - fl0
    s.m_tree_size[it] = s.tree_size
    s.itr = it + 1
    return s


def kgmt_solve(cfg: KGMTConfig, system, grid: RegionGrid, init: Tensor,
               goal: Tensor, obstacles: Tensor, key: Tensor) -> KGMTState:
    with phase_scope("kgmt_init", init.device):
        s = init_state(cfg, grid, init, key)
    return kgmt_run(cfg, system, grid, goal, obstacles, s)


def kgmt_run_pathless(cfg: KGMTConfig, system, grid: RegionGrid, goal: Tensor,
                      obstacles: Tensor, s: PathlessState) -> PathlessState:
    """kgmt_run with the tree commit replaced by a write into the R-row
    next-frontier buffer: the same keys, parent order, statistics and
    acceptance (the same ``_region_stats_and_accept``), so (solved, cost,
    iterations, tree_size) equal the tree mode's whenever every iteration's
    accepted children fit R rows. Children past R rows are dropped, as in
    the JAX package, and counted in ``m_dropped``."""
    M, R = cfg.max_tree_size, cfg.rollouts_per_iter
    dev = s.f_rows.device
    with phase_scope("kgmt_init", dev):
        solved = host_read(torch.isfinite(s.cost_to_goal))
        nxt_rows = torch.zeros((R, SAMPLE_DIM + 1), dtype=torch.float32, device=dev)
        slot = torch.arange(R, dtype=torch.int64, device=dev)
    w = n_tgt = n_next = 0
    r1_score, r1_thr, r2_seen = s.r1_score, s.r1_threshold, s.r2_avail
    while w > 0 or _keep_going(cfg, s, solved):
        with phase_scope("kgmt_wave", dev, itr=s.itr, w=w):
            if w == 0:
                with phase_scope("kgmt_scores", dev):
                    r1_score, r1_thr = update_region_scores(cfg, s)
                    n_tgt = _fresh_target(cfg, s.n_frontier, s.tree_size)
                    r2_seen = s.r2_avail.clone()
                    n_next = 0
            it, n_frontier = s.itr, s.n_frontier

            with phase_scope("kgmt_parents", dev):
                gslot = w * R + slot
                slot_active = gslot < n_tgt
                parent_idx = gslot % max(n_frontier, 1)
                if cfg.goal_bias > 0.0:
                    parent_idx = _goal_biased(cfg, s.f_rows[:n_frontier], goal,
                                              parent_idx, 0)
                parent_rows = s.f_rows[parent_idx]
                parent_cost = parent_rows[:, SAMPLE_DIM]
                x0 = parent_rows[:, :system.state_dim].contiguous()
            with phase_scope("kgmt_rng", dev):
                k_ctrl, k_accept = _wave_keys(s.key, it, w)
            with phase_scope("kgmt_expand", dev):
                x1, controls, valid = _expand_rollout(cfg, system, k_ctrl, x0, obstacles)
                valid = valid & slot_active
                samples1 = torch.cat([x1, controls], dim=-1)
            with phase_scope("kgmt_region_stats", dev):
                d1, d2, accept, r2_seen = _region_stats_and_accept(
                    cfg, grid, x1, slot_active, valid, r1_score, r2_seen, k_accept)

            with phase_scope("kgmt_goal", dev):
                incl, _, within = _commit_plan(accept, s.tree_size, M)
                child_cost = parent_cost + controls[:, -1]
                best_cost = _goal_costs(cfg, x1, goal, within, child_cost).min()
                s.cost_to_goal = torch.minimum(best_cost, s.cost_to_goal)
            with phase_scope("kgmt_commit", dev):
                n_sum, n_valid, solved = _readout(accept, valid, s.cost_to_goal)
                n_acc = min(n_sum, M - s.tree_size)
                kept = min(n_acc, R - n_next)
                if kept:
                    rows = torch.cat([samples1, child_cost[:, None]], dim=-1)
                    nxt_rows[n_next:n_next + kept] = rows[_first_accepted(incl, kept)]
                s.m_dropped[it] += n_acc - kept
                n_next = min(n_next + n_acc, R)

            with phase_scope("kgmt_boundary", dev):
                last = w + 1 >= _num_waves(cfg, n_tgt)
                stalled = n_next == 0
                if last and not (cfg.keep_frontier_on_stall and stalled):
                    s.f_rows.copy_(nxt_rows)
                    s.n_frontier = n_next
                s.m_frontier_size[it] = n_frontier
                s.tree_size += n_acc
                s.r1_total += d1[:, 0]
                s.r1_valid += d1[:, 1]
                s.r1_invalid += d1[:, 0] - d1[:, 1]
                s.r1_avail |= (d1[:, 1] > 0).to(torch.int32)
                s.r2_avail |= (d2[:, 1] > 0).to(torch.int32)
                s.r1_score, s.r1_threshold = r1_score, r1_thr
                s.m_valid[it] += n_valid
                s.m_accepted[it] += n_acc
                s.m_tree_size[it] = s.tree_size
                if last:
                    s.stalled = stalled
                    s.itr = it + 1
                w = 0 if last else w + 1
    return s


def kgmt_solve_pathless(cfg: KGMTConfig, system, grid: RegionGrid,
                        init: Tensor, goal: Tensor, obstacles: Tensor,
                        key: Tensor) -> PathlessState:
    with phase_scope("kgmt_init", init.device):
        s = init_pathless_state(cfg, grid, init, key)
    return kgmt_run_pathless(cfg, system, grid, goal, obstacles, s)


def extract_path(cfg: KGMTConfig, s: KGMTState) -> tuple[Tensor, Tensor, Tensor]:
    """Walk parent pointers from the goal node to the root on the device.
    Depth grows by at most one per iteration, so num_iterations + 1 bounds
    the length. Returns (nodes [L], samples [L, SAMPLE_DIM], length), root
    first; entries past ``length`` are -1 / zeros. Indices are clamped at 0
    before every lookup (a -1 would wrap to the last slot)."""
    L = cfg.num_iterations + 1
    node = s.goal_node.reshape(1)
    rev = []
    for _ in range(L):
        rev.append(node)
        parent = s.tree_parent.index_select(0, node.clamp(min=0).long())
        node = torch.where(node >= 0, parent, -1)
    rev_nodes = torch.cat(rev)
    length = (rev_nodes >= 0).sum()
    idx = torch.arange(L, device=rev_nodes.device)
    src = (length - 1 - idx).clamp(min=0)
    nodes = torch.where(idx < length, rev_nodes[src], -1)
    samples = torch.where((nodes >= 0)[:, None],
                          s.tree_samples[nodes.clamp(min=0).long()], 0.0)
    return nodes, samples, length


# plan_recorded's dumps: (state field, directory, file name stem, values a row),
# then G/G<i>.csv, the frontier mask
_RECORDED = (("u_samples", "UnexploredSamples", "unexploredSamples", SAMPLE_DIM),
             ("u_parent", "UParentIdx", "uParentIdx", 1),
             ("tree_samples", "Samples", "samples", SAMPLE_DIM),
             ("tree_parent", "Parents", "parents", 1),
             ("r1_score", "R1Scores", "R1Scores", 1),
             ("r1_avail", "R1Avail", "R1Avail", 1),
             ("r1_total", "R1", "R1", 1))


def resolve_device(device: torch.device | str) -> torch.device:
    """The planners' device: the card unless the caller names the CPU. A
    CUDA device on a host without one is an error, never a move to the
    CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device}: torch.cuda.is_available() is false; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return device


class KGMT:
    """Host-facing planner for one configuration on one explicit device
    (``cuda`` unless the caller asks for ``cpu``)."""

    def __init__(self, config: KGMTConfig | None = None, system=None,
                 device: torch.device | str = "cuda"):
        self.config = config or KGMTConfig()
        self.system = system or get_system(
            self.config.system,
            **({"agent_length": self.config.agent_length}
               if self.config.system in ("bicycle", "car") else {}),
        )
        self.grid = RegionGrid(width=self.config.width,
                               height=self.config.height,
                               N=self.config.N, n=self.config.n)
        self.device = resolve_device(device)

    def plan(self, scenario: Scenario, seed: int | None = None) -> KGMTResult:
        cfg, dev = self.config, self.device
        seed = cfg.seed if seed is None else seed
        with phase_scope("kgmt_plan", dev, seed=seed, problems=1):
            with phase_scope("kgmt_init", dev):
                obstacles_np, _ = scenario.padded_obstacles(cfg.max_obstacles)
                obstacles = torch.as_tensor(obstacles_np, device=dev)
                init = torch.as_tensor(scenario.init, device=dev)
                goal = torch.as_tensor(scenario.goal, device=dev)
                key = rng.key(seed, dev)
                _synchronize(dev)
                t0 = time.perf_counter()
            solve = kgmt_solve if cfg.need_path else kgmt_solve_pathless
            final = solve(cfg, self.system, self.grid, init, goal, obstacles, key)
            return self._finish(final, t0)

    def _finish(self, final: KGMTState | PathlessState, t0: float) -> KGMTResult:
        """The path walk and the result of a finished solve, its wall from
        ``t0``."""
        cfg, dev = self.config, self.device
        with phase_scope("kgmt_extract", dev):
            nodes = samples = length = None
            if cfg.need_path:
                nodes, samples, length = extract_path(cfg, final)
            _synchronize(dev)
            wall = time.perf_counter() - t0
            return self._build_result(final, nodes, samples, length, wall)

    def resume(self, state: KGMTState | PathlessState, scenario: Scenario) -> KGMTResult:
        """Continue a solve from a state, a checkpointed one for example
        (io/checkpoint.py), to its end: exact, RNG included. The state's
        kind must match ``config.need_path`` and its tensors lie on the
        planner's device; the state is updated in place."""
        cfg, dev = self.config, self.device
        expected = KGMTState if cfg.need_path else PathlessState
        if not isinstance(state, expected):
            raise ValueError(
                f"checkpoint holds {type(state).__name__} but this planner is "
                f"configured with need_path={cfg.need_path} (expects "
                f"{expected.__name__}); construct KGMT with the matching config "
                "to resume it")
        if state.key.device != dev:
            raise ValueError(f"state on {state.key.device}, planner on {dev}: load "
                             "the checkpoint onto the planner's device")
        with phase_scope("kgmt_plan", dev, problems=1):
            with phase_scope("kgmt_init", dev):
                obstacles = torch.as_tensor(
                    scenario.padded_obstacles(cfg.max_obstacles)[0], device=dev)
                goal = torch.as_tensor(scenario.goal, device=dev)
                _synchronize(dev)
                t0 = time.perf_counter()
            run = kgmt_run if cfg.need_path else kgmt_run_pathless
            final = run(cfg, self.system, self.grid, goal, obstacles, state)
            return self._finish(final, t0)

    def plan_recorded(self, scenario: Scenario, out_dir: str, seed: int | None = None,
                      dump_every: int = 1, checkpoint_every: int | None = None
                      ) -> KGMTResult:
        """Step-by-step solve with per-iteration artifact dumps (the
        reference's commented-out debug workflow, KGMT.cu:263-291): one
        ``kgmt_iteration`` at a time, and after iteration i + 1 (every
        ``dump_every``-th) the CSVs ``Samples/samples<i+1>.csv``,
        ``Parents/parents``, ``R1Scores/R1Scores``, ``R1Avail/R1Avail``,
        ``R1/R1``, ``G/G``, ``UnexploredSamples/unexploredSamples`` and
        ``UParentIdx/uParentIdx`` under ``out_dir``, and every
        ``checkpoint_every`` iterations ``checkpoint_<i+1>.npz``. Stops on
        the tests of ``kgmt_run``; slower than ``plan`` (the dumps read the
        state back every iteration)."""
        import pathlib

        from cudasbmp_torch.io.checkpoint import save_checkpoint
        from cudasbmp_torch.io.csv import frontier_mask, write_csv

        cfg, dev = self.config, self.device
        if not cfg.need_path:
            raise ValueError("plan_recorded needs the tree-mode planner "
                             "(need_path=True): its artifacts ARE the tree")
        out = pathlib.Path(out_dir)
        for sub in (*(d for _, d, _, _ in _RECORDED), "G"):
            (out / sub).mkdir(parents=True, exist_ok=True)
        obstacles = torch.as_tensor(scenario.padded_obstacles(cfg.max_obstacles)[0],
                                    device=dev)
        goal = torch.as_tensor(scenario.goal, device=dev)
        key = rng.key(cfg.seed if seed is None else seed, dev)
        state = init_state(cfg, self.grid, torch.as_tensor(scenario.init, device=dev), key)
        _synchronize(dev)
        t0 = time.perf_counter()
        for i in range(cfg.num_iterations):
            state = kgmt_iteration(cfg, self.system, self.grid, obstacles, goal, state)
            if i % dump_every == 0:
                it = i + 1
                for field, sub, name, cols in _RECORDED:
                    write_csv(host_read(getattr(state, field), numpy=True),
                              out / sub / f"{name}{it}.csv", cols)
                write_csv(frontier_mask(state, cfg.max_tree_size).astype(np.int32),
                          out / "G" / f"G{it}.csv")
            if checkpoint_every and (i + 1) % checkpoint_every == 0:
                save_checkpoint(state, out / f"checkpoint_{i + 1}.npz")
            if not _keep_going(cfg, state, host_read(torch.isfinite(state.cost_to_goal))):
                break
        nodes, samples, length = extract_path(cfg, state)
        _synchronize(dev)
        wall = time.perf_counter() - t0
        return self._build_result(state, nodes, samples, length, wall)

    def generate_random_tree(self, scenario: Scenario, num_rollouts: int):
        """Unguided random-tree probe (Planner.cuh:10): ``NaivePlanner``'s,
        on the planner's device."""
        from cudasbmp_torch.planners.naive import NaivePlanner

        return NaivePlanner(self.config, self.system, device=self.device
                            ).generate_random_tree(scenario, num_rollouts)

    def _build_result(self, final, nodes, samples, length, wall) -> KGMTResult:
        cost = host_read(final.cost_to_goal)
        solved = bool(np.isfinite(cost))
        it = final.itr
        if nodes is None:
            path = np.zeros((0, SAMPLE_DIM), np.float32)
            path_nodes = np.zeros(0, np.int32)
        else:
            n = host_read(length)
            path = host_read(samples[:n], numpy=True)
            path_nodes = host_read(nodes[:n], numpy=True)
        metrics = {
            "frontier_size": final.m_frontier_size[:it],
            "valid": final.m_valid[:it],
            "accepted": final.m_accepted[:it],
            "tree_size": final.m_tree_size[:it],
            "r1_threshold": host_read(final.r1_threshold),
            "rollout": rollout_kind(self.config, self.system),
        }
        if isinstance(final, PathlessState):
            metrics["dropped"] = final.m_dropped[:it]
        return KGMTResult(
            solved=solved,
            cost=cost if solved else float("inf"),
            iterations=it,
            tree_size=final.tree_size,
            wall_time_s=wall,
            path=path,
            path_nodes=path_nodes,
            state=final,
            metrics=metrics,
        )


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
