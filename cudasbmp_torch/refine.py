"""Differentiable trajectory refinement (counterpart of cudasbmp_tpu/refine.py):
the local optimisation stage after the KGMT feasibility search.

A solved path's controls are optimised by Adam on a smooth objective:
total trajectory time plus hinge penalties for entering the margin-inflated
obstacles, leaving the workspace and ending outside the goal region. The
controls stay inside their sampling box through a sigmoid
reparameterisation, and the result is re-validated with the exact hard
checker before a caller keeps it.

The JAX package takes ``jax.value_and_grad`` through the unrolled Euler
chain (``_loss``), vmapped over problems, inside one jitted scan of Adam
steps. Here the problems are a batch axis, and on the card the whole
refinement is one launch of ``refine_adam_kernel``
(ops/refine_cuda.py::refine_adam_cuda: every Adam step, the clip by each
problem's gradient norm, the best iterate and the final choice, each
problem integrating its own path only); on the CPU it is the plain twin's
loop, one step an iteration, the penalty under autograd. ``_refine_core``
is the entry to both, and given a penalty it runs that loop around it:
with R1's wrapper (ops/refine_cuda.py::refine_penalty_cuda, one launch a
step) on the card it is the step path the kernel equals to the bit.
Nothing is read back to the host inside the Adam loop; the losses come
back as one [iterations, B] tensor at the end.

The revalidation replays the refined edge chain with the exact checker,
one launch an edge up to the longest real path: kernel B1
(``rollout_cuda``) for ``refine_path``, B6 (``rollout_batched_cuda``, a
box set per problem) for ``refine_batch``, with the config's footprint
(B3), as the JAX ``_revalidate_jit`` passes it; a system without a device
struct replays through its generic ``step`` (``rollout_batch``, the
planners' rule ``ops/rollout_cuda.py::rollout_route``), as JAX replays
every system. ``refine_batch`` refines and replays its batch cut to the
longest real path and keeps the padded columns' controls as they were:
padded edges add exact zeros, so on the card the bits are the padded
run's. On the CPU torch's vectorised sigmoid and log may round a cut row
apart from the padded one in the last bits (tests/test_torch_refine_trim.py
holds the two within tests/test_torch_refine.py's tolerances).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cudasbmp_torch._math import row_sum
from cudasbmp_torch.config import KGMTConfig
from cudasbmp_torch.ops.refine_cuda import (objective, refine_adam_cuda, refine_adam_torch,
                                            refine_penalty_cuda, soft_penetration,
                                            unroll_positions)
from cudasbmp_torch.ops.rollout import rollout_batch
from cudasbmp_torch.ops.rollout_cuda import (rollout_batched_cuda, rollout_cuda,
                                             rollout_route)

Tensor = torch.Tensor
_soft_penetration = soft_penetration
_unroll_positions = unroll_positions


@dataclasses.dataclass(frozen=True)
class RefineConfig:
    iterations: int = 400
    learning_rate: float = 1e-3
    clip_norm: float = 1.0  # chained-Euler gradients explode; clip per problem
    collision_weight: float = 30.0
    goal_weight: float = 10.0
    time_weight: float = 1.0
    margin: float = 0.05  # extra clearance demanded from obstacles and bounds


def _loss(system, cfg: KGMTConfig, rcfg: RefineConfig, x0: Tensor, goal_xy: Tensor,
          obstacles: Tensor, raw: Tensor, lo: Tensor, hi: Tensor, mask: Tensor,
          penalty=refine_penalty_cuda) -> Tensor:
    """The refinement objective [B] of raw controls [B, L, C+1] (JAX's
    ``_loss`` over a batch; ops/refine_cuda.py::objective). ``penalty`` is
    R1's wrapper, or its plain twin."""
    return objective(system, x0, goal_xy, obstacles, raw, lo, hi, mask, penalty=penalty,
                     **_objective_kw(cfg, rcfg))


def _objective_kw(cfg: KGMTConfig, rcfg: RefineConfig) -> dict:
    return dict(num_disc=cfg.num_disc, width=cfg.width, height=cfg.height,
                margin=rcfg.margin, goal_threshold=cfg.goal_threshold,
                collision_weight=rcfg.collision_weight, goal_weight=rcfg.goal_weight,
                time_weight=rcfg.time_weight)


def _refine_core(system, cfg: KGMTConfig, rcfg: RefineConfig, x0: Tensor,
                 goal_xy: Tensor, obstacles: Tensor, controls0: Tensor, mask: Tensor,
                 penalty=None) -> tuple[Tensor, Tensor]:
    """Adam through the rollout for B problems: x0 [B, S], goal_xy [B, 2],
    obstacles [K, 4] or [B, K, 4], controls0 [B, L, C+1], mask [B, L].
    Returns (refined controls [B, L, C+1], losses [iterations, B]). With no
    ``penalty``, the whole refinement (ops/refine_cuda.py::refine_adam_cuda:
    one launch on the card, the plain twin's loop on the CPU); with one,
    the loop of one step an iteration around it
    (ops/refine_cuda.py::refine_adam_torch): with R1's wrapper on the card,
    the step path the whole refinement's kernel is held against."""
    kw = dict(iterations=rcfg.iterations, learning_rate=rcfg.learning_rate,
              clip_norm=rcfg.clip_norm, **_objective_kw(cfg, rcfg))
    if penalty is None:
        return refine_adam_cuda(system, x0, goal_xy, obstacles, controls0, mask, **kw)
    return refine_adam_torch(system, x0, goal_xy, obstacles, controls0, mask,
                             penalty=penalty, **kw)


def _revalidate(system, cfg: KGMTConfig, x0s: Tensor, goal_xys: Tensor,
                obstacles: Tensor, controls: Tensor, masks: Tensor,
                edges: int | None = None) -> tuple[Tensor, Tensor, Tensor]:
    """Replay every problem's edge chain with the exact checker, one launch
    an edge, each edge starting from the previous edge's end state: B1
    against one box set [K, 4] (one problem), B6 against [B, K, 4]. A
    masked edge leaves the state as it is, so only the first ``edges``
    edges (the longest real path; all by default) are replayed and the
    states of the rest repeat the last. Returns (per-edge end states
    [B, L, S], frozen at the first failing step as the rollout freezes, all
    edges valid [B], end inside the goal radius [B])."""
    kw = dict(num_disc=cfg.num_disc, width=cfg.width, height=cfg.height,
              footprint=cfg.footprint)
    generic = rollout_route(system, cfg.rollout_backend) == "generic"
    states, ok = x0s, torch.ones(x0s.shape[0], dtype=torch.bool, device=x0s.device)
    per_edge = []
    L = controls.shape[1]
    for l in range(L if edges is None else min(edges, L)):
        ctrl, m = controls[:, l].contiguous(), masks[:, l]
        if generic:
            x1, valid = rollout_batch(system, states, ctrl, cfg.num_disc, obstacles,
                                      cfg.width, cfg.height, footprint=cfg.footprint)
        elif obstacles.dim() == 2:
            x1, valid = rollout_cuda(system, states, ctrl, obstacles, **kw)
        else:
            x1, valid = rollout_batched_cuda(system, states[:, None], ctrl[:, None],
                                             obstacles, **kw)
            x1, valid = x1[:, 0], valid[:, 0]
        states = torch.where(m[:, None], x1, states)
        ok = ok & (valid | ~m)
        per_edge.append(states)
    per_edge += [states] * (L - len(per_edge))
    d = states[:, :2] - goal_xys
    in_goal = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) < cfg.goal_threshold
    return torch.stack(per_edge, 1), ok, in_goal


def refine_path(system, cfg: KGMTConfig, path: np.ndarray, goal: np.ndarray,
                obstacles: np.ndarray, rcfg: RefineConfig | None = None,
                device: torch.device | str = "cuda") -> dict:
    """Refine a solved path's controls. path: [L + 1, SAMPLE_DIM] from
    KGMTResult (root first); obstacles [K, 4]. Returns numpy values:
    refined controls [L, C+1], the exact checker's node states [L + 1, S],
    cost before and after, whether the refined trajectory passes the hard
    check and ends in the goal (if not, keep the original), and the losses
    [iterations]."""
    from cudasbmp_torch.planners.kgmt import resolve_device

    rcfg = rcfg or RefineConfig()
    dev = resolve_device(device)
    L = len(path) - 1
    if L < 1:
        raise ValueError("path must contain at least one edge")
    S = system.state_dim
    path = np.asarray(path, dtype=np.float32)
    x0 = torch.as_tensor(path[:1, :S], device=dev)
    controls0 = torch.as_tensor(np.ascontiguousarray(path[None, 1:, S:]), device=dev)
    goal_xy = torch.as_tensor(np.asarray(goal, np.float32)[None, :2], device=dev)
    obs = torch.as_tensor(np.asarray(obstacles, np.float32), device=dev)
    mask = torch.ones((1, L), dtype=torch.bool, device=dev)
    refined, losses = _refine_core(system, cfg, rcfg, x0, goal_xy, obs, controls0,
                                   mask)
    edge_states, ok, in_goal = _revalidate(system, cfg, x0, goal_xy, obs, refined, mask)
    states = torch.cat([x0, edge_states[0]], 0)
    refined_np = refined[0].cpu().numpy()
    return {
        "controls": refined_np,
        "states": states.cpu().numpy(),
        "cost_before": float(path[1:, -1].sum()),
        "cost_after": float(refined_np[:, -1].sum()),
        "valid": bool(ok[0] and in_goal[0]),
        "losses": losses[:, 0].cpu().numpy(),
    }


def refine_batch(system, cfg: KGMTConfig, paths: np.ndarray, path_lengths: np.ndarray,
                 goals: np.ndarray, obstacles: np.ndarray,
                 rcfg: RefineConfig | None = None,
                 device: torch.device | str = "cuda") -> dict:
    """Refine a batch of solved paths at once. paths: [B, Lmax, SAMPLE_DIM]
    (MultiQueryResult.paths: row 0 the root, rows 1..length-1 each edge's
    controls in columns state_dim:); path_lengths [B] node counts (0 or 1:
    unsolved, skipped); goals [B, SAMPLE_DIM]; obstacles [B, K, 4] or a
    shared [K, 4]. Returns numpy values: refined controls [B, Lmax-1, C+1]
    (unsolved rows untouched), cost_before and cost_after [B], valid [B]
    (the hard re-validation and the goal), improved [B] (valid and
    cheaper: keep the original elsewhere) and losses [B, iterations]."""
    from cudasbmp_torch.planners.kgmt import resolve_device

    rcfg = rcfg or RefineConfig()
    dev = resolve_device(device)
    paths = np.asarray(paths, dtype=np.float32)
    B, Lmax = paths.shape[0], paths.shape[1]
    if Lmax < 2:
        raise ValueError("paths must have room for at least one edge")
    S = system.state_dim
    x0s = torch.as_tensor(np.ascontiguousarray(paths[:, 0, :S]), device=dev)
    controls0 = torch.as_tensor(np.ascontiguousarray(paths[:, 1:, S:]), device=dev)
    goal_xys = torch.as_tensor(np.ascontiguousarray(np.asarray(goals, np.float32)[:, :2]),
                               device=dev)
    obstacles = np.asarray(obstacles, dtype=np.float32)
    shared = torch.as_tensor(obstacles, device=dev)
    per_problem = (shared if obstacles.ndim == 3
                   else shared.expand(B, *obstacles.shape).contiguous())
    lengths = np.asarray(path_lengths).astype(np.int64)
    masks = torch.as_tensor(np.arange(Lmax - 1)[None, :] < (lengths[:, None] - 1),
                            device=dev)
    # edges past the longest real path are masked in every row: refine and
    # replay up to it, and keep controls0 beyond (the same bits)
    n = min(max(int(lengths.max(initial=0)) - 1, 1), Lmax - 1)
    refined, losses = _refine_core(system, cfg, rcfg, x0s, goal_xys, shared,
                                   controls0[:, :n].contiguous(),
                                   masks[:, :n].contiguous())
    refined = torch.cat([refined, controls0[:, n:]], 1)
    _, ok, in_goal = _revalidate(system, cfg, x0s, goal_xys, per_problem, refined, masks,
                                 edges=n)
    cost_before = row_sum(torch.where(masks, controls0[..., -1], 0.0))[:, 0]
    cost_after = row_sum(torch.where(masks, refined[..., -1], 0.0))[:, 0]
    cost_before, cost_after = cost_before.cpu().numpy(), cost_after.cpu().numpy()
    valid = (ok & in_goal).cpu().numpy() & (lengths >= 2)
    return {
        "controls": refined.cpu().numpy(),
        "cost_before": cost_before,
        "cost_after": cost_after,
        "valid": valid,
        "improved": valid & (cost_after < cost_before),
        "losses": losses.T.cpu().numpy(),
    }
