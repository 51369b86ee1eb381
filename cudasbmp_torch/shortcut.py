"""Sampling-based kinodynamic path shortcutting (counterpart of
cudasbmp_tpu/shortcut.py).

The reference returns the first feasible trajectory and stops (KGMT.cu:
251-254). This post-processing stage repeatedly picks a node i on the path,
fires ``candidates`` random rollouts from it, replays the path's suffix
after a later node j from each candidate's end state, and splices in the
candidate that keeps every replayed edge collision-free, still ends in the
goal region and saves the most trajectory time. No steering function is
needed: the suffix's stored controls are replayed from the new state, the
tree's own replay invariant.

One round works on a batch of B padded paths at once ([B, N, SAMPLE_DIM],
node 0 the root, node k the state after edge k and the control that made
it). Its rollouts, the candidates and every replayed suffix step, are one
launch each: kernel B1 (``rollout_cuda``) for one path against one box set
([K, 4], ``shortcut_path``), kernel B6 (``rollout_batched_cuda``) for a
batch against one set per path ([B, K, 4], ``shortcut_batch``), with the
config's footprint and fast math; their plain twins on the CPU. A system
without a device struct replays through its generic ``step``
(``rollout_batch``) under the planners' rule
(``ops/rollout_cuda.py::rollout_route``), as the JAX round does for every
system. The JAX
round replays all N steps, frozen past each path's suffix length m; here
the replay stops after the batch's longest suffix (one read from the
device a round), since the later steps change nothing.

Keys, draws and splices are the JAX functions': round r of path b draws
from ``split(fold_in(fold_in(key(seed), r), b), 3)`` in ``shortcut_batch``
and ``split(fold_in(key(seed), r), 3)`` in ``shortcut_path``; i and j come
from ``randint`` (cudasbmp_torch.rng, bitwise jax.random.randint).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cudasbmp_torch import rng
from cudasbmp_torch.config import SAMPLE_DIM, KGMTConfig
from cudasbmp_torch.ops.rollout import rollout_batch
from cudasbmp_torch.ops.rollout_cuda import (rollout_batched_cuda, rollout_cuda,
                                             rollout_route)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ShortcutConfig:
    rounds: int = 64
    candidates: int = 256  # K random rollouts per round
    min_gain: float = 1e-4


def _rollout(system, cfg: KGMTConfig, x0: Tensor, controls: Tensor,
             obstacles: Tensor) -> tuple[Tensor, Tensor]:
    """x0 [B, K, S], controls [B, K, C] -> (x1, valid): B1 on the B*K lanes
    against obstacles [K, 4], or B6 against [B, K, 4]; the generic rollout
    for a system without a device struct."""
    if rollout_route(system, cfg.rollout_backend) == "generic":
        return rollout_batch(system, x0, controls, cfg.num_disc,
                             obstacles if obstacles.dim() == 2 else obstacles[:, None],
                             cfg.width, cfg.height, footprint=cfg.footprint)
    kw = dict(num_disc=cfg.num_disc, width=cfg.width, height=cfg.height,
              footprint=cfg.footprint, fast_math=cfg.fast_math)
    if obstacles.dim() == 3:
        return rollout_batched_cuda(system, x0, controls, obstacles, **kw)
    B, K, S = x0.shape
    x1, valid = rollout_cuda(system, x0.reshape(B * K, S),
                             controls.reshape(B * K, -1), obstacles, **kw)
    return x1.reshape(B, K, S), valid.reshape(B, K)


def _shortcut_round(system, cfg: KGMTConfig, K: int, nodes: Tensor,
                    n_edges: Tensor, goal_xy: Tensor, obstacles: Tensor,
                    keys: Tensor, min_gain: float) -> tuple[Tensor, Tensor]:
    """One shortcut attempt on every path of the batch: nodes [B, N,
    SAMPLE_DIM], n_edges [B] (int64), goal_xy [B, 2], keys [B, 2]; obstacles
    [K, 4] shared or [B, K, 4]. Returns the updated (nodes, n_edges)."""
    B, N, _ = nodes.shape
    S = system.state_dim
    dev = nodes.device
    k = rng.split(keys, 3)
    k_i, k_j, k_ctrl = k[:, 0], k[:, 1], k[:, 2]
    # i in [0, n_edges - 2], j in [i + 2, n_edges]
    can = n_edges >= 2
    i = rng.randint(k_i, (), 0, torch.clamp(n_edges - 1, min=1)).to(torch.int64)
    j = rng.randint(k_j, (), i + 2, torch.maximum(n_edges + 1, i + 3)).to(torch.int64)
    j = torch.minimum(j, n_edges)

    def node_rows(idx: Tensor) -> Tensor:
        """nodes[b, idx[b, t]] for idx [B, T] -> [B, T, SAMPLE_DIM]."""
        return nodes.gather(1, idx[..., None].expand(*idx.shape, SAMPLE_DIM))

    x_i = node_rows(i[:, None])[..., :S]
    controls = system.control_spec.sample(k_ctrl.contiguous(), (K,))
    x_c, valid_c = _rollout(system, cfg, x_i.expand(B, K, S).contiguous(),
                            controls, obstacles)

    # replay suffix edges j+1..n_edges from each candidate's end state, up
    # to the longest suffix of the batch
    m = n_edges - j
    state, ok = x_c, valid_c
    suffix_states = []
    for t in range(max(int(m.max()), 0)):
        active = (t < m)[:, None]
        ctrl = node_rows(torch.clamp(j + 1 + t, max=N - 1)[:, None])[..., S:]
        x1, v = _rollout(system, cfg, state,
                         ctrl.expand(B, K, SAMPLE_DIM - S).contiguous(), obstacles)
        state = torch.where(active[..., None], x1, state)
        ok = ok & (~active | v)
        suffix_states.append(state)

    dx = state[..., 0] - goal_xy[:, None, 0]
    dy = state[..., 1] - goal_xy[:, None, 1]
    d2 = dx * dx + dy * dy
    feasible = valid_c & ok & (d2 < cfg.goal_threshold ** 2) & can[:, None]

    # time gain: duration of the replaced edges i+1..j minus the candidate's
    edge_idx = torch.arange(N, device=dev)
    replaced = ((edge_idx >= (i + 1)[:, None])
                & (edge_idx <= j[:, None])).to(torch.float32)
    replaced_time = (nodes[..., SAMPLE_DIM - 1] * replaced).sum(dim=-1)
    gains = torch.where(feasible, replaced_time[:, None] - controls[..., -1],
                        float("-inf"))
    best = torch.argmax(gains, dim=-1, keepdim=True)  # [B, 1]
    accept = gains.gather(1, best)[:, 0] > min_gain

    # splice: slot s keeps nodes[s] for s <= i; s == i+1 takes the
    # candidate; s in (i+1, i+1+m] takes replayed suffix edge s - i - 2
    pick = best[..., None]
    cand = torch.cat([x_c.gather(1, pick.expand(B, 1, S)),
                      controls.gather(1, pick.expand(B, 1, controls.shape[-1]))],
                     dim=-1)  # [B, 1, SAMPLE_DIM]
    t_of_slot = edge_idx - (i + 2)[:, None]  # [B, N]
    if suffix_states:
        stacked = torch.stack(suffix_states, dim=1)  # [B, T, K, S]
        T = stacked.shape[1]
        best_states = stacked.gather(
            2, pick[:, None].expand(B, T, 1, S))[:, :, 0]  # [B, T, S]
        replayed = best_states.gather(
            1, t_of_slot.clamp(0, T - 1)[..., None].expand(B, N, S))
    else:
        replayed = torch.zeros((B, N, S), dtype=nodes.dtype, device=dev)
    suffix_sample = torch.cat(
        [replayed, node_rows(torch.clamp(j[:, None] + 1 + t_of_slot, 0, N - 1))[..., S:]],
        dim=-1)
    in_suffix = ((t_of_slot >= 0) & (t_of_slot < m[:, None]))[..., None]
    new_nodes = torch.where(
        (edge_idx <= i[:, None])[..., None], nodes,
        torch.where((edge_idx == (i + 1)[:, None])[..., None], cand,
                    torch.where(in_suffix, suffix_sample, 0.0)))
    nodes = torch.where(accept[:, None, None], new_nodes, nodes)
    n_edges = torch.where(accept, i + 1 + m, n_edges)
    return nodes, n_edges


def shortcut_batch(system, cfg: KGMTConfig, paths: np.ndarray,
                   path_lengths: np.ndarray, goals: np.ndarray,
                   obstacles: np.ndarray, scfg: ShortcutConfig | None = None,
                   seed: int = 0, device: torch.device | str = "cuda") -> dict:
    """Shortcut a batch of solved paths (``MultiQueryResult.paths``: [B,
    Lmax, SAMPLE_DIM] padded, root first; path_lengths [B] node counts, < 2
    = unsolved, passed through untouched), each against its own box set
    ([B, K, 4], kernel B6) or a shared one ([K, 4], broadcast). Returns
    numpy arrays: paths [B, Lmax, SAMPLE_DIM] (entries past the new edge
    count zeroed), path_lengths [B], cost_before/cost_after [B]."""
    from cudasbmp_torch.planners.kgmt import resolve_device

    scfg = scfg or ShortcutConfig()
    dev = resolve_device(device)
    B, N = paths.shape[0], paths.shape[1]
    obstacles = np.asarray(obstacles, dtype=np.float32)
    if obstacles.ndim == 2:
        obstacles = np.broadcast_to(obstacles, (B,) + obstacles.shape)
    lengths = np.asarray(path_lengths)
    nodes = torch.as_tensor(np.asarray(paths, dtype=np.float32), device=dev)
    n_edges0 = np.maximum(lengths.astype(np.int64) - 1, 0)
    n_edges = torch.as_tensor(n_edges0, device=dev)
    goal_xy = torch.as_tensor(np.asarray(goals, dtype=np.float32)[:, :2], device=dev)
    obs = torch.as_tensor(np.ascontiguousarray(obstacles), device=dev)
    key = rng.key(seed, dev)
    problem = torch.arange(B, device=dev)
    for r in range(scfg.rounds):
        keys = rng.fold_in(rng.fold_in(key, r), problem)
        nodes, n_edges = _shortcut_round(system, cfg, scfg.candidates, nodes,
                                         n_edges, goal_xy, obs, keys, scfg.min_gain)
    nodes_np = nodes.cpu().numpy()
    n_edges_np = n_edges.cpu().numpy()
    idx = np.arange(N)[None, :]
    edge_mask0 = (idx >= 1) & (idx <= n_edges0[:, None])
    edge_mask1 = (idx >= 1) & (idx <= n_edges_np[:, None])
    return {
        "paths": nodes_np,
        "path_lengths": np.where(lengths >= 2, n_edges_np + 1, lengths),
        "cost_before": (np.asarray(paths)[:, :, SAMPLE_DIM - 1] * edge_mask0).sum(axis=1),
        "cost_after": (nodes_np[:, :, SAMPLE_DIM - 1] * edge_mask1).sum(axis=1),
    }


def shortcut_path(system, cfg: KGMTConfig, path: np.ndarray, goal: np.ndarray,
                  obstacles: np.ndarray, scfg: ShortcutConfig | None = None,
                  seed: int = 0, device: torch.device | str = "cuda") -> dict:
    """Shortcut one solved path (``KGMTResult.path``, [L+1, SAMPLE_DIM],
    root first) against obstacles [K, 4]: its rollouts go through kernel
    B1. Returns the new path, its edge count and the cost before and
    after."""
    from cudasbmp_torch.planners.kgmt import resolve_device

    scfg = scfg or ShortcutConfig()
    dev = resolve_device(device)
    N = path.shape[0]
    if N < 2:
        raise ValueError("path must contain at least one edge")
    nodes = torch.as_tensor(np.asarray(path, dtype=np.float32), device=dev)[None]
    n_edges = torch.full((1,), N - 1, dtype=torch.int64, device=dev)
    goal_xy = torch.as_tensor(np.asarray(goal, dtype=np.float32)[None, :2], device=dev)
    obs = torch.as_tensor(np.asarray(obstacles, dtype=np.float32), device=dev)
    key = rng.key(seed, dev)
    for r in range(scfg.rounds):
        nodes, n_edges = _shortcut_round(system, cfg, scfg.candidates, nodes,
                                         n_edges, goal_xy, obs,
                                         rng.fold_in(key, r)[None], scfg.min_gain)
    n = int(n_edges[0])
    new_path = nodes[0, :n + 1].cpu().numpy()
    return {
        "path": new_path,
        "n_edges": n,
        "cost_before": float(path[1:, SAMPLE_DIM - 1].sum()),
        "cost_after": float(new_path[1:, SAMPLE_DIM - 1].sum()),
    }
