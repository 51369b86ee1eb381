"""Batched propagate-and-check in plain PyTorch: the plain version of the
rollout kernel (counterpart of cudasbmp_tpu/ops/rollout.py::rollout_batch).

B rollouts advance in lockstep for ``num_disc`` Euler steps with an
``alive`` mask in place of the reference's ``break``: a rollout freezes at
the candidate state of its first failing step (out of the exclusive
workspace bounds, or its step's swept AABB hits an obstacle), so valid
rollouts match the reference and invalid ones expose the position of the
failing step. The op order is the JAX function's, operator by operator.
"""

from __future__ import annotations

import torch

from cudasbmp_torch._math import div
from cudasbmp_torch.geometry.aabb import segment_aabb, segment_clear


def rollout_batch(system, x0: torch.Tensor, controls: torch.Tensor,
                  num_disc: int, obstacles: torch.Tensor, width: float,
                  height: float) -> tuple[torch.Tensor, torch.Tensor]:
    """x0 [B, state_dim], controls [B, control_dim] (duration last),
    obstacles [K, 4] -> (x1 [B, state_dim], valid bool [B])."""
    duration = controls[:, -1]
    ctrl = controls[:, :-1]
    dt = div(duration, num_disc)
    state = x0
    alive = torch.ones(x0.shape[0], dtype=torch.bool, device=x0.device)
    for _ in range(num_disc):
        cand = system.step(state, ctrl, dt)
        x, y = cand[:, 0], cand[:, 1]
        in_bounds = (x > 0.0) & (x < width) & (y > 0.0) & (y < height)
        bb_min, bb_max = segment_aabb(state[:, 0:2], cand[:, 0:2])
        clear = segment_clear(bb_min, bb_max, obstacles)
        state = torch.where(alive[:, None], cand, state)
        alive = alive & in_bounds & clear
    return state, alive
