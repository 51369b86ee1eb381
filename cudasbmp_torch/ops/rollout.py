"""Batched propagate-and-check in plain PyTorch: the plain version of the
rollout kernel's exact path (counterpart of
cudasbmp_tpu/ops/rollout.py::rollout_batch), and the unchecked propagation
of the probe planners (``rollout_unchecked``) and its every-state form
(``rollout_states``, the edge replay of viz.py); and
``propagate_and_check``, the reference's propagateAndCheck with its control
draw, over a batch.

B rollouts advance in lockstep for ``num_disc`` Euler steps with an
``alive`` mask in place of the reference's ``break``: a rollout freezes at
the candidate state of its first failing step (out of the exclusive
workspace bounds, its step's swept AABB hits an obstacle or, with a
footprint, the body at the new pose does), so valid rollouts match the
reference and invalid ones expose the position of the failing step. The op
order is the JAX function's, operator by operator.
"""

from __future__ import annotations

import torch

from cudasbmp_torch._math import div
from cudasbmp_torch.geometry.aabb import segment_aabb, segment_clear
from cudasbmp_torch.geometry.footprint import footprint_clear
from cudasbmp_torch.ops.rollout_cuda import rollout_cuda, rollout_route


def rollout_batch(system, x0: torch.Tensor, controls: torch.Tensor,
                  num_disc: int, obstacles: torch.Tensor, width: float,
                  height: float, footprint: tuple[float, float] | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """x0 [B, state_dim], controls [B, control_dim] (duration last),
    obstacles [K, 4] -> (x1 [B, state_dim], valid bool [B]).
    ``footprint=(half_len, half_wid)`` adds the oriented-body test at every
    post-step pose, heading from ``system.heading_index`` (0 without one).
    Lanes may carry more leading dimensions, [B, R, ...], with obstacles
    [B, 1, K, 4] for one set per problem (the batched arena's plain path)."""
    duration = controls[..., -1]
    ctrl = controls[..., :-1]
    dt = div(duration, num_disc)
    heading_index = getattr(system, "heading_index", None)
    state = x0
    alive = torch.ones(x0.shape[:-1], dtype=torch.bool, device=x0.device)
    for _ in range(num_disc):
        cand = system.step(state, ctrl, dt)
        x, y = cand[..., 0], cand[..., 1]
        in_bounds = (x > 0.0) & (x < width) & (y > 0.0) & (y < height)
        bb_min, bb_max = segment_aabb(state[..., 0:2], cand[..., 0:2])
        step_ok = in_bounds & segment_clear(bb_min, bb_max, obstacles)
        if footprint is not None:
            theta = (cand[..., heading_index] if heading_index is not None
                     else torch.zeros_like(x))
            step_ok = step_ok & footprint_clear(x, y, theta, footprint[0],
                                                footprint[1], obstacles)
        state = torch.where(alive[..., None], cand, state)
        alive = alive & step_ok
    return state, alive


def rollout_unchecked(system, x0: torch.Tensor, controls: torch.Tensor,
                      num_disc: int) -> torch.Tensor:
    """Propagation with no bounds or collision test, the probe planners'
    path (counterpart of cudasbmp_tpu/ops/rollout.py::rollout_unchecked):
    x0 [B, state_dim], controls [B, control_dim] (duration last) -> x1.
    ``dt`` is a true division, as in ``rollout_batch``."""
    ctrl = controls[..., :-1]
    dt = div(controls[..., -1], num_disc)
    state = x0
    for _ in range(num_disc):
        state = system.step(state, ctrl, dt)
    return state


def rollout_states(system, x0: torch.Tensor, controls: torch.Tensor,
                   num_disc: int) -> torch.Tensor:
    """``rollout_unchecked`` keeping every state: x0 [..., state_dim],
    controls [..., control_dim] (duration last) -> [..., num_disc + 1,
    state_dim], x0 first (the edge replay of the reference's MATLAB
    cross-check, visualizationKGMT_Single.m:86-112)."""
    ctrl = controls[..., :-1]
    dt = div(controls[..., -1], num_disc)
    states = [x0]
    for _ in range(num_disc):
        states.append(system.step(states[-1], ctrl, dt))
    return torch.stack(states, dim=-2)


def propagate_and_check(system, key: torch.Tensor, x0: torch.Tensor,
                        obstacles: torch.Tensor, *, num_disc: int, width: float,
                        height: float, batch: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Draw random controls and roll them out, the reference's
    propagateAndCheck with its curand draw (statePropagator.cu:17-19) over
    a batch, from the threefry stream of ``key`` (bitwise the JAX draw;
    counterpart of cudasbmp_tpu/ops/rollout.py::propagate_and_check).
    x0 [B, state_dim] (``batch`` overrides B) -> (samples [B, state_dim +
    control_dim], final state and the control that made it, the layout of
    the tree's samples; controls; valid bool [B]). On a CUDA tensor a
    system with a device struct rolls out through kernel B1
    (``ops/rollout_cuda.py::rollout_route``), else, and on the CPU, through
    ``rollout_batch``, as the JAX function does."""
    B = x0.shape[0] if batch is None else batch
    controls = system.control_spec.sample(key, (B,))
    if x0.device.type == "cuda" and rollout_route(system) == "kernel":
        x1, valid = rollout_cuda(system, x0.contiguous(), controls, obstacles,
                                 num_disc=num_disc, width=width, height=height)
    else:
        x1, valid = rollout_batch(system, x0, controls, num_disc, obstacles,
                                  width, height)
    return torch.cat([x1, controls], -1), controls, valid
