"""Value and gradient of trajectory refinement's penalty (csrc/refine.cu,
kernel R1) and its plain twin.

The JAX package refines a path by ``jax.value_and_grad`` of its loss
(cudasbmp_tpu/refine.py:77-107, 122), one jitted XLA program with no Pallas
kernel. The loss unrolls every edge's ``num_disc`` Euler steps in sequence
and scores each fine point: a soft penetration of the margin-inflated boxes,
a soft out-of-bounds term and, on the last point, a soft goal term. This
module computes that penalty,

    collision_weight * (collision + oob) + goal_weight * goal_pen,

for a batch of problems, and its gradient with respect to the controls.
The time term, the sigmoid box reparameterisation and the masks are torch
ops around it (cudasbmp_torch/refine.py::_loss).

- ``unroll_positions`` and ``soft_penetration`` are the JAX functions
  ``_unroll_positions`` and ``_soft_penetration`` over a batch;
- ``refine_penalty_torch`` is the plain twin: the penalty as torch ops,
  differentiated by autograd (some 60 launches a bicycle step, forward and
  backward, on the card: chip_smoke.py, phase 28);
- ``refine_penalty_cuda`` is the wrapper: on the CPU the twin, on a CUDA
  tensor one launch of R1 in the forward (loss and gradient together) and
  the saved gradient scaled in the backward (``_R1``).

Inputs: x0 [B, S], controls [B, L, C+1] with masked durations already 0,
wts [B, L] (a weight per edge, repeated over its points: 0 silences padded
edges), goal_xy [B, 2], obstacles [K, 4] shared or [B, K, 4]. Every sum
is ``_math.row_sum``'s fixed order in the twin and one fixed order in the
kernel, so a problem's value does not depend on its batch or on padded
edges after its path.

One rule, as for every wrapper of the package: tensors on the CPU go
through the plain twin; CUDA tensors launch the kernel or raise. R1 counts
its launches in ``refine_penalty_cuda.launches`` and a user struct's also
in ``refine_penalty_cuda.user_systems[name]``. A user's system runs R1
through its device struct's library (ops/rollout_cuda.py::kernel_system)
where the struct has the adjoint hook ``back``; on the card one without it
raises, naming the hook, where the JAX package differentiates any
system's ``step`` (the one place where the port asks more of a user
system). On the CPU the twin differentiates ``step`` for any system.
"""

from __future__ import annotations

import collections

import torch

from cudasbmp_torch._math import div, row_sum
from cudasbmp_torch.ops import _build
from cudasbmp_torch.ops.rollout_cuda import (USER_SYSTEM_ID, _check, _device_of,
                                             _index, _raise_on, kernel_system)

Tensor = torch.Tensor
MAX_POINTS = 2 ** 31 - 1  # the kernel's point index is an int


def unroll_positions(system, x0: Tensor, controls: Tensor, num_disc: int) -> Tensor:
    """Positions after every Euler step of every edge, [B, L * num_disc, 2]:
    edge l integrates ``num_disc`` steps of dt = dur / num_disc (a true
    division) with its controls from the previous edge's end state, through
    ``system.step``, the exact step."""
    state, pts = x0, []
    for ctrl in controls.unbind(1):
        u, dt = ctrl[:, :-1], div(ctrl[:, -1], num_disc)
        for _ in range(num_disc):
            state = system.step(state, u, dt)
            pts.append(state[:, :2])
    return torch.stack(pts, 1)


def soft_penetration(px: Tensor, py: Tensor, obstacles: Tensor, margin: float,
                     wts: Tensor) -> Tensor:
    """Sum over points and boxes of relu(-signed distance)^2 * weight, the
    signed distance to each margin-inflated box being max over the axes of
    max(lo - margin - p, p - hi - margin); px, py, wts [B, T], obstacles
    [K, 4] or [B, K, 4] -> [B]."""
    if obstacles.dim() == 2:
        obstacles = obstacles[None]
    ox0, oy0, ox1, oy1 = (o[:, None, :] for o in obstacles.unbind(-1))
    px, py = px[..., None], py[..., None]
    dx = torch.maximum(ox0 - margin - px, px - ox1 - margin)
    dy = torch.maximum(oy0 - margin - py, py - oy1 - margin)
    outside = torch.maximum(dx, dy)  # > 0 outside, < 0 inside
    return row_sum((torch.relu(-outside) ** 2 * wts[..., None]).flatten(1))[:, 0]


def _weighted_squares(z: Tensor, wts: Tensor) -> Tensor:
    return row_sum(torch.relu(z) ** 2 * wts)[:, 0]


def refine_penalty_torch(system, x0: Tensor, controls: Tensor, wts: Tensor,
                         goal_xy: Tensor, obstacles: Tensor, *, num_disc: int,
                         width: float, height: float, margin: float,
                         goal_threshold: float, collision_weight: float,
                         goal_weight: float) -> Tensor:
    """Plain twin of R1: the penalty [B] as torch ops (cudasbmp_tpu/
    refine.py:87-104), differentiable by autograd."""
    pts = unroll_positions(system, x0, controls, num_disc)
    px, py = pts[..., 0], pts[..., 1]
    w = wts.repeat_interleave(num_disc, dim=1)
    collision = soft_penetration(px, py, obstacles, margin, w)
    oob = (_weighted_squares(margin - px, w)
           + _weighted_squares(px - (width - margin), w)
           + _weighted_squares(margin - py, w)
           + _weighted_squares(py - (height - margin), w))
    goal_dist = row_sum((pts[:, -1] - goal_xy) ** 2)[:, 0]
    goal_pen = torch.relu(torch.sqrt(goal_dist + 1e-9)
                          - 0.8 * goal_threshold) ** 2
    return collision_weight * (collision + oob) + goal_weight * goal_pen


def _launch(system, x0: Tensor, controls: Tensor, wts: Tensor, goal_xy: Tensor,
            obstacles: Tensor, *, num_disc: int, width: float, height: float,
            margin: float, goal_threshold: float, collision_weight: float,
            goal_weight: float) -> tuple[Tensor, Tensor, Tensor]:
    """One launch of R1: (penalty [B], d penalty / d controls [B, L, C+1],
    the forward chain's states [B, L * num_disc + 1, 4], x0 first)."""
    sid, param, struct = kernel_system(system, "refinement (R1)")
    lib = _build.load(struct)
    if struct is not None and not lib.cudasbmp_user_has_back():
        raise NotImplementedError(
            f"system {system.name!r}: its device struct has no back(s, q, dt, lam, g), "
            "the adjoint hook R1 needs on the card (systems/base.py::DeviceStructMixin)")
    B, L = controls.shape[:2]
    per_problem = obstacles.dim() == 3
    K = obstacles.shape[-2]
    _check("x0", x0, (B, system.state_dim), torch.float32)
    _check("controls", controls, (B, L, system.control_spec.dim), torch.float32)
    _check("wts", wts, (B, L), torch.float32)
    _check("goal_xy", goal_xy, (B, 2), torch.float32)
    _check("obstacles", obstacles, ((B, K, 4) if per_problem else (K, 4)), torch.float32)
    T = L * num_disc
    if num_disc < 1 or not 1 <= T <= MAX_POINTS:
        raise ValueError(f"{L} edges x {num_disc} steps: R1 takes 1 to {MAX_POINTS} "
                         "points a problem")
    dev = x0.device
    loss = torch.empty(B, dtype=torch.float32, device=dev)
    grad = torch.empty_like(controls)
    # global scratch: each problem's T + 1 states and T position gradients
    states = torch.empty((B, T + 1, 4), dtype=torch.float32, device=dev)
    if B == 0:
        return loss, grad, states
    gpos = torch.empty((B, T, 2), dtype=torch.float32, device=dev)
    rc = lib.cudasbmp_refine(
        _index(dev), sid, param, x0.data_ptr(), controls.data_ptr(), wts.data_ptr(),
        goal_xy.data_ptr(), obstacles.data_ptr(), K, int(per_problem),
        states.data_ptr(), gpos.data_ptr(), loss.data_ptr(), grad.data_ptr(), B, L,
        num_disc, margin, width - margin, height - margin, 0.8 * goal_threshold,
        collision_weight, goal_weight, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "refine_kernel")
    refine_penalty_cuda.launches += 1
    if sid == USER_SYSTEM_ID:
        refine_penalty_cuda.user_systems[system.name] += 1
    return loss, grad, states


class _R1(torch.autograd.Function):
    """R1 under autograd: the forward launches the kernel once and keeps
    its gradient; the backward scales it by the incoming cotangent."""

    @staticmethod
    def forward(ctx, controls, system, x0, wts, goal_xy, obstacles, kw):
        loss, grad, _ = _launch(system, x0, controls, wts, goal_xy, obstacles, **kw)
        ctx.save_for_backward(grad)
        return loss

    @staticmethod
    def backward(ctx, grad_out):
        (grad,) = ctx.saved_tensors
        return grad_out[:, None, None] * grad, None, None, None, None, None, None


def refine_penalty_cuda(system, x0: Tensor, controls: Tensor, wts: Tensor,
                        goal_xy: Tensor, obstacles: Tensor, *, num_disc: int,
                        width: float, height: float, margin: float,
                        goal_threshold: float, collision_weight: float,
                        goal_weight: float) -> Tensor:
    """Kernel R1: the refinement penalty [B] of ``refine_penalty_torch``,
    differentiable with respect to ``controls`` (one launch computes the
    value and the gradient); the plain twin on the CPU."""
    kw = dict(num_disc=num_disc, width=width, height=height, margin=margin,
              goal_threshold=goal_threshold, collision_weight=collision_weight,
              goal_weight=goal_weight)
    if _device_of(x0, controls, wts, goal_xy, obstacles).type == "cpu":
        return refine_penalty_torch(system, x0, controls, wts, goal_xy, obstacles, **kw)
    return _R1.apply(controls.contiguous(), system, x0.contiguous(), wts.contiguous(),
                     goal_xy.contiguous(), obstacles.contiguous(), kw)


refine_penalty_cuda.launches = 0
refine_penalty_cuda.user_systems = collections.Counter()
