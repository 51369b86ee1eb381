"""Trajectory refinement's kernels (csrc/refine.cu) and their plain twins:
R1, the penalty's value and gradient, and the whole refinement in one
launch.

The JAX package refines a path by ``jax.value_and_grad`` of its loss
(cudasbmp_tpu/refine.py:77-107, 122) inside a jitted ``lax.scan`` of Adam
steps (refine.py:111-151), vmapped over problems (``_refine_batch_jit``):
one XLA program with no Pallas kernel. The loss unrolls every edge's
``num_disc`` Euler steps in sequence and scores each fine point: a soft
penetration of the margin-inflated boxes, a soft out-of-bounds term and,
on the last point, a soft goal term. R1 computes that penalty,

    collision_weight * (collision + oob) + goal_weight * goal_pen,

for a batch of problems, and its gradient with respect to the controls.

- ``unroll_positions`` and ``soft_penetration`` are the JAX functions
  ``_unroll_positions`` and ``_soft_penetration`` over a batch;
- ``refine_penalty_torch`` is R1's plain twin: the penalty as torch ops,
  differentiated by autograd (some 60 launches a bicycle step, forward and
  backward, on the card: chip_smoke.py, phase 28);
- ``refine_penalty_cuda`` is R1's wrapper: on the CPU the twin, on a CUDA
  tensor one launch of R1 in the forward (loss and gradient together) and
  the saved gradient scaled in the backward (``_R1``);
- ``objective`` adds the time term, the sigmoid box and the masks around a
  penalty (JAX's ``_loss``), and ``refine_adam_torch`` runs Adam on it as
  JAX's scan does, one step a loop iteration: with ``refine_penalty_torch``
  it is the whole refinement's plain twin, with ``refine_penalty_cuda`` on
  the card the step path (401 R1 launches a refinement);
- ``refine_adam_cuda`` is the whole refinement's wrapper: on the CPU the
  twin, on a CUDA tensor one launch of ``refine_adam_kernel`` (every Adam
  step, the best iterate and the final choice; each problem trimmed to
  its own path), whose losses and controls equal the step path's to the
  bit.

R1's inputs: x0 [B, S], controls [B, L, C+1] with masked durations already
0, wts [B, L] (a weight per edge, repeated over its points: 0 silences
padded edges), goal_xy [B, 2], obstacles [K, 4] shared or [B, K, 4]. Every
sum is ``_math.row_sum``'s fixed order in the twins and one fixed order in
the kernels, so a problem's value does not depend on its batch or on padded
edges after its path.

One rule, as for every wrapper of the package: tensors on the CPU go
through the plain twin; CUDA tensors launch the kernel or raise. R1 counts
its launches in ``refine_penalty_cuda.launches`` and a user struct's also
in ``refine_penalty_cuda.user_systems[name]``; the whole refinement in
``refine_adam_cuda.launches``, ``.user_systems`` and ``.workspaces`` (the
instantiation each launch took: "shared" or "global"). A user's system
runs both through its device struct's library (ops/rollout_cuda.py::
kernel_system) where the struct has the adjoint hook ``back``; on the card
one without it raises, naming the hook, where the JAX package
differentiates any system's ``step`` (the one place where the port asks
more of a user system). On the CPU the twin differentiates ``step`` for
any system.
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
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


def _user_library(system, kernel: str):
    """(system id, param, the library) of ``system``'s refinement kernel
    ``kernel``; raises for a user struct without ``back``."""
    sid, param, struct = kernel_system(system, f"refinement ({kernel})")
    lib = _build.load(struct)
    if struct is not None and not lib.cudasbmp_user_has_back():
        raise NotImplementedError(
            f"system {system.name!r}: its device struct has no back(s, q, dt, lam, g), "
            f"the adjoint hook {kernel} needs on the card (systems/base.py::DeviceStructMixin)")
    return sid, param, lib


def _launch(system, x0: Tensor, controls: Tensor, wts: Tensor, goal_xy: Tensor,
            obstacles: Tensor, *, num_disc: int, width: float, height: float,
            margin: float, goal_threshold: float, collision_weight: float,
            goal_weight: float) -> tuple[Tensor, Tensor, Tensor]:
    """One launch of R1: (penalty [B], d penalty / d controls [B, L, C+1],
    the forward chain's states [B, L * num_disc + 1, 4], x0 first)."""
    sid, param, lib = _user_library(system, "R1")
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


# -- the whole refinement ---------------------------------------------------

def objective(system, x0: Tensor, goal_xy: Tensor, obstacles: Tensor, raw: Tensor,
              lo: Tensor, hi: Tensor, mask: Tensor, *, penalty, num_disc: int,
              width: float, height: float, margin: float, goal_threshold: float,
              collision_weight: float, goal_weight: float, time_weight: float
              ) -> Tensor:
    """The refinement objective [B] of raw controls [B, L, C+1] (JAX's
    ``_loss`` over a batch). Masked edges get duration 0, so the unroll
    freezes at the path's end, and weight 0, so their points add nothing:
    a padded problem's objective is its unpadded one's. ``penalty`` is R1's
    wrapper, or its plain twin."""
    controls = lo + (hi - lo) * torch.sigmoid(raw)
    dur = torch.where(mask, controls[..., -1], 0.0)
    controls = torch.cat([controls[..., :-1], dur[..., None]], -1)
    time_cost = row_sum(dur)[:, 0]
    return time_weight * time_cost + penalty(
        system, x0, controls, mask.to(torch.float32), goal_xy, obstacles,
        num_disc=num_disc, width=width, height=height, margin=margin,
        goal_threshold=goal_threshold, collision_weight=collision_weight,
        goal_weight=goal_weight)


def raw_controls(system, controls0: Tensor) -> Tensor:
    """The sigmoid box's inverse at controls0 clipped 1e-4 inside the box:
    Adam's start."""
    lo, hi = system.control_spec.bounds(controls0.device)
    eps = 1e-4
    c0 = torch.clamp(controls0, lo + eps, hi - eps)
    return torch.log((c0 - lo) / (hi - c0))


def bias_tables(iterations: int, device) -> tuple[Tensor, Tensor]:
    """Adam's bias corrections 1 - 0.9^t and 1 - 0.999^t for t = 1 to
    ``iterations``, in f32 as jitted JAX computes them (torch's pow)."""
    steps = torch.arange(1, iterations + 1, dtype=torch.float32, device=device)
    return (1 - torch.full_like(steps, 0.9) ** steps,
            1 - torch.full_like(steps, 0.999) ** steps)


def refine_adam_torch(system, x0: Tensor, goal_xy: Tensor, obstacles: Tensor,
                      controls0: Tensor, mask: Tensor, *, iterations: int,
                      learning_rate: float, clip_norm: float,
                      penalty=refine_penalty_torch, **kw) -> tuple[Tensor, Tensor]:
    """Adam through the rollout for B problems (JAX's ``_refine_core``,
    vmapped): x0 [B, S], goal_xy [B, 2], obstacles [K, 4] or [B, K, 4],
    controls0 [B, L, C+1], mask [B, L] bool; ``kw`` are ``objective``'s.
    Returns (refined controls [B, L, C+1], losses [iterations, B]). Each
    problem clips by its own gradient norm, as the vmapped JAX core does;
    the bias corrections are computed in f32 as jitted JAX computes them;
    the best iterate is kept on the device and one final loss decides
    between it and the last. With ``refine_penalty_torch`` this is the
    whole refinement's plain twin; with ``refine_penalty_cuda`` on the card
    it is the step path (one R1 launch a step and one for the final loss)."""
    dev = x0.device
    lo, hi = system.control_spec.bounds(dev)
    raw0 = raw_controls(system, controls0)
    keep = mask[..., None]

    def loss_fn(raw: Tensor) -> Tensor:
        return objective(system, x0, goal_xy, obstacles, torch.where(keep, raw, raw0),
                         lo, hi, mask, penalty=penalty, **kw)

    bias1, bias2 = bias_tables(iterations, dev)
    raw, best_raw = raw0, raw0
    m = torch.zeros_like(raw0)
    v = torch.zeros_like(raw0)
    best_loss = torch.full(mask.shape[:1], float("inf"), device=dev)
    clip = torch.full_like(best_loss, clip_norm)
    losses = torch.empty((iterations, mask.shape[0]), dtype=torch.float32, device=dev)
    for t in range(iterations):
        raw_in = raw.detach().requires_grad_()
        loss = loss_fn(raw_in)
        (g,) = torch.autograd.grad(loss.sum(), raw_in)
        loss = loss.detach()
        losses[t] = loss
        # nonmonotone optimisation over chaotic dynamics: remember the best
        better = loss < best_loss
        best_raw = torch.where(better[:, None, None], raw, best_raw)
        best_loss = torch.where(better, loss, best_loss)
        g = torch.where(keep, g, 0.0)
        gn = torch.sqrt(row_sum((g * g).flatten(1))[:, 0] + 1e-12)
        g = g * torch.minimum(torch.ones_like(gn), clip / gn)[:, None, None]
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mhat = m / bias1[t]
        vhat = v / bias2[t]
        raw = raw - learning_rate * mhat / (torch.sqrt(vhat) + 1e-8)
    with torch.no_grad():
        final_loss = loss_fn(raw)
    raw = torch.where((final_loss < best_loss)[:, None, None], raw, best_raw)
    refined = lo + (hi - lo) * torch.sigmoid(raw)
    return torch.where(keep, refined, controls0), losses


def adam_workspace(system, L: int, num_disc: int, device: torch.device
                   ) -> tuple[int, int]:
    """(bytes of one problem's working set at L edges of num_disc steps,
    the dynamic shared memory a block of the whole refinement may take on
    this card): the wrapper keeps the working set in shared memory where
    the first is at most the second, else in global scratch."""
    sid, _, lib = _user_library(system, "refine_adam_kernel")
    nbytes, limit = ctypes.c_longlong(0), ctypes.c_int(0)
    rc = lib.cudasbmp_refine_adam_workspace(_index(device), sid, L, num_disc,
                                            ctypes.addressof(nbytes),
                                            ctypes.addressof(limit))
    _raise_on(rc, "refine_adam_kernel's workspace query")
    return nbytes.value, limit.value


def refine_adam_cuda(system, x0: Tensor, goal_xy: Tensor, obstacles: Tensor,
                     controls0: Tensor, mask: Tensor, *, iterations: int,
                     learning_rate: float, clip_norm: float, time_weight: float,
                     num_disc: int, width: float, height: float, margin: float,
                     goal_threshold: float, collision_weight: float,
                     goal_weight: float) -> tuple[Tensor, Tensor]:
    """The whole refinement of ``refine_adam_torch``: (refined controls
    [B, L, C+1], losses [iterations, B]). On the CPU its plain twin; on a
    CUDA tensor one launch of refine_adam_kernel, a block a problem, which
    integrates each problem's path up to its last unmasked edge only. Its
    working set lies in shared memory where it fits (``adam_workspace``),
    else in global scratch."""
    kw = dict(num_disc=num_disc, width=width, height=height, margin=margin,
              goal_threshold=goal_threshold, collision_weight=collision_weight,
              goal_weight=goal_weight, time_weight=time_weight)
    dev = _device_of(x0, goal_xy, obstacles, controls0, mask)
    if dev.type == "cpu":
        return refine_adam_torch(system, x0, goal_xy, obstacles, controls0, mask,
                                 iterations=iterations, learning_rate=learning_rate,
                                 clip_norm=clip_norm, **kw)
    sid, param, lib = _user_library(system, "refine_adam_kernel")
    B, L = controls0.shape[:2]
    per_problem = obstacles.dim() == 3
    K = obstacles.shape[-2]
    x0, goal_xy, obstacles, controls0, mask = (
        t.contiguous() for t in (x0, goal_xy, obstacles, controls0, mask))
    _check("x0", x0, (B, system.state_dim), torch.float32)
    _check("controls0", controls0, (B, L, system.control_spec.dim), torch.float32)
    _check("mask", mask, (B, L), torch.bool)
    _check("goal_xy", goal_xy, (B, 2), torch.float32)
    _check("obstacles", obstacles, ((B, K, 4) if per_problem else (K, 4)), torch.float32)
    if iterations < 0 or type(iterations) is not int:
        raise ValueError(f"iterations={iterations!r}: expected an int >= 0")
    T = L * num_disc
    if num_disc < 1 or not 1 <= T <= MAX_POINTS:
        raise ValueError(f"{L} edges x {num_disc} steps: the whole refinement takes 1 to "
                         f"{MAX_POINTS} points a problem")
    losses = torch.empty((iterations, B), dtype=torch.float32, device=dev)
    refined = torch.empty_like(controls0)
    if B == 0:
        return refined, losses
    nbytes, limit = adam_workspace(system, L, num_disc, dev)
    shared = nbytes <= limit
    scratch = torch.empty(0 if shared else B * nbytes, dtype=torch.uint8, device=dev)
    raw0 = raw_controls(system, controls0)
    bias1, bias2 = bias_tables(iterations, dev)
    lo, hi = (np.asarray(b, np.float32) for b in (system.control_spec.lo,
                                                    system.control_spec.hi))
    rc = lib.cudasbmp_refine_adam(
        _index(dev), sid, param, x0.data_ptr(), raw0.data_ptr(), controls0.data_ptr(),
        mask.data_ptr(), goal_xy.data_ptr(), obstacles.data_ptr(), K, int(per_problem),
        bias1.data_ptr(), bias2.data_ptr(), *map(float, lo), *map(float, hi),
        scratch.data_ptr(), 0 if shared else nbytes, int(shared), losses.data_ptr(),
        refined.data_ptr(), B, L, num_disc, iterations, margin, width - margin,
        height - margin, 0.8 * goal_threshold, collision_weight, goal_weight, time_weight,
        learning_rate, clip_norm, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "refine_adam_kernel")
    refine_adam_cuda.launches += 1
    refine_adam_cuda.workspaces["shared" if shared else "global"] += 1
    if sid == USER_SYSTEM_ID:
        refine_adam_cuda.user_systems[system.name] += 1
    return refined, losses


refine_adam_cuda.launches = 0
refine_adam_cuda.user_systems = collections.Counter()
refine_adam_cuda.workspaces = collections.Counter()
