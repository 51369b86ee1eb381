"""Narrow-phase collision: the agent's oriented rectangular body against AABB
obstacles (counterpart of cudasbmp_tpu/geometry/footprint.py).

The body is ``2*half_len`` long and ``2*half_wid`` wide, extending FORWARD
from the pose point (rear axle at the pose, front axle at pose + L*heading).
The test is the 2-D separating-axis theorem on four axes: the two world
axes and the two body axes. Touching does not collide (>= separation, as
the broad phase), and padding rows (max < min) never hit; zero-thickness
walls (max == min) do. The op order is the JAX function's, operator by
operator, and the CUDA kernel (csrc/rollout.cu) keeps it too.
"""

from __future__ import annotations

import torch


def footprint_clear(x: torch.Tensor, y: torch.Tensor, theta: torch.Tensor,
                    half_len: float, half_wid: float,
                    obstacles: torch.Tensor) -> torch.Tensor:
    """True iff the body at pose (x, y, theta) overlaps no obstacle. x, y,
    theta [...] (broadcastable); obstacles [K, 4] or broadcastable
    [..., K, 4]; returns bool [...]."""
    return footprint_clear_cs(x, y, torch.cos(theta), torch.sin(theta),
                              half_len, half_wid, obstacles)


def footprint_clear_cs(x: torch.Tensor, y: torch.Tensor, ct: torch.Tensor,
                       st: torch.Tensor, half_len: float, half_wid: float,
                       obstacles: torch.Tensor) -> torch.Tensor:
    """``footprint_clear`` with the heading given as its cosine and sine (the
    fast-math rollout carries them instead of theta). Obstacles may carry
    leading dimensions that broadcast against the poses' ([B, 1, K, 4]
    against poses [B, R])."""
    hl, hw = half_len, half_wid
    cx = x + hl * ct  # body center
    cy = y + hl * st
    act, ast = torch.abs(ct), torch.abs(st)

    bcx = (obstacles[..., 0] + obstacles[..., 2]) * 0.5  # [..., K]
    bcy = (obstacles[..., 1] + obstacles[..., 3]) * 0.5
    bhx = (obstacles[..., 2] - obstacles[..., 0]) * 0.5
    bhy = (obstacles[..., 3] - obstacles[..., 1]) * 0.5
    valid_box = (bhx >= 0) & (bhy >= 0)

    dx = cx[..., None] - bcx  # [..., K]
    dy = cy[..., None] - bcy
    act_k, ast_k = act[..., None], ast[..., None]
    ct_k, st_k = ct[..., None], st[..., None]
    sep_x = torch.abs(dx) >= bhx + hl * act_k + hw * ast_k
    sep_y = torch.abs(dy) >= bhy + hl * ast_k + hw * act_k
    sep_u = torch.abs(dx * ct_k + dy * st_k) >= hl + bhx * act_k + bhy * ast_k
    sep_v = torch.abs(dy * ct_k - dx * st_k) >= hw + bhx * ast_k + bhy * act_k
    hit = valid_box & ~(sep_x | sep_y | sep_u | sep_v)
    return ~hit.any(dim=-1)


def footprint_corners(x, y, theta, half_len: float,
                      half_wid: float) -> torch.Tensor:
    """Counter-clockwise world-frame corners of the body at pose(s):
    [..., 4, 2]."""
    ct, st = torch.cos(theta), torch.sin(theta)
    local = torch.tensor([[0.0, -half_wid], [2 * half_len, -half_wid],
                          [2 * half_len, half_wid], [0.0, half_wid]],
                         dtype=torch.float32, device=ct.device)
    wx = x[..., None] + local[:, 0] * ct[..., None] - local[:, 1] * st[..., None]
    wy = y[..., None] + local[:, 0] * st[..., None] + local[:, 1] * ct[..., None]
    return torch.stack([wx, wy], dim=-1)
