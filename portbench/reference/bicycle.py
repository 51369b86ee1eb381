"""The kinematic bicycle of the reference demo (nipe1783/cudaSBMP
``src/statePropagator/statePropagator.cu``), written out plainly:

    x     += v * cos(theta) * dt        # the step's starting theta and v
    y     += v * sin(theta) * dt
    theta += (v / L) * tan(steering) * dt
    v     += a * dt

State (x, y, theta, v), control (a, steering, duration); an edge is
``num_disc`` Euler steps of ``duration / num_disc``. Plain PyTorch on the
CPU in whatever dtype it is given: float64 to judge, bfloat16 for the
control that has to fail the judge. Imports nothing of the program.
"""

from __future__ import annotations

import math

import torch

STATE_DIM = 4
CONTROL_LO = (-5.0, -math.pi, 0.05)
CONTROL_HI = (5.0, math.pi, 1.05)


def step(state: torch.Tensor, control: torch.Tensor, dt: torch.Tensor,
         length: float) -> torch.Tensor:
    """One Euler step: state [..., 4], control [..., 2] (a, steering), dt
    [...] -> the next state."""
    x, y, th, v = state.unbind(-1)
    a, steer = control[..., 0], control[..., 1]
    return torch.stack([x + v * torch.cos(th) * dt,
                        y + v * torch.sin(th) * dt,
                        th + (v / length) * torch.tan(steer) * dt,
                        v + a * dt], dim=-1)


def edge_states(x0: torch.Tensor, control: torch.Tensor, num_disc: int,
                length: float) -> torch.Tensor:
    """Every state of an edge: x0 [..., 4], control [..., 3] (duration
    last) -> [..., num_disc + 1, 4], x0 first, in x0's dtype."""
    control = control.to(x0.dtype)
    dt = control[..., 2] / num_disc
    states = [x0]
    for _ in range(num_disc):
        states.append(step(states[-1], control[..., :2], dt, length))
    return torch.stack(states, dim=-2)


def scale(states: torch.Tensor, control: torch.Tensor) -> torch.Tensor:
    """The size each end-state component's rounding error grows with, over
    an edge's states [E, S, 4] and controls [E, 3]: the heading adds the
    rounding of every theta it passes (max(1, |theta|)); a position adds
    its own (max(1, |x|, |y|)) and the heading's error carried through
    cos/sin for |v| * duration; the speed its own (max(1, |v|)). Returns
    [E, 4]."""
    th = states[..., 2].abs().amax(-1).clamp(min=1)
    v = states[..., 3].abs().amax(-1).clamp(min=1)
    xy = states[:, -1, :2].abs().amax(-1)
    pos = torch.maximum(xy, v * control[:, 2].abs() * th).clamp(min=1)
    return torch.stack([pos, pos, th, v], -1)
