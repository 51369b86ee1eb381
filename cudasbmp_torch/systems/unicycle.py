"""Differential-drive unicycle (counterpart of
cudasbmp_tpu/systems/unicycle.py). State (x, y, theta, 0); controls
(v, omega) plus duration:

    x     += v * cos(theta) * dt        # PRE-step theta
    y     += v * sin(theta) * dt
    theta += omega * dt
"""

from __future__ import annotations

import dataclasses
import math
from typing import ClassVar

import torch

from cudasbmp_torch.systems.base import ControlSpec


@dataclasses.dataclass(frozen=True)
class Unicycle:
    name: str = "unicycle"
    state_dim: int = 4
    heading_index: ClassVar[int] = 2
    control_spec: ControlSpec = dataclasses.field(
        default_factory=lambda: ControlSpec(lo=(-2.0, -math.pi, 0.05),
                                            hi=(2.0, math.pi, 1.05)))

    def step(self, state: torch.Tensor, control: torch.Tensor,
             dt: torch.Tensor) -> torch.Tensor:
        x, y, theta = state[..., 0], state[..., 1], state[..., 2]
        v, omega = control[..., 0], control[..., 1]
        new_x = x + v * torch.cos(theta) * dt
        new_y = y + v * torch.sin(theta) * dt
        new_theta = theta + omega * dt
        return torch.stack([new_x, new_y, new_theta, torch.zeros_like(new_x)],
                           dim=-1)

    def soa_prepare(self, ctrl: list[torch.Tensor]) -> tuple[torch.Tensor, ...]:
        v, omega = ctrl
        return v, omega

    def soa_step(self, comps: list[torch.Tensor], aux: tuple[torch.Tensor, ...],
                 dt: torch.Tensor) -> list[torch.Tensor]:
        x, y, th, z = comps
        v, omega = aux
        return [x + v * torch.cos(th) * dt,
                y + v * torch.sin(th) * dt,
                th + omega * dt,
                torch.zeros_like(z)]

    # Fast-math hooks: dtheta = omega*dt is constant per rollout, so one
    # rotation per step replaces cos and sin.
    def soa_prepare_fast(self, comps, ctrl, dt):
        v, omega = ctrl
        th = comps[2]
        d0 = omega * dt
        return (torch.cos(th), torch.sin(th)), (v, omega, torch.cos(d0),
                                                torch.sin(d0))

    def soa_step_fast(self, comps, carry, aux, dt):
        x, y, th, z = comps
        ct, st = carry
        v, omega, dct, dst = aux
        new = [x + v * ct * dt,
               y + v * st * dt,
               th + omega * dt,
               torch.zeros_like(z)]
        return new, (ct * dct - st * dst, st * dct + ct * dst)
