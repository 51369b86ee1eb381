"""Dubins-style curvature car, forward-only speed and bounded curvature
(counterpart of cudasbmp_tpu/systems/dubins.py). State (x, y, theta, 0);
controls (v, kappa) plus duration:

    x     += v * cos(theta) * dt        # PRE-step theta
    y     += v * sin(theta) * dt
    theta += v * kappa * dt
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from cudasbmp_torch.systems.base import ControlSpec


@dataclasses.dataclass(frozen=True)
class DubinsCar:
    name: str = "dubins"
    state_dim: int = 4
    heading_index: ClassVar[int] = 2
    kappa_max: float = 1.0  # min turn radius = 1 / kappa_max
    control_spec: ControlSpec = dataclasses.field(
        default_factory=lambda: ControlSpec(lo=(0.25, -1.0, 0.05),
                                            hi=(2.0, 1.0, 1.05)))

    def step(self, state: torch.Tensor, control: torch.Tensor,
             dt: torch.Tensor) -> torch.Tensor:
        x, y, theta = state[..., 0], state[..., 1], state[..., 2]
        v, kappa = control[..., 0], control[..., 1]
        new_x = x + v * torch.cos(theta) * dt
        new_y = y + v * torch.sin(theta) * dt
        new_theta = theta + v * kappa * dt
        return torch.stack([new_x, new_y, new_theta, torch.zeros_like(new_x)],
                           dim=-1)

    def soa_prepare(self, ctrl: list[torch.Tensor]) -> tuple[torch.Tensor, ...]:
        v, kappa = ctrl
        return v, kappa

    def soa_step(self, comps: list[torch.Tensor], aux: tuple[torch.Tensor, ...],
                 dt: torch.Tensor) -> list[torch.Tensor]:
        x, y, th, z = comps
        v, kappa = aux
        return [x + v * torch.cos(th) * dt,
                y + v * torch.sin(th) * dt,
                th + v * kappa * dt,
                torch.zeros_like(z)]

    # Fast-math hooks: v is constant per rollout, so dtheta = v*kappa*dt is
    # too; one rotation per step replaces cos and sin.
    def soa_prepare_fast(self, comps, ctrl, dt):
        v, kappa = ctrl
        th = comps[2]
        d0 = v * kappa * dt
        return (torch.cos(th), torch.sin(th)), (v, kappa, torch.cos(d0),
                                                torch.sin(d0))

    def soa_step_fast(self, comps, carry, aux, dt):
        x, y, th, z = comps
        ct, st = carry
        v, kappa, dct, dst = aux
        new = [x + v * ct * dt,
               y + v * st * dt,
               th + v * kappa * dt,
               torch.zeros_like(z)]
        return new, (ct * dct - st * dst, st * dct + ct * dst)
