"""2-D double integrator, acceleration-controlled point mass (counterpart of
cudasbmp_tpu/systems/double_integrator.py). State (x, y, vx, vy); controls
(ax, ay) plus duration. Position integrates the PRE-step velocity:

    x += vx * dt;  y += vy * dt;  vx += ax * dt;  vy += ay * dt
"""

from __future__ import annotations

import dataclasses

import torch

from cudasbmp_torch.systems.base import ControlSpec


@dataclasses.dataclass(frozen=True)
class DoubleIntegrator2D:
    name: str = "double_integrator"
    state_dim: int = 4
    control_spec: ControlSpec = dataclasses.field(
        default_factory=lambda: ControlSpec(lo=(-3.0, -3.0, 0.05),
                                            hi=(3.0, 3.0, 1.05)))

    def step(self, state: torch.Tensor, control: torch.Tensor,
             dt: torch.Tensor) -> torch.Tensor:
        x, y, vx, vy = state.unbind(-1)
        ax, ay = control[..., 0], control[..., 1]
        return torch.stack([x + vx * dt, y + vy * dt, vx + ax * dt,
                            vy + ay * dt], dim=-1)

    def soa_prepare(self, ctrl: list[torch.Tensor]) -> tuple[torch.Tensor, ...]:
        ax, ay = ctrl
        return ax, ay

    def soa_step(self, comps: list[torch.Tensor], aux: tuple[torch.Tensor, ...],
                 dt: torch.Tensor) -> list[torch.Tensor]:
        x, y, vx, vy = comps
        ax, ay = aux
        return [x + vx * dt, y + vy * dt, vx + ax * dt, vy + ay * dt]
