"""2-D point agent, velocity-controlled (counterpart of
cudasbmp_tpu/systems/point2d.py). State (x, y, 0, 0): the two padding dims
keep the shared 4-float state layout. Controls (vx, vy) plus duration:

    x += vx * dt
    y += vy * dt
"""

from __future__ import annotations

import dataclasses

import torch

from cudasbmp_torch.systems.base import ControlSpec


@dataclasses.dataclass(frozen=True)
class Point2D:
    name: str = "point2d"
    state_dim: int = 4
    max_speed: float = 2.0
    # None -> derived from max_speed, so the two never disagree
    control_spec: ControlSpec | None = None

    def __post_init__(self) -> None:
        if self.control_spec is None:
            object.__setattr__(self, "control_spec", ControlSpec(
                lo=(-self.max_speed, -self.max_speed, 0.05),
                hi=(self.max_speed, self.max_speed, 1.05)))

    def step(self, state: torch.Tensor, control: torch.Tensor,
             dt: torch.Tensor) -> torch.Tensor:
        x, y = state[..., 0], state[..., 1]
        vx, vy = control[..., 0], control[..., 1]
        new_x = x + vx * dt
        new_y = y + vy * dt
        zeros = torch.zeros_like(new_x)
        return torch.stack([new_x, new_y, zeros, zeros], dim=-1)

    def soa_prepare(self, ctrl: list[torch.Tensor]) -> tuple[torch.Tensor, ...]:
        vx, vy = ctrl
        return vx, vy

    def soa_step(self, comps: list[torch.Tensor], aux: tuple[torch.Tensor, ...],
                 dt: torch.Tensor) -> list[torch.Tensor]:
        x, y, z0, z1 = comps
        vx, vy = aux
        return [x + vx * dt, y + vy * dt, torch.zeros_like(z0),
                torch.zeros_like(z1)]
