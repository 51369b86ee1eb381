"""Kinematic bicycle ("car"), the reference's system:

    x     += v * cos(theta) * dt        # PRE-step theta and v
    y     += v * sin(theta) * dt
    theta += (v / L) * tan(steering) * dt
    v     += a * dt

Controls: a ~ U(-5, 5), steering ~ U(-pi, pi), duration ~ U(0.05, 1.05).
The float-op order is the JAX package's (cudasbmp_tpu/systems/bicycle.py),
and the CUDA rollout kernel (csrc/rollout.cu) keeps it too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import ClassVar

import torch

from cudasbmp_torch._math import div
from cudasbmp_torch.systems.base import ControlSpec


@dataclasses.dataclass(frozen=True)
class KinematicBicycle:
    name: str = "bicycle"
    state_dim: int = 4  # x, y, theta, v
    heading_index: ClassVar[int] = 2
    agent_length: float = 1.0  # wheelbase L
    control_spec: ControlSpec = dataclasses.field(
        default_factory=lambda: ControlSpec(
            lo=(-5.0, -math.pi, 0.05),
            hi=(5.0, math.pi, 1.05),
        )
    )

    def step(self, state: torch.Tensor, control: torch.Tensor,
             dt: torch.Tensor) -> torch.Tensor:
        x, y, theta, v = state.unbind(-1)
        a, steering = control[..., 0], control[..., 1]
        new_x = x + v * torch.cos(theta) * dt
        new_y = y + v * torch.sin(theta) * dt
        new_theta = theta + div(v, self.agent_length) * torch.tan(steering) * dt
        new_v = v + a * dt
        return torch.stack([new_x, new_y, new_theta, new_v], dim=-1)

    # Per-component hooks, the layout of the fused kernel: soa_prepare runs
    # once per rollout (tan(steering), kept unscaled so soa_step's op order
    # matches step bitwise), soa_step once per Euler step.
    def soa_prepare(self, ctrl: list[torch.Tensor]) -> tuple[torch.Tensor, ...]:
        a, steering = ctrl
        return a, torch.tan(steering)

    def soa_step(self, comps: list[torch.Tensor], aux: tuple[torch.Tensor, ...],
                 dt: torch.Tensor) -> list[torch.Tensor]:
        x, y, th, v = comps
        a, tan_s = aux
        return [x + v * torch.cos(th) * dt,
                y + v * torch.sin(th) * dt,
                th + div(v, self.agent_length) * tan_s * dt,
                v + a * dt]

    # Fast-math hooks: dtheta_k = (v_k/L)*tan(s)*dt with v_k = v0 + a*dt*k is
    # affine in k, so cos/sin of theta and of dtheta each update by one 2-D
    # rotation per step (cudasbmp_tpu/systems/bicycle.py:75-98). Both
    # divisions by L go through div: CUDA would otherwise multiply by 1/L.
    def soa_prepare_fast(self, comps, ctrl, dt):
        a, steering = ctrl
        tan_s = torch.tan(steering)
        _, _, th, v = comps
        d0 = div(v, self.agent_length) * tan_s * dt  # dtheta at step 0
        c2 = div(a * dt, self.agent_length) * tan_s * dt  # per-step increment
        carry = (torch.cos(th), torch.sin(th), torch.cos(d0), torch.sin(d0), d0)
        aux = (a, torch.cos(c2), torch.sin(c2), c2)
        return carry, aux

    def soa_step_fast(self, comps, carry, aux, dt):
        x, y, th, v = comps
        ct, st, dct, dst, dth = carry
        a, cc2, sc2, c2 = aux
        new = [x + v * ct * dt,
               y + v * st * dt,
               th + dth,
               v + a * dt]
        nct = ct * dct - st * dst
        nst = st * dct + ct * dst
        ndct = dct * cc2 - dst * sc2
        ndst = dst * cc2 + dct * sc2
        return new, (nct, nst, ndct, ndst, dth + c2)
