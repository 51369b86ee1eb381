"""Dynamical-system interface: a control-sampling spec plus an explicit
Euler step over tensors (counterpart of cudasbmp_tpu/systems/base.py).

State convention: ``state[..., :2]`` is the workspace position (x, y); the
rest is system-specific. Controls carry the edge duration LAST.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import torch

from cudasbmp_torch import rng


@dataclasses.dataclass(frozen=True)
class ControlSpec:
    """Uniform box control distribution, duration range last."""

    lo: tuple[float, ...]
    hi: tuple[float, ...]

    @property
    def dim(self) -> int:
        return len(self.lo)

    def sample(self, key: torch.Tensor, shape: tuple[int, ...] = ()) -> torch.Tensor:
        """Controls ``lo + u*(hi - lo)`` with u the threefry uniform stream
        of ``key`` (bitwise the JAX draw); [..., dim] on the key's device."""
        lo = torch.tensor(self.lo, dtype=torch.float32, device=key.device)
        hi = torch.tensor(self.hi, dtype=torch.float32, device=key.device)
        u = rng.uniform(key, tuple(shape) + (self.dim,))
        return lo + u * (hi - lo)


@runtime_checkable
class System(Protocol):
    """A controlled dynamical system with an explicit-Euler step."""

    name: str
    state_dim: int
    control_spec: ControlSpec

    def step(self, state: torch.Tensor, control: torch.Tensor,
             dt: torch.Tensor) -> torch.Tensor:
        """One Euler step. state [..., state_dim], control [..., dim-1]
        (duration excluded), dt broadcastable."""
        ...
