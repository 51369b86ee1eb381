"""Dynamical-system interface: a control-sampling spec plus an explicit
Euler step over tensors (counterpart of cudasbmp_tpu/systems/base.py).

State convention: ``state[..., :2]`` is the workspace position (x, y); the
rest is system-specific. Controls carry the edge duration LAST.
"""

from __future__ import annotations

import dataclasses
import functools
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

    def bounds(self, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
        """(lo, hi) as f32 tensors on ``device``, made once per device: a
        copy from the host each draw would wait for the card."""
        return _bounds(self.lo, self.hi, torch.device(device))

    def sample(self, key: torch.Tensor, shape: tuple[int, ...] = (),
               offset: int = 0) -> torch.Tensor:
        """Controls ``lo + u*(hi - lo)`` with u the threefry uniform stream
        of ``key`` (bitwise the JAX draw); [..., dim] on the key's device, a
        batch of keys [..., 2] giving [..., *shape, dim]. ``offset`` (a
        multiple of ``dim``) gives the controls from that element on of a
        larger draw."""
        lo, hi = self.bounds(key.device)
        u = rng.uniform(key, tuple(shape) + (self.dim,), offset=offset)
        return lo + u * (hi - lo)


@functools.lru_cache(maxsize=None)
def _bounds(lo: tuple[float, ...], hi: tuple[float, ...],
            device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.tensor(lo, dtype=torch.float32, device=device),
            torch.tensor(hi, dtype=torch.float32, device=device))


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


class SoAStepMixin(Protocol):
    """Per-component step hooks: the layout of the fused rollout kernel
    (csrc/rollout.cu) and of its plain twin (ops/rollout_cuda.py::
    rollout_soa); counterpart of cudasbmp_tpu/systems/base.py:68-103.

    ``soa_prepare`` runs once per rollout (loop-invariant work such as the
    bicycle's tan(steering)), ``soa_step`` once per Euler step on lists of
    [B] tensors. Components [0], [1] are workspace x, y. ``soa_step`` rounds
    exactly as ``step`` does, operator by operator.

    Optional fast-math hooks (``KGMTConfig.fast_math``): where the heading
    increment per step is affine in the step index, cos/sin of the heading
    update by chained 2-D rotations instead of per-step trig. When the
    system has a heading, carry[0] and carry[1] are cos and sin of the
    CURRENT state's heading, so the footprint test reuses them:

        soa_prepare_fast(comps, ctrl, dt) -> (carry, aux)
        soa_step_fast(comps, carry, aux, dt) -> (new_comps, new_carry)
    """

    def soa_prepare(self, ctrl: list[torch.Tensor]) -> tuple[torch.Tensor, ...]:
        ...

    def soa_step(self, comps: list[torch.Tensor], aux: tuple[torch.Tensor, ...],
                 dt: torch.Tensor) -> list[torch.Tensor]:
        ...
