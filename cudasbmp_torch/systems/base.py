"""Dynamical-system interface: a control-sampling spec plus an explicit
Euler step over tensors (counterpart of cudasbmp_tpu/systems/base.py).

State convention: ``state[..., :2]`` is the workspace position (x, y); the
rest is system-specific. Controls carry the edge duration LAST.
"""

from __future__ import annotations

import dataclasses
import functools
import re
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


class DeviceStructMixin(Protocol):
    """A system's own device struct, which admits it to the hand-written
    kernels (csrc/rollout.cu: B1-B6; csrc/refine.cu: R1); the port's
    counterpart of ``SoAStepMixin``, whose Python hooks the JAX package
    traces into its Pallas kernels. A CUDA kernel cannot trace Python, so
    the system hands in C++ source instead:

    - ``cuda_struct``: the text of ``struct UserSystem``, with the built-in
      structs' interface: ``static constexpr bool kHeading, kFast`` (z is the
      heading the footprint test reads; the fast-math hooks exist), a type
      ``Aux``, ``Aux prepare(float c0, float c1) const`` (once a rollout)
      and ``float4 step(float4 s, Aux q, float dt) const`` (one Euler step
      of the state (x, y, z, w)); with ``kFast`` also ``Carry``,
      ``FastAux``, ``prepare_fast(s, c0, c1, dt, Carry&, FastAux&)`` and
      ``float4 step_fast(s, Carry&, FastAux, dt)``, the carry's first two
      fields the new pose's cos and sin; for R1 optionally ``float4
      back(float4 s, Aux q, float dt, float4 lam, Grad& g) const``, the
      step's adjoint: it adds the step's contributions to g = (d/dc0,
      d/dc1, d/ddt) and returns the adjoint of s. Every function is
      ``__device__``; the struct may hold one float, set from
      ``cuda_param``;
    - ``cuda_param`` (optional float): passed as the bicycle's wheelbase
      is, ``UserSystem{cuda_param}``.

    The struct rounds as its torch SoA hooks do, operator by operator, with
    the kernels' helpers ``add``, ``sub``, ``mul``, ``dvd`` (round-to-
    nearest, never contracted into an FMA), ``cos_sin`` (one sincosf),
    ``advance(x, v, c, dt)`` = x + (v*c)*dt and ``rotate(c, s, dc, ds)``;
    those hooks are its plain twin, on the CPU and in the tests, so a system
    with a struct has them too. The layout is the JAX planner's bound on
    every system: a float4 state (``state_dim`` 4) and two controls plus
    the duration (``control_spec.dim`` 3). ``device_struct`` checks all of
    this that Python can see."""

    cuda_struct: str


_FLAGS = ("kHeading", "kFast")
_COMMENTS = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)


@functools.lru_cache(maxsize=None)
def struct_flags(text: str) -> dict[str, bool]:
    """``kHeading`` and ``kFast`` as ``struct UserSystem`` states them
    (``= true`` or ``= false``, outside comments)."""
    code = _COMMENTS.sub("", text)
    if not re.search(r"\bstruct\s+UserSystem\b", code):
        raise ValueError("cuda_struct: expected the text of struct UserSystem")
    flags = {}
    for name in _FLAGS:
        found = re.findall(rf"\b{name}\s*=\s*(true|false)\b", code)
        if len(found) != 1:
            raise ValueError(f"cuda_struct: state {name} once, as 'static constexpr "
                             f"bool {name} = true|false', found {len(found)}")
        flags[name] = found[0] == "true"
    return flags


def device_struct(system) -> str | None:
    """The C++ text of ``system``'s own device struct (``cuda_struct``,
    ``DeviceStructMixin``), checked against its Python side; None for a
    system without one. Raises ValueError where the two disagree."""
    text = getattr(system, "cuda_struct", None)
    if text is None:
        return None
    name = getattr(system, "name", type(system).__name__)
    if not isinstance(text, str):
        raise ValueError(f"system {name!r}: cuda_struct must be a str")
    flags = struct_flags(text)
    if not (hasattr(system, "soa_prepare") and hasattr(system, "soa_step")):
        raise ValueError(f"system {name!r}: a device struct needs the torch SoA hooks "
                         "(soa_prepare, soa_step), its plain twin")
    if system.state_dim != 4 or system.control_spec.dim != 3:
        raise ValueError(f"system {name!r}: a device struct takes a float4 state and "
                         "two controls plus the duration; got state_dim "
                         f"{system.state_dim}, control_spec.dim {system.control_spec.dim}")
    heading = getattr(system, "heading_index", None)
    if heading not in (None, 2) or flags["kHeading"] != (heading is not None):
        raise ValueError(f"system {name!r}: kHeading = {flags['kHeading']} but "
                         f"heading_index = {heading} (the footprint test reads z, "
                         "index 2, as the heading)")
    fast = hasattr(system, "soa_prepare_fast") and hasattr(system, "soa_step_fast")
    if flags["kFast"] != fast or (fast and not flags["kHeading"]):
        raise ValueError(f"system {name!r}: kFast = {flags['kFast']} but the fast "
                         f"hooks are {'there' if fast else 'missing'} (fast math "
                         "needs a heading)")
    return text
