"""System registry: name -> constructor. Only the kinematic bicycle (and its
``car`` alias) is ported; the JAX package's other systems raise."""

from __future__ import annotations

from typing import Callable

from cudasbmp_torch.systems.base import System
from cudasbmp_torch.systems.bicycle import KinematicBicycle

_REGISTRY: dict[str, Callable[..., System]] = {
    "bicycle": KinematicBicycle,
    "car": KinematicBicycle,
}
_NOT_PORTED = ("point2d", "double_integrator", "unicycle", "dubins")


def get_system(name: str, **kwargs) -> System:
    if name in _NOT_PORTED:
        raise KeyError(f"system {name!r} is not yet ported to cudasbmp_torch")
    if name not in _REGISTRY:
        raise KeyError(f"unknown system {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)

