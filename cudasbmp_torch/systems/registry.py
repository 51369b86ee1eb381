"""System registry: name -> constructor, so configs select dynamics by name
(counterpart of cudasbmp_tpu/systems/registry.py)."""

from __future__ import annotations

from typing import Callable

from cudasbmp_torch.systems.base import System
from cudasbmp_torch.systems.bicycle import KinematicBicycle
from cudasbmp_torch.systems.double_integrator import DoubleIntegrator2D
from cudasbmp_torch.systems.dubins import DubinsCar
from cudasbmp_torch.systems.point2d import Point2D
from cudasbmp_torch.systems.unicycle import Unicycle

_REGISTRY: dict[str, Callable[..., System]] = {
    "bicycle": KinematicBicycle,
    "car": KinematicBicycle,  # the name of systems/car.yaml
    "point2d": Point2D,
    "double_integrator": DoubleIntegrator2D,
    "unicycle": Unicycle,
    "dubins": DubinsCar,
}


def get_system(name: str, **kwargs) -> System:
    if name not in _REGISTRY:
        raise KeyError(f"unknown system {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def available_systems() -> list[str]:
    return sorted(_REGISTRY)
