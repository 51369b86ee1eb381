"""System registry: name -> constructor, so configs select dynamics by name
(counterpart of cudasbmp_tpu/systems/registry.py). ``register_system`` adds
a user's system, or replaces a built-in under its name; a config's
``system:`` then reaches it from YAML, the CLI and every planner."""

from __future__ import annotations

from typing import Callable

from cudasbmp_torch.systems.base import System
from cudasbmp_torch.systems.bicycle import KinematicBicycle
from cudasbmp_torch.systems.double_integrator import DoubleIntegrator2D
from cudasbmp_torch.systems.dubins import DubinsCar
from cudasbmp_torch.systems.point2d import Point2D
from cudasbmp_torch.systems.unicycle import Unicycle

_REGISTRY: dict[str, Callable[..., System]] = {}


def register_system(name: str, ctor: Callable[..., System]) -> None:
    _REGISTRY[name] = ctor


def get_system(name: str, **kwargs) -> System:
    if name not in _REGISTRY:
        raise KeyError(f"unknown system {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def available_systems() -> list[str]:
    return sorted(_REGISTRY)


register_system("bicycle", KinematicBicycle)
register_system("car", KinematicBicycle)  # the name of systems/car.yaml
register_system("point2d", Point2D)
register_system("double_integrator", DoubleIntegrator2D)
register_system("unicycle", Unicycle)
register_system("dubins", DubinsCar)
