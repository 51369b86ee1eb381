from cudasbmp_torch.systems.base import ControlSpec, System
from cudasbmp_torch.systems.bicycle import KinematicBicycle
from cudasbmp_torch.systems.registry import get_system

__all__ = ["ControlSpec", "System", "KinematicBicycle", "get_system"]
