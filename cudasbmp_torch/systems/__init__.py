from cudasbmp_torch.systems.base import (ControlSpec, DeviceStructMixin, SoAStepMixin,
                                         System, device_struct)
from cudasbmp_torch.systems.bicycle import KinematicBicycle
from cudasbmp_torch.systems.double_integrator import DoubleIntegrator2D
from cudasbmp_torch.systems.dubins import DubinsCar
from cudasbmp_torch.systems.point2d import Point2D
from cudasbmp_torch.systems.registry import (available_systems, get_system,
                                             register_system)
from cudasbmp_torch.systems.unicycle import Unicycle

__all__ = ["ControlSpec", "DeviceStructMixin", "SoAStepMixin", "System",
           "KinematicBicycle", "DoubleIntegrator2D", "DubinsCar", "Point2D", "Unicycle",
           "available_systems", "device_struct", "get_system", "register_system"]
