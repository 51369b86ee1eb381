"""cudasbmp_torch: the KGMT kinodynamic planner in PyTorch, with hand-written
CUDA rollout kernels for NVIDIA Hopper.

A port of the JAX package ``cudasbmp_tpu`` (the reference it is tested
against), with the same module layout and public names. It imports torch and
numpy, never JAX. Kernels build with nvcc at first use (ops/_build.py).
"""

from cudasbmp_torch.config import KGMTConfig, Scenario
from cudasbmp_torch.planners.kgmt import KGMT, KGMTResult

__version__ = "0.1.0"

__all__ = ["KGMTConfig", "Scenario", "KGMT", "KGMTResult", "__version__"]
