"""Wrappers of the CUDA rollout kernels (csrc/rollout.cu), which replace the
TPU kernels of cudasbmp_tpu/ops/rollout_pallas.py:

- ``rollout_cuda`` (kernel B1, ``rollout_kernel``) replaces
  ``rollout_pallas``: controls supplied by the caller;
- ``sample_and_rollout_cuda`` (kernel B2, ``sample_and_rollout_kernel``)
  replaces ``sample_and_rollout_pallas``: controls drawn inside the kernel,
  here from Philox-4x32-10 keyed by the wave's threefry control key (the
  TPU's hardware stream has no counterpart, so ``cuda_rng`` is a backend of
  its own, as ``pallas_rng`` is in the JAX planner).

One rule for both: tensors on the CPU go through the plain PyTorch version
(``rollout_batch``; ``sample_and_rollout_torch``, the same Philox stream);
CUDA tensors launch the kernel or raise. Nothing falls back from the card to
the CPU or from the kernel to the plain version.

Each wrapper counts its launches in ``<wrapper>.launches``, incremented only
where the kernel is launched.
"""

from __future__ import annotations

import torch

from cudasbmp_torch import rng
from cudasbmp_torch.ops import _build
from cudasbmp_torch.ops.rollout import rollout_batch
from cudasbmp_torch.systems.bicycle import KinematicBicycle

MAX_OBSTACLES = 32


def supports_system(system) -> bool:
    """The kernels integrate the kinematic bicycle."""
    return isinstance(system, KinematicBicycle)


def _device_of(*tensors: torch.Tensor) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def _check(name: str, t: torch.Tensor, shape: tuple[int, ...],
           dtype: torch.dtype) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} {shape}, got "
                         f"{t.dtype} {tuple(t.shape)}"
                         f"{'' if t.is_contiguous() else ' non-contiguous'}")


def _check_kernel_inputs(system, x0: torch.Tensor,
                         obstacles: torch.Tensor) -> tuple[int, int]:
    if not supports_system(system):
        raise NotImplementedError(
            f"no CUDA rollout kernel for system {system.name!r}")
    B, K = x0.shape[0], obstacles.shape[0]
    _check("x0", x0, (B, system.state_dim), torch.float32)
    if x0.data_ptr() % 16:
        raise ValueError("x0: rows are read as float4, need 16-byte alignment")
    _check("obstacles", obstacles, (K, 4), torch.float32)
    if K > MAX_OBSTACLES:
        raise ValueError(f"{K} obstacles > {MAX_OBSTACLES} (kernel shared memory)")
    return B, K


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def rollout_cuda(system, x0: torch.Tensor, controls: torch.Tensor,
                 obstacles: torch.Tensor, *, num_disc: int, width: float,
                 height: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B1: (x1 [B, 4], valid bool [B]) for x0 [B, 4], controls [B, 3]
    (duration last), obstacles [K, 4]; the contract of ``rollout_batch``."""
    device = _device_of(x0, controls, obstacles)
    if device.type == "cpu":
        return rollout_batch(system, x0, controls, num_disc, obstacles,
                             width, height)
    B, K = _check_kernel_inputs(system, x0, obstacles)
    _check("controls", controls, (B, system.control_spec.dim), torch.float32)
    x1 = torch.empty_like(x0)
    valid = torch.empty(B, dtype=torch.bool, device=device)
    if B == 0:
        return x1, valid
    lib = _build.load()
    rc = lib.cudasbmp_rollout(
        device.index if device.index is not None else torch.cuda.current_device(),
        x0.data_ptr(), controls.data_ptr(), obstacles.data_ptr(), K,
        x1.data_ptr(), valid.data_ptr(), B, num_disc, width, height,
        system.agent_length, torch.cuda.current_stream(device).cuda_stream)
    _raise_on(rc, "rollout_kernel")
    rollout_cuda.launches += 1
    return x1, valid


rollout_cuda.launches = 0


def sample_and_rollout_torch(system, key: torch.Tensor, x0: torch.Tensor,
                             obstacles: torch.Tensor, *, num_disc: int,
                             width: float, height: float
                             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of kernel B2: the same Philox controls, then
    ``rollout_batch``. Returns (x1, controls, valid)."""
    spec = system.control_spec
    lo = torch.tensor(spec.lo, dtype=torch.float32, device=x0.device)
    hi = torch.tensor(spec.hi, dtype=torch.float32, device=x0.device)
    u = rng.philox_uniform_lanes(key, x0.shape[0], spec.dim)
    controls = lo + u * (hi - lo)
    x1, valid = rollout_batch(system, x0, controls, num_disc, obstacles,
                              width, height)
    return x1, controls, valid


def sample_and_rollout_cuda(system, key: torch.Tensor, x0: torch.Tensor,
                            obstacles: torch.Tensor, *, num_disc: int,
                            width: float, height: float
                            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel B2: draw each lane's controls from Philox-4x32-10 under the
    threefry key data ``key`` (int64 [2]) at counter (lane, 0, 0, 0), then
    roll out as B1. Returns (x1 [B, 4], controls [B, 3], valid bool [B])."""
    device = _device_of(key, x0, obstacles)
    if device.type == "cpu":
        return sample_and_rollout_torch(system, key, x0, obstacles,
                                        num_disc=num_disc, width=width,
                                        height=height)
    B, K = _check_kernel_inputs(system, x0, obstacles)
    _check("key", key, (2,), torch.int64)
    spec = system.control_spec
    x1 = torch.empty_like(x0)
    controls = torch.empty((B, spec.dim), dtype=torch.float32, device=device)
    valid = torch.empty(B, dtype=torch.bool, device=device)
    if B == 0:
        return x1, controls, valid
    lib = _build.load()
    rc = lib.cudasbmp_sample_and_rollout(
        device.index if device.index is not None else torch.cuda.current_device(),
        key.data_ptr(), x0.data_ptr(), obstacles.data_ptr(), K,
        x1.data_ptr(), controls.data_ptr(), valid.data_ptr(), B, num_disc,
        width, height, system.agent_length, *spec.lo, *spec.hi,
        torch.cuda.current_stream(device).cuda_stream)
    _raise_on(rc, "sample_and_rollout_kernel")
    sample_and_rollout_cuda.launches += 1
    return x1, controls, valid


sample_and_rollout_cuda.launches = 0


def reset_launch_counts() -> None:
    rollout_cuda.launches = 0
    sample_and_rollout_cuda.launches = 0
