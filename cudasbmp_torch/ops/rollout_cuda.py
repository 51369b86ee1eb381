"""Wrappers of the CUDA rollout kernels (csrc/rollout.cu), which replace the
TPU kernels of cudasbmp_tpu/ops/rollout_pallas.py, and their plain twins:

- ``rollout_cuda`` (kernel B1, ``rollout_kernel``) replaces
  ``rollout_pallas``: controls supplied by the caller;
- ``sample_and_rollout_cuda`` (kernel B2, ``sample_and_rollout_kernel``)
  replaces ``sample_and_rollout_pallas``: controls drawn inside the kernel,
  here from Philox-4x32-10 keyed by the wave's threefry control key (the
  TPU's hardware stream has no counterpart, so ``cuda_rng`` is a backend of
  its own, as ``pallas_rng`` is in the JAX planner);
- ``rollout_batched_cuda`` and ``sample_and_rollout_batched_cuda`` (kernel
  B6: the same two kernels launched with one obstacle set, and one key, per
  problem) replace ``jax.vmap`` of those two over per-problem obstacle sets
  (parallel/batch_kgmt.py:200-211, 226-230): lanes [B, R], obstacles
  [B, K, 4], and for the Philox form keys [B, 2];
- all take the footprint narrow phase (B3) and fast math (B4) as options,
  for every system of the registry;
- ``rollout_soa`` is their plain PyTorch twin: the JAX kernel body
  ``_integrate`` (rollout_pallas.py:66-140) on per-component tensors,
  through the systems' SoA hooks, over lanes [B] or [B, R] (with obstacles
  [B, K, 4] for one set per problem). Without fast math it rounds exactly
  as ``rollout_batch`` does. ``sample_and_rollout_torch`` draws the same
  Philox controls first.

One rule for every wrapper: tensors on the CPU go through the plain twin;
CUDA tensors launch the kernel or raise. Nothing falls back from the card
to the CPU or from the kernel to the plain version.

Each wrapper counts its launches in ``<wrapper>.launches``, and per
instantiation in ``<wrapper>.instantiations[(system name, footprint,
fast)]`` (fast: the fast-math body ran, i.e. fast math on a system with the
hooks), both incremented only where the kernel is launched.
"""

from __future__ import annotations

import collections
import functools

import torch

from cudasbmp_torch import rng
from cudasbmp_torch._math import div
from cudasbmp_torch.geometry.aabb import segment_aabb, segment_clear
from cudasbmp_torch.geometry.footprint import footprint_clear_cs
from cudasbmp_torch.ops import _build
from cudasbmp_torch.systems.bicycle import KinematicBicycle
from cudasbmp_torch.systems.double_integrator import DoubleIntegrator2D
from cudasbmp_torch.systems.dubins import DubinsCar
from cudasbmp_torch.systems.point2d import Point2D
from cudasbmp_torch.systems.unicycle import Unicycle

# the kernel's SystemId of each system class (csrc/rollout.cu)
SYSTEM_IDS = {KinematicBicycle: 0, Point2D: 1, DoubleIntegrator2D: 2,
              Unicycle: 3, DubinsCar: 4}
FLAG_FOOTPRINT, FLAG_FAST = 1, 2


def supports_system(system) -> bool:
    """A system joins the fused path by providing the SoA step hooks."""
    return hasattr(system, "soa_prepare") and hasattr(system, "soa_step")


def rollout_soa(system, x0: torch.Tensor, controls: torch.Tensor,
                obstacles: torch.Tensor, *, num_disc: int, width: float,
                height: float, footprint: tuple[float, float] | None = None,
                fast_math: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of kernels B1-B4: (x1 [B, 4], valid bool [B]), or over
    lanes [B, R] with obstacles [B, K, 4], each problem's lanes against its
    own set (kernel B6); row b then equals the twin of problem b alone.
    Each step tests the exclusive bounds, the swept AABB and, with
    ``footprint``, the body at the new pose (heading: cos/sin of the new
    theta, the fast carry's rotated cos/sin with ``fast_math``, or an
    axis-aligned body for systems without a heading). Fast math applies
    only to systems with the fast hooks; elsewhere it is the exact path."""
    if not supports_system(system):
        raise NotImplementedError(f"system {system.name!r} has no SoA hooks")
    if obstacles.dim() == 3:  # one set per problem: [B, 1, K, 4] over [B, R]
        obstacles = obstacles[:, None]
    comps = list(x0.unbind(-1))
    ctrl = list(controls[..., :-1].unbind(-1))
    dt = div(controls[..., -1], num_disc)
    use_fast = fast_math and hasattr(system, "soa_step_fast")
    if use_fast:
        carry, aux = system.soa_prepare_fast(comps, ctrl, dt)
    else:
        aux = system.soa_prepare(ctrl)
    heading_index = getattr(system, "heading_index", None)
    alive = torch.ones(x0.shape[:-1], dtype=torch.bool, device=x0.device)
    for _ in range(num_disc):
        if use_fast:
            new, new_carry = system.soa_step_fast(comps, carry, aux, dt)
        else:
            new = system.soa_step(comps, aux, dt)
        nx, ny = new[0], new[1]
        clear = (nx > 0.0) & (nx < width) & (ny > 0.0) & (ny < height)
        bb_min, bb_max = segment_aabb(torch.stack(comps[:2], -1),
                                      torch.stack([nx, ny], -1))
        clear = clear & segment_clear(bb_min, bb_max, obstacles)
        if footprint is not None:
            if use_fast:  # every system with fast hooks has a heading
                ct, st = new_carry[0], new_carry[1]
            elif heading_index is not None:
                ct = torch.cos(new[heading_index])
                st = torch.sin(new[heading_index])
            else:
                ct, st = torch.ones_like(nx), torch.zeros_like(nx)
            clear = clear & footprint_clear_cs(nx, ny, ct, st, footprint[0],
                                               footprint[1], obstacles)
        comps = [torch.where(alive, n, c) for n, c in zip(new, comps)]
        if use_fast:
            carry = new_carry  # dead lanes keep rotating; their state is frozen
        alive = alive & clear
    return torch.stack(comps, -1), alive


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


def _index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


@functools.cache
def max_kernel_obstacles(device_index: int) -> int:
    """The most boxes one block's shared memory holds on this card (16 B
    each): 14,528 at 227 KB on an H100."""
    n = _build.load().cudasbmp_max_obstacles(device_index)
    if n < 0:
        raise RuntimeError(f"cudaDeviceGetAttribute failed: cudaError {-n}")
    return n


def _kernel_args(system, x0: torch.Tensor, obstacles: torch.Tensor,
                 footprint, fast_math: bool, per_problem: bool) -> tuple:
    """Check the inputs; return (device index, system id, flags, P, R, K,
    param, hl, hw), the arguments the C entry points share. Lanes x0 [R, S]
    take one set of obstacles [K, 4] (P = 1); with ``per_problem`` (kernel
    B6) lanes [P, R, S] take one set per problem, [P, K, 4]."""
    sid = SYSTEM_IDS.get(type(system))
    if sid is None:
        raise NotImplementedError(
            f"no CUDA rollout kernel for system {system.name!r}")
    if x0.dim() != 2 + per_problem:
        raise ValueError(f"x0: expected {'[B, R' if per_problem else '[B'}, "
                         f"state_dim] lanes, got {tuple(x0.shape)}")
    lanes = tuple(x0.shape[:-1])
    P, R = (lanes if per_problem else (1, *lanes))
    K = obstacles.shape[-2] if obstacles.dim() >= 2 else 0
    _check("x0", x0, (*lanes, system.state_dim), torch.float32)
    if x0.data_ptr() % 16:
        raise ValueError("x0: rows are read as float4, need 16-byte alignment")
    _check("obstacles", obstacles, (*lanes[:-1], K, 4), torch.float32)
    dev = _index(x0.device)
    limit = max_kernel_obstacles(dev)
    if K > limit:
        raise ValueError(f"{K} obstacles > {limit}, the most one block's "
                         "shared memory holds on this card")
    flags = (FLAG_FOOTPRINT if footprint is not None else 0) | (
        FLAG_FAST if fast_math else 0)
    hl, hw = footprint if footprint is not None else (0.0, 0.0)
    param = system.agent_length if isinstance(system, KinematicBicycle) else 0.0
    return dev, sid, flags, P, R, K, param, hl, hw


def _count(wrapper, system, flags: int) -> None:
    """One launch of ``wrapper``'s kernel, in the instantiation
    (system name, footprint, fast) it ran."""
    wrapper.launches += 1
    wrapper.instantiations[(system.name, bool(flags & FLAG_FOOTPRINT),
                            bool(flags & FLAG_FAST)
                            and hasattr(system, "soa_step_fast"))] += 1


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _rollout(wrapper, system, x0: torch.Tensor, controls: torch.Tensor,
             obstacles: torch.Tensor, per_problem: bool, *, num_disc: int,
             width: float, height: float, footprint, fast_math: bool
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """``rollout_kernel`` on the card for ``wrapper`` (B1, or B6 with
    ``per_problem``), or the plain twin on the CPU."""
    kw = dict(num_disc=num_disc, width=width, height=height,
              footprint=footprint, fast_math=fast_math)
    device = _device_of(x0, controls, obstacles)
    if device.type == "cpu":
        if obstacles.dim() != 2 + per_problem:
            raise ValueError(f"obstacles: expected {'[B, K' if per_problem else '[K'},"
                             f" 4], got {tuple(obstacles.shape)}")
        return rollout_soa(system, x0, controls, obstacles, **kw)
    dev, sid, flags, P, R, K, param, hl, hw = _kernel_args(
        system, x0, obstacles, footprint, fast_math, per_problem)
    _check("controls", controls, (*x0.shape[:-1], system.control_spec.dim),
           torch.float32)
    x1 = torch.empty_like(x0)
    valid = torch.empty(x0.shape[:-1], dtype=torch.bool, device=device)
    if P * R == 0:
        return x1, valid
    rc = _build.load().cudasbmp_rollout(
        dev, sid, flags, x0.data_ptr(), controls.data_ptr(),
        obstacles.data_ptr(), K, int(per_problem), x1.data_ptr(),
        valid.data_ptr(), P, R, num_disc, width, height, param, hl, hw,
        torch.cuda.current_stream(device).cuda_stream)
    _raise_on(rc, "rollout_kernel")
    _count(wrapper, system, flags)
    return x1, valid


def _sample_and_rollout(wrapper, system, keys: torch.Tensor, x0: torch.Tensor,
                        obstacles: torch.Tensor, per_problem: bool, *,
                        num_disc: int, width: float, height: float, footprint,
                        fast_math: bool
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``sample_and_rollout_kernel`` on the card for ``wrapper`` (B2, or B6
    with ``per_problem``), or the plain twin on the CPU."""
    kw = dict(num_disc=num_disc, width=width, height=height,
              footprint=footprint, fast_math=fast_math)
    device = _device_of(keys, x0, obstacles)
    if device.type == "cpu":
        if keys.dim() != 1 + per_problem or obstacles.dim() != 2 + per_problem:
            raise ValueError(f"keys {tuple(keys.shape)}, obstacles "
                             f"{tuple(obstacles.shape)}: expected "
                             f"{'[B, 2], [B, K, 4]' if per_problem else '[2], [K, 4]'}")
        return sample_and_rollout_torch(system, keys, x0, obstacles, **kw)
    dev, sid, flags, P, R, K, param, hl, hw = _kernel_args(
        system, x0, obstacles, footprint, fast_math, per_problem)
    _check("keys", keys, (P, 2) if per_problem else (2,), torch.int64)
    spec = system.control_spec
    x1 = torch.empty_like(x0)
    controls = torch.empty((*x0.shape[:-1], spec.dim), dtype=torch.float32,
                           device=device)
    valid = torch.empty(x0.shape[:-1], dtype=torch.bool, device=device)
    if P * R == 0:
        return x1, controls, valid
    rc = _build.load().cudasbmp_sample_and_rollout(
        dev, sid, flags, keys.data_ptr(), x0.data_ptr(), obstacles.data_ptr(),
        K, int(per_problem), x1.data_ptr(), controls.data_ptr(),
        valid.data_ptr(), P, R, num_disc, width, height, param, hl, hw,
        *spec.lo, *spec.hi, torch.cuda.current_stream(device).cuda_stream)
    _raise_on(rc, "sample_and_rollout_kernel")
    _count(wrapper, system, flags)
    return x1, controls, valid


def rollout_cuda(system, x0: torch.Tensor, controls: torch.Tensor,
                 obstacles: torch.Tensor, *, num_disc: int, width: float,
                 height: float, footprint: tuple[float, float] | None = None,
                 fast_math: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B1 (with B3/B4 as options): (x1 [B, 4], valid bool [B]) for
    x0 [B, 4], controls [B, 3] (duration last), obstacles [K, 4]; the
    contract of ``rollout_soa``."""
    return _rollout(rollout_cuda, system, x0, controls, obstacles, False,
                    num_disc=num_disc, width=width, height=height,
                    footprint=footprint, fast_math=fast_math)


def rollout_batched_cuda(system, x0: torch.Tensor, controls: torch.Tensor,
                         obstacles: torch.Tensor, *, num_disc: int,
                         width: float, height: float,
                         footprint: tuple[float, float] | None = None,
                         fast_math: bool = False
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B6: B problems of R lanes each, problem b against its own
    obstacles[b]. x0 [B, R, 4], controls [B, R, 3] (duration last),
    obstacles [B, K, 4] -> (x1 [B, R, 4], valid bool [B, R]); the contract
    of ``rollout_soa``."""
    return _rollout(rollout_batched_cuda, system, x0, controls, obstacles, True,
                    num_disc=num_disc, width=width, height=height,
                    footprint=footprint, fast_math=fast_math)


def sample_and_rollout_torch(system, key: torch.Tensor, x0: torch.Tensor,
                             obstacles: torch.Tensor, *, num_disc: int,
                             width: float, height: float,
                             footprint: tuple[float, float] | None = None,
                             fast_math: bool = False
                             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of kernel B2, and of B6's Philox form for keys [B, 2] over
    lanes [B, R] and obstacles [B, K, 4]: lane r of each problem draws from
    the counter (r, 0, 0, 0) under its problem's key, then ``rollout_soa``.
    Returns (x1, controls, valid)."""
    spec = system.control_spec
    lo = torch.tensor(spec.lo, dtype=torch.float32, device=x0.device)
    hi = torch.tensor(spec.hi, dtype=torch.float32, device=x0.device)
    u = rng.philox_uniform_lanes(key, x0.shape[-2], spec.dim)
    controls = lo + u * (hi - lo)
    x1, valid = rollout_soa(system, x0, controls, obstacles, num_disc=num_disc,
                            width=width, height=height, footprint=footprint,
                            fast_math=fast_math)
    return x1, controls, valid


def sample_and_rollout_cuda(system, key: torch.Tensor, x0: torch.Tensor,
                            obstacles: torch.Tensor, *, num_disc: int,
                            width: float, height: float,
                            footprint: tuple[float, float] | None = None,
                            fast_math: bool = False
                            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel B2: draw each lane's controls from Philox-4x32-10 under the
    threefry key data ``key`` (int64 [2]) at counter (lane, 0, 0, 0), then
    roll out as B1. Returns (x1 [B, 4], controls [B, 3], valid bool [B])."""
    return _sample_and_rollout(sample_and_rollout_cuda, system, key, x0,
                               obstacles, False, num_disc=num_disc, width=width,
                               height=height, footprint=footprint,
                               fast_math=fast_math)


def sample_and_rollout_batched_cuda(system, keys: torch.Tensor, x0: torch.Tensor,
                                    obstacles: torch.Tensor, *, num_disc: int,
                                    width: float, height: float,
                                    footprint: tuple[float, float] | None = None,
                                    fast_math: bool = False
                                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel B6, Philox form: problem b's lane r draws its controls from
    Philox-4x32-10 under the key words keys[b] (int64 [B, 2]) at counter
    (r, 0, 0, 0), so a problem's controls depend on its key and lane only,
    then rolls out as ``rollout_batched_cuda``. Returns (x1 [B, R, 4],
    controls [B, R, 3], valid bool [B, R])."""
    return _sample_and_rollout(sample_and_rollout_batched_cuda, system, keys, x0,
                               obstacles, True, num_disc=num_disc, width=width,
                               height=height, footprint=footprint,
                               fast_math=fast_math)


WRAPPERS = (rollout_cuda, sample_and_rollout_cuda, rollout_batched_cuda,
            sample_and_rollout_batched_cuda)
for _wrapper in WRAPPERS:
    _wrapper.launches = 0
    _wrapper.instantiations = collections.Counter()


def reset_launch_counts() -> None:
    for wrapper in WRAPPERS:
        wrapper.launches = 0
        wrapper.instantiations.clear()
