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
  (parallel/batch_kgmt.py:200-211, 226-230, and under ``vmap`` of the whole
  solve, parallel/multi_query.py:80-86): lanes [B, R], obstacles
  [B, K, 4], and for the Philox form keys [B, 2];
- all take the footprint narrow phase (B3) and fast math (B4) as options,
  for every system of the registry, and ``cull=W``, the culled broad phase
  (kernel B5, ``_integrate_culled``, rollout_pallas.py:143-328): the same
  (x1, valid) to the bit, with each warp of 32 lanes testing each window's
  steps only against the boxes near its union box of the window
  (``cull_plan``: windows of at most CULL_STEPS steps). It pays where
  neighbouring lanes are near each other (grouped lanes) on dense fields;
- ``rollout_bicycle_cuda`` and ``sample_and_rollout_bicycle_cuda`` are the
  bicycle entry points of the JAX module (rollout_pallas.py:445-458,
  608-632);
- a user's system runs on the same kernels through its own device struct
  (``cuda_struct``, systems/base.py::DeviceStructMixin), compiled into a
  library of its own at its first launch (ops/_build.py), under the
  system id ``USER_SYSTEM_ID``; ``rollout_route`` is the one rule every
  caller asks: a system takes the kernels exactly when it has a device
  struct, one of the five built-in or its own, and otherwise runs the
  generic ``step`` (``ops/rollout.py::rollout_batch``), as the JAX
  planner runs a system its Pallas kernel cannot take;
- ``rollout_soa`` is their plain PyTorch twin: the JAX kernel body
  ``_integrate`` (rollout_pallas.py:66-140) on per-component tensors,
  through the systems' SoA hooks, over lanes [B] or [B, R] (with obstacles
  [B, K, 4] for one set per problem). Without fast math it rounds exactly
  as ``rollout_batch`` does. ``sample_and_rollout_torch`` draws the same
  Philox controls first. ``rollout_culled_soa`` is B5's twin: the JAX body
  ``_integrate_culled`` operator by operator over groups of lanes.

One rule for every wrapper: tensors on the CPU go through the plain twin;
CUDA tensors launch the kernel or raise. Nothing falls back from the card
to the CPU or from the kernel to the plain version. A system without a
device struct has no kernel, so every wrapper refuses it on either device.

On the card each rollout runs on a group of G threads (``split``, 1, 2, 4
or 8): every sub-lane integrates the same chain and tests every G-th box,
and the group ANDs the verdicts, so the result is the same for every G.
``lanes_per_rollout`` picks G from the launch's total lanes and the card's
SM count (G > 1 only where one thread a rollout would leave SMs idle);
``split=`` forces it, for tests and measurements. The culled body (B5)
always runs with G = 1.

Each wrapper counts its launches in ``<wrapper>.launches``, per
instantiation in ``<wrapper>.instantiations[(system name, footprint,
fast)]`` (fast: the fast-math body ran, i.e. fast math on a system with the
hooks), per G in ``<wrapper>.splits[G]``, and the culled ones (B5) also in
``<wrapper>.culled``, all incremented only where the kernel is launched. A
user struct's launches count in ``launches``, ``splits`` and ``culled`` and,
in the place of ``instantiations`` (the package's own library), in
``<wrapper>.user_systems[(system name, footprint, fast)]``.
"""

from __future__ import annotations

import collections
import dataclasses
import functools

import torch

from cudasbmp_torch import rng
from cudasbmp_torch._math import div
from cudasbmp_torch.geometry.aabb import segment_aabb, segment_clear
from cudasbmp_torch.geometry.footprint import footprint_clear_cs
from cudasbmp_torch.ops import _build
from cudasbmp_torch.systems.base import ControlSpec, device_struct
from cudasbmp_torch.systems.bicycle import KinematicBicycle
from cudasbmp_torch.systems.double_integrator import DoubleIntegrator2D
from cudasbmp_torch.systems.dubins import DubinsCar
from cudasbmp_torch.systems.point2d import Point2D
from cudasbmp_torch.systems.unicycle import Unicycle

# the kernel's SystemId of each system class (csrc/rollout.cu)
SYSTEM_IDS = {KinematicBicycle: 0, Point2D: 1, DoubleIntegrator2D: 2,
              Unicycle: 3, DubinsCar: 4}
USER_SYSTEM_ID = 5  # kUser: a user library's one system
FLAG_FOOTPRINT, FLAG_FAST = 1, 2
WARP = 32  # the lanes B5 culls for together
THREADS = 128  # a block's threads (kThreads)
WALK = 4  # the one-thread walk pads K to a multiple of it (kWalk)
CULL_STEPS = 10  # B5: the most steps of a window, in shared memory (kCullSteps)
MAX_PLAN = 256  # B5: the most windows of a launch's plan (kMaxPlan)
SPLITS = (1, 2, 4, 8)  # the threads a rollout may run on (kMaxSplit)
# lanes_per_rollout's G for a narrow launch, and the threads an SM it may
# fill with it: 8 warps, two for each of an SM's schedulers, in blocks of
# 128 threads (PERF.md, the per-G table)
NARROW_SPLIT = 4
SPLIT_THREADS_PER_SM = 8 * WARP


def lanes_per_rollout(lanes: int, sm_count: int) -> int:
    """G, the threads each rollout of a launch of ``lanes`` rollouts (all
    problems together) runs on: NARROW_SPLIT where lanes * NARROW_SPLIT <=
    SPLIT_THREADS_PER_SM * sm_count, else 1. A narrow launch, whose one
    thread a rollout would leave most SMs idle and wait on one rollout's
    chain, takes G = 4 (at 8 boxes two a sub-lane, in registers); a launch
    that fills the card takes G = 1, where more threads a rollout would only
    repeat the chain. On an H100 (132 SMs) G = 4 up to 8,448 lanes: the
    demo's 4,096 and the extension rounds' buckets of 8 to 64 problems x
    128 lanes; G = 1 from 16,384 lanes: buckets of 128 and 256 problems,
    the arena's 32,768, the sweeps' 1,024 x 128 and the probe's 2^17. G = 2
    (its four boxes in shared memory) lost to G = 4 at every width and G =
    8 won by at most 2.1%, at 2,048 lanes or fewer; in blocks of 128
    threads G = 1 overtook G = 4 between 8,192 and 16,384 lanes."""
    fits = lanes * NARROW_SPLIT <= SPLIT_THREADS_PER_SM * sm_count
    return NARROW_SPLIT if fits else 1


def cull_windows(cull: bool | int | None, num_disc: int) -> int:
    """The step windows of ``cull`` (rollout_pallas.py:390, 408): None,
    False or 0 is off (0); True or 1 one whole-trajectory box; W >= 2 that
    many windows, at most one a step."""
    return max(1, min(int(cull), num_disc)) if cull else 0


def window_bounds(windows: int, num_disc: int) -> list[int]:
    """The first step of each window and the end: Python's round (halves to
    even) of w * num_disc / W, as _integrate_culled splits the steps; the
    kernel computes the same integers."""
    return [round(w * num_disc / windows) for w in range(windows + 1)]


def cull_plan(windows: int, num_disc: int, cap: int = CULL_STEPS) -> list[int]:
    """B5's windows as the kernel runs them: ``window_bounds``, each window
    longer than ``cap`` steps cut into ceil(len / cap) sub-windows of near
    equal length (the kernel keeps at most ``cap`` steps a window in shared
    memory). The first step of each and the end. Cutting a window changes
    which boxes are skipped, never the result."""
    bounds = window_bounds(windows, num_disc)
    plan = [0]
    for lo, hi in zip(bounds, bounds[1:]):
        pieces = -(-(hi - lo) // cap)
        plan += [lo + k * (hi - lo) // pieces for k in range(1, pieces + 1)]
    return plan


def footprint_pad(footprint: tuple[float, float] | None) -> float:
    """How far the body reaches from its reference point in any direction,
    hl + hypot(hl, hw), in double as the JAX body computes it; 0 without a
    footprint."""
    if footprint is None:
        return 0.0
    hl, hw = footprint
    return hl + float((hl * hl + hw * hw) ** 0.5)


def supports_system(system) -> bool:
    """A system joins the fused path by providing the SoA step hooks."""
    return hasattr(system, "soa_prepare") and hasattr(system, "soa_step")


def has_kernel(system) -> bool:
    """Whether ``system`` runs on the hand-written kernels: it has a device
    struct, its own (``cuda_struct``, checked by ``device_struct``; it wins
    over a built-in class or name) or a built-in one (SYSTEM_IDS, by exact
    class)."""
    return device_struct(system) is not None or type(system) in SYSTEM_IDS


def rollout_route(system, backend: str = "auto") -> str:
    """Which rollout a wave of ``system`` takes: ``"kernel"`` (the kernel
    wrappers: B1/B2/B6 on the card, their twins on the CPU) where the
    system has a device struct (``has_kernel``), else ``"generic"``, the
    system's own ``step`` through ``ops/rollout.py::rollout_batch``, as the
    JAX planner sends a system its kernel cannot take to ``rollout_batch``
    (cudasbmp_tpu/planners/kgmt.py:186-212). Under ``cuda`` or ``cuda_rng``,
    which ask for the kernel, a system without a struct raises, where JAX's
    ``pallas_rng`` would take the generic path silently. The planners run
    every system through ``rollout_batch`` under ``torch`` themselves."""
    if has_kernel(system):
        return "kernel"
    if backend in ("cuda", "cuda_rng"):
        raise NotImplementedError(_no_kernel(system, f"rollout_backend {backend!r}"))
    return "generic"


def _no_kernel(system, what: str, hint: bool = True) -> str:
    return (f"system {system.name!r} has no device struct (cuda_struct), so no "
            f"CUDA kernel for {what}" + (": rollout_backend 'auto' runs its "
                                          "generic step, 'torch' the plain rollout"
                                          if hint else ""))


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


def _group_reduce(v: torch.Tensor, group: int, op: str) -> torch.Tensor:
    """The min or max of ``v`` over consecutive groups of ``group`` lanes
    along the last axis (the last group may be short), broadcast back to
    every lane of the group."""
    n = v.shape[-1]
    fill = float("inf") if op == "min" else float("-inf")
    g = torch.nn.functional.pad(v, (0, -n % group), value=fill)
    g = g.unflatten(-1, (-1, group))
    g = g.amin(-1) if op == "min" else g.amax(-1)
    return g.repeat_interleave(group, -1)[..., :n]


def rollout_culled_soa(system, x0: torch.Tensor, controls: torch.Tensor,
                       obstacles: torch.Tensor, *, cull: bool | int, group: int,
                       num_disc: int, width: float, height: float,
                       footprint: tuple[float, float] | None = None,
                       fast_math: bool = False, plan: list[int] | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of kernel B5: ``_integrate_culled`` (rollout_pallas.py:
    143-328) operator by operator, with each consecutive ``group`` of lanes
    along the last axis in the place of a TPU program (the kernel's warp:
    ``WARP``). Pass 1 runs the unconditional chain and folds the workspace
    bounds into the first failing step; each group takes its union boxes
    (the whole trajectory and ``cull_windows(cull)`` windows, padded by
    ``footprint_pad``); pass 2 tests box k at the steps of a window only
    where the group's boxes overlap it (masks in the place of ``lax.cond``);
    then the first-failure freeze is rebuilt. Lanes [B] or [B, R] as
    ``rollout_soa``, with obstacles [K, 4] or [B, K, 4]; the result is
    ``rollout_soa``'s to the bit, whatever ``group``. ``plan`` (the first
    step of each window and the end, as ``cull_plan`` gives the kernel's)
    replaces the windows of ``cull``, with the same result."""
    if not supports_system(system):
        raise NotImplementedError(f"system {system.name!r} has no SoA hooks")
    W = cull_windows(cull, num_disc)
    if W == 0:
        raise ValueError("rollout_culled_soa needs cull >= 1")
    boxes = obstacles.unbind(-2)  # K x [4] or K x [B, 4]
    if obstacles.dim() == 3:  # one set per problem: box k is [B, 1] per side
        boxes = [b[:, None] for b in boxes]
    comps = list(x0.unbind(-1))
    ctrl = list(controls[..., :-1].unbind(-1))
    dt = div(controls[..., -1], num_disc)
    use_fast = fast_math and hasattr(system, "soa_step_fast")
    if use_fast:
        carry, aux = system.soa_prepare_fast(comps, ctrl, dt)
    else:
        aux = system.soa_prepare(ctrl)
    heading_index = getattr(system, "heading_index", None)
    # pass 1: the unconditional chain
    positions, bboxes, poses = [], [], []
    cur = comps
    for i in range(num_disc):
        if use_fast:
            new, carry = system.soa_step_fast(cur, carry, aux, dt)
        else:
            new = system.soa_step(cur, aux, dt)
        nx, ny, x, y = new[0], new[1], cur[0], cur[1]
        bboxes.append((torch.minimum(x, nx), torch.maximum(x, nx),
                       torch.minimum(y, ny), torch.maximum(y, ny)))
        if footprint is not None:
            if use_fast and heading_index is not None:
                poses.append((carry[0], carry[1]))
            elif heading_index is not None:
                poses.append((torch.cos(new[heading_index]),
                              torch.sin(new[heading_index])))
            else:
                poses.append((torch.ones_like(nx), torch.zeros_like(nx)))
        positions.append(new)
        oob = ~((nx > 0.0) & (nx < width) & (ny > 0.0) & (ny < height))
        fi = torch.where(oob, i, num_disc).to(torch.int32)
        fail = fi if i == 0 else torch.minimum(fail, fi)
        cur = new

    # the groups' union boxes: whole trajectory and per window
    def chain(op, vals):
        acc = vals[0]
        for v in vals[1:]:
            acc = op(acc, v)
        return acc

    pad = footprint_pad(footprint)

    def union_box(step_boxes):
        return (_group_reduce(chain(torch.minimum, [b[0] for b in step_boxes]),
                              group, "min") - pad,
                _group_reduce(chain(torch.maximum, [b[1] for b in step_boxes]),
                              group, "max") + pad,
                _group_reduce(chain(torch.minimum, [b[2] for b in step_boxes]),
                              group, "min") - pad,
                _group_reduce(chain(torch.maximum, [b[3] for b in step_boxes]),
                              group, "max") + pad)

    bounds = plan if plan is not None else window_bounds(W, num_disc)
    if bounds[0] != 0 or bounds[-1] != num_disc or sorted(bounds) != bounds:
        raise ValueError(f"plan {bounds}: expected 0 = b0 <= ... <= {num_disc}")
    windows = [range(lo, hi) for lo, hi in zip(bounds, bounds[1:]) if lo < hi]
    win_boxes = [union_box([bboxes[i] for i in win]) for win in windows]
    whole = tuple(chain(torch.minimum if j % 2 == 0 else torch.maximum,
                        [b[j] for b in win_boxes]) for j in range(4))

    def step_hit(i, oxmin, oymin, oxmax, oymax):
        bmnx, bmxx, bmny, bmxy = bboxes[i]
        hit = ~((bmxx <= oxmin) | (oxmax <= bmnx)
                | (bmxy <= oymin) | (oymax <= bmny))
        if footprint is not None:
            hl, hw = footprint
            ct, st = poses[i]
            nx, ny = positions[i][0], positions[i][1]
            bcx = (oxmin + oxmax) * 0.5
            bcy = (oymin + oymax) * 0.5
            bhx = (oxmax - oxmin) * 0.5
            bhy = (oymax - oymin) * 0.5
            valid_box = (bhx >= 0) & (bhy >= 0)
            fcx = nx + hl * ct
            fcy = ny + hl * st
            act, ast = torch.abs(ct), torch.abs(st)
            dx = fcx - bcx
            dy = fcy - bcy
            sep_x = torch.abs(dx) >= bhx + hl * act + hw * ast
            sep_y = torch.abs(dy) >= bhy + hl * ast + hw * act
            sep_u = torch.abs(dx * ct + dy * st) >= hl + bhx * act + bhy * ast
            sep_v = torch.abs(dy * ct - dx * st) >= hw + bhx * ast + bhy * act
            hit = hit | (valid_box & ~(sep_x | sep_y | sep_u | sep_v))
        return hit

    def overlaps(box, oxmin, oymin, oxmax, oymax):
        mnx, mxx, mny, mxy = box
        return ~((mxx <= oxmin) | (oxmax <= mnx) | (mxy <= oymin) | (oymax <= mny))

    # pass 2: each box's exact tests where the group's boxes overlap it
    for box in boxes:
        o = box.unbind(-1)
        f = fail
        for win, wbox in zip(windows, win_boxes):
            tested = f
            for i in win:
                tested = torch.minimum(
                    tested, torch.where(step_hit(i, *o), i, num_disc).to(torch.int32))
            f = torch.where(overlaps(wbox, *o), tested, f)
        fail = torch.where(overlaps(whole, *o), f, fail)

    # the first-failure freeze: the candidate of step min(fail, num_disc - 1)
    alive = fail >= num_disc
    take = torch.clamp(fail, max=num_disc - 1)
    out = positions[0]
    for i in range(1, num_disc):
        sel = take >= i
        out = [torch.where(sel, n, o) for n, o in zip(positions[i], out)]
    return torch.stack(out, -1), alive


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


def cull_state_bytes(footprint: bool) -> int:
    """B5's window store in a block's shared memory (cull_state_bytes in
    csrc/rollout.cu): CULL_STEPS candidate states (float4) a thread and,
    with a footprint, as many poses (float2)."""
    return THREADS * CULL_STEPS * (16 + (8 if footprint else 0))


@functools.cache
def smem_optin(device_index: int, struct: str | None = None) -> int:
    """The shared memory one block may opt in to on this card, in bytes
    (232,448 on an H100), read through the package's library or, with
    ``struct``, that user struct's (a user system's launch needs no build
    of the package's library)."""
    n = _build.load(struct).cudasbmp_smem_optin(device_index)
    if n < 0:
        raise RuntimeError(f"cudaDeviceGetAttribute failed: cudaError {-n}")
    return n


def max_kernel_obstacles(device_index: int, culled: bool = False,
                         footprint: bool = False, struct: str | None = None) -> int:
    """The most boxes (16 B each, the set padded to a multiple of WALK) one
    block's shared memory holds on this card: 14,528 at 227 KB on an H100;
    the culled body (B5) keeps its window store beside them,
    ``cull_state_bytes(footprint)``, so 13,248 (12,608 with a footprint).
    ``struct``: a user struct's launch (``smem_optin``)."""
    optin = smem_optin(device_index) if struct is None else smem_optin(device_index, struct)
    room = optin - (cull_state_bytes(footprint) if culled else 0)
    return max(room, 0) // 16 & ~(WALK - 1)


@functools.cache
def sm_count(device_index: int) -> int:
    """The card's streaming multiprocessors (132 on an H100 SXM)."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _check_split(split: int | None, cull) -> None:
    if split is not None and (type(split) is not int or split not in SPLITS):
        raise ValueError(f"split={split!r}: expected None or one of {SPLITS}")
    if split not in (None, 1) and cull:
        raise ValueError(f"split={split}: the culled body (cull={cull!r}) runs "
                         "one thread a rollout")


def _split(split: int | None, lanes: int, windows: int, dev: int) -> int:
    """G for a launch on the card: ``split`` where given, else the rule;
    1 for the culled body."""
    if windows:
        return 1
    return split if split is not None else lanes_per_rollout(lanes, sm_count(dev))


def kernel_system(system, what: str) -> tuple[int, float, str | None]:
    """(system id, param, struct) of ``system``'s kernels: USER_SYSTEM_ID,
    its ``cuda_param`` and its struct's text, whose library
    (``_build.load(struct)``) it launches, or the class's SYSTEM_IDS entry,
    the bicycle's wheelbase (else 0) and None, the package's library.
    Raises for a system without a device struct."""
    struct = device_struct(system)
    if struct is not None:
        return USER_SYSTEM_ID, float(getattr(system, "cuda_param", 0.0)), struct
    sid = SYSTEM_IDS.get(type(system))
    if sid is None:
        raise NotImplementedError(_no_kernel(system, what, hint=what == "its rollout"))
    param = system.agent_length if isinstance(system, KinematicBicycle) else 0.0
    return sid, param, None


def _kernel_args(system, x0: torch.Tensor, obstacles: torch.Tensor,
                 footprint, fast_math: bool, per_problem: bool, windows: int = 0
                 ) -> tuple:
    """Check the inputs; return (device index, system id, flags, P, R, K,
    param, hl, hw, struct), the arguments the C entry points share and the
    user struct whose library launches (None: the package's). Lanes x0
    [R, S] take one set of obstacles [K, 4] (P = 1); with ``per_problem``
    (kernel B6) lanes [P, R, S] take one set per problem, [P, K, 4]; with
    ``windows`` (B5) fewer boxes fit a block."""
    sid, param, struct = kernel_system(system, "its rollout")
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
    if obstacles.data_ptr() % 16:
        raise ValueError("obstacles: rows are read as float4, need 16-byte alignment")
    dev = _index(x0.device)
    limit = max_kernel_obstacles(dev, bool(windows), footprint is not None, struct)
    if K > limit:
        raise ValueError(f"{K} obstacles > {limit}, the most one block's "
                         "shared memory holds on this card"
                         f"{' beside the culled window store' if windows else ''}")
    flags = (FLAG_FOOTPRINT if footprint is not None else 0) | (
        FLAG_FAST if fast_math else 0)
    hl, hw = footprint if footprint is not None else (0.0, 0.0)
    return dev, sid, flags, P, R, K, param, hl, hw, struct


def _count(wrapper, system, sid: int, flags: int, windows: int, split: int) -> None:
    """One launch of ``wrapper``'s kernel, in the instantiation
    (system name, footprint, fast) it ran, culled (B5) or not, at G =
    ``split``; a user struct's in ``user_systems``."""
    wrapper.launches += 1
    wrapper.culled += bool(windows)
    wrapper.splits[split] += 1
    counter = wrapper.user_systems if sid == USER_SYSTEM_ID else wrapper.instantiations
    counter[(system.name, bool(flags & FLAG_FOOTPRINT),
             bool(flags & FLAG_FAST) and hasattr(system, "soa_step_fast"))] += 1


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _plain_rollout(system, x0, controls, obstacles, *, cull, **kw):
    """The plain twin of the kernel the wrapper would launch: B5's with
    ``cull``, over warps of lanes, else B1's."""
    W = cull_windows(cull, kw["num_disc"])
    if W:
        return rollout_culled_soa(system, x0, controls, obstacles, cull=cull,
                                  group=WARP, plan=cull_plan(W, kw["num_disc"]),
                                  **kw)
    return rollout_soa(system, x0, controls, obstacles, **kw)


def _plan_arg(cull, num_disc: int) -> tuple[int, bytes | None]:
    """B5's plan as the C entry points take it: (windows, one byte a window,
    its steps), or (0, None) with ``cull`` off."""
    W = cull_windows(cull, num_disc)
    if not W:
        return 0, None
    plan = cull_plan(W, num_disc)
    if len(plan) - 1 > MAX_PLAN:
        raise ValueError(f"cull={cull!r} at num_disc={num_disc}: {len(plan) - 1} "
                         f"windows of at most {CULL_STEPS} steps > {MAX_PLAN}")
    return len(plan) - 1, bytes(hi - lo for lo, hi in zip(plan, plan[1:]))


def _rollout(wrapper, system, x0: torch.Tensor, controls: torch.Tensor,
             obstacles: torch.Tensor, per_problem: bool, *, num_disc: int,
             width: float, height: float, footprint, fast_math: bool, cull,
             split: int | None) -> tuple[torch.Tensor, torch.Tensor]:
    """``rollout_kernel`` on the card for ``wrapper`` (B1, or B6 with
    ``per_problem``; B5 with ``cull``), or the plain twin on the CPU."""
    kw = dict(num_disc=num_disc, width=width, height=height,
              footprint=footprint, fast_math=fast_math)
    _check_split(split, cull)
    if not has_kernel(system):
        raise NotImplementedError(_no_kernel(system, "its rollout"))
    device = _device_of(x0, controls, obstacles)
    if device.type == "cpu":
        if obstacles.dim() != 2 + per_problem:
            raise ValueError(f"obstacles: expected {'[B, K' if per_problem else '[K'},"
                             f" 4], got {tuple(obstacles.shape)}")
        return _plain_rollout(system, x0, controls, obstacles, cull=cull, **kw)
    windows, plan = _plan_arg(cull, num_disc)
    dev, sid, flags, P, R, K, param, hl, hw, struct = _kernel_args(
        system, x0, obstacles, footprint, fast_math, per_problem, windows)
    _check("controls", controls, (*x0.shape[:-1], system.control_spec.dim),
           torch.float32)
    x1 = torch.empty_like(x0)
    valid = torch.empty(x0.shape[:-1], dtype=torch.bool, device=device)
    if P * R == 0:
        return x1, valid
    G = _split(split, P * R, windows, dev)
    rc = _build.load(struct).cudasbmp_rollout(
        dev, sid, flags, x0.data_ptr(), controls.data_ptr(),
        obstacles.data_ptr(), K, int(per_problem), x1.data_ptr(),
        valid.data_ptr(), P, R, num_disc, width, height, param, hl, hw,
        windows, plan, footprint_pad(footprint) if windows else 0.0, G,
        torch.cuda.current_stream(device).cuda_stream)
    _raise_on(rc, "rollout_kernel")
    _count(wrapper, system, sid, flags, windows, G)
    return x1, valid


def _sample_and_rollout(wrapper, system, keys: torch.Tensor, x0: torch.Tensor,
                        obstacles: torch.Tensor, per_problem: bool, *,
                        num_disc: int, width: float, height: float, footprint,
                        fast_math: bool, cull, split: int | None, lane0: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``sample_and_rollout_kernel`` on the card for ``wrapper`` (B2, or B6
    with ``per_problem``; B5 with ``cull``), or the plain twin on the CPU."""
    kw = dict(num_disc=num_disc, width=width, height=height,
              footprint=footprint, fast_math=fast_math, cull=cull)
    _check_split(split, cull)
    if not has_kernel(system):
        raise NotImplementedError(_no_kernel(system, "its rollout"))
    if not 0 <= lane0 <= 2**31 - 1 - x0.shape[-2]:
        raise ValueError(f"lane0 {lane0}: the lanes [lane0, lane0 + "
                         f"{x0.shape[-2]}) must lie in [0, 2^31 - 1)")
    device = _device_of(keys, x0, obstacles)
    if device.type == "cpu":
        if keys.dim() != 1 + per_problem or obstacles.dim() != 2 + per_problem:
            raise ValueError(f"keys {tuple(keys.shape)}, obstacles "
                             f"{tuple(obstacles.shape)}: expected "
                             f"{'[B, 2], [B, K, 4]' if per_problem else '[2], [K, 4]'}")
        return sample_and_rollout_torch(system, keys, x0, obstacles, lane0=lane0,
                                        **kw)
    windows, plan = _plan_arg(cull, num_disc)
    dev, sid, flags, P, R, K, param, hl, hw, struct = _kernel_args(
        system, x0, obstacles, footprint, fast_math, per_problem, windows)
    _check("keys", keys, (P, 2) if per_problem else (2,), torch.int64)
    spec = system.control_spec
    x1 = torch.empty_like(x0)
    controls = torch.empty((*x0.shape[:-1], spec.dim), dtype=torch.float32,
                           device=device)
    valid = torch.empty(x0.shape[:-1], dtype=torch.bool, device=device)
    if P * R == 0:
        return x1, controls, valid
    G = _split(split, P * R, windows, dev)
    rc = _build.load(struct).cudasbmp_sample_and_rollout(
        dev, sid, flags, keys.data_ptr(), x0.data_ptr(), obstacles.data_ptr(),
        K, int(per_problem), x1.data_ptr(), controls.data_ptr(),
        valid.data_ptr(), P, R, num_disc, width, height, param, hl, hw,
        windows, plan, footprint_pad(footprint) if windows else 0.0,
        *spec.lo, *spec.hi, lane0, G, torch.cuda.current_stream(device).cuda_stream)
    _raise_on(rc, "sample_and_rollout_kernel")
    _count(wrapper, system, sid, flags, windows, G)
    return x1, controls, valid


def rollout_cuda(system, x0: torch.Tensor, controls: torch.Tensor,
                 obstacles: torch.Tensor, *, num_disc: int, width: float,
                 height: float, footprint: tuple[float, float] | None = None,
                 fast_math: bool = False, cull: bool | int | None = None,
                 split: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B1 (with B3/B4 as options, and B5 with ``cull``): (x1 [B, 4],
    valid bool [B]) for x0 [B, 4], controls [B, 3] (duration last),
    obstacles [K, 4]; the contract of ``rollout_soa``. ``split`` forces G,
    the threads a rollout (None: ``lanes_per_rollout``); the result does
    not depend on it."""
    return _rollout(rollout_cuda, system, x0, controls, obstacles, False,
                    num_disc=num_disc, width=width, height=height,
                    footprint=footprint, fast_math=fast_math, cull=cull,
                    split=split)


def rollout_batched_cuda(system, x0: torch.Tensor, controls: torch.Tensor,
                         obstacles: torch.Tensor, *, num_disc: int,
                         width: float, height: float,
                         footprint: tuple[float, float] | None = None,
                         fast_math: bool = False, cull: bool | int | None = None,
                         split: int | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B6: B problems of R lanes each, problem b against its own
    obstacles[b]. x0 [B, R, 4], controls [B, R, 3] (duration last),
    obstacles [B, K, 4] -> (x1 [B, R, 4], valid bool [B, R]); the contract
    of ``rollout_soa`` (B5's with ``cull``, warps within each problem).
    ``split`` as ``rollout_cuda``'s, the rule taking all B * R lanes."""
    return _rollout(rollout_batched_cuda, system, x0, controls, obstacles, True,
                    num_disc=num_disc, width=width, height=height,
                    footprint=footprint, fast_math=fast_math, cull=cull,
                    split=split)


def sample_and_rollout_torch(system, key: torch.Tensor, x0: torch.Tensor,
                             obstacles: torch.Tensor, *, num_disc: int,
                             width: float, height: float,
                             footprint: tuple[float, float] | None = None,
                             fast_math: bool = False,
                             cull: bool | int | None = None, lane0: int = 0
                             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of kernel B2, and of B6's Philox form for keys [B, 2] over
    lanes [B, R] and obstacles [B, K, 4]: lane r of each problem draws from
    the counter (lane0 + r, 0, 0, 0) under its problem's key, then
    ``rollout_soa`` (``rollout_culled_soa`` over warps with ``cull``).
    Returns (x1, controls, valid)."""
    spec = system.control_spec
    lo, hi = spec.bounds(x0.device)
    u = rng.philox_uniform_lanes(key, x0.shape[-2], spec.dim, lane0=lane0)
    controls = lo + u * (hi - lo)
    x1, valid = _plain_rollout(system, x0, controls, obstacles, num_disc=num_disc,
                               width=width, height=height, footprint=footprint,
                               fast_math=fast_math, cull=cull)
    return x1, controls, valid


def sample_and_rollout_cuda(system, key: torch.Tensor, x0: torch.Tensor,
                            obstacles: torch.Tensor, *, num_disc: int,
                            width: float, height: float,
                            footprint: tuple[float, float] | None = None,
                            fast_math: bool = False,
                            cull: bool | int | None = None,
                            split: int | None = None, lane0: int = 0
                            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel B2: draw each lane's controls from Philox-4x32-10 under the
    threefry key data ``key`` (int64 [2]) at counter (lane0 + lane, 0, 0,
    0), then roll out as B1 (B5 with ``cull``; ``split`` as B1's). ``lane0``
    makes the launch lanes [lane0, lane0 + B) of a larger batch. Returns (x1
    [B, 4], controls [B, 3], valid bool [B])."""
    return _sample_and_rollout(sample_and_rollout_cuda, system, key, x0,
                               obstacles, False, num_disc=num_disc, width=width,
                               height=height, footprint=footprint,
                               fast_math=fast_math, cull=cull, split=split,
                               lane0=lane0)


def sample_and_rollout_batched_cuda(system, keys: torch.Tensor, x0: torch.Tensor,
                                    obstacles: torch.Tensor, *, num_disc: int,
                                    width: float, height: float,
                                    footprint: tuple[float, float] | None = None,
                                    fast_math: bool = False,
                                    cull: bool | int | None = None,
                                    split: int | None = None
                                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel B6, Philox form: problem b's lane r draws its controls from
    Philox-4x32-10 under the key words keys[b] (int64 [B, 2]) at counter
    (r, 0, 0, 0), so a problem's controls depend on its key and lane only,
    then rolls out as ``rollout_batched_cuda`` (``split`` as its). Returns
    (x1 [B, R, 4], controls [B, R, 3], valid bool [B, R])."""
    return _sample_and_rollout(sample_and_rollout_batched_cuda, system, keys, x0,
                               obstacles, True, num_disc=num_disc, width=width,
                               height=height, footprint=footprint,
                               fast_math=fast_math, cull=cull, split=split)


def rollout_bicycle_cuda(x0: torch.Tensor, controls: torch.Tensor,
                         obstacles: torch.Tensor, *, num_disc: int, width: float,
                         height: float, agent_length: float = 1.0,
                         fast_math: bool = False, cull: bool | int | None = None,
                         split: int | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """B1 (B5 with ``cull``) for the kinematic bicycle of wheelbase
    ``agent_length``: the counterpart of ``rollout_bicycle_pallas``."""
    return rollout_cuda(KinematicBicycle(agent_length=agent_length), x0, controls,
                        obstacles, num_disc=num_disc, width=width, height=height,
                        fast_math=fast_math, cull=cull, split=split)


def sample_and_rollout_bicycle_cuda(key: torch.Tensor, x0: torch.Tensor,
                                    obstacles: torch.Tensor, *, num_disc: int,
                                    width: float, height: float,
                                    agent_length: float = 1.0,
                                    control_bounds: tuple | None = None,
                                    fast_math: bool = False,
                                    cull: bool | int | None = None,
                                    split: int | None = None
                                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B2 (B5 with ``cull``) for the kinematic bicycle, its controls drawn
    from ``control_bounds`` ((lo, hi) per control, duration last) where
    given, else the system's box: the counterpart of
    ``sample_and_rollout_bicycle_pallas``."""
    system = KinematicBicycle(agent_length=agent_length)
    if control_bounds is not None:
        system = dataclasses.replace(system, control_spec=ControlSpec(
            lo=tuple(b[0] for b in control_bounds),
            hi=tuple(b[1] for b in control_bounds)))
    return sample_and_rollout_cuda(system, key, x0, obstacles, num_disc=num_disc,
                                   width=width, height=height,
                                   fast_math=fast_math, cull=cull, split=split)


WRAPPERS = (rollout_cuda, sample_and_rollout_cuda, rollout_batched_cuda,
            sample_and_rollout_batched_cuda)
for _wrapper in WRAPPERS:
    _wrapper.launches = 0
    _wrapper.culled = 0
    _wrapper.instantiations = collections.Counter()
    _wrapper.user_systems = collections.Counter()
    _wrapper.splits = collections.Counter()


def reset_launch_counts() -> None:
    for wrapper in WRAPPERS:
        wrapper.launches = 0
        wrapper.culled = 0
        wrapper.instantiations.clear()
        wrapper.user_systems.clear()
        wrapper.splits.clear()
