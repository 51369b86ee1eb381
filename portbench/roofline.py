"""The rollout kernels' operation and byte counts, and the H100's published
peaks: a frozen copy of cudasbmp_torch/probes/roofline.py's
``ops_per_lane``, ``bound`` and ``bound_ms``, kept here so that the
yardstick does not move with the program. The counts depend on the launch's
shapes only (lanes, boxes, keys, steps), whatever kernel does the work.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet
PEAK_F32_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
HEADING = ("bicycle", "unicycle", "dubins")


def ops_per_lane(system: str, footprint: bool, fast: bool, K: int, num_disc: int,
                 sample: bool) -> int:
    """f32 operations one lane of a rollout does: each add, sub, mul, div,
    compare, min, max and abs one, each cos/sin/tan one, a step's bounds
    test (4 compares) and swept box (4 min/max), 4 a box for the
    separating-axis test (46 with a footprint), and with ``sample`` a
    Philox-4x32-10 draw of three controls at 95. Every step and every box
    counts whatever the data (the one-pass loops run them all)."""
    heading = system in HEADING
    turn = {"unicycle": 1, "dubins": 2}.get(system, 0)
    if fast and heading:
        prepare = 14 if system == "bicycle" else 4 + turn
        step = 22 if system == "bicycle" else 13 + turn
    else:
        prepare = 1 if system == "bicycle" else 0
        step = {"bicycle": 14, "point2d": 4, "double_integrator": 8}.get(system, 9 + turn)
    per_step = step + 8
    per_box = 4
    if footprint:
        per_step += 6 + (2 if heading and not fast else 0)
        per_box += 42
    return 1 + prepare + num_disc * (per_step + K * per_box) + (95 if sample else 0)


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    """The least time the card could take, in ms: the larger of the bytes
    over the memory rate and the operations over the f32 rate, with what
    bounds it."""
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def bound_ms(lanes: int, ops: int, boxes: int, keys: int = 0) -> tuple[float, str]:
    """``bound`` of one rollout launch: per lane a float4 state and 3
    controls in or out, a float4 state and a valid byte out (45 B); 16 B a
    box and a key, each read once; ``ops`` operations a lane."""
    return bound(45 * lanes + 16 * (boxes + keys), lanes * ops)


def launch_bound_ms(shape: dict) -> tuple[float, str]:
    """``bound_ms`` of a launch described by ``shape``: ``problems`` x
    ``lanes`` (a problem's rollouts), ``boxes`` a set, one set shared or
    one a problem (``per_problem_boxes``), a key a problem where the kernel
    draws its controls (``sample``), and the system's options."""
    P, R, K = shape["problems"], shape["lanes"], shape["boxes"]
    ops = ops_per_lane(shape["system"], shape["footprint"], shape["fast_math"], K,
                       shape["num_disc"], shape["sample"])
    sets = P if shape["per_problem_boxes"] else 1
    keys = (P if shape["per_problem_boxes"] else 1) if shape["sample"] else 0
    return bound_ms(P * R, ops, sets * K, keys)
