"""Roofline accounting for the rollout kernels on the card (counterpart of
tools/roofline.py):

    python -m cudasbmp_torch.probes.roofline

1. ``calibrate``: the card's dependent-FMA rate (kernel P1a, f32[2048, 128],
   16,384 links), its accurate cos, sin and tan rates (P1b, 2,048 links)
   and its shared-memory gather rate at tables of 8, 128 and 1,024 rows
   (P2, 512 links), each from device time under torch.profiler.
2. The throughput probe's B2 rollouts per second (``cuda_rng``): exact and
   fast math on the demo's boxes, exact on ``Scenario.dense(24)``.
3. Each as a share of the card's published peaks (67 TFLOP/s f32 outside
   the tensor cores, 3.35 TB/s): ``bound_ms`` of the kernel's work from
   ``ops_per_lane`` over its device time; and ``analyze``, the formulas of
   tools/roofline.py, against the calibrated rates with the kernel's own
   operation counts (``kernel_ops``). The calibrated rates stand beside the
   shares and do not replace the peaks.

Prints JSON lines, the card's name and power limit first, and writes the
whole record to chiprun_out/roofline.json.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
CAL_SHAPE = (2048, 128)  # 8 programs of 256 x 128, as the TPU probes
PROGRAM_ROWS = 256
ALU_CHAIN, TRANS_CHAIN, GATHER_CHAIN = 16384, 2048, 512
GATHER_ROWS = (8, 128, 1024)
OUT = Path(__file__).resolve().parents[2] / "chiprun_out" / "roofline.json"
HEADING = ("bicycle", "unicycle", "dubins")


def ops_per_lane(system: str, footprint: bool, fast: bool, K: int, num_disc: int,
                 sample: bool) -> int:
    """f32 operations one lane of the rollout kernels does, counted from
    csrc/rollout.cu: each add, sub, mul, div, compare, min, max and abs is
    one, each cosf/sinf/tanf one (the accurate library functions take tens
    of instructions, so the count, and the bound it gives, is a lower
    bound), and Philox-4x32-10's integer work in the sampling forms (10
    rounds of two wide multiplies, four xors and two key adds, about 80)
    counts at the f32 rate with the 5 operations of each of 3 draws. The
    one-pass loops run every step and every box whatever the data (a dead
    lane keeps computing), so the count depends on the shapes only; it is
    also the count of the work B5 computes, which skips some of it."""
    heading = system in HEADING
    turn = {"unicycle": 1, "dubins": 2}.get(system, 0)
    if fast and heading:
        prepare = 14 if system == "bicycle" else 4 + turn
        step = 22 if system == "bicycle" else 13 + turn
    else:
        prepare = 1 if system == "bicycle" else 0  # tanf(steering)
        step = {"bicycle": 14, "point2d": 4, "double_integrator": 8}.get(system, 9 + turn)
    per_step = step + 8  # bounds (4 compares) and the swept box (4 min/max)
    per_box = 4  # the separating-axis test
    if footprint:
        per_step += 6 + (2 if heading and not fast else 0)  # centre, |cos|, |sin|; trig
        per_box += 42  # box centre and half extents, four axes
    return 1 + prepare + num_disc * (per_step + K * per_box) + (95 if sample else 0)


def trig_per_lane(system: str, footprint: bool, fast: bool, num_disc: int) -> int:
    """cosf/sinf/tanf calls of one lane (within ``ops_per_lane``): the
    bicycle's tanf(steering); cos/sin of the heading every step on the exact
    path, twice with a footprint; the fast path's once-per-rollout carry."""
    if system not in HEADING:
        return 0
    if fast:
        return 7 if system == "bicycle" else 4
    return (system == "bicycle") + num_disc * (4 if footprint else 2)


def kernel_ops(system: str, footprint: bool, fast: bool, K: int, num_disc: int,
               sample: bool) -> dict:
    """The rollout kernel's per-lane work in the keys ``analyze`` reads.
    Every rounding step is an explicit __fadd_rn/__fmul_rn, which nvcc never
    fuses, so the fused and the conservative tallies are one count."""
    trig = trig_per_lane(system, footprint, fast, num_disc)
    alu = ops_per_lane(system, footprint, fast, K, num_disc, sample) - trig
    return {"assumptions": "csrc/rollout.cu, one issue per f32 operation, no "
                           "FMA; Philox's integer work at the f32 rate",
            "system": system, "num_disc": num_disc, "K_obstacles": K,
            "footprint": footprint, "fast_math": fast, "sample": sample,
            "alu_issues_fused": alu, "alu_issues_conservative": alu,
            "transcendentals": trig}


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the f32 rate. (ms, what bounds it)."""
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def bound_ms(lanes: int, ops: int, boxes: int, keys: int = 0) -> tuple[float, str]:
    """``bound`` of a rollout launch: per lane a float4 state and 3 controls
    in or out, a float4 state and a valid byte out (45 B); 16 B per box and
    per key, read once; ``ops`` operations a lane."""
    return bound(45 * lanes + 16 * (boxes + keys), lanes * ops)


# R1's operations a step of each system, forward and in the reverse sweep,
# and a prepare a edge (tanf), counted from csrc/refine.cu as ops_per_lane
# counts (trig one each)
REFINE_STEP_OPS = {"bicycle": (14, 39, 1), "point2d": (4, 10, 0),
                   "double_integrator": (8, 18, 0), "unicycle": (10, 26, 0),
                   "dubins": (11, 30, 0)}


def refine_ops(system: str, problems: int, edges: int, points: int, boxes: int,
               inside: int) -> int:
    """f32 operations of an R1 launch over ``problems`` problems of
    ``edges`` edges and ``points`` Euler steps in all, each problem against
    ``boxes`` boxes: per point its step forward and back, 13 a box (the
    signed distance) and 31 more (the bounds, the point's gradient); 21
    more for each of the ``inside`` (point, box) pairs inside an inflated
    box, which the data decides; per edge dt twice, the prepare twice and
    d/d dur; per problem the block's sum of 5 terms over 256 threads and
    the goal term."""
    fwd, back, prep = REFINE_STEP_OPS[system]
    return (points * (fwd + back + 13 * boxes + 31) + 21 * inside
            + edges * (3 + 2 * prep) + problems * (5 * 255 + 15))


def refine_bound_ms(system: str, problems: int, edges: int, points: int, boxes: int,
                    inside: int, per_problem_boxes: bool) -> tuple[float, str]:
    """``bound`` of one R1 launch (``refine_ops``'s arguments): per problem
    a float4 start, the goal and the loss (28 B), per edge 3 controls, a
    weight and 3 gradients (28 B); 16 B a box, once for a shared set."""
    sets = problems if per_problem_boxes else 1
    return bound(28 * (problems + edges) + 16 * boxes * sets,
                 refine_ops(system, problems, edges, points, boxes, inside))


# the whole refinement's operations an entry (3 an edge) an Adam step: the
# sigmoid box (an exp counted as one, 4 more), its backward through the box
# and the sigmoid (5), the square for the norm (1), the clip and Adam (11);
# and 4 adds an edge for the pairwise trees of the time term and the norm
ADAM_ENTRY_OPS = 22


def refine_adam_ops(system: str, problems: int, edges: int, points: int, boxes: int,
                    inside: int, iterations: int) -> int:
    """f32 operations of one whole refinement (refine_adam_kernel) over
    ``problems`` problems whose own paths hold ``edges`` edges and
    ``points`` Euler steps in all: ``iterations`` of R1's work with its
    sweep and one more without it (the final loss), ``inside`` (point,
    box) pairs each pass, and ADAM_ENTRY_OPS an entry and 4 an edge a step."""
    back = REFINE_STEP_OPS[system][1]
    one = refine_ops(system, problems, edges, points, boxes, inside)
    return ((iterations + 1) * one - points * back
            + iterations * edges * (3 * ADAM_ENTRY_OPS + 4))


def refine_adam_bound_ms(system: str, problems: int, padded_edges: int, edges: int,
                         points: int, boxes: int, inside: int, iterations: int,
                         per_problem_boxes: bool) -> tuple[float, str]:
    """``bound`` of one whole refinement (``refine_adam_ops``' arguments):
    per problem a float4 start, the goal and its losses (24 + 4 iterations
    B), per padded edge the controls and their inverse sigmoid in, the
    mask, and the refined controls out (37 B), the two bias tables (8 B a
    step), 16 B a box, once for a shared set."""
    sets = problems if per_problem_boxes else 1
    return bound((24 + 4 * iterations) * problems + 37 * padded_edges + 8 * iterations
                 + 16 * boxes * sets,
                 refine_adam_ops(system, problems, edges, points, boxes, inside, iterations))


# Threefry-2x32's own instructions, counted from what the function needs
# (rng.py's twin), not from what csrc/threefry.cu compiles to: a hash is 20
# rounds of an add, a rotation (one funnel shift) and a xor (60), the third
# key word (one 3-input xor) and 6 injections of two adds, the round
# constant folded into a 3-input add (13). An output adds its index, its
# key's two words loaded and its store's address (4), and per mode:
# fold_in the data and two words stored; split the counter's add and two
# words stored; random_bits the 64-bit counter's add, the words' xor and a
# store; uniform that less its store, the mantissa (shift, or, subtract 1)
# and max(lo, u * (hi - lo) + lo) (4) and a store; scaled_uniform the same
# without the max; wave_keys (an output pair) four hashes (two folds, the
# split's two words), two data, the wave's test and two keys stored (4).
# The kernel's operand maps, (index / div) % mod of each operand, are not
# counted: the function needs no division.
THREEFRY_HASH = 60 + 13
THREEFRY_INSTRUCTIONS = {
    "fold_in": THREEFRY_HASH + 4 + 3, "split": THREEFRY_HASH + 4 + 3,
    "random_bits": THREEFRY_HASH + 4 + 4, "uniform": THREEFRY_HASH + 4 + 3 + 3 + 4 + 1,
    "scaled_uniform": THREEFRY_HASH + 4 + 3 + 3 + 3 + 1,
    "wave_keys": 4 * THREEFRY_HASH + 4 + 2 + 1 + 4}
# bytes an output: the output written, and a data tensor's int64 read
THREEFRY_BYTES = {"fold_in": 16 + 8, "split": 16, "random_bits": 8, "uniform": 4,
                  "scaled_uniform": 4, "wave_keys": 32 + 16}
H100_SMS = 132
TOP_SM_CLOCK_HZ = 1.98e9  # the H100 SXM's top SM clock, held under load
WARP_ISSUES_PER_CLOCK = 4  # warp-instructions a clock an SM, one a scheduler


def threefry_bound_ms(mode: str, outputs: int, key_rows: int = 1,
                      sm_count: int = H100_SMS,
                      clock_hz: float = TOP_SM_CLOCK_HZ) -> tuple[float, str]:
    """The least time of one threefry launch of ``mode`` over ``outputs``
    outputs (wave_keys: output pairs) from ``key_rows`` keys: the larger of
    its bytes (``THREEFRY_BYTES`` an output, 16 a key) over 3.35 TB/s and
    its instructions (``THREEFRY_INSTRUCTIONS`` an output) at 4
    warp-instructions a clock an SM. (ms, "bytes" or "instructions")."""
    t_bytes = (THREEFRY_BYTES[mode] * outputs + 16 * key_rows) / PEAK_BYTES_PER_S
    t_issue = (THREEFRY_INSTRUCTIONS[mode] * outputs
               / (sm_count * WARP_ISSUES_PER_CLOCK * 32 * clock_hz))
    return 1e3 * max(t_bytes, t_issue), "bytes" if t_bytes >= t_issue else "instructions"


def chain_bounds(elems: int, rows: int | None = None) -> dict:
    """``bound`` of each calibration chain over ``elems`` elements: f32 x
    read and y written once (P2: the table, int32 idx, y); P1a two flops a
    link (an FMA), P1b a trig call and an add, P2 one add (the gather is a
    shared-memory load, the index update integer work)."""
    out = {"alu": bound(8 * elems, 2 * ALU_CHAIN * elems),
           "trans": bound(8 * elems, 2 * TRANS_CHAIN * elems)}
    if rows is not None:
        out["gather"] = bound(512 * rows + 8 * elems, GATHER_CHAIN * elems)
    return out


def chain_inputs(device, rows: int | None = None):
    """The calibration inputs, from seeds: x f32 CAL_SHAPE uniform in
    [0.5, 1) (threefry key 0, as the TPU probe draws it); with ``rows``, a
    table f32 [rows, 128] and indices int32 CAL_SHAPE in [0, rows)."""
    from cudasbmp_torch import rng

    x = rng.uniform(rng.key(0, device), CAL_SHAPE, 0.5, 1.0)
    if rows is None:
        return x
    r = np.random.default_rng(rows)
    tbl = torch.tensor(r.uniform(0, 1, (rows, CAL_SHAPE[1])).astype(np.float32),
                       device=device)
    idx = torch.tensor(r.integers(0, rows, CAL_SHAPE).astype(np.int32), device=device)
    return x, tbl, idx


def calibrate(device: torch.device | str = "cuda") -> dict:
    """The card's chain rates from device time per launch: FMA issues/s
    (one a link; ``alu_ops_per_sec_2x`` counts mul and add apart, as the
    TPU probe's convention), cos/sin/tan evaluations/s and gathers/s per
    table size, with each launch's ms and its regular profiler windows
    (``regular``; a rate is None where no window was regular)."""
    from cudasbmp_torch.ops import chains_cuda as cc
    from cudasbmp_torch.planners.kgmt import resolve_device
    from cudasbmp_torch.probes.timing import device_ms

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("calibrate measures the card: pass a CUDA device")
    x = chain_inputs(dev)
    elems = x.numel()
    ms, regular, out = {}, {}, {}

    def rate(name: str, links: int, fn) -> float | None:
        ms[name], regular[name], _ = device_ms(fn)
        return links * elems / (ms[name] / 1e3) if ms[name] else None

    out["alu_fma_issues_per_sec"] = rate(
        "alu", ALU_CHAIN, lambda: cc.alu_chain_cuda(x, ALU_CHAIN))
    fma = out["alu_fma_issues_per_sec"]
    out["alu_ops_per_sec_2x"] = 2 * fma if fma else None
    for op in ("cos", "sin", "tan"):
        out[f"{op}_evals_per_sec"] = rate(
            op, TRANS_CHAIN, lambda: cc.trans_chain_cuda(x, TRANS_CHAIN, op))
    for rows in GATHER_ROWS:
        _, tbl, idx = chain_inputs(dev, rows)
        out[f"gathers_per_sec_{rows}"] = rate(
            f"gather{rows}", GATHER_CHAIN,
            lambda: cc.gather_chain_cuda(tbl, idx, GATHER_CHAIN))
    out["ms"], out["regular"] = ms, regular
    return out


def analyze(measured_total_per_sec: float, ops: dict, cal: dict) -> dict:
    """Fractions of each roofline for one measured kernel configuration:
    the formulas of tools/roofline.py::analyze."""
    alu_rate = cal["alu_fma_issues_per_sec"]
    trans_rate = min(cal["cos_evals_per_sec"], cal["sin_evals_per_sec"])
    n_tr = ops["transcendentals"]
    trans_frac = (measured_total_per_sec * n_tr / trans_rate) if n_tr else 0.0
    alu_frac_fused = measured_total_per_sec * ops["alu_issues_fused"] / alu_rate
    alu_frac_cons = (measured_total_per_sec
                     * ops["alu_issues_conservative"] / alu_rate)
    # additive (no-overlap) speed-of-light prediction
    sol_additive = 1.0 / (ops["alu_issues_fused"] / alu_rate
                          + (n_tr / trans_rate if n_tr else 0.0))
    sol_overlap = min(alu_rate / ops["alu_issues_fused"],
                      trans_rate / n_tr if n_tr else float("inf"))
    binding = ("transcendental" if trans_frac > alu_frac_fused
               else "ALU issue slots")
    return {
        "measured_rollouts_per_sec": measured_total_per_sec,
        "trans_roofline_fraction": round(trans_frac, 3),
        "alu_roofline_fraction_fused": round(alu_frac_fused, 3),
        "alu_roofline_fraction_conservative": round(alu_frac_cons, 3),
        "sol_rollouts_per_sec_additive": round(sol_additive, 1),
        "sol_rollouts_per_sec_overlapped": round(sol_overlap, 1),
        "fraction_of_sol_overlapped": round(
            measured_total_per_sec / sol_overlap, 3),
        "binding_constraint": binding,
        "ops": ops,
    }


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def b2_shares(cal: dict, device="cuda", probes: dict | None = None) -> dict:
    """B2 (``cuda_rng``) exact and fast on the demo's boxes and exact on
    dense-24: the probe's rates (``probes[label]`` where given, else
    measured here), the kernel's device ms at the probe's shape, its share
    of the published peaks (bound over ms) and ``analyze`` against
    ``cal``."""
    from cudasbmp_torch.config import Scenario
    from cudasbmp_torch.ops import rollout_cuda as rc
    from cudasbmp_torch.probes import throughput as tp
    from cudasbmp_torch.probes.timing import device_ms
    from cudasbmp_torch import rng

    out = {}
    for label, dense, fast in (("exact_demo", False, False),
                               ("fast_math_demo", False, True),
                               ("exact_dense24", True, False)):
        probe = (probes or {}).get(label) or tp.measure_prop_throughput(
            backend="cuda_rng", dense=dense, fast_math=fast, device=device)
        sc = Scenario.dense(24) if dense else Scenario.demo()
        obstacles = torch.tensor(sc.obstacles, device=device)
        K = obstacles.shape[0]
        x0 = tp.start_states(tp.BATCH, device)
        key = rng.key(1, device)
        kernel_ms, regular, _ = device_ms(lambda: rc.sample_and_rollout_bicycle_cuda(
            key, x0, obstacles, num_disc=tp.NUM_DISC, width=tp.WIDTH,
            height=tp.HEIGHT, fast_math=fast))
        ops = ops_per_lane("bicycle", False, fast, K, tp.NUM_DISC, True)
        b_ms, by = bound_ms(tp.BATCH, ops, K, 1)
        out[label] = {
            "K": K, "kernel_ms": kernel_ms, "kernel_regular": regular,
            "bound_ms": b_ms, "bound_by": by,
            "peak_share": b_ms / kernel_ms if kernel_ms else None,
            "probe": probe,
            "calibrated": analyze(tp.BATCH / (kernel_ms / 1e3),
                                  kernel_ops("bicycle", False, fast, K,
                                             tp.NUM_DISC, True), cal)
            if kernel_ms else None}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("roofline: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    smi = card()
    print(json.dumps({"card": smi}), flush=True)
    cal = calibrate("cuda")
    print(json.dumps({"calibration": cal}), flush=True)
    shares = b2_shares(cal, "cuda")
    for label, r in shares.items():
        print(json.dumps({label: {k: v for k, v in r.items() if k != "probe"}}),
              flush=True)
    result = {"card": smi, "peaks": {"f32_per_s": PEAK_F32_PER_S,
                                     "bytes_per_s": PEAK_BYTES_PER_S},
              "calibration": cal, **shares}
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
