"""Drive the cudasbmp_torch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # phases 1-35, one GPU, no network
    python3 chip_smoke.py --profile  # also: torch.profiler over a demo solve,
                                     # an arena solve and a streaming sweep
    python3 chip_smoke.py --compare OLD.json NEW.json  # two runs' records:
                                     # do their solves agree? (no GPU needed)
    python3 chip_smoke.py --user-dynamics  # phases 1, 2 and 34 alone
    python3 chip_smoke.py --ranks N  # phase 33 alone over N processes (a card
                                     # a rank: nccl), after [16], [22], [30]

Run from the root of a checkout. The CUDA kernels build from
cudasbmp_torch/csrc/ with nvcc at first use. Phases, one line each:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc seconds and the kernels' register and spill counts;
3. B1 (rollout_kernel) against its plain PyTorch version at 2^17 demo lanes,
   at the main path's wave width R=4096, at R=33 and 4,097 (lanes past R
   inside a thread group's warp), and with 40 boxes at 4,096 and 4,097;
4. B2 (sample_and_rollout_kernel) against its plain twin, at those widths;
5. the reference demo solve (KGMTConfig() defaults: M=30000, R=4096,
   N=16/n=8) in tree mode, 'auto' backend, seeds 0-3: solved, path replays,
   and the launch counters prove every wave went through B1, at the G
   (threads a rollout) the rule picks for 4,096 lanes, G > 1;
6. the same with 'cuda_rng' (every wave through B2) and need_path=False;
7. throughput: ms per call of B1, B2 and their plain versions at B=4096
   (the main path's shape; the JSON line's times) and valid 10-step
   rollouts/s at B=2^17: device time under torch.profiler over 20 calls
   after warm-up (``ms``), and CUDA events over 20 calls (``launch_ms``,
   which the host's launch rate sets where it is slower than the card);
   the per-G table (B1 exact and with the footprint at every forced G in
   {1, 2, 4, 8} at 1,024 to 2^17 lanes) and the one-warp floor of each
   rollout row (32 lanes at the G its row runs at);
8. every instantiation of B1 and B2 (5 systems x {broad phase, footprint
   B3} x {exact, fast math B4}) bitwise against its plain twin at the
   rule's G and at every forced G, at R in {33, 4,096, 4,097, 2^17} and K
   in {1, 5, 8, 9, 40} (the one-thread walk pads K to a multiple of 4);
   kernel/plain ms at B=4096 (the main path's width) for
   bicycle+footprint (B3) and bicycle+footprint+fast (B4), and at B=2^17
   for bicycle+footprint+fast and dubins+footprint;
9. 40 boxes (Scenario.dense, max_obstacles=64), past the 32 a static
   shared array once held: B1/B2 against their twins, and a solve;
10. the bicycle with every option (footprint 0.5, fast math, goal bias
    0.25) at demo width, seeds 0-7, tree and pathless ('auto') and seeds
    0-3 with 'cuda_rng'; for seed 0 the kernel equals its plain twin
    driven on the card, and with exact math 'auto' equals 'torch';
11. systems/unicycle.yaml, systems/dubins.yaml (also without adaptive
    waves, as the JAX package's dubins test runs it), point2d and
    double_integrator at default widths, seeds 0-3;
12. the CLI as subprocesses: demo with every option and plan of
    configurations/ with systems/car.yaml, on the card;
13. B6 (rollout_kernel and sample_and_rollout_kernel with one box set and
    key per problem), every instantiation of both forms bitwise against its
    plain twin at B=8 problems x R=512 lanes, at the extension rounds'
    buckets of 8 and 64 problems x R=128 and at the sweeps' B=1024 x R=128,
    at the rule's G and at every forced G, with a distinct box set per
    problem, at K in {1, 5, 8, 9, 40} x R in {1, 127, 128, 129, 512} per
    problem (8 problems, at the rule's G and G = 1), and at 70,000 problems
    x 2 lanes (past a grid's y extent); a wall in
    problem 1 changes only problem 1; a key gives the same rows at B=4 and
    at B=8 in another slot; ms of B6, its twin, and B1 on the same lanes
    with one shared set, at the sweeps' shape B=1024 x R=128 x K=8;
14. the batched arena at BASELINE config 4's width (256 demo pairs, goal
    jitter 1.0, R=128, 150 windows, auto capacity, one extension; the
    bench.py settings) under 'auto' (every wave through B1) and 'cuda_rng'
    (B2): solve rate, cost quantiles, solves/s, launches equal to the waves
    run, at the rule's G for 32,768 lanes, solved paths replaying within
    1e-4 with cost = sum of durations; then config 4 with three goals
    inside a box, which forces one extension round: the three re-planned in
    a bucket of 8 x 128 lanes at the rule's G for it (4 on an H100), the
    merged result checked against the same solve without the round;
15. the Monte-Carlo sweep at config 5's per-chip width (1024 random
    scenarios, 8 boxes, two extensions), every wave through B6 at G = 1;
16. the streaming sweep (4096 scenarios, pool 1024, R=128, 150 waves per
    scenario) under 'auto' (B6) and 'cuda_rng' (B6's Philox form); then at
    256 scenarios two id_lo partitions and pool sizes 32 and 64 reproduce
    the pool of 64 bit for bit, under both;
17. the CLI as subprocesses: multi --impl arena --batch 256 and sweep
    --impl stream, on the card;
18. B5 (both kernels with cull=W, the culled broad phase) bitwise against
    cull off in every instantiation at W in {1, 2, 4, 5}, on the dense-24
    field and tests/test_pallas.py's 16-box field, at 2^17 lanes random and
    Morton-grouped, at R=33 and 4,097 and at 100 boxes, at 25 steps (windows
    past the kernel's cap of 10 steps, cut by the wrapper's plan) and at the
    culled box cap (one box more raises); against its plain twin; device ms
    of B2 with cull off and at each W beside the twin's, and its one-warp
    floor; the culled instantiations' registers and spills;
19. the throughput probe (probes/throughput.py, bench.py's 2^17 lanes):
    valid rollouts/s by device time and, labelled, by wall for cuda,
    cuda_rng, fast math, dense-24 and torch; then the cull table of
    tools/r4_cull_bench.py, B5's main path;
20. the calibration chains P1a (FMA; also at a ragged size), P1b (cos,
    sin, tan; bitwise) and P2 (gathers at 8, 128 and 1,024 rows, on the
    calibration's indices and on a ragged count of rows with negative and
    large indices; bitwise) against their plain twins, each one's launch
    geometry (P1a's and P1b's blocks an SM by the occupancy query and
    their grids, P2's blocks, rows a block and most rows at each table
    size) and registers, their device ms, the rollout
    kernels' sincosf against torch.sin/torch.cos at every float, their
    rates from device time (probes/roofline.py::calibrate), and B2's
    roofline shares, exact, fast and dense-24;
21. the CLI's probe, naive and costprop at 524,288 lanes, as subprocesses
    on the card;
22. both B6 forms bitwise against their twins at the new paths' shapes (64
    problems x 4,096 lanes, 256 x 2,048, 128 x 256) and B1 at
    shortcut_path's 256 lanes; torch's sums of score rows as a batch and
    one row at a time, against _math.row_sum's (equal); then MultiQueryPlanner at the CLI's multi
    default (KGMTConfig(), 64 jittered demo pairs) under 'auto' (every trip
    one launch of B6) and 'cuda_rng' (B6's Philox form): four problems, the
    slowest among them, equal the single-query solve on their keys
    fold_in(key(seed), b) field by field (solved, iterations, tree size,
    cost, path bits); every solved path replays within 1e-4 with cost = sum
    of durations; kernel launches a trip equal at B = 8 and 64 (profiler
    runtime-API records); one host read a trip (torch's sync debug mode);
23. bench.py's vmap shape: 256 demo pairs, M=16,384, R=2,048, 'cuda_rng',
    fixed waves, every trip through B6's Philox form; then config 4's 256
    pairs and settings through the vmapped planner and the arena: trips,
    wall and kernel launches a trip of each;
24. MonteCarloPlanner(impl='vmap') at the CLI's sweep default (64 random
    scenarios of 8 boxes), every trip through B6 with a distinct box set
    per problem; the slowest scenario equals its single solve;
25. shortcutting: shortcut_path (ShortcutConfig()) on phase 5's seed-0 demo
    path through B1, equal to the plain twin driven on the card;
    shortcut_batch on [22]'s paths and at the quality pipeline's shape
    (arena 128 x R=1,024, 150 windows, 'cuda_rng', one extension, then 256
    rounds x 256 candidates) through B6; every shortened path replays valid
    and ends in its goal;
26. the CLI's defaults as subprocesses on the card: multi, sweep (both
    --impl vmap) and demo --shortcut;
27. R1 (refine_kernel, the refinement penalty's value and gradient)
    against its plain twin under autograd for every system, with and
    without masked edges, shared and per-problem boxes, at T of 1 to 1,510
    points, and on the CLI demo path's and [25]'s pipeline inputs: forward
    states bitwise, penalty within R1_RTOL, gradient within R1_GRAD_RTOL of
    its norm; device ms of R1 at both shapes and of the twin at the demo
    path's, R1 on one path of the pipeline (its serial chain), and the
    bounds; then refine_adam_kernel, R1 redesigned to run the whole
    refinement in one launch, each problem trimmed to its own path: at
    RefineConfig() bitwise the step path (refine.py::_refine_core with R1,
    401 R1 launches, counted) in losses and refined controls on the CLI
    demo path and on the pipeline (cut to its longest real path as
    refine_batch runs it, and padded to its full width), within
    ADAM_TWIN_TOL of its twin at ADAM_TWIN_STEPS steps; its device ms a
    refinement and an Adam step at both shapes, padded, on the pipeline's
    longest path alone and either side of the switch to global scratch
    (the least L whose working set passes a block's shared memory), at
    ADAM_ROW_STEPS steps beside its twin's, the step path's wall, and the
    bounds;
28. refinement: the CLI's demo --refine (KGMTConfig(), RefineConfig()) as a
    subprocess; refine_path on the CLI demo's path (one launch of the whole
    refinement, B1 an edge) and refine_batch at RefineConfig() on [25]'s
    128 shortened pipeline paths (one launch, B6 an edge of the longest
    real path): improved count, cost quantiles before and after, wall;
    every kept path replays valid and ends in its goal; the wall and device
    ms and the kernel launches of the step path's Adam step with R1 and
    with its twin, at both shapes (the twin's launches at the demo path's
    only);
29. the recorded solve of the demo (KGMT.plan_recorded, a checkpoint every
    5 iterations), a checkpoint round trip on the card, a resume from
    checkpoint_5 equal to plan() to the bit, and the CLI's record as a
    subprocess;
30. the sharded tree (ShardedTreePlanner at KGMTConfig(): 30,000 slots a
    shard, 4,096 lanes, the exchange pool) at D = 1 and 4 shards under
    'auto' (every trip one launch of B6 over D x 4,096 lanes) and
    'cuda_rng' (B6's Philox form, a key a shard), seeds 0-3: solve rate,
    cost, iterations, trips, launches (equal to the trips), launches and
    host reads an iteration, paths crossing shards, identical score rows,
    wall; the paths replay; at D = 4 every trip's rows bitwise the twin's
    on the card; plan_checkpointed and a resume equal to plan(); a trace
    naming the sharded iteration's phases; validate_state on a demo solve;
31. the CLI's sharded (with --checkpoint-dir and --resume-from), profile
    (its trace's phase names) and demo --plot --out-dir and viz (exit 2
    with a message without matplotlib) as subprocesses on the card;
32. the sharded multi-query planner at full width: the CLI multi default's
    64 jittered demo pairs x 4 shards each at KGMTConfig(), under 'auto'
    (every trip one launch of B6 over 64 x 4 x 4,096 lanes) and 'cuda_rng'
    (B6's Philox form): solve rate, cost quantiles, iterations, trips,
    launches (equal to the trips), launches and host reads an iteration and
    a trip, wall, solves/s; problems 0-3 equal ShardedTreePlanner's solves
    under their keys, bitwise; the first trips' rows bitwise the twin's on
    the card; every solved path replays;
33. two processes on the one card joined by gloo (this script's
    --two-ranks-child, a rank each, killed if they outlive the timeout):
    the sharded tree at D = 4 (two shards a rank) seeds 0-3 under both
    backends, plan_checkpointed (rank 0 writes; the file resumes in a fresh
    one-process planner), MultiQueryPlanner over the two ranks at the CLI
    multi default and run_sharded at 4,096 scenarios (a pool of 1,024 a
    rank): every result bitwise [30]'s, [22]'s and [16]'s one-process
    results; each rank's walls, launches a trip and host reads an iteration;
34. user dynamics (register_system, a system's own device struct built into
    a library of its own: both libraries below start building beside the
    package's in phase 2): (a) the built-in bicycle's struct copied under
    the name bicycle_copy is bitwise the built-in kernels: B1 and B2 at the
    demo's 4,096 lanes, exact, with the footprint (B3) and with fast math
    (B4); B6 and B6 Philox at 64 x 4,096; B5 at W = 4 on the cull table's
    2^17 Morton-grouped starts on dense-24; R1 and refine_path (the whole
    refinement in its library) on the CLI demo path; its
    demo solves at seeds 0-3 under 'auto' and 'cuda_rng' equal [5]'s and
    [6]'s field for field, seed 0's path to the bit; (b) new dynamics, the
    damped double integrator ``drift`` with its struct and torch hooks: B1,
    B2, B6 and B6 Philox bitwise its twin (its struct has no back(): its
    refine_path raises, naming the hook); KGMTConfig(system="drift") on
    the demo, seeds 0-3, both backends, every path replayed with error 0;
    MultiQueryPlanner on the CLI multi default's 64 pairs; (c) the same
    dynamics without a struct: under 'auto' the generic rollout (metrics
    say so, no kernel launch) equal to (b)'s seed-0 solve; under 'cuda' it
    raises. Each user library's nvcc seconds (first build, beside the
    package's) and cached load, its registers, and device ms of the user
    kernels beside their built-in twins at the same shapes;
35. the threefry kernel (csrc/threefry.cu, every threefry draw of rng.py on
    a CUDA key): each mode bitwise its torch twin on the same CUDA tensors
    at the demo's wave (one key, 4,096 lanes) and the fleet's trip (64
    keys, 64 x 4,096): the wave's keys, controls and acceptance uniforms,
    fold_in with int and tensor data, split, random_bits and uniform from
    offsets past 2^32, uniform where max(lo, ...) binds, one launch each;
    device ms a launch of the wave's three draws at both shapes beside the
    twin's, and their bounds. Its main-path launches are the ones counted
    in [5] and [22] (three a wave or trip: the wave's keys, controls and
    acceptance uniforms; under cuda_rng two, B2 drawing the controls; one
    fold_in a batch) and, on each rank, in [33].

Then the card's name and power limit, a JSON line of the kernels and,
last, {"ok": true, "device": {...}}. Each kernel entry has its device
time, its plain twin's, both also by CUDA events, the regular profiler
windows each device time is the median of (``regular_windows``,
``plain_regular_windows``; probes/timing.py), and its bound: the larger
of the bytes it must move over 3.35 TB/s and its f32 operations over 67
TFLOP/s (probes/roofline.py; the threefry row: its integer instructions
at 4 warp-instructions a clock an SM, ``threefry_bound_ms``); the rollout rows also the one-warp floor
(``floor_ms``, 32 lanes at the row's G) and, for B1-B4 and B6, the G
their main path ran at (``split``). A line before the JSON flags every
time read from fewer than MIN_REGULAR regular windows; a rollout row that
reads below its floor by more than FLOOR_SLACK fails. Any failed check
raises: the script exits non-zero and prints no result. The full record
also goes to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import math
from collections import Counter
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch

B_CHECK = 2 ** 17
SEEDS = range(4)
OPTION_SEEDS = range(8)
SYSTEMS = ("bicycle", "point2d", "double_integrator", "unicycle", "dubins")
FOOTPRINT = (0.5, 0.25)  # half extents of a 1.0 x 0.5 body
ATOL = 1e-3  # x1 allclose: |kernel - plain| <= ATOL + RTOL * |plain|
RTOL = 1e-5  # (theta grows large where tan(steering) does: ulps scale with it)
MISMATCH_FRACTION = 1e-4  # valid-mask disagreements allowed, all near an edge
EDGE = 1e-4  # how near an edge a disagreeing lane must pass
ROOT = pathlib.Path(__file__).resolve().parent
# the arena and sweep settings of bench.py:317-320, 412-413 and 454-455
SWEEP = dict(rollouts_per_iter=128, num_iterations=150, adaptive_waves=False)
ARENA_B = 256  # BASELINE config 4
MC_N = 1024  # BASELINE config 5 per chip
STREAM_N, STREAM_POOL = 4096, 1024  # bench.py's streaming sweep
CHECK_N, CHECK_POOL = 256, 64  # the invariance checks
SWEEP_SHAPE = (1024, 128, 8)  # B6's timing shape: problems, lanes, boxes
SPLIT_WIDTHS = (1024, 2048, 4096, 8192, 16_384, 32_768, B_CHECK)  # the per-G table's lanes
# problems of R=128 in the arena's and the Monte-Carlo sweep's extension
# rounds (a bucket is a power of two, at least 8: batch_kgmt.py::_extend)
EXTENSION_BUCKETS = (8, 64)
RAGGED = (33, 4097)  # lanes past R inside a thread group's warp
BOX_COUNTS = (1, 5, 8, 9, 40)  # K around the one-thread walk's passes of 4 boxes
PROBLEM_LANES = (1, 127, 128, 129, 512)  # B6's R around one 128-lane warp group
FLOOR_LANES = 32  # a launch and one rollout's chain (one warp at G = 1)
# a rollout row may read this far below its floor (the spread of one
# kernel's readings within a call is under 2%: PERF.md); further fails
FLOOR_SLACK = 0.05
MIN_REGULAR = 3  # regular profiler windows a time should be the median of
# calls a profiler window of a plain version holds: its thousands of records
# a call would otherwise fill the profiler's buffers mid-window, where the
# profiler loses records (PERF.md)
PLAIN_CALLS = 2
# P1a's and P2's ragged inputs: 7 programs of 37 rows x 128 (33,152
# elements, not a whole round of a P1a grid) and 1,003 rows of idx (not a
# multiple of the rows a P2 block holds)
RAGGED_PROGRAMS, RAGGED_PROGRAM_ROWS, RAGGED_IDX_ROWS = 7, 37, 1003
WINDOWS = (1, 2, 4, 5)  # B5's step windows, as tools/r4_cull_bench.py
CUT_STEPS = 25  # past B5's cap of steps a window: W = 1 runs as 3 windows
PROBE_LANES = 524_288  # the CostProp probe's width (CostPropPlanner.cu:85-88)
MULTI_B = 64  # the CLI's multi and sweep batches (cudasbmp_tpu/cli.py:236, 246)
MC_VMAP_N = 64
BENCH_VMAP_B = 256  # bench.py's vmap batch (bench.py:324-329)
QUALITY_B, QUALITY_R = 128, 1024  # tools/r5_quality_pipeline.py's arena
SHORTCUT_CANDIDATES = 256  # ShortcutConfig().candidates
# B6's shapes on the new paths: the CLI's multi, bench.py's vmap shape and
# the quality pipeline's shortcut rounds (problems, lanes)
MULTI_SHAPES = ((MULTI_B, 4096), (BENCH_VMAP_B, 2048), (QUALITY_B, SHORTCUT_CANDIDATES))
# R1 against its twin: (edges, steps an edge), T = 1 to 1,510 points; the
# penalty within R1_RTOL (positive terms summed in another order), the
# gradient within R1_GRAD_RTOL of its norm (the reverse sweep accumulates in
# another order than autograd)
R1_SHAPES = ((1, 1), (1, 10), (6, 10), (151, 10))
R1_RTOL, R1_GRAD_RTOL = 1e-5, 1e-4
# the whole refinement against its twin: tests/test_torch_refine.py's
# tolerances (controls rtol and atol, the first two losses rtol) at 3 steps
ADAM_TWIN_TOL, ADAM_TWIN_STEPS = 1e-5, 3
ADAM_ROW_STEPS = 10  # the kernels line's ms, plain_ms and bound_ms: Adam steps
# [35]'s shapes: (keys, lanes) of the demo's wave and of the fleet's trip
TF_SHAPES = {"demo": (1, 4096), "fleet": (MULTI_B, 4096)}
TF_SEED = 2**32 - 12345  # a large seed: its key's second word past 2^31


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def demo_batch(B: int, seed: int, dev):
    """Parents spread over the free demo workspace, controls uniform in the
    bicycle's control box, from a seeded numpy generator."""
    from cudasbmp_torch.config import Scenario

    r = np.random.default_rng(seed)
    xy = r.uniform(0.05, 19.95, size=(4 * B, 2))
    free = np.ones(len(xy), bool)
    for x0, y0, x1, y1 in Scenario.demo().obstacles:
        free &= ~((xy[:, 0] > x0) & (xy[:, 0] < x1)
                  & (xy[:, 1] > y0) & (xy[:, 1] < y1))
    xy = xy[free][:B]
    x0 = np.concatenate([xy, r.uniform(-np.pi, np.pi, (B, 1)),
                         r.uniform(-3, 3, (B, 1))], -1).astype(np.float32)
    ctrl = np.stack([r.uniform(-5, 5, B), r.uniform(-np.pi, np.pi, B),
                     r.uniform(0.05, 1.05, B)], -1).astype(np.float32)
    return torch.tensor(x0, device=dev), torch.tensor(ctrl, device=dev)


def edge_margin(system, x0, ctrl, obstacles, cfg) -> torch.Tensor:
    """Per lane, how near its unfrozen plain trajectory passes to a workspace
    bound or to touching an obstacle, over all steps: the smallest slack of
    the tests rollout_batch makes."""
    o = obstacles[(obstacles[:, 2] >= obstacles[:, 0])
                  & (obstacles[:, 3] >= obstacles[:, 1])]  # drop padding rows
    dt = ctrl[:, -1] / cfg.num_disc
    state = x0
    margin = torch.full((x0.shape[0],), float("inf"), device=x0.device)
    for _ in range(cfg.num_disc):
        cand = system.step(state, ctrl[:, :-1], dt)
        nx, ny = cand[:, 0], cand[:, 1]
        bounds = torch.stack([nx, cfg.width - nx, ny, cfg.height - ny]).abs().amin(0)
        lo = torch.minimum(state[:, :2], cand[:, :2])
        hi = torch.maximum(state[:, :2], cand[:, :2])
        slack = torch.stack([o[None, :, 0] - hi[:, None, 0], lo[:, None, 0] - o[None, :, 2],
                             o[None, :, 1] - hi[:, None, 1], lo[:, None, 1] - o[None, :, 3]])
        obs_m = slack.amax(0).abs().amin(1)  # separation slack per obstacle
        margin = torch.minimum(margin, torch.minimum(bounds, obs_m))
        state = cand
    return margin


def compare(name, system, x0, ctrl, obstacles, cfg, x1, valid, px1, pvalid) -> dict:
    """Hold a kernel's (x1, valid) against its plain version's."""
    mismatch = valid != pvalid
    n_mis = int(mismatch.sum())
    check(n_mis <= MISMATCH_FRACTION * len(valid),
          f"{name}: {n_mis} valid-mask mismatches of {len(valid)}")
    if n_mis:
        m = edge_margin(system, x0[mismatch], ctrl[mismatch], obstacles, cfg)
        check(bool((m <= EDGE).all()),
              f"{name}: mismatched lanes pass {float(m.max())} from every edge")
    diff = (x1 - px1).abs()
    err = float(diff.max())
    col_err = diff.amax(0).tolist()
    bitwise = float((x1.view(torch.int32) == px1.view(torch.int32)).all(1)
                    .float().mean())
    out = {"mismatches": n_mis, "max_abs_err": err, "max_abs_err_xyzv": col_err,
           "bitwise_rows": bitwise, "valid_fraction": float(valid.float().mean())}
    check(torch.isfinite(x1).all().item(), f"{name}: non-finite x1")
    check(torch.allclose(x1, px1, rtol=RTOL, atol=ATOL),
          f"{name}: x1 not within atol {ATOL} + rtol {RTOL} of the plain version")
    return out


def device_time(fn, n: int | None = None, required: bool = True):
    """probes/timing.py's Timing of ``fn`` over windows of ``n`` calls (20 by
    default), profiled again with more windows where none was regular;
    where still none is, fails if ``required`` (a kernel's time: there is
    none to report), else returns the Timing without a time."""
    from cudasbmp_torch.probes import timing

    n = timing.TIMED if n is None else n
    t = timing.device_ms(fn, n)
    if not t.regular:
        t = timing.device_ms(fn, n, tries=24)
    check(t.regular > 0 or not required, f"no regular profiler window in "
          f"{t.windows}: {timing.IRREGULAR_WINDOWS[-3:]}")
    return t


def timed(out: dict, name: str, fn, n: int | None = None, plain: bool = False) -> None:
    """out[name_ms]: device ms per call of ``fn`` (``device_time``), with
    out[name_regular] its regular windows and out[name_by] "device";
    out[name_launch_ms]: CUDA-event ms per call, which the host's launch
    rate may set. A plain version (``plain``) whose windows are never
    regular (the profiler lost a record in each) gets its CUDA-event time
    as out[name_ms] instead, out[name_by] "events", out[name_regular] 0."""
    from cudasbmp_torch.probes import timing

    n = timing.TIMED if n is None else n
    t = device_time(fn, n, required=not plain)
    launch = timing.time_ms(fn, n)
    out[f"{name}_ms"] = t.ms if t.regular else launch
    out[f"{name}_by"] = "device" if t.regular else "events"
    out[f"{name}_regular"], out[f"{name}_launch_ms"] = t.regular, launch


def expected_waves(cfg, metrics) -> int:
    """Waves the flat loop runs: per iteration ceil(min(fanout * frontier,
    M - tree size at its start) / R)."""
    ts_start = np.concatenate([[1], metrics["tree_size"][:-1]])
    n_tgt = np.minimum(cfg.fanout * metrics["frontier_size"],
                       cfg.max_tree_size - ts_start)
    if not cfg.adaptive_waves:
        return int(np.minimum(n_tgt, 1).sum())
    return int((-(-n_tgt // cfg.rollouts_per_iter)).sum())


def solve_seeds(cfg, dev, replay: bool, seeds=SEEDS, scenario=None,
                min_rate: float = 1.0) -> tuple[dict, list]:
    """Plan the scenario (the demo by default) for every seed; check each
    result (finite, a solved path replays valid through the plain exact
    rollout and ends in the goal region); fail below ``min_rate`` solved.
    Returns a summary and the per-seed records."""
    from cudasbmp_torch import KGMT, Scenario
    from cudasbmp_torch.ops.rollout import rollout_batch

    planner = KGMT(cfg, device=dev)
    sc = scenario or Scenario.demo()
    warm = planner.plan(sc, seed=100)  # warm-up: kernel load, allocator, caches
    obstacles = torch.tensor(sc.obstacles, device=dev)
    rows, waves = [], expected_waves(cfg, warm.metrics)
    what = f"{cfg.system}/{cfg.rollout_backend}/need_path={cfg.need_path}"
    for seed in seeds:
        r = planner.plan(sc, seed=seed)
        check(r.iterations <= cfg.num_iterations and 1 <= r.tree_size
              <= cfg.max_tree_size, f"{what}: seed {seed}: {r.iterations} "
              f"iterations, tree size {r.tree_size}")
        check(not r.solved or (math.isfinite(r.cost) and r.cost > 0),
              f"{what}: seed {seed}: cost {r.cost}")
        waves += expected_waves(cfg, r.metrics)
        if replay and r.solved:
            p = torch.tensor(r.path, device=dev)
            check(p.shape[0] >= 2 and p.shape[1] == 7,
                  f"{what}: seed {seed}: path shape {tuple(p.shape)}")
            check(bool(torch.isfinite(p).all()), f"{what}: seed {seed}: non-finite path")
            x1, valid = rollout_batch(planner.system, p[:-1, :4].contiguous(),
                                      p[1:, 4:].contiguous(), cfg.num_disc,
                                      obstacles, cfg.width, cfg.height,
                                      footprint=cfg.footprint)
            # fast math accepts edges by the rotation recurrence; the exact
            # replay may disagree on a boundary-grazing edge (JAX config note)
            check(bool(valid.all()) or cfg.fast_math,
                  f"{what}: seed {seed}: path edge invalid on replay")
            err = float((x1 - p[1:, :4]).abs().max())
            check(err <= (5e-2 if cfg.fast_math else ATOL),
                  f"{what}: seed {seed}: replay error {err}")
            gx, gy = r.path[-1, 0] - sc.goal[0], r.path[-1, 1] - sc.goal[1]
            check(math.hypot(gx, gy) < cfg.goal_threshold,
                  f"{what}: seed {seed}: off goal")
        rows.append({"seed": seed, "solved": r.solved, "cost": r.cost,
                     "iterations": r.iterations, "tree_size": r.tree_size,
                     "wall_s": r.wall_time_s})
    solved = [x for x in rows if x["solved"]]
    rate = len(solved) / len(rows)
    check(rate >= min_rate, f"{what}: solve rate {rate} < {min_rate}")
    def pct(key: str, q: float) -> float:
        return float(np.percentile([x[key] for x in solved], q)) if solved else math.inf

    summary = {"solve_rate": rate, "cost_p50": pct("cost", 50),
               "cost_p90": pct("cost", 90), "tts_p50_s": pct("wall_s", 50),
               "tts_p90_s": pct("wall_s", 90), "waves": waves}
    return summary, rows

def system_batch(name: str, B: int, seed: int, dev):
    """(system, x0, controls): parents over the demo workspace (headings and
    speeds where the system has them), controls uniform in its box."""
    from cudasbmp_torch.systems import get_system

    r = np.random.default_rng(seed)
    system = get_system(name)
    spec = system.control_spec
    x0 = np.zeros((B, 4), np.float32)
    x0[:, 0] = r.uniform(0.5, 19.5, B)
    x0[:, 1] = r.uniform(0.5, 19.5, B)
    if name != "point2d":
        x0[:, 2] = r.uniform(-np.pi, np.pi, B)
    if name in ("bicycle", "double_integrator"):
        x0[:, 3] = r.uniform(-3, 3, B)
    u = r.uniform(0, 1, (B, spec.dim))
    c = np.asarray(spec.lo) + u * (np.asarray(spec.hi) - np.asarray(spec.lo))
    return (system, torch.tensor(x0, device=dev),
            torch.tensor(c.astype(np.float32), device=dev))


def bitwise(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def threefry_launches(tfc) -> dict:
    """The threefry wrappers' launches since their last reset, those that
    launched (ops/threefry_cuda.py)."""
    return {w.__name__: w.launches for w in tfc.WRAPPERS if w.launches}


def check_against_twins(name, system, x0, c, obstacles, key, kw,
                        splits=(None,)) -> dict:
    """B1 and B2 with the options in ``kw`` against their plain twins on the
    card, at each G of ``splits`` (None: the rule's): bitwise states, equal
    masks, bitwise B2 controls."""
    from cudasbmp_torch.ops import rollout_cuda as rc

    px1, pvalid = rc.rollout_soa(system, x0, c, obstacles, **kw)
    ty1, tc2, tv2 = rc.sample_and_rollout_torch(system, key, x0, obstacles, **kw)
    err = 0.0
    for G in splits:
        x1, valid = rc.rollout_cuda(system, x0, c, obstacles, **kw, split=G)
        y1, c2, v2 = rc.sample_and_rollout_cuda(system, key, x0, obstacles, **kw, split=G)
        torch.cuda.synchronize()
        check(torch.equal(valid, pvalid) and bitwise(x1, px1),
              f"B1 {name} {kw} G={G}: {int((valid != pvalid).sum())} mask mismatches, "
              f"max |dx1| {float((x1 - px1).abs().max())}")
        check(bitwise(c2, tc2) and torch.equal(v2, tv2) and bitwise(y1, ty1),
              f"B2 {name} {kw} G={G}: differs from its twin")
        check(bool(torch.isfinite(x1).all()), f"B1 {name} {kw}: non-finite x1")
        err = max(err, float((x1 - px1).abs().max()), float((y1 - ty1).abs().max()))
    return {"max_abs_err": err, "valid_fraction": float(pvalid.float().mean())}


def check_instantiations(dev, obstacles, kw) -> dict:
    """Phase 8: every (system, footprint, fast math) instantiation of B1 and
    B2 against its twin at the rule's G and at every forced G, at R in
    {33, 4,096, 4,097, 2^17} and K in BOX_COUNTS (the demo's 8 boxes, else
    the first K of dense-40); kernel and twin ms of B3
    (bicycle + footprint) and B4 (and fast math) at B=4096, the width of
    their main path, and at B=2^17 for bicycle+footprint+fast and
    dubins+footprint."""
    from cudasbmp_torch import rng
    from cudasbmp_torch.config import Scenario
    from cudasbmp_torch.ops import rollout_cuda as rc

    key = rng.key(777, dev)
    forty = torch.tensor(Scenario.dense(40, seed=0).padded_obstacles(64)[0], device=dev)
    out = {"checks": {}, "times": {}}
    for i, name in enumerate(SYSTEMS):
        for R in (RAGGED[0], 4096, RAGGED[1], B_CHECK):
            system, x0, c = system_batch(name, R, 50 + i, dev)
            for K, obs in ((K, obstacles if K == obstacles.shape[0] else forty[:K])
                           for K in BOX_COUNTS):
                for fp in (None, FOOTPRINT):
                    for fast in (False, True):
                        opts = dict(kw, footprint=fp, fast_math=fast)
                        tag = (f"{name}/{'footprint' if fp else 'broad'}/"
                               f"{'fast' if fast else 'exact'}/R={R}/K={K}")
                        out["checks"][tag] = check_against_twins(
                            name, system, x0, c, obs, key, opts, (None, *rc.SPLITS))
    for tag, name, fast, B in (("b3_4096", "bicycle", False, 4096),
                               ("b4_4096", "bicycle", True, 4096),
                               ("bicycle/footprint/fast", "bicycle", True, B_CHECK),
                               ("dubins/footprint/exact", "dubins", False, B_CHECK)):
        system, x0, c = system_batch(name, B, 60, dev)
        opts = dict(kw, footprint=FOOTPRINT, fast_math=fast)
        t = out["times"][tag] = {}
        timed(t, "kernel", lambda: rc.rollout_cuda(system, x0, c, obstacles, **opts))
        timed(t, "plain", lambda: rc.rollout_soa(system, x0, c, obstacles, **opts),
              PLAIN_CALLS, plain=True)
        t["valid_fraction"] = float(rc.rollout_cuda(system, x0, c, obstacles,
                                                    **opts)[1].float().mean())
    return out


def split_table(dev, obstacles, kw) -> dict:
    """Phase 7's per-G table: device ms of B1, exact and with the footprint,
    at every forced G and each of SPLIT_WIDTHS demo lanes (K=8), beside the
    G the rule picks there."""
    from cudasbmp_torch.ops import rollout_cuda as rc
    from cudasbmp_torch.systems.bicycle import KinematicBicycle

    system, out = KinematicBicycle(), {}
    for B in SPLIT_WIDTHS:
        x0, ctrl = demo_batch(B, 1, dev)
        row = out[str(B)] = {"rule": rc.lanes_per_rollout(B, rc.sm_count(dev.index or 0))}
        for tag, opts in (("exact", kw), ("footprint", dict(kw, footprint=FOOTPRINT))):
            for G in rc.SPLITS:
                t = device_time(
                    lambda: rc.rollout_cuda(system, x0, ctrl, obstacles, **opts, split=G))
                row[f"{tag}_g{G}_ms"], row[f"{tag}_g{G}_regular"] = t.ms, t.regular
    return out


def floors(dev, obstacles, kw, G: int) -> dict:
    """Phase 7's one-warp floors: device ms of each rollout row's kernel at
    FLOOR_LANES lanes, a launch and one rollout's chain, at the G its row
    runs at: B1, B2, B3 (bicycle + footprint) and B4 (and fast math) at
    ``G`` (the demo's), both B6 forms (one problem of 32 lanes) at G = 1,
    and B5 (B2 with cull=4 on dense-24) on the first 32 of its row's
    Morton-grouped starts, a warp as near together as the row's. With
    ``<row>_regular`` the regular windows of each."""
    from cudasbmp_torch import rng
    from cudasbmp_torch.config import Scenario
    from cudasbmp_torch.ops import rollout_cuda as rc
    from cudasbmp_torch.probes import throughput as tp
    from cudasbmp_torch.systems.bicycle import KinematicBicycle

    system, key = KinematicBicycle(), rng.key(32, dev)
    x0, ctrl = demo_batch(FLOOR_LANES, 2, dev)
    fp = dict(kw, footprint=FOOTPRINT, split=G)
    demo = dict(kw, split=G)
    one = dict(kw, split=1)
    bx0, bc, bobs = x0[None], ctrl[None], obstacles[None].contiguous()
    dense = torch.tensor(Scenario.dense(24).obstacles, device=dev)
    near = tp.start_states(B_CHECK, dev, grouped=True)[:FLOOR_LANES].contiguous()
    runs = {"b1": lambda: rc.rollout_cuda(system, x0, ctrl, obstacles, **demo),
            "b2": lambda: rc.sample_and_rollout_cuda(system, key, x0, obstacles, **demo),
            "b3": lambda: rc.rollout_cuda(system, x0, ctrl, obstacles, **fp),
            "b4": lambda: rc.rollout_cuda(system, x0, ctrl, obstacles, **fp,
                                          fast_math=True),
            "b6": lambda: rc.rollout_batched_cuda(system, bx0, bc, bobs, **one),
            "b6_rng": lambda: rc.sample_and_rollout_batched_cuda(
                system, key[None], bx0, bobs, **one),
            "b5": lambda: rc.sample_and_rollout_cuda(system, key, near, dense, **kw,
                                                     cull=4)}
    out = {}
    for k, fn in runs.items():
        t = device_time(fn)
        out[f"{k}_ms"], out[f"{k}_regular"] = t.ms, t.regular
    return out


def check_many_boxes(dev, kw) -> dict:
    """Phase 9: 40 boxes, max_obstacles=64. The kernels once held at most
    32 boxes in a static shared array; now the block's dynamic shared memory
    holds them. B1/B2 against their twins (broad and footprint), then a
    demo-width solve whose every wave goes through B1."""
    from cudasbmp_torch import KGMTConfig, Scenario, rng
    from cudasbmp_torch.ops import rollout_cuda as rc

    sc = Scenario.dense(40, seed=0)
    obstacles = torch.tensor(sc.padded_obstacles(64)[0], device=dev)
    check(obstacles.shape == (40, 4), f"40-box scenario: {tuple(obstacles.shape)}")
    system, x0, c = system_batch("bicycle", 4096, 70, dev)
    errs = [check_against_twins("bicycle", system, x0, c, obstacles, rng.key(3, dev),
                                dict(kw, footprint=fp))["max_abs_err"]
            for fp in (None, FOOTPRINT)]
    cfg = KGMTConfig(max_obstacles=64)
    rc.reset_launch_counts()
    summary, rows = solve_seeds(cfg, dev, replay=True, scenario=sc)
    check(rc.rollout_cuda.launches == summary["waves"],
          f"40 boxes: B1 launches {rc.rollout_cuda.launches} for {summary['waves']} waves")
    return {**summary, "seeds": rows, "b1_launches": rc.rollout_cuda.launches,
            "max_abs_err": max(errs), "limit": rc.max_kernel_obstacles(dev.index or 0)}


def solve_all_options(dev) -> dict:
    """Phase 10: the bicycle with every option at the demo width; the main
    path of this phase's kernels (B3, B4). Counts are zeroed before each
    mode and read after it."""
    from cudasbmp_torch import KGMT, KGMTConfig, Scenario
    from cudasbmp_torch.ops import rollout_cuda as rc
    from cudasbmp_torch.planners import kgmt as tk

    cfg = KGMTConfig(footprint_width=0.5, fast_math=True, goal_bias=0.25)
    out = {}
    for mode, c, seeds in (("tree_auto", cfg, OPTION_SEEDS),
                           ("pathless_auto", cfg.replace(need_path=False), OPTION_SEEDS),
                           ("tree_cuda_rng", cfg.replace(rollout_backend="cuda_rng"), SEEDS)):
        rc.reset_launch_counts()
        summary, rows = solve_seeds(c, dev, replay=c.need_path, seeds=seeds)
        launches = rc.rollout_cuda.launches + rc.sample_and_rollout_cuda.launches
        inst = rc.rollout_cuda.instantiations + rc.sample_and_rollout_cuda.instantiations
        splits = rc.rollout_cuda.splits + rc.sample_and_rollout_cuda.splits
        G = rc.lanes_per_rollout(c.rollouts_per_iter, rc.sm_count(dev.index or 0))
        check(launches == summary["waves"]
              and inst[("bicycle", True, True)] == launches and splits == {G: launches},
              f"all options {mode}: {dict(inst)} at G {dict(splits)} for "
              f"{summary['waves']} waves")
        out[mode] = {**summary, "seeds": rows, "launches": launches, "split": G}

    def solve(c):
        r = KGMT(c, device=dev).plan(Scenario.demo(), seed=0)
        return [r.solved, r.iterations, r.tree_size, r.cost]

    kernel = solve(cfg)
    saved = tk.rollout_cuda
    tk.rollout_cuda = rc.rollout_soa  # the kernel's plain twin, on the card
    try:
        twin = solve(cfg)
    finally:
        tk.rollout_cuda = saved
    exact = cfg.replace(fast_math=False)
    exact_auto, exact_torch = solve(exact), solve(exact.replace(rollout_backend="torch"))
    check(kernel == twin, f"all options seed 0: kernel {kernel} != twin {twin}")
    check(exact_auto == exact_torch,
          f"footprint + goal bias seed 0: auto {exact_auto} != torch {exact_torch}")
    out["identity_seed0"] = {"kernel": kernel, "twin_on_card": twin,
                             "exact_auto": exact_auto, "exact_torch": exact_torch}
    return out


def solve_other_systems(dev) -> dict:
    """Phase 11: the shipped unicycle and dubins configs and the two point
    systems at default widths, seeds 0-3, every wave through B1 with the
    system's own instantiation. dubins.yaml keeps adaptive waves, with which
    the demo's 30k-node tree fills before the goal on the CPU too; it also
    runs without them, as the JAX package's dubins test does."""
    from cudasbmp_torch import KGMTConfig
    from cudasbmp_torch.ops import rollout_cuda as rc

    dubins = KGMTConfig.from_file(str(ROOT / "systems" / "dubins.yaml"))
    cases = (("unicycle.yaml", KGMTConfig.from_file(str(ROOT / "systems" / "unicycle.yaml")), 0.75),
             ("dubins.yaml", dubins, 0.0),
             ("dubins.yaml --no-adaptive-waves", dubins.replace(adaptive_waves=False), 0.5),
             ("point2d", KGMTConfig(system="point2d"), 0.75),
             ("double_integrator", KGMTConfig(system="double_integrator"), 0.75))
    out = {}
    for tag, cfg, min_rate in cases:
        rc.reset_launch_counts()
        summary, rows = solve_seeds(cfg, dev, replay=True, min_rate=min_rate)
        inst = dict(rc.rollout_cuda.instantiations)
        G = rc.lanes_per_rollout(cfg.rollouts_per_iter, rc.sm_count(dev.index or 0))
        check(rc.rollout_cuda.launches == summary["waves"]
              and inst == {(cfg.system, False, False): summary["waves"]}
              and rc.rollout_cuda.splits == {G: summary["waves"]},
              f"{tag}: launches {inst} at G {dict(rc.rollout_cuda.splits)} for "
              f"{summary['waves']} waves")
        out[tag] = {**summary, "seeds": rows, "b1_launches": rc.rollout_cuda.launches}
    return out


def run_cli(out_dir: pathlib.Path) -> dict:
    """Phase 12: the port's CLI as a user starts it, on the card."""
    runs = {
        "demo": ["demo", "--device", "cuda", "--footprint-width", "0.5",
                 "--fast-math", "--goal-bias", "0.25"],
        "plan": ["plan", "--configurations", "configurations", "--config",
                 "systems/car.yaml", "--device", "cuda", "--out-dir",
                 str(out_dir / "artifacts")],
    }
    out = {}
    for tag, args in runs.items():
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "cudasbmp_torch.cli", *args],
                           cwd=ROOT, capture_output=True, text=True, timeout=300)
        lines = p.stdout.splitlines()
        check(p.returncode == 0, f"cli {tag}: exit {p.returncode}\n{p.stdout[-2000:]}"
              f"\n{p.stderr[-2000:]}")
        check(len(lines) > 3 and lines[0].startswith("Goal: ")
              and lines[1].startswith("time inside KGMT is ")
              and re.fullmatch(r"Iteration \d+, Tree size \d+", lines[2]) is not None,
              f"cli {tag}: parity lines {lines[:3]}")
        body = p.stdout[p.stdout.index("{\n"):p.stdout.index("\n}") + 2]
        summary = json.loads(body)
        check(summary["solved"] is True, f"cli {tag}: {summary}")
        out[tag] = {"seconds": time.perf_counter() - t0, "lines": lines[:3],
                    "summary": summary}
    n_csv = len(list((out_dir / "artifacts").glob("*.csv")))
    check(n_csv == 13, f"cli plan: {n_csv} artifact CSVs")
    return out


def problem_batch(name: str, B: int, R: int, K: int, seed: int, dev, padding: int = 2):
    """(system, x0 [B, R, 4], controls [B, R, 3], obstacles [B, K, 4]): a
    distinct random box field per problem, its last ``padding`` rows
    padding boxes."""
    system, x0, c = system_batch(name, B * R, seed, dev)
    r = np.random.default_rng(seed + 1000)
    lo = r.uniform(0.0, 17.0, (B, K, 2))
    boxes = np.concatenate([lo, lo + r.uniform(0.5, 3.0, (B, K, 2))], -1)
    boxes[:, K - padding:] = (1.0, 1.0, 0.0, 0.0)
    return (system, x0.reshape(B, R, 4), c.reshape(B, R, -1),
            torch.tensor(boxes.astype(np.float32), device=dev))


def check_b6(dev, kw) -> dict:
    """Phase 13: both forms of B6 in every instantiation against their
    plain twins (bitwise) at B=8 x R=512, at the extension rounds' buckets
    (EXTENSION_BUCKETS x R=128) and at the sweeps' launch shape
    (SWEEP_SHAPE, one block per problem at G = 1), each at the rule's G and
    at every forced G; at 8 problems of each R in PROBLEM_LANES with each K
    in BOX_COUNTS, at the rule's G and G = 1 (the one-thread walk); then at
    70,000 problems (more than a grid's y extent) at the rule's G and G = 8;
    the isolation and key checks; times at the sweeps' shape."""
    from cudasbmp_torch import rng
    from cudasbmp_torch.ops import rollout_cuda as rc

    out = {"checks": {}, "times": {}}
    errs = []

    def against_twins(tag, system, x0, c, obs, keys, opts,
                      splits=(None, *rc.SPLITS)) -> None:
        px1, pvalid = rc.rollout_soa(system, x0, c, obs, **opts)
        ty1, tc2, tv2 = rc.sample_and_rollout_torch(system, keys, x0, obs, **opts)
        for G in splits:
            x1, valid = rc.rollout_batched_cuda(system, x0, c, obs, **opts, split=G)
            y1, c2, v2 = rc.sample_and_rollout_batched_cuda(system, keys, x0, obs,
                                                            **opts, split=G)
            torch.cuda.synchronize()
            check(torch.equal(valid, pvalid) and bitwise(x1, px1),
                  f"B6 {tag} G={G}: {int((valid != pvalid).sum())} mask mismatches")
            check(bitwise(c2, tc2) and torch.equal(v2, tv2) and bitwise(y1, ty1),
                  f"B6 Philox {tag} G={G}: differs from its twin")
            check(bool(torch.isfinite(x1).all()), f"B6 {tag}: non-finite x1")
            errs.append(max(float((x1 - px1).abs().max()), float((y1 - ty1).abs().max())))
        out["checks"][tag] = {"max_abs_err": max(errs[-len(splits):]),
                              "valid_fraction": float(pvalid.float().mean())}

    for nb, nr, nk in ((8, 512, 8), *((b, 128, 8) for b in EXTENSION_BUCKETS),
                       SWEEP_SHAPE):
        for i, name in enumerate(SYSTEMS):
            system, x0, c, obs = problem_batch(name, nb, nr, nk, 80 + i, dev)
            keys = rng.split(rng.key(90 + i, dev), nb)
            for fp in (None, FOOTPRINT):
                for fast in (False, True):
                    tag = (f"{nb}x{nr}/{name}/{'footprint' if fp else 'broad'}/"
                           f"{'fast' if fast else 'exact'}")
                    against_twins(tag, system, x0, c, obs, keys,
                                  dict(kw, footprint=fp, fast_math=fast))
    for K in BOX_COUNTS:
        for R in PROBLEM_LANES:
            for i, name in enumerate(SYSTEMS):
                system, x0, c, obs = problem_batch(name, 8, R, K, 60 + K + i, dev,
                                                   padding=min(2, K - 1))
                keys = rng.split(rng.key(K * R + i, dev), 8)
                for fp in (None, FOOTPRINT):
                    for fast in (False, True):
                        tag = (f"8x{R}/K={K}/{name}/{'footprint' if fp else 'broad'}/"
                               f"{'fast' if fast else 'exact'}")
                        against_twins(tag, system, x0, c, obs, keys,
                                      dict(kw, footprint=fp, fast_math=fast), (None, 1))
    system, x0, c, obs = problem_batch("bicycle", 70_000, 2, 4, 97, dev)
    against_twins("70000x2/bicycle/broad/exact", system, x0, c, obs,
                  rng.split(rng.key(96, dev), 70_000), kw, (None, 8))
    # isolation: a wall in problem 1 changes problem 1's lanes only
    system, x0, c, obs = problem_batch("bicycle", 8, 512, 8, 99, dev)
    x1, valid = rc.rollout_batched_cuda(system, x0, c, obs, **kw)
    walled = obs.clone()
    walled[1, -1] = torch.tensor([0.0, 9.0, 20.0, 11.0], device=dev)
    wx1, wvalid = rc.rollout_batched_cuda(system, x0, c, walled, **kw)
    others = [b for b in range(8) if b != 1]
    check(torch.equal(wvalid[others], valid[others]) and bitwise(wx1[others], x1[others])
          and bool((wvalid[1] != valid[1]).any()), "B6: the wall leaked across problems")
    # keys: the same key gives the same rows at B=4 and at B=8 in another slot
    keys = rng.split(rng.key(7, dev), 8)
    _, c8, v8 = rc.sample_and_rollout_batched_cuda(system, keys, x0, obs, **kw)
    perm = [5, 1, 7, 2]
    _, c4, v4 = rc.sample_and_rollout_batched_cuda(system, keys[perm].contiguous(),
                                                   x0[perm].contiguous(),
                                                   obs[perm].contiguous(), **kw)
    check(bitwise(c4, c8[perm]) and torch.equal(v4, v8[perm]),
          "B6 Philox: a problem's draws depend on its slot or on B")
    out["isolation"] = {"lanes_changed_in_problem_1": int((wvalid[1] != valid[1]).sum())}
    # times at the sweeps' shape: B=1024 problems x R=128 lanes x K=8 boxes
    nb, nr, nk = SWEEP_SHAPE
    system, x0, c, obs = problem_batch("bicycle", nb, nr, nk, 98, dev)
    keys = rng.split(rng.key(8, dev), nb)
    flat_x0, flat_c = x0.reshape(-1, 4), c.reshape(-1, 3)
    t = out["times"]
    timed(t, "b6", lambda: rc.rollout_batched_cuda(system, x0, c, obs, **kw))
    timed(t, "plain", lambda: rc.rollout_soa(system, x0, c, obs, **kw), PLAIN_CALLS, plain=True)
    timed(t, "b6_rng", lambda: rc.sample_and_rollout_batched_cuda(system, keys, x0, obs,
                                                                  **kw))
    timed(t, "rng_plain", lambda: rc.sample_and_rollout_torch(system, keys, x0, obs, **kw),
          PLAIN_CALLS, plain=True)
    timed(t, "b1_same_lanes_shared_boxes",
          lambda: rc.rollout_cuda(system, flat_x0, flat_c, obs[0], **kw))
    t["valid_fraction"] = float(rc.rollout_batched_cuda(system, x0, c, obs, **kw)[1]
                                .float().mean())
    out["max_abs_err"] = max(errs)
    return out


def culled_field(K: int, dev):
    """Phase 18's fields: Scenario.dense(K) (padded to a multiple of 8), or
    tests/test_pallas.py's 16 random boxes with two padding rows (K=16)."""
    from cudasbmp_torch.config import Scenario

    if K != 16:
        return torch.tensor(Scenario.dense(K, seed=0).padded_obstacles(K + 8)[0],
                            device=dev)
    r = np.random.default_rng(1234)
    lo = r.uniform(0, 18, (K, 2))
    boxes = np.concatenate([lo, lo + r.uniform(0.3, 3.0, (K, 2))], -1)
    boxes[-2:] = (1.0, 1.0, 0.0, 0.0)
    return torch.tensor(boxes.astype(np.float32), device=dev)


def check_b5(dev, kw) -> dict:
    """Phase 18: B5 (both kernels with cull=W) bitwise against cull off, in
    every instantiation at W in WINDOWS on the dense-24 and the 16-box
    fields, at 2^17 lanes random and Morton-grouped, at ragged R and at 100
    boxes, at CUT_STEPS steps (windows past the kernel's cap, cut by the
    wrapper's plan) and at the culled box cap (one more box raises);
    against its plain twin; device ms of B2 off and at each W beside the
    culled twin at the cull table's shape, and at its one-warp floor."""
    from cudasbmp_torch import rng
    from cudasbmp_torch.config import Scenario
    from cudasbmp_torch.ops import rollout_cuda as rc
    from cudasbmp_torch.probes import throughput as tp
    from cudasbmp_torch.systems.bicycle import KinematicBicycle

    out = {"checks": 0, "twin": {}, "times": {}}
    key = rng.key(18, dev)

    def against_b1(system, x0, c, obs, opts, tag) -> None:
        x1, valid = rc.rollout_cuda(system, x0, c, obs, **opts)
        y1, c2, v2 = rc.sample_and_rollout_cuda(system, key, x0, obs, **opts)
        for W in WINDOWS:
            cx1, cvalid = rc.rollout_cuda(system, x0, c, obs, **opts, cull=W)
            cy1, cc2, cv2 = rc.sample_and_rollout_cuda(system, key, x0, obs, **opts,
                                                       cull=W)
            check(torch.equal(cvalid, valid) and bitwise(cx1, x1)
                  and bitwise(cc2, c2) and torch.equal(cv2, v2) and bitwise(cy1, y1),
                  f"B5 {tag} W={W}: differs from cull off")
            out["checks"] += 2

    def grouped(x0, c):
        order = tp.morton_order(x0)
        return x0[order].contiguous(), c[order].contiguous()

    for K in (24, 16):
        obs = culled_field(K, dev)
        for i, name in enumerate(SYSTEMS):
            system, x0, c = system_batch(name, B_CHECK, 180 + i, dev)
            for fp in (None, FOOTPRINT):
                for fast in (False, True):
                    opts = dict(kw, footprint=fp, fast_math=fast)
                    tag = f"K={K}/{name}/{'footprint' if fp else 'broad'}/" \
                          f"{'fast' if fast else 'exact'}"
                    against_b1(system, x0, c, obs, opts, tag)
                    against_b1(system, *grouped(x0, c), obs, opts, tag + "/grouped")
    system = KinematicBicycle()
    for R, K in ((33, 24), (4097, 24), (4097, 100), (B_CHECK, 100)):
        _, x0, c = system_batch("bicycle", R, 190 + R % 97, dev)
        obs = culled_field(K, dev)
        for fp in (None, FOOTPRINT):
            against_b1(system, *grouped(x0, c), obs, dict(kw, footprint=fp),
                       f"R={R} K={K}")
    # windows longer than the kernel keeps: the wrapper's plan cuts them
    _, x0, c = system_batch("bicycle", B_CHECK, 191, dev)
    obs = culled_field(24, dev)
    check(len(rc.cull_plan(1, CUT_STEPS)) > 2, f"{CUT_STEPS} steps: no window cut")
    for fp in (None, FOOTPRINT):
        for fast in (False, True):
            against_b1(system, *grouped(x0, c), obs,
                       dict(kw, num_disc=CUT_STEPS, footprint=fp, fast_math=fast),
                       f"{CUT_STEPS} steps {fp} {fast}")
    # the culled box cap: the window store's bytes less than cull off's
    out["box_cap"] = {}
    _, x0, c = system_batch("bicycle", 4097, 192, dev)
    for fp in (None, FOOTPRINT):
        limit = rc.max_kernel_obstacles(dev.index or 0, culled=True,
                                        footprint=fp is not None)
        check(rc.max_kernel_obstacles(dev.index or 0) - limit
              == rc.cull_state_bytes(fp is not None) // 16,
              f"culled box cap {limit}: not the window store's bytes below cull off's")
        r = np.random.default_rng(limit)
        lo = r.uniform(0, 19.8, (limit, 2))
        big = torch.tensor(np.concatenate([lo, lo + r.uniform(0.01, 0.2, (limit, 2))], -1)
                           .astype(np.float32), device=dev)
        against_b1(system, *grouped(x0, c), big, dict(kw, footprint=fp), f"K={limit}")
        try:
            rc.rollout_cuda(system, x0, c, torch.cat([big, big[:1]]), **kw, footprint=fp,
                            cull=4)
            fail(f"B5 at {limit + 1} boxes: launched past the culled cap")
        except ValueError:
            pass
        out["box_cap"]["footprint" if fp else "broad"] = limit
    # the plain culled twin on the card, at warps of 32 lanes
    obs = culled_field(24, dev)
    _, x0, c = system_batch("bicycle", B_CHECK, 199, dev)
    gx0, gc = grouped(x0, c)
    for fp in (None, FOOTPRINT):
        for fast in (False, True):
            opts = dict(kw, footprint=fp, fast_math=fast)
            cx1, cvalid = rc.rollout_cuda(system, gx0, gc, obs, **opts, cull=4)
            tx1, tvalid = rc.rollout_culled_soa(system, gx0, gc, obs, cull=4,
                                                group=rc.WARP, **opts)
            check(torch.equal(cvalid, tvalid) and bitwise(cx1, tx1),
                  f"B5 twin {fp} {fast}: differs from the kernel")
            out["twin"][f"{'footprint' if fp else 'broad'}/{'fast' if fast else 'exact'}"] = {
                "max_abs_err": float((cx1 - tx1).abs().max()),
                "valid_fraction": float(cvalid.float().mean())}
    # device ms at the cull table's shape: B2 on 2^17 dense-24 starts
    sc_obs = torch.tensor(Scenario.dense(24).obstacles, device=dev)
    t = out["times"]
    for g in (False, True):
        x0 = tp.start_states(B_CHECK, dev, grouped=g)
        for W in (0, *WINDOWS):
            timed(t, f"{'grouped' if g else 'random'}_W{W}",
                  lambda: rc.sample_and_rollout_bicycle_cuda(key, x0, sc_obs, **kw, cull=W))
    x0 = tp.start_states(B_CHECK, dev, grouped=True)
    timed(t, "plain_grouped_W4", lambda: rc.sample_and_rollout_torch(
        system, key, x0, sc_obs, **kw, cull=4), PLAIN_CALLS, plain=True)
    near = x0[:FLOOR_LANES].contiguous()
    timed(t, "floor_W4", lambda: rc.sample_and_rollout_cuda(system, key, near, sc_obs,
                                                           **kw, cull=4))
    out["max_abs_err"] = max(v["max_abs_err"] for v in out["twin"].values())
    return out


def run_probes(dev) -> dict:
    """Phase 19: the throughput probe (bench.py's settings: 2^17 lanes, 10
    steps) through cuda, cuda_rng, fast math, dense-24 and the plain torch
    backend, then the cull table. Launch counts are zeroed before and read
    after: the table is B5's main path."""
    from cudasbmp_torch.ops import rollout_cuda as rc
    from cudasbmp_torch.probes import throughput as tp

    out = {"probes": {}}
    rc.reset_launch_counts()
    for label, kw in (("cuda", dict(backend="cuda")),
                      ("cuda_rng", dict(backend="cuda_rng")),
                      ("cuda_rng_fast", dict(backend="cuda_rng", fast_math=True)),
                      ("cuda_rng_dense24", dict(backend="cuda_rng", dense=True)),
                      ("cuda_fast", dict(backend="cuda", fast_math=True)),
                      ("torch", dict(backend="torch"))):
        r = tp.measure_prop_throughput(device=dev, **kw)
        check(0.0 < r["valid_fraction"] < 1.0 and (r["valid_per_sec"] or 0) > 0,
              f"probe {label}: {r}")
        out["probes"][label] = r
    out["probe_launches"] = {w.__name__: w.launches for w in rc.WRAPPERS}
    check(out["probe_launches"]["rollout_cuda"] > 0
          and out["probe_launches"]["sample_and_rollout_cuda"] > 0,
          f"probes: launches {out['probe_launches']}")
    rc.reset_launch_counts()
    table = tp.cull_table(device=dev)
    out["cull_table"] = table
    out["b5_launches"] = rc.sample_and_rollout_cuda.culled
    check(out["b5_launches"] > 0 and rc.rollout_cuda.launches == 0,
          f"cull table: B5 launches {out['b5_launches']}")
    fr = {r["label"]: r["valid_fraction"] for r in table["rows"]}
    check(len({v for k, v in fr.items() if k.startswith("dense24_grouped")}) == 1,
          f"cull table: the culled rows' valid fractions differ: {fr}")
    return out


def ragged_chain_inputs(dev, rows: int | None = None):
    """P1a's input at a ragged size, x f32 [RAGGED_PROGRAMS x
    RAGGED_PROGRAM_ROWS, 128] uniform in [0.5, 1); or, with ``rows``, P2's:
    a table f32 [rows, 128] and idx int32 [RAGGED_IDX_ROWS, 128] in [0,
    rows) but for 24 lanes of the first row: -rows - 3, -2^31 and 2^31 - 513
    (the floor modulo of negative and large indices; idx + i stays an
    int32 in the twin)."""
    r = np.random.default_rng(RAGGED_IDX_ROWS + (rows or 0))
    if rows is None:
        x = r.uniform(0.5, 1.0, (RAGGED_PROGRAMS * RAGGED_PROGRAM_ROWS, 128))
        return torch.tensor(x.astype(np.float32), device=dev)
    tbl = r.uniform(0, 1, (rows, 128)).astype(np.float32)
    idx = r.integers(0, rows, (RAGGED_IDX_ROWS, 128)).astype(np.int32)
    idx[0, :8], idx[0, 8:16], idx[0, 16:24] = -rows - 3, -2 ** 31, 2 ** 31 - 513
    return torch.tensor(tbl, device=dev), torch.tensor(idx, device=dev)


def run_calibration(dev, probes: dict) -> dict:
    """Phase 20: the calibration chains (P1a, P1b, P2) against their plain
    twins on the card, their rates from device time (launches zeroed before
    and read after ``calibrate``), and B2's roofline shares, exact, fast and
    dense-24."""
    from cudasbmp_torch.ops import chains_cuda as cc
    from cudasbmp_torch.ops import rollout_cuda as rc
    from cudasbmp_torch.probes import roofline as rf

    x = rf.chain_inputs(dev)
    di = dev.index or 0
    out = {"checks": {}, "plain_ms": {}}
    # P1a within its rtol at 64 and 16,384 links, and at 64 on a ragged size
    rx = ragged_chain_inputs(dev)
    for tag, xs, chain, rtol, rows in (
            ("alu_64", x, 64, 1e-5, rf.PROGRAM_ROWS),
            (f"alu_{rf.ALU_CHAIN}", x, rf.ALU_CHAIN, 2e-3, rf.PROGRAM_ROWS),
            ("alu_64_ragged", rx, 64, 1e-5, RAGGED_PROGRAM_ROWS)):
        a, b = cc.alu_chain_cuda(xs, chain, rows), cc.alu_chain_torch(xs, chain, rows)
        err = float(((a - b).abs() / b.abs()).max())
        check(err <= rtol, f"P1a {tag}: relative error {err} > {rtol}")
        out["checks"][tag] = {"max_rel_err": err, "rtol": rtol,
                              "max_abs_err": float((a - b).abs().max())}
    # P1b within 1e-5 of its twin, and bitwise: the kernel runs each
    # element's chain as the twin does, cosf/sinf/tanf as torch's kernels
    for op, chain in (("cos", rf.TRANS_CHAIN), ("sin", rf.TRANS_CHAIN), ("tan", 2)):
        a, b = cc.trans_chain_cuda(x, chain, op), cc.trans_chain_torch(x, chain, op)
        err = float(((a - b).abs() / b.abs()).max())
        check(err <= 1e-5, f"P1b {op} at {chain} links: relative error {err}")
        out["checks"][f"{op}_{chain}"] = {"max_rel_err": err, "bitwise": bitwise(a, b),
                                          "max_abs_err": float((a - b).abs().max())}
    a = cc.trans_chain_cuda(x, rf.TRANS_CHAIN, "tan")
    out["checks"][f"tan_{rf.TRANS_CHAIN}"] = {
        "bitwise": bitwise(a, cc.trans_chain_torch(x, rf.TRANS_CHAIN, "tan")),
        "finite": bool(torch.isfinite(a).all())}
    for k in ("cos_2048", "sin_2048", "tan_2", "tan_2048"):
        check(out["checks"][k]["bitwise"], f"P1b {k}: no longer bitwise equal to its twin")

    def p1_geometry(kernel: str) -> dict:
        threads, elems, per_sm = cc.chain_geometry(di, kernel)
        return {"threads": threads, "elements_a_thread": elems, "blocks_per_sm": per_sm,
                "grid": cc.chain_plan(x.numel(), rc.sm_count(di), per_sm, threads, elems)}

    out["p1a_geometry"] = p1_geometry("alu")
    out["p1b_geometry"] = {op: p1_geometry(op) for op in cc.TRANS_OPS}
    # P2 bitwise at each table size, on the calibration's idx and a ragged one
    out["p2_geometry"] = {}
    for rows in rf.GATHER_ROWS:
        _, tbl, idx = rf.chain_inputs(dev, rows)
        for tag, (t, i) in ((f"gather_{rows}", (tbl, idx)),
                            (f"gather_{rows}_ragged", ragged_chain_inputs(dev, rows))):
            check(bitwise(cc.gather_chain_cuda(t, i, rf.GATHER_CHAIN),
                          cc.gather_chain_torch(t, i, rf.GATHER_CHAIN)),
                  f"P2 {tag}: differs from its twin")
            out["checks"][tag] = {"bitwise": True}
        threads, per_block, per_sm, max_rows = cc.gather_geometry(di, rows)
        out["p2_geometry"][rows] = {
            "threads": threads, "rows_per_block": per_block, "blocks_per_sm": per_sm,
            "max_rows": max_rows, "blocks": cc.LANES // cc.SLICE_LANES * cc.gather_plan(
                idx.shape[0], rows, rc.sm_count(di), per_sm, per_block, rc.smem_optin(di))}
        check(max_rows == cc.gather_max_rows(rc.smem_optin(di)),
              f"P2: the kernel's most rows {max_rows} != gather_max_rows "
              f"{cc.gather_max_rows(rc.smem_optin(di))}")
    # the rollout kernels' one sincosf a heading against torch.sin/torch.cos
    out["sincos_differences"] = cc.sincos_differences(dev)
    check(out["sincos_differences"] == 0,
          f"sincosf differs from torch.sin/cos on {out['sincos_differences']} floats")
    pm = out["plain_ms"]
    timed(pm, "alu", lambda: cc.alu_chain_torch(x, rf.ALU_CHAIN), PLAIN_CALLS, plain=True)
    timed(pm, "cos", lambda: cc.trans_chain_torch(x, rf.TRANS_CHAIN, "cos"), PLAIN_CALLS, plain=True)
    _, tbl, idx = rf.chain_inputs(dev, 1024)
    timed(pm, "gather1024", lambda: cc.gather_chain_torch(tbl, idx, rf.GATHER_CHAIN),
          PLAIN_CALLS, plain=True)
    cc.reset_launch_counts()
    out["calibration"] = rf.calibrate(dev)
    check(all(out["calibration"]["regular"].values()),
          f"calibrate: no regular profiler window for {out['calibration']['regular']}")
    out["launches"] = {w.__name__: w.launches for w in cc.WRAPPERS}
    check(all(out["launches"].values()), f"calibrate: launches {out['launches']}")
    out["shares"] = rf.b2_shares(out["calibration"], dev, probes={
        "exact_demo": probes["cuda_rng"], "fast_math_demo": probes["cuda_rng_fast"],
        "exact_dense24": probes["cuda_rng_dense24"]})
    check(all(v["kernel_ms"] for v in out["shares"].values()),
          "B2 shares: no regular profiler window for a kernel time")
    return out


def run_probe_cli() -> dict:
    """Phase 21: ``probe`` as a user starts it, on the card, at the
    CostProp reference's 524,288 lanes."""
    out = {}
    for planner in ("naive", "costprop"):
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "cudasbmp_torch.cli", "probe",
                            "--planner", planner, "--width", str(PROBE_LANES),
                            "--device", "cuda"],
                           cwd=ROOT, capture_output=True, text=True, timeout=300)
        lines = p.stdout.splitlines()
        check(p.returncode == 0 and len(lines) == 3,
              f"cli probe {planner}: exit {p.returncode}\n{p.stdout[-2000:]}"
              f"\n{p.stderr[-2000:]}")
        m = re.fullmatch(r"Kernel execution time: (\d+\.\d+) milliseconds", lines[0])
        rate = json.loads(lines[2])["rollouts_per_sec"]
        check(m is not None and lines[1] == f"Tree size: {PROBE_LANES}" and rate > 0,
              f"cli probe {planner}: {lines}")
        out[planner] = {"seconds": time.perf_counter() - t0, "lines": lines,
                        "kernel_ms": float(m[1]), "rollouts_per_sec": rate}
    return out


def counting(module, name: str, attr: str):
    """Wrap module.name so that every call appends the ``attr`` of what it
    returns to a list (the iterations a solve ran); returns (list, undo)."""
    orig = getattr(module, name)
    seen: list[int] = []

    def wrapped(*a, **k):
        out = orig(*a, **k)
        seen.append(getattr(out, attr))
        return out

    setattr(module, name, wrapped)
    return seen, lambda: setattr(module, name, orig)


def quantiles(costs: np.ndarray) -> list[float]:
    costs = costs[np.isfinite(costs)]
    return (np.quantile(costs, [0.1, 0.5, 0.9]).tolist() if costs.size
            else [math.nan] * 3)


def arena_config4(dev, backend: str) -> tuple[dict, str]:
    """Phase 14: BASELINE config 4 through the batched arena, as bench.py
    measures it (warm-up seed 7, measured seed 8 with one extension).
    Returns the record and the result's digest ([33] holds the ranks to
    it)."""
    from cudasbmp_torch import KGMTConfig
    from cudasbmp_torch.ops import rollout_cuda as rc
    from cudasbmp_torch.parallel import ArenaMultiQueryPlanner
    from cudasbmp_torch.parallel import batch_kgmt as bk

    cfg = KGMTConfig(**SWEEP, rollout_backend=backend)
    B = ARENA_B
    inits, goals, obstacles = jittered_demo(B, cfg.seed)  # the CLI's multi batch
    planner = ArenaMultiQueryPlanner(cfg, auto_capacity=True, device=dev)
    planner.plan_batch(inits, goals, obstacles, seed=7)  # warm-up
    waves, undo = counting(bk, "arena_solve", "it")
    rc.reset_launch_counts()
    try:
        res = planner.plan_batch(inits, goals, obstacles, seed=8, max_extensions=1)
    finally:
        undo()
    kernel = rc.sample_and_rollout_cuda if backend == "cuda_rng" else rc.rollout_cuda
    launches = {w.__name__: w.launches for w in rc.WRAPPERS}
    check(launches.pop(kernel.__name__) == sum(waves) and set(launches.values()) == {0},
          f"arena {backend}: launches {dict(launches)} {kernel.launches} for waves {waves}")
    # the first solve's waves at the rule's G for B x R lanes; the extension,
    # narrower, at its own
    G = rc.lanes_per_rollout(ARENA_B * cfg.rollouts_per_iter, rc.sm_count(dev.index or 0))
    check(kernel.splits[G] >= waves[0], f"arena {backend}: G {dict(kernel.splits)}, "
          f"{waves[0]} waves at G={G}")
    check(bool((res.path_lengths[res.solved] >= 2).all()),
          f"arena {backend}: a solved problem without a path")
    worst = check_paths(f"arena {backend}", planner.system, cfg, res.paths,
                        res.path_lengths, res.costs, goals, obstacles)
    rate = float(res.solved.mean())
    check(rate >= 0.5, f"arena {backend}: solve rate {rate}")
    return {"batch": B, "solve_rate": rate, "cost_p10_p50_p90": quantiles(res.costs),
            "iterations_p50": float(np.median(res.iterations)),
            "iterations_max": int(res.iterations.max()),
            "solves_per_sec": res.solves_per_sec, "wall_time_s": res.wall_time_s,
            "waves": waves, "launches": kernel.launches, "split": G,
            "splits": dict(kernel.splits), "budget_exhausted": int(res.budget_exhausted.sum()),
            "replay_max_err": worst}, arena_digest(res)


def arena_extension(dev) -> dict:
    """Phase 14's extension round: config 4 ('auto') with the goals of three
    problems inside the demo's long wall, which no rollout reaches, so they
    exhaust their 150 windows and one extension round re-plans them with
    300 windows in a bucket of 8 problems x 128 lanes. The merged result
    keeps every other problem as the same solve without the round gives it
    and marks the three exhausted after 300 iterations; the round's waves
    launch B1 at the rule's G for 1,024 lanes, the first round's at the
    rule's G for 32,768."""
    from cudasbmp_torch import KGMTConfig
    from cudasbmp_torch.ops import rollout_cuda as rc
    from cudasbmp_torch.parallel import ArenaMultiQueryPlanner
    from cudasbmp_torch.parallel import batch_kgmt as bk

    cfg = KGMTConfig(**SWEEP)
    B, walled = ARENA_B, [0, 100, 200]
    inits, goals, obstacles = jittered_demo(B, cfg.seed)
    goals[walled, :2] = (9.0, 7.0)  # inside the box (0, 6)-(18, 8)
    planner = ArenaMultiQueryPlanner(cfg, auto_capacity=True, device=dev)
    plain = planner.plan_batch(inits, goals, obstacles, seed=8)
    waves, undo = counting(bk, "arena_solve", "it")
    rc.reset_launch_counts()
    try:
        res = planner.plan_batch(inits, goals, obstacles, seed=8, max_extensions=1)
    finally:
        undo()
    sms = rc.sm_count(dev.index or 0)
    G1, G2 = (rc.lanes_per_rollout(n * cfg.rollouts_per_iter, sms) for n in (B, 8))
    windows = planner.n_windows
    check(list(np.flatnonzero(plain.budget_exhausted)) == walled
          and waves == [windows, 2 * windows] and set(planner._extensions) == {2 * windows},
          f"arena extension: exhausted {np.flatnonzero(plain.budget_exhausted)}, waves "
          f"{waves}")
    check(rc.rollout_cuda.launches == sum(waves)
          and dict(rc.rollout_cuda.splits) == ({G1: windows, G2: 2 * windows} if G1 != G2
                                               else {G1: 3 * windows}),
          f"arena extension: B1 launches {rc.rollout_cuda.launches} at G "
          f"{dict(rc.rollout_cuda.splits)} for waves {waves}")
    others = np.setdiff1d(np.arange(B), walled)
    for f in ("solved", "costs", "tree_sizes", "iterations", "path_lengths"):
        check(np.array_equal(getattr(res, f)[others], getattr(plain, f)[others]),
              f"arena extension: {f} of the unextended problems changed")
    L = plain.paths.shape[1]
    check(res.paths.shape == (B, 2 * windows + 1, 7)
          and np.array_equal(res.paths[others, :L], plain.paths[others])
          and not res.paths[others, L:].any(),
          f"arena extension: merged paths {res.paths.shape}")
    check(not res.solved[walled].any() and res.budget_exhausted[walled].all()
          and (res.iterations[walled] == 2 * windows).all()
          and (res.path_lengths[walled] == 0).all()
          and res.budget_exhausted.sum() == len(walled),
          f"arena extension: walled problems {res.iterations[walled]} iterations")
    return {"exhausted_first_round": walled, "waves": waves,
            "splits": dict(rc.rollout_cuda.splits),
            "solve_rate": float(res.solved.mean()), "wall_time_s": res.wall_time_s}


def mc_sweep(dev) -> dict:
    """Phase 15: BASELINE config 5 per chip, as bench.py measures it (1024
    random scenarios, 8 boxes, two extensions), every wave through B6."""
    from cudasbmp_torch import KGMTConfig
    from cudasbmp_torch.ops import rollout_cuda as rc
    from cudasbmp_torch.parallel import MonteCarloPlanner
    from cudasbmp_torch.parallel import batch_kgmt as bk

    mc = MonteCarloPlanner(KGMTConfig(**SWEEP), impl="arena", auto_capacity=True,
                           device=dev)
    mc.run(64, seed=0, num_obstacles=8)  # warm-up
    waves, undo = counting(bk, "arena_solve", "it")
    rc.reset_launch_counts()
    try:
        s = mc.run(MC_N, seed=1, num_obstacles=8, max_extensions=2)
    finally:
        undo()
    launches = {w.__name__: w.launches for w in rc.WRAPPERS}
    splits = rc.rollout_batched_cuda.splits
    check(launches.pop("rollout_batched_cuda") == sum(waves)
          and set(launches.values()) == {0} and splits[1] >= waves[0],
          f"Monte-Carlo sweep: launches {launches} at G {dict(splits)} for waves {waves}")
    check(s.solve_rate >= 0.5 and bool(np.isfinite(s.costs[s.solved]).all())
          and bool((s.costs[s.solved] > 0).all()),
          f"Monte-Carlo sweep: solve rate {s.solve_rate}")
    return {"scenarios": MC_N, "solve_rate": s.solve_rate,
            "cost_p10_p50_p90": quantiles(s.costs), "solves_per_sec": s.solves_per_sec,
            "wall_time_s": s.wall_time_s, "mean_tree_size": s.mean_tree_size,
            "budget_exhausted": s.num_budget_exhausted, "waves": waves,
            "launches": rc.rollout_batched_cuda.launches, "splits": dict(splits)}


def stream_sweep(dev) -> tuple[dict, dict]:
    """Phase 16: the streaming sweep at bench.py's width under 'auto' (B6)
    and 'cuda_rng' (B6's Philox form), then the partition and pool-size
    invariances at 256 scenarios. Returns the record and, by backend, the
    sweep's digest of costs and iterations and its wall (phase 33)."""
    from cudasbmp_torch import KGMTConfig
    from cudasbmp_torch.ops import rollout_cuda as rc
    from cudasbmp_torch.parallel import StreamingMonteCarloPlanner
    from cudasbmp_torch.parallel import streaming_mc as sm

    out, sweeps = {}, {}
    for backend, kernel in (("auto", rc.rollout_batched_cuda),
                            ("cuda_rng", rc.sample_and_rollout_batched_cuda)):
        cfg = KGMTConfig(**SWEEP, rollout_backend=backend)
        StreamingMonteCarloPlanner(cfg, pool=64, device=dev).run(64, seed=0)  # warm-up
        iters, undo = counting(sm, "stream_solve", "it")
        rc.reset_launch_counts()
        try:
            s = StreamingMonteCarloPlanner(cfg, pool=STREAM_POOL, device=dev).run(
                STREAM_N, seed=1, num_obstacles=8)
        finally:
            undo()
        launches = {w.__name__: w.launches for w in rc.WRAPPERS}
        main_launches = launches.pop(kernel.__name__)
        check(main_launches == sum(iters) and set(launches.values()) == {0}
              and kernel.splits == {1: main_launches},
              f"streaming {backend}: launches {launches} at G {dict(kernel.splits)} for "
              f"{iters} iterations")
        check(s.solve_rate >= 0.5, f"streaming {backend}: solve rate {s.solve_rate}")
        check(bool(((np.isfinite(s.costs)) | (s.iters >= cfg.num_iterations)).all()),
              f"streaming {backend}: a scenario neither solved nor exhausted")
        inv = {}
        single = StreamingMonteCarloPlanner(cfg, pool=CHECK_POOL, device=dev).run(
            CHECK_N, seed=3)
        half = CHECK_N // 2
        parts = [StreamingMonteCarloPlanner(cfg, pool=CHECK_POOL, device=dev).run(
            half, seed=3, id_lo=lo) for lo in (0, half)]
        narrow = StreamingMonteCarloPlanner(cfg, pool=CHECK_POOL // 2, device=dev).run(
            CHECK_N, seed=3)
        for tag, costs, its in (
                ("id_lo partitions", np.concatenate([p.costs for p in parts]),
                 np.concatenate([p.iters for p in parts])),
                (f"pool {CHECK_POOL // 2}", narrow.costs, narrow.iters)):
            check(np.array_equal(costs.view(np.uint32), single.costs.view(np.uint32))
                  and np.array_equal(its, single.iters),
                  f"streaming {backend}: {tag} differ from the pool of {CHECK_POOL}")
            inv[tag] = "bitwise equal"
        out[backend] = {"scenarios": STREAM_N, "pool": STREAM_POOL, "solve_rate": s.solve_rate,
                        "cost_quantiles": s.cost_quantiles,
                        "solves_per_sec": s.solves_per_sec, "wall_time_s": s.wall_time_s,
                        "mean_iters": s.mean_iters, "iterations": iters,
                        "launches": main_launches, "invariance_256": inv,
                        "solve_rate_256": single.solve_rate}
        sweeps[backend] = {"digest": digest(s.costs, s.iters), "wall_time_s": s.wall_time_s}
    return out, sweeps


def run_batch_cli() -> dict:
    """Phase 17: the batch subcommands as a user starts them, on the card."""
    sweep_flags = ["--rollouts-per-iter", "128", "--num-iterations", "150",
                   "--no-adaptive-waves"]
    runs = {
        "multi": ["multi", "--impl", "arena", "--batch", "256", "--device", "cuda",
                  "--max-tree-size", str(128 * 151), *sweep_flags],
        "sweep_stream": ["sweep", "--impl", "stream", "--scenarios", "1024", "--pool",
                         "256", "--device", "cuda", *sweep_flags],
    }
    out = {}
    for tag, args in runs.items():
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "cudasbmp_torch.cli", *args],
                           cwd=ROOT, capture_output=True, text=True, timeout=300)
        check(p.returncode == 0, f"cli {tag}: exit {p.returncode}\n{p.stdout[-2000:]}"
              f"\n{p.stderr[-2000:]}")
        summary = json.loads(p.stdout[p.stdout.index("{"):p.stdout.rindex("}") + 1])
        check(summary["solve_rate"] > 0.5, f"cli {tag}: {summary}")
        out[tag] = {"seconds": time.perf_counter() - t0, "summary": summary}
    return out


def jittered_demo(B: int, seed: int, jitter: float = 1.0):
    """The CLI's multi batch (cudasbmp_tpu/cli.py:331-341): B demo pairs,
    goals jittered by U(-jitter, jitter) from default_rng(seed), and the
    demo's padded boxes."""
    from cudasbmp_torch.config import Scenario

    base = Scenario.demo()
    inits = np.tile(base.init, (B, 1)).astype(np.float32)
    goals = np.tile(base.goal, (B, 1)).astype(np.float32)
    goals[:, :2] += np.random.default_rng(seed).uniform(
        -jitter, jitter, (B, 2)).astype(np.float32)
    return inits, goals, base.padded_obstacles(8)[0]


def check_new_shapes(dev, kw) -> dict:
    """Phase 22's kernel checks: both B6 forms bitwise against their plain
    twins at the shapes the new paths give them: the CLI's multi (64
    problems x 4,096 lanes), bench.py's vmap shape (256 x 2,048) and the
    quality pipeline's shortcut rounds (128 paths x 256 candidates), each
    with one box set per problem, at the rule's G; and B1 against its twin
    at shortcut_path's 256 lanes against the demo's 5 boxes. Returns the
    largest error and B6's device ms at 64 x 4,096 beside its twin's."""
    from cudasbmp_torch import rng
    from cudasbmp_torch.config import Scenario
    from cudasbmp_torch.ops import rollout_cuda as rc

    out = {"checks": {}}
    for nb, nr in MULTI_SHAPES:
        system, x0, c, obs = problem_batch("bicycle", nb, nr, 8, 200 + nb, dev)
        keys = rng.split(rng.key(300 + nb, dev), nb)
        px1, pvalid = rc.rollout_soa(system, x0, c, obs, **kw)
        ty1, tc2, tv2 = rc.sample_and_rollout_torch(system, keys, x0, obs, **kw)
        x1, valid = rc.rollout_batched_cuda(system, x0, c, obs, **kw)
        y1, c2, v2 = rc.sample_and_rollout_batched_cuda(system, keys, x0, obs, **kw)
        torch.cuda.synchronize()
        check(torch.equal(valid, pvalid) and bitwise(x1, px1),
              f"B6 {nb}x{nr}: {int((valid != pvalid).sum())} mask mismatches")
        check(bitwise(c2, tc2) and torch.equal(v2, tv2) and bitwise(y1, ty1),
              f"B6 Philox {nb}x{nr}: differs from its twin")
        out["checks"][f"{nb}x{nr}"] = {
            "max_abs_err": max(float((x1 - px1).abs().max()), float((y1 - ty1).abs().max())),
            "valid_fraction": float(pvalid.float().mean()),
            "split": rc.lanes_per_rollout(nb * nr, rc.sm_count(dev.index or 0))}
        if (nb, nr) == MULTI_SHAPES[0]:
            t = out["times"] = {}
            timed(t, "b6", lambda: rc.rollout_batched_cuda(system, x0, c, obs, **kw))
            timed(t, "plain", lambda: rc.rollout_soa(system, x0, c, obs, **kw),
                  PLAIN_CALLS, plain=True)
            timed(t, "b6_rng", lambda: rc.sample_and_rollout_batched_cuda(
                system, keys, x0, obs, **kw))
            timed(t, "rng_plain", lambda: rc.sample_and_rollout_torch(
                system, keys, x0, obs, **kw), PLAIN_CALLS, plain=True)
    boxes = torch.tensor(Scenario.demo().obstacles, device=dev)
    system, x0, c = system_batch("bicycle", SHORTCUT_CANDIDATES, 210, dev)
    out["checks"]["b1_shortcut_path"] = check_against_twins(
        "shortcut_path", system, x0, c, boxes, rng.key(211, dev), kw)
    out["max_abs_err"] = max(v["max_abs_err"] for v in out["checks"].values())
    return out


def sum_orders(dev, rows: int = MULTI_B, draws: int = 100) -> dict:
    """Why every score total is ``_math.row_sum``: rows of [rows, 256]
    score-like values (fourth powers over 1 + count^2, 70% zeros, from a
    seeded generator) summed by torch as one batch and one row at a time,
    and by ``row_sum``; the rows whose library sums differ, and those whose
    row_sum differs between the batch and the single row (none may)."""
    from cudasbmp_torch._math import row_sum

    g = torch.Generator().manual_seed(0)
    library = pairwise = 0
    for _ in range(draws):
        x = (torch.rand(rows, 256, generator=g) ** 4
             / (1 + torch.randint(0, 100, (rows, 256), generator=g).float() ** 2))
        x[torch.rand(rows, 256, generator=g) < 0.7] = 0
        x = x.to(dev)
        one_at_a_time = torch.stack([r.sum() for r in x])
        library += int((x.sum(dim=-1) != one_at_a_time).sum())
        single = torch.cat([row_sum(r) for r in x])
        pairwise += int((row_sum(x)[:, 0] != single).sum())
    check(pairwise == 0, f"row_sum: {pairwise} rows differ between the batch and one row")
    return {"rows": rows * draws, "library_rows_differing": library,
            "row_sum_rows_differing": pairwise}


def single_solve(cfg, planner, init, goal, obstacles, key) -> list:
    """The single-query solve (planners/kgmt.py) of one problem on the card
    under ``key``: [solved, iterations, tree size, cost, path] with the path
    as its f32 bits."""
    from cudasbmp_torch.planners import kgmt as tk

    dev = key.device
    s = tk.kgmt_solve(cfg, planner.system, planner.grid,
                      torch.as_tensor(init, device=dev), torch.as_tensor(goal, device=dev),
                      torch.as_tensor(np.ascontiguousarray(obstacles), device=dev), key)
    _, samples, length = tk.extract_path(cfg, s)
    cost = float(s.cost_to_goal)
    return [math.isfinite(cost), s.itr, s.tree_size, cost,
            samples[:int(length)].cpu().numpy().view(np.uint32).tolist()]


def digest(*arrays) -> str:
    """sha256 of the arrays' bytes, in order (their bits, not their values)."""
    import hashlib

    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def multi_digest(res) -> str:
    """A MultiQueryResult's solve fields as one digest."""
    return digest(res.solved, res.costs, res.iterations, res.tree_sizes, res.paths,
                  res.path_lengths)


def arena_digest(res) -> str:
    """An arena result's solve fields, its exhausted flags too, as one
    digest."""
    return digest(res.solved, res.costs, res.iterations, res.tree_sizes, res.paths,
                  res.path_lengths, res.budget_exhausted)


def batched_row(res, b: int) -> list:
    """Problem b of a MultiQueryResult in single_solve's layout."""
    n = int(res.path_lengths[b])
    return [bool(res.solved[b]), int(res.iterations[b]), int(res.tree_sizes[b]),
            float(res.costs[b]), res.paths[b, :n].view(np.uint32).tolist()]


def check_paths(tag: str, system, cfg, paths, lengths, costs, goals, obstacles) -> float:
    """Every path of length >= 2 replays through the plain exact rollout
    within 1e-4, every edge valid, ends inside its goal, and its cost is
    the sum of its durations. Returns the worst replay error."""
    from cudasbmp_torch.ops.rollout import rollout_batch

    dev = torch.device("cuda", 0)
    worst = 0.0
    for b in np.flatnonzero(lengths >= 2):
        path = torch.tensor(paths[b, :lengths[b]], device=dev)
        obs = torch.tensor(np.ascontiguousarray(
            obstacles[b] if obstacles.ndim == 3 else obstacles), device=dev)
        x1, valid = rollout_batch(system, path[:-1, :4].contiguous(),
                                  path[1:, 4:].contiguous(), cfg.num_disc, obs,
                                  cfg.width, cfg.height, footprint=cfg.footprint)
        err = float((x1 - path[1:, :4]).abs().max())
        worst = max(worst, err)
        check(bool(valid.all()) and err <= 1e-4, f"{tag}: path {b} replays with error {err}")
        check(math.isclose(float(costs[b]), float(path[1:, 6].sum()), rel_tol=1e-5),
              f"{tag}: path {b} cost {costs[b]} != the sum of its durations")
        end = paths[b, lengths[b] - 1]
        check(math.hypot(end[0] - goals[b, 0], end[1] - goals[b, 1]) < cfg.goal_threshold,
              f"{tag}: path {b} ends off its goal")
    return worst


def trip_costs(cfg, planner, B: int, dev, trips: int = 3) -> dict:
    """Kernel launches and host reads a trip of the vmapped loop at B
    problems, each over ``trips`` trips: launches by ``runtime_launches``,
    host reads by torch's synchronization warnings
    (torch.cuda.set_sync_debug_mode)."""
    import warnings

    from cudasbmp_torch import rng
    from cudasbmp_torch.parallel import multi_query as mq

    inits, goals, obstacles = jittered_demo(B, 0)
    g = torch.tensor(goals, device=dev)
    o = torch.tensor(np.stack([obstacles] * B), device=dev)
    s = mq.init_batch_state(cfg, planner.grid, torch.tensor(inits, device=dev),
                            rng.fold_in(rng.key(0, dev), torch.arange(B, device=dev)))
    launches = runtime_launches(
        lambda: mq.multi_query_trip(cfg, planner.system, planner.grid, g, o, s), trips)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(trips):
                mq.multi_query_trip(cfg, planner.system, planner.grid, g, o, s)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message) for w in caught if "synchroniz" in str(w.message)]
    return {"launches_per_trip": launches, "host_reads_per_trip": len(syncs) / trips,
            "sync_messages": syncs[:3]}


def multi_query_default(dev) -> tuple[dict, dict]:
    """Phase 22: MultiQueryPlanner at the CLI's default (KGMTConfig(), 64
    jittered demo pairs) under 'auto' (every trip one launch of B6) and
    'cuda_rng' (B6's Philox form); four problems, the slowest among them,
    equal the single-query solve on their keys field by field; every solved
    path replays; launches per trip equal at B=8 and B=64; one host read
    per trip. Returns the record and the 'auto' batch (paths, lengths,
    costs, goals, obstacles) for phase 25."""
    from cudasbmp_torch import KGMTConfig, rng
    from cudasbmp_torch.ops import rollout_cuda as rc
    from cudasbmp_torch.ops import threefry_cuda as tfc
    from cudasbmp_torch.parallel import MultiQueryPlanner
    from cudasbmp_torch.utils import profiling
    from cudasbmp_torch.utils.profiling import trip_graph

    out = {}
    B = MULTI_B
    for backend, kernel in (("auto", rc.rollout_batched_cuda),
                            ("cuda_rng", rc.sample_and_rollout_batched_cuda)):
        cfg = KGMTConfig(rollout_backend=backend)
        inits, goals, obstacles = jittered_demo(B, cfg.seed)
        planner = MultiQueryPlanner(cfg, device=dev)
        planner.plan_batch(inits[:8], goals[:8], obstacles, seed=7)  # warm-up
        rc.reset_launch_counts()
        tfc.reset_launch_counts()
        profiling.reset_trip_graphs()
        res = planner.plan_batch(inits, goals, obstacles, seed=cfg.seed)
        trips = planner.last_state.trips
        launches = {w.__name__: w.launches for w in rc.WRAPPERS}
        main_launches = kernel.launches
        # a trip's keys, controls (not under cuda_rng: B6 draws them) and
        # acceptance uniforms, launched by the host once, when B = 64's trip
        # is captured (the replays launch them from the graphs); the batch's
        # keys one fold_in
        graphs = {"captures": trip_graph.captures, "replays": trip_graph.replays}
        check(graphs == {"captures": 1, "replays": trips},
              f"multi {backend}: trip graphs {graphs} for {trips} trips")
        tf_trips = threefry_launches(tfc)
        want = {"fold_in_cuda": 1, "wave_keys_cuda": 1, "uniform_cuda": 1,
                **({"scaled_uniform_cuda": 1} if backend == "auto" else {})}
        check(tf_trips == want, f"multi {backend}: threefry launches {tf_trips} for "
              f"{trips} trips")
        G = rc.lanes_per_rollout(B * cfg.rollouts_per_iter, rc.sm_count(dev.index or 0))
        check(launches.pop(kernel.__name__) == trips and set(launches.values()) == {0}
              and kernel.splits == {G: trips},
              f"multi {backend}: launches {launches} {kernel.launches} at G "
              f"{dict(kernel.splits)} for {trips} trips")
        slowest = int(np.argmax(res.iterations))
        picks = sorted({0, 1, B - 1, slowest})
        for b in picks:
            one = single_solve(cfg, planner, inits[b], goals[b], obstacles,
                               rng.fold_in(rng.key(cfg.seed, dev), b))
            check(one == batched_row(res, b),
                  f"multi {backend}: problem {b} {batched_row(res, b)[:4]} != its single "
                  f"solve {one[:4]}")
        worst = check_paths(f"multi {backend}", planner.system, cfg, res.paths,
                            res.path_lengths, res.costs, goals, obstacles)
        rate = float(res.solved.mean())
        check(rate >= 0.5, f"multi {backend}: solve rate {rate}")
        costs = {}
        for nb in (8, B):
            costs[nb] = trip_costs(cfg, planner, nb, dev)
        check(costs[8]["launches_per_trip"] == costs[B]["launches_per_trip"] > 0,
              f"multi {backend}: launches per trip {costs}")
        check(all(c["host_reads_per_trip"] == 1 for c in costs.values()),
              f"multi {backend}: host reads per trip {costs}")
        out[backend] = {
            "batch": B, "solve_rate": rate, "cost_p10_p50_p90": quantiles(res.costs),
            "solves_per_sec": res.solves_per_sec, "wall_time_s": res.wall_time_s,
            "trips": trips, "iterations_max": int(res.iterations.max()),
            "launches": main_launches, "split": G, "checked_problems": picks,
            "replay_max_err": worst, "trip_costs": {str(k): v for k, v in costs.items()},
            "threefry_launches": tf_trips}
        if backend == "auto":
            batch = {"paths": res.paths, "path_lengths": res.path_lengths,
                     "costs": res.costs, "goals": goals, "obstacles": obstacles,
                     "digest": multi_digest(res), "wall_time_s": res.wall_time_s}
    return out, batch


def multi_query_bench(dev) -> dict:
    """Phase 23: bench.py's vmap shape (bench.py:324-329): 256 demo pairs,
    M=16,384, R=2,048, 'cuda_rng', fixed waves; warm-up seed 7, measured
    seed 8; every trip one launch of B6's Philox form."""
    from cudasbmp_torch import KGMTConfig
    from cudasbmp_torch.ops import rollout_cuda as rc
    from cudasbmp_torch.parallel import MultiQueryPlanner

    cfg = KGMTConfig(max_tree_size=16_384, rollouts_per_iter=2048,
                     rollout_backend="cuda_rng", adaptive_waves=False)
    inits, goals, obstacles = jittered_demo(BENCH_VMAP_B, 0, jitter=0.0)
    planner = MultiQueryPlanner(cfg, device=dev)
    planner.plan_batch(inits, goals, obstacles, seed=7)  # warm-up
    rc.reset_launch_counts()
    res = planner.plan_batch(inits, goals, obstacles, seed=8)
    trips = planner.last_state.trips
    kernel = rc.sample_and_rollout_batched_cuda
    G = rc.lanes_per_rollout(BENCH_VMAP_B * cfg.rollouts_per_iter,
                             rc.sm_count(dev.index or 0))
    check(kernel.launches == trips and kernel.splits == {G: trips}
          and rc.rollout_batched_cuda.launches == 0,
          f"bench vmap: B6 Philox {kernel.launches} at G {dict(kernel.splits)} for "
          f"{trips} trips")
    worst = check_paths("bench vmap", planner.system, cfg, res.paths, res.path_lengths,
                        res.costs, goals, obstacles)
    rate = float(res.solved.mean())
    check(rate >= 0.5, f"bench vmap: solve rate {rate}")
    return {"batch": BENCH_VMAP_B, "solve_rate": rate,
            "cost_p10_p50_p90": quantiles(res.costs), "solves_per_sec": res.solves_per_sec,
            "wall_time_s": res.wall_time_s, "trips": trips,
            "iterations_max": int(res.iterations.max()),
            "budget_exhausted": int(res.budget_exhausted.sum()),
            "launches": kernel.launches, "split": G, "replay_max_err": worst}


def runtime_launches(step, steps: int = 3) -> float:
    """Kernel launches a call of ``step`` makes: the profiler's runtime-API
    launch records over ``steps`` calls, after two unprofiled ones."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if "LaunchKernel" in e.name) / steps


def vmap_vs_arena(dev) -> dict:
    """Phase 23's comparison on the same problems: BASELINE config 4's 256
    jittered demo pairs with config 4's settings (R=128, 150 iterations,
    fixed waves), seed 8, through the vmapped planner and through the arena
    (auto capacity, no extension): solve rate, cost quantiles, solves/s,
    trips (the arena's global iterations), wall a trip, and the kernel
    launches of three trips (``runtime_launches``)."""
    from cudasbmp_torch import KGMTConfig, rng
    from cudasbmp_torch.parallel import ArenaMultiQueryPlanner, MultiQueryPlanner
    from cudasbmp_torch.parallel import batch_kgmt as bk
    from cudasbmp_torch.parallel import multi_query as mq

    cfg = KGMTConfig(**SWEEP)
    inits, goals, obstacles = jittered_demo(ARENA_B, cfg.seed)
    key = rng.key(8, dev)
    t_inits, t_goals = (torch.tensor(a, device=dev) for a in (inits, goals))
    t_obs = torch.tensor(obstacles, device=dev)
    out = {}
    vmap = MultiQueryPlanner(cfg, device=dev)
    arena = ArenaMultiQueryPlanner(cfg, auto_capacity=True, device=dev)
    for tag, planner in (("vmap", vmap), ("arena", arena)):
        planner.plan_batch(inits, goals, obstacles, seed=7)  # warm-up
        waves, undo = counting(bk, "arena_solve", "it")
        try:
            res = planner.plan_batch(inits, goals, obstacles, seed=8)
        finally:
            undo()
        if tag == "vmap":
            trips = planner.last_state.trips
            s = mq.init_batch_state(cfg, planner.grid, t_inits,
                                    rng.fold_in(key, torch.arange(ARENA_B, device=dev)))
            per_obs = t_obs.expand(ARENA_B, *t_obs.shape).contiguous()
            launches = runtime_launches(lambda: mq.multi_query_trip(
                cfg, planner.system, planner.grid, t_goals, per_obs, s))
        else:
            trips = waves[0]
            s = bk.arena_init(cfg, planner.grid, t_inits, key, planner.M, planner.R,
                              planner.system.state_dim)
            launches = runtime_launches(lambda: bk.arena_iteration(
                cfg, planner.system, planner.grid, t_obs, t_goals, planner.R, s))
        out[tag] = {"solve_rate": float(res.solved.mean()),
                    "cost_p10_p50_p90": quantiles(res.costs),
                    "solves_per_sec": res.solves_per_sec, "wall_time_s": res.wall_time_s,
                    "trips": trips, "ms_per_trip": res.wall_time_s / trips * 1e3,
                    "launches_per_trip": launches}
    return out


def mc_vmap(dev) -> dict:
    """Phase 24: MonteCarloPlanner(impl='vmap') at the CLI's sweep default
    (KGMTConfig(), 64 random scenarios of 8 boxes, seed 0): every trip one
    launch of B6 with a distinct box set per problem; the slowest scenario
    equals its single solve on its own box set."""
    from cudasbmp_torch import KGMTConfig, rng
    from cudasbmp_torch.ops import rollout_cuda as rc
    from cudasbmp_torch.parallel import MonteCarloPlanner, random_scenarios

    cfg = KGMTConfig()
    mc = MonteCarloPlanner(cfg, device=dev)
    mc.run(8, seed=5, num_obstacles=8)  # warm-up
    rc.reset_launch_counts()
    s = mc.run(MC_VMAP_N, seed=cfg.seed, num_obstacles=8)
    trips = mc.planner.last_state.trips
    kernel = rc.rollout_batched_cuda
    G = rc.lanes_per_rollout(MC_VMAP_N * cfg.rollouts_per_iter, rc.sm_count(dev.index or 0))
    check(kernel.launches == trips and kernel.splits == {G: trips}
          and rc.rollout_cuda.launches == 0,
          f"Monte-Carlo vmap: B6 {kernel.launches} at G {dict(kernel.splits)} for "
          f"{trips} trips")
    inits, goals, obstacles = random_scenarios(rng.key(cfg.seed), MC_VMAP_N, cfg, 8)
    check(len({tuple(o.ravel()) for o in obstacles}) == MC_VMAP_N,
          "Monte-Carlo vmap: box sets repeat")
    b = int(np.argmax(mc.planner.last_state.itr.cpu().numpy()))
    one = single_solve(cfg, mc.planner, inits[b], goals[b], obstacles[b],
                       rng.fold_in(rng.key(cfg.seed + 1, dev), b))
    row = [bool(s.solved[b]), int(mc.planner.last_state.itr[b]),
           int(mc.planner.last_state.tree_size[b]), float(s.costs[b])]
    check(one[:4] == row, f"Monte-Carlo vmap: scenario {b} {row} != its single solve "
          f"{one[:4]}")
    check(s.solve_rate >= 0.5, f"Monte-Carlo vmap: solve rate {s.solve_rate}")
    return {"scenarios": MC_VMAP_N, "solve_rate": s.solve_rate,
            "cost_p10_p50_p90": quantiles(s.costs), "solves_per_sec": s.solves_per_sec,
            "wall_time_s": s.wall_time_s, "trips": trips,
            "budget_exhausted": s.num_budget_exhausted, "launches": kernel.launches,
            "split": G, "checked_scenario": b}


def shortcutting(dev, m: dict) -> tuple[dict, dict]:
    """Phase 25: shortcut_path (ShortcutConfig()) on phase 5's seed-0 demo
    path through B1, the card's result equal to the plain twin's driven on
    the card; shortcut_batch on phase 22's solved paths through B6; then
    the quality pipeline's shape (tools/r5_quality_pipeline.py:97-118):
    arena B=128, R=1,024, 150 windows, 'cuda_rng', one extension, then 256
    rounds x 256 candidates. Every shortened path replays valid and ends in
    its goal. Returns the record and the pipeline's shortened batch, which
    phase 28 refines."""
    from cudasbmp_torch import KGMT, KGMTConfig, Scenario
    from cudasbmp_torch import shortcut as sc
    from cudasbmp_torch.ops import rollout_cuda as rc
    from cudasbmp_torch.parallel import ArenaMultiQueryPlanner

    out = {}
    cfg, demo = KGMTConfig(), Scenario.demo()
    planner = KGMT(cfg, device=dev)
    path = planner.plan(demo, seed=0).path
    rc.reset_launch_counts()
    t0 = time.perf_counter()
    card = sc.shortcut_path(planner.system, cfg, path, demo.goal, demo.obstacles,
                            device=dev)
    wall = time.perf_counter() - t0
    b1 = rc.rollout_cuda.launches
    G1 = rc.lanes_per_rollout(SHORTCUT_CANDIDATES, rc.sm_count(dev.index or 0))
    check(b1 > 0 and rc.rollout_cuda.splits == {G1: b1}
          and rc.rollout_batched_cuda.launches == 0,
          f"shortcut_path: B1 {b1} at G {dict(rc.rollout_cuda.splits)}")
    saved = sc.rollout_cuda
    sc.rollout_cuda = rc.rollout_soa  # the kernel's plain twin, on the card
    try:
        twin = sc.shortcut_path(planner.system, cfg, path, demo.goal, demo.obstacles,
                                device=dev)
    finally:
        sc.rollout_cuda = saved
    check(card["n_edges"] == twin["n_edges"]
          and np.array_equal(card["path"].view(np.uint32), twin["path"].view(np.uint32)),
          f"shortcut_path: the card's {card['n_edges']} edges differ from the twin's "
          f"{twin['n_edges']}")
    one = card["path"]
    check_paths("shortcut_path", planner.system, cfg, one[None], np.array([len(one)]),
                [card["cost_after"]], demo.goal[None], demo.obstacles)
    out["path"] = {"edges_before": len(path) - 1, "edges_after": card["n_edges"],
                   "cost_before": card["cost_before"], "cost_after": card["cost_after"],
                   "wall_time_s": wall, "b1_launches": b1, "split": G1}

    rc.reset_launch_counts()
    t0 = time.perf_counter()
    batch = sc.shortcut_batch(planner.system, cfg, m["paths"], m["path_lengths"],
                              m["goals"], m["obstacles"], device=dev)
    wall = time.perf_counter() - t0
    out["multi"] = shortcut_record("shortcut_batch on [22]", planner.system, cfg, batch,
                                   m, wall, dev)

    qcfg = KGMTConfig(rollouts_per_iter=QUALITY_R, num_iterations=150,
                      rollout_backend="cuda_rng", adaptive_waves=False)
    arena = ArenaMultiQueryPlanner(qcfg, auto_capacity=True, device=dev)
    inits, goals, obstacles = jittered_demo(QUALITY_B, 0, jitter=0.0)
    arena.plan_batch(inits, goals, obstacles, seed=7)  # warm-up
    t0 = time.perf_counter()
    res = arena.plan_batch(inits, goals, obstacles, seed=8, max_extensions=1)
    solve_wall = time.perf_counter() - t0
    scfg = sc.ShortcutConfig(rounds=256, candidates=SHORTCUT_CANDIDATES)
    sc.shortcut_batch(planner.system, qcfg, res.paths, res.path_lengths, goals, obstacles,
                      scfg, seed=3, device=dev)  # warm-up
    rc.reset_launch_counts()
    t0 = time.perf_counter()
    batch = sc.shortcut_batch(planner.system, qcfg, res.paths, res.path_lengths, goals,
                              obstacles, scfg, seed=4, device=dev)
    wall = time.perf_counter() - t0
    q = {"paths": res.paths, "path_lengths": res.path_lengths, "costs": res.costs,
         "goals": goals, "obstacles": obstacles}
    out["quality"] = shortcut_record("shortcut_batch, quality pipeline", planner.system,
                                     qcfg, batch, q, wall, dev)
    out["quality"].update(arena_solve_rate=float(res.solved.mean()),
                          arena_wall_time_s=solve_wall)
    return out, {"cfg": qcfg, "paths": batch["paths"], "path_lengths": batch["path_lengths"],
                 "costs": batch["cost_after"], "goals": goals, "obstacles": obstacles}


def shortcut_record(tag: str, system, cfg, batch: dict, before: dict, wall: float,
                    dev) -> dict:
    """Check a shortcut_batch result (every shortened path valid, in its
    goal, no costlier than before, unsolved rows untouched; every rollout
    through B6) and summarise it."""
    from cudasbmp_torch.ops import rollout_cuda as rc

    lengths = batch["path_lengths"]
    solved = before["path_lengths"] >= 2
    check(np.array_equal(lengths[~solved], before["path_lengths"][~solved])
          and bool((lengths[solved] <= before["path_lengths"][solved]).all()),
          f"{tag}: path lengths {lengths}")
    check(bool((batch["cost_after"][solved] <= batch["cost_before"][solved] + 1e-5).all()),
          f"{tag}: a path got costlier")
    worst = check_paths(tag, system, cfg, batch["paths"], lengths, batch["cost_after"],
                        before["goals"], before["obstacles"])
    b6 = rc.rollout_batched_cuda.launches
    G = rc.lanes_per_rollout(len(lengths) * SHORTCUT_CANDIDATES, rc.sm_count(dev.index or 0))
    check(b6 > 0 and rc.rollout_cuda.launches == 0 and rc.rollout_batched_cuda.splits == {G: b6},
          f"{tag}: B6 {b6} at G {dict(rc.rollout_batched_cuda.splits)}, B1 "
          f"{rc.rollout_cuda.launches}")
    return {"paths": int(solved.sum()), "cost_before_p10_p50_p90":
            quantiles(batch["cost_before"][solved]),
            "cost_after_p10_p50_p90": quantiles(batch["cost_after"][solved]),
            "edges_before_mean": float(before["path_lengths"][solved].mean() - 1),
            "edges_after_mean": float(lengths[solved].mean() - 1),
            "wall_time_s": wall, "b6_launches": b6, "split": G, "replay_max_err": worst}


def run_vmap_cli() -> dict:
    """Phase 26: the CLI's default multi and sweep (--impl vmap) and demo
    --shortcut, as subprocesses on the card."""
    runs = {"multi": ["multi"], "sweep": ["sweep"], "demo_shortcut": ["demo", "--shortcut"]}
    out = {}
    for tag, args in runs.items():
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "cudasbmp_torch.cli", *args],
                           cwd=ROOT, capture_output=True, text=True, timeout=300)
        check(p.returncode == 0, f"cli {tag}: exit {p.returncode}\n{p.stdout[-2000:]}"
              f"\n{p.stderr[-2000:]}")
        rec = {"seconds": time.perf_counter() - t0}
        if tag == "demo_shortcut":
            line = p.stdout.splitlines()[3]
            check(re.fullmatch(r"shortcut: cost \d+\.\d{3} -> \d+\.\d{3} \(\d+ -> \d+ "
                               r"edges\)", line) is not None, f"cli {tag}: {line!r}")
            rec["line"] = line
        else:
            summary = json.loads(p.stdout[p.stdout.index("{"):p.stdout.rindex("}") + 1])
            check(summary["solve_rate"] > 0.5, f"cli {tag}: {summary}")
            rec["summary"] = summary
        out[tag] = rec
    return out


def refine_inputs(name: str, B: int, L: int, num_disc: int, seed: int, dev,
                  masked: bool, per_problem: bool):
    """R1's inputs from a numpy generator (tests/test_torch_cuda.py's):
    starts in the middle of the workspace, controls in the system's box,
    the last third of each problem's edges masked (duration 0, weight 0)
    with ``masked``, goals in the workspace, the demo's boxes shared or 8
    random boxes per problem."""
    from cudasbmp_torch.config import Scenario
    from cudasbmp_torch.systems.registry import get_system

    system = get_system(name)
    r = np.random.default_rng(seed)
    lo = np.asarray(system.control_spec.lo, np.float32)
    hi = np.asarray(system.control_spec.hi, np.float32)
    x0 = np.zeros((B, 4), np.float32)
    x0[:, :2] = r.uniform(6.0, 14.0, (B, 2))
    if name in ("bicycle", "unicycle", "dubins"):
        x0[:, 2] = r.uniform(-np.pi, np.pi, B)
    elif name == "double_integrator":
        x0[:, 2] = r.uniform(-1.0, 1.0, B)
    if name in ("bicycle", "double_integrator"):
        x0[:, 3] = r.uniform(-1.0, 1.0, B)
    controls = (lo + (hi - lo) * r.uniform(size=(B, L, 3))).astype(np.float32)
    controls[..., 2] *= np.float32(0.3)
    wts = np.ones((B, L), np.float32)
    if masked:
        keep = np.maximum(1, L - L // 3 - r.integers(0, 2, B))
        wts = (np.arange(L)[None] < keep[:, None]).astype(np.float32)
        controls[..., 2] *= wts
    goal = r.uniform(2.0, 18.0, (B, 2)).astype(np.float32)
    if per_problem:
        c = r.uniform(2.0, 18.0, (B, 8, 2))
        h = r.uniform(0.3, 2.0, (B, 8, 2))
        obs = np.concatenate([c - h, c + h], -1).astype(np.float32)
    else:
        obs = Scenario.demo().padded_obstacles(8)[0]
    return system, [torch.tensor(a, device=dev) for a in (x0, controls, wts, goal, obs)]


def refine_kw(cfg, rcfg) -> dict:
    return dict(num_disc=cfg.num_disc, width=cfg.width, height=cfg.height,
                margin=rcfg.margin, goal_threshold=cfg.goal_threshold,
                collision_weight=rcfg.collision_weight, goal_weight=rcfg.goal_weight)


def r1_against_twin(system, x0, c, w, goal, obs, kw) -> tuple[float, float]:
    """R1's launch against its twin under autograd on the same inputs: the
    forward states bitwise, the penalty within rtol R1_RTOL and the gradient
    within R1_GRAD_RTOL of its norm, per problem. Returns (the loss's
    largest abs error, the gradient's largest error over its norm)."""
    from cudasbmp_torch.ops import refine_cuda as rf

    loss, grad, states = rf._launch(system, x0, c, w, goal, obs, **kw)
    pts = rf.unroll_positions(system, x0, c, kw["num_disc"])
    check(torch.equal(states[:, 1:, :2].contiguous().view(torch.int32),
                      pts.contiguous().view(torch.int32)),
          f"R1 {system.name}: forward states differ from the twin's")
    cr = c.clone().requires_grad_()
    twin = rf.refine_penalty_torch(system, x0, cr, w, goal, obs, **kw)
    (tgrad,) = torch.autograd.grad(twin.sum(), cr)
    twin = twin.detach()
    loss_err = (loss - twin).abs()
    check(bool((loss_err <= R1_RTOL * twin.abs() + 1e-6).all()),
          f"R1 {system.name}: loss {loss.tolist()} vs twin {twin.tolist()}")
    rel = ((grad - tgrad).flatten(1).norm(dim=1)
           / tgrad.flatten(1).norm(dim=1).clamp(min=1e-30))
    check(bool((rel <= R1_GRAD_RTOL).all()), f"R1 {system.name}: gradient errors {rel.tolist()}")
    return float(loss_err.max()), float(rel.max())


def refine_batch_inputs(system, batch: dict, dev):
    """R1's inputs for a batch of padded paths (refine_batch's layout):
    x0, masked controls, weights, goals and the shared boxes."""
    paths, lengths = batch["paths"], batch["path_lengths"]
    Lmax = paths.shape[1]
    mask = np.arange(Lmax - 1)[None, :] < (lengths[:, None] - 1)
    c = paths[:, 1:, 4:].copy()
    c[..., 2] *= mask
    return [torch.tensor(np.ascontiguousarray(a), device=dev) for a in (
        paths[:, 0, :4], c, mask.astype(np.float32), batch["goals"][:, :2],
        batch["obstacles"])]


def inside_pairs(system, x0, c, obs, margin: float, num_disc: int) -> int:
    """(point, box) pairs inside a margin-inflated box: the data-dependent
    part of R1's work (probes/roofline.py::refine_ops)."""
    from cudasbmp_torch.ops import refine_cuda as rf

    pts = rf.unroll_positions(system, x0, c, num_disc)
    o = obs if obs.dim() == 3 else obs[None]
    px, py = pts[..., 0, None], pts[..., 1, None]
    dx = torch.maximum(o[:, None, :, 0] - margin - px, px - o[:, None, :, 2] - margin)
    dy = torch.maximum(o[:, None, :, 1] - margin - py, py - o[:, None, :, 3] - margin)
    return int((torch.maximum(dx, dy) < 0).sum())


def check_r1(dev, quality: dict) -> dict:
    """Phase 27: R1 against its plain twin for every system, with and
    without masked edges, shared and per-problem boxes, at T of 1 to 1,510
    points (8 problems each), then on the CLI demo path's and the quality
    pipeline's inputs. Device ms of R1 at the CLI demo path's shape (B = 1)
    and at the pipeline's (B = 128), of its twin's value and gradient at
    the demo path's (the twin's Adam step at the pipeline's shape is phase
    28's), of R1 at B = 1 on the pipeline's longest path (its serial
    chain), and the bounds."""
    from cudasbmp_torch import KGMT, KGMTConfig, Scenario
    from cudasbmp_torch.ops import refine_cuda as rf
    from cudasbmp_torch.probes import roofline as rfl
    from cudasbmp_torch.refine import RefineConfig

    cfg, rcfg = KGMTConfig(), RefineConfig()
    kw = refine_kw(cfg, rcfg)
    loss_err = grad_err = 0.0
    cases = 0
    for name in SYSTEMS:
        for L, nd in R1_SHAPES:
            for masked in (False, True):
                for per_problem in (False, True):
                    system, (x0, c, w, goal, obs) = refine_inputs(
                        name, 8, L, nd, L + 7 * masked, dev, masked, per_problem)
                    le, ge = r1_against_twin(system, x0, c, w, goal, obs,
                                             dict(kw, num_disc=nd))
                    loss_err, grad_err = max(loss_err, le), max(grad_err, ge)
                    cases += 1
    planner = KGMT(cfg, device=dev)
    demo = Scenario.demo()
    path = planner.plan(demo).path  # the CLI's demo: KGMTConfig().seed
    L = len(path) - 1
    one = [torch.tensor(np.ascontiguousarray(a), device=dev) for a in (
        path[None, 0, :4], path[None, 1:, 4:], np.ones((1, L), np.float32),
        demo.goal[None, :2], demo.obstacles)]
    pipe = refine_batch_inputs(planner.system, quality, dev)
    lengths = quality["path_lengths"]
    longest = int(np.argmax(lengths))
    n = int(lengths[longest]) - 1
    chain = [t[longest:longest + 1, :n].contiguous() for t in pipe[1:3]]
    chain = [pipe[0][longest:longest + 1], *chain, pipe[3][longest:longest + 1], pipe[4]]
    for inputs in (one, pipe):
        le, ge = r1_against_twin(planner.system, *inputs, kw)
        loss_err, grad_err = max(loss_err, le), max(grad_err, ge)
    t: dict = {}

    def twin(x0, c, w, goal, obs):
        cr = c.clone().requires_grad_()
        return torch.autograd.grad(
            rf.refine_penalty_torch(planner.system, x0, cr, w, goal, obs, **kw).sum(), cr)

    timed(t, "demo", lambda: rf._launch(planner.system, *one, **kw))
    timed(t, "demo_plain", lambda: twin(*one), PLAIN_CALLS, plain=True)
    timed(t, "pipeline", lambda: rf._launch(planner.system, *pipe, **kw))
    timed(t, "chain", lambda: rf._launch(planner.system, *chain, **kw))
    B, Lm = pipe[1].shape[:2]
    edges = int((lengths[lengths >= 2] - 1).sum())
    demo_bound = rfl.refine_bound_ms(
        "bicycle", 1, L, L * cfg.num_disc, len(demo.obstacles),
        inside_pairs(planner.system, one[0], one[1], one[4], rcfg.margin, cfg.num_disc),
        False)
    # the pipeline's launch integrates every padded edge too (duration 0)
    pipe_bound = rfl.refine_bound_ms(
        "bicycle", B, B * Lm, B * Lm * cfg.num_disc, pipe[4].shape[0],
        inside_pairs(planner.system, pipe[0], pipe[1], pipe[4], rcfg.margin, cfg.num_disc),
        False)
    return {"cases": cases, "shapes": [list(s) for s in R1_SHAPES],
            "max_abs_err": loss_err, "grad_rel_err": grad_err,
            "demo_edges": L, "pipeline_problems": int(B), "pipeline_edges": int(Lm),
            "pipeline_path_edges": edges, "chain_edges": int(lengths[longest] - 1),
            "demo_bound_ms": demo_bound[0], "demo_bound_by": demo_bound[1],
            "pipeline_bound_ms": pipe_bound[0], "pipeline_bound_by": pipe_bound[1], **t}


def whole_refinement(dev, quality: dict) -> dict:
    """Phase 27, continued: refine_adam_kernel (the whole refinement in one
    launch) against the step path (R1 and torch's Adam ops, 401 R1
    launches) to the bit at RefineConfig() on the CLI demo path and on
    [25]'s pipeline, cut to its longest real path as refine_batch runs it
    and padded to its full width (against the padded step path both), and
    against its plain twin at ADAM_TWIN_STEPS steps. Device ms a refinement
    at both shapes, at ADAM_ROW_STEPS steps beside the twin's, on the
    pipeline's longest path alone (its serial chains), and either side of
    the switch to global scratch (at the least L whose working set passes
    the shared memory a block may take); the step path's wall a
    refinement; the bounds."""
    from cudasbmp_torch import KGMT, KGMTConfig, Scenario
    from cudasbmp_torch import refine as tr
    from cudasbmp_torch.ops import refine_cuda as rf
    from cudasbmp_torch.probes import roofline as rfl
    from cudasbmp_torch.probes import timing

    cfg, rcfg = KGMTConfig(), tr.RefineConfig()
    qcfg = quality["cfg"]
    planner = KGMT(cfg, device=dev)
    demo = Scenario.demo()
    path = planner.plan(demo).path  # the CLI's demo: KGMTConfig().seed
    system = planner.system

    def t(a):
        return torch.tensor(np.ascontiguousarray(a), device=dev)

    L = len(path) - 1
    one = [t(path[None, 0, :4]), t(demo.goal[None, :2]), t(demo.obstacles),
           t(path[None, 1:, 4:]), torch.ones((1, L), dtype=torch.bool, device=dev)]
    paths, lengths = quality["paths"], quality["path_lengths"]
    Lmax = paths.shape[1]
    n = min(max(int(lengths.max()) - 1, 1), Lmax - 1)  # refine_batch's cut
    padded = [t(paths[:, 0, :4]), t(quality["goals"][:, :2]), t(quality["obstacles"]),
              t(paths[:, 1:, 4:]), t(np.arange(Lmax - 1)[None] < (lengths[:, None] - 1))]
    pipe = padded[:3] + [x[:, :n].contiguous() for x in padded[3:]]
    longest = int(np.argmax(lengths))
    chain = [x[longest:longest + 1].contiguous() for x in pipe[:2]] + [pipe[2]] + [
        x[longest:longest + 1].contiguous() for x in pipe[3:]]

    def adam(c, inputs, rc=rcfg):
        x0, goal, obs, c0, mask = inputs
        return tr._refine_core(system, c, rc, x0, goal, obs, c0, mask)

    def step_path(c, inputs, rc=rcfg, penalty=rf.refine_penalty_cuda):
        x0, goal, obs, c0, mask = inputs
        return tr._refine_core(system, c, rc, x0, goal, obs, c0, mask, penalty)

    out: dict = {"demo_edges": L, "pipeline_problems": len(lengths),
                 "pipeline_edges": int(n), "pipeline_padded_edges": int(Lmax - 1)}
    walls, r1_launches = {}, {}
    for tag, c, inputs in (("demo", cfg, one), ("pipeline_padded", qcfg, padded)):
        step_path(c, inputs, tr.RefineConfig(iterations=2))  # warm-up
        torch.cuda.synchronize()
        rf.refine_penalty_cuda.launches = 0
        t0 = time.perf_counter()
        want = step_path(c, inputs)
        torch.cuda.synchronize()
        walls[tag] = time.perf_counter() - t0
        r1_launches[tag] = rf.refine_penalty_cuda.launches
        check(r1_launches[tag] == rcfg.iterations + 1,
              f"the step path {tag}: {r1_launches[tag]} R1 launches")
        shapes = [(tag, inputs)] + ([("pipeline", pipe)] if tag == "pipeline_padded" else [])
        for name, x in shapes:
            launches = rf.refine_adam_cuda.launches
            got = adam(c, x)
            check(rf.refine_adam_cuda.launches == launches + 1,
                  f"refine_adam_kernel {name}: {rf.refine_adam_cuda.launches - launches} launches")
            w = x[3].shape[1]
            check(bitwise(got[1], want[1]) and bitwise(got[0], want[0][:, :w].contiguous())
                  and bitwise(want[0][:, w:].contiguous(), inputs[3][:, w:].contiguous()),
                  f"refine_adam_kernel {name}: not the step path's bits")
    twin_err = 0.0
    few = tr.RefineConfig(iterations=ADAM_TWIN_STEPS)
    for tag, c, inputs in (("demo", cfg, one), ("pipeline", qcfg, pipe)):
        got = adam(c, inputs, few)
        want = step_path(c, inputs, few, rf.refine_penalty_torch)
        err = (got[0] - want[0]).abs()
        check(bool((err <= ADAM_TWIN_TOL + ADAM_TWIN_TOL * want[0].abs()).all()),
              f"refine_adam_kernel {tag}: controls {float(err.max())} from the twin's")
        lerr = (got[1][:2] - want[1][:2]).abs()
        check(bool((lerr <= ADAM_TWIN_TOL * want[1][:2].abs()).all()),
              f"refine_adam_kernel {tag}: losses {lerr.tolist()} from the twin's")
        twin_err = max(twin_err, float(err.max()))
    out["twin_max_abs_err"] = twin_err
    out["step_path_wall_s"], out["step_path_r1_launches"] = walls, r1_launches
    # the switch to global scratch: the least L (num_disc 10) past the limit
    nd = qcfg.num_disc
    limit = rf.adam_workspace(system, 1, nd, dev)[1]
    lo, hi = 1, 2
    while rf.adam_workspace(system, hi, nd, dev)[0] <= limit:
        lo, hi = hi, 2 * hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if rf.adam_workspace(system, mid, nd, dev)[0] <= limit else (lo, mid)
    out["switch"] = {"edges": hi, "points": hi * nd, "shared_limit_bytes": limit,
                     "bytes_at_switch": rf.adam_workspace(system, hi, nd, dev)[0],
                     "bytes_below": rf.adam_workspace(system, lo, nd, dev)[0]}
    below = refine_inputs("bicycle", 1, lo, nd, 27, dev, False, False)[1]
    past = refine_inputs("bicycle", 1, hi, nd, 27, dev, False, False)[1]
    below = [below[0], below[3], below[4], below[1],
             torch.ones((1, lo), dtype=torch.bool, device=dev)]
    past = [past[0], past[3], past[4], past[1], torch.ones((1, hi), dtype=torch.bool,
                                                            device=dev)]
    rf.refine_adam_cuda.workspaces.clear()
    adam(qcfg, below)
    adam(qcfg, past)
    check(rf.refine_adam_cuda.workspaces == {"shared": 1, "global": 1},
          f"refine_adam_kernel at the switch: {dict(rf.refine_adam_cuda.workspaces)}")
    row = tr.RefineConfig(iterations=ADAM_ROW_STEPS)
    tm: dict = {}
    timed(tm, "demo", lambda: adam(cfg, one), 3)
    timed(tm, "demo_row", lambda: adam(cfg, one, row), 3)
    d = timing.device_ms(lambda: step_path(cfg, one, row, rf.refine_penalty_torch), 1,
                         tries=3, windows=1)
    tm["demo_row_plain_launch_ms"] = timing.time_ms(
        lambda: step_path(cfg, one, row, rf.refine_penalty_torch), 1)
    tm["demo_row_plain_ms"] = d.ms if d.regular else tm["demo_row_plain_launch_ms"]
    tm["demo_row_plain_regular"] = d.regular
    timed(tm, "pipeline", lambda: adam(qcfg, pipe), 3)
    timed(tm, "pipeline_padded", lambda: adam(qcfg, padded), 3)
    timed(tm, "chain", lambda: adam(qcfg, chain), 3)
    timed(tm, "switch_below", lambda: adam(qcfg, below), 1)
    timed(tm, "switch_past", lambda: adam(qcfg, past), 1)
    out.update(tm)
    for k in ("demo", "pipeline", "pipeline_padded", "chain", "switch_below", "switch_past"):
        out[f"{k}_step_ms"] = out[f"{k}_ms"] / rcfg.iterations
    margin = rcfg.margin

    def bound(x, c, steps):
        x0, goal, obs, c0, mask = x
        cm = c0 * torch.cat([torch.ones_like(c0[..., :2]), mask[..., None].float()], -1)
        real = int(mask.sum())
        return rfl.refine_adam_bound_ms(
            "bicycle", x0.shape[0], c0.shape[0] * c0.shape[1], real, real * c.num_disc,
            obs.shape[-2], inside_pairs(system, x0, cm, obs, margin, c.num_disc) * (steps + 1),
            steps, obs.dim() == 3)

    for k, c, x, steps in (("demo", cfg, one, rcfg.iterations),
                           ("demo_row", cfg, one, ADAM_ROW_STEPS),
                           ("pipeline", qcfg, pipe, rcfg.iterations)):
        out[f"{k}_bound_ms"], out[f"{k}_bound_by"] = bound(x, c, steps)
    return out


def adam_steps(system, cfg, rcfg, inputs, penalty, count: bool = True) -> dict:
    """An Adam step of refine.py::_refine_core with ``penalty`` (R1's
    wrapper or its twin) on ``inputs`` (x0, controls, mask, goals, boxes):
    wall ms a step over a run of 2 steps after one warm-up run, device ms a
    step (probes/timing.py over one run) and, with ``count``, kernel
    launches a step (the profiler's runtime-API records of runs of 3 steps
    less those of 1 step, over 2)."""
    import dataclasses

    from cudasbmp_torch.probes import timing
    from cudasbmp_torch.refine import _refine_core

    x0, c0, mask, goal, obs = inputs

    def run(steps: int):
        few = dataclasses.replace(rcfg, iterations=steps)
        return lambda: _refine_core(system, cfg, few, x0, goal, obs, c0, mask, penalty)

    run(2)()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(2)()
    torch.cuda.synchronize()
    out = {"step_wall_ms": (time.perf_counter() - t0) / 2 * 1e3}
    d = timing.device_ms(run(2), 1, tries=3, windows=1)
    out.update(step_device_ms=d.ms / 2 if d.ms is not None else None,
               step_regular_windows=d.regular)
    if count:
        out["step_launches"] = (runtime_launches(run(3), 1)
                                - runtime_launches(run(1), 1)) / 2
    return out


def refinement(dev, quality: dict) -> tuple[dict, dict]:
    """Phase 28: the CLI's demo --refine as a subprocess; refine_path on
    the CLI demo's path (one launch of the whole refinement, then B1 an
    edge) and refine_batch at RefineConfig() on phase 25's quality-pipeline
    output (one launch, then B6 an edge of its longest real path), with the
    launch counts set to 0 just before and read just after; every kept path
    replays valid and ends in its goal. Then the walls of the step path's
    Adam steps with R1 and with its twin, at 2 steps. Returns the record
    and the main path's launch counts."""
    from cudasbmp_torch import KGMT, KGMTConfig, Scenario
    from cudasbmp_torch import refine as tr
    from cudasbmp_torch.ops import refine_cuda as rf
    from cudasbmp_torch.ops import rollout_cuda as rc

    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "cudasbmp_torch.cli", "demo", "--refine"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    check(p.returncode == 0, f"cli demo --refine: exit {p.returncode}\n"
          f"{p.stdout[-2000:]}\n{p.stderr[-2000:]}")
    line = p.stdout.splitlines()[3]
    check(re.fullmatch(r"refine: cost \d+\.\d{3} -> \d+\.\d{3} \((kept|rejected — "
                       r"original retained); hard-revalidation (ok|FAILED)\)", line)
          is not None, f"cli demo --refine: {line!r}")
    out = {"cli": {"line": line, "wall_s": time.perf_counter() - t0}}

    cfg, rcfg, demo = KGMTConfig(), tr.RefineConfig(), Scenario.demo()
    planner = KGMT(cfg, device=dev)
    path = planner.plan(demo).path
    system = planner.system
    qcfg = quality["cfg"]
    lengths = quality["path_lengths"]
    solved = lengths >= 2
    tr.refine_batch(system, qcfg, quality["paths"], lengths, quality["goals"],
                    quality["obstacles"], tr.RefineConfig(iterations=2), device=dev)  # warm-up
    rc.reset_launch_counts()
    rf.refine_penalty_cuda.launches = rf.refine_adam_cuda.launches = 0
    t0 = time.perf_counter()
    one = tr.refine_path(system, cfg, path, demo.goal, demo.obstacles, device=dev)
    path_wall = time.perf_counter() - t0
    path_counts = (rf.refine_adam_cuda.launches, rf.refine_penalty_cuda.launches,
                   rc.rollout_cuda.launches, rc.rollout_batched_cuda.launches)
    t0 = time.perf_counter()
    ref = tr.refine_batch(system, qcfg, quality["paths"], lengths, quality["goals"],
                          quality["obstacles"], device=dev)
    batch_wall = time.perf_counter() - t0
    adam, r1 = rf.refine_adam_cuda.launches, rf.refine_penalty_cuda.launches
    b1, b6 = rc.rollout_cuda.launches, rc.rollout_batched_cuda.launches
    Lmax = quality["paths"].shape[1]
    longest = int(lengths.max()) - 1  # refine_batch replays up to it
    check(path_counts == (1, 0, len(path) - 1, 0),
          f"refine_path: whole refinement, R1, B1, B6 launches {path_counts}")
    check(adam == 2 and r1 == 0 and b1 == len(path) - 1 and b6 == longest,
          f"refine_batch: whole refinement {adam - 1}, R1 {r1}, B6 {b6} launches for "
          f"{longest} edges")
    check(bool(np.isfinite(ref["losses"]).all()) and np.isfinite(one["losses"]).all(),
          "refinement: non-finite losses")
    imp = ref["improved"]
    check(not (imp & ~solved).any() and bool((ref["cost_after"][imp]
                                              < ref["cost_before"][imp]).all()),
          "refine_batch: improved rows")
    # every kept path replays valid and ends in its goal: the exact
    # checker's (B6's) states beside the refined controls, replayed by the
    # plain exact rollout
    x0s = torch.tensor(quality["paths"][:, 0, :4], device=dev)
    masks = torch.tensor(np.arange(Lmax - 1)[None, :] < (lengths[:, None] - 1), device=dev)
    states, _, _ = tr._revalidate(
        system, qcfg, x0s, torch.tensor(quality["goals"][:, :2], device=dev),
        torch.tensor(np.broadcast_to(quality["obstacles"], (len(lengths),)
                                     + quality["obstacles"].shape).copy(), device=dev),
        torch.tensor(ref["controls"], device=dev), masks)
    kept = np.concatenate([np.concatenate([quality["paths"][:, :1, :4],
                                           states.cpu().numpy()], 1),
                           np.concatenate([quality["paths"][:, :1, 4:], ref["controls"]], 1)],
                          -1)
    worst = check_paths("refine_batch, kept paths", system, qcfg, kept,
                        np.where(imp, lengths, 0), ref["cost_after"], quality["goals"],
                        quality["obstacles"])
    final = np.where(imp, ref["cost_after"], ref["cost_before"])
    out["path"] = {"edges": len(path) - 1, "cost_before": one["cost_before"],
                   "cost_after": one["cost_after"], "valid": one["valid"],
                   "adam_launches": path_counts[0], "r1_launches": path_counts[1],
                   "b1_launches": path_counts[2], "wall_time_s": path_wall}
    out["batch"] = {"paths": int(solved.sum()), "edges_max": int(Lmax - 1),
                    "edges_longest": longest,
                    "improved": int(imp.sum()), "valid": int(ref["valid"].sum()),
                    "cost_before_p10_p50_p90": quantiles(ref["cost_before"][solved]),
                    "cost_after_p10_p50_p90": quantiles(final[solved]),
                    "adam_launches": adam - path_counts[0], "r1_launches": r1,
                    "b6_launches": b6, "wall_time_s": batch_wall, "replay_max_err": worst}
    inputs = refine_batch_inputs(system, quality, dev)
    shapes = {
        "demo": [torch.tensor(path[None, 0, :4], device=dev),
                 torch.tensor(path[None, 1:, 4:], device=dev),
                 torch.ones((1, len(path) - 1), dtype=torch.bool, device=dev),
                 torch.tensor(demo.goal[None, :2], device=dev),
                 torch.tensor(demo.obstacles, device=dev)],
        "pipeline": [inputs[0], torch.tensor(quality["paths"][:, 1:, 4:], device=dev),
                     masks, inputs[3], inputs[4]]}
    # the twin's step at the pipeline's shape is some 60,000 launches: its
    # count is left out
    out["adam_steps"] = {
        tag: {"r1": adam_steps(system, cfg if tag == "demo" else qcfg, rcfg, x,
                               rf.refine_penalty_cuda),
              "twin": adam_steps(system, cfg if tag == "demo" else qcfg, rcfg, x,
                                 rf.refine_penalty_torch, count=tag == "demo")}
        for tag, x in shapes.items()}
    return out, {"adam": adam, "r1": r1, "b1": b1, "b6": b6}


def checkpoint_record(dev, out_dir: pathlib.Path) -> dict:
    """Phase 29: the recorded solve of the demo (KGMTConfig()), a checkpoint
    of it saved and loaded on the card bit for bit, a resume from its
    checkpoint_5 equal to plan() on the demo (solved, iterations, tree size,
    cost, path bits), and the CLI's record as a subprocess."""
    import shutil

    from cudasbmp_torch import KGMT, KGMTConfig, Scenario
    from cudasbmp_torch.convert import state_to_numpy
    from cudasbmp_torch.io.checkpoint import load_checkpoint, save_checkpoint

    cfg, demo = KGMTConfig(), Scenario.demo()
    planner = KGMT(cfg, device=dev)
    rec_dir = out_dir / "record"
    shutil.rmtree(rec_dir, ignore_errors=True)
    t0 = time.perf_counter()
    recorded = planner.plan_recorded(demo, rec_dir / "lib", dump_every=1000,
                                     checkpoint_every=5)
    record_wall = time.perf_counter() - t0
    want = planner.plan(demo)
    state = load_checkpoint(rec_dir / "lib" / "checkpoint_5.npz", device=dev)
    save_checkpoint(state, rec_dir / "again.npz")
    again = load_checkpoint(rec_dir / "again.npz", device=dev)
    a, b = state_to_numpy(state), state_to_numpy(again)
    check(all(np.array_equal(a[k], b[k]) for k in a), "checkpoint: round trip differs")
    got = planner.resume(state, demo)

    def fields(r):
        return [r.solved, r.iterations, r.tree_size, r.cost,
                r.path.view(np.uint32).tolist()]

    check(fields(got) == fields(want) == fields(recorded),
          f"resume from checkpoint_5 {fields(got)[:4]} / recorded {fields(recorded)[:4]} "
          f"!= plan() {fields(want)[:4]}")
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "cudasbmp_torch.cli", "record", "--out-dir",
                        str(rec_dir / "cli"), "--dump-every", "1000",
                        "--checkpoint-every", "5"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    check(p.returncode == 0, f"cli record: exit {p.returncode}\n{p.stderr[-2000:]}")
    summary = json.loads(p.stdout)
    check([summary["solved"], summary["iterations"], summary["tree_size"]]
          == fields(want)[:3], f"cli record: {summary}")
    names = sorted(x.name for x in (rec_dir / "cli").iterdir())
    shutil.rmtree(rec_dir)
    return {"solved": want.solved, "iterations": want.iterations,
            "tree_size": want.tree_size, "cost": want.cost, "path_edges": len(want.path) - 1,
            "resumed_from": 5, "record_wall_time_s": record_wall,
            "cli_files": names, "cli_wall_s": time.perf_counter() - t0}


def profile_batched(dev, out_dir: pathlib.Path) -> dict:
    """torch.profiler over one arena solve at config 4's width ('auto', no
    extension) and one streaming sweep of 1024 scenarios in a pool of 1024:
    device busy time against the wall, and kernel launches per wave."""
    from torch.profiler import ProfilerActivity, profile

    from cudasbmp_torch import KGMTConfig
    from cudasbmp_torch.parallel import ArenaMultiQueryPlanner, StreamingMonteCarloPlanner
    from cudasbmp_torch.parallel import batch_kgmt as bk
    from cudasbmp_torch.parallel import streaming_mc as sm

    cfg = KGMTConfig(**SWEEP)
    inits, goals, obstacles = jittered_demo(ARENA_B, 0)
    arena = ArenaMultiQueryPlanner(cfg, auto_capacity=True, device=dev)
    stream = StreamingMonteCarloPlanner(cfg, pool=STREAM_POOL, device=dev)
    arena.plan_batch(inits, goals, obstacles, seed=7)
    stream.run(256, seed=0)
    runs = {"arena": (bk, "arena_solve", lambda: arena.plan_batch(inits, goals, obstacles,
                                                                  seed=8)),
            "streaming": (sm, "stream_solve", lambda: stream.run(1024, seed=1))}
    out = {}
    for tag, (module, fn, run) in runs.items():
        waves, undo = counting(module, fn, "it")
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            undo()
        events = prof.key_averages()
        (out_dir / f"profile_{tag}.txt").write_text(
            events.table(sort_by="cuda_time_total", row_limit=25))
        dev_us = [getattr(e, "self_device_time_total", None) for e in events]
        if None in dev_us:
            dev_us = [e.self_cuda_time_total for e in events]
        launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
        busy = sum(dev_us) / 1e6
        out[tag] = {"wall_s": wall, "device_busy_s": busy, "idle_share": 1 - busy / wall,
                    "waves": sum(waves), "launches_per_wave": launches / max(sum(waves), 1)}
    return out


def ptxas_summary(ptxas: dict, keep) -> str:
    """Registers and spill bytes of the kernels whose names ``keep`` takes."""
    rows = [v for k, v in ptxas.items() if keep(k)]
    regs = [v["registers"] for v in rows]
    spills = sum(v["spill_stores"] + v["spill_loads"] for v in rows)
    return (f"{len(rows)} kernels, registers {min(regs, default=0)}-{max(regs, default=0)}, "
            f"spill bytes {spills}")


def ptxas_table(log: str) -> dict:
    """{kernel instantiation: registers and spill bytes} from nvcc's
    -Xptxas -v output (names demangled with c++filt where it exists)."""
    table, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            table[name] = {"registers": 0, "spill_stores": 0, "spill_loads": 0}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            table[name]["spill_stores"] = int(m.group(1))
            table[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            table[name]["registers"] = int(m.group(1))
    try:
        out = subprocess.run(["c++filt"], input="\n".join(table), text=True,
                             capture_output=True, timeout=60, check=True).stdout
        names = out.splitlines()
    except (OSError, subprocess.SubprocessError):
        return table
    short = [re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", n) for n in names]
    return dict(zip(short, table.values())) if len(short) == len(table) else table


def profile_solve(cfg, dev, out_dir: pathlib.Path) -> dict:
    """torch.profiler over one demo solve: device time by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    from cudasbmp_torch import KGMT, Scenario

    planner = KGMT(cfg, device=dev)
    planner.plan(Scenario.demo(), seed=100)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        r = planner.plan(Scenario.demo(), seed=0)
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=25)
    (out_dir / "profile.txt").write_text(table)
    events = prof.key_averages()
    dev_us = [getattr(e, "self_device_time_total", None) for e in events]
    if None in dev_us:
        dev_us = [e.self_cuda_time_total for e in events]
    return {"wall_s": r.wall_time_s, "device_busy_s": sum(dev_us) / 1e6,
            "kernel_names": sum(t > 0 for t in dev_us)}


SHARDED_D = (1, 4)  # the CLI's tree axis on one card, and the library's four shards
SHARDED_SEEDS = range(4)
SHARDED_SCOPES = ("kgmt_scores", "kgmt_frontier", "kgmt_frontier_exchange", "kgmt_waves")
SOLVE_SCOPES = ("kgmt_scores", "kgmt_expand", "kgmt_region_stats", "kgmt_commit",
                "kgmt_goal")


def traced_scopes(log_dir: pathlib.Path) -> list[str]:
    """The user-annotation names of the one trace file under ``log_dir``."""
    files = list(log_dir.glob("*.pt.trace.json"))
    check(len(files) == 1, f"{log_dir}: {len(files)} trace files")
    events = json.loads(files[0].read_text())["traceEvents"]
    return sorted({e["name"] for e in events if e.get("cat") == "user_annotation"})


def iteration_costs(planner, dev, iterations: int = 3, start=None, mesh=None) -> dict:
    """Kernel launches and host reads an iteration of the sharded loop over
    ``iterations`` iterations of a fresh solve (``start() -> (state, goal,
    boxes)``; default the demo's at seed 0), with ``mesh``'s collectives:
    launches by the profiler's runtime-API records, host reads by torch's
    synchronization warnings (torch.cuda.set_sync_debug_mode)."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from cudasbmp_torch import Scenario
    from cudasbmp_torch.parallel import sharded_tree as st

    cfg = planner.config
    if start is None:
        goal, boxes = planner._inputs(Scenario.demo())

        def start():
            return planner._init(Scenario.demo(), 0, None), goal, boxes
    out = {}
    for mode in ("launches", "reads"):
        s, goal, boxes = start()
        _, trips = st.sharded_readout(cfg, s, mesh)
        torch.cuda.synchronize()

        def run():
            nonlocal trips
            for _ in range(iterations):
                st.sharded_iteration(cfg, planner.system, planner.grid, goal, boxes, s, trips,
                                     mesh)
                _, trips = st.sharded_readout(cfg, s, mesh)

        if mode == "launches":
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
            launches = sum(1 for e in prof.events() if "LaunchKernel" in e.name)
            out["launches_per_iteration"] = launches / iterations
            out["launches_per_trip"] = launches / s.trips
            out["measured_trips"] = s.trips
        else:
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    run()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            syncs = [str(w.message) for w in caught if "synchroniz" in str(w.message)]
            out["host_reads_per_iteration"] = len(syncs) / iterations
            out["sync_messages"] = syncs[:3]
    return out


def sharded_fields(r) -> list:
    """A ShardedTreeResult's solve fields, the path as a digest of its bits."""
    return [bool(r.solved), float(r.cost), int(r.best_shard), int(r.iterations),
            int(r.total_tree_size), r.tree_sizes_by_shard.tolist(), digest(r.path),
            r.path_shards.tolist()]


def sharded_tree(dev, out_dir: pathlib.Path) -> tuple[dict, dict, dict]:
    """Phase 30: ShardedTreePlanner on the demo at KGMTConfig() (M = 30,000
    slots a shard, R = 4,096, adaptive waves, exchange_frac 0.25,
    exchange_k 64) at D = 1 (the CLI's tree axis on one card) and D = 4
    shards, under 'auto' (every trip one launch of B6 over D x 4,096 lanes,
    one box set per shard) and 'cuda_rng' (B6's Philox form, keyed per
    shard), seeds 0-3: solved, cost, iterations, total tree size, best
    shard, whether the path crosses shards, identical score rows, wall; the
    paths replay; launches equal the trips; launches and host reads an
    iteration; at each D every trip's rows equal the plain twin's driven
    on the card, bitwise; plan_checkpointed (a checkpoint every 2 iterations)
    and a resume from its first checkpoint equal plan() to the bit; a
    trace names the sharded iteration's phases; validate_state on a demo
    single solve. Returns the record, the launches by kernel and, by backend,
    the D = 4 solves' fields (sharded_fields) and walls (phase 33)."""
    import shutil

    from cudasbmp_torch import KGMT, KGMTConfig, Scenario
    from cudasbmp_torch.ops import rollout_cuda as rc
    from cudasbmp_torch.parallel import ShardedTreePlanner, make_planner_mesh
    from cudasbmp_torch.utils.profiling import trace_to
    from cudasbmp_torch.utils.validate import validate_state

    demo = Scenario.demo()
    obstacles = demo.padded_obstacles(KGMTConfig().max_obstacles)[0]
    out, launches, d4 = {}, Counter(), {}
    for backend, kernel in (("auto", rc.rollout_batched_cuda),
                            ("cuda_rng", rc.sample_and_rollout_batched_cuda)):
        cfg = KGMTConfig(rollout_backend=backend)
        d4[backend] = {"fields": [], "walls": []}
        for D in SHARDED_D:
            tag = f"{backend}_D{D}"
            planner = ShardedTreePlanner(cfg, mesh=make_planner_mesh(n_tree=D,
                                                                     device=str(dev)))
            planner.plan(demo, seed=100)  # warm-up
            rows, trips = [], 0
            rc.reset_launch_counts()
            for seed in SHARDED_SEEDS:
                r = planner.plan(demo, seed=seed)
                trips += planner.last_state.trips
                if D == 4:
                    d4[backend]["fields"].append(sharded_fields(r))
                    d4[backend]["walls"].append(r.wall_time_s)
                check(bool((r.r1_scores_by_shard == r.r1_scores_by_shard[0]).all()),
                      f"sharded {tag}: seed {seed}: score rows differ")
                check(r.tree_sizes_by_shard.shape == (D,) and r.total_tree_size
                      == int(r.tree_sizes_by_shard.sum()) <= D * cfg.max_tree_size,
                      f"sharded {tag}: seed {seed}: tree sizes {r.tree_sizes_by_shard}")
                if r.solved:
                    check(r.path_shards[-1] == r.best_shard and r.path_shards.shape
                          == (len(r.path),), f"sharded {tag}: seed {seed}: path shards")
                    check_paths(f"sharded {tag} seed {seed}", planner.system, cfg,
                                r.path[None], np.array([len(r.path)]), np.array([r.cost]),
                                demo.goal[None], obstacles)
                rows.append({"seed": seed, "solved": r.solved, "cost": r.cost,
                             "iterations": r.iterations,
                             "total_tree_size": r.total_tree_size,
                             "tree_sizes_by_shard": r.tree_sizes_by_shard.tolist(),
                             "best_shard": r.best_shard,
                             "path_crosses_shards": len(set(r.path_shards.tolist())) > 1,
                             "path_edges": len(r.path) - 1,
                             "identical_score_rows": True,
                             "trips": planner.last_state.trips,
                             "wall_time_s": r.wall_time_s})
            counts = {w.__name__: w.launches for w in rc.WRAPPERS}
            main = counts.pop(kernel.__name__)
            check(main == trips and set(counts.values()) == {0},
                  f"sharded {tag}: launches {main} {counts} for {trips} trips")
            launches[kernel.__name__] += main
            solved = [x for x in rows if x["solved"]]
            check(len(solved) >= 3, f"sharded {tag}: {len(solved)} of 4 seeds solved")
            if D > 1:
                check(any(x["path_crosses_shards"] for x in solved),
                      f"sharded {tag}: no path crosses shards")
            out[tag] = {
                "n_tree": D, "seeds": rows, "solve_rate": len(solved) / len(rows),
                "cost_p50": float(np.median([x["cost"] for x in solved])),
                "iterations": sum(x["iterations"] for x in rows), "trips": trips,
                "launches": main, "splits": dict(kernel.splits),
                "wall_p50_s": float(np.median([x["wall_time_s"] for x in rows])),
                **iteration_costs(planner, dev)}
            check(out[tag]["host_reads_per_iteration"] == 1,
                  f"sharded {tag}: host reads an iteration {out[tag]}")
            out[tag]["twin_trips_bitwise"] = sharded_twin_check(
                planner, lambda: planner.plan(demo, seed=0), kernel)
    # plan_checkpointed and resume, D = 4, auto
    cfg = KGMTConfig()
    planner = ShardedTreePlanner(cfg, mesh=make_planner_mesh(n_tree=4, device=str(dev)))
    ck = out_dir / "sharded_checkpoints"
    shutil.rmtree(ck, ignore_errors=True)

    def fields(r):
        return [r.solved, r.cost, r.iterations, r.total_tree_size, r.best_shard,
                r.tree_sizes_by_shard.tolist(), r.path.view(np.uint32).tolist(),
                r.path_shards.tolist()]

    want = fields(planner.plan(demo, seed=0))
    chunked = fields(planner.plan_checkpointed(demo, ck / "run", checkpoint_every=2, seed=0))
    files = sorted((ck / "run").glob("sharded_checkpoint_*.npz"),
                   key=lambda q: int(q.stem.split("_")[-1]))
    resumed = fields(planner.plan_checkpointed(demo, ck / "resumed", checkpoint_every=2,
                                               resume_from=files[0]))
    check(chunked == want == resumed, f"plan_checkpointed {chunked[:5]} / resumed "
          f"{resumed[:5]} != plan() {want[:5]}")
    out["checkpointed"] = {"checkpoints": [q.name for q in files], "resumed_from": files[0].name,
                           "equal_to_plan": True, "solved": want[0], "cost": want[1],
                           "iterations": want[2], "total_tree_size": want[3]}
    shutil.rmtree(ck)
    # the trace of a short sharded solve names the iteration's phases
    trace_dir = out_dir / "sharded_trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    short = ShardedTreePlanner(cfg.replace(num_iterations=3),
                               mesh=make_planner_mesh(n_tree=4, device=str(dev)))
    with trace_to(trace_dir):
        short.plan(demo)
    names = traced_scopes(trace_dir)
    check(set(SHARDED_SCOPES) <= set(names), f"sharded trace names {names}")
    shutil.rmtree(trace_dir)
    out["trace_scopes"] = names
    # the state validator on the demo's single solve
    single = KGMT(cfg, device=dev).plan(demo, seed=0)
    out["validate_state"] = validate_state(single.state, cfg)
    check(out["validate_state"]["solved"] and out["validate_state"]["tree_size"]
          == single.tree_size, f"validate_state {out['validate_state']}")
    return out, dict(launches), d4


def sharded_twin_check(planner, solve, kernel, trips: int | None = None) -> int:
    """Every trip of ``solve()`` (or its first ``trips``): the rows of B6
    (or its Philox form) equal the plain twin's driven on the card, on the
    same inputs, to the bit. Returns the trips compared."""
    from cudasbmp_torch.ops import rollout_cuda as rc
    from cudasbmp_torch.parallel import multi_query as mq

    cfg, system = planner.config, planner.system
    kw = dict(num_disc=cfg.num_disc, width=cfg.width, height=cfg.height)
    rollout, compared = mq._rollout, 0

    def spy(c, sys_, k_ctrl, x0, obstacles):
        nonlocal compared
        x1, controls, valid = rollout(c, sys_, k_ctrl, x0, obstacles)
        if trips is not None and compared >= trips:
            return x1, controls, valid
        if kernel is rc.rollout_batched_cuda:
            tx1, tvalid = rc.rollout_soa(sys_, x0, controls, obstacles, **kw)
        else:
            tx1, tc, tvalid = rc.sample_and_rollout_torch(sys_, k_ctrl, x0, obstacles, **kw)
            check(bitwise(tc, controls), "sharded: Philox controls differ from the twin")
        check(bitwise(tx1, x1) and torch.equal(tvalid, valid),
              f"sharded {kernel.__name__}: a trip's rows differ from the twin")
        compared += 1
        return x1, controls, valid

    mq._rollout = spy
    try:
        solve()
    finally:
        mq._rollout = rollout
    return compared


def sharded_cli(out_dir: pathlib.Path) -> dict:
    """Phase 31: the CLI's sharded (the card count's tree axis: D = 1 on one
    card), its --checkpoint-dir and --resume-from, profile (the trace file
    and its phase names) and the plots (demo --plot --out-dir, viz: exit 2
    with a message where matplotlib is absent, else the PNGs) as
    subprocesses on the card."""
    import importlib.util
    import shutil

    base = out_dir / "cli_phase31"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)

    def cli(*argv, timeout=600):
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "cudasbmp_torch.cli", *argv], cwd=ROOT,
                           capture_output=True, text=True, timeout=timeout)
        return p, time.perf_counter() - t0

    out = {}
    p, wall = cli("sharded")
    check(p.returncode in (0, 1), f"cli sharded: exit {p.returncode}\n{p.stderr[-2000:]}")
    plain = json.loads(p.stdout)
    check(plain["n_tree"] == torch.cuda.device_count(), f"cli sharded: {plain}")
    p, _ = cli("sharded", "--checkpoint-dir", str(base / "ck"), "--checkpoint-every", "4")
    chunked = json.loads(p.stdout)
    first = sorted((base / "ck").glob("sharded_checkpoint_*.npz"),
                   key=lambda q: int(q.stem.split("_")[-1]))[0]
    p, _ = cli("sharded", "--checkpoint-dir", str(base / "ck2"), "--resume-from", str(first))
    resumed = json.loads(p.stdout)
    same = [{k: v for k, v in d.items() if k != "wall_time_s"}
            for d in (plain, chunked, resumed)]
    check(same[0] == same[1] == same[2], f"cli sharded: {same}")
    out["sharded"] = {"summary": plain, "cli_wall_s": wall, "checkpointed_equal": True,
                      "resumed_from": first.name}
    p, wall = cli("profile", "--trace-dir", str(base / "trace"))
    check(p.returncode == 0 and p.stdout.startswith("trace written to"),
          f"cli profile: exit {p.returncode}\n{p.stderr[-2000:]}")
    names = traced_scopes(base / "trace")
    check(set(SOLVE_SCOPES) <= set(names), f"cli profile: trace names {names}")
    out["profile"] = {"line_with_wall": p.stdout.strip(), "scopes": names,
                      "cli_wall_s": wall}
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    p, wall = cli("demo", "--plot", "--out-dir", str(base / "art"))
    p2, wall2 = cli("viz", "--artifacts", str(base / "art"), "--out", str(base / "v.png"))
    if have_mpl:
        check(p.returncode == 0 and (base / "art" / "tree.png").exists()
              and p2.returncode == 0 and (base / "v.png").exists(),
              f"cli plots: exits {p.returncode}, {p2.returncode}\n{p.stderr[-1000:]}")
    else:
        check(p.returncode == 2 == p2.returncode and "matplotlib" in p.stderr
              and "matplotlib" in p2.stderr and not (base / "art").exists(),
              f"cli plots without matplotlib: exits {p.returncode}, {p2.returncode}")
    out["plots"] = {"matplotlib": have_mpl, "demo_plot_exit": p.returncode,
                    "viz_exit": p2.returncode,
                    "message": (p.stderr.strip().splitlines() or [""])[-1],
                    "cli_wall_s": wall + wall2}
    shutil.rmtree(base)
    return out


SMQ_D = 4  # [32]: the CLI multi default's problems, four shards each
TWO_RANKS = 2  # [33]: ranks on the one card
TWO_RANKS_TIMEOUT_S = 420


def sharded_multi_query(dev) -> tuple[dict, dict]:
    """Phase 32: ShardedMultiQueryPlanner at full width: the CLI multi
    default's 64 jittered demo pairs x D = 4 shards each at KGMTConfig()
    (M = 30,000 slots a shard, R = 4,096, adaptive waves, the exchange pool),
    under 'auto' (every trip one launch of B6 over 64 x 4 x 4,096 lanes, a
    box set a tree) and 'cuda_rng' (B6's Philox form, a key a tree): solve
    rate, cost quantiles, iterations, trips, launches (equal to the trips),
    launches and host reads an iteration and a trip, wall, solves/s;
    problems 0-3 equal ShardedTreePlanner's solves under their keys
    fold_in(key(seed), b), bitwise; the first trips' rows equal the plain
    twin's driven on the card; every solved path replays. Returns the
    record and the launches by kernel."""
    from cudasbmp_torch import KGMTConfig, Scenario, rng
    from cudasbmp_torch.ops import rollout_cuda as rc
    from cudasbmp_torch.parallel import (
        ShardedMultiQueryPlanner,
        ShardedTreePlanner,
        make_planner_mesh,
    )
    from cudasbmp_torch.parallel import sharded_tree as st

    out, launches = {}, Counter()
    B, D = MULTI_B, SMQ_D
    for backend, kernel in (("auto", rc.rollout_batched_cuda),
                            ("cuda_rng", rc.sample_and_rollout_batched_cuda)):
        cfg = KGMTConfig(rollout_backend=backend)
        inits, goals, obstacles = jittered_demo(B, cfg.seed)
        mesh = make_planner_mesh(n_tree=D, device=str(dev))
        planner = ShardedMultiQueryPlanner(cfg, mesh=mesh)
        planner.plan_batch(inits[:2], goals[:2], obstacles, seed=7)  # warm-up
        rc.reset_launch_counts()
        res = planner.plan_batch(inits, goals, obstacles, seed=cfg.seed)
        trips = planner.last_state.trips
        counts = {w.__name__: w.launches for w in rc.WRAPPERS}
        main = counts.pop(kernel.__name__)
        G = rc.lanes_per_rollout(B * D * cfg.rollouts_per_iter, rc.sm_count(dev.index or 0))
        check(main == trips and set(counts.values()) == {0} and kernel.splits == {G: trips},
              f"sharded multi {backend}: launches {main} {counts} at G {dict(kernel.splits)} "
              f"for {trips} trips")
        launches[kernel.__name__] += main
        splits = dict(kernel.splits)
        one = ShardedTreePlanner(cfg, mesh=mesh)
        boxes = torch.tensor(obstacles, device=dev).expand(D, -1, -1).contiguous()
        for b in range(4):
            sc = Scenario(init=inits[b], goal=goals[b], obstacles=obstacles)
            s = one._init(sc, None, None, key=rng.fold_in(rng.key(cfg.seed, dev), b))
            st.sharded_run(cfg, one.system, one.grid, torch.tensor(goals[b], device=dev),
                           boxes, s)
            want = sharded_fields(one._build_result(s, time.perf_counter()))
            got = [bool(res.solved[b]), float(res.costs[b]), int(res.best_shards[b])
                   if res.solved[b] else want[2], int(res.iterations[b]),
                   int(res.total_tree_sizes[b]), want[5], digest(res.paths[b]),
                   res.path_shards[b].tolist()]
            check(got == want, f"sharded multi {backend}: problem {b} {got[:5]} != "
                  f"ShardedTreePlanner's {want[:5]}")
        lengths = np.array([len(p) for p in res.paths])
        padded = np.zeros((B, max(lengths.max(), 1), 7), np.float32)
        for b, p in enumerate(res.paths):
            padded[b, :len(p)] = p
        worst = check_paths(f"sharded multi {backend}", planner.system, cfg, padded,
                            lengths, res.costs, goals, obstacles)
        rate = float(res.solved.mean())
        check(rate >= 0.5, f"sharded multi {backend}: solve rate {rate}")
        twin = sharded_twin_check(planner, lambda: planner.plan_batch(
            inits, goals, obstacles, seed=cfg.seed), kernel, trips=3)

        def start():
            roots, goal_rows, tree_boxes = planner._inputs(inits, goals, obstacles)
            return planner._init(B, roots, cfg.seed), goal_rows, tree_boxes

        costs = iteration_costs(planner, dev, start=start)
        check(costs["host_reads_per_iteration"] == 1,
              f"sharded multi {backend}: host reads an iteration {costs}")
        out[backend] = {
            "batch": B, "n_tree": D, "lanes_per_trip": B * D * cfg.rollouts_per_iter,
            "solve_rate": rate, "cost_p10_p50_p90": quantiles(res.costs),
            "iterations_max": int(res.iterations.max()),
            "iterations_p50": float(np.median(res.iterations)), "trips": trips,
            "launches": main, "splits": splits, "checked_problems": [0, 1, 2, 3],
            "replay_max_err": worst, "twin_trips_bitwise": twin,
            "wall_time_s": res.wall_time_s, "solves_per_sec": res.solves_per_sec,
            **{k: v for k, v in costs.items() if k != "measured_trips"}}
    return out, dict(launches)


def two_ranks(out_dir: pathlib.Path, sharded_d4: dict, multi_batch: dict,
              stream_sweeps: dict, arena_rng: dict, ranks: int = TWO_RANKS) -> dict:
    """Phase 33: ``ranks`` processes, two on the one card by default, joined
    by the backend's rule (gloo when ranks share a card: NCCL refuses two
    ranks on one device; nccl with a card a rank): each rank runs this
    script's --two-ranks-child (the sharded tree at D = 4, 4 / ranks shards
    a rank, seeds 0-3 under 'auto' and 'cuda_rng'; plan_checkpointed every
    2 iterations; MultiQueryPlanner over the ranks at the CLI multi default;
    ArenaMultiQueryPlanner over the ranks at config 4 under 'cuda_rng', each
    rank's wave one B2 launch from its lane offset; run_sharded at 4,096
    scenarios, a pool of 1,024 a rank). Every rank must exit 0 within the
    timeout and report [30]'s D = 4 fields and path digests, [22]'s 'auto'
    batch, [14]'s 'cuda_rng' arena with its B2 launches (and no B1 launch)
    and [16]'s 'auto' sweep, bit for bit; the
    checkpoint rank 0 wrote resumes in a fresh one-process planner to
    plan()'s solve. Every child is killed on the way out."""
    import os
    import shutil
    import socket

    from cudasbmp_torch import KGMTConfig, Scenario
    from cudasbmp_torch.parallel import ShardedTreePlanner, make_planner_mesh
    from cudasbmp_torch.parallel.mesh import backend_for

    base = out_dir / "two_ranks"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    t0 = time.perf_counter()
    try:
        for r in range(ranks):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(ranks),
                       LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(ranks),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--two-ranks-child", str(base)],
                cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        outs = [p.communicate(timeout=TWO_RANKS_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    pg_backend = backend_for("cuda", ranks)
    reports = []
    for r, (p, (stdout, stderr)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"two ranks: rank {r} exit {p.returncode}\n{stderr[-3000:]}")
        reports.append(json.loads(stdout.strip().splitlines()[-1]))
    for r, got in enumerate(reports):
        check(got["backend"] == pg_backend and got["world"] == ranks and got["rank"] == r,
              f"two ranks: rank {r} joined {got['backend']} {got['world']} {got['rank']}")
        for backend in ("auto", "cuda_rng"):
            check(got["sharded"][backend]["fields"] == sharded_d4[backend]["fields"],
                  f"two ranks: rank {r} sharded {backend} {got['sharded'][backend]['fields']} "
                  f"!= [30]'s {sharded_d4[backend]['fields']}")
        check(got["checkpointed"] == sharded_d4["auto"]["fields"][0],
              f"two ranks: rank {r} plan_checkpointed {got['checkpointed']} != plan()'s")
        check(got["multi"]["digest"] == multi_batch["digest"],
              f"two ranks: rank {r} MultiQueryPlanner differs from [22]'s batch")
        check(got["arena"]["digest"] == arena_rng["digest"],
              f"two ranks: rank {r} ArenaMultiQueryPlanner differs from [14]'s cuda_rng")
        check(got["arena"]["launches"] == {"sample_and_rollout_cuda": arena_rng["launches"]},
              f"two ranks: rank {r} arena launches {got['arena']['launches']}, [14]'s "
              f"B2 {arena_rng['launches']}")
        check(got["stream"]["digest"] == stream_sweeps["auto"]["digest"],
              f"two ranks: rank {r} run_sharded differs from [16]'s sweep")
        # every rank's draws through the threefry kernel on its own card
        check(all(sum(v.values()) > 0 for v in got["threefry"].values())
              and len(got["threefry"]) == 5,
              f"two ranks: rank {r} threefry launches {got['threefry']}")
    files = sorted((base / "ck").glob("sharded_checkpoint_*.npz"),
                   key=lambda q: int(q.stem.split("_")[-1]))
    check(len(files) > 1, f"two ranks: checkpoints {files}")
    resumed = ShardedTreePlanner(KGMTConfig(), mesh=make_planner_mesh(n_tree=4, device="cuda"))
    r = resumed.plan_checkpointed(Scenario.demo(), base / "resumed", checkpoint_every=2,
                                  resume_from=files[0])
    check(sharded_fields(r) == sharded_d4["auto"]["fields"][0],
          f"two ranks: the one-process resume from {files[0].name} != plan()")
    shutil.rmtree(base)
    out = {"ranks": ranks, "backend": pg_backend, "wall_s": wall,
           "resumed_from": files[0].name, "checkpoints": [q.name for q in files],
           "equal_to_one_process": True}
    for r, got in enumerate(reports):
        out[f"rank{r}"] = {k: v for k, v in got.items() if k not in ("backend", "rank")}
    out["one_process_wall_s"] = {
        "sharded_auto_p50": float(np.median(sharded_d4["auto"]["walls"])),
        "sharded_cuda_rng_p50": float(np.median(sharded_d4["cuda_rng"]["walls"])),
        "multi": multi_batch["wall_time_s"], "arena": arena_rng["wall_time_s"],
        "stream": stream_sweeps["auto"]["wall_time_s"]}
    return out


def two_ranks_child(base: pathlib.Path) -> int:
    """One rank of phase 33 (torchrun's environment set by the parent): join
    the process group, solve, print one JSON line of the results."""
    import torch.distributed as dist

    from cudasbmp_torch import KGMTConfig, Scenario
    from cudasbmp_torch.ops import rollout_cuda as rc
    from cudasbmp_torch.ops import threefry_cuda as tfc
    from cudasbmp_torch.parallel import (
        ArenaMultiQueryPlanner,
        MultiQueryPlanner,
        ShardedTreePlanner,
        StreamingMonteCarloPlanner,
        make_planner_mesh,
        maybe_initialize_distributed,
    )

    check(maybe_initialize_distributed("cuda", timeout_s=300), "no process group")
    dev = torch.device(make_planner_mesh(device="cuda").device)
    demo = Scenario.demo()
    out = {"backend": dist.get_backend(), "world": dist.get_world_size(),
           "rank": dist.get_rank(), "device": str(dev), "sharded": {}, "threefry": {}}
    for backend, kernel in (("auto", rc.rollout_batched_cuda),
                            ("cuda_rng", rc.sample_and_rollout_batched_cuda)):
        mesh = make_planner_mesh(n_tree=4, device="cuda")
        planner = ShardedTreePlanner(KGMTConfig(rollout_backend=backend), mesh=mesh)
        planner.plan(demo, seed=100)  # warm-up
        rc.reset_launch_counts()
        tfc.reset_launch_counts()
        rows, walls, trips = [], [], 0
        for seed in SHARDED_SEEDS:
            r = planner.plan(demo, seed=seed)
            rows.append(sharded_fields(r))
            walls.append(r.wall_time_s)
            trips += planner.last_state.trips
        check(kernel.launches == trips, f"rank {out['rank']}: {kernel.launches} launches "
              f"for {trips} trips")
        out["threefry"][f"sharded_{backend}"] = threefry_launches(tfc)
        out["sharded"][backend] = {"fields": rows, "walls": walls,
                                   "wall_p50_s": float(np.median(walls)), "trips": trips,
                                   "launches": kernel.launches, "splits": dict(kernel.splits),
                                   **iteration_costs(planner, dev, mesh=mesh)}
    planner = ShardedTreePlanner(KGMTConfig(), mesh=make_planner_mesh(n_tree=4, device="cuda"))
    out["checkpointed"] = sharded_fields(planner.plan_checkpointed(
        demo, base / "ck", checkpoint_every=2, seed=0))
    cfg = KGMTConfig()
    inits, goals, obstacles = jittered_demo(MULTI_B, cfg.seed)
    planner = MultiQueryPlanner(cfg, mesh=make_planner_mesh(device="cuda"))
    planner.plan_batch(inits[:8], goals[:8], obstacles, seed=7)  # warm-up
    rc.reset_launch_counts()
    tfc.reset_launch_counts()
    res = planner.plan_batch(inits, goals, obstacles, seed=cfg.seed)
    out["threefry"]["multi"] = threefry_launches(tfc)
    out["multi"] = {"digest": multi_digest(res), "wall_time_s": res.wall_time_s,
                    "trips": planner.last_state.trips,
                    "launches": rc.rollout_batched_cuda.launches,
                    "problems": int(planner.last_state.tree_size.shape[0])}
    acfg = KGMTConfig(**SWEEP, rollout_backend="cuda_rng")
    inits, goals, obstacles = jittered_demo(ARENA_B, acfg.seed)
    arena = ArenaMultiQueryPlanner(acfg, mesh=make_planner_mesh(device="cuda"),
                                   auto_capacity=True)
    arena.plan_batch(inits, goals, obstacles, seed=7)  # warm-up
    rc.reset_launch_counts()
    tfc.reset_launch_counts()
    res = arena.plan_batch(inits, goals, obstacles, seed=8, max_extensions=1)
    out["threefry"]["arena"] = threefry_launches(tfc)
    out["arena"] = {"digest": arena_digest(res), "wall_time_s": res.wall_time_s,
                    "solves_per_sec": res.solves_per_sec,
                    "launches": {w.__name__: w.launches for w in rc.WRAPPERS if w.launches}}
    sweep = StreamingMonteCarloPlanner(KGMTConfig(**SWEEP), pool=STREAM_POOL, device="cuda")
    rc.reset_launch_counts()
    tfc.reset_launch_counts()
    s = sweep.run_sharded(STREAM_N, mesh=make_planner_mesh(device="cuda"), seed=1,
                          num_obstacles=8)
    out["threefry"]["stream"] = threefry_launches(tfc)
    out["stream"] = {"digest": digest(s.costs, s.iters), "wall_time_s": s.wall_time_s,
                     "solve_rate": s.solve_rate,
                     "launches": rc.rollout_batched_cuda.launches}
    dist.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


def ranks_only(n: int) -> int:
    """``chip_smoke.py --ranks N``: phase 33 alone over N processes (on N
    cards, nccl), after the one-process runs it is held to ([16]'s, [22]'s
    and [30]'s); no kernel line, not the one-card gate."""
    from cudasbmp_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    _build.build()
    _build.load()
    dev = torch.device("cuda", 0)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    _, sweeps = stream_sweep(dev)
    _, batch = multi_query_default(dev)
    arena_rec, arena_rng = arena_config4(dev, "cuda_rng")
    sh, _, d4 = sharded_tree(dev, out_dir)
    tr = two_ranks(out_dir, d4, batch, sweeps, {"digest": arena_rng, **arena_rec}, ranks=n)
    (out_dir / f"ranks_{n}.json").write_text(json.dumps(
        {"nvidia_smi": smi, "sharded_tree": sh, "ranks": tr}, indent=1))
    print(smi.replace("\n", " | "))
    print(json.dumps({k: v for k, v in tr.items() if not k.startswith("rank")}))
    for r in range(n):
        v = tr[f"rank{r}"]
        print(f"rank {r}: " + json.dumps({
            "sharded": {b: {k: v["sharded"][b][k] for k in (
                "wall_p50_s", "trips", "launches", "launches_per_iteration",
                "launches_per_trip", "host_reads_per_iteration")} for b in v["sharded"]},
            "multi": v["multi"], "arena": v["arena"], "stream": v["stream"],
            "device": v["device"], "threefry": v["threefry"]}))
    return 0


# phase 34's user systems: the built-in bicycle's device struct copied
# (csrc/rollout.cu's Bicycle with csrc/refine.cu's back()), and new
# dynamics, a damped double integrator (x, y, vx, vy; controls ax, ay):
# x += vx dt, y += vy dt, vx += (ax - c vx) dt, vy += (ay - c vy) dt
BICYCLE_COPY_STRUCT = """
struct UserSystem {  // (x, y, theta, v); controls (a, steering)
  static constexpr bool kHeading = true, kFast = true;
  float L;
  struct Aux { float a, tan_s; };
  struct Carry { float ct, st, dct, dst, dth; };
  struct FastAux { float a, cc2, sc2, c2; };
  __device__ Aux prepare(float a, float steering) const {
    return {a, tanf(steering)};
  }
  __device__ float4 step(float4 s, Aux q, float dt) const {
    const float2 cs = cos_sin(s.z);
    return make_float4(advance(s.x, s.w, cs.x, dt),
                       advance(s.y, s.w, cs.y, dt),
                       add(s.z, mul(mul(__fdiv_rn(s.w, L), q.tan_s), dt)),
                       add(s.w, mul(q.a, dt)));
  }
  __device__ void prepare_fast(float4 s, float a, float steering, float dt,
                               Carry& k, FastAux& q) const {
    const float tan_s = tanf(steering);
    const float d0 = mul(mul(__fdiv_rn(s.w, L), tan_s), dt);
    const float c2 = mul(mul(__fdiv_rn(mul(a, dt), L), tan_s), dt);
    k = {cosf(s.z), sinf(s.z), cosf(d0), sinf(d0), d0};
    q = {a, cosf(c2), sinf(c2), c2};
  }
  __device__ float4 step_fast(float4 s, Carry& k, FastAux q, float dt) const {
    const float4 n = make_float4(advance(s.x, s.w, k.ct, dt),
                                 advance(s.y, s.w, k.st, dt), add(s.z, k.dth),
                                 add(s.w, mul(q.a, dt)));
    rotate(k.ct, k.st, k.dct, k.dst);
    rotate(k.dct, k.dst, q.cc2, q.sc2);
    k.dth = add(k.dth, q.c2);
    return n;
  }
  __device__ float4 back(float4 s, Aux q, float dt, float4 lam, Grad& g) const {
    const float2 cs = cos_sin(s.z);
    const float vc = mul(s.w, cs.x), vs = mul(s.w, cs.y);
    const float vl = dvd(s.w, L), turn = mul(vl, q.tan_s);
    const float g_vc = mul(lam.x, dt), g_vs = mul(lam.y, dt);
    const float g_turn = mul(lam.z, dt);
    g.dt = add(g.dt, add(add(add(mul(lam.x, vc), mul(lam.y, vs)),
                             mul(lam.z, turn)), mul(lam.w, q.a)));
    g.c0 = add(g.c0, mul(lam.w, dt));
    g.c1 = add(g.c1, mul(mul(g_turn, vl), add(1.0f, mul(q.tan_s, q.tan_s))));
    const float g_th = sub(mul(mul(g_vs, s.w), cs.x), mul(mul(g_vc, s.w), cs.y));
    const float g_v = add(add(mul(g_vc, cs.x), mul(g_vs, cs.y)),
                          dvd(mul(g_turn, q.tan_s), L));
    return make_float4(lam.x, lam.y, add(lam.z, g_th), add(lam.w, g_v));
  }
};
"""
DRIFT_STRUCT = """
struct UserSystem {  // damped double integrator: (x, y, vx, vy); controls (ax, ay)
  static constexpr bool kHeading = false, kFast = false;
  float c;  // damping
  struct Aux { float ax, ay; };
  __device__ Aux prepare(float ax, float ay) const { return {ax, ay}; }
  __device__ float4 step(float4 s, Aux q, float dt) const {
    return make_float4(add(s.x, mul(s.z, dt)), add(s.y, mul(s.w, dt)),
                       add(s.z, mul(sub(q.ax, mul(c, s.z)), dt)),
                       add(s.w, mul(sub(q.ay, mul(c, s.w)), dt)));
  }
};
"""
USER_STRUCTS = {"bicycle_copy": BICYCLE_COPY_STRUCT, "drift": DRIFT_STRUCT}


def user_systems() -> dict:
    """Phase 34's systems by registered name: ``bicycle_copy`` (the
    built-in bicycle with the copied struct), ``drift`` (the damped double
    integrator with its struct and torch hooks) and ``drift_generic`` (the
    same dynamics with only ``step``, no struct)."""
    import dataclasses
    from typing import ClassVar

    from cudasbmp_torch.systems import ControlSpec, KinematicBicycle

    @dataclasses.dataclass(frozen=True)
    class BicycleCopy(KinematicBicycle):
        name: str = "bicycle_copy"
        cuda_struct: ClassVar[str] = BICYCLE_COPY_STRUCT

        @property
        def cuda_param(self) -> float:
            return self.agent_length

    @dataclasses.dataclass(frozen=True)
    class DriftGeneric:
        name: str = "drift_generic"
        state_dim: int = 4
        damping: float = 0.3
        control_spec: ControlSpec = dataclasses.field(default_factory=lambda: ControlSpec(
            lo=(-3.0, -3.0, 0.05), hi=(3.0, 3.0, 1.05)))

        def step(self, state, control, dt):
            x, y, vx, vy = state.unbind(-1)
            ax, ay = control[..., 0], control[..., 1]
            return torch.stack([x + vx * dt, y + vy * dt,
                                vx + (ax - self.damping * vx) * dt,
                                vy + (ay - self.damping * vy) * dt], dim=-1)

    @dataclasses.dataclass(frozen=True)
    class Drift(DriftGeneric):
        name: str = "drift"
        cuda_struct: ClassVar[str] = DRIFT_STRUCT

        @property
        def cuda_param(self) -> float:
            return self.damping

        def soa_prepare(self, ctrl):
            return tuple(ctrl)

        def soa_step(self, comps, aux, dt):
            x, y, vx, vy = comps
            ax, ay = aux
            return [x + vx * dt, y + vy * dt, vx + (ax - self.damping * vx) * dt,
                    vy + (ay - self.damping * vy) * dt]

    return {"bicycle_copy": BicycleCopy, "drift": Drift, "drift_generic": DriftGeneric}


def start_user_builds() -> dict:
    """Phase 34's two user libraries, each built in a thread of its own
    (two nvcc each) beside the package's build: name -> (thread, result
    list, filled with build()'s (path, seconds, log) or its exception)."""
    import threading

    from cudasbmp_torch.ops import _build

    def run(struct: str, out: list) -> None:
        try:
            out.append(_build.build(struct))
        except Exception as e:  # re-raised by phase 34
            out.append(e)

    builds = {}
    for name, struct in USER_STRUCTS.items():
        out: list = []
        t = threading.Thread(target=run, args=(struct, out), daemon=True)
        t.start()
        builds[name] = (t, out)
    return builds


def user_dynamics(dev, builds: dict, record: dict) -> dict:
    """Phase 34 (see the module's docstring). ``builds`` from
    ``start_user_builds``; ``record`` holds [5]'s and [6]'s seeds where
    the run has them, else the built-in's are solved here."""
    from cudasbmp_torch import KGMT, KGMTConfig, Scenario, rng
    from cudasbmp_torch.ops import _build
    from cudasbmp_torch.ops import refine_cuda as rf
    from cudasbmp_torch.ops import rollout_cuda as rc
    from cudasbmp_torch.ops.rollout import rollout_batch
    from cudasbmp_torch.parallel import MultiQueryPlanner
    from cudasbmp_torch.probes import throughput as tp
    from cudasbmp_torch.refine import RefineConfig, refine_path
    from cudasbmp_torch.systems import get_system, register_system
    from cudasbmp_torch.systems.bicycle import KinematicBicycle

    classes = user_systems()
    for name, cls in classes.items():
        register_system(name, cls)
    out: dict = {"build": {}}
    for name, (thread, res) in builds.items():
        thread.join()
        check(len(res) == 1, f"user library {name}: no build result")
        if isinstance(res[0], Exception):
            raise res[0]
        path, seconds, log = res[0]
        t0 = time.perf_counter()
        _build.load(USER_STRUCTS[name])
        load_s = time.perf_counter() - t0
        check(_build.build(USER_STRUCTS[name])[1] == 0.0, f"{name}: rebuilt when cached")
        ptxas = ptxas_table(log)
        out["build"][name] = {
            "library": path.name, "nvcc_s": seconds, "cached_load_s": load_s,
            "ptxas": ptxas, "summary": ptxas_summary(ptxas, lambda k: True),
            "kernels": len(ptxas)}
    builtin = record.get("build", {}).get("ptxas", {})
    copy_regs = {k.replace("UserSystem", "Bicycle"): v
                 for k, v in out["build"]["bicycle_copy"]["ptxas"].items()}
    out["build"]["bicycle_copy"]["registers_as_builtin"] = bool(builtin) and all(
        builtin.get(k) == v for k, v in copy_regs.items() if not k.startswith("refine"))

    cfg = KGMTConfig()
    kw = dict(num_disc=cfg.num_disc, width=cfg.width, height=cfg.height)
    R = cfg.rollouts_per_iter
    obstacles = torch.tensor(Scenario.demo().padded_obstacles(cfg.max_obstacles)[0],
                             device=dev)
    key = rng.key(34, dev)
    bike, copy = KinematicBicycle(agent_length=cfg.agent_length), classes["bicycle_copy"]()
    drift = classes["drift"]()
    checks = 0

    def same(a, b, tag: str) -> None:
        nonlocal checks
        check(all(bitwise(x, y) if x.dtype == torch.float32 else torch.equal(x, y)
                  for x, y in zip(a, b)), f"[34] {tag}: differs")
        checks += 1

    # (a) the copied struct against the built-in kernels; (b) drift's
    # kernels against its twin, at the same shapes
    x0, c = demo_batch(R, 34, dev)
    d0 = torch.cat([x0[:, :2], torch.tensor(np.random.default_rng(34).uniform(
        -3, 3, (R, 2)).astype(np.float32), device=dev)], 1)
    dc = c * torch.tensor([0.6, 3.0 / math.pi, 1.0], device=dev)  # drift's box
    for fp, fast, tag in ((None, False, "B1/B2"), (FOOTPRINT, False, "B3"),
                          (FOOTPRINT, True, "B4")):
        opts = dict(kw, footprint=fp, fast_math=fast)
        same(rc.rollout_cuda(bike, x0, c, obstacles, **opts),
             rc.rollout_cuda(copy, x0, c, obstacles, **opts), f"bicycle_copy {tag} B1")
        same(rc.sample_and_rollout_cuda(bike, key, x0, obstacles, **opts),
             rc.sample_and_rollout_cuda(copy, key, x0, obstacles, **opts),
             f"bicycle_copy {tag} B2")
        if not fast:
            same(rc.rollout_cuda(drift, d0, dc, obstacles, **opts),
                 rc.rollout_soa(drift, d0, dc, obstacles, **opts), f"drift {tag} B1")
            same(rc.sample_and_rollout_cuda(drift, key, d0, obstacles, **opts),
                 rc.sample_and_rollout_torch(drift, key, d0, obstacles, **opts),
                 f"drift {tag} B2")
    P = MULTI_B
    bx0, bc = demo_batch(P * R, 35, dev)
    bx0, bc = bx0.view(P, R, 4), bc.view(P, R, 3)
    bd0 = torch.cat([bx0[..., :2], torch.tensor(np.random.default_rng(35).uniform(
        -3, 3, (P, R, 2)).astype(np.float32), device=dev)], -1)
    bdc = bc * torch.tensor([0.6, 3.0 / math.pi, 1.0], device=dev)
    bobs = obstacles[None].expand(P, -1, -1).contiguous()
    keys = rng.split(key, P)
    same(rc.rollout_batched_cuda(bike, bx0, bc, bobs, **kw),
         rc.rollout_batched_cuda(copy, bx0, bc, bobs, **kw), "bicycle_copy B6")
    same(rc.sample_and_rollout_batched_cuda(bike, keys, bx0, bobs, **kw),
         rc.sample_and_rollout_batched_cuda(copy, keys, bx0, bobs, **kw),
         "bicycle_copy B6 Philox")
    same(rc.rollout_batched_cuda(drift, bd0, bdc, bobs, **kw),
         rc.rollout_soa(drift, bd0, bdc, bobs, **kw), "drift B6")
    same(rc.sample_and_rollout_batched_cuda(drift, keys, bd0, bobs, **kw),
         rc.sample_and_rollout_torch(drift, keys, bd0, bobs, **kw), "drift B6 Philox")
    starts = tp.start_states(B_CHECK, dev, grouped=True)
    dense = torch.tensor(Scenario.dense(24).obstacles, device=dev)  # the cull table's
    same(rc.sample_and_rollout_cuda(bike, key, starts, dense, **kw, cull=4),
         rc.sample_and_rollout_cuda(copy, key, starts, dense, **kw, cull=4),
         "bicycle_copy B5 W=4")
    # R1 on the CLI demo path
    rcfg = RefineConfig()
    rkw = refine_kw(cfg, rcfg)
    demo = Scenario.demo()
    path = KGMT(cfg, device=dev).plan(demo).path
    L = len(path) - 1
    one = [torch.tensor(np.ascontiguousarray(a), device=dev) for a in (
        path[None, 0, :4], path[None, 1:, 4:], np.ones((1, L), np.float32),
        demo.goal[None, :2], demo.obstacles)]
    same(rf._launch(bike, *one, **rkw), rf._launch(copy, *one, **rkw), "bicycle_copy R1")
    # the whole refinement: refine_path of the copy (its library's
    # refine_adam_kernel) is the built-in's, field for field; drift's struct
    # has no back(), so its refinement raises, naming the hook
    want = refine_path(bike, cfg, path, demo.goal, demo.obstacles, rcfg, device=dev)
    rf.refine_adam_cuda.user_systems.clear()
    got = refine_path(copy, cfg, path, demo.goal, demo.obstacles, rcfg, device=dev)
    user_launches = rf.refine_adam_cuda.user_systems["bicycle_copy"]
    check(rf.refine_adam_cuda.user_systems == {"bicycle_copy": 1},
          f"[34] bicycle_copy refine_path: {dict(rf.refine_adam_cuda.user_systems)}")
    check(all(np.array_equal(got[k], want[k]) for k in ("controls", "states", "losses"))
          and (got["valid"], got["cost_after"]) == (want["valid"], want["cost_after"]),
          "[34] bicycle_copy refine_path: differs from the built-in's")
    checks += 1
    try:
        refine_path(drift, cfg, path, demo.goal, demo.obstacles, RefineConfig(iterations=2),
                    device=dev)
        refused = None
    except NotImplementedError as e:
        refused = str(e)
    check(refused is not None and "back(" in refused,
          f"[34] drift refine_path: not refused by name ({refused!r})")
    out["refine"] = {"bicycle_copy": {"cost_before": got["cost_before"],
                                      "cost_after": got["cost_after"], "valid": got["valid"]},
                     "user_launches": user_launches, "drift_refused": refused}
    torch.cuda.synchronize()
    out["checks"] = checks

    # times: the user kernels beside their built-in twins at the same shapes
    t: dict = {}
    timed(t, "b1_builtin", lambda: rc.rollout_cuda(bike, x0, c, obstacles, **kw))
    timed(t, "b1_copy", lambda: rc.rollout_cuda(copy, x0, c, obstacles, **kw))
    timed(t, "b2_builtin", lambda: rc.sample_and_rollout_cuda(bike, key, x0, obstacles, **kw))
    timed(t, "b2_copy", lambda: rc.sample_and_rollout_cuda(copy, key, x0, obstacles, **kw))
    timed(t, "b6_builtin", lambda: rc.rollout_batched_cuda(bike, bx0, bc, bobs, **kw))
    timed(t, "b6_copy", lambda: rc.rollout_batched_cuda(copy, bx0, bc, bobs, **kw))
    di = get_system("double_integrator")
    timed(t, "b1_double_integrator", lambda: rc.rollout_cuda(di, d0, dc, obstacles, **kw))
    timed(t, "b1_drift", lambda: rc.rollout_cuda(drift, d0, dc, obstacles, **kw))
    timed(t, "b6_drift", lambda: rc.rollout_batched_cuda(drift, bd0, bdc, bobs, **kw))
    out["times"] = t

    # the solves: the copy's demo seeds against [5]'s and [6]'s; drift's
    main = Counter()  # the main path's launches: wrapper name -> user-struct launches
    insts = Counter()
    out["solves"] = {}
    for backend, phase in (("auto", "tree_auto"), ("cuda_rng", "tree_cuda_rng")):
        ucfg = cfg.replace(rollout_backend=backend, system="bicycle_copy")
        planner = KGMT(ucfg, device=dev)
        check(type(planner.system).__name__ == "BicycleCopy", "[34] registry")
        rows = record.get(phase, {}).get("seeds") or solve_seeds(
            cfg.replace(rollout_backend=backend), dev, replay=False)[1]
        rc.reset_launch_counts()
        got = [planner.plan(demo, seed=r["seed"]) for r in rows]
        for w in rc.WRAPPERS:
            main[w.__name__] += w.launches
            insts.update({(w.__name__, *k): n for k, n in w.user_systems.items()})
            check(not w.instantiations and w.launches == sum(w.user_systems.values()),
                  f"[34] bicycle_copy {backend}: {w.__name__} launched the built-in")
        for r, g in zip(rows, got):
            check([g.solved, g.cost, g.iterations, g.tree_size]
                  == [r["solved"], r["cost"], r["iterations"], r["tree_size"]],
                  f"[34] bicycle_copy {backend} seed {r['seed']}: {g.cost} != {r['cost']}")
        want = KGMT(cfg.replace(rollout_backend=backend), device=dev).plan(demo, seed=0)
        check(got[0].path.tobytes() == want.path.tobytes(),
              f"[34] bicycle_copy {backend}: seed 0's path differs from the built-in's")
        out["solves"][f"bicycle_copy_{backend}"] = {
            "seeds": len(rows), "equal_to_builtin": True,
            "cost_p10_p50_p90": quantiles(np.array([g.cost for g in got]))}
        dcfg = cfg.replace(rollout_backend=backend, system="drift")
        planner = KGMT(dcfg, device=dev)
        planner.plan(demo, seed=100)  # warm-up
        rc.reset_launch_counts()
        res = [planner.plan(demo, seed=s) for s in SEEDS]
        for w in rc.WRAPPERS:
            main[w.__name__] += w.launches
            insts.update({(w.__name__, *k): n for k, n in w.user_systems.items()})
        worst = 0.0
        obs_demo = torch.tensor(demo.obstacles, device=dev)
        for s, r in zip(SEEDS, res):
            check(r.metrics["rollout"] == "kernel", f"[34] drift {backend}: route")
            if r.solved:
                pth = torch.tensor(r.path, device=dev)
                x1, valid = rollout_batch(planner.system, pth[:-1, :4].contiguous(),
                                          pth[1:, 4:].contiguous(), cfg.num_disc,
                                          obs_demo, cfg.width, cfg.height)
                err = float((x1 - pth[1:, :4]).abs().max())
                worst = max(worst, err)
                check(bool(valid.all()) and err == 0.0,
                      f"[34] drift {backend} seed {s}: replay error {err}")
                check(math.hypot(r.path[-1, 0] - demo.goal[0], r.path[-1, 1] - demo.goal[1])
                      < cfg.goal_threshold, f"[34] drift {backend} seed {s}: off goal")
        costs = np.array([r.cost for r in res])
        rate = float(np.isfinite(costs).mean())
        check(rate >= 0.5, f"[34] drift {backend}: solve rate {rate}")
        out["solves"][f"drift_{backend}"] = {
            "solve_rate": rate, "cost_p10_p50_p90": quantiles(costs),
            "iterations": [r.iterations for r in res], "tree_sizes": [r.tree_size for r in res],
            "tts_p50_s": float(np.median([r.wall_time_s for r in res])),
            "replay_max_err": worst}
        if backend == "auto":
            drift_seed0 = res[0]

    # drift through MultiQueryPlanner at the CLI multi default's 64 pairs
    inits, goals, mobs = jittered_demo(MULTI_B, cfg.seed)
    mq = MultiQueryPlanner(cfg.replace(system="drift"), device=dev)
    mq.plan_batch(inits[:8], goals[:8], mobs, seed=7)  # warm-up
    rc.reset_launch_counts()
    m = mq.plan_batch(inits, goals, mobs, seed=cfg.seed)
    check(rc.rollout_batched_cuda.launches == mq.last_state.trips
          == sum(rc.rollout_batched_cuda.user_systems.values()),
          f"[34] drift multi: B6 launches {rc.rollout_batched_cuda.launches}")
    main["rollout_batched_cuda"] += rc.rollout_batched_cuda.launches
    insts.update({("rollout_batched_cuda", *k): n
                  for k, n in rc.rollout_batched_cuda.user_systems.items()})
    worst = check_paths("[34] drift multi", mq.system, cfg, m.paths, m.path_lengths,
                        m.costs, goals, mobs)
    out["solves"]["drift_multi"] = {
        "batch": MULTI_B, "solve_rate": float(m.solved.mean()),
        "cost_p10_p50_p90": quantiles(m.costs), "trips": mq.last_state.trips,
        "solves_per_sec": m.solves_per_sec, "wall_time_s": m.wall_time_s,
        "replay_max_err": worst}

    # (c) the same dynamics without a struct: the generic rollout under auto,
    # refused under cuda
    rc.reset_launch_counts()
    gen = KGMT(cfg.replace(system="drift_generic"), device=dev).plan(demo, seed=0)
    check(gen.metrics["rollout"] == "generic" and all(w.launches == 0 for w in rc.WRAPPERS),
          "[34] drift_generic: a kernel ran")
    check([gen.solved, gen.cost, gen.iterations, gen.tree_size] == [
        drift_seed0.solved, drift_seed0.cost, drift_seed0.iterations, drift_seed0.tree_size],
        f"[34] drift_generic: {gen.cost} != the struct's {drift_seed0.cost}")
    try:
        KGMT(cfg.replace(system="drift_generic", rollout_backend="cuda"),
             device=dev).plan(demo)
        refused = ""
    except NotImplementedError as e:
        refused = str(e)
    check("'auto'" in refused and "'torch'" in refused,
          f"[34] drift_generic under cuda: not refused ({refused!r})")
    out["generic"] = {"rollout": gen.metrics["rollout"], "solved": gen.solved,
                      "cost": gen.cost, "equal_to_struct": True,
                      "tts_s": gen.wall_time_s, "cuda_refusal": refused}
    out["main_launches"] = dict(main)
    out["user_systems"] = {"/".join(map(str, k)): n for k, n in insts.items()}
    return out


def print_user_dynamics(ud: dict, seconds: float) -> None:
    b, t, sv = ud["build"], ud["times"], ud["solves"]
    print("[34 user dynamics] " + " | ".join(
        f"{k}: nvcc {v['nvcc_s']:.1f} s beside the package's, cached load "
        f"{v['cached_load_s'] * 1e3:.1f} ms, {v['summary']}" for k, v in b.items())
        + f", bicycle_copy's registers as the built-in's: "
        f"{b['bicycle_copy']['registers_as_builtin']} | {ud['checks']} checks bitwise "
        f"(bicycle_copy = built-in B1, B2, B3, B4, B6, B6 Philox, B5 W=4, R1; drift = "
        f"its twin B1, B2, B3, B6, B6 Philox) | device ms, copy (built-in): B1 "
        f"{t['b1_copy_ms']:.5f} ({t['b1_builtin_ms']:.5f}), B2 {t['b2_copy_ms']:.5f} "
        f"({t['b2_builtin_ms']:.5f}), B6 64x4096 {t['b6_copy_ms']:.5f} "
        f"({t['b6_builtin_ms']:.5f}); drift B1 {t['b1_drift_ms']:.5f} (double_integrator "
        f"{t['b1_double_integrator_ms']:.5f}), B6 {t['b6_drift_ms']:.5f} | demo solves of "
        f"bicycle_copy == [5]/[6] field for field | drift " + " | ".join(
            f"{k[6:]}: rate {v['solve_rate']:.2f} cost p10/p50/p90 "
            + "/".join(f"{q:.3f}" for q in v["cost_p10_p50_p90"])
            + f" replay err {v['replay_max_err']}" for k, v in sv.items()
            if k.startswith("drift"))
        + f" | drift_generic under auto: {ud['generic']['rollout']}, == drift's seed 0, "
        f"no kernel launch; under cuda refused | user launches {ud['main_launches']} "
        f"({seconds:.1f} s)", flush=True)


def check_threefry(dev) -> dict:
    """Phase 35: the threefry kernel (csrc/threefry.cu) in every mode bit
    for bit its torch twin (rng.py's ``*_torch``) on the same CUDA tensors,
    one launch each, at TF_SHAPES: the wave's keys (``wave_keys``, the
    fleet's per problem, some waves 0), its controls (``scaled_uniform``
    between the bicycle's bounds, [..., 4,096, 3]) and acceptance uniforms;
    fold_in with int data past 2^32 and tensor data; split and random_bits
    from offsets past 2^32; uniform where max(lo, ...) binds. Then device
    ms a launch of the wave's three draws at both shapes beside the twin's
    (PLAIN_CALLS a window), and their bounds
    (probes/roofline.py::threefry_bound_ms at the card's SM count)."""
    from cudasbmp_torch import rng
    from cudasbmp_torch.ops import rollout_cuda as rc
    from cudasbmp_torch.ops import threefry_cuda as tfc
    from cudasbmp_torch.probes import roofline as rf
    from cudasbmp_torch.systems.bicycle import KinematicBicycle

    lo, hi = KinematicBicycle().control_spec.bounds(dev)
    pair_lo = torch.tensor([19.5, 14.5], device=dev)  # above hi: the max binds
    sms = rc.sm_count(dev.index or 0)
    out = {"checks": {}, "times": {}, "bounds": {}, "sm_count": sms}
    for tag, (B, R) in TF_SHAPES.items():
        base = rng.key(TF_SEED, dev)
        per = torch.arange(B, device=dev)
        k = base if B == 1 else rng.fold_in(base, per)
        itr, wave, data = (5, 2, 977) if B == 1 else (per % 9, per * 7 % 5, per * 977)
        draws = {  # name: (kernel route, twin, mode, outputs)
            "wave_keys": (lambda: rng.wave_keys(k, itr, wave),
                          lambda: rng.wave_keys_torch(k, itr, wave), "wave_keys", B),
            "controls": (lambda: rng.scaled_uniform(k, (R, 3), lo, hi),
                         lambda: rng.scaled_uniform_torch(k, (R, 3), lo, hi),
                         "scaled_uniform", B * R * 3),
            "acceptance": (lambda: rng.uniform(k, (R,)), lambda: rng.uniform_torch(k, (R,)),
                           "uniform", B * R),
            "fold_in_int": (lambda: rng.fold_in(k, 2**33 + 9),
                            lambda: rng.fold_in_torch(k, 2**33 + 9), "fold_in", B),
            "fold_in_tensor": (lambda: rng.fold_in(k, data),
                               lambda: rng.fold_in_torch(k, data), "fold_in", B),
            "split": (lambda: rng.split(k, 3, 2**32 - 1),
                      lambda: rng.split_torch(k, 3, 2**32 - 1), "split", B * 3),
            "random_bits": (lambda: rng.random_bits(k, (R, 3), 2**32 + 7),
                            lambda: rng.random_bits_torch(k, (R, 3), 2**32 + 7),
                            "random_bits", B * R * 3),
            "uniform_max_binds": (lambda: rng.uniform(k, (R, 2), pair_lo, -1.0, 3 * 2**32 + 1),
                                  lambda: rng.uniform_torch(k, (R, 2), pair_lo, -1.0,
                                                            3 * 2**32 + 1),
                                  "uniform", B * R * 2),
        }
        for name, (kernel, twin, mode, outputs) in draws.items():
            tfc.reset_launch_counts()
            got, want = kernel(), twin()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            launched = threefry_launches(tfc)
            same = all(g.shape == w.shape and g.dtype == w.dtype
                       and (bitwise(g, w) if g.dtype == torch.float32 else torch.equal(g, w))
                       for g, w in zip(got, want))
            check(same and len(got) == len(want), f"threefry {tag} {name}: differs from "
                  f"its twin")
            check(sum(launched.values()) == 1, f"threefry {tag} {name}: launches {launched}")
            out["checks"][f"{tag}/{name}"] = {"shape": list(got[0].shape),
                                              "launches": launched, "bitwise": True}
            if name == "uniform_max_binds":
                check(torch.equal(got[0], pair_lo.expand_as(got[0])),
                      f"threefry {tag}: max(lo, ...) does not bind")
            if name in ("wave_keys", "controls", "acceptance"):
                timed(out["times"], f"{tag}_{name}", kernel)
                timed(out["times"], f"{tag}_{name}_plain", twin, PLAIN_CALLS, plain=True)
                ms, by = rf.threefry_bound_ms(mode, outputs, B, sm_count=sms)
                out["bounds"][f"{tag}_{name}"] = {"mode": mode, "outputs": outputs,
                                                  "bound_ms": ms, "bound_by": by}
        t = out["times"]
        for side in ("", "_plain"):
            t[f"{tag}_wave{side}_ms"] = sum(t[f"{tag}_{n}{side}_ms"]
                                            for n in ("wave_keys", "controls", "acceptance"))
    return out


# the phases whose solves two runs of the same kernels' results must share
SOLVE_PHASES = ("tree_auto", "tree_cuda_rng", "pathless_auto", "forty_boxes",
                "all_options", "other_systems", "arena_config4", "arena_extension",
                "monte_carlo", "streaming", "multi_query", "multi_query_bench",
                "monte_carlo_vmap", "shortcut", "refine", "checkpoint", "sharded_tree",
                "sharded_cli", "sharded_multi_query", "two_ranks", "user_dynamics")


def compare_records(old: dict, new: dict) -> tuple[int, list[str]]:
    """The fields of SOLVE_PHASES (phases 5-16, 22-25 and 28-34: solve rates,
    costs, iterations, tree sizes, launches, path checks) in two records of
    this script, times left out (fields, and fields of dicts, whose names
    start with ``tts`` or end with ``_s`` or ``_ms`` or hold ``per_sec``,
    ``wall`` or ``regular``), and phases only one record has: how many were
    compared, and each that differs."""
    def leaves(o, path):
        if isinstance(o, dict):
            for k, v in o.items():
                yield from leaves(v, f"{path}/{k}")
        elif isinstance(o, list):
            for i, v in enumerate(o):
                yield from leaves(v, f"{path}[{i}]")
        else:
            yield path, o

    def timed_field(path: str) -> bool:  # a time, or a field of a dict of times
        return any(name.startswith("tts") or name.endswith(("_s", "_ms"))
                   or "per_sec" in name or "wall" in name or "regular" in name
                   for name in (seg.split("[")[0] for seg in path.split("/")[1:]))

    compared, differ = 0, []
    for phase in SOLVE_PHASES:
        if phase not in old or phase not in new:  # a phase one record lacks
            continue
        a, b = dict(leaves(old.get(phase), phase)), dict(leaves(new.get(phase), phase))
        for path in sorted(a.keys() | b.keys()):
            if not timed_field(path):
                compared += 1
                if a.get(path) != b.get(path):
                    differ.append(f"{path}: {a.get(path)!r} -> {b.get(path)!r}")
    return compared, differ


def main() -> int:
    if sys.argv[1:2] == ["--compare"]:
        old, new = (json.loads(pathlib.Path(f).read_text()) for f in sys.argv[2:4])
        compared, differ = compare_records(old, new)
        one_sided = [p for p in SOLVE_PHASES if (p in old) != (p in new)]
        print(f"{compared} solve fields of {len(SOLVE_PHASES) - len(one_sided)} phases "
              f"compared, {len(differ)} differ; in one record only: "
              f"{one_sided or 'none'}", *differ, sep="\n")
        return 1 if differ else 0
    if sys.argv[1:2] == ["--two-ranks-child"]:
        return two_ranks_child(pathlib.Path(sys.argv[2]))
    if sys.argv[1:2] == ["--ranks"]:
        return ranks_only(int(sys.argv[2]))
    out_dir = ROOT / "chiprun_out"
    record: dict = {}
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import cudasbmp_torch  # noqa: F401  (fails outside a checkout)
    from cudasbmp_torch import KGMTConfig, rng
    from cudasbmp_torch.config import Scenario
    from cudasbmp_torch.ops import _build
    from cudasbmp_torch.ops import rollout_cuda as rc
    from cudasbmp_torch.ops import threefry_cuda as tfc
    from cudasbmp_torch.ops.rollout import rollout_batch
    from cudasbmp_torch.probes import roofline as rf
    from cudasbmp_torch.probes import timing
    from cudasbmp_torch.systems.bicycle import KinematicBicycle

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    record["nvidia_smi"] = smi
    record["versions"] = {"python": sys.version.split()[0], "torch": torch.__version__,
                          "cuda": torch.version.cuda}
    print(f"[1 device] {smi.splitlines()[0]} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | count {torch.cuda.device_count()}", flush=True)

    # 2. build (phase 34's user libraries build beside it)
    user_builds = start_user_builds()
    path, seconds, log = _build.build()
    _build.load()
    ptxas = ptxas_table(log)
    record["build"] = {"library": path.name, "seconds": seconds, "ptxas": ptxas}
    regs = [v["registers"] for v in ptxas.values()]
    spills = sum(v["spill_stores"] + v["spill_loads"] for v in ptxas.values())
    print(f"[2 build] {f'{seconds:.1f} s nvcc' if seconds else 'cached'} -> "
          f"{path.name}; {len(ptxas)} "
          f"kernels, registers {min(regs, default=0)}-{max(regs, default=0)}, "
          f"spill bytes {spills}", flush=True)
    if "--user-dynamics" in sys.argv[1:]:
        ud = record["user_dynamics"] = user_dynamics(dev, user_builds, record)
        print_user_dynamics(ud, 0.0)
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_user.json").write_text(json.dumps(record, indent=1))
        return 0

    cfg = KGMTConfig()
    system = KinematicBicycle(agent_length=cfg.agent_length)
    obstacles = torch.tensor(Scenario.demo().padded_obstacles(cfg.max_obstacles)[0],
                             device=dev)
    kw = dict(num_disc=cfg.num_disc, width=cfg.width, height=cfg.height)

    # 3. B1 against the plain version; 4. B2 against its plain twin
    key = rng.key(12345, dev)
    forty = torch.tensor(Scenario.dense(40, seed=0).padded_obstacles(64)[0], device=dev)
    checks = {}
    for B, obs, tag in ((B_CHECK, obstacles, ""), (cfg.rollouts_per_iter, obstacles, ""),
                        *((r, obstacles, "") for r in RAGGED),
                        *((r, forty, "/K=40") for r in (cfg.rollouts_per_iter, *RAGGED))):
        x0, ctrl = demo_batch(B, 0, dev)
        x1, valid = rc.rollout_cuda(system, x0, ctrl, obs, **kw)
        px1, pvalid = rollout_batch(system, x0, ctrl, cfg.num_disc, obs,
                                    cfg.width, cfg.height)
        torch.cuda.synchronize()
        b1 = compare("rollout_kernel", system, x0, ctrl, obs, cfg, x1,
                     valid, px1, pvalid)
        x1, c, valid = rc.sample_and_rollout_cuda(system, key, x0, obs, **kw)
        tx1, tc, tvalid = rc.sample_and_rollout_torch(system, key, x0, obs, **kw)
        torch.cuda.synchronize()
        check(torch.equal(c.view(torch.int32), tc.view(torch.int32)),
              "sample_and_rollout_kernel: controls differ from the Philox twin")
        b2 = compare("sample_and_rollout_kernel", system, x0, c, obs, cfg,
                     x1, valid, tx1, tvalid)
        checks[f"{B}{tag}"] = (b1, b2)
    b1 = {k: max(checks[B][0][k] for B in checks) for k in ("mismatches", "max_abs_err")}
    b2 = {k: max(checks[B][1][k] for B in checks) for k in ("mismatches", "max_abs_err")}
    record["checks"] = {str(B): {"b1": v[0], "b2": v[1]} for B, v in checks.items()}
    print(f"[3 B1] B={list(checks)} mismatches={b1['mismatches']} "
          f"max|dx1|={b1['max_abs_err']:.3g} (atol {ATOL}, rtol {RTOL}) bitwise rows "
          f"{min(v[0]['bitwise_rows'] for v in checks.values()):.6f}", flush=True)
    print(f"[4 B2] controls bitwise equal; mismatches={b2['mismatches']} "
          f"max|dx1|={b2['max_abs_err']:.3g} bitwise rows "
          f"{min(v[1]['bitwise_rows'] for v in checks.values()):.6f}", flush=True)

    # 5. the demo solve through B1, at the rule's G for the wave's lanes
    G_demo = rc.lanes_per_rollout(cfg.rollouts_per_iter, rc.sm_count(dev.index or 0))
    check(G_demo > 1, f"the rule picks G={G_demo} for the demo's wave")
    rc.reset_launch_counts()
    tfc.reset_launch_counts()
    tree, rows = solve_seeds(cfg, dev, replay=True)
    b1_launches, b2_launches = rc.rollout_cuda.launches, rc.sample_and_rollout_cuda.launches
    tf_demo = threefry_launches(tfc)
    check(tf_demo == {"wave_keys_cuda": b1_launches, "scaled_uniform_cuda": b1_launches,
                      "uniform_cuda": b1_launches},
          f"tree/auto: threefry launches {tf_demo} for {b1_launches} waves")
    record["threefry_main"] = {"tree_auto": tf_demo}
    check(b1_launches == tree["waves"] and b2_launches == 0
          and rc.rollout_cuda.splits == {G_demo: b1_launches},
          f"tree/auto: B1 launches {b1_launches} for {tree['waves']} waves at G "
          f"{dict(rc.rollout_cuda.splits)}, B2 {b2_launches}")
    record["tree_auto"] = {**tree, "seeds": rows, "b1_launches": b1_launches,
                           "split": G_demo}
    print(f"[5 demo tree auto] solve rate {tree['solve_rate']:.2f} cost p50 "
          f"{tree['cost_p50']:.4f} p90 {tree['cost_p90']:.4f} TTS p50 "
          f"{tree['tts_p50_s'] * 1e3:.1f} ms p90 {tree['tts_p90_s'] * 1e3:.1f} ms | "
          f"waves {tree['waves']} B1 launches {b1_launches} at G={G_demo}, B2 0",
          flush=True)

    # 6. cuda_rng (B2) and pathless
    rc.reset_launch_counts()
    rngs, rows = solve_seeds(cfg.replace(rollout_backend="cuda_rng"), dev, replay=True)
    b2_main = rc.sample_and_rollout_cuda.launches
    check(rc.rollout_cuda.launches == 0 and b2_main == rngs["waves"]
          and rc.sample_and_rollout_cuda.splits == {G_demo: b2_main},
          f"tree/cuda_rng: B1 {rc.rollout_cuda.launches}, B2 {b2_main} for "
          f"{rngs['waves']} waves at G {dict(rc.sample_and_rollout_cuda.splits)}")
    rc.reset_launch_counts()
    pathless, prows = solve_seeds(cfg.replace(need_path=False), dev, replay=False)
    check(rc.rollout_cuda.launches == pathless["waves"]
          and rc.sample_and_rollout_cuda.launches == 0
          and rc.rollout_cuda.splits == {G_demo: pathless["waves"]},
          f"pathless/auto: B1 {rc.rollout_cuda.launches} for {pathless['waves']} waves")
    record["tree_cuda_rng"] = {**rngs, "seeds": rows, "b2_launches": b2_main,
                               "split": G_demo}
    record["pathless_auto"] = {**pathless, "seeds": prows,
                               "b1_launches": rc.rollout_cuda.launches, "split": G_demo}
    print(f"[6 demo cuda_rng] rate {rngs['solve_rate']:.2f} cost p50 "
          f"{rngs['cost_p50']:.4f} TTS p50 {rngs['tts_p50_s'] * 1e3:.1f} ms, B2 "
          f"launches {b2_main} B1 0 | [pathless auto] rate "
          f"{pathless['solve_rate']:.2f} cost p50 {pathless['cost_p50']:.4f} TTS p50 "
          f"{pathless['tts_p50_s'] * 1e3:.1f} ms", flush=True)

    # 7. kernel and plain times at the main path's shape, throughput at 2^17
    times = {}
    for B in (cfg.rollouts_per_iter, B_CHECK):
        x0, ctrl = demo_batch(B, 1, dev)
        _, valid = rc.rollout_cuda(system, x0, ctrl, obstacles, **kw)
        t = {"valid": int(valid.sum())}
        timed(t, "b1", lambda: rc.rollout_cuda(system, x0, ctrl, obstacles, **kw))
        timed(t, "plain", lambda: rollout_batch(system, x0, ctrl, cfg.num_disc,
                                                obstacles, cfg.width, cfg.height),
              PLAIN_CALLS, plain=True)
        timed(t, "b2", lambda: rc.sample_and_rollout_cuda(system, key, x0, obstacles,
                                                          **kw))
        timed(t, "twin", lambda: rc.sample_and_rollout_torch(system, key, x0,
                                                             obstacles, **kw),
              PLAIN_CALLS, plain=True)
        t["b1_valid_rollouts_per_s"] = t["valid"] / (t["b1_ms"] / 1e3)
        t["plain_valid_rollouts_per_s"] = t["valid"] / (t["plain_ms"] / 1e3)
        times[B] = t
    record["throughput"] = {str(B): t for B, t in times.items()}
    main, big = times[cfg.rollouts_per_iter], times[B_CHECK]
    print(f"[7 throughput] device ms (CUDA-event ms) | B={cfg.rollouts_per_iter}: B1 "
          f"{main['b1_ms']:.4f} ({main['b1_launch_ms']:.4f}) plain {main['plain_ms']:.4f} "
          f"({main['plain_launch_ms']:.4f}) B2 {main['b2_ms']:.4f} "
          f"({main['b2_launch_ms']:.4f}) twin {main['twin_ms']:.4f} "
          f"({main['twin_launch_ms']:.4f}) | B={B_CHECK}: B1 {big['b1_ms']:.4f} "
          f"({big['b1_launch_ms']:.4f}; {big['b1_valid_rollouts_per_s']:.4g} valid "
          f"rollouts/s) plain {big['plain_ms']:.4f} ({big['plain_launch_ms']:.4f}; "
          f"{big['plain_valid_rollouts_per_s']:.4g}/s) B2 {big['b2_ms']:.4f} "
          f"({big['b2_launch_ms']:.4f}) twin {big['twin_ms']:.4f} "
          f"({big['twin_launch_ms']:.4f})", flush=True)
    t0 = time.perf_counter()
    table = split_table(dev, obstacles, kw)
    floor = floors(dev, obstacles, kw, G_demo)
    record["split_table"], record["floors"] = table, floor
    print("[7 per-G] B1 device us at G=1/2/4/8 (the rule's G): " + " | ".join(
        f"{B} {tag} " + "/".join(f"{row[f'{tag}_g{G}_ms'] * 1e3:.2f}" for G in rc.SPLITS)
        + f" ({row['rule']})" for B, row in table.items()
        for tag in ("exact", "footprint"))
        + f" | one-warp floors (32 lanes; B1-B4 at G={G_demo}, B5/B6 at G=1) us: "
        + ", ".join(f"{k[:-3]} {v * 1e3:.2f}" for k, v in floor.items() if k.endswith("_ms"))
        + f" ({time.perf_counter() - t0:.1f} s)", flush=True)

    # 8. every instantiation of B1/B2 (B3, B4) against its twin; times
    t0 = time.perf_counter()
    inst = check_instantiations(dev, obstacles, kw)
    record["instantiations"] = inst
    it = inst["times"]
    fp_t, fast_t = it["b3_4096"], it["b4_4096"]
    print(f"[8 instantiations] {len(inst['checks'])} x (B1, B2) x G in "
          f"{['rule', *rc.SPLITS]} bitwise equal to their twins (R in "
          f"{[RAGGED[0], 4096, RAGGED[1], B_CHECK]}, K in {{8, 40}}) | device ms "
          f"(CUDA-event ms), kernel/plain: " + "; ".join(
              f"{k} {v['kernel_ms']:.4f} ({v['kernel_launch_ms']:.4f})/{v['plain_ms']:.4f} "
              f"({v['plain_launch_ms']:.4f})" for k, v in it.items())
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)

    # 9. 40 boxes
    t0 = time.perf_counter()
    boxes = check_many_boxes(dev, kw)
    record["forty_boxes"] = boxes
    print(f"[9 40 boxes] B1/B2 bitwise equal to their twins; solve rate "
          f"{boxes['solve_rate']:.2f} cost p50 {boxes['cost_p50']:.4f} B1 launches "
          f"{boxes['b1_launches']}; limit {boxes['limit']} boxes "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # 10. the bicycle with every option: the main path of B3 and B4
    t0 = time.perf_counter()
    opts = solve_all_options(dev)
    record["all_options"] = opts
    line = " | ".join(
        f"{m} rate {v['solve_rate']:.2f} cost p50 {v['cost_p50']:.4f} p90 "
        f"{v['cost_p90']:.4f} TTS p50 {v['tts_p50_s'] * 1e3:.1f} ms p90 "
        f"{v['tts_p90_s'] * 1e3:.1f} ms waves {v['waves']} launches {v['launches']}"
        for m, v in opts.items() if m != "identity_seed0")
    print(f"[10 all options] {line} | seed 0 kernel == twin, auto == torch (exact) "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    # every launch of that main path ran B1 with both B3 and B4
    option_launches = opts["tree_auto"]["launches"]

    # 11. the other systems
    t0 = time.perf_counter()
    others = solve_other_systems(dev)
    record["other_systems"] = others
    print("[11 systems] " + " | ".join(
        f"{k} rate {v['solve_rate']:.2f} cost p50 {v['cost_p50']:.4f} TTS p50 "
        f"{v['tts_p50_s'] * 1e3:.1f} ms launches {v['b1_launches']}"
        for k, v in others.items()) + f" ({time.perf_counter() - t0:.1f} s)", flush=True)

    # 12. the CLI
    t0 = time.perf_counter()
    clis = run_cli(out_dir)
    record["cli"] = clis
    print("[12 cli] " + " | ".join(
        f"{k}: {v['lines'][2]} solved cost {v['summary']['cost']:.4f} ({v['seconds']:.1f} s)"
        for k, v in clis.items()), flush=True)

    # 13. B6 against its twins; times at the sweeps' shape
    t0 = time.perf_counter()
    b6 = check_b6(dev, kw)
    record["b6"] = b6
    bt = b6["times"]
    print(f"[13 B6] {len(b6['checks'])} x (B6, B6 Philox) bitwise equal to their twins at "
          f"B=8 x R=512, B={' and '.join(map(str, EXTENSION_BUCKETS))} x R=128 and "
          f"B=1024 x R=128 (G: the rule's, 1, 2, 4, 8), B=8 x R in {list(PROBLEM_LANES)} x "
          f"K in {list(BOX_COUNTS)} (the rule's, 1) and B=70000 x R=2 (the "
          f"rule's, 8); wall in problem 1 changed {b6['isolation']['lanes_changed_in_problem_1']}"
          f" of its lanes and none elsewhere; keys slot- and B-independent | B=1024 x R=128 x "
          f"K=8, device ms (CUDA-event ms): B6 {bt['b6_ms']:.4f} ({bt['b6_launch_ms']:.4f}) "
          f"plain {bt['plain_ms']:.4f} ({bt['plain_launch_ms']:.4f}), Philox "
          f"{bt['b6_rng_ms']:.4f} ({bt['b6_rng_launch_ms']:.4f}) plain "
          f"{bt['rng_plain_ms']:.4f} ({bt['rng_plain_launch_ms']:.4f}), B1 on the same "
          f"lanes (shared boxes) {bt['b1_same_lanes_shared_boxes_ms']:.4f} "
          f"({bt['b1_same_lanes_shared_boxes_launch_ms']:.4f}) "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # 14. the batched arena at config 4's width, auto (B1) and cuda_rng (B2)
    t0 = time.perf_counter()
    arena = {b: arena_config4(dev, b) for b in ("auto", "cuda_rng")}
    arena_rng = {"digest": arena["cuda_rng"][1], **arena["cuda_rng"][0]}
    arena = record["arena_config4"] = {b: v[0] for b, v in arena.items()}
    extension = record["arena_extension"] = arena_extension(dev)
    print("[14 arena B=256] " + " | ".join(
        f"{b}: rate {v['solve_rate']:.4f} cost p10/p50/p90 "
        f"{'/'.join(f'{q:.3f}' for q in v['cost_p10_p50_p90'])} iterations p50 "
        f"{v['iterations_p50']:.0f} max {v['iterations_max']} solves/s "
        f"{v['solves_per_sec']:.1f} waves {sum(v['waves'])} launches {v['launches']}"
        for b, v in arena.items())
        + f" | extension round: problems {extension['exhausted_first_round']} exhausted, "
        f"waves {extension['waves']} at G {extension['splits']}, merged result checked "
        f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # 15. the Monte-Carlo sweep at config 5's per-chip width, through B6
    t0 = time.perf_counter()
    mc = mc_sweep(dev)
    record["monte_carlo"] = mc
    print(f"[15 Monte-Carlo 1024] rate {mc['solve_rate']:.4f} cost p10/p50/p90 "
          f"{'/'.join(f'{q:.3f}' for q in mc['cost_p10_p50_p90'])} solves/s "
          f"{mc['solves_per_sec']:.1f} exhausted {mc['budget_exhausted']} waves "
          f"{mc['waves']} B6 launches {mc['launches']} ({time.perf_counter() - t0:.1f} s)",
          flush=True)

    # 16. the streaming sweep, B6 and its Philox form; invariances
    t0 = time.perf_counter()
    stream, stream_sweeps = stream_sweep(dev)
    record["streaming"] = stream
    print("[16 streaming 4096/1024] " + " | ".join(
        f"{b}: rate {v['solve_rate']:.4f} cost p10/p50/p90 "
        f"{v['cost_quantiles']['p10']}/{v['cost_quantiles']['p50']}/"
        f"{v['cost_quantiles']['p90']} solves/s {v['solves_per_sec']:.1f} iterations "
        f"{sum(v['iterations'])} launches {v['launches']}; 256: partitions and pool 32 "
        f"bitwise equal" for b, v in stream.items())
        + f" ({time.perf_counter() - t0:.1f} s)", flush=True)

    # 17. the batch subcommands of the CLI
    t0 = time.perf_counter()
    bcli = run_batch_cli()
    record["batch_cli"] = bcli
    print("[17 cli] " + " | ".join(
        f"{k}: rate {v['summary']['solve_rate']:.4f} solves/s "
        f"{v['summary']['solves_per_sec']:.1f} ({v['seconds']:.1f} s)"
        for k, v in bcli.items()) + f" ({time.perf_counter() - t0:.1f} s)", flush=True)

    # 18. B5, the culled broad phase, against B1 and its twin
    t0 = time.perf_counter()
    b5 = check_b5(dev, kw)
    record["b5"] = b5
    b5t = b5["times"]
    print(f"[18 B5] {b5['checks']} culled launches (W in {list(WINDOWS)}, 20 instantiations x "
          f"2 kernels, dense-24 and 16 boxes, 2^17 random and grouped; R=33, 4097 and 2^17 at "
          f"24 and 100 boxes; {CUT_STEPS} steps, windows cut; the culled box caps "
          f"{b5['box_cap']}) bitwise equal to cull off; twin bitwise at W=4 | culled "
          f"instantiations: {ptxas_summary(ptxas, lambda k: k.endswith(', true>'))} | B2 at 2^17 on "
          f"dense-24, device ms random/grouped: " + ", ".join(
              f"W={W} {b5t[f'random_W{W}_ms']:.4f}/{b5t[f'grouped_W{W}_ms']:.4f}"
              for W in (0, *WINDOWS))
          + f"; floor (32 grouped lanes, W=4) {b5t['floor_W4_ms']:.4f}; plain culled twin "
          f"(grouped, W=4) {b5t['plain_grouped_W4_ms']:.2f} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # 19. the throughput probe and the cull table (B5's main path)
    t0 = time.perf_counter()
    probes = run_probes(dev)
    record["probes"] = probes
    pr = probes["probes"]
    print("[19 probe 2^17] valid rollouts/s by device time (by wall): " + ", ".join(
        f"{k} {v['valid_per_sec']:.4g} ({v['wall_valid_per_sec']:.4g})" for k, v in pr.items())
        + " | cull table, rollouts/s by device time (wall): " + ", ".join(
        f"{r['label']} {r['rollouts_per_sec']:.4g} ({r['wall_rollouts_per_sec']:.4g})"
        for r in probes["cull_table"]["rows"])
        + f" | B5 launches {probes['b5_launches']} ({time.perf_counter() - t0:.1f} s)",
        flush=True)

    # 20. the calibration chains (P1, P2) and B2's roofline shares
    t0 = time.perf_counter()
    cal = run_calibration(dev, pr)
    record["calibration"] = cal
    rates = cal["calibration"]
    print(f"[20 calibrate] FFMA/s {rates['alu_fma_issues_per_sec']:.4g}, cos/sin/tan "
          f"evals/s {rates['cos_evals_per_sec']:.4g}/{rates['sin_evals_per_sec']:.4g}/"
          f"{rates['tan_evals_per_sec']:.4g}, gathers/s at 8/128/1024 rows "
          f"{rates['gathers_per_sec_8']:.4g}/{rates['gathers_per_sec_128']:.4g}/"
          f"{rates['gathers_per_sec_1024']:.4g}; P1a device ms {rates['ms']['alu']:.4f} on "
          f"{cal['p1a_geometry']}; P1b device ms cos/sin/tan "
          f"{rates['ms']['cos']:.4f}/{rates['ms']['sin']:.4f}/{rates['ms']['tan']:.4f} on "
          f"{cal['p1b_geometry']['cos']} ({ptxas_summary(ptxas, lambda k: k.startswith('trans_chain'))}); "
          f"P2 device ms at 8/128/1024 rows {rates['ms']['gather8']:.4f}/"
          f"{rates['ms']['gather128']:.4f}/{rates['ms']['gather1024']:.4f} on "
          f"{cal['p2_geometry']} ({ptxas_summary(ptxas, lambda k: k.startswith(('alu_chain', 'gather_chain')))}); "
          f"chains agree with their twins (ragged sizes too), P1b and P2 bitwise; sincosf "
          f"differs from torch.sin/cos on {cal['sincos_differences']} of 2^32 floats | B2 share of "
          f"the peaks: " + ", ".join(f"{k} {v['peak_share']:.4f} ({v['kernel_ms']:.4f} ms)"
                                      for k, v in cal["shares"].items())
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)

    # 21. the probe subcommand
    t0 = time.perf_counter()
    pcli = run_probe_cli()
    record["probe_cli"] = pcli
    print("[21 cli probe] " + " | ".join(
        f"{k}: {v['kernel_ms']:.3f} ms, {v['rollouts_per_sec']:.4g} rollouts/s "
        f"({v['seconds']:.1f} s)" for k, v in pcli.items()), flush=True)

    # 22. the vmapped multi-query planner at the CLI's default: B6, B6 Philox
    t0 = time.perf_counter()
    shapes = check_new_shapes(dev, kw)
    orders = record["sum_orders"] = sum_orders(dev)
    multi, multi_batch = multi_query_default(dev)
    record["new_shapes"], record["multi_query"] = shapes, multi
    st = shapes["times"]
    print(f"[22 multi B={MULTI_B}] B6 and B6 Philox bitwise equal to their twins at "
          f"{', '.join(k for k in shapes['checks'] if 'x' in k)} (problems x lanes), B1 at "
          f"{SHORTCUT_CANDIDATES} lanes; at {MULTI_SHAPES[0][0]}x{MULTI_SHAPES[0][1]} device "
          f"ms B6 {st['b6_ms']:.4f} plain {st['plain_ms']:.4f} Philox {st['b6_rng_ms']:.4f} "
          f"plain {st['rng_plain_ms']:.4f} | sums of {orders['rows']} rows of 256: torch's "
          f"batched and one-row sums differ in {orders['library_rows_differing']}, "
          f"row_sum's in {orders['row_sum_rows_differing']} | " + " | ".join(
              f"{b}: rate {v['solve_rate']:.4f} cost p10/p50/p90 "
              f"{'/'.join(f'{q:.3f}' for q in v['cost_p10_p50_p90'])} solves/s "
              f"{v['solves_per_sec']:.2f} trips {v['trips']} launches {v['launches']} at "
              f"G={v['split']}; problems {v['checked_problems']} equal their single "
              f"solves; launches a trip at B=8/{MULTI_B} "
              f"{v['trip_costs']['8']['launches_per_trip']:.0f}/"
              f"{v['trip_costs'][str(MULTI_B)]['launches_per_trip']:.0f}, host reads a "
              f"trip {v['trip_costs'][str(MULTI_B)]['host_reads_per_trip']:.0f}"
              for b, v in multi.items()) + f" ({time.perf_counter() - t0:.1f} s)", flush=True)

    # 23. bench.py's vmap shape, B6 Philox
    t0 = time.perf_counter()
    bench = record["multi_query_bench"] = multi_query_bench(dev)
    print(f"[23 vmap B={BENCH_VMAP_B}] rate {bench['solve_rate']:.4f} cost p10/p50/p90 "
          f"{'/'.join(f'{q:.3f}' for q in bench['cost_p10_p50_p90'])} solves/s "
          f"{bench['solves_per_sec']:.2f} trips {bench['trips']} launches "
          f"{bench['launches']} at G={bench['split']} ({time.perf_counter() - t0:.1f} s)",
          flush=True)

    t0 = time.perf_counter()
    versus = record["vmap_vs_arena"] = vmap_vs_arena(dev)
    print(f"[23 vmap vs arena, config 4's {ARENA_B} pairs] " + " | ".join(
        f"{k}: rate {v['solve_rate']:.4f} cost p10/p50/p90 "
        f"{'/'.join(f'{q:.3f}' for q in v['cost_p10_p50_p90'])} solves/s "
        f"{v['solves_per_sec']:.2f} trips {v['trips']} at {v['ms_per_trip']:.2f} ms and "
        f"{v['launches_per_trip']:.0f} launches a trip" for k, v in versus.items())
        + f" ({time.perf_counter() - t0:.1f} s)", flush=True)

    # 24. the Monte-Carlo sweep through the vmapped planner, B6
    t0 = time.perf_counter()
    mcv = record["monte_carlo_vmap"] = mc_vmap(dev)
    print(f"[24 Monte-Carlo vmap {MC_VMAP_N}] rate {mcv['solve_rate']:.4f} cost "
          f"p10/p50/p90 {'/'.join(f'{q:.3f}' for q in mcv['cost_p10_p50_p90'])} solves/s "
          f"{mcv['solves_per_sec']:.2f} trips {mcv['trips']} B6 launches {mcv['launches']} "
          f"at G={mcv['split']}; scenario {mcv['checked_scenario']} equals its single "
          f"solve ({time.perf_counter() - t0:.1f} s)", flush=True)

    # 25. shortcutting: B1 on one path, B6 on batches
    t0 = time.perf_counter()
    short, quality = shortcutting(dev, multi_batch)
    record["shortcut"] = short
    sp = short["path"]
    print(f"[25 shortcut] path: cost {sp['cost_before']:.3f} -> {sp['cost_after']:.3f} "
          f"({sp['edges_before']} -> {sp['edges_after']} edges) in {sp['wall_time_s']:.2f} s, "
          f"B1 {sp['b1_launches']} at G={sp['split']}, equal to the twin on the card | "
          + " | ".join(
              f"{k} ({v['paths']} paths): cost p10/p50/p90 "
              f"{'/'.join(f'{q:.3f}' for q in v['cost_before_p10_p50_p90'])} -> "
              f"{'/'.join(f'{q:.3f}' for q in v['cost_after_p10_p50_p90'])}, edges "
              f"{v['edges_before_mean']:.1f} -> {v['edges_after_mean']:.1f} in "
              f"{v['wall_time_s']:.2f} s, B6 {v['b6_launches']} at G={v['split']}"
              for k, v in short.items() if k != "path")
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)

    # 26. the CLI's defaults: multi, sweep, demo --shortcut
    t0 = time.perf_counter()
    vcli = record["vmap_cli"] = run_vmap_cli()
    print("[26 cli] " + " | ".join(
        f"{k}: " + (v["line"] if "line" in v else
                    f"rate {v['summary']['solve_rate']:.4f} solves/s "
                    f"{v['summary']['solves_per_sec']:.2f}") + f" ({v['seconds']:.1f} s)"
        for k, v in vcli.items()) + f" ({time.perf_counter() - t0:.1f} s)", flush=True)

    # 27. R1 against its twin; its times; the whole refinement against R1's
    # step path and its twin; its times
    t0 = time.perf_counter()
    r1 = record["r1"] = check_r1(dev, quality)
    print(f"[27 R1] {r1['cases']} cases (5 systems, (edges, steps) in {r1['shapes']}, "
          f"masked or not, shared or per-problem boxes) and the demo's and pipeline's "
          f"inputs: states bitwise, loss max abs err {r1['max_abs_err']:.3g} (rtol "
          f"{R1_RTOL}), gradient err {r1['grad_rel_err']:.3g} of its norm (tol "
          f"{R1_GRAD_RTOL}) | device ms (CUDA-event ms): demo path B=1 x {r1['demo_edges']} "
          f"edges R1 {r1['demo_ms']:.4f} ({r1['demo_launch_ms']:.4f}) twin "
          f"{r1['demo_plain_ms']:.3f} ({r1['demo_plain_launch_ms']:.3f}) bound "
          f"{r1['demo_bound_ms']:.3g}; pipeline B={r1['pipeline_problems']} x "
          f"{r1['pipeline_edges']} edges R1 {r1['pipeline_ms']:.4f} "
          f"({r1['pipeline_launch_ms']:.4f}) bound {r1['pipeline_bound_ms']:.3g}; "
          f"one path of {r1['chain_edges']} edges (the serial chain) {r1['chain_ms']:.4f} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    wr = record["refine_adam"] = whole_refinement(dev, quality)
    sw = wr["switch"]
    print(f"[27 whole refinement] refine_adam_kernel bitwise the step path (R1 "
          f"{wr['step_path_r1_launches']} launches) at RefineConfig() on the demo path "
          f"(1 x {wr['demo_edges']} edges) and the pipeline ({wr['pipeline_problems']} x "
          f"{wr['pipeline_edges']} edges, and padded to {wr['pipeline_padded_edges']}); "
          f"twin at {ADAM_TWIN_STEPS} steps: controls max abs err {wr['twin_max_abs_err']:.3g} "
          f"| device ms a refinement (an Adam step): demo {wr['demo_ms']:.3f} "
          f"({wr['demo_step_ms']:.5f}), pipeline {wr['pipeline_ms']:.3f} "
          f"({wr['pipeline_step_ms']:.5f}), padded {wr['pipeline_padded_ms']:.3f} "
          f"({wr['pipeline_padded_step_ms']:.5f}), one path of {wr['pipeline_edges']} edges "
          f"{wr['chain_ms']:.3f} ({wr['chain_step_ms']:.5f}); step path wall s "
          f"{wr['step_path_wall_s']} | {ADAM_ROW_STEPS} steps on the demo path "
          f"{wr['demo_row_ms']:.4f}, twin {wr['demo_row_plain_ms']:.1f} | global scratch "
          f"from {sw['edges']} edges ({sw['points']} points, {sw['bytes_at_switch']} B > "
          f"{sw['shared_limit_bytes']} B): {sw['edges'] - 1} edges shared "
          f"{wr['switch_below_ms']:.2f}, {sw['edges']} global {wr['switch_past_ms']:.2f} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # 28. refinement: demo --refine, refine_path and refine_batch, a launch each
    t0 = time.perf_counter()
    refine, refine_counts = refinement(dev, quality)
    record["refine"] = refine
    rb, steps = refine["batch"], refine["adam_steps"]
    print(f"[28 refine] cli: {refine['cli']['line']} ({refine['cli']['wall_s']:.1f} s) | "
          f"refine_path: {refine['path']['edges']} edges, cost "
          f"{refine['path']['cost_before']:.3f} -> {refine['path']['cost_after']:.3f} valid "
          f"{refine['path']['valid']} in {refine['path']['wall_time_s']:.3f} s, whole "
          f"refinement {refine['path']['adam_launches']} R1 {refine['path']['r1_launches']} "
          f"B1 {refine['path']['b1_launches']} | "
          f"refine_batch on [25]'s {rb['paths']} paths: improved {rb['improved']} valid "
          f"{rb['valid']}, cost p10/p50/p90 "
          f"{'/'.join(f'{q:.3f}' for q in rb['cost_before_p10_p50_p90'])} -> "
          f"{'/'.join(f'{q:.3f}' for q in rb['cost_after_p10_p50_p90'])} in "
          f"{rb['wall_time_s']:.3f} s, whole refinement {rb['adam_launches']} R1 "
          f"{rb['r1_launches']} B6 {rb['b6_launches']} ({rb['edges_longest']} edges of "
          f"{rb['edges_max']}) | the step path's Adam step, wall ms (device ms, "
          f"launches): " + "; ".join(
              f"{tag} R1 {v['r1']['step_wall_ms']:.3f} "
              f"({v['r1']['step_device_ms']}, {v['r1']['step_launches']}) twin "
              f"{v['twin']['step_wall_ms']:.1f} ({v['twin']['step_device_ms']}, "
              f"{v['twin'].get('step_launches', 'not counted')})"
              for tag, v in steps.items())
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)

    # 29. checkpoint, resume and the recorded solve
    t0 = time.perf_counter()
    ck = record["checkpoint"] = checkpoint_record(dev, out_dir)
    print(f"[29 checkpoint] plan_recorded of the demo ({ck['record_wall_time_s']:.2f} s), "
          f"checkpoint_5 round trip bitwise, resumed to iterations {ck['iterations']} tree "
          f"size {ck['tree_size']} cost {ck['cost']:.4f}: plan()'s to the bit; cli record "
          f"wrote {len(ck['cli_files'])} entries ({ck['cli_wall_s']:.1f} s) "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # 30. the sharded tree, B6 and B6 Philox; 31. its CLI, profile and plots
    t0 = time.perf_counter()
    sh, sharded_launches, sharded_d4 = sharded_tree(dev, out_dir)
    record["sharded_tree"] = sh
    print("[30 sharded tree] " + " | ".join(
        f"{k}: rate {v['solve_rate']:.2f} cost p50 {v['cost_p50']:.4f} iterations "
        f"{v['iterations']} trips {v['trips']} launches {v['launches']} at G "
        f"{v['splits']}, {v['launches_per_iteration']:.1f} launches and "
        f"{v['host_reads_per_iteration']:.0f} host read an iteration, paths crossing "
        f"shards {sum(x['path_crosses_shards'] for x in v['seeds'])}/4, wall p50 "
        f"{v['wall_p50_s'] * 1e3:.1f} ms, {v['twin_trips_bitwise']} trips bitwise the "
        f"twin's" for k, v in sh.items() if k.startswith(("auto", "cuda_rng")))
        + f" | plan_checkpointed and resume == plan() ({len(sh['checkpointed']['checkpoints'])}"
        f" checkpoints) | trace scopes {[n for n in sh['trace_scopes'] if n in SHARDED_SCOPES]}"
        f" | validate_state {sh['validate_state']} ({time.perf_counter() - t0:.1f} s)",
        flush=True)
    t0 = time.perf_counter()
    scli = record["sharded_cli"] = sharded_cli(out_dir)
    print(f"[31 cli] sharded: {json.dumps(scli['sharded']['summary'])} "
          f"({scli['sharded']['cli_wall_s']:.1f} s), checkpointed and resumed equal | profile: "
          f"{scli['profile']['line_with_wall']}, scopes {scli['profile']['scopes']} | plots: "
          f"matplotlib {scli['plots']['matplotlib']}, demo --plot exit "
          f"{scli['plots']['demo_plot_exit']}, viz exit {scli['plots']['viz_exit']} "
          f"({scli['plots']['message']}) ({time.perf_counter() - t0:.1f} s)", flush=True)

    # 32. the sharded multi-query planner at full width; 33. two processes
    t0 = time.perf_counter()
    smq, smq_launches = sharded_multi_query(dev)
    record["sharded_multi_query"] = smq
    print("[32 sharded multi B=64 x D=4] " + " | ".join(
        f"{k}: rate {v['solve_rate']:.4f} cost p10/p50/p90 "
        f"{'/'.join(f'{q:.3f}' for q in v['cost_p10_p50_p90'])} iterations p50 "
        f"{v['iterations_p50']:.0f} max {v['iterations_max']} trips {v['trips']} launches "
        f"{v['launches']} at G {v['splits']} over {v['lanes_per_trip']} lanes, "
        f"{v['launches_per_iteration']:.1f} launches and {v['host_reads_per_iteration']:.0f} "
        f"host read an iteration ({v['launches_per_trip']:.1f} a trip), wall "
        f"{v['wall_time_s']:.2f} s, solves/s {v['solves_per_sec']:.1f}, problems 0-3 == "
        f"ShardedTreePlanner, {v['twin_trips_bitwise']} trips bitwise the twin's, replay "
        f"err {v['replay_max_err']:.2g}" for k, v in smq.items())
        + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    tr = record["two_ranks"] = two_ranks(out_dir, sharded_d4, multi_batch, stream_sweeps,
                                         arena_rng)
    one = tr["one_process_wall_s"]
    print(f"[33 two ranks, {tr['backend']}] both ranks == one process: sharded D=4 (2 shards "
          f"a rank) seeds 0-3 auto/cuda_rng, plan_checkpointed (resumed in one process from "
          f"{tr['resumed_from']}), MultiQueryPlanner B=64, arena B=256 cuda_rng (B2 "
          f"launches {tr['rank1']['arena']['launches']} on rank 1), run_sharded 4096/1024 "
          f"a rank | "
          + " | ".join(
              f"rank {r}: sharded wall p50 auto {v['sharded']['auto']['wall_p50_s'] * 1e3:.0f} "
              f"ms cuda_rng {v['sharded']['cuda_rng']['wall_p50_s'] * 1e3:.0f} ms, "
              f"{v['sharded']['auto']['launches_per_trip']:.1f} launches a trip and "
              f"{v['sharded']['auto']['host_reads_per_iteration']:.0f} host reads an iteration;"
              f" multi {v['multi']['wall_time_s']:.2f} s; arena {v['arena']['wall_time_s']:.2f}"
              f" s; stream {v['stream']['wall_time_s']:.2f} s"
              for r, v in ((r, tr[f"rank{r}"]) for r in range(TWO_RANKS)))
          + f" | one process: sharded p50 auto {one['sharded_auto_p50'] * 1e3:.0f} ms cuda_rng "
          f"{one['sharded_cuda_rng_p50'] * 1e3:.0f} ms, multi {one['multi']:.2f} s, arena "
          f"{one['arena']:.2f} s, stream "
          f"{one['stream']:.2f} s ({time.perf_counter() - t0:.1f} s)", flush=True)

    # 34. user dynamics
    t0 = time.perf_counter()
    ud = record["user_dynamics"] = user_dynamics(dev, user_builds, record)
    print_user_dynamics(ud, time.perf_counter() - t0)

    # 35. the threefry kernel against its twin; its main-path launches
    t0 = time.perf_counter()
    tf = record["threefry"] = check_threefry(dev)
    tf_main = record["threefry_main"]
    for b, v in multi.items():
        tf_main[f"multi_{b}"] = v["threefry_launches"]
    tf_ranks = {f"rank{r}": tr[f"rank{r}"]["threefry"] for r in range(TWO_RANKS)}
    tft, tfb = tf["times"], tf["bounds"]
    print(f"[35 threefry] {len(tf['checks'])} draws bitwise their twins, one launch each "
          f"({', '.join(tf['checks'])}) | device ms a launch (twin's), bound ms: " + " | ".join(
              f"{tag} " + ", ".join(
                  f"{n} {tft[f'{tag}_{n}_ms']:.5f} ({tft[f'{tag}_{n}_plain_ms']:.4f}), "
                  f"{tfb[f'{tag}_{n}']['bound_ms']:.3g} ({tfb[f'{tag}_{n}']['bound_by']})"
                  for n in ("wave_keys", "controls", "acceptance"))
              for tag in TF_SHAPES)
          + f" | main-path launches {tf_main} | two ranks {tf_ranks} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    if "--profile" in sys.argv[1:]:
        out_dir.mkdir(exist_ok=True)
        record["profile_tree_auto"] = profile_solve(cfg, dev, out_dir)
        print(f"[profile] {record['profile_tree_auto']}", flush=True)
        record["profile_batched"] = profile_batched(dev, out_dir)
        print(f"[profile batched] {record['profile_batched']}", flush=True)

    inst_err = max(v["max_abs_err"] for v in inst["checks"].values())
    K = obstacles.shape[0]
    R = cfg.rollouts_per_iter
    nd = cfg.num_disc
    nb, nr, nk = SWEEP_SHAPE

    def bounds(lanes, ops, boxes, keys=0):
        ms, by = rf.bound_ms(lanes, ops, boxes, keys)
        return {"bound_ms": ms, "bound_by": by, "library_ms": None}

    def chain_row(ms_by):
        ms, by = ms_by
        return {"bound_ms": ms, "bound_by": by, "library_ms": None}

    ops_per_lane = rf.ops_per_lane
    G_options = opts["tree_auto"]["split"]
    # B6's user paths: the arena sweep's, the streaming sweep's, the vmapped
    # planner's ([22] auto, [24]) and the shortcut batches' ([25]); its G
    # the one of most launches
    b6_splits = Counter(mc["splits"]) + Counter({1: stream["auto"]["launches"]}) \
        + sum((Counter(v["splits"]) for k, v in sh.items() if k.startswith("auto_")),
              Counter()) + Counter(smq["auto"]["splits"]) \
        + Counter({multi["auto"]["split"]: multi["auto"]["launches"]}) \
        + Counter({mcv["split"]: mcv["launches"]}) \
        + sum((Counter({v["split"]: v["b6_launches"]}) for k, v in short.items()
               if k != "path"), Counter())
    G_b6 = max(b6_splits, key=b6_splits.get)
    rng_splits = Counter({1: stream["cuda_rng"]["launches"]}) \
        + sum((Counter(v["splits"]) for k, v in sh.items() if k.startswith("cuda_rng_")),
              Counter()) + Counter(smq["cuda_rng"]["splits"]) \
        + Counter({multi["cuda_rng"]["split"]: multi["cuda_rng"]["launches"]}) \
        + Counter({bench["split"]: bench["launches"]})
    cms, creg = cal["calibration"]["ms"], cal["calibration"]["regular"]
    pm = cal["plain_ms"]
    # B1's and B2's user paths: the demo's waves (G_demo), the arena's
    # (G = 1 at 32,768 lanes) and, for B1, the forced extension round's
    b1_splits = Counter({G_demo: b1_launches}) + Counter(arena["auto"]["splits"]) \
        + Counter(extension["splits"]) + Counter({sp["split"]: sp["b1_launches"]})
    b2_splits = Counter({G_demo: b2_main}) + Counter(arena["cuda_rng"]["splits"])

    def regular(kernel: int, plain: int, floor_of: str | None = None) -> dict:
        out = {"regular_windows": kernel, "plain_regular_windows": plain,
               "plain_ms_by": "device" if plain else "events"}
        if floor_of:
            out["floor_regular_windows"] = floor[f"{floor_of}_regular"]
        return out

    cb = rf.chain_bounds(rf.CAL_SHAPE[0] * rf.CAL_SHAPE[1], 1024)
    def chain_err(prefixes):
        return max(v["max_abs_err"] for k, v in cal["checks"].items()
                   if k.startswith(prefixes) and "max_abs_err" in v)

    def user(wrapper: str) -> dict:
        """[34]'s main-path launches of ``wrapper`` on user structs, and the
        instantiations that ran (name/footprint/fast: launches)."""
        return {"user_launches": ud["main_launches"].get(wrapper, 0),
                "user_systems": {k.split("/", 1)[1]: v for k, v in ud["user_systems"].items()
                                 if k.split("/", 1)[0] == wrapper}}

    kernels = [
        {"name": "rollout_kernel", "route": "cuda",
         "source": "cudasbmp_torch/csrc/rollout.cu",
         "replaces": "cudasbmp_tpu/ops/rollout_pallas.py:432",
         "systems": list(SYSTEMS),
         "launches": sum(b1_splits.values()) + user("rollout_cuda")["user_launches"],
         "splits": dict(b1_splits), **user("rollout_cuda"),
         "max_abs_err": max(b1["max_abs_err"], inst_err),
         "ms": main["b1_ms"], "plain_ms": main["plain_ms"],
         "launch_ms": main["b1_launch_ms"], "plain_launch_ms": main["plain_launch_ms"],
         **regular(main["b1_regular"], main["plain_regular"], "b1"),
         "split": G_demo, "floor_ms": floor["b1_ms"],
         **bounds(R, ops_per_lane("bicycle", False, False, K, nd, False), K)},
        {"name": "sample_and_rollout_kernel", "route": "cuda",
         "source": "cudasbmp_torch/csrc/rollout.cu",
         "replaces": "cudasbmp_tpu/ops/rollout_pallas.py:593",
         "systems": list(SYSTEMS),
         "launches": sum(b2_splits.values())
         + user("sample_and_rollout_cuda")["user_launches"],
         "splits": dict(b2_splits), **user("sample_and_rollout_cuda"),
         "launches_two_ranks": sum(tr[f"rank{r}"]["arena"]["launches"][
             "sample_and_rollout_cuda"] for r in range(TWO_RANKS)),
         "max_abs_err": max(b2["max_abs_err"], inst_err),
         "ms": main["b2_ms"], "plain_ms": main["twin_ms"],
         "launch_ms": main["b2_launch_ms"], "plain_launch_ms": main["twin_launch_ms"],
         **regular(main["b2_regular"], main["twin_regular"], "b2"),
         "split": G_demo, "floor_ms": floor["b2_ms"],
         **bounds(R, ops_per_lane("bicycle", False, False, K, nd, True), K, 1)},
        {"name": "rollout_kernel<footprint> (B3)", "route": "cuda",
         "source": "cudasbmp_torch/csrc/rollout.cu",
         "replaces": "cudasbmp_tpu/ops/rollout_pallas.py:104",
         "systems": list(SYSTEMS),
         "launches": option_launches, "max_abs_err": inst_err,
         "ms": fp_t["kernel_ms"], "plain_ms": fp_t["plain_ms"],
         "launch_ms": fp_t["kernel_launch_ms"], "plain_launch_ms": fp_t["plain_launch_ms"],
         "timed": "bicycle + footprint, 4096 lanes",
         **regular(fp_t["kernel_regular"], fp_t["plain_regular"], "b3"),
         "split": G_options, "floor_ms": floor["b3_ms"],
         **bounds(R, ops_per_lane("bicycle", True, False, K, nd, False), K)},
        {"name": "rollout_kernel<fast_math> (B4)", "route": "cuda",
         "source": "cudasbmp_torch/csrc/rollout.cu",
         "replaces": "cudasbmp_tpu/ops/rollout_pallas.py:81",
         "systems": ["bicycle", "unicycle", "dubins"],
         "launches": option_launches, "max_abs_err": inst_err,
         "ms": fast_t["kernel_ms"], "plain_ms": fast_t["plain_ms"],
         "launch_ms": fast_t["kernel_launch_ms"],
         "plain_launch_ms": fast_t["plain_launch_ms"],
         "timed": "bicycle + footprint + fast math, 4096 lanes",
         **regular(fast_t["kernel_regular"], fast_t["plain_regular"], "b4"),
         "split": G_options, "floor_ms": floor["b4_ms"],
         **bounds(R, ops_per_lane("bicycle", True, True, K, nd, False), K)},
        {"name": "rollout_kernel, per-problem boxes (B6)", "route": "cuda",
         "source": "cudasbmp_torch/csrc/rollout.cu",
         "replaces": "cudasbmp_tpu/parallel/batch_kgmt.py:227",
         "systems": list(SYSTEMS),
         "launches": sum(b6_splits.values()) + user("rollout_batched_cuda")["user_launches"],
         **user("rollout_batched_cuda"),
         "launches_sharded": sharded_launches["rollout_batched_cuda"],
         "launches_sharded_multi_query": smq_launches["rollout_batched_cuda"],
         "launches_two_ranks": sum(
             v["sharded"]["auto"]["launches"] + v["multi"]["launches"]
             + v["stream"]["launches"] for v in (tr[f"rank{r}"] for r in range(TWO_RANKS))),
         "max_abs_err": max(b6["max_abs_err"], shapes["max_abs_err"]),
         "ms": bt["b6_ms"], "plain_ms": bt["plain_ms"],
         "ms_64x4096": st["b6_ms"], "plain_ms_64x4096": st["plain_ms"],
         "bound_ms_64x4096": rf.bound_ms(
             MULTI_B * R, ops_per_lane("bicycle", False, False, nk, nd, False),
             MULTI_B * nk)[0],
         "launch_ms": bt["b6_launch_ms"], "plain_launch_ms": bt["plain_launch_ms"],
         **regular(bt["b6_regular"], bt["plain_regular"], "b6"),
         "split": G_b6, "splits": b6_splits, "floor_ms": floor["b6_ms"],
         **bounds(nb * nr, ops_per_lane("bicycle", False, False, nk, nd, False), nb * nk)},
        {"name": "sample_and_rollout_kernel, per-problem boxes and keys (B6)",
         "route": "cuda",
         "source": "cudasbmp_torch/csrc/rollout.cu",
         "replaces": "cudasbmp_tpu/parallel/batch_kgmt.py:208",
         "systems": list(SYSTEMS),
         "launches": sum(rng_splits.values())
         + user("sample_and_rollout_batched_cuda")["user_launches"],
         "splits": dict(rng_splits), **user("sample_and_rollout_batched_cuda"),
         "launches_sharded": sharded_launches["sample_and_rollout_batched_cuda"],
         "launches_sharded_multi_query": smq_launches["sample_and_rollout_batched_cuda"],
         "launches_two_ranks": sum(tr[f"rank{r}"]["sharded"]["cuda_rng"]["launches"]
                                   for r in range(TWO_RANKS)),
         "max_abs_err": max(b6["max_abs_err"], shapes["max_abs_err"]),
         "ms_64x4096": st["b6_rng_ms"], "plain_ms_64x4096": st["rng_plain_ms"],
         "bound_ms_64x4096": rf.bound_ms(
             MULTI_B * R, ops_per_lane("bicycle", False, False, nk, nd, True),
             MULTI_B * nk, MULTI_B)[0],
         "ms": bt["b6_rng_ms"],
         "plain_ms": bt["rng_plain_ms"], "launch_ms": bt["b6_rng_launch_ms"],
         "plain_launch_ms": bt["rng_plain_launch_ms"],
         **regular(bt["b6_rng_regular"], bt["rng_plain_regular"], "b6_rng"),
         "split": max(rng_splits, key=rng_splits.get), "floor_ms": floor["b6_rng_ms"],
         **bounds(nb * nr, ops_per_lane("bicycle", False, False, nk, nd, True), nb * nk,
                  nb)},
        {"name": "sample_and_rollout_kernel<cull> (B5)", "route": "cuda",
         "source": "cudasbmp_torch/csrc/rollout.cu",
         "replaces": "cudasbmp_tpu/ops/rollout_pallas.py:143",
         "systems": list(SYSTEMS), "windows": list(WINDOWS),
         "launches": probes["b5_launches"], "max_abs_err": b5["max_abs_err"],
         "ms": b5t["grouped_W4_ms"], "plain_ms": b5t["plain_grouped_W4_ms"],
         "launch_ms": b5t["grouped_W4_launch_ms"],
         "plain_launch_ms": b5t["plain_grouped_W4_launch_ms"],
         **regular(b5t["grouped_W4_regular"], b5t["plain_grouped_W4_regular"], "b5"),
         "cull_off_ms": b5t["grouped_W0_ms"], "floor_ms": floor["b5_ms"],
         **bounds(B_CHECK, ops_per_lane("bicycle", False, False, 24, nd, True), 24, 1)},
        {"name": "alu_chain_kernel (P1a)", "route": "cuda",
         "source": "cudasbmp_torch/csrc/chains.cu",
         "replaces": "tools/roofline.py:69",
         "launches": cal["launches"]["alu_chain_cuda"], "max_abs_err": chain_err("alu"),
         "ms": cms["alu"], "geometry": cal["p1a_geometry"], "plain_ms": pm["alu_ms"],
         "plain_launch_ms": pm["alu_launch_ms"], **regular(creg["alu"], pm["alu_regular"]),
         **chain_row(cb["alu"])},
        {"name": "trans_chain_kernel<cos|sin|tan> (P1b)", "route": "cuda",
         "source": "cudasbmp_torch/csrc/chains.cu",
         "replaces": "tools/roofline.py:79",
         "launches": cal["launches"]["trans_chain_cuda"],
         "max_abs_err": chain_err(("cos", "sin", "tan")),
         "ms": cms["cos"], "ms_sin": cms["sin"], "ms_tan": cms["tan"],
         "geometry": cal["p1b_geometry"]["cos"],
         "plain_ms": pm["cos_ms"], "plain_launch_ms": pm["cos_launch_ms"],
         **regular(creg["cos"], pm["cos_regular"]), **chain_row(cb["trans"])},
        {"name": "gather_chain_kernel (P2)", "route": "cuda",
         "source": "cudasbmp_torch/csrc/chains.cu",
         "replaces": "tools/r3_probe1.py:97",
         "launches": cal["launches"]["gather_chain_cuda"], "max_abs_err": 0.0,
         "ms": cms["gather1024"], "ms_rows8": cms["gather8"],
         "ms_rows128": cms["gather128"], "geometry": cal["p2_geometry"][1024],
         "plain_ms": pm["gather1024_ms"],
         "plain_launch_ms": pm["gather1024_launch_ms"],
         **regular(creg["gather1024"], pm["gather1024_regular"]), **chain_row(cb["gather"])},
        {"name": "refine_kernel (R1)", "route": "cuda",
         "source": "cudasbmp_torch/csrc/refine.cu",
         "replaces": "no TPU kernel (XLA's jitted value_and_grad, "
                     "cudasbmp_tpu/refine.py:122)",
         "systems": list(SYSTEMS),
         "main_path": None,
         "role": "the step path's penalty, refine.py::_refine_core(penalty="
                 "refine_penalty_cuda): the reference refine_adam_kernel is held against "
                 "in [27]; no user path launches it",
         "launches": refine_counts["r1"],
         "step_path_launches": sum(wr["step_path_r1_launches"].values()),
         "step_path_launches_per_refinement": wr["step_path_r1_launches"]["demo"],
         "max_abs_err": r1["max_abs_err"], "grad_rel_err": r1["grad_rel_err"],
         "timed": f"the CLI demo's path, 1 x {r1['demo_edges']} edges",
         "ms": r1["demo_ms"], "plain_ms": r1["demo_plain_ms"],
         "launch_ms": r1["demo_launch_ms"], "plain_launch_ms": r1["demo_plain_launch_ms"],
         **regular(r1["demo_regular"], r1["demo_plain_regular"]),
         "bound_ms": r1["demo_bound_ms"], "bound_by": r1["demo_bound_by"],
         "library_ms": None,
         "ms_pipeline": r1["pipeline_ms"], "bound_ms_pipeline": r1["pipeline_bound_ms"],
         "chain_ms": r1["chain_ms"], "chain_edges": r1["chain_edges"],
         "adam_step": steps},
        {"name": "refine_adam_kernel (R1 redesigned: the whole refinement)",
         "route": "cuda", "source": "cudasbmp_torch/csrc/refine.cu",
         "replaces": "no TPU kernel (XLA's jitted lax.scan of Adam steps, "
                     "cudasbmp_tpu/refine.py:111-170)",
         "systems": list(SYSTEMS), "launches": refine_counts["adam"],
         "user_launches": ud["refine"]["user_launches"],
         "launches_per_refinement": refine["path"]["adam_launches"],
         "max_abs_err": wr["twin_max_abs_err"], "step_path_bitwise": True,
         "timed": f"the CLI demo's path, 1 x {wr['demo_edges']} edges, "
                  f"{ADAM_ROW_STEPS} Adam steps",
         "ms": wr["demo_row_ms"], "plain_ms": wr["demo_row_plain_ms"],
         "launch_ms": wr["demo_row_launch_ms"],
         "plain_launch_ms": wr["demo_row_plain_launch_ms"],
         **regular(wr["demo_row_regular"], wr["demo_row_plain_regular"]),
         "bound_ms": wr["demo_row_bound_ms"], "bound_by": wr["demo_row_bound_by"],
         "library_ms": None,
         "ms_refinement": wr["demo_ms"], "ms_step": wr["demo_step_ms"],
         "bound_ms_refinement": wr["demo_bound_ms"],
         "ms_pipeline": wr["pipeline_ms"], "ms_step_pipeline": wr["pipeline_step_ms"],
         "bound_ms_pipeline": wr["pipeline_bound_ms"],
         "ms_pipeline_padded": wr["pipeline_padded_ms"], "chain_ms": wr["chain_ms"],
         "switch": wr["switch"], "ms_switch_below": wr["switch_below_ms"],
         "ms_switch_past": wr["switch_past_ms"]},
        {"name": "threefry_kernel (TF)", "route": "cuda",
         "source": "cudasbmp_torch/csrc/threefry.cu",
         "replaces": "no TPU kernel (jax.random's threefry, fused by XLA: "
                     "cudasbmp_tpu/planners/kgmt.py:377-387 and :448, "
                     "cudasbmp_tpu/systems/base.py:42-47)",
         "modes": ["fold_in", "split", "random_bits", "uniform", "scaled_uniform",
                   "wave_keys"],
         "launches": sum(sum(v.values()) for v in tf_main.values()),
         "launches_by_run": tf_main,
         "launches_two_ranks": sum(sum(v.values()) for r in tf_ranks.values()
                                   for v in r.values()),
         "max_abs_err": 0.0, "bitwise_draws": len(tf["checks"]),
         "timed": "the demo wave's controls, scaled_uniform over 4,096 x 3",
         "ms": tft["demo_controls_ms"], "plain_ms": tft["demo_controls_plain_ms"],
         "launch_ms": tft["demo_controls_launch_ms"],
         "plain_launch_ms": tft["demo_controls_plain_launch_ms"],
         **regular(tft["demo_controls_regular"], tft["demo_controls_plain_regular"]),
         "bound_ms": tfb["demo_controls"]["bound_ms"],
         "bound_by": tfb["demo_controls"]["bound_by"], "library_ms": None,
         "ms_acceptance": tft["demo_acceptance_ms"], "ms_wave_keys": tft["demo_wave_keys_ms"],
         "ms_wave": tft["demo_wave_ms"], "plain_ms_wave": tft["demo_wave_plain_ms"],
         "ms_64x4096": tft["fleet_controls_ms"],
         "plain_ms_64x4096": tft["fleet_controls_plain_ms"],
         "bound_ms_64x4096": tfb["fleet_controls"]["bound_ms"],
         "bound_by_64x4096": tfb["fleet_controls"]["bound_by"],
         "ms_acceptance_64x4096": tft["fleet_acceptance_ms"],
         "ms_wave_keys_64x4096": tft["fleet_wave_keys_ms"],
         "ms_wave_64x4096": tft["fleet_wave_ms"],
         "plain_ms_wave_64x4096": tft["fleet_wave_plain_ms"],
         "bounds": tfb},
    ]
    for k in kernels:
        # a row with main_path None is a reference kernel no user path runs:
        # its main-path count is read all the same, and its own run is checked
        check(k["launches"] > 0 or ("main_path" in k and k["main_path"] is None
                                    and k["step_path_launches"] > 0),
              f"{k['name']}: no launch on its main path")
        check(k["ms"] is not None and (k["regular_windows"] > 0),
              f"{k['name']}: no device time")
        # a rollout row at or above the launch and one rollout's chain
        check("floor_ms" not in k or k["ms"] >= k["floor_ms"] * (1 - FLOOR_SLACK),
              f"{k['name']}: {k['ms']} ms, below its one-warp floor {k.get('floor_ms')} ms")
    record["kernels"] = kernels
    irregular = timing.IRREGULAR_WINDOWS
    record["profiler_irregular_windows"] = irregular
    flagged = [f"{k['name']}{'' if w == 'regular_windows' else ' ' + w}: {k[w]}"
               for k in kernels for w in ("regular_windows", "floor_regular_windows")
               if k.get(w, MIN_REGULAR) < MIN_REGULAR]
    flagged += [f"{k['name']} plain_ms by CUDA events" for k in kernels
                if k["plain_ms_by"] == "events"]
    print(f"[times] regular profiler windows of each kernel time (floor): " + ", ".join(
        f"{k['name'].split(' (')[-1].rstrip(')')} {k['regular_windows']}"
        + (f" ({k['floor_regular_windows']})" if "floor_regular_windows" in k else "")
        for k in kernels) + f" | fewer than {MIN_REGULAR}: {flagged or 'none'} | "
        f"irregular windows {len(irregular)} {irregular[:3]}", flush=True)
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(smi.splitlines()[0])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
