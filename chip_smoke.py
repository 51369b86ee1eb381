"""Drive the cudasbmp_torch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # phases 1-12, one GPU, no network
    python3 chip_smoke.py --profile  # also: torch.profiler over one demo solve

Run from the root of a checkout. The CUDA kernels build from
cudasbmp_torch/csrc/ with nvcc at first use. Phases, one line each:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc seconds and the kernels' register and spill counts;
3. B1 (rollout_kernel) against its plain PyTorch version at 2^17 demo lanes
   and at the main path's wave width R=4096;
4. B2 (sample_and_rollout_kernel) against its plain twin, at both widths;
5. the reference demo solve (KGMTConfig() defaults: M=30000, R=4096,
   N=16/n=8) in tree mode, 'auto' backend, seeds 0-3: solved, path replays,
   and the launch counters prove every wave went through B1;
6. the same with 'cuda_rng' (every wave through B2) and need_path=False;
7. throughput: ms per launch of B1, B2 and their plain versions at B=4096
   (the main path's shape; the JSON line's times) and valid 10-step
   rollouts/s at B=2^17, CUDA events over 20 launches after warm-up;
8. every instantiation of B1 and B2 (5 systems x {broad phase, footprint
   B3} x {exact, fast math B4}) bitwise against its plain twin at B=4096,
   and kernel/plain ms at B=2^17 for bicycle+footprint+fast and
   dubins+footprint;
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
    configurations/ with systems/car.yaml, on the card.

Then a JSON line of the kernels and, last, {"ok": true, "device": {...}}.
Any failed check raises: the script exits non-zero and prints no result.
The full record also goes to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import math
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
TIMED = 20
SYSTEMS = ("bicycle", "point2d", "double_integrator", "unicycle", "dubins")
FOOTPRINT = (0.5, 0.25)  # half extents of a 1.0 x 0.5 body
ATOL = 1e-3  # x1 allclose: |kernel - plain| <= ATOL + RTOL * |plain|
RTOL = 1e-5  # (theta grows large where tan(steering) does: ulps scale with it)
MISMATCH_FRACTION = 1e-4  # valid-mask disagreements allowed, all near an edge
EDGE = 1e-4  # how near an edge a disagreeing lane must pass
ROOT = pathlib.Path(__file__).resolve().parent


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


def time_ms(fn, n: int = TIMED) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


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


def check_against_twins(name, system, x0, c, obstacles, key, kw) -> dict:
    """B1 and B2 with the options in ``kw`` against their plain twins on the
    card: bitwise states, equal masks, bitwise B2 controls."""
    from cudasbmp_torch.ops import rollout_cuda as rc

    x1, valid = rc.rollout_cuda(system, x0, c, obstacles, **kw)
    px1, pvalid = rc.rollout_soa(system, x0, c, obstacles, **kw)
    y1, c2, v2 = rc.sample_and_rollout_cuda(system, key, x0, obstacles, **kw)
    ty1, tc2, tv2 = rc.sample_and_rollout_torch(system, key, x0, obstacles, **kw)
    torch.cuda.synchronize()
    check(torch.equal(valid, pvalid) and bitwise(x1, px1),
          f"B1 {name} {kw}: {int((valid != pvalid).sum())} mask mismatches, "
          f"max |dx1| {float((x1 - px1).abs().max())}")
    check(bitwise(c2, tc2) and torch.equal(v2, tv2) and bitwise(y1, ty1),
          f"B2 {name} {kw}: differs from its twin")
    check(bool(torch.isfinite(x1).all()), f"B1 {name} {kw}: non-finite x1")
    return {"max_abs_err": max(float((x1 - px1).abs().max()),
                               float((y1 - ty1).abs().max())),
            "valid_fraction": float(valid.float().mean())}


def check_instantiations(dev, obstacles, kw) -> dict:
    """Phase 8: every (system, footprint, fast math) instantiation of B1 and
    B2 against its twin at B=4096; kernel and twin ms at B=2^17 for
    bicycle+footprint+fast (B4 with B3) and dubins+footprint (B3)."""
    from cudasbmp_torch import rng
    from cudasbmp_torch.ops import rollout_cuda as rc

    key = rng.key(777, dev)
    out = {"checks": {}, "times": {}}
    for i, name in enumerate(SYSTEMS):
        system, x0, c = system_batch(name, 4096, 50 + i, dev)
        for fp in (None, FOOTPRINT):
            for fast in (False, True):
                opts = dict(kw, footprint=fp, fast_math=fast)
                tag = f"{name}/{'footprint' if fp else 'broad'}/{'fast' if fast else 'exact'}"
                out["checks"][tag] = check_against_twins(name, system, x0, c,
                                                         obstacles, key, opts)
    for tag, name, fast in (("bicycle/footprint/fast", "bicycle", True),
                            ("dubins/footprint/exact", "dubins", False)):
        system, x0, c = system_batch(name, B_CHECK, 60, dev)
        opts = dict(kw, footprint=FOOTPRINT, fast_math=fast)
        out["times"][tag] = {
            "ms": time_ms(lambda: rc.rollout_cuda(system, x0, c, obstacles, **opts)),
            "plain_ms": time_ms(lambda: rc.rollout_soa(system, x0, c, obstacles, **opts)),
            "valid_fraction": float(rc.rollout_cuda(system, x0, c, obstacles,
                                                    **opts)[1].float().mean())}
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
        check(launches == summary["waves"]
              and inst[("bicycle", True, True)] == launches,
              f"all options {mode}: {dict(inst)} for {summary['waves']} waves")
        out[mode] = {**summary, "seeds": rows, "launches": launches}

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
        check(rc.rollout_cuda.launches == summary["waves"]
              and inst == {(cfg.system, False, False): summary["waves"]},
              f"{tag}: launches {inst} for {summary['waves']} waves")
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


def main() -> int:
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
    from cudasbmp_torch.ops.rollout import rollout_batch
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

    # 2. build
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

    cfg = KGMTConfig()
    system = KinematicBicycle(agent_length=cfg.agent_length)
    obstacles = torch.tensor(Scenario.demo().padded_obstacles(cfg.max_obstacles)[0],
                             device=dev)
    kw = dict(num_disc=cfg.num_disc, width=cfg.width, height=cfg.height)

    # 3. B1 against the plain version; 4. B2 against its plain twin
    key = rng.key(12345, dev)
    checks = {}
    for B in (B_CHECK, cfg.rollouts_per_iter):
        x0, ctrl = demo_batch(B, 0, dev)
        x1, valid = rc.rollout_cuda(system, x0, ctrl, obstacles, **kw)
        px1, pvalid = rollout_batch(system, x0, ctrl, cfg.num_disc, obstacles,
                                    cfg.width, cfg.height)
        torch.cuda.synchronize()
        b1 = compare("rollout_kernel", system, x0, ctrl, obstacles, cfg, x1,
                     valid, px1, pvalid)
        x1, c, valid = rc.sample_and_rollout_cuda(system, key, x0, obstacles, **kw)
        tx1, tc, tvalid = rc.sample_and_rollout_torch(system, key, x0, obstacles,
                                                      **kw)
        torch.cuda.synchronize()
        check(torch.equal(c.view(torch.int32), tc.view(torch.int32)),
              "sample_and_rollout_kernel: controls differ from the Philox twin")
        b2 = compare("sample_and_rollout_kernel", system, x0, c, obstacles, cfg,
                     x1, valid, tx1, tvalid)
        checks[B] = (b1, b2)
    b1 = {k: max(checks[B][0][k] for B in checks) for k in ("mismatches", "max_abs_err")}
    b2 = {k: max(checks[B][1][k] for B in checks) for k in ("mismatches", "max_abs_err")}
    record["checks"] = {str(B): {"b1": v[0], "b2": v[1]} for B, v in checks.items()}
    print(f"[3 B1] B={list(checks)} mismatches={b1['mismatches']} "
          f"max|dx1|={b1['max_abs_err']:.3g} (atol {ATOL}, rtol {RTOL}) bitwise rows "
          f"{min(v[0]['bitwise_rows'] for v in checks.values()):.6f}", flush=True)
    print(f"[4 B2] controls bitwise equal; mismatches={b2['mismatches']} "
          f"max|dx1|={b2['max_abs_err']:.3g} bitwise rows "
          f"{min(v[1]['bitwise_rows'] for v in checks.values()):.6f}", flush=True)

    # 5. the demo solve through B1
    rc.reset_launch_counts()
    tree, rows = solve_seeds(cfg, dev, replay=True)
    b1_launches, b2_launches = rc.rollout_cuda.launches, rc.sample_and_rollout_cuda.launches
    check(b1_launches == tree["waves"] and b2_launches == 0,
          f"tree/auto: B1 launches {b1_launches} for {tree['waves']} waves, "
          f"B2 {b2_launches}")
    record["tree_auto"] = {**tree, "seeds": rows, "b1_launches": b1_launches}
    print(f"[5 demo tree auto] solve rate {tree['solve_rate']:.2f} cost p50 "
          f"{tree['cost_p50']:.4f} p90 {tree['cost_p90']:.4f} TTS p50 "
          f"{tree['tts_p50_s'] * 1e3:.1f} ms p90 {tree['tts_p90_s'] * 1e3:.1f} ms | "
          f"waves {tree['waves']} B1 launches {b1_launches} B2 0", flush=True)

    # 6. cuda_rng (B2) and pathless
    rc.reset_launch_counts()
    rngs, rows = solve_seeds(cfg.replace(rollout_backend="cuda_rng"), dev, replay=True)
    b2_main = rc.sample_and_rollout_cuda.launches
    check(rc.rollout_cuda.launches == 0 and b2_main == rngs["waves"],
          f"tree/cuda_rng: B1 {rc.rollout_cuda.launches}, B2 {b2_main} for "
          f"{rngs['waves']} waves")
    rc.reset_launch_counts()
    pathless, prows = solve_seeds(cfg.replace(need_path=False), dev, replay=False)
    check(rc.rollout_cuda.launches == pathless["waves"]
          and rc.sample_and_rollout_cuda.launches == 0,
          f"pathless/auto: B1 {rc.rollout_cuda.launches} for {pathless['waves']} waves")
    record["tree_cuda_rng"] = {**rngs, "seeds": rows, "b2_launches": b2_main}
    record["pathless_auto"] = {**pathless, "seeds": prows,
                               "b1_launches": rc.rollout_cuda.launches}
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
        t["b1_ms"] = time_ms(lambda: rc.rollout_cuda(system, x0, ctrl, obstacles, **kw))
        t["plain_ms"] = time_ms(lambda: rollout_batch(system, x0, ctrl, cfg.num_disc,
                                                      obstacles, cfg.width, cfg.height))
        t["b2_ms"] = time_ms(lambda: rc.sample_and_rollout_cuda(system, key, x0,
                                                                obstacles, **kw))
        t["twin_ms"] = time_ms(lambda: rc.sample_and_rollout_torch(system, key, x0,
                                                                   obstacles, **kw))
        t["b1_valid_rollouts_per_s"] = t["valid"] / (t["b1_ms"] / 1e3)
        t["plain_valid_rollouts_per_s"] = t["valid"] / (t["plain_ms"] / 1e3)
        times[B] = t
    record["throughput"] = {str(B): t for B, t in times.items()}
    main, big = times[cfg.rollouts_per_iter], times[B_CHECK]
    print(f"[7 throughput] B={cfg.rollouts_per_iter}: B1 {main['b1_ms']:.4f} ms plain "
          f"{main['plain_ms']:.4f} ms B2 {main['b2_ms']:.4f} ms twin "
          f"{main['twin_ms']:.4f} ms | B={B_CHECK}: B1 {big['b1_ms']:.4f} ms "
          f"({big['b1_valid_rollouts_per_s']:.4g} valid rollouts/s) plain "
          f"{big['plain_ms']:.4f} ms ({big['plain_valid_rollouts_per_s']:.4g}/s) B2 "
          f"{big['b2_ms']:.4f} ms twin {big['twin_ms']:.4f} ms", flush=True)

    # 8. every instantiation of B1/B2 (B3, B4) against its twin; times
    t0 = time.perf_counter()
    inst = check_instantiations(dev, obstacles, kw)
    record["instantiations"] = inst
    fast_t, fp_t = inst["times"]["bicycle/footprint/fast"], inst["times"]["dubins/footprint/exact"]
    print(f"[8 instantiations] {len(inst['checks'])} x (B1, B2) bitwise equal to their "
          f"twins at B=4096 | B={B_CHECK}: bicycle+footprint+fast {fast_t['ms']:.4f} ms "
          f"plain {fast_t['plain_ms']:.4f} ms; dubins+footprint {fp_t['ms']:.4f} ms "
          f"plain {fp_t['plain_ms']:.4f} ms ({time.perf_counter() - t0:.1f} s)", flush=True)

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

    if "--profile" in sys.argv[1:]:
        out_dir.mkdir(exist_ok=True)
        record["profile_tree_auto"] = profile_solve(cfg, dev, out_dir)
        print(f"[profile] {record['profile_tree_auto']}", flush=True)

    inst_err = max(v["max_abs_err"] for v in inst["checks"].values())
    kernels = [
        {"name": "rollout_kernel", "route": "cuda",
         "source": "cudasbmp_torch/csrc/rollout.cu",
         "replaces": "cudasbmp_tpu/ops/rollout_pallas.py:432",
         "systems": list(SYSTEMS),
         "launches": b1_launches, "max_abs_err": max(b1["max_abs_err"], inst_err),
         "ms": main["b1_ms"], "plain_ms": main["plain_ms"]},
        {"name": "sample_and_rollout_kernel", "route": "cuda",
         "source": "cudasbmp_torch/csrc/rollout.cu",
         "replaces": "cudasbmp_tpu/ops/rollout_pallas.py:593",
         "systems": list(SYSTEMS),
         "launches": b2_main, "max_abs_err": max(b2["max_abs_err"], inst_err),
         "ms": main["b2_ms"], "plain_ms": main["twin_ms"]},
        {"name": "rollout_kernel<footprint> (B3)", "route": "cuda",
         "source": "cudasbmp_torch/csrc/rollout.cu",
         "replaces": "cudasbmp_tpu/ops/rollout_pallas.py:104",
         "systems": list(SYSTEMS),
         "launches": option_launches, "max_abs_err": inst_err,
         "ms": fp_t["ms"], "plain_ms": fp_t["plain_ms"]},
        {"name": "rollout_kernel<fast_math> (B4)", "route": "cuda",
         "source": "cudasbmp_torch/csrc/rollout.cu",
         "replaces": "cudasbmp_tpu/ops/rollout_pallas.py:81",
         "systems": ["bicycle", "unicycle", "dubins"],
         "launches": option_launches, "max_abs_err": inst_err,
         "ms": fast_t["ms"], "plain_ms": fast_t["plain_ms"]},
    ]
    record["kernels"] = kernels
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
