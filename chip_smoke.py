"""Drive the cudasbmp_torch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # phases 1-7, one GPU, no network
    python3 chip_smoke.py --profile  # also: torch.profiler over one demo solve

Run from the root of a checkout. The CUDA kernels build from
cudasbmp_torch/csrc/ with nvcc at first use. Phases, one line each:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc seconds and the kernels' register counts;
3. B1 (rollout_kernel) against its plain PyTorch version at 2^17 demo lanes
   and at the main path's wave width R=4096;
4. B2 (sample_and_rollout_kernel) against its plain twin, at both widths;
5. the reference demo solve (KGMTConfig() defaults: M=30000, R=4096,
   N=16/n=8) in tree mode, 'auto' backend, seeds 0-7: solved, path replays,
   and the launch counters prove every wave went through B1;
6. the same with 'cuda_rng' (every wave through B2) and need_path=False;
7. throughput: ms per launch of B1, B2 and their plain versions at B=4096
   (the main path's shape; the JSON line's times) and valid 10-step
   rollouts/s at B=2^17, CUDA events over 20 launches after warm-up.

Then a JSON line of the kernels and, last, {"ok": true, "device": {...}}.
Any failed check raises: the script exits non-zero and prints no result.
The full record also goes to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys

import numpy as np
import torch

B_CHECK = 2 ** 17
SEEDS = range(8)
TIMED = 20
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


def solve_seeds(cfg, dev, replay: bool) -> tuple[dict, list]:
    """Plan the demo for every seed; check each result; return a summary and
    the per-seed records."""
    from cudasbmp_torch import KGMT, Scenario
    from cudasbmp_torch.ops.rollout import rollout_batch

    planner = KGMT(cfg, device=dev)
    sc = Scenario.demo()
    warm = planner.plan(sc, seed=100)  # warm-up: kernel load, allocator, caches
    obstacles = torch.tensor(sc.obstacles, device=dev)
    rows, waves = [], expected_waves(cfg, warm.metrics)
    for seed in SEEDS:
        r = planner.plan(sc, seed=seed)
        check(r.solved, f"{cfg.rollout_backend}/need_path={cfg.need_path}: "
              f"seed {seed} unsolved after {r.iterations} iterations")
        check(math.isfinite(r.cost) and r.cost > 0, f"seed {seed}: cost {r.cost}")
        waves += expected_waves(cfg, r.metrics)
        if replay:
            p = torch.tensor(r.path, device=dev)
            check(p.shape[0] >= 2 and p.shape[1] == 7,
                  f"seed {seed}: path shape {tuple(p.shape)}")
            check(bool(torch.isfinite(p).all()), f"seed {seed}: non-finite path")
            x1, valid = rollout_batch(planner.system, p[:-1, :4].contiguous(),
                                      p[1:, 4:].contiguous(), cfg.num_disc,
                                      obstacles, cfg.width, cfg.height)
            check(bool(valid.all()), f"seed {seed}: path edge invalid on replay")
            err = float((x1 - p[1:, :4]).abs().max())
            check(err <= ATOL, f"seed {seed}: replay error {err}")
            gx, gy = r.path[-1, 0] - sc.goal[0], r.path[-1, 1] - sc.goal[1]
            check(math.hypot(gx, gy) < cfg.goal_threshold, f"seed {seed}: off goal")
        rows.append({"seed": seed, "cost": r.cost, "iterations": r.iterations,
                     "tree_size": r.tree_size, "wall_s": r.wall_time_s})
    costs = [x["cost"] for x in rows]
    walls = [x["wall_s"] for x in rows]
    summary = {"solve_rate": len(rows) / len(SEEDS),
               "cost_p50": float(np.percentile(costs, 50)),
               "cost_p90": float(np.percentile(costs, 90)),
               "tts_p50_s": float(np.percentile(walls, 50)),
               "tts_p90_s": float(np.percentile(walls, 90)),
               "waves": waves}
    return summary, rows


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
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    record["build"] = {"library": path.name, "seconds": seconds, "ptxas": regs}
    print(f"[2 build] {seconds:.1f} s nvcc -> {path.name}; "
          + " | ".join(regs), flush=True)

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

    if "--profile" in sys.argv[1:]:
        out_dir.mkdir(exist_ok=True)
        record["profile_tree_auto"] = profile_solve(cfg, dev, out_dir)
        print(f"[profile] {record['profile_tree_auto']}", flush=True)

    kernels = [
        {"name": "rollout_kernel", "route": "cuda",
         "source": "cudasbmp_torch/csrc/rollout.cu",
         "replaces": "cudasbmp_tpu/ops/rollout_pallas.py:432",
         "launches": b1_launches, "max_abs_err": b1["max_abs_err"],
         "ms": main["b1_ms"], "plain_ms": main["plain_ms"]},
        {"name": "sample_and_rollout_kernel", "route": "cuda",
         "source": "cudasbmp_torch/csrc/rollout.cu",
         "replaces": "cudasbmp_tpu/ops/rollout_pallas.py:593",
         "launches": b2_main, "max_abs_err": b2["max_abs_err"],
         "ms": main["b2_ms"], "plain_ms": main["twin_ms"]},
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
