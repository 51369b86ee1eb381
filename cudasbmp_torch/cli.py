"""Command-line entry point of the port (counterpart of cudasbmp_tpu/cli.py):

    python -m cudasbmp_torch.cli demo [--device cuda|cpu] [--shortcut] [--refine]
                                      [config flags]
    python -m cudasbmp_torch.cli plan --configurations DIR [--device ...] [...]
    python -m cudasbmp_torch.cli record --out-dir DIR [--dump-every N]
                                        [--checkpoint-every N] [...]
    python -m cudasbmp_torch.cli multi [--impl vmap|arena] [--batch B] [...]
    python -m cudasbmp_torch.cli sweep [--impl vmap|arena|stream] [--scenarios N] [...]
    python -m cudasbmp_torch.cli probe [--planner naive|costprop] [--width W]
                                       [--rows R] [--device cuda|cpu]
    python -m cudasbmp_torch.cli sharded [--n-tree D] [--checkpoint-dir DIR
                                         [--checkpoint-every N] [--resume-from F]]
    python -m cudasbmp_torch.cli profile --trace-dir DIR [...]
    python -m cudasbmp_torch.cli viz --artifacts DIR [--out tree.png]

``demo`` plans the reference demo scenario, ``plan`` a ``configurations/``
directory (its numR1/numR2 files set the grid unless a flag does). Config
flags are the JAX CLI's; a flag given on the command line overrides
``--config FILE`` even at its default value. Output: the reference's parity
lines (``Goal: ...``, ``time inside KGMT is ...``, ``Iteration ..., Tree
size ...``), then a JSON summary; ``--verbose`` adds the per-iteration
table, ``--out-dir`` the 13 artifact CSVs, ``--shortcut`` the shortcut
line of the solved path (``shortcut: cost A -> B (N -> M edges)``,
shortcut.py::shortcut_path) and ``--refine`` the refinement line (``refine:
cost A -> B (kept|rejected — original retained; hard-revalidation
ok|FAILED)``, refine.py::refine_path, whose Adam steps run on kernel R1 on
the card); ``--plot`` with ``--out-dir`` also draws ``tree.png`` there
(viz.py). Exit code 0 when solved, 1 when not, 2 on a usage error.

``record`` solves the demo one iteration at a time (KGMT.plan_recorded),
dumping the per-iteration CSVs under ``--out-dir`` every ``--dump-every``
iterations and a checkpoint every ``--checkpoint-every``
(io/checkpoint.py; ``KGMT.resume`` continues one), then prints the JSON
summary; exit 0 when solved, 1 when not.

``multi`` plans ``--batch`` copies of the demo with the goal jittered per
problem: by default (``--impl vmap``) each with the whole single-query
solve in the vmapped multi-query planner, with ``--impl arena`` in one
batched arena. ``sweep`` plans ``--scenarios`` random scenarios, each
against its own box set: in the vmapped planner (the default), in one
batched arena (``--impl arena``) or streamed through a pool of ``--pool``
slots (``--impl stream``). Each prints the JAX CLI's JSON summary and exits
0; ``--no-need-path`` is refused there (exit 2, as in the JAX CLI).

``probe`` runs the reference's raw propagation-throughput probes (the
Naive and CostProp planners, no collision checks) on the demo's root and
prints the reference's two lines (``Kernel execution time: ...``, ``Tree
size: ...``) and a JSON line of rollouts/s.

``sharded`` solves the demo with one logical tree over ``--n-tree`` shards
(parallel/sharded_tree.py; default and divisor: the world's devices, one a
rank under torchrun, else the number of cards, so D = 1 on one card and
with ``--device cpu``), in
``--checkpoint-every``-iteration chunks with a checkpoint after each when
``--checkpoint-dir`` is given (``--resume-from`` continues one), and prints
the JAX CLI's JSON summary; exit 0 when solved, 1 when not.

Under torchrun (``torchrun --nproc-per-node N -m cudasbmp_torch.cli multi
...``) ``multi``, ``sweep`` and ``sharded`` join the process group
(parallel/mesh.py::maybe_initialize_distributed: ``nccl`` with a card a
rank, ``gloo`` on the CPU or with ranks on one card), lay their batch,
scenarios or shards over the ranks, and rank 0 alone prints the summary.

``profile`` solves the demo once outside the trace (nvcc and the first
launches), then once inside a ``torch.profiler`` trace written to
``--trace-dir`` (utils/profiling.py::trace_to), and prints where it went.
``viz`` plots a dumped artifact directory to ``--out``. The plots need
matplotlib, which the package does not depend on: without it ``viz`` and
``--plot`` exit 2 with a message before any work.

``--device`` is explicit and defaults to ``cuda``, where the rollouts run
through the hand-written CUDA kernels; without a CUDA device the CLI stops
with an error instead of moving to the CPU. ``--device cpu`` runs the plain
PyTorch versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def _add_config_args(p: argparse.ArgumentParser) -> None:
    # Flags default to None so that "set on the command line" is detectable:
    # an explicit flag overrides --config even at the dataclass default.
    from cudasbmp_torch.config import ROLLOUT_BACKENDS, KGMTConfig

    d = KGMTConfig()
    p.add_argument("--width", type=float, default=None,
                   help=f"workspace width (default {d.width})")
    p.add_argument("--height", type=float, default=None,
                   help=f"workspace height (default {d.height})")
    p.add_argument("--N", type=int, default=None,
                   help=f"R1 cells per axis (default {d.N})")
    p.add_argument("--n", type=int, default=None,
                   help=f"R2 subcells per axis (default {d.n})")
    p.add_argument("--num-iterations", type=int, default=None,
                   help=f"default {d.num_iterations}")
    p.add_argument("--max-tree-size", type=int, default=None,
                   help=f"default {d.max_tree_size}")
    p.add_argument("--num-disc", type=int, default=None,
                   help=f"default {d.num_disc}")
    p.add_argument("--agent-length", type=float, default=None,
                   help=f"default {d.agent_length}")
    p.add_argument("--goal-threshold", type=float, default=None,
                   help=f"default {d.goal_threshold}")
    p.add_argument("--rollouts-per-iter", type=int, default=None,
                   help=f"default {d.rollouts_per_iter}")
    p.add_argument("--system", default=None,
                   help=f"dynamics system (default {d.system})")
    p.add_argument("--seed", type=int, default=None, help=f"default {d.seed}")
    p.add_argument("--rollout-backend", default=None, choices=ROLLOUT_BACKENDS,
                   help="rollout implementation (see KGMTConfig)")
    p.add_argument("--goal-bias", type=float, default=None,
                   help="fraction of each wave expanded from the top-k "
                   "goal-nearest frontier nodes (0 = reference semantics)")
    p.add_argument("--fast-math", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="chained-rotation trig in the rollout kernels "
                   "(positions differ from exact only by f32 rounding)")
    p.add_argument("--footprint-width", type=float, default=None,
                   help="agent body width for the oriented-footprint "
                   "collision test (0 = broad phase only)")
    p.add_argument("--adaptive-waves", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="several sub-waves per iteration so every frontier "
                   "node gets its full fan-out")
    p.add_argument("--exchange-frac", type=float, default=None,
                   help="sharded-tree mode: fraction of each wave expanding "
                   "the cross-shard frontier-exchange pool (0 disables)")
    p.add_argument("--exchange-k", type=int, default=None,
                   help="sharded-tree mode: goal-nearest frontier nodes "
                   "each shard publishes per iteration")
    p.add_argument("--need-path", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="--no-need-path runs the pathless feasibility "
                   "planner: (solved, cost, iterations) only")
    p.add_argument("--config", help="YAML/JSON config file (overridden by "
                   "flags set on the command line)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the solve (default cuda; cpu runs "
                   "the plain PyTorch versions)")


def _add_plan_args(p: argparse.ArgumentParser) -> None:
    """The single-query subcommands' output flags."""
    p.add_argument("--out-dir", help="dump the artifact CSVs here")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--shortcut", action="store_true",
                   help="post-process the solution with kinodynamic "
                   "shortcutting")
    p.add_argument("--refine", action="store_true",
                   help="post-process the solution with gradient trajectory "
                   "refinement (hard-revalidated)")
    p.add_argument("--plot", action="store_true",
                   help="with --out-dir, also draw the tree to tree.png there "
                   "(needs matplotlib)")


def _config_from_args(args: argparse.Namespace):
    from cudasbmp_torch.config import KGMTConfig

    cfg = KGMTConfig.from_file(args.config) if args.config else KGMTConfig()
    flag_fields = dict(
        width=args.width, height=args.height, N=args.N, n=args.n,
        num_iterations=args.num_iterations, max_tree_size=args.max_tree_size,
        num_disc=args.num_disc, agent_length=args.agent_length,
        goal_threshold=args.goal_threshold,
        rollouts_per_iter=args.rollouts_per_iter, system=args.system,
        seed=args.seed, rollout_backend=args.rollout_backend,
        goal_bias=args.goal_bias, footprint_width=args.footprint_width,
        fast_math=args.fast_math, adaptive_waves=args.adaptive_waves,
        exchange_frac=args.exchange_frac, exchange_k=args.exchange_k,
        need_path=args.need_path,
    )
    overrides = {k: v for k, v in flag_fields.items() if v is not None}
    return dataclasses.replace(cfg, **overrides)


def _error(msg: str) -> int:
    print(f"error: {msg}", file=sys.stderr)
    return 2


def _plot_error() -> int:
    """2 with a message when matplotlib, which the plots need, is absent."""
    import importlib.util

    if importlib.util.find_spec("matplotlib") is None:
        return _error("matplotlib is not installed; the plots (viz, --plot) "
                      "need it")
    return 0


def _print_json(summary: dict) -> None:
    """The JSON summary, printed by rank 0 alone under a process group."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_rank() == 0:
        print(json.dumps(summary, indent=2))


def _device_error(args: argparse.Namespace) -> int:
    """2 with a message when --device names CUDA on a host without it."""
    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        return _error(f"--device {args.device}: torch.cuda.is_available() is "
                      "false; pass --device cpu to run the plain PyTorch "
                      "versions on the CPU")
    return 0


def _run_plan(args: argparse.Namespace, scenario) -> int:
    from cudasbmp_torch.io.csv import write_artifacts
    from cudasbmp_torch.planners.kgmt import KGMT
    from cudasbmp_torch.utils.metrics import (
        iteration_metrics_table,
        summarize_result,
    )

    if rc := _device_error(args):
        return rc
    device = args.device
    cfg = _config_from_args(args)
    if not cfg.need_path and (args.out_dir or args.shortcut or args.refine or args.plot):
        wants = [f for f, v in (("--shortcut", args.shortcut), ("--refine", args.refine),
                                ("--out-dir", args.out_dir), ("--plot", args.plot)) if v]
        return _error("--no-need-path keeps no tree/path; incompatible with "
                      + ", ".join(wants))
    if args.plot and args.out_dir and (rc := _plot_error()):
        return rc
    planner = KGMT(cfg, device=device)
    print(f"Goal: {scenario.goal[0]:f}, {scenario.goal[1]:f}")
    result = planner.plan(scenario)
    print(f"time inside KGMT is {result.wall_time_s}")
    print(f"Iteration {result.iterations}, Tree size {result.tree_size}")
    if args.shortcut and result.solved:
        from cudasbmp_torch.shortcut import shortcut_path

        out = shortcut_path(planner.system, cfg, result.path, scenario.goal,
                            scenario.obstacles, device=device)
        print(f"shortcut: cost {out['cost_before']:.3f} -> "
              f"{out['cost_after']:.3f} ({len(result.path) - 1} -> "
              f"{out['n_edges']} edges)")
    if args.refine and result.solved:
        from cudasbmp_torch.refine import refine_path

        out = refine_path(planner.system, cfg, result.path, scenario.goal,
                          scenario.obstacles, device=device)
        kept = out["valid"] and out["cost_after"] < out["cost_before"]
        print(f"refine: cost {out['cost_before']:.3f} -> {out['cost_after']:.3f} "
              f"({'kept' if kept else 'rejected — original retained'}; "
              f"hard-revalidation {'ok' if out['valid'] else 'FAILED'})")
    print(json.dumps(summarize_result(result), indent=2))
    if args.verbose:
        print(iteration_metrics_table(result.metrics))
    if args.out_dir:
        written = write_artifacts(result.state, cfg, args.out_dir)
        print(f"wrote {len(written)} artifact CSVs to {args.out_dir}")
        if args.plot:
            from cudasbmp_torch.viz import plot_tree

            out = plot_tree(result=result, config=cfg, obstacles=scenario.obstacles,
                            out_path=f"{args.out_dir}/tree.png",
                            footprint=cfg.footprint)
            print(f"wrote {out}")
    return 0 if result.solved else 1


def _run_record(args: argparse.Namespace) -> int:
    from cudasbmp_torch.config import Scenario
    from cudasbmp_torch.planners.kgmt import KGMT
    from cudasbmp_torch.utils.metrics import summarize_result

    if rc := _device_error(args):
        return rc
    cfg = _config_from_args(args)
    result = KGMT(cfg, device=args.device).plan_recorded(
        Scenario.demo(), args.out_dir, dump_every=args.dump_every,
        checkpoint_every=args.checkpoint_every)
    print(json.dumps(summarize_result(result), indent=2))
    return 0 if result.solved else 1


def _batch_usage_error(args: argparse.Namespace) -> int:
    """The checks ``multi`` and ``sweep`` make before any work."""
    if args.need_path is False:
        return _error("--no-need-path applies to the single-query planner "
                      "(demo/plan); the streaming sweep (sweep --impl "
                      "stream) is already pathless by design")
    return _device_error(args)


def _run_multi(args: argparse.Namespace) -> int:
    import numpy as np

    from cudasbmp_torch.config import Scenario
    from cudasbmp_torch.parallel import (
        ArenaMultiQueryPlanner,
        MultiQueryPlanner,
        make_planner_mesh,
    )

    if rc := _batch_usage_error(args):
        return rc
    cfg = _config_from_args(args)
    base = Scenario.demo()
    B = args.batch
    rng = np.random.default_rng(cfg.seed)
    inits = np.tile(base.init, (B, 1)).astype(np.float32)
    goals = np.tile(base.goal, (B, 1)).astype(np.float32)
    goals[:, :2] += rng.uniform(-args.goal_jitter, args.goal_jitter,
                                (B, 2)).astype(np.float32)
    obstacles, _ = base.padded_obstacles(cfg.max_obstacles)
    cls = ArenaMultiQueryPlanner if args.impl == "arena" else MultiQueryPlanner
    planner = cls(cfg, mesh=make_planner_mesh(device=args.device))
    res = planner.plan_batch(inits, goals, obstacles, seed=cfg.seed)
    _print_json({
        "batch": B,
        "solved": int(res.solved.sum()),
        "solve_rate": float(res.solved.mean()),
        "mean_cost": float(res.costs[res.solved].mean())
        if res.solved.any() else None,
        "wall_time_s": res.wall_time_s,
        "solves_per_sec": res.solves_per_sec,
    })
    return 0


def _run_sweep(args: argparse.Namespace) -> int:
    if rc := _batch_usage_error(args):
        return rc
    cfg = _config_from_args(args)
    if args.impl == "stream":
        from cudasbmp_torch.parallel import StreamingMonteCarloPlanner

        mc = StreamingMonteCarloPlanner(cfg, pool=min(args.pool, args.scenarios),
                                        device=args.device)
        s = mc.run(num_scenarios=args.scenarios, seed=cfg.seed,
                   num_obstacles=args.obstacles)
        _print_json({
            "scenarios": s.num_scenarios,
            "solve_rate": s.solve_rate,
            "mean_cost_solved": s.mean_cost_solved,
            "cost_quantiles": s.cost_quantiles,
            "num_budget_exhausted": s.num_budget_exhausted,
            "wall_time_s": s.wall_time_s,
            "solves_per_sec": s.solves_per_sec,
        })
        return 0
    from cudasbmp_torch.parallel import MonteCarloPlanner, make_planner_mesh

    mc = MonteCarloPlanner(cfg, mesh=make_planner_mesh(device=args.device),
                           impl=args.impl)
    s = mc.run(num_scenarios=args.scenarios, seed=cfg.seed,
               num_obstacles=args.obstacles)
    _print_json({
        "scenarios": s.num_scenarios,
        "solve_rate": s.solve_rate,
        "mean_cost_solved": s.mean_cost_solved,
        "mean_tree_size": s.mean_tree_size,
        "wall_time_s": s.wall_time_s,
        "solves_per_sec": s.solves_per_sec,
        "num_budget_exhausted": s.num_budget_exhausted,
    })
    return 0


def _run_probe(args: argparse.Namespace) -> int:
    if rc := _device_error(args):
        return rc
    from cudasbmp_torch.config import Scenario

    if args.planner == "naive":
        from cudasbmp_torch.planners.naive import NaivePlanner as P
    else:
        from cudasbmp_torch.planners.costprop import CostPropPlanner as P
    probe = P(width_rollouts=args.width, rows=args.rows, device=args.device)
    r = probe.plan(Scenario.demo())
    # NaivePlanner.cu:129-130 parity
    print(f"Kernel execution time: {r.kernel_time_s * 1e3:f} milliseconds")
    print(f"Tree size: {r.num_rollouts}")
    print(json.dumps({"rollouts_per_sec": r.rollouts_per_sec}))
    return 0


def _run_sharded(args: argparse.Namespace) -> int:
    import torch
    import torch.distributed as dist

    from cudasbmp_torch.config import Scenario
    from cudasbmp_torch.parallel import ShardedTreePlanner, make_planner_mesh
    from cudasbmp_torch.parallel.mesh import device_count

    if args.resume_from and not args.checkpoint_dir:
        return _error("--resume-from requires --checkpoint-dir")
    if rc := _batch_usage_error(args):
        return rc
    cfg = _config_from_args(args)
    # the tree axis defaults to, and must divide, the world's devices (one a
    # rank under torchrun, else the cards), as the JAX CLI's does its devices
    n_dev = (device_count() if torch.device(args.device).type == "cuda"
             or dist.is_initialized() else 1)
    n_tree = args.n_tree or n_dev
    if n_dev % n_tree != 0:
        return _error(f"--n-tree {n_tree} must divide the device count {n_dev}")
    planner = ShardedTreePlanner(cfg, mesh=make_planner_mesh(
        n_scenario=n_dev // n_tree, n_tree=n_tree, device=args.device))
    sc = Scenario.demo()
    if args.checkpoint_dir:
        res = planner.plan_checkpointed(sc, args.checkpoint_dir,
                                        checkpoint_every=args.checkpoint_every,
                                        resume_from=args.resume_from)
    else:
        res = planner.plan(sc)
    _print_json({
        "n_tree": n_tree,
        "solved": res.solved,
        "cost": res.cost if res.solved else None,
        "iterations": res.iterations,
        "total_tree_size": res.total_tree_size,
        "best_shard": res.best_shard,
        "path_crosses_shards": bool(len(set(res.path_shards.tolist())) > 1),
        "wall_time_s": res.wall_time_s,
    })
    return 0 if res.solved else 1


def _run_profile(args: argparse.Namespace) -> int:
    from cudasbmp_torch.config import Scenario
    from cudasbmp_torch.planners.kgmt import KGMT
    from cudasbmp_torch.utils.profiling import trace_to

    if rc := _device_error(args):
        return rc
    planner = KGMT(_config_from_args(args), device=args.device)
    planner.plan(Scenario.demo())  # the build and first launches, outside
    with trace_to(args.trace_dir):
        result = planner.plan(Scenario.demo())
    print(f"trace written to {args.trace_dir}; "
          f"solved={result.solved} wall={result.wall_time_s:.3f}s")
    return 0


def _run_viz(args: argparse.Namespace) -> int:
    if rc := _plot_error():
        return rc
    from cudasbmp_torch.viz import plot_tree

    out = plot_tree(artifacts_dir=args.artifacts, out_path=args.out)
    print(f"wrote {out}")
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    parser = argparse.ArgumentParser(prog="cudasbmp_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_demo = sub.add_parser("demo", help="plan the reference demo scenario")
    _add_config_args(p_demo)
    _add_plan_args(p_demo)
    p_plan = sub.add_parser("plan", help="plan a configurations/ scenario")
    _add_config_args(p_plan)
    _add_plan_args(p_plan)
    p_plan.add_argument("--configurations", required=True,
                        help="directory in the reference configurations/ "
                        "layout")
    p_rec = sub.add_parser("record", help="step-by-step solve with per-iteration "
                           "dumps (the reference's commented-out debug workflow, "
                           "KGMT.cu:263-291)")
    _add_config_args(p_rec)
    p_rec.add_argument("--out-dir", required=True)
    p_rec.add_argument("--dump-every", type=int, default=1)
    p_rec.add_argument("--checkpoint-every", type=int, default=None)
    p_multi = sub.add_parser("multi", help="multi-query batch: B init/goal "
                             "pairs planned together")
    _add_config_args(p_multi)
    p_multi.add_argument("--batch", type=int, default=64)
    p_multi.add_argument("--goal-jitter", type=float, default=1.0,
                         help="uniform jitter applied to the demo goal per "
                         "problem")
    p_multi.add_argument("--impl", choices=["vmap", "arena"], default="vmap",
                         help="'vmap' = every problem with the whole "
                         "single-query solve (adaptive waves supported); "
                         "'arena' = the batched arena (fixed wave width)")
    p_sweep = sub.add_parser("sweep", help="Monte-Carlo sweep over random "
                             "obstacle scenarios")
    _add_config_args(p_sweep)
    p_sweep.add_argument("--scenarios", type=int, default=64)
    p_sweep.add_argument("--obstacles", type=int, default=8)
    p_sweep.add_argument("--impl", choices=["vmap", "arena", "stream"],
                         default="vmap",
                         help="'vmap' = every scenario with the whole "
                         "single-query solve; 'arena' = one batched arena "
                         "over every scenario; 'stream' = slot-refilling "
                         "streaming sweep (per-scenario results, no tree "
                         "storage)")
    p_sweep.add_argument("--pool", type=int, default=1024,
                         help="resident slot count for --impl stream")
    p_probe = sub.add_parser("probe", help="raw propagation-throughput probes "
                             "(Naive/CostProp planner analogs)")
    p_probe.add_argument("--planner", choices=["naive", "costprop"],
                         default="costprop")
    p_probe.add_argument("--width", type=int, default=1024 * 512,
                         help="rollouts per row (CostProp reference: 524288)")
    p_probe.add_argument("--rows", type=int, default=1)
    p_probe.add_argument("--device", default="cuda",
                         help="torch device (default cuda; cpu runs on the CPU)")
    p_viz = sub.add_parser("viz", help="plot a dumped artifact directory")
    p_viz.add_argument("--artifacts", required=True)
    p_viz.add_argument("--out", default="tree.png")
    p_prof = sub.add_parser("profile", help="capture a torch.profiler trace of "
                            "one solve (view in TensorBoard/Perfetto)")
    _add_config_args(p_prof)
    p_prof.add_argument("--trace-dir", required=True)
    p_sharded = sub.add_parser(
        "sharded", help="ONE logical tree sharded over the mesh 'tree' axis "
        "(global guidance + cross-shard frontier exchange); optional chunked "
        "checkpointing with exact resume")
    _add_config_args(p_sharded)
    p_sharded.add_argument("--n-tree", type=int, default=0,
                           help="tree-axis size (0 = the number of cards)")
    p_sharded.add_argument("--checkpoint-dir", default=None,
                           help="run in chunks, writing a full-state "
                           "checkpoint after each (plan_checkpointed)")
    p_sharded.add_argument("--checkpoint-every", type=int, default=4,
                           help="iterations per chunk/checkpoint")
    p_sharded.add_argument("--resume-from", default=None,
                           help="checkpoint npz to resume from "
                           "(requires --checkpoint-dir)")
    args = parser.parse_args(argv)

    if args.cmd == "probe":
        return _run_probe(args)
    if args.cmd in ("multi", "sweep", "sharded"):
        # under torchrun: one process a rank, each solving its part
        from cudasbmp_torch.parallel.mesh import maybe_initialize_distributed

        if _device_error(args) == 0:
            maybe_initialize_distributed(args.device)
    if args.cmd == "sharded":
        return _run_sharded(args)
    if args.cmd == "profile":
        return _run_profile(args)
    if args.cmd == "viz":
        return _run_viz(args)

    if args.cmd == "record":
        return _run_record(args)
    if args.cmd == "multi":
        return _run_multi(args)
    if args.cmd == "sweep":
        return _run_sweep(args)
    if args.cmd == "demo":
        from cudasbmp_torch.config import Scenario

        return _run_plan(args, Scenario.demo())
    from cudasbmp_torch.io.csv import load_scenario

    scenario, grid_params = load_scenario(args.configurations)
    # a PRESENT numR1/numR2 CSV sets the grid unless a flag does; an absent
    # one defers to --config and the defaults
    if args.N is None and grid_params["N"] is not None:
        args.N = grid_params["N"]
    if args.n is None and grid_params["n"] is not None:
        args.n = grid_params["n"]
    return _run_plan(args, scenario)


if __name__ == "__main__":
    sys.exit(main())
