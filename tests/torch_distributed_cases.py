"""The multi-process cases of tests/test_torch_distributed.py: each function
plans on a mesh made by ``make_planner_mesh`` over whatever process group
is up (none: one process holds every position) and returns its results as
named numpy arrays, so one process's results and each rank's can be held
against each other bit for bit.

``python tests/torch_distributed_cases.py RANK WORLD PORT OUT_DIR [CASE...]``
joins a ``gloo`` group through torchrun's environment variables
(``maybe_initialize_distributed``), runs the cases (default: all) and
writes ``OUT_DIR/rank<RANK>.npz``. With the case ``victim`` it runs the
checkpointed sharded solve into OUT_DIR slowly (to be killed); with
``resume`` it resumes the newest checkpoint there and prints the result
(tests/test_torch_distributed_recovery.py). Imports torch and the port,
never JAX.
"""

from __future__ import annotations

import hashlib
import os
import re
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from cudasbmp_torch.config import KGMTConfig, Scenario  # noqa: E402
from cudasbmp_torch.parallel import (  # noqa: E402
    ArenaMultiQueryPlanner,
    MonteCarloPlanner,
    MultiQueryPlanner,
    ShardedMultiQueryPlanner,
    ShardedTreePlanner,
    StreamingMonteCarloPlanner,
    device_count,
    make_planner_mesh,
)
from cudasbmp_torch.parallel.sharded_tree import sharded_state_to_numpy  # noqa: E402

# tests/test_parallel.py's sharded-tree config (full fan-out, small shards)
# at 4,096 slots a shard: four shards of 2,048 fill before they solve
SHARDED = dict(num_iterations=60, max_tree_size=4096, rollouts_per_iter=512,
               adaptive_waves=False)
D = 4  # tree shards: two a rank over two ranks
TRAP = np.array([[14.0, 14.0, 16.0, 16.0]], np.float32)
MQ = dict(num_iterations=30, max_tree_size=4096, rollouts_per_iter=512)
ARENA = dict(rollouts_per_iter=128, max_tree_size=128 * 13, num_iterations=12)
STREAM = dict(rollouts_per_iter=128, num_iterations=12, adaptive_waves=False,
              max_tree_size=2)


def demo_pairs(B: int, seed: int = 1):
    """B demo starts; goals jittered, the last one the demo goal (unsolved
    within a dozen arena windows, so the arena runs an extension round)."""
    base = Scenario.demo()
    inits = np.tile(base.init, (B, 1)).astype(np.float32)
    goals = np.tile(base.goal, (B, 1)).astype(np.float32)
    r = np.random.default_rng(seed)
    goals[:-1, 0] = r.uniform(8, 11, B - 1)
    goals[:-1, 1] = r.uniform(2.5, 5, B - 1)
    return inits, goals, base.padded_obstacles(8)[0]


def _fields(prefix: str, res, names) -> dict:
    return {f"{prefix}/{n}": np.asarray(getattr(res, n)) for n in names}


def case_mesh() -> dict:
    """The mesh this world makes: the default, a 2x4, and a refused 3x3."""
    out = {"mesh/device_count": np.array(device_count())}
    for tag, kw in (("default", {}), ("2x4", dict(n_scenario=2, n_tree=4))):
        m = make_planner_mesh(device="cpu", **kw)
        out[f"mesh/{tag}"] = np.array([m.n_scenario, m.n_tree, m.world, m.rank,
                                       *m.local_range("scenario"), *m.local_range("tree")])
    try:
        make_planner_mesh(n_scenario=3, n_tree=3, device="cpu")
        out["mesh/3x3_refused"] = np.array(False)
    except ValueError:
        out["mesh/3x3_refused"] = np.array(True)
    return out


def case_sharded_tree() -> dict:
    """D = 4 shards on the demo: the result and every stacked state field."""
    p = ShardedTreePlanner(KGMTConfig(**SHARDED),
                           mesh=make_planner_mesh(n_tree=D, device="cpu"))
    r = p.plan(Scenario.demo(), seed=0)
    out = _fields("tree", r, ("solved", "cost", "best_shard", "iterations",
                              "total_tree_size", "path", "path_shards",
                              "tree_sizes_by_shard", "r1_scores_by_shard"))
    out.update({f"tree/state/{k}": v
                for k, v in sharded_state_to_numpy(p.last_state, p.mesh).items()})
    out["tree/trips"] = np.array(p.last_state.trips)
    return out


def case_sterile() -> dict:
    """tests/test_parallel.py:158-184 with the roots of shards 0 and 1 (all
    of rank 0's over two ranks) inside a box: with the exchange they grow
    from the other rank's nodes (a single wave's pool slots take the pool's
    last entries, shards 2 and 3's), without it they never grow, and their
    rank runs the collectives all the same."""
    base = Scenario.demo()
    sc = Scenario(init=base.init, goal=base.goal,
                  obstacles=np.concatenate([base.obstacles, TRAP]))
    inits = np.tile(base.init, (D, 1)).astype(np.float32)
    inits[:2, 0:2] = 15.0
    cfg = KGMTConfig(**SHARDED)
    out = {}
    for tag, c in (("with", cfg), ("without", cfg.replace(exchange_frac=0.0))):
        r = ShardedTreePlanner(c, mesh=make_planner_mesh(n_tree=D, device="cpu")).plan(
            sc, inits=inits)
        out.update(_fields(f"sterile_{tag}", r, ("solved", "cost", "iterations",
                                                 "tree_sizes_by_shard", "path")))
    return out


def case_multi_query() -> dict:
    inits, goals, obstacles = demo_pairs(4)
    r = MultiQueryPlanner(KGMTConfig(**MQ), mesh=make_planner_mesh(device="cpu")
                          ).plan_batch(inits, goals, obstacles, seed=5)
    return _fields("multi", r, ("solved", "costs", "tree_sizes", "iterations", "paths",
                                "path_lengths", "budget_exhausted"))


def case_arena() -> dict:
    """Shared boxes under ``auto`` and ``cuda_rng`` (rank 1 draws its lanes
    of the batch-wide Philox launch from its first problem's on), with one
    extension round."""
    inits, goals, obstacles = demo_pairs(4)
    out = {}
    for backend in ("auto", "cuda_rng"):
        cfg = KGMTConfig(**ARENA, rollout_backend=backend)
        r = ArenaMultiQueryPlanner(cfg, mesh=make_planner_mesh(device="cpu")).plan_batch(
            inits, goals, obstacles, seed=2, max_extensions=1)
        out.update(_fields(f"arena_{backend}", r, (
            "solved", "costs", "tree_sizes", "iterations", "paths", "path_lengths",
            "budget_exhausted")))
    return out


def case_monte_carlo() -> dict:
    cfg = KGMTConfig(**MQ)
    r = MonteCarloPlanner(cfg, mesh=make_planner_mesh(device="cpu")).run(
        4, seed=3, num_obstacles=5)
    return _fields("monte_carlo", r, ("costs", "solved", "mean_tree_size"))


def case_streaming() -> dict:
    """run_sharded, one pool of 2 a scenario slot."""
    planner = StreamingMonteCarloPlanner(KGMTConfig(**STREAM), pool=2, device="cpu")
    r = planner.run_sharded(8, mesh=make_planner_mesh(device="cpu"), seed=5,
                            num_obstacles=5)
    return _fields("stream", r, ("costs", "iters"))


def case_sharded_multi_query() -> dict:
    """Two problems x four shards, the tree axis over the ranks."""
    inits, goals, obstacles = demo_pairs(2, seed=4)
    cfg = KGMTConfig(**dict(SHARDED, num_iterations=40))
    r = ShardedMultiQueryPlanner(cfg, mesh=make_planner_mesh(n_scenario=1, n_tree=D,
                                                             device="cpu")
                                 ).plan_batch(inits, goals, obstacles, seed=9)
    out = _fields("smq", r, ("solved", "costs", "best_shards", "total_tree_sizes",
                             "iterations"))
    for b in range(2):
        out[f"smq/path{b}"] = r.paths[b]
        out[f"smq/path_shards{b}"] = r.path_shards[b]
    return out


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}


def checkpoints(ckpt_dir: Path) -> list[Path]:
    """The sharded checkpoints under ``ckpt_dir``, newest first (written
    atomically: a file under its final name is whole)."""
    found = [(int(m.group(1)), p) for p in ckpt_dir.glob("sharded_checkpoint_*.npz")
             if (m := re.fullmatch(r"sharded_checkpoint_(\d+)\.npz", p.name))]
    return [p for _, p in sorted(found, reverse=True)]


def result_line(r) -> str:
    digest = hashlib.md5(np.ascontiguousarray(r.path).tobytes()).hexdigest()
    return f"RESULT cost={r.cost!r} iters={r.iterations} path={digest}"


def recovery(mode: str, ckpt_dir: Path) -> None:
    """The checkpointed sharded solve (D = 4, a checkpoint every 2
    iterations): ``victim`` sleeps half a second a chunk so a kill lands
    mid-solve; ``resume`` continues from the newest checkpoint."""
    p = ShardedTreePlanner(KGMTConfig(**SHARDED),
                           mesh=make_planner_mesh(n_tree=D, device="cpu"))
    if mode == "victim":
        p.plan_checkpointed(Scenario.demo(), ckpt_dir, checkpoint_every=2, seed=0,
                            chunk_delay_s=0.5)
        print("FINISHED_UNKILLED", flush=True)
    else:
        newest = checkpoints(ckpt_dir)[0]
        r = p.plan_checkpointed(Scenario.demo(), ckpt_dir / "resumed", checkpoint_every=2,
                                resume_from=newest)
        print(f"{result_line(r)} from={newest.name}", flush=True)


def run_cases(names=None) -> dict:
    out = {}
    for name in names or CASES:
        out.update(CASES[name]())
    return out


def main(argv: list[str]) -> int:
    rank, world, port, out_dir = int(argv[0]), int(argv[1]), argv[2], Path(argv[3])
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=port)
    torch.set_num_threads(1)
    from cudasbmp_torch.parallel import maybe_initialize_distributed

    import torch.distributed as dist

    assert maybe_initialize_distributed(device="cpu", timeout_s=120)
    try:
        if argv[4:] in (["victim"], ["resume"]):
            recovery(argv[4], out_dir)
        else:
            out = run_cases(argv[4:] or None)
            np.savez(out_dir / f"rank{rank}.npz", **out)
            print(f"rank {rank}: {len(out)} arrays", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
