"""Time the rollout kernels of a cudasbmp_torch checkout on one GPU.

    python3 time_kernels.py [--root CHECKOUT] [--reps 5]

Imports cudasbmp_torch from CHECKOUT (default: the directory of this
script), builds its kernels, and times B1 (``rollout_cuda``) and B2
(``sample_and_rollout_cuda``) on the demo's obstacles at the demo's wave
width (4,096 lanes) and at 2^17 lanes, and,
where the checkout has kernel B6 (``rollout_batched_cuda``), B6 at the
sweeps' shape (1,024 problems x 128 lanes x 8 boxes), each ``--reps``
times by its device time under torch.profiler and by CUDA events (which
measure the host's launch rate where it is slower than the card), 20
launches a measurement, as chip_smoke.py times them. Prints one JSON line
with the card's name and power limit, the checkout and every time in ms.

To compare two checkouts, time both on the same card one after the other,
in the order parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=pathlib.Path,
                    default=pathlib.Path(__file__).resolve().parent)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_kernels: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import cudasbmp_torch
    from cudasbmp_torch import KGMTConfig, rng
    from cudasbmp_torch.config import Scenario
    from cudasbmp_torch.ops import rollout_cuda as rc
    from cudasbmp_torch.systems.bicycle import KinematicBicycle

    # this script's helpers, and the timing module of this script's own
    # checkout by its path; cudasbmp_torch stays the one imported from root
    here = pathlib.Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    from chip_smoke import SWEEP_SHAPE, demo_batch, problem_batch

    spec = importlib.util.spec_from_file_location(
        "_timing", here / "cudasbmp_torch" / "probes" / "timing.py")
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)
    device_ms, time_ms = timing.device_ms, timing.time_ms

    if not pathlib.Path(cudasbmp_torch.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"time_kernels: imported {cudasbmp_torch.__file__}, not {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    cfg = KGMTConfig()
    system = KinematicBicycle(agent_length=cfg.agent_length)
    obstacles = torch.tensor(Scenario.demo().padded_obstacles(cfg.max_obstacles)[0],
                             device=dev)
    kw = dict(num_disc=cfg.num_disc, width=cfg.width, height=cfg.height)
    key = rng.key(12345, dev)
    runs = {}
    for B in (cfg.rollouts_per_iter, 2 ** 17):
        x0, ctrl = demo_batch(B, 1, dev)
        runs[f"b1_{B}_ms"] = lambda x0=x0, ctrl=ctrl: rc.rollout_cuda(
            system, x0, ctrl, obstacles, **kw)
        runs[f"b2_{B}_ms"] = lambda x0=x0: rc.sample_and_rollout_cuda(
            system, key, x0, obstacles, **kw)
    if hasattr(rc, "rollout_batched_cuda"):
        nb, nr, nk = SWEEP_SHAPE
        bsys, bx0, bc, bobs = problem_batch("bicycle", nb, nr, nk, 98, dev)
        runs["b6_ms"] = lambda: rc.rollout_batched_cuda(bsys, bx0, bc, bobs, **kw)
    times = {name: {"device_ms": [device_ms(fn) for _ in range(args.reps)],
                    "launch_ms": [time_ms(fn) for _ in range(args.reps)]}
             for name, fn in runs.items()}
    print(json.dumps({"card": smi, "root": str(root), "times": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
