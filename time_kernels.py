"""Time the rollout kernels of a cudasbmp_torch checkout on one GPU.

    python3 time_kernels.py [--root CHECKOUT] [--reps 5] [--no-groups]
                            [--group-lanes 4096,32768] [--group-splits 1,4]

Imports cudasbmp_torch from CHECKOUT (default: the directory of this
script), builds its kernels, and times, on the demo's obstacles (K=8):
B1 (``rollout_cuda``) and B2 (``sample_and_rollout_cuda``) at the demo's
wave width (4,096 lanes) and at 2^17 lanes; B1 with the footprint (B3,
``b3_4096``) and with footprint and fast math (B4, ``b4_4096``) at 4,096
lanes; the one-warp floor, B1 at 32 lanes (``floor_b1_32``), and its
parts: one step and no box (``floor_n1_k0``), ten steps and no box
(``floor_n10_k0``), one step and the demo's boxes (``floor_n1_k8``);
where the checkout has kernel B6 (``rollout_batched_cuda``), B6 at the
sweeps' shape (1,024 problems x 128 lanes x 8 boxes); and where it has
thread groups
(``lanes_per_rollout``), B1 exact and with the footprint at every G in
{1, 2, 4, 8} (``--group-splits``) at each of chip_smoke.py's SPLIT_WIDTHS,
1,024 to 2^17 lanes (``--group-lanes``), as ``g<G>_<exact|footprint>_
<lanes>``, and B6 at the extension rounds' buckets (EXTENSION_BUCKETS
problems x 128 lanes x 8 boxes, ``g<G>_b6_<P>x128``), with the floor at
G = 1. Each is timed ``--reps`` times by its
device time under torch.profiler and by CUDA events (which measure the
host's launch rate where it is slower than the card), 20 launches a
measurement, as chip_smoke.py times them. Prints one JSON line with the
card's name and power limit, the checkout, the G each default launch took
(``splits``, where the checkout counts them) and every time in ms.

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
from collections import Counter


def _ints(text: str | None) -> tuple[int, ...]:
    return tuple(int(v) for v in text.split(",")) if text else ()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=pathlib.Path,
                    default=pathlib.Path(__file__).resolve().parent)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--no-groups", action="store_true",
                    help="skip the per-G table")
    ap.add_argument("--group-lanes", help="the per-G table's widths, comma-separated "
                    "(default: chip_smoke.SPLIT_WIDTHS)")
    ap.add_argument("--group-splits", help="the per-G table's G, comma-separated "
                    "(default: every G)")
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
    from chip_smoke import (EXTENSION_BUCKETS, SPLIT_WIDTHS, SWEEP_SHAPE, demo_batch,
                            problem_batch)

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
    fp = dict(kw, footprint=(0.5, 0.25))
    runs = {}
    for B in (cfg.rollouts_per_iter, 2 ** 17):
        x0, ctrl = demo_batch(B, 1, dev)
        runs[f"b1_{B}_ms"] = lambda x0=x0, ctrl=ctrl: rc.rollout_cuda(
            system, x0, ctrl, obstacles, **kw)
        runs[f"b2_{B}_ms"] = lambda x0=x0: rc.sample_and_rollout_cuda(
            system, key, x0, obstacles, **kw)
    groups = hasattr(rc, "lanes_per_rollout")  # thread groups and split=
    one = dict(split=1) if groups else {}
    x0, ctrl = demo_batch(cfg.rollouts_per_iter, 1, dev)
    runs["b3_4096_ms"] = lambda x0=x0, ctrl=ctrl: rc.rollout_cuda(
        system, x0, ctrl, obstacles, **fp)
    runs["b4_4096_ms"] = lambda x0=x0, ctrl=ctrl: rc.rollout_cuda(
        system, x0, ctrl, obstacles, **fp, fast_math=True)
    fx0, fctrl = demo_batch(32, 2, dev)
    runs["floor_b1_32_ms"] = lambda: rc.rollout_cuda(system, fx0, fctrl, obstacles,
                                                     **kw, **one)
    none = obstacles[:0]
    for tag, n, obs in (("n1_k0", 1, none), ("n10_k0", 10, none), ("n1_k8", 1, obstacles)):
        runs[f"floor_{tag}_ms"] = lambda n=n, obs=obs: rc.rollout_cuda(
            system, fx0, fctrl, obs, **dict(kw, num_disc=n), **one)
    if hasattr(rc, "rollout_batched_cuda"):
        nb, nr, nk = SWEEP_SHAPE
        bsys, bx0, bc, bobs = problem_batch("bicycle", nb, nr, nk, 98, dev)
        runs["b6_ms"] = lambda: rc.rollout_batched_cuda(bsys, bx0, bc, bobs, **kw)
    splits = {}
    if groups:
        for name, fn in list(runs.items()):  # the G each launch takes
            rc.reset_launch_counts()
            fn()
            splits[name] = dict(sum((w.splits for w in rc.WRAPPERS), Counter()))
        widths = (() if args.no_groups else _ints(args.group_lanes) or SPLIT_WIDTHS)
        for B in widths:
            x0, ctrl = demo_batch(B, 1, dev)
            for tag, opts in (("exact", kw), ("footprint", fp)):
                for G in _ints(args.group_splits) or rc.SPLITS:
                    runs[f"g{G}_{tag}_{B}_ms"] = (
                        lambda x0=x0, ctrl=ctrl, opts=opts, G=G: rc.rollout_cuda(
                            system, x0, ctrl, obstacles, **opts, split=G))
        for P in () if args.no_groups else EXTENSION_BUCKETS:
            batch = problem_batch("bicycle", P, nr, nk, 98, dev)
            for G in _ints(args.group_splits) or rc.SPLITS:
                runs[f"g{G}_b6_{P}x{nr}_ms"] = (
                    lambda batch=batch, G=G: rc.rollout_batched_cuda(*batch, **kw, split=G))
    times = {name: {"device_ms": [device_ms(fn) for _ in range(args.reps)],
                    "launch_ms": [time_ms(fn) for _ in range(args.reps)]}
             for name, fn in runs.items()}
    print(json.dumps({"card": smi, "root": str(root), "splits": splits,
                      "times": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
