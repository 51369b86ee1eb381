"""Sets of runs of one cell, each run a process of its own as the check
runs them, and the spread of every metric in each set:

    python3 -m portbench.sets --workload demo.single --seconds 51 --sets 2 \\
        --seeds 11,12,13,14,15,16 [--trace-seeds 21,22,23] [--out FILE]

Every set runs the same seeds in turn. A spread is the distance between the
first and third quartile (``statistics.quantiles(values, n=4)``) over the
median. Prints each run's result line with its wall, then one summary line
a metric; with ``--out``, the same lines go to FILE (JSON lines).
"""

import argparse
import json
import statistics
import subprocess
import sys
import time

from portbench.cells import ROOT


def spread(values: list[float]) -> float | None:
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def one(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, "-m", "portbench.run", "--workload", workload, "--seed",
           str(seed), "--seconds", str(seconds), "--trace", str(trace)]
    t = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    rec = {"workload": workload, "seed": seed, "trace": trace, "rc": p.returncode,
           "wall_s": time.perf_counter() - t, "stderr_tail": p.stderr[-3000:]}
    lines = p.stdout.strip().splitlines()
    if p.returncode == 0 and lines:
        rec["result"] = json.loads(lines[-1])
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--seeds", default="", help="comma-separated, one run each a set")
    p.add_argument("--trace-seeds", default="")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    seeds = [int(s) for s in a.seeds.split(",") if s]
    out = open(a.out, "a") if a.out else None

    def emit(rec: dict) -> None:
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    by_set: list[list[dict]] = []
    for k in range(a.sets if seeds else 0):
        by_set.append([])
        for seed in seeds:
            rec = one(a.workload, seed, a.seconds, 0)
            rec["set"] = k
            by_set[-1].append(rec)
            emit(rec)
    for seed in (int(s) for s in a.trace_seeds.split(",") if s):
        emit(one(a.workload, seed, a.seconds, 1))
    for k, recs in enumerate(by_set):
        ok = [r["result"] for r in recs if "result" in r]
        names = sorted({m for r in ok for m in r["metrics"]})
        for name in names:
            values = [r["metrics"][name]["value"] for r in ok if name in r["metrics"]]
            emit({"summary": a.workload, "set": k, "metric": name, "n": len(values),
                  "median": statistics.median(values), "spread": spread(values),
                  "values": values})
        emit({"summary": a.workload, "set": k, "correct": [r["correct"] for r in ok],
              "runs": len(recs), "results": len(ok)})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
