"""Run one cell of the benchmark of cudasbmp_torch once, on the card of
this machine, and print its result as the last line of standard output:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (BENCHMARK.json's ``workloads``)
names a configuration and a traffic mix (portbench/cells.py finds their
files); portbench/generator.py makes every call's inputs from ``--seed``
and drives the traffic's entry. Set-up (``setup_s``) runs from this
module's first line to the window's first call: imports, the CUDA context,
the kernel library (built into cudasbmp_torch/_build/ at a checkout's first
run, loaded after), the planner and one warm call at the cell's shapes. The
window is a closed loop of calls, each timed from its call to its result
after a synchronize; it starts no call once ``--seconds`` seconds have
passed, and ends with the last call's result.

After the window, a ``--trace 1`` run profiles a slice: the traffic's
``trace_calls`` calls on inputs that are the same in every run, under
torch.profiler, in memory, no trace file written; its per-layer metrics are
printed in place of its end-to-end ones. (A process that has run the
profiler stays slower on the host after it stops, so the window comes
first.)

Once the window has closed and the peak memory is read, the planner is
freed and every answer of the run is judged against the plain reference by
the traffic's judge (portbench/judges/<judge>.py); ``correct`` holds where
each number is within its limit (portbench/limits/<workload>.json). The
numbers and their limits come last: in the result's ``checks`` and as the
last lines of standard error.

The run fails without printing a result where CUDA is missing or has fewer
cards than the cell asks for, and where ``jax``, ``jaxlib``, ``flax`` or
``cudasbmp_tpu`` is among the loaded modules once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from portbench import cells, trace  # noqa: E402
from portbench.generator import Traffic  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "cudasbmp_tpu")


def forbidden_modules(names) -> list[str]:
    """The forbidden packages among module names, by whole top-level name."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


@dataclasses.dataclass
class Call:
    start: float  # seconds from the window's start
    seconds: float
    problems: int
    solved: int
    costs: np.ndarray  # the solved answers' costs


@dataclasses.dataclass
class Window:
    setup_s: float
    window_s: float
    calls: list[Call]


@dataclasses.dataclass
class TracedRun:
    """What a traced run leaves for the per-layer readers."""
    slice: trace.Slice
    waves_slice: int  # rollout-kernel launches in the profiled slice
    window_s: float  # the untraced window's wall, before the slice
    waves_window: int  # and the rollout-kernel launches in it
    waves_total: int
    solved_total: int  # problems solved in the run
    shape: dict  # a main-path rollout launch (portbench/roofline.py)


def _waves() -> int:
    from cudasbmp_torch.ops import rollout_cuda

    return sum(w.launches for w in rollout_cuda.WRAPPERS)


def run_once(args, cell: cells.Cell, hooks: dict | None = None) -> dict:
    """Set-up, the window, and with ``--trace 1`` the profiled slice and
    the per-layer readers; every answer kept. ``hooks`` (tests) may give
    ``device`` and ``wrap`` (a function of the Traffic that returns it,
    changed)."""
    import torch

    hooks = hooks or {}
    device = hooks.get("device", "cuda")
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    t_planner = time.perf_counter()
    traffic = Traffic(cell, args.seed, device)
    if "wrap" in hooks:
        traffic = hooks["wrap"](traffic)
    t_warm = time.perf_counter()
    traffic.call(traffic.warm_inputs())
    sync()
    setup_s = time.perf_counter() - T0
    setup_parts = {"to_planner": t_planner - T0, "planner": t_warm - t_planner,
                   "warm_call": T0 + setup_s - t_warm}

    calls: list[Call] = []
    answers: list[dict] = []

    def one(x: dict, start: float) -> int:
        t = time.perf_counter()
        ans = traffic.call(x)
        sync()
        dt = time.perf_counter() - t
        solved = np.asarray(ans["solved"], bool)
        calls.append(Call(t - start, dt, len(solved), int(solved.sum()),
                          np.asarray(ans["cost"])[solved]))
        answers.append(ans)
        return int(solved.sum())

    w0, solved_total, i = _waves(), 0, 0
    start = time.perf_counter()
    while True:  # no call starts once the window's seconds have passed
        solved_total += one(traffic.inputs(i), start)
        i += 1
        if time.perf_counter() - start >= args.seconds:
            break
    end = time.perf_counter()
    n_window, w_window = len(calls), _waves() - w0
    if args.trace:  # the profiled slice, after the window: the same inputs every run
        from torch.profiler import record_function

        with trace.profiled() as prof:
            t = time.perf_counter()
            for j in range(cell.traffic["trace_calls"]):
                x = traffic.slice_inputs(j)
                with record_function(trace.CALL_SPAN):
                    solved_total += one(x, start)
            sync()
            slice_wall = time.perf_counter() - t
        t = time.perf_counter()
        sliced = trace.Slice(prof)
        print(f"the slice's {len(calls) - n_window} calls took {slice_wall!r} s "
              f"under the profiler, {time.perf_counter() - t!r} s to read", file=sys.stderr)
    out = {"setup_s": setup_s, "setup_parts": setup_parts,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)) if on_card else 0}
    if args.trace:
        run = TracedRun(slice=sliced, waves_slice=_waves() - w0 - w_window,
                        window_s=end - start - calls[0].start, waves_window=w_window,
                        waves_total=_waves() - w0, solved_total=solved_total,
                        shape=traffic.entry.launch_shape())
        out["per_layer"], out["notes"] = {}, {}
        for m in cell.per_layer:
            mod = cells.reader("metrics", m["name"], cell.base)
            value = mod.read(run)
            if value is not None:
                out["per_layer"][m["name"]] = value
            if hasattr(mod, "note"):
                out["notes"][m["name"]] = mod.note(run)
        out.update(busy_s=sliced.busy_s, window_s=sliced.span_s,
                   device_ops=sliced.device_ops(), idle_gaps=sliced.idle_gaps())
    out["window"] = Window(setup_s, end - start - calls[0].start, calls[:n_window])
    out["calls"], out["answers"] = calls, answers
    del traffic
    if on_card:
        torch.cuda.empty_cache()
    return out


def result(args, cell: cells.Cell, part: dict, device: dict) -> tuple[dict, list[str]]:
    """The result line's object and the check lines, from ``run_once``'s
    output."""
    window, calls = part["window"], part["calls"]  # calls: the window's and the slice's
    attempted = sum(c.problems for c in calls)
    judge = cells.reader("judges", cell.traffic["judge"], cell.base)
    numbers = judge.read(part["answers"], attempted, cell.config)
    checks = {k: {"value": numbers[k], "limit": cell.limits[k]} for k in cell.limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if args.trace:
        values = part["per_layer"]
        device = dict(device, busy_s=part["busy_s"], window_s=part["window_s"])
    else:
        values = {m["name"]: cells.reader("end_to_end", m["name"], cell.base).read(window)
                  for m in cell.end_to_end}
    out = {"correct": correct, "attempted": attempted,
           "failed": attempted - sum(c.solved for c in calls),
           "metrics": {k: {"value": v, "unit": units[k]} for k, v in values.items()
                       if v is not None},
           "device": dict(device, memory_peak_bytes=part["memory_peak_bytes"])}
    if args.trace:
        out["breakdown"] = {"device_ops": part["device_ops"], "idle_gaps": part["idle_gaps"]}
    out["checks"] = checks
    secs = sorted(c.seconds for c in window.calls)
    others = {k: v for k, v in numbers.items() if k not in checks}
    info = [f"window: {len(secs)} calls of {window.calls[0].problems} problems in "
            f"{window.window_s!r} s; a call min {secs[0]!r} median {secs[len(secs) // 2]!r} "
            f"max {secs[-1]!r} s; setup {window.setup_s!r} s: {json.dumps(part['setup_parts'])}",
            f"judge: {json.dumps(others)}"]
    for name, note in part.get("notes", {}).items():
        info.append(f"{name}: {json.dumps(note)}")
    if args.trace:
        info.append(f"per_layer: {json.dumps(part['per_layer'])}")
    lines = info + [f"check {k}: {c['value']!r} <= {c['limit']!r}: "
                    f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}" for k, c in checks.items()]
    return out, lines


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cell = cells.load_cell(args.workload)
    import torch

    import cudasbmp_torch  # noqa: F401  (a checkout without the program has nothing to run)

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s): is_available "
              f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    part = run_once(args, cell)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips}
    out, lines = result(args, cell, part, device)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
