"""Timing on the card: device time under torch.profiler and CUDA-event
time, per call of a function that launches work on the current device.

``device_ms`` profiles windows of ``n`` calls and reads each window as its
records: one ``(key, count, us)`` per kernel or copy with device time (its
name, its launches in the window, their device microseconds). The
profiler sometimes drops records, or carries some over from other work, so
a window is used only if it is regular (``window_verdicts``): every kernel
seen in any window of the call appears in it with a count that is a
positive multiple of ``n``. ``summarize`` turns the windows into a
``Timing``: the median over the regular ones and how many there were, and
no time at all where none was regular. Each window also launches GUARDS
guard kernels (``torch.cuda._sleep``) before the first call and after the
last, whose records are left out: once a process has run a while, the
profiler loses a record at one end of every window, and with guards it is
a guard's (on an H100; PERF.md). A window of a function that launches
thousands of kernels a call should hold a few calls: such windows of 20
calls lost a record in their middle."""

from __future__ import annotations

import functools
import statistics
import time
from typing import NamedTuple

import torch

TIMED = 20
GUARDS = 32  # guard kernels at each end of a window
GUARD_CYCLES = 1000
# why each irregular window seen was irregular
IRREGULAR_WINDOWS: list = []

Record = tuple[str, int, float]  # (key, launches in the window, device us)


class Timing(NamedTuple):
    """Device ms per call, the median over ``regular`` regular windows (None
    when no window was regular), of ``windows`` profiled."""
    ms: float | None
    regular: int
    windows: int


def window_verdicts(windows: list[list[Record]], n: int) -> list[str]:
    """For each window, "" if it is regular, else why not: a kernel seen in
    some window of the call is missing from it, or its count there is not a
    positive multiple of ``n``. A window with no record is irregular."""
    counts = []
    for records in windows:
        c: dict[str, int] = {}
        for key, count, us in records:
            if us > 0:
                c[key] = c.get(key, 0) + count
        counts.append(c)
    seen = sorted({key for c in counts for key in c})
    verdicts = []
    for c in counts:
        why = "no record" if not c else ""
        for key in seen:
            if why:
                break
            if key not in c:
                why = f"missing {key[:60]}"
            elif c[key] % n:
                why = f"{c[key]} launches of {key[:60]} for {n} calls"
        verdicts.append(why)
    return verdicts


def summarize(windows: list[list[Record]], n: int) -> Timing:
    """Device ms per call: the median over the regular windows of each one's
    device time over ``n``; ``ms`` None (not a time) where none is regular."""
    verdicts = window_verdicts(windows, n)
    regular = [sum(us for _, _, us in records if us > 0) / n / 1e3
               for records, why in zip(windows, verdicts) if not why]
    return Timing(statistics.median(regular) if regular else None, len(regular),
                  len(windows))


def time_ms(fn, n: int = TIMED) -> float:
    """CUDA-event ms per call over ``n`` back-to-back calls after three
    warm-up calls. Where the host launches slower than the card runs, this
    is the host's launch rate."""
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


def _records(prof, skip: frozenset = frozenset()) -> list[Record]:
    out = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        if e.key not in skip:
            out.append((e.key, e.count, us))
    return out


def _guard() -> None:
    for _ in range(GUARDS):
        torch.cuda._sleep(GUARD_CYCLES)


@functools.cache
def _guard_keys() -> frozenset:
    """The keys the guard kernels' records carry (profiled alone)."""
    from torch.profiler import ProfilerActivity, profile

    keys = set()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _guard()
            torch.cuda.synchronize()
        keys |= {key for key, _, us in _records(prof) if us > 0}
    return frozenset(keys)


def device_ms(fn, n: int = TIMED, tries: int = 8, windows: int = 3,
              budget_s: float = 2.0) -> Timing:
    """Device time per call of ``fn`` under torch.profiler, over windows of
    ``n`` calls after a warm-up call (``summarize``), each window between
    GUARDS guard kernels at either end. Profiles until
    ``windows`` windows are regular, or ``budget_s`` seconds have passed
    with at least one regular (the plain versions' windows of thousands of
    launches take seconds each), or ``tries`` windows in all. Irregular
    windows go to IRREGULAR_WINDOWS. Where the host launches slower than
    the card runs, ``time_ms`` measures the launch rate; this does not."""
    from torch.profiler import ProfilerActivity, profile

    skip = _guard_keys()
    fn()
    torch.cuda.synchronize()
    seen: list[list[Record]] = []
    start = time.perf_counter()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _guard()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            _guard()
            torch.cuda.synchronize()
        seen.append(_records(prof, skip))
        t = summarize(seen, n)
        if t.regular >= windows or (t.regular and time.perf_counter() - start > budget_s):
            break
    IRREGULAR_WINDOWS.extend(why for why in window_verdicts(seen, n) if why)
    return summarize(seen, n)
