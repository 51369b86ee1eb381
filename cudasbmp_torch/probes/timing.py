"""Timing on the card: device time under torch.profiler and CUDA-event
time, per call of a function that launches work on the current device."""

from __future__ import annotations

import statistics
import time

import torch

TIMED = 20
# device_ms windows whose records were not a multiple of the calls
IRREGULAR_WINDOWS: list = []


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


def device_ms(fn, n: int = TIMED, tries: int = 8, windows: int = 3,
              budget_s: float = 2.0) -> float:
    """Device time per call of ``fn`` under torch.profiler, over ``n``
    calls after a warm-up call: for each kernel or copy, its mean device
    time per launch times its launches per call. A window where some
    kernel's records are not a multiple of ``n`` (the profiler dropped
    records or carried some over from earlier work) is irregular: it is
    logged in IRREGULAR_WINDOWS and not used. Returns the median over
    ``windows`` regular windows, at most ``tries`` windows in all and no
    new window once ``budget_s`` seconds have passed (the plain versions'
    windows of thousands of launches take seconds each); the median of
    every window, records rounded to calls, if none was regular. Where the
    host launches slower than the card runs, ``time_ms`` measures the
    launch rate; this does not. Raises if the profiler records no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    regular, rounded = [], []
    start = time.perf_counter()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        total_us, odd = 0.0, []
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            us = e.self_cuda_time_total if us is None else us
            if us > 0:
                total_us += us / e.count * max(round(e.count / n), 1)
                if e.count % n:
                    odd.append((e.key[:60], e.count))
        if total_us <= 0:
            continue
        rounded.append(total_us / 1e3)
        if odd:
            IRREGULAR_WINDOWS.append(odd[:3])
        else:
            regular.append(total_us / 1e3)
        if len(regular) == windows or time.perf_counter() - start > budget_s:
            break
    if not rounded:
        raise RuntimeError(f"torch.profiler recorded no device time in {tries} "
                           f"windows of {n} calls")
    return statistics.median(regular or rounded)
