"""Tracing and timing (counterpart of cudasbmp_tpu/utils/profiling.py).

``Timer`` is a wall timer whose ``stop`` waits for the card first (the JAX
module's ``block_until_ready``). ``trace_to`` records a ``torch.profiler``
trace of a block, CPU and, where there is a card, CUDA activity, written
as a Chrome trace (``*.pt.trace.json``, for TensorBoard or Perfetto).
``phase_scope`` names a planner phase in such a trace: the planners wrap
their phases in it under the JAX package's ``named_scope`` names
(``kgmt_scores``, ``kgmt_frontier``, ``kgmt_frontier_exchange``,
``kgmt_waves``, ``kgmt_expand``, ...).

A ``record_function`` costs some 10 us on the host even with no profiler
running, so ``phase_scope`` opens one only while a profiler records. On a
CUDA device it also pushes an NVTX range, which Nsight tools read.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

import torch


class Timer:
    """Wall timer: ``with Timer() as t: ...`` then ``t.elapsed_s``. Pass the
    result to ``stop`` for a reading taken after the card has finished the
    work queued so far (``torch.cuda.synchronize``)."""

    def __enter__(self) -> "Timer":
        self.start = time.perf_counter()
        self.elapsed_s = None
        return self

    def __exit__(self, *exc) -> None:
        if self.elapsed_s is None:
            self.elapsed_s = time.perf_counter() - self.start

    def stop(self, result=None) -> float:
        if result is not None and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.elapsed_s = time.perf_counter() - self.start
        return self.elapsed_s


@contextlib.contextmanager
def trace_to(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Record a ``torch.profiler`` trace of the enclosed block into
    ``log_dir`` (created if missing) as ``<worker>.<time>.pt.trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    handler = torch.profiler.tensorboard_trace_handler(str(log_dir))
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=handler) as prof:
        yield prof
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()


@contextlib.contextmanager
def phase_scope(name: str, device: torch.device | None = None) -> Iterator[None]:
    """A named range in profiler traces: a ``record_function`` while a
    profiler records, and an NVTX range when ``device`` is a CUDA device."""
    nvtx = device is not None and device.type == "cuda"
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        if torch._C._autograd._profiler_enabled():
            with torch.profiler.record_function(name):
                yield
        else:
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
