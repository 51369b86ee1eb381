"""Tracing and timing (counterpart of cudasbmp_tpu/utils/profiling.py).

``Timer`` is a wall timer whose ``stop`` waits for the card first (the JAX
module's ``block_until_ready``). ``trace_to`` records a ``torch.profiler``
trace of a block, CPU and, where there is a card, CUDA activity, shapes
included, written as a Chrome trace (``*.pt.trace.json``, for TensorBoard
or Perfetto). ``phase_scope`` names a span of the planners in such a
trace, and ``host_read`` is the planners' one way to read the card.

The span tree of the planner loops (planners/kgmt.py,
parallel/multi_query.py, parallel/batch_kgmt.py), outermost first:

- call spans (``CALL_SPANS``): ``kgmt_plan`` around ``KGMT.plan`` and
  ``KGMT.resume`` (tree and pathless), ``kgmt_plan_batch`` around the
  vmapped and the arena planners' ``plan_batch``, ``kgmt_restart`` around
  each restart round of the arena (``_extend``);
- loop spans (``LOOP_SPANS``): ``kgmt_wave`` around each wave of
  ``kgmt_run`` and ``kgmt_run_pathless``, ``kgmt_trip`` around each
  ``multi_query_trip``, ``kgmt_iteration`` around each
  ``arena_iteration``, and ``kgmt_waves`` around the waves of
  ``planners/kgmt.py::kgmt_iteration`` and the trips of the sharded tree;
- phases (``PHASES``), innermost: ``kgmt_init`` (state and key set-up),
  ``kgmt_scores`` (the region scores at an iteration's start),
  ``kgmt_frontier`` and ``kgmt_frontier_exchange`` (the stepwise and
  sharded iterations' frontier and exchange pool), ``kgmt_parents``
  (parent choice and gathers), ``kgmt_rng`` (every threefry draw: the wave
  keys, ``fold_in``/``split``, the controls and the acceptance uniforms,
  nested wherever it is drawn), ``kgmt_expand`` (the rollout launch and
  the concat), ``kgmt_region_stats``, ``kgmt_goal``, ``kgmt_commit``,
  ``kgmt_boundary`` (the iteration boundary and the statistics tail),
  ``kgmt_host_read`` (a read of the card, ``host_read``) and
  ``kgmt_extract`` (the path walk and the result read-back).

Every operator of these loops runs under a phase, never with a call or
loop span as its innermost span, so a trace's host time and the card's
idle gaps fall to phases. Call and loop spans carry their identifiers
(a call's planner seed and problem count, a wave's ``itr`` and ``w``, a
trip's number, an iteration's ``it``, a restart's round, bucket and
windows) as the record's keyword values, which a Chrome trace recorded
with shapes shows as the event's ``args``; the names stay few.

A ``record_function`` costs some 10 us on the host even with no profiler
running, so ``phase_scope`` opens one only while a profiler records. On a
CUDA device it also pushes an NVTX range, which Nsight tools read.

The one counter, ``host_read.reads`` (the reads of the card, from process
start; ``reset_host_reads``), is a function attribute in the rollout
wrappers' ``.launches`` idiom.
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
    ``log_dir`` (created if missing) as ``<worker>.<time>.pt.trace.json``,
    shapes recorded (so the spans' identifiers are kept)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    handler = torch.profiler.tensorboard_trace_handler(str(log_dir))
    with torch.profiler.profile(activities=activities, record_shapes=True,
                                on_trace_ready=handler) as prof:
        yield prof
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()


CALL_SPANS = ("kgmt_plan", "kgmt_plan_batch", "kgmt_restart")
LOOP_SPANS = ("kgmt_wave", "kgmt_trip", "kgmt_iteration", "kgmt_waves")
PHASES = ("kgmt_init", "kgmt_scores", "kgmt_frontier", "kgmt_frontier_exchange",
          "kgmt_parents", "kgmt_rng", "kgmt_expand", "kgmt_region_stats", "kgmt_goal",
          "kgmt_commit", "kgmt_boundary", "kgmt_host_read", "kgmt_extract")


def _record(name: str, ids: dict):
    """The profiler record of a span; with identifiers, one that keeps them
    as keyword values (``record_function``'s own ``args`` string is not
    exported to a Chrome trace)."""
    if ids:
        return torch._C._profiler._RecordFunctionFast(name, [], ids)
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def phase_scope(name: str, device: torch.device | None = None, **ids) -> Iterator[None]:
    """A named range in profiler traces: a record while a profiler records,
    carrying ``ids`` (a call's or loop's identifiers, as keyword values),
    and an NVTX range when ``device`` is a CUDA device."""
    nvtx = device is not None and device.type == "cuda"
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        if torch._C._autograd._profiler_enabled():
            with _record(name, ids):
                yield
        else:
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def host_read(t: torch.Tensor, numpy: bool = False):
    """Read ``t`` from its device, under the phase ``kgmt_host_read``:
    ``t.tolist()`` (a Python number for a 0-d tensor), or with ``numpy``
    ``t.cpu().numpy()``. Counts one in ``host_read.reads``."""
    with phase_scope("kgmt_host_read", t.device):
        host_read.reads += 1
        return t.cpu().numpy() if numpy else t.tolist()


host_read.reads = 0


def reset_host_reads() -> None:
    host_read.reads = 0
