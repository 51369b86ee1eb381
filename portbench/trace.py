"""The profiled slice of a traced run, read from torch.profiler's records
in memory (no trace file is written).

``Slice`` holds what the per-layer readers take: the slice's wall and its
span in the profiler's clock, the device's records (kernels, copies and
sets, each with its name, start, end and correlation id), the runtime's
kernel-launch records, the shapes the host's ``aten::empty*`` operators
made (a launch's buffers), and the host's annotations (the program's
``phase_scope`` names and the harness's own spans) and operators, from
which an idle gap of the device gets the label of the host activity then
open. The union of the device records is the device's busy time.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

import numpy as np

SLICE_SPAN = "portbench.slice"
CALL_SPAN = "portbench.call"


@contextlib.contextmanager
def profiled():
    """Profile the enclosed block, CPU and CUDA, inside the span SLICE_SPAN."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    with profile(activities=activities, record_shapes=True) as prof:
        with record_function(SLICE_SPAN):
            yield prof
            if card:
                torch.cuda.synchronize()


def _device_kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def _is_op(name: str) -> bool:
    """A host record of an operator or a runtime or driver call (the rest
    are annotations: the program's phase scopes and the harness's spans)."""
    return name.startswith(("aten::", "cuda", "cu", "nccl", "c10d::", "record_param"))


def _intervals_union(iv: np.ndarray) -> np.ndarray:
    """Merge [start, end) rows, sorted by start, into disjoint ones."""
    if len(iv) == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    idx = np.flatnonzero(new)
    stops = ends[np.r_[idx[1:] - 1, len(iv) - 1]]
    return np.stack([starts, stops], 1)


def _segments(spans: list[tuple[int, int, str]]) -> tuple[list[int], list[str]]:
    """Nested host spans as flat segments: the boundaries and, for each
    segment from a boundary on, the innermost span's name ('' where none)."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    points = sorted({t for s, e, _ in spans for t in (s, e)})
    labels = []
    stack: list[tuple[int, str]] = []
    opened = 0
    for t in points:
        while stack and stack[-1][0] <= t:
            stack.pop()
        while opened < len(spans) and spans[opened][0] <= t:
            s, e, name = spans[opened]
            opened += 1
            while stack and stack[-1][0] <= s:
                stack.pop()
            if e > t:
                stack.append((e, name))
        labels.append(stack[-1][1] if stack else "")
    return points, labels


def _label_at(points: list[int], labels: list[str], t: float) -> str:
    i = bisect.bisect_right(points, t) - 1
    return labels[i] if i >= 0 else ""


class Slice:
    """The device and host records of one profiled slice (``prof``, after
    its block has closed)."""

    def __init__(self, prof):
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        self.device: list[tuple[str, int, int, int, str]] = []
        self.launch_records = 0
        annotations, ops = [], []
        self.start_ns = self.end_ns = None
        events = prof.profiler.kineto_results.events()
        host_names = {e.name() for e in events if e.device_type() != cuda}
        self._launch_at: dict[int, int] = {}  # correlation id -> the launch call's start
        self._host_ops: dict[str, list[tuple[int, list]]] = defaultdict(list)
        for e in events:
            name = e.name()
            start, end = e.start_ns(), e.start_ns() + e.duration_ns()
            if e.device_type() == cuda:
                if name not in host_names:  # not the card's copy of a host span
                    self.device.append((name, start, end, e.correlation_id(),
                                        _device_kind(name)))
                continue
            if "LaunchKernel" in name:
                self.launch_records += 1
                self._launch_at[e.correlation_id()] = start
            if name == SLICE_SPAN:
                self.start_ns, self.end_ns = start, end
            elif _is_op(name):
                ops.append((start, end, name))
                if name.startswith("aten::empty"):
                    self._host_ops[name].append((start, e.shapes()))
            else:
                annotations.append((start, end, name))
        if self.start_ns is None:
            raise RuntimeError(f"the profile holds no {SLICE_SPAN} span")
        self.span_s = (self.end_ns - self.start_ns) / 1e9
        self._annotations = _segments(annotations)
        self._ops = _segments(ops)
        for v in self._host_ops.values():
            v.sort(key=lambda r: r[0])
        iv = np.array([(s, e) for _, s, e, _, _ in self.device], dtype=np.int64)
        iv = np.clip(iv.reshape(-1, 2), self.start_ns, self.end_ns)
        self.busy = _intervals_union(iv)
        self.busy_s = float((self.busy[:, 1] - self.busy[:, 0]).sum()) / 1e9

    def kernels(self, pattern: str) -> list[tuple[str, int, int, int]]:
        """The kernel records whose name holds ``pattern``: (name, start,
        end, correlation id)."""
        return [(n, s, e, c) for n, s, e, c, k in self.device
                if k == "kernel" and pattern in n]

    def shapes_before(self, correlation: int, op: str) -> list | None:
        """The input shapes of the last host operator ``op`` (an
        ``aten::empty*``) before the launch call of the kernel record
        ``correlation``: the launch's buffers, where the wrapper makes them
        just before it launches. None where either is not in the slice."""
        at = self._launch_at.get(correlation)
        recs = self._host_ops.get(op)
        if at is None or not recs:
            return None
        i = bisect.bisect_left(recs, (at,)) - 1
        return recs[i][1] if i >= 0 else None

    def union_s(self, pattern: str) -> float:
        """Seconds in which a kernel whose name holds ``pattern`` ran."""
        iv = np.array([(s, e) for _, s, e, _ in self.kernels(pattern)], dtype=np.int64)
        u = _intervals_union(np.clip(iv.reshape(-1, 2), self.start_ns, self.end_ns))
        return float((u[:, 1] - u[:, 0]).sum()) / 1e9

    def device_ops(self, top: int = 10) -> list[list]:
        """The device operations that took most time: [name, seconds]."""
        total: dict[str, int] = defaultdict(int)
        for name, s, e, _, _ in self.device:
            total[name] += e - s
        best = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:160], ns / 1e9] for name, ns in best]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """The device's idle time in the slice by what the host was doing:
        the innermost annotation open at each gap's middle and, after a
        slash, the innermost operator or runtime call then open ('python'
        where none is): [label, seconds], the largest first."""
        edges = np.concatenate([[self.start_ns], self.busy.reshape(-1), [self.end_ns]])
        gaps = edges.reshape(-1, 2)
        total: dict[str, int] = defaultdict(int)
        for s, e in gaps:
            if e <= s:
                continue
            mid = (s + e) / 2
            label = (_label_at(*self._annotations, mid) or "(none)") + "/" + (
                _label_at(*self._ops, mid) or "python")
            total[label] += int(e - s)
        best = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[label[:160], ns / 1e9] for label, ns in best]
