"""Self time of the program's own spans in a traced run's profiled slice:
the innermost-annotation segments of ``trace.Slice``, clipped to the
slice. A program without a span gives nothing, never an error."""

from __future__ import annotations

from collections import defaultdict


def self_ns(sliced) -> dict[str, int]:
    """Nanoseconds of the slice in which each annotation was the innermost
    one open (the harness's spans included)."""
    points, labels = sliced._annotations
    lo, hi = sliced.start_ns, sliced.end_ns
    out: dict[str, int] = defaultdict(int)
    for i in range(len(points) - 1):
        a, b = max(points[i], lo), min(points[i + 1], hi)
        if b > a and labels[i]:
            out[labels[i]] += b - a
    return dict(out)


def ms_per_wave(run, name: str) -> float | None:
    """Self time of the span ``name`` in the slice over the slice's waves
    (rollout launches), in ms; None where the slice has no such span or no
    wave."""
    ns = self_ns(run.slice).get(name)
    if ns is None or not run.waves_slice:
        return None
    return ns / 1e6 / run.waves_slice
