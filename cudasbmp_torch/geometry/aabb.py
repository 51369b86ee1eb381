"""Swept-AABB broad-phase collision against axis-aligned box obstacles
(counterpart of cudasbmp_tpu/geometry/aabb.py).

Obstacles are [K, 4] rows ``(xmin, ymin, xmax, ymax)``. The separating-axis
test is exclusive: a pair is clear when on some axis ``bb_max <= omin`` or
``omax <= bb_min``, so touching boxes do not collide, and degenerate padding
boxes (max < min) are separated from everything.
"""

from __future__ import annotations

import torch


def segment_aabb(p0: torch.Tensor, p1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """AABB of a motion segment: p0, p1 [..., 2] -> (bb_min, bb_max)."""
    return torch.minimum(p0, p1), torch.maximum(p0, p1)


def segment_clear(bb_min: torch.Tensor, bb_max: torch.Tensor,
                  obstacles: torch.Tensor) -> torch.Tensor:
    """True iff the segment AABB overlaps no obstacle. bb_min, bb_max
    [..., 2]; obstacles [K, 4]; returns bool [...]."""
    omin = obstacles[:, 0:2]
    omax = obstacles[:, 2:4]
    sep = (bb_max[..., None, :] <= omin) | (omax <= bb_min[..., None, :])
    return sep.any(dim=-1).all(dim=-1)


def segments_clear_batch(p0: torch.Tensor, p1: torch.Tensor,
                         obstacles: torch.Tensor) -> torch.Tensor:
    """Endpoint arrays p0, p1 [..., 2] -> bool [...]."""
    bb_min, bb_max = segment_aabb(p0, p1)
    return segment_clear(bb_min, bb_max, obstacles)

