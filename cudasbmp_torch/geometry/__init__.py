from cudasbmp_torch.geometry.aabb import (
    segment_aabb,
    segment_clear,
    segments_clear_batch,
)
from cudasbmp_torch.geometry.grid import RegionGrid

__all__ = ["RegionGrid", "segment_aabb", "segment_clear",
           "segments_clear_batch"]
