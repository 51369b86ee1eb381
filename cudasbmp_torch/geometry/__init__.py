from cudasbmp_torch.geometry.aabb import (
    segment_aabb,
    segment_clear,
    segments_clear_batch,
)
from cudasbmp_torch.geometry.footprint import footprint_clear, footprint_corners
from cudasbmp_torch.geometry.grid import RegionGrid

__all__ = ["RegionGrid", "footprint_clear", "footprint_corners",
           "segment_aabb", "segment_clear", "segments_clear_batch"]
