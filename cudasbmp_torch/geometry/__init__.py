from cudasbmp_torch.geometry.aabb import (
    point_in_any_obstacle,
    segment_aabb,
    segment_clear,
    segments_clear_batch,
)
from cudasbmp_torch.geometry.footprint import footprint_clear, footprint_corners
from cudasbmp_torch.geometry.grid import OccupancyGrid, RegionGrid

__all__ = ["OccupancyGrid", "RegionGrid", "footprint_clear", "footprint_corners",
           "point_in_any_obstacle", "segment_aabb", "segment_clear", "segments_clear_batch"]
