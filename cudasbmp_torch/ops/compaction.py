"""Stream compaction under fixed shapes (counterpart of
cudasbmp_tpu/ops/compaction.py).

The reference compacts boolean frontier masks with ``thrust::exclusive_scan``
and a scatter kernel ``findInd`` (KGMT.cu:139-147, 319-339). Here the same
mask -> dense-index transform is a cumsum and one scatter on the mask's
device, and the size stays a tensor: no read back to the host. The planners
keep their frontier as the contiguous range [frontier_lo, tree_size), so
none calls it; it is the library's building block for a mask that does not
pack to a range. The JAX package computes it outside any Pallas kernel, and
so does this one: plain torch ops.
"""

from __future__ import annotations

import torch


def compact_indices(mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack the indices of True entries to the front of a buffer of the
    mask's size. mask: bool [M]. Returns (idx int32 [M], whose first
    ``count`` entries are the set positions in ascending order and the rest
    0, count int32 [])."""
    m = mask.shape[0]
    cum = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32)
    count = cum[-1]
    # each set bit's destination; unset bits go to a scratch slot past M
    pos = torch.where(mask, cum - 1, m).long()
    idx = torch.zeros(m + 1, dtype=torch.int32, device=mask.device)
    idx.scatter_(0, pos, torch.arange(m, dtype=torch.int32, device=mask.device))
    return idx[:m], count
