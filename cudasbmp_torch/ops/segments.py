"""Segment reductions in the place of the reference's atomic region
statistics (counterpart of cudasbmp_tpu/ops/segments.py).

The reference updates its R1/R2 counters with ``atomicAdd``/``atomicExch``
from every rollout thread (KGMT.cu:392-410, 460-478). Here a histogram is an
integer ``index_add_`` and an availability flag a scatter-max (an idempotent
OR), both exact and in a fixed result whatever the order (no float atomics,
ROADMAP's GPU determinism rules). Cells indexed -1 (out of the grid), and
past ``num``, are dropped, as JAX's ``mode="drop"`` drops them, into a
scratch row past the result. Plain torch ops: the JAX package computes
these outside any Pallas kernel.
"""

from __future__ import annotations

import torch


def _slot(indices: torch.Tensor, keep: torch.Tensor, num: int) -> torch.Tensor:
    """Each entry's row: its index where ``keep`` and inside [0, num), else
    the scratch row ``num``."""
    return torch.where(keep & (indices >= 0) & (indices < num), indices, num).long()


def masked_bincount(indices: torch.Tensor, valid: torch.Tensor, num: int) -> torch.Tensor:
    """Valid entries a cell: indices int [B] (may hold -1), valid bool [B]
    -> int32 [num]."""
    out = torch.zeros(num + 1, dtype=torch.int32, device=indices.device)
    out.index_add_(0, _slot(indices, valid, num), valid.to(torch.int32))
    return out[:num]


def masked_multi_bincount(indices: torch.Tensor, vals: torch.Tensor,
                          num: int) -> torch.Tensor:
    """Several integer columns histogrammed in one ``index_add_``: indices
    int [B] (-1 dropped), vals int [B, C] -> int32 [num, C]."""
    keep = torch.ones_like(indices, dtype=torch.bool)
    out = torch.zeros((num + 1, vals.shape[-1]), dtype=torch.int32,
                      device=indices.device)
    out.index_add_(0, _slot(indices, keep, num), vals.to(torch.int32))
    return out[:num]


def scatter_or(flags: torch.Tensor, indices: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """OR ``valid`` into the int flags at ``indices`` (in the place of
    atomicExch(..., 1)): flags int [num], indices int [B] (may hold -1),
    valid bool [B] -> a new [num] of flags' dtype."""
    num = flags.shape[0]
    out = torch.cat([flags, flags.new_zeros(1)])
    out.scatter_reduce_(0, _slot(indices, valid, num), valid.to(flags.dtype),
                        reduce="amax")
    return out[:num]
