"""Two-level workspace decomposition, R1 cells and R2 subcells
(counterpart of cudasbmp_tpu/geometry/grid.py).

- R1: N x N cells of edge ``width / N``; index ``cell_y * N + cell_x``;
  -1 outside the grid.
- R2: each R1 cell splits into n x n subcells of edge ``width / (n*N)``;
  index ``r1 * n*n + local_y * n + local_x``; -1 when r1 is -1 or the
  subcell falls outside [0, n).

Float-to-int casts truncate toward zero (``.to(torch.int32)``, like C's
``static_cast<int>``), so x in (-cell, 0) lands in cell 0. ``r2_index`` takes
floor ``//`` and ``%`` of r1 even at r1 = -1 (torch's integer ``//`` and ``%``
floor, as jnp's do); that lane is masked to -1 afterwards. Both axes use the
width-derived cell size. Divisions are IEEE on every device (_math.div).
"""

from __future__ import annotations

import dataclasses

import torch

from cudasbmp_torch._math import div


@dataclasses.dataclass(frozen=True)
class RegionGrid:
    width: float
    height: float
    N: int
    n: int

    @property
    def r1_size(self) -> float:
        return self.width / self.N

    @property
    def r2_size(self) -> float:
        return self.width / (self.n * self.N)

    @property
    def num_r1(self) -> int:
        return self.N * self.N

    @property
    def num_r2(self) -> int:
        return self.N * self.N * self.n * self.n

    def r1_index(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        cell_x = div(x, self.r1_size).to(torch.int32)
        cell_y = div(y, self.r1_size).to(torch.int32)
        inside = (cell_x >= 0) & (cell_x < self.N) & (cell_y >= 0) & (cell_y < self.N)
        return torch.where(inside, cell_y * self.N + cell_x, -1)

    def r2_index(self, x: torch.Tensor, y: torch.Tensor,
                 r1: torch.Tensor) -> torch.Tensor:
        cell_y_r1 = r1 // self.N
        cell_x_r1 = r1 % self.N
        local_x = x - cell_x_r1.to(torch.float32) * self.r1_size
        local_y = y - cell_y_r1.to(torch.float32) * self.r1_size
        cell_x = div(local_x, self.r2_size).to(torch.int32)
        cell_y = div(local_y, self.r2_size).to(torch.int32)
        inside = (cell_x >= 0) & (cell_x < self.n) & (cell_y >= 0) & (cell_y < self.n)
        r2 = r1 * (self.n * self.n) + cell_y * self.n + cell_x
        return torch.where((r1 >= 0) & inside, r2, -1)

    def region_indices(self, xy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(r1, r2) int32 for positions xy [..., 2]."""
        x, y = xy[..., 0], xy[..., 1]
        r1 = self.r1_index(x, y)
        return r1, self.r2_index(x, y, r1)
