"""Float arithmetic that rounds the same way on every device."""

from __future__ import annotations

import torch


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as an IEEE division on every device. PyTorch's CUDA division
    by a Python scalar multiplies by the scalar's reciprocal instead, which
    can differ in the last bit (with ``dt = dur / 10`` it moved 14% of
    2^17 demo rollouts on an H100); the CPU divides. Dividing by a tensor
    of c divides on both, as the JAX functions and the CUDA kernels do."""
    return x / torch.full_like(x, c)


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, keeping it (size 1), in one fixed order: a
    pairwise tree of elementwise adds over the row zero-padded to a power of
    two. A library reduction's order depends on the device and on the
    number of rows (on an H100 80GB HBM3, torch's sums of [64, 256] score
    rows differ in the last bit from the same rows summed one at a time in
    11% of rows: chip_smoke.py, phase 22), so a problem's total would depend
    on its batch; this one does not."""
    n = x.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x
