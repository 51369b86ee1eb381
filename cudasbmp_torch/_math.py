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
