"""Collectives over a mesh axis: the port's counterpart of the JAX
package's ``psum``, ``pmax`` and ``all_gather`` sites (the sharded tree's
statistics, termination flags and exchange pool, and the batch planners'
results).

The reductions take this process's value, already reduced over the
positions of ``axis`` it stacks (each caller reduces its own fields its
own way), and, only where the axis spans ranks (``PlannerMesh.spans``),
combine it with those of the ranks of the sub-group that shares this
rank's index on the other axis, through ``torch.distributed``. Without a
mesh, or on an axis the process holds whole, they return it as it is.

Only integers and flags are reduced across ranks: an integer sum is exact
in any order, and no float value is ever all-reduced (a float sum's bits
would depend on the order the backend adds in). Floats cross ranks only in
``axis_gather``, by copy. Under ``gloo`` a CUDA tensor is staged through
the host (gloo's collectives work on host memory); under ``nccl`` it stays
on the card.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from cudasbmp_torch.parallel.mesh import PlannerMesh

Tensor = torch.Tensor


def _group(mesh: PlannerMesh | None, axis: str):
    """The axis's sub-group where it spans ranks, else None."""
    if mesh is None or not mesh.spans(axis):
        return None
    return mesh.groups[axis]


def _staged(x: Tensor, group) -> tuple[Tensor, torch.device]:
    """``x`` as the backend takes it: on the host under gloo."""
    import torch.distributed as dist

    if x.is_cuda and dist.get_backend(group) == "gloo":
        return x.cpu(), x.device
    return x.contiguous(), x.device


def _all_reduce(mesh: PlannerMesh | None, axis: str, x: Tensor, op: str) -> Tensor:
    group = _group(mesh, axis)
    if group is None:
        return x
    import torch.distributed as dist

    buf, dev = _staged(x, group)
    dist.all_reduce(buf, op=getattr(dist.ReduceOp, op), group=group)
    return buf.to(dev)


def _integers(x: Tensor, name: str) -> None:
    if x.is_floating_point():
        raise TypeError(f"{name} takes integers: a float reduction across ranks "
                        "depends on the order of its operations")


def axis_sum(mesh: PlannerMesh | None, axis: str, x: Tensor | Sequence[Tensor]
             ) -> Tensor | list[Tensor]:
    """The integer sum over ``axis`` of the process's sums ``x``, in
    ``x``'s dtype. A sequence of tensors is summed each alone, across ranks
    in one collective (flattened into one buffer of the first one's
    dtype)."""
    sums = [x] if isinstance(x, Tensor) else list(x)
    for t in sums:
        _integers(t, "axis_sum")
    if _group(mesh, axis) is not None:
        flat = torch.cat([t.reshape(-1).to(sums[0].dtype) for t in sums])
        flat = _all_reduce(mesh, axis, flat, "SUM")
        sums = [part.view(t.shape).to(t.dtype) for part, t in
                zip(flat.split([t.numel() for t in sums]), sums)]
    return sums[0] if isinstance(x, Tensor) else sums


def axis_max(mesh: PlannerMesh | None, axis: str, x: Tensor) -> Tensor:
    """The integer max over ``axis`` of the process's maxima ``x``."""
    _integers(x, "axis_max")
    return _all_reduce(mesh, axis, x, "MAX")


def axis_any(mesh: PlannerMesh | None, axis: str, x: Tensor) -> Tensor:
    """Whether the process's flags ``x`` are set on any rank of ``axis``."""
    if _group(mesh, axis) is None:
        return x
    return _all_reduce(mesh, axis, x.to(torch.int32), "MAX") > 0


def axis_gather(mesh: PlannerMesh | None, axis: str, x: Tensor, dim: int = 0) -> Tensor:
    """``x``'s positions along ``dim`` concatenated with those of every
    rank of ``axis``'s sub-group, in rank order: the axis's positions in
    order (each rank holds consecutive ones). Bits are copied, not
    computed."""
    group = _group(mesh, axis)
    if group is None:
        return x
    import torch.distributed as dist

    buf, dev = _staged(x, group)
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts, dim=dim).to(dev)
