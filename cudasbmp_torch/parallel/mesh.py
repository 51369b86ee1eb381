"""The planner mesh (counterpart of cudasbmp_tpu/parallel/mesh.py).

The JAX package lays its planners over a ``('scenario', 'tree')`` device
mesh: ``scenario`` for independent problems, ``tree`` for the shards of one
logical planner (ShardedTreePlanner), whose region statistics and frontier
exchange are collectives over that axis. Here a mesh is a small
description of the two axes and of the one device that holds them: every
shard of the ``tree`` axis lives on that device, stacked on a leading axis
of size ``n_tree``, as MultiQueryPlanner stacks problems, and the
collectives are sums and concatenations over that axis. Several processes,
one a card, are not yet supported; ``maybe_initialize_distributed`` is the
place they will start from.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PlannerMesh:
    """The ``('scenario', 'tree')`` axes and the device holding every
    shard (a torch device string: ``cuda``, ``cuda:1``, ``cpu``)."""

    n_scenario: int
    n_tree: int
    device: str = "cuda"

    @property
    def shape(self) -> dict[str, int]:
        """Axis sizes by name, as ``jax.sharding.Mesh.shape``."""
        return {"scenario": self.n_scenario, "tree": self.n_tree}


def device_count() -> int:
    """The number of CUDA cards this process sees (0 without one)."""
    import torch

    return torch.cuda.device_count()


def make_planner_mesh(n_scenario: int | None = None, n_tree: int = 1,
                      device: str = "cuda") -> PlannerMesh:
    """A ``('scenario', 'tree')`` mesh on ``device``. ``n_scenario``
    defaults to 1: every axis lives on the one device, so no device count
    constrains the sizes (the JAX function fills the devices it sees)."""
    if n_scenario is None:
        n_scenario = 1
    if n_scenario < 1 or n_tree < 1:
        raise ValueError(f"mesh {n_scenario}x{n_tree}: axis sizes must be >= 1")
    return PlannerMesh(n_scenario=int(n_scenario), n_tree=int(n_tree),
                       device=str(device))


def maybe_initialize_distributed() -> None:
    """No-op: one process drives every shard on its one device. The
    multi-process form (a process a card, ``torch.distributed`` given its
    address, world size and rank) is not yet ported."""
