"""The planner mesh (counterpart of cudasbmp_tpu/parallel/mesh.py).

The JAX package lays its planners over a ``('scenario', 'tree')`` device
mesh: ``scenario`` for independent problems, ``tree`` for the shards of one
logical planner (ShardedTreePlanner), whose region statistics and frontier
exchange are collectives over that axis. Here a mesh's positions are laid
over the ranks of a ``torch.distributed`` process group (one process, the
world of size 1, without one), ``scenario`` outermost as in the JAX
package: rank r holds the ``n_scenario * n_tree / world`` consecutive
positions from ``r * per_rank`` on, stacked on its one device as one
process stacks them all. So a rank holds whole scenario slots (the tree
axis is local to it) or an equal share of one slot's tree axis (the tree
axis spans ``n_tree / per_rank`` ranks). The collectives over an axis
(parallel/collectives.py) reduce the stacked positions inside the process
first, then, where the axis spans ranks, across the sub-group of ranks that
share the other axis's index.

``maybe_initialize_distributed`` joins the process group torchrun
describes in the environment. Its backend: ``nccl`` when every rank has a
card of its own, ``gloo`` on the CPU and when ranks share a card (NCCL
refuses two ranks on one device).
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch

AXES = ("scenario", "tree")


@dataclasses.dataclass(frozen=True)
class PlannerMesh:
    """The ``('scenario', 'tree')`` axes, this rank's place in the world and
    its device (a torch device string: ``cuda``, ``cuda:1``, ``cpu``).
    ``groups`` holds, by axis, the process group of the ranks that share
    this rank's index on the other axis, where the axis spans ranks."""

    n_scenario: int
    n_tree: int
    device: str = "cuda"
    world: int = 1
    rank: int = 0
    groups: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def shape(self) -> dict[str, int]:
        """Axis sizes by name, as ``jax.sharding.Mesh.shape``."""
        return {"scenario": self.n_scenario, "tree": self.n_tree}

    @property
    def per_rank(self) -> int:
        """Mesh positions each rank holds."""
        return self.n_scenario * self.n_tree // self.world

    def local_range(self, axis: str) -> tuple[int, int]:
        """The indices [lo, hi) of ``axis`` whose positions this rank holds
        (on the other axis's index or indices it holds)."""
        first = self.rank * self.per_rank
        if axis == "tree":
            if self.per_rank >= self.n_tree:
                return 0, self.n_tree
            lo = first % self.n_tree
            return lo, lo + self.per_rank
        if axis == "scenario":
            lo = first // self.n_tree
            return lo, lo + max(self.per_rank // self.n_tree, 1)
        raise ValueError(f"axis {axis!r} is not one of {AXES}")

    def spans(self, axis: str) -> bool:
        """Whether ``axis`` is laid over more than one rank."""
        lo, hi = self.local_range(axis)
        return hi - lo < self.shape[axis]

    def batch_range(self, batch: int) -> tuple[int, int]:
        """The problems [lo, hi) this rank solves of a batch laid over the
        scenario axis (``batch / n_scenario`` a slot, the JAX package's
        ``P("scenario")`` sharding)."""
        if batch % self.n_scenario:
            raise ValueError(f"batch size {batch} must be divisible by the scenario-axis "
                             f"size {self.n_scenario} (pad the batch or change the mesh)")
        per = batch // self.n_scenario
        lo, hi = self.local_range("scenario")
        return lo * per, hi * per


def _axis_ranks(n_scenario: int, n_tree: int, world: int, axis: str) -> list[list[int]]:
    """The rank lists of ``axis``'s sub-groups: the ranks that hold the
    axis's positions at one index of the other axis, in position order."""
    per = n_scenario * n_tree // world
    if axis == "tree":  # a slot's tree axis over n_tree / per ranks
        span = max(n_tree // per, 1)
        return [list(range(g * span, (g + 1) * span)) for g in range(world // span)]
    span = max(n_tree // per, 1)  # ranks sharing one slot: one block of the tree axis each
    return [list(range(j, world, span)) for j in range(span)]


def _rank_device(device: str) -> str:
    """This rank's device: the card of its local rank (``LOCAL_RANK`` modulo
    the cards this process sees) for a bare ``cuda``, else ``device``."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return str(dev)
    count = torch.cuda.device_count()
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return f"cuda:{local % count}" if count else "cuda"


def _world() -> tuple[int, int]:
    """(world size, rank) of the process group, (1, 0) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def device_count() -> int:
    """The devices of the mesh's world: one a rank under a process group
    (ranks that share a card count once each, as the JAX package's
    processes count their chips), else the CUDA cards this process sees
    (0 without one)."""
    world, _ = _world()
    if world > 1:
        return world
    return torch.cuda.device_count()


def make_planner_mesh(n_scenario: int | None = None, n_tree: int = 1,
                      device: str = "cuda") -> PlannerMesh:
    """A ``('scenario', 'tree')`` mesh over the process group's ranks, each
    on ``device`` (a bare ``cuda``: the card of its local rank).
    ``n_scenario`` defaults to the world size over ``n_tree`` (1 without a
    process group: every axis lives on the one device, so no device count
    constrains the sizes). Every rank must make the same meshes in the same
    order: the sub-groups are made here, by all ranks together. Refuses a
    layout whose positions do not split evenly over the ranks, or that
    splits a scenario slot's tree axis unevenly."""
    world, rank = _world()
    if n_scenario is None:
        n_scenario = max(world // n_tree, 1)
    if n_scenario < 1 or n_tree < 1:
        raise ValueError(f"mesh {n_scenario}x{n_tree}: axis sizes must be >= 1")
    positions = n_scenario * n_tree
    if positions % world:
        raise ValueError(f"mesh {n_scenario}x{n_tree}: {positions} positions do not "
                         f"split evenly over {world} ranks")
    per = positions // world
    if (per < n_tree and n_tree % per) or (per > n_tree and per % n_tree):
        raise ValueError(f"mesh {n_scenario}x{n_tree} over {world} ranks: {per} "
                         f"positions a rank split a scenario slot's {n_tree} tree "
                         "positions unevenly")
    groups = {}
    if world > 1:
        import torch.distributed as dist

        for axis in AXES:
            for ranks in _axis_ranks(n_scenario, n_tree, world, axis):
                if len(ranks) < 2:
                    continue
                group = dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)
                if rank in ranks:
                    groups[axis] = group
    return PlannerMesh(n_scenario=int(n_scenario), n_tree=int(n_tree),
                       device=_rank_device(str(device)) if world > 1 else str(device),
                       world=world, rank=rank, groups=groups)


def backend_for(device: str, local_world: int) -> str:
    """The process group's backend, by rule: ``nccl`` when each of the
    ``local_world`` ranks on this host has a card of its own, ``gloo`` on
    the CPU and when ranks share a card."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= local_world else "gloo"


def maybe_initialize_distributed(device: str = "cuda",
                                 timeout_s: float | None = None) -> bool:
    """Join the process group torchrun describes (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``)
    with ``backend_for``'s backend for ``device``; a no-op without that
    environment or with a group already joined. Returns whether a process
    group is up."""
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    env = os.environ
    if "RANK" not in env or "WORLD_SIZE" not in env:
        return False
    world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    backend = backend_for(device, local_world)
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)))
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method="env://", world_size=world,
                            rank=rank, **kw)
    return True
