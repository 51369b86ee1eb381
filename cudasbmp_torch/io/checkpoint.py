"""Checkpoint and resume of planner state (counterpart of
cudasbmp_tpu/io/checkpoint.py).

A checkpoint is an ``np.savez`` of the state's fields (``convert.
state_to_numpy``: the key as its two uint32 words, host ints as int32
scalars) with a ``__state_type__`` marker naming the state class, so
``KGMTState`` and ``PathlessState`` files load as what they hold. The file
names, fields and marker are the JAX package's: a JAX checkpoint loads here
and a port checkpoint loads there (the JAX loader reads only its own fields,
so the port's extra ``m_dropped`` is ignored; one missing from a JAX
pathless file starts at zeros here). A resumed solve continues bit for bit
where it stopped, RNG included.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from cudasbmp_torch.convert import state_from_numpy, state_to_numpy
from cudasbmp_torch.planners.kgmt import KGMTState, PathlessState, resolve_device

_TYPE_FIELD = "__state_type__"
_STATE_TYPES = {"KGMTState": KGMTState, "PathlessState": PathlessState}


def save_checkpoint(state: KGMTState | PathlessState, path: str | os.PathLike) -> None:
    """Write ``state`` to ``path`` (``.npz`` appended where missing)
    atomically: savez to ``<path>.tmp.npz``, then ``os.replace``, so a
    process killed mid-write never leaves a torn file under the name."""
    name = type(state).__name__
    if name not in _STATE_TYPES:
        raise TypeError(f"cannot checkpoint a {name}; expected one of {sorted(_STATE_TYPES)}")
    write_state_npz(path, name, state_to_numpy(state))


def write_state_npz(path: str | os.PathLike, name: str,
                    fields: dict[str, np.ndarray]) -> None:
    """The atomic write of ``save_checkpoint``: the arrays ``fields`` and the
    marker ``name`` to ``path`` (``.npz`` appended where missing). The
    sharded tree's stacked state goes through it too."""
    path = str(path)
    if not path.endswith(".npz"):
        path += ".npz"
    tmp = path + ".tmp.npz"
    np.savez(tmp, **{_TYPE_FIELD: np.asarray(name)}, **fields)
    os.replace(tmp, path)


def read_state_npz(path: str | os.PathLike) -> tuple[str, dict[str, np.ndarray]]:
    """(marker, arrays) of a checkpoint file; no marker means KGMTState."""
    with np.load(path) as z:
        name = str(z[_TYPE_FIELD]) if _TYPE_FIELD in z.files else "KGMTState"
        return name, {k: z[k] for k in z.files if k != _TYPE_FIELD}


def load_checkpoint(path: str | os.PathLike, device: torch.device | str = "cuda"
                    ) -> KGMTState | PathlessState:
    """The state a checkpoint holds, its tensors on ``device``. Files
    without the marker (written before pathless states could be saved) hold
    a KGMTState."""
    name, fields = read_state_npz(path)
    return state_from_numpy(_STATE_TYPES[name], fields, resolve_device(device))
