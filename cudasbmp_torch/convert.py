"""Carry planner state between the JAX package and this one, through numpy.

``state_to_numpy`` turns a port ``KGMTState``/``PathlessState`` into a dict of
numpy arrays keyed by field name, with the key as its two uint32 words (what
``jax.random.key_data`` gives). ``state_from_numpy`` builds a port state from
such a dict on a given device. A JAX state goes in as
``{**state._asdict(), "key": jax.random.key_data(state.key)}`` after
``jax.device_get``, and comes back with ``jax.random.wrap_key_data``. This
module imports no JAX: the caller does the JAX side.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from cudasbmp_torch.planners.kgmt import KGMTState, PathlessState

_HOST_INTS = ("frontier_lo", "tree_size", "itr", "n_frontier")


def state_from_numpy(cls: type, d: Mapping[str, np.ndarray],
                     device: torch.device | str) -> KGMTState | PathlessState:
    """Port state of type ``cls`` from numpy field arrays. A missing
    ``m_dropped`` (the JAX PathlessState has none) starts at zeros."""
    out = {}
    for f in dataclasses.fields(cls):
        name = f.name
        if name == "m_dropped" and name not in d:
            out[name] = np.zeros_like(np.asarray(d["m_valid"], np.int32))
            continue
        v = np.asarray(d[name])
        if name in _HOST_INTS:
            out[name] = int(v)
        elif name == "stalled":
            out[name] = bool(v)
        elif name.startswith("m_"):
            out[name] = v.astype(np.int32).copy()
        elif name == "key":
            out[name] = torch.tensor(v.astype(np.uint32).astype(np.int64),
                                     device=device)
        else:
            out[name] = torch.tensor(v, device=device)
    return cls(**out)


def state_to_numpy(s: KGMTState | PathlessState) -> dict[str, np.ndarray]:
    """Numpy field arrays of a port state (int32 scalars for host ints,
    uint32 [2] key data)."""
    out = {}
    for f in dataclasses.fields(s):
        v = getattr(s, f.name)
        if f.name in _HOST_INTS:
            out[f.name] = np.int32(v)
        elif f.name == "stalled":
            out[f.name] = np.bool_(v)
        elif f.name == "key":
            out[f.name] = v.cpu().numpy().astype(np.uint32)
        elif isinstance(v, torch.Tensor):
            out[f.name] = v.cpu().numpy()
        else:
            out[f.name] = np.asarray(v).copy()
    return out
