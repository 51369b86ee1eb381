"""Wrappers of the threefry kernel (csrc/threefry.cu): every threefry draw
of ``rng.py`` on a CUDA key as one launch, the bits of its torch twin
(``rng.fold_in_torch``, ``split_torch``, ``random_bits_torch``,
``uniform_torch``, ``scaled_uniform_torch``, ``wave_keys_torch``), with the
shapes the twin returns. ``rng.py``'s public functions call these for a
CUDA key and the twins for a CPU one; nothing here reads the card back,
and each launches on the current stream of the key's device.

Keys [..., 2] broadcast against data and against [..., *shape] as the
twins do: each operand is read at (index // div) % mod of the output
(``_map``), so a key, a data tensor or a bound that is broadcast or given
per problem needs no copy; an operand broadcast along an inner axis of
the output is made contiguous first (one copy). A bound that would widen
the output past the keys' draw raises, as ``jax.random.uniform`` does. A
Python number goes to the kernel by value; a draw of 2^31 outputs or more
is refused.

Each wrapper counts its launches in ``<wrapper>.launches``
(``reset_launch_counts``).
"""

from __future__ import annotations

import math

import torch

from cudasbmp_torch import rng
from cudasbmp_torch.ops import _build
from cudasbmp_torch.ops.rollout_cuda import _index, _raise_on

FOLD_IN, SPLIT, RANDOM_BITS, UNIFORM, WAVE_KEYS = range(5)  # csrc/threefry.cu's Mode
_NO_INT = (None, 0, 1, 1, 1)  # an unused int operand: pointer, value, div, mod, wide
_ZERO, _ONE = (None, 0.0, 1, 1), (None, 1.0, 1, 1)  # float operands: the unit range


def _broadcast(*shapes: tuple[int, ...]) -> tuple[int, ...]:
    """``torch.broadcast_shapes``' rule, without the import its first call
    makes (``torch.fx.experimental.symbolic_shapes``, some 4 s on the
    card's host)."""
    out = [1] * max(map(len, shapes))
    for shape in shapes:
        for i, size in enumerate(shape, len(out) - len(shape)):
            if size != 1:
                if out[i] not in (1, size):
                    raise ValueError(f"shapes {shapes} do not broadcast")
                out[i] = size
    return tuple(out)


def _map(shape: tuple[int, ...], out: tuple[int, ...]) -> tuple[int, int] | None:
    """(div, mod) such that element e of a row-major ``out`` reads element
    (e // div) % mod of a contiguous operand of ``shape`` broadcast against
    ``out`` from the right; None where the operand's axes of size above 1
    are not consecutive axes of ``out`` of the same sizes (a broadcast
    along an inner axis)."""
    pad = len(out) - len(shape)
    axes = [i for i, s in enumerate(shape) if s != 1]
    if not axes:
        return 1, 1
    lo, hi = axes[0], axes[-1] + 1
    if tuple(shape[lo:hi]) != tuple(out[pad + lo:pad + hi]):
        return None
    return math.prod(out[pad + hi:]), math.prod(shape[lo:hi])


def _operand(t: torch.Tensor, out: tuple[int, ...]) -> tuple:
    """(t contiguous, div, mod): the kernel reads element e of ``out`` at
    (e // div) % mod of it; a broadcast along an inner axis is copied out
    first."""
    m = _map(t.shape, out)
    if m is None:
        t, m = t.expand(out), (1, math.prod(out))
    return t.contiguous(), *m


def _keys(k: torch.Tensor, batch: tuple[int, ...]) -> tuple:
    """The kernel's key arguments for keys k[..., 2] over ``batch``: (keys
    as rows of two words, row stride, word stride, div, mod); the rows are
    a view of k wherever its key axes collapse into one."""
    m = _map(k.shape[:-1], batch)
    if m is None:
        k, m = k.expand(*batch, 2), (1, math.prod(batch))
    rows = k.reshape(-1, 2)
    return rows, rows.stride(0), rows.stride(1), *m


def _int(data: int | torch.Tensor, batch: tuple[int, ...], device) -> tuple:
    """An int operand over ``batch``: (tensor or None, value, div, mod,
    int64?); a Python int by value, mod 2^32 as the twin folds it."""
    if not isinstance(data, torch.Tensor):
        return None, int(data) & rng.MASK32, 1, 1, 1
    if data.dtype not in (torch.int64, torch.int32):
        data = data.to(torch.int64)
    data, div, mod = _operand(data.to(device), batch)
    return data, 0, div, mod, int(data.dtype == torch.int64)


def _float(v: float | torch.Tensor, out: tuple[int, ...], device) -> tuple:
    """A float operand over ``out``: (tensor or None, value, div, mod)."""
    if not isinstance(v, torch.Tensor):
        return None, float(v), 1, 1
    v, div, mod = _operand(v.to(device=device, dtype=torch.float32), out)
    return v, 0.0, div, mod


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _launch(wrapper, mode: int, k: torch.Tensor, batch: tuple[int, ...],
            out: torch.Tensor, total: int, n: int = 1, offset: int = 0,
            data0: tuple = _NO_INT, data1: tuple = _NO_INT, folds: int = 1,
            lo: tuple = _ZERO, hi: tuple = _ONE, clamp: bool = True
            ) -> torch.Tensor:
    """One launch of ``mode`` over ``total`` outputs into ``out``; none
    where there are none. A uniform draw's bounds default to [0, 1), which
    give u itself."""
    if total == 0:
        return out
    keys, row, word, kdiv, kmod = _keys(k, batch)
    rc = _build.load().cudasbmp_threefry(
        _index(k.device), mode, keys.data_ptr(), row, word, kdiv, kmod,
        _ptr(data0[0]), *data0[1:], _ptr(data1[0]), *data1[1:], folds,
        _ptr(lo[0]), *lo[1:], _ptr(hi[0]), *hi[1:], int(clamp), n, offset, total,
        out.data_ptr(), torch.cuda.current_stream(k.device).cuda_stream)
    _raise_on(rc, "threefry_kernel")
    wrapper.launches += 1
    return out


def _check_keys(k: torch.Tensor) -> torch.Size:
    """The key batch of k[..., 2], int64 words; raise for anything else."""
    if k.dtype != torch.int64 or k.dim() == 0 or k.shape[-1] != 2:
        raise ValueError(f"keys: expected int64 [..., 2], got {k.dtype} {tuple(k.shape)}")
    return k.shape[:-1]


def fold_in_cuda(k: torch.Tensor, data: int | torch.Tensor) -> torch.Tensor:
    """``rng.fold_in`` on the card: [..., 2] over the broadcast of the key
    batch and ``data``."""
    batch = tuple(_check_keys(k))
    if isinstance(data, torch.Tensor):
        batch = _broadcast(batch, data.shape)
    out = torch.empty((*batch, 2), dtype=torch.int64, device=k.device)
    return _launch(fold_in_cuda, FOLD_IN, k, batch, out, math.prod(batch),
                   data0=_int(data, batch, k.device))


def split_cuda(k: torch.Tensor, num: int = 2, offset: int = 0) -> torch.Tensor:
    """``rng.split`` on the card: [..., num, 2]."""
    batch = tuple(_check_keys(k))
    out = torch.empty((*batch, num, 2), dtype=torch.int64, device=k.device)
    return _launch(split_cuda, SPLIT, k, batch, out, math.prod(batch) * num,
                   n=num, offset=offset)


def random_bits_cuda(k: torch.Tensor, shape: tuple[int, ...], offset: int = 0
                     ) -> torch.Tensor:
    """``rng.random_bits`` on the card: int64 [..., *shape]."""
    batch = tuple(_check_keys(k))
    out = torch.empty((*batch, *shape), dtype=torch.int64, device=k.device)
    n = math.prod(shape)
    return _launch(random_bits_cuda, RANDOM_BITS, k, batch, out,
                   math.prod(batch) * n, n=n, offset=offset)


def _uniform(wrapper, k: torch.Tensor, shape: tuple[int, ...], minval, maxval,
             offset: int, clamp: bool) -> torch.Tensor:
    """f32 [..., *shape]: ``max(minval, u * (maxval - minval) + minval)``
    with ``clamp``, else ``minval + u * (maxval - minval)``; bounds that
    widen the draw past [..., *shape] raise."""
    batch = tuple(_check_keys(k))
    draw = (*batch, *shape)
    lo_shape = minval.shape if isinstance(minval, torch.Tensor) else ()
    hi_shape = maxval.shape if isinstance(maxval, torch.Tensor) else ()
    if _broadcast(draw, lo_shape, hi_shape) != draw:
        raise ValueError(f"uniform: bounds {tuple(lo_shape)} and {tuple(hi_shape)} widen "
                         f"the draw {draw}")
    out = torch.empty(draw, dtype=torch.float32, device=k.device)
    n = math.prod(shape)
    return _launch(wrapper, UNIFORM, k, batch, out, math.prod(draw), n=n,
                   offset=offset, lo=_float(minval, draw, k.device),
                   hi=_float(maxval, draw, k.device), clamp=clamp)


def uniform_cuda(k: torch.Tensor, shape: tuple[int, ...],
                 minval: float | torch.Tensor = 0.0,
                 maxval: float | torch.Tensor = 1.0, offset: int = 0) -> torch.Tensor:
    """``rng.uniform`` on the card."""
    return _uniform(uniform_cuda, k, tuple(shape), minval, maxval, offset, True)


def scaled_uniform_cuda(k: torch.Tensor, shape: tuple[int, ...],
                        lo: float | torch.Tensor, hi: float | torch.Tensor,
                        offset: int = 0) -> torch.Tensor:
    """``rng.scaled_uniform`` on the card."""
    return _uniform(scaled_uniform_cuda, k, tuple(shape), lo, hi, offset, False)


def wave_keys_cuda(k: torch.Tensor, itr: int | torch.Tensor, wave: int | torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """``rng.wave_keys`` on the card: (k_ctrl, k_accept), each [..., 2] and
    contiguous (one [2, ..., 2] output)."""
    batch = tuple(_check_keys(k))
    for d in (itr, wave):
        if isinstance(d, torch.Tensor):
            batch = _broadcast(batch, d.shape)
    folds = 2 if isinstance(wave, torch.Tensor) or wave > 0 else 1
    out = torch.empty((2, *batch, 2), dtype=torch.int64, device=k.device)
    _launch(wave_keys_cuda, WAVE_KEYS, k, batch, out, math.prod(batch),
            data0=_int(itr, batch, k.device), data1=_int(wave, batch, k.device),
            folds=folds)
    return out[0], out[1]


WRAPPERS = (fold_in_cuda, split_cuda, random_bits_cuda, uniform_cuda,
            scaled_uniform_cuda, wave_keys_cuda)
for _wrapper in WRAPPERS:
    _wrapper.launches = 0


def reset_launch_counts() -> None:
    for wrapper in WRAPPERS:
        wrapper.launches = 0
