"""Counter-based random streams in PyTorch.

Threefry-2x32, bit for bit the stream of ``jax.random`` (jax 0.9 with
``jax_threefry_partitionable=True``, its default), so the port's planner
draws exactly the controls and acceptance numbers of the JAX planner:

- ``key(seed)``           = jax.random.key(seed) key data
- ``fold_in(key, data)``  = jax.random.fold_in
- ``split(key, num)``     = jax.random.split (the fold-like partitionable form)
- ``random_bits``         = 32-bit jax.random.bits
- ``uniform``             = jax.random.uniform (f32, with its ``minval`` and
  ``maxval``, as op-by-op JAX rounds them)
- ``randint``             = jax.random.randint (int32, ``minval`` and
  ``maxval`` scalars or tensors)

and Philox-4x32-10 (Random123), the generator the ``cuda_rng`` rollout kernel
draws its controls from; ``philox4x32`` here is that kernel's plain twin.

A key is an int64 tensor of shape [..., 2] holding the two uint32 words of
the JAX key data; a batch of keys ([B, 2]) gives what ``jax.vmap`` of the
same function over [B] keys gives, with the batch shape leading. torch has
no full uint32 arithmetic, so every word is carried in int64 and masked to
32 bits after each add, multiply or shift. Every function runs on the device
of the key it is given, and a Python number becomes a tensor there by a
fill, not by a copy from the host, so no function here waits for the card.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK32


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of counter words (x0, x1) under key
    words (k0, k1); all int64 holding uint32, broadcastable."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def key(seed: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """Key data of ``jax.random.key(seed)`` for a 32-bit seed: the words
    (0, seed mod 2^32)."""
    if not -2**31 <= seed < 2**32:
        raise ValueError(f"seed {seed} does not fit 32 bits")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64, device=device)


def _on(value: float | int | torch.Tensor, dtype: torch.dtype,
        device: torch.device) -> torch.Tensor:
    """``value`` as a ``dtype`` tensor on ``device``: a tensor is cast, a
    Python number filled in place (``torch.tensor(x, device='cuda')`` copies
    from pageable host memory, which waits for the stream)."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype)
    return torch.full((), value, dtype=dtype, device=device)


def fold_in(k: torch.Tensor, data: int | torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the counter (0, data mod 2^32).
    ``data`` broadcasts against the key batch; returns [..., 2]."""
    d = _on(data, torch.int64, k.device) & MASK32
    a, b = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([a, b], dim=-1)


def split(k: torch.Tensor, num: int = 2, offset: int = 0) -> torch.Tensor:
    """``jax.random.split``: key i is the hash of the counter (0, i);
    returns [..., num, 2]. ``offset`` gives keys [offset, offset + num) of a
    larger split (a rank's share of a batch's keys)."""
    i = torch.arange(offset, offset + num, dtype=torch.int64, device=k.device)
    a, b = threefry2x32(k[..., 0, None], k[..., 1, None], torch.zeros_like(i), i)
    return torch.stack([a, b], dim=-1)


def random_bits(k: torch.Tensor, shape: tuple[int, ...], offset: int = 0) -> torch.Tensor:
    """32-bit ``jax.random.bits``: element i (row-major) is the xor of the two
    hash words of the counter (i >> 32, i mod 2^32); returns
    [..., *shape] for keys [..., 2]. ``offset`` gives the elements from
    ``offset`` on of a larger draw (a rank's rows of a batch's draw)."""
    n = 1
    for s in shape:
        n *= s
    i = torch.arange(offset, offset + n, dtype=torch.int64, device=k.device)
    a, b = threefry2x32(k[..., 0, None], k[..., 1, None], i >> 32, i & MASK32)
    return (a ^ b).reshape((*k.shape[:-1], *shape))


def uniform(k: torch.Tensor, shape: tuple[int, ...],
            minval: float | torch.Tensor = 0.0,
            maxval: float | torch.Tensor = 1.0, offset: int = 0) -> torch.Tensor:
    """f32 ``jax.random.uniform``: 23 random mantissa bits under exponent 0
    give [1, 2), minus 1, then ``max(minval, u * (maxval - minval) +
    minval)`` with each operation rounded once, as JAX computes it op by op
    (jitted on XLA:CPU the multiply-add may become one FMA). ``minval`` and
    ``maxval`` broadcast against ``shape`` from the right. At the defaults
    the scaling is exact and the result is u. Returns [..., *shape];
    ``offset`` as ``random_bits``'s."""
    bits = (random_bits(k, shape, offset) >> 9) | 0x3F800000
    u = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = _on(minval, torch.float32, k.device)
    hi = _on(maxval, torch.float32, k.device)
    return torch.maximum(lo, u * (hi - lo) + lo)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a uint32 bit pattern -> the int32 value it means."""
    return torch.where(x >= 2**31, x - 2**32, x)


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod 2^32 for uint32 values held in int64, with b split into
    16-bit halves so no product leaves int64."""
    return (a * (b & 0xFFFF) + ((a * (b >> 16)) & 0xFFFF) * 65536) & MASK32


def randint(k: torch.Tensor, shape: tuple[int, ...],
            minval: int | torch.Tensor, maxval: int | torch.Tensor) -> torch.Tensor:
    """int32 ``jax.random.randint``: two 32-bit draws under ``split(k)``'s
    keys, ``hi`` and ``lo``, give ``((hi % span) * m + lo % span) % span``
    in uint32 arithmetic, with ``span = maxval - minval`` (1 where maxval <=
    minval) and ``m = (2^16 % span)^2 % span`` (the square wraps at 2^32,
    so m is 0 for spans past 2^16), added to ``minval``: not a plain modulo
    of one draw. ``minval`` and ``maxval`` (int32 values)
    broadcast against [..., *shape] for keys [..., 2], as ``fold_in``'s
    data does against the keys. Returns int32 [..., *shape]."""
    lo_v = _on(minval, torch.int64, k.device)
    hi_v = _on(maxval, torch.int64, k.device)
    k1, k2 = split(k).unbind(-2)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = torch.where(hi_v <= lo_v, 1, (hi_v - lo_v) & MASK32)
    mult = _mul32(2**16 % span, 2**16 % span) % span
    offset = (_mul32(higher % span, mult) + lower % span) & MASK32
    return _wrap32((lo_v + offset % span) & MASK32).to(torch.int32)


# ---------------------------------------------------------------------------
# Philox-4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3")
# ---------------------------------------------------------------------------

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of the 64-bit product a*b, with b split into
    16-bit halves so no intermediate leaves int64."""
    t_hi = (b >> 16) * a  # < 2^48
    t_lo = (b & 0xFFFF) * a  # < 2^48
    lo = (((t_hi & 0xFFFF) << 16) + t_lo) & MASK32
    hi = (t_hi + (t_lo >> 16)) >> 16
    return hi, lo


def philox4x32(counter: tuple[torch.Tensor, ...],
               k0: torch.Tensor, k1: torch.Tensor) -> list[torch.Tensor]:
    """Philox-4x32 with 10 rounds: four int64-held uint32 counter words and
    two key words -> four output words (broadcast shapes)."""
    c = list(counter)
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c[0])
        hi1, lo1 = _mulhilo(PHILOX_M1, c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return c


def philox_uniform_lanes(k: torch.Tensor, n: int, words: int,
                         lane0: int = 0) -> torch.Tensor:
    """The ``cuda_rng`` kernels' stream: lane i hashes the counter
    (i, 0, 0, 0) under key words (k[..., 0], k[..., 1]); word j becomes
    u = (bits >> 8) * 2^-24 in [0, 1). Returns f32 [..., n, words] for keys
    [..., 2], words <= 4: a batch of keys gives each problem its own
    stream, as the batched kernel draws it. ``lane0`` gives lanes [lane0,
    lane0 + n) of a larger launch."""
    if not 1 <= words <= 4:
        raise ValueError("Philox-4x32 gives at most 4 words per lane")
    lane = torch.arange(lane0, lane0 + n, dtype=torch.int64, device=k.device)
    zero = torch.zeros_like(lane)
    out = philox4x32((lane, zero, zero, zero), k[..., 0, None], k[..., 1, None])
    top24 = torch.stack(out[:words], dim=-1) >> 8
    return top24.to(torch.float32) * (1.0 / (1 << 24))
