"""The threefry kernel's route and wrappers on the CPU (csrc/threefry.cu,
ops/threefry_cuda.py):

- on a CPU key every public ``rng`` function runs its torch twin, bit for
  bit ``jax.random``, and never loads the kernel library;
- the package's library lists the kernel's source and its C entry point;
- the wrappers' operand layout (keys, data and bounds read at (index //
  div) % mod, the keys' row and word strides, the wave keys' two arrays),
  driven through an emulation of the C entry point over host memory, gives
  the twins' bits for every broadcast the planners draw with.

The kernel itself runs only on the card (tests/test_torch_threefry_cuda.py).
"""

import ctypes
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudasbmp_torch import rng
from cudasbmp_torch.ops import _build
from cudasbmp_torch.ops import threefry_cuda as tc
from cudasbmp_torch.systems.base import ControlSpec as TSpec
from cudasbmp_tpu.systems.base import ControlSpec as JSpec

torch.set_num_threads(2)
M32 = rng.MASK32
SPEC = dict(lo=(-5.0, -np.pi, 0.05), hi=(5.0, np.pi, 1.05))


def _kd(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k))


def _u32(a) -> np.ndarray:
    return np.asarray(a).view(np.uint32)


@pytest.fixture
def no_library(monkeypatch):
    """The kernel library's loader raises: a CPU draw must not reach it."""
    def refuse(*a, **k):
        raise AssertionError("a CPU key reached the kernel library")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "_load", refuse)
    monkeypatch.setattr(_build, "build", refuse)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_cpu_keys_run_the_twins_equal_to_jax(no_library, seed):
    jk, tk = jax.random.key(seed), rng.key(seed)
    np.testing.assert_array_equal(_kd(jax.random.fold_in(jk, 123)),
                                  rng.fold_in(tk, 123).numpy())
    np.testing.assert_array_equal(
        _kd(jax.vmap(lambda d: jax.random.fold_in(jk, d))(jnp.arange(5))),
        rng.fold_in(tk, torch.arange(5)).numpy())
    np.testing.assert_array_equal(_kd(jax.random.split(jk, 3)),
                                  rng.split(tk, 3).numpy())
    np.testing.assert_array_equal(_u32(jax.random.bits(jk, (4, 5))),
                                  rng.random_bits(tk, (4, 5)).numpy().astype(np.uint32))
    np.testing.assert_array_equal(_u32(jax.random.uniform(jk, (64, 3))),
                                  _u32(rng.uniform(tk, (64, 3)).numpy()))
    with jax.disable_jit():
        ranged = jax.random.uniform(jk, (64, 2), minval=0.5,
                                    maxval=jnp.asarray([19.5, 14.5], jnp.float32))
    np.testing.assert_array_equal(
        _u32(ranged), _u32(rng.uniform(tk, (64, 2), 0.5, torch.tensor([19.5, 14.5])).numpy()))
    np.testing.assert_array_equal(np.asarray(jax.random.randint(jk, (33,), -7, 100)),
                                  rng.randint(tk, (33,), -7, 100).numpy())
    # the compositions: ControlSpec.sample op by op, and a wave's keys
    np.testing.assert_array_equal(_u32(JSpec(**SPEC).sample(jk, (256,))),
                                  _u32(TSpec(**SPEC).sample(tk, (256,)).numpy()))
    for itr, w in ((4, 0), (4, 3)):
        kw = jax.random.fold_in(jk, itr)
        kw = jax.random.fold_in(kw, w) if w else kw
        want = _kd(jax.random.split(kw))
        got = rng.wave_keys(tk, itr, w)
        np.testing.assert_array_equal(want, torch.stack(got).numpy())


def test_wave_keys_over_a_batch_fold_the_wave_only_where_it_is_above_zero(no_library):
    """The vmapped planner's wave keys: per problem (itr, w), w = 0 taking
    the iteration key itself."""
    B = 6
    keys = rng.fold_in(rng.key(11), torch.arange(B))
    itr = torch.tensor([0, 1, 2, 3, 4, 5])
    w = torch.tensor([0, 2, 0, 1, 0, 7])
    k_ctrl, k_accept = rng.wave_keys(keys, itr, w)
    for b in range(B):
        one = rng.wave_keys(keys[b], int(itr[b]), int(w[b]))
        assert torch.equal(k_ctrl[b], one[0]) and torch.equal(k_accept[b], one[1])


def test_the_library_builds_and_declares_the_kernel():
    assert "threefry.cu" in _build.SOURCES
    assert (_build.CSRC_DIR / "threefry.cu").is_file()
    assert "cudasbmp_threefry" in _build.ENTRY_POINTS
    assert "cudasbmp_threefry" not in _build.USER_ENTRY_POINTS
    sig = _build.SIGNATURES["cudasbmp_threefry"]
    assert len(sig) == 32
    assert sig[0] is ctypes.c_int and sig[-2] is ctypes.c_void_p  # device ... out
    # the 64-bit counter offset and the sizes pass as long long, the bounds as float
    assert sig[27:30] == (ctypes.c_longlong,) * 3
    assert sig[19] is ctypes.c_float and sig[23] is ctypes.c_float


# --- the wrappers' layout, through an emulation of cudasbmp_threefry ------


def _host(ptr: int, count: int, ctype) -> np.ndarray:
    """``count`` elements at host address ``ptr``, as a numpy view."""
    return np.ctypeslib.as_array((ctype * count).from_address(ptr))


def _hash(k0, k1, x0, x1):
    return rng.threefry2x32(k0 & M32, k1 & M32, x0 & M32, x1 & M32)


def emulated_threefry(device, mode, keys, key_row, key_word, key_div, key_mod,
                      d0, v0, div0, mod0, wide0, d1, v1, div1, mod1, wide1, folds,
                      lo, lo_value, lo_div, lo_mod, hi, hi_value, hi_div, hi_mod,
                      clamp, n, offset, total, out, stream):
    """csrc/threefry.cu's entry point, operand by operand, over host memory."""
    if not 0 <= total < 2**31 or not 0 < n < 2**31:
        return 1  # cudaErrorInvalidValue: the kernel indexes in 32 bits
    e = torch.arange(total, dtype=torch.int64)
    words = torch.from_numpy(_host(keys, (key_mod - 1) * key_row + key_word + 1,
                                   ctypes.c_longlong).copy())

    def key(b):
        q = b // key_div % key_mod * key_row
        return words[q], words[q + key_word]

    def ints(ptr, value, div, mod, wide, i):
        if ptr is None:
            return torch.full_like(i, value)
        a = _host(ptr, mod, ctypes.c_longlong if wide else ctypes.c_int)
        return torch.from_numpy(a.astype(np.int64))[i // div % mod]

    def floats(ptr, value, div, mod, i):
        if ptr is None:
            return torch.full(i.shape, value, dtype=torch.float32)
        return torch.from_numpy(_host(ptr, mod, ctypes.c_float).copy())[i // div % mod]

    def fold(k, d):
        return _hash(k[0], k[1], torch.zeros_like(d), d)

    def put_keys(pairs, at):
        view = _host(out, 2 * (at + total), ctypes.c_longlong)
        view[2 * at:] = torch.stack(pairs, -1).reshape(-1).numpy()

    if mode in (tc.FOLD_IN, tc.WAVE_KEYS):
        k = fold(key(e), ints(d0, v0, div0, mod0, wide0, e))
        if mode == tc.FOLD_IN:
            put_keys(k, 0)
            return 0
        if folds == 2:
            w = ints(d1, v1, div1, mod1, wide1, e)
            k = tuple(torch.where(w > 0, a, b) for a, b in zip(fold(k, w), k))
        put_keys(_hash(*k, torch.zeros_like(e), torch.zeros_like(e)), 0)
        put_keys(_hash(*k, torch.zeros_like(e), torch.ones_like(e)), total)
        return 0
    b, c = e // n, offset + e % n
    if mode == tc.SPLIT:
        put_keys(_hash(*key(b), torch.zeros_like(c), c), 0)
        return 0
    x0, x1 = _hash(*key(b), c >> 32, c)
    bits = x0 ^ x1
    if mode == tc.RANDOM_BITS:
        _host(out, total, ctypes.c_longlong)[:] = bits.numpy()
        return 0
    u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo_ = floats(lo, lo_value, lo_div, lo_mod, e)
    hi_ = floats(hi, hi_value, hi_div, hi_mod, e)
    scaled = u * (hi_ - lo_)
    r = torch.maximum(lo_, scaled + lo_) if clamp else lo_ + scaled
    _host(out, total, ctypes.c_float)[:] = r.numpy()
    return 0


@pytest.fixture
def emulated(monkeypatch):
    """The wrappers on host tensors, the C entry point emulated."""
    monkeypatch.setattr(_build, "load",
                        lambda struct=None: SimpleNamespace(cudasbmp_threefry=emulated_threefry))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    tc.reset_launch_counts()


def _keys(*batch: int) -> torch.Tensor:
    n = int(np.prod(batch)) if batch else 1
    return rng.fold_in(rng.key(5), torch.arange(n)).reshape(*batch, 2)


def _same(a, b) -> None:
    for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
        assert x.shape == y.shape and x.dtype == y.dtype
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y)


B, T = 3, 4
FOLD_CASES = {
    "one key, an int": (lambda: _keys(), 7),
    "one key, past 2^32": (lambda: _keys(), 2**40 + 5),
    "batched keys, a negative int": (lambda: _keys(B), -3),
    "one key, data [T]": (lambda: _keys(), torch.arange(T)),
    "keys [B], data [B] int32": (lambda: _keys(B), torch.arange(B, dtype=torch.int32)),
    "keys [B, 1], data [T]": (lambda: _keys(B, 1), torch.arange(T) + 9),
    "keys [B, T], data [T]": (lambda: _keys(B, T), torch.arange(T)),
    "keys [B], a 0-d tensor": (lambda: _keys(B), torch.tensor(12)),
    "keys [B] from an unbind": (lambda: rng.split(_keys(B)).unbind(-2)[1], torch.arange(B)),
    "keys [T, B] transposed": (lambda: _keys(B, T).transpose(0, 1), torch.arange(B)),
    "keys [B, 1, T], data [2, 1]": (lambda: _keys(B, 1, T), torch.arange(2)[:, None]),
}


@pytest.mark.parametrize("case", FOLD_CASES)
def test_fold_in_layouts(emulated, case):
    make, data = FOLD_CASES[case]
    k = make()
    _same(tc.fold_in_cuda(k, data), rng.fold_in_torch(k, data))
    assert tc.fold_in_cuda.launches == 1


@pytest.mark.parametrize("batch, num, offset", [
    ((), 3, 0), ((B,), 2, 5), ((B,), 4, 2**32 + 7), ((B, T), 3, 1), ((B,), 0, 0)])
def test_split_layouts(emulated, batch, num, offset):
    k = _keys(*batch)
    _same(tc.split_cuda(k, num, offset), rng.split_torch(k, num, offset))
    assert tc.split_cuda.launches == int(num > 0)


@pytest.mark.parametrize("batch, shape, offset", [
    ((), (5,), 0), ((B,), (4, 3), 2**32 - 5), ((B, 2), (7,), 3 * 2**32 + 11),
    ((B,), (), 0), ((), (0,), 0)])
def test_random_bits_layouts(emulated, batch, shape, offset):
    k = _keys(*batch)
    _same(tc.random_bits_cuda(k, shape, offset), rng.random_bits_torch(k, shape, offset))


UNIFORM_CASES = {
    "the defaults": ((), (64, 3), 0.0, 1.0, 0),
    "scalars, keys [B]": ((B,), (64,), -2.0, 3.5, 2**32 + 1),
    "bounds [3]": ((B,), (16, 3), torch.tensor([-5.0, -1.0, 0.05]),
                   torch.tensor([5.0, 1.0, 1.05]), 0),
    "max binds (hi below lo)": ((B,), (32, 2), torch.tensor([1.0, 2.0]), -4.0, 0),
    "0-d bounds": ((), (16,), torch.tensor(0.5), torch.tensor(4.0), 0),
    "bounds per key [B, 1, 1]": ((B,), (8, 2), torch.arange(B, dtype=torch.float32)[:, None, None],
                                 10.0, 0),
    "bounds [B, 1, 2] (an inner broadcast)": ((B,), (8, 2), torch.zeros(B, 1, 2),
                                              torch.tensor([[[1.0, 2.0]]]).expand(B, 1, 2), 0),
    "bounds wider than the draw": ((), (5,), torch.zeros(4, 1), 2.0, 0),
}


@pytest.mark.parametrize("case", UNIFORM_CASES)
def test_uniform_layouts(emulated, case):
    batch, shape, lo, hi, offset = UNIFORM_CASES[case]
    k = _keys(*batch)
    if case == "bounds wider than the draw":
        # jax.random.uniform refuses it; the kernel's route raises before a launch
        with pytest.raises(ValueError, match="widen"):
            tc.uniform_cuda(k, shape, lo, hi, offset)
        assert tc.uniform_cuda.launches == 0
        return
    _same(tc.uniform_cuda(k, shape, lo, hi, offset), rng.uniform_torch(k, shape, lo, hi, offset))
    assert tc.uniform_cuda.launches == 1


@pytest.mark.parametrize("batch, offset", [((), 0), ((B,), 3 * 7), ((B, 2), 0)])
def test_scaled_uniform_is_control_sampling(emulated, batch, offset):
    k = _keys(*batch)
    lo, hi = TSpec(**SPEC).bounds(torch.device("cpu"))
    _same(tc.scaled_uniform_cuda(k, (64, 3), lo, hi, offset),
          rng.scaled_uniform_torch(k, (64, 3), lo, hi, offset))


WAVE_CASES = {
    "wave 0": (lambda: _keys(), 3, 0),
    "wave 2": (lambda: _keys(), 3, 2),
    "per problem": (lambda: _keys(B + 2), torch.arange(B + 2), torch.tensor([0, 1, 0, 4, 2])),
    "int32 counters": (lambda: _keys(B), torch.arange(B, dtype=torch.int32),
                       torch.tensor([2, 0, 1], dtype=torch.int32)),
    "keys [B], one wave": (lambda: _keys(B), 5, 1),
}


@pytest.mark.parametrize("case", WAVE_CASES)
def test_wave_keys_layouts(emulated, case):
    make, itr, w = WAVE_CASES[case]
    k = make()
    got = tc.wave_keys_cuda(k, itr, w)
    _same(got, rng.wave_keys_torch(k, itr, w))
    assert all(g.is_contiguous() for g in got)
    assert tc.wave_keys_cuda.launches == 1


@pytest.mark.parametrize("keys", [torch.zeros(4, 2, dtype=torch.int32), torch.zeros(4, 3, dtype=torch.int64),
                                  torch.tensor(5)])
def test_the_wrappers_refuse_what_the_kernel_does_not_read(emulated, keys):
    with pytest.raises(ValueError, match="keys: expected int64"):
        tc.fold_in_cuda(keys, 1)
    assert tc.fold_in_cuda.launches == 0


@pytest.mark.parametrize("shapes", [((), ()), ((3,), ()), ((3, 1), (4,)), ((2, 1, 5), (1, 4, 1), (5,)),
                                    ((0,), (1,)), ((3, 2), (2,), ())])
def test_the_wrappers_broadcast_as_torch_does(shapes):
    assert tc._broadcast(*shapes) == tuple(torch.broadcast_shapes(*shapes))


def test_shapes_that_do_not_broadcast_are_refused():
    with pytest.raises(ValueError, match="do not broadcast"):
        tc._broadcast((3,), (4,))
