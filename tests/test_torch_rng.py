"""cudasbmp_torch.rng: threefry bit for bit against jax.random (jax with
jax_threefry_partitionable=True), and Philox-4x32-10 against the Random123
known-answer vectors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudasbmp_torch import rng
from cudasbmp_torch.systems.base import ControlSpec as TSpec
from cudasbmp_tpu.systems.base import ControlSpec as JSpec

torch.set_num_threads(2)
SEEDS = list(range(48)) + [1234, 99991, 2**31 - 2, 2**31 - 1]
DATA = (0, 1, 2, 7, 255, 65536, 123456789, 2**31 - 1)
R = 2048


def _kd(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k))


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint32)


def test_partitionable_threefry_is_on():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_bitwise(seed):
    jk, tk = jax.random.key(seed), rng.key(seed)
    np.testing.assert_array_equal(_kd(jk), tk.numpy())
    for d in DATA:
        np.testing.assert_array_equal(_kd(jax.random.fold_in(jk, d)),
                                      rng.fold_in(tk, d).numpy())
    for num in (2, 3):
        np.testing.assert_array_equal(_kd(jax.random.split(jk, num)),
                                      rng.split(tk, num).numpy())


@pytest.mark.parametrize("seed", SEEDS[:12])
def test_uniform_bitwise(seed):
    jk, tk = jax.random.key(seed), rng.key(seed)
    for shape in ((R, 3), (R,), (5, 7, 2)):
        np.testing.assert_array_equal(
            _bits(jax.random.uniform(jk, shape)),
            _bits(rng.uniform(tk, shape).numpy()))


def test_key_data_round_trip():
    for seed in SEEDS:
        kd = _kd(jax.random.fold_in(jax.random.key(seed), seed))
        t = torch.tensor(kd.astype(np.int64))
        back = jax.random.wrap_key_data(jnp.asarray(t.numpy().astype(np.uint32)))
        np.testing.assert_array_equal(_kd(back), kd)
        np.testing.assert_array_equal(
            _bits(jax.random.uniform(back, (64,))),
            _bits(rng.uniform(t, (64,)).numpy()))


def test_control_sampling_bitwise_eager():
    """ControlSpec.sample (lo + u*(hi - lo)) evaluated op by op is bitwise
    equal. The JITTED JAX draw is not: XLA:CPU fuses and contracts the
    multiply-add, which moves a share of the controls by about 1 ulp
    (measured here). The port is therefore held bitwise against the JAX
    functions evaluated op by op."""
    spec = dict(lo=(-5.0, -np.pi, 0.05), hi=(5.0, np.pi, 1.05))
    js, ts = JSpec(**spec), TSpec(**spec)
    for seed in SEEDS[:16]:
        jc = _bits(js.sample(jax.random.key(seed), (R,)))
        tc = _bits(ts.sample(rng.key(seed), (R,)).numpy())
        np.testing.assert_array_equal(jc, tc)
    jitted = np.asarray(jax.jit(lambda k: js.sample(k, (R,)))(jax.random.key(0)))
    eager = ts.sample(rng.key(0), (R,)).numpy()
    assert (jitted != eager).mean() < 1.0  # about half, on CPUs with FMA
    np.testing.assert_allclose(jitted, eager, rtol=2.5e-7, atol=1e-6)


def test_philox_known_answers():
    """Random123 kat_vectors for philox4x32_10."""
    def run(ctr, key):
        c = tuple(torch.tensor([v], dtype=torch.int64) for v in ctr)
        out = rng.philox4x32(c, torch.tensor(key[0]), torch.tensor(key[1]))
        return [int(o) for o in out]

    assert run((0, 0, 0, 0), (0, 0)) == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C,
                                         0x9B00DBD8]
    m = 0xFFFFFFFF
    assert run((m, m, m, m), (m, m)) == [0x408F276D, 0x41C83B0E, 0xA20BC7C6,
                                         0x6D5451FD]
    assert run((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
               (0xA4093822, 0x299F31D0)) == [0xD16CFE09, 0x94FDCCEB,
                                             0x5001E420, 0x24126EA1]


def test_philox_uniform_lanes():
    k = rng.key(5)
    u = rng.philox_uniform_lanes(k, 4096, 3)
    assert u.dtype == torch.float32 and u.shape == (4096, 3)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert torch.equal(u, rng.philox_uniform_lanes(k, 4096, 3))
    assert torch.equal(u[:100], rng.philox_uniform_lanes(k, 100, 3))
    with pytest.raises(ValueError):
        rng.philox_uniform_lanes(k, 8, 5)


RANGES = ((0, 1), (0, 5), (3, 9), (-7, 100), (5, 5), (9, 3), (0, 65535), (0, 65536),
          (0, 65537), (-1000, 2**30 + 12345), (0, 2**31 - 1), (-2**31, 2**31 - 1))


@pytest.mark.parametrize("seed", SEEDS[:16])
def test_randint_bitwise(seed):
    """jax.random.randint's two draws and span arithmetic, at spans on both
    sides of 2^16 (where its multiplier wraps to 0), empty and reversed
    ranges and the whole int32 range."""
    jk, tk = jax.random.key(seed), rng.key(seed)
    for lo, hi in RANGES:
        for shape in ((), (33,), (4, 5)):
            want = np.asarray(jax.random.randint(jk, shape, lo, hi))
            got = rng.randint(tk, shape, lo, hi)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)


def test_randint_dynamic_ranges_under_batched_keys():
    """The shortcut's draws: a batch of keys with per-key tensor bounds, j's
    range depending on the drawn i, as vmap of jax.random.randint gives."""
    B = 64
    n_edges = np.random.default_rng(0).integers(0, 200, B).astype(np.int32)
    jkeys = jax.vmap(lambda b: jax.random.fold_in(jax.random.key(9), b))(jnp.arange(B))
    tkeys = rng.fold_in(rng.key(9), torch.arange(B))
    np.testing.assert_array_equal(_kd(jkeys), tkeys.numpy())

    def draw(k, n):
        ki, kj = jax.random.split(k)
        i = jax.random.randint(ki, (), 0, jnp.maximum(n - 1, 1))
        return i, jax.random.randint(kj, (), i + 2, jnp.maximum(n + 1, i + 3))

    wi, wj = jax.vmap(draw)(jkeys, jnp.asarray(n_edges))
    n = torch.as_tensor(n_edges, dtype=torch.int64)
    ki, kj = rng.split(tkeys).unbind(-2)
    gi = rng.randint(ki, (), 0, torch.clamp(n - 1, min=1))
    gj = rng.randint(kj, (), gi.long() + 2, torch.maximum(n + 1, gi.long() + 3))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gj.numpy(), np.asarray(wj))
    big = rng.randint(tkeys, (7,), torch.zeros(B, 1, dtype=torch.int64), 2**31 - 1)
    want = jax.vmap(lambda k: jax.random.randint(k, (7,), 0, 2**31 - 1))(jkeys)
    np.testing.assert_array_equal(big.numpy(), np.asarray(want))
