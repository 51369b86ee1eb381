"""Batched keys in cudasbmp_torch.rng: ``fold_in``, ``split``,
``random_bits`` and ``uniform`` on keys [B, 2] against ``jax.vmap`` of the
JAX functions over [B] keys, and the ranged ``uniform`` against
``jax.random.uniform(minval=, maxval=)`` run op by op (jax.disable_jit),
all bit for bit; the batched Philox lanes equal one draw per key."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudasbmp_torch import rng

torch.set_num_threads(2)
SEEDS = (0, 1, 7, 2**31 - 1)


def _kd(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k))


def _keys(seed: int, n: int):
    """n JAX keys and their key data as a port key batch."""
    jk = jax.random.split(jax.random.key(seed), n)
    return jk, torch.tensor(_kd(jk).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_and_split_over_a_key_batch(seed):
    jk, tk = _keys(seed, 6)
    data = np.array([0, 1, 5, 255, 2**31 - 1, 123456], np.int32)
    want = _kd(jax.vmap(jax.random.fold_in)(jk, jnp.asarray(data)))
    np.testing.assert_array_equal(rng.fold_in(tk, torch.tensor(data)).numpy(), want)
    want = _kd(jax.vmap(lambda k: jax.random.fold_in(k, 3))(jk))
    np.testing.assert_array_equal(rng.fold_in(tk, 3).numpy(), want)
    for num in (2, 3):
        want = _kd(jax.vmap(lambda k: jax.random.split(k, num))(jk))
        got = rng.split(tk, num)
        assert got.shape == (6, num, 2)
        np.testing.assert_array_equal(got.numpy(), want)
    # one key, a batch of data: vmap over the data only
    k0 = jax.random.key(seed)
    want = _kd(jax.vmap(lambda d: jax.random.fold_in(k0, d))(jnp.asarray(data)))
    np.testing.assert_array_equal(
        rng.fold_in(rng.key(seed), torch.tensor(data)).numpy(), want)


@pytest.mark.parametrize("shape", [(5,), (4, 3), (32, 2)])
def test_bits_and_uniform_over_a_key_batch(shape):
    jk, tk = _keys(11, 4)
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, shape))(jk))
    np.testing.assert_array_equal(rng.random_bits(tk, shape).numpy().astype(np.uint32),
                                  want)
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape))(jk))
    got = rng.uniform(tk, shape).numpy()
    assert got.shape == (4, *shape)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("minval,maxval", [
    (0.0, (19.5, 19.5)), (0.5, 4.0), (0.5, (19.5, 14.5)), (-3.0, 2.0)])
def test_ranged_uniform_bitwise_against_op_by_op_jax(minval, maxval):
    jk, tk = _keys(3, 16)
    jmax = jnp.asarray(maxval, jnp.float32)
    with jax.disable_jit():
        want = np.asarray(jax.vmap(
            lambda k: jax.random.uniform(k, (8, 2), minval=minval, maxval=jmax))(jk))
    got = rng.uniform(tk, (8, 2), minval, torch.tensor(maxval, dtype=torch.float32))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    # the same for one key
    with jax.disable_jit():
        one = np.asarray(jax.random.uniform(jax.random.key(4), (64, 2),
                                            minval=minval, maxval=jmax))
    got1 = rng.uniform(rng.key(4), (64, 2), minval, torch.tensor(maxval))
    np.testing.assert_array_equal(got1.numpy().view(np.uint32), one.view(np.uint32))


def test_ranged_uniform_against_the_jitted_draw_differs_by_at_most_an_ulp():
    """Jitted on XLA:CPU the multiply-add may be one FMA: count how many
    coordinates move, and by how much (the record the ROADMAP asks for)."""
    k = jax.random.key(21)
    jmax = jnp.asarray([19.5, 19.5], jnp.float32)
    jitted = np.asarray(jax.jit(
        lambda kk: jax.random.uniform(kk, (4096, 2), minval=0.5, maxval=jmax))(k))
    got = rng.uniform(rng.key(21), (4096, 2), 0.5, torch.tensor([19.5, 19.5])).numpy()
    ulps = np.abs(got.view(np.int32).astype(np.int64) - jitted.view(np.int32))
    assert ulps.max() <= 1
    assert ulps.mean() < 0.5  # most coordinates agree to the bit


def test_default_uniform_is_the_unscaled_draw():
    k = rng.key(9)
    u = rng.uniform(k, (1000,))
    v = rng.uniform(k, (1000,), torch.tensor(0.0), torch.tensor(1.0))
    assert torch.equal(u, v) and float(u.min()) >= 0.0 and float(u.max()) < 1.0


def test_philox_lanes_over_a_key_batch_equal_one_draw_per_key():
    keys = torch.tensor([[0, 1], [7, 2**32 - 1], [123, 456]], dtype=torch.int64)
    got = rng.philox_uniform_lanes(keys, 37, 3)
    assert got.shape == (3, 37, 3)
    for b in range(3):
        assert torch.equal(got[b], rng.philox_uniform_lanes(keys[b], 37, 3))
    # a problem's draws do not depend on how many lanes the others have
    assert torch.equal(rng.philox_uniform_lanes(keys, 5, 3), got[:, :5])
