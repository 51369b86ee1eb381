"""The calibration chains' plain twins (ops/chains_cuda.py: P1a, P1b, P2)
against the TPU kernels they replace, run as Pallas kernels in interpret
mode on the CPU: ``_alu_kernel`` and ``_trans_kernel`` from
tools/roofline.py and ``_gather_kernel`` from tools/r3_probe1.py, each in a
``pallas_call`` of 2 programs of 8 x 128 built here (the tools' own calls
take 8 programs of 256 x 128).

Tolerances, with their reasons:
- ALU chain, rtol 1e-5 at chain 64: the twin rounds y*m and + x apart,
  while XLA may fuse them into one FMA (as the CUDA kernel does);
- cos and sin chains, rtol 1e-5 at chain 64: torch's CPU trig (SLEEF) and
  XLA:CPU's differ by one ulp on a few percent of inputs, and these chains
  do not amplify it;
- tan chain, rtol 1e-5 at chain 2 only: from x in [0.5, 1) the second
  link reaches tan(1.557) = 72.7 and the third 1,353, so each link
  multiplies a one-ulp difference by up to some 5,000 (measured: 7.6e-6
  at 2 links, 2.1e-3 at 3, 6.3e-2 at 4);
- gather chain: exact, integer indices and the same order of adds.
"""

import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cudasbmp_torch.ops import chains_cuda as cc

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import r3_probe1  # noqa: E402
import roofline  # noqa: E402

torch.set_num_threads(2)
ROWS, LANES, PROGRAMS = 8, 128, 2


def _x(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0.5, 1.0, (PROGRAMS * ROWS, LANES)
                                               ).astype(np.float32)


def _pallas_chain(kernel, chain: int, x: np.ndarray) -> np.ndarray:
    spec = pl.BlockSpec((ROWS, LANES), lambda i: (i, 0))
    return np.asarray(pl.pallas_call(
        functools.partial(kernel, chain), grid=(PROGRAMS,), in_specs=[spec],
        out_specs=spec, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True)(jnp.asarray(x)))


def test_alu_chain_twin_matches_the_tpu_kernel():
    x = _x(0)
    # x0 * 1e-9 moves m only for a large x0: the second program's first
    # element sets that program's m, and no other
    x[ROWS, 0] = 2000.0
    want = _pallas_chain(roofline._alu_kernel, 64, x)
    got = cc.alu_chain_cuda(torch.tensor(x), 64, program_rows=ROWS).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # one m per program, from that program's first element
    m0 = np.float32(x[0, 0] * np.float32(1e-9) + np.float32(0.999931))
    m1 = np.float32(x[ROWS, 0] * np.float32(1e-9) + np.float32(0.999931))
    assert m0 != m1
    one = cc.alu_chain_torch(torch.tensor(x), 1, program_rows=ROWS).numpy()
    np.testing.assert_array_equal(one[:ROWS], x[:ROWS] * m0 + x[:ROWS])
    np.testing.assert_array_equal(one[ROWS:], x[ROWS:] * m1 + x[ROWS:])


@pytest.mark.parametrize("op,chain", [("cos", 64), ("sin", 64), ("tan", 2)])
def test_trans_chain_twin_matches_the_tpu_kernel(op, chain):
    x = _x(1)
    kernel = functools.partial(roofline._trans_kernel, getattr(jnp, op))
    want = _pallas_chain(kernel, chain, x)
    got = cc.trans_chain_cuda(torch.tensor(x), chain, op, program_rows=ROWS).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("rows", [8, 128, 1024])
def test_gather_chain_twin_equals_the_tpu_kernel(rows):
    r = np.random.default_rng(rows)
    tbl = r.uniform(0, 1, (rows, LANES)).astype(np.float32)
    idx = r.integers(0, rows, (PROGRAMS * ROWS, LANES)).astype(np.int32)
    chain = 40
    tile = pl.BlockSpec((ROWS, LANES), lambda i: (i, 0))
    want = np.asarray(pl.pallas_call(
        functools.partial(r3_probe1._gather_kernel, chain), grid=(PROGRAMS,),
        in_specs=[pl.BlockSpec((rows, LANES), lambda i: (0, 0)), tile],
        out_specs=tile, out_shape=jax.ShapeDtypeStruct(idx.shape, jnp.float32),
        interpret=True)(jnp.asarray(tbl), jnp.asarray(idx)))
    got = cc.gather_chain_cuda(torch.tensor(tbl), torch.tensor(idx), chain).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def trans_elements(n: int, grid: int, threads: int, elems: int) -> list[list[int]]:
    """csrc/chains.cu::trans_chain_kernel's index walk in Python: the
    elements each thread chains, in order. Thread t of T = grid x threads
    takes e0 + k * T for k < elems below n, for e0 = t, t + T * elems, ..."""
    T = grid * threads
    return [[e0 + k * T for e0 in range(t, n, T * elems) for k in range(elems)
             if e0 + k * T < n] for t in range(T)]


@pytest.mark.parametrize("sm_count,blocks_per_sm", [(132, 8), (4, 1), (3, 2)])
@pytest.mark.parametrize("program_rows,programs", [(3, 5), (8, 2), (256, 8)])
def test_trans_plan_walks_each_element_once(sm_count, blocks_per_sm, program_rows,
                                            programs):
    """P1b's launch plan: a grid of at most the card's resident blocks
    (fewer where n needs fewer), k elements a thread, a grid-stride walk;
    every element is chained by exactly one thread, for n a multiple of
    the program (rows x 128): at 5 programs of 3 rows not a multiple of k x
    threads, at 2 x 8 and 8 x 256 rows one."""
    threads, elems = 256, 2
    n = programs * program_rows * LANES
    grid = cc.trans_plan(n, sm_count, blocks_per_sm, threads, elems)
    assert 1 <= grid <= sm_count * blocks_per_sm
    assert grid * threads * elems >= n or grid == sm_count * blocks_per_sm
    walk = trans_elements(n, grid, threads, elems)
    assert sorted(e for mine in walk for e in mine) == list(range(n))
    assert all(mine == sorted(mine) for mine in walk)
    # the calibration shape on an H100 at 8 blocks an SM: one round, k a thread
    assert cc.trans_plan(2048 * 128, 132, 8, threads, elems) == 512
    assert cc.trans_plan(5 * 3 * LANES, 132, 8, threads, elems) == 4


def test_wrappers_check_their_inputs_and_count_only_launches():
    cc.reset_launch_counts()
    x = torch.tensor(_x(2))
    with pytest.raises(ValueError, match="programs"):
        cc.alu_chain_cuda(x, 4, program_rows=5)
    with pytest.raises(ValueError, match="op"):
        cc.trans_chain_cuda(x, 4, "exp", program_rows=ROWS)
    with pytest.raises(ValueError, match="programs"):
        cc.trans_chain_cuda(x, 4, "cos", program_rows=5)
    with pytest.raises(ValueError, match="chain"):
        cc.trans_chain_cuda(x, -1, "sin", program_rows=ROWS)
    with pytest.raises(ValueError, match="float32"):
        cc.trans_chain_cuda(x.double(), 4, "tan", program_rows=ROWS)
    cc.alu_chain_cuda(x, 4, program_rows=ROWS)  # the CPU twin: no launch
    cc.trans_chain_cuda(x, 4, "cos", program_rows=ROWS)
    cc.gather_chain_cuda(torch.ones(8, LANES), torch.zeros(4, LANES, dtype=torch.int32), 3)
    assert [w.launches for w in cc.WRAPPERS] == [0, 0, 0]


def test_sincos_twin_on_the_cpu():
    """The sincos check kernel's twin is torch.sin and torch.cos (the plain
    rollout twins' calls); on CPU tensors no kernel launches. Against
    jnp.sin/jnp.cos within a few ulps (the two libraries' own roundings)."""
    cc.reset_launch_counts()
    x = np.random.default_rng(5).uniform(-50, 50, 4096).astype(np.float32)
    s, c = cc.sincos_cuda(torch.tensor(x))
    assert torch.equal(s, torch.sin(torch.tensor(x)))
    assert torch.equal(c, torch.cos(torch.tensor(x)))
    np.testing.assert_allclose(s.numpy(), np.asarray(jnp.sin(jnp.asarray(x))), atol=1e-6)
    np.testing.assert_allclose(c.numpy(), np.asarray(jnp.cos(jnp.asarray(x))), atol=1e-6)
    assert cc.sincos_cuda.launches == 0
