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
import re
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
CHAINS_CU = (Path(cc.__file__).resolve().parents[1] / "csrc" / "chains.cu").read_text()


def _constant(name: str) -> int:
    """A ``constexpr int`` of csrc/chains.cu, as the kernels are built."""
    return int(re.search(rf"constexpr int {name} = (\d+);", CHAINS_CU)[1])


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


def chain_elements(n: int, grid: int, threads: int, elems: int) -> list[list[int]]:
    """csrc/chains.cu::trans_chain_kernel's walk (P1b) in Python: the
    elements each thread chains, in order. Thread t of T = grid x threads
    takes e0 + k * T for k < elems below n, for e0 = t, t + T * elems, ..."""
    T = grid * threads
    return [[e0 + k * T for e0 in range(t, n, T * elems) for k in range(elems)
             if e0 + k * T < n] for t in range(T)]


def alu_elements(n: int, grid: int, threads: int, elems: int) -> list[list[list[int]]]:
    """csrc/chains.cu::alu_chain_kernel's walk (P1a) in Python: for each
    thread, the elements it chains together in each of its rounds. Block b
    takes the tiles of threads x elems contiguous elements at b, b + grid,
    ...; thread t of a tile at ``base`` takes base + t + k * threads below
    n, k < elems."""
    tile = threads * elems
    return [[[base + t + k * threads for k in range(elems) if base + t + k * threads < n]
             for base in range(b * tile, n, grid * tile) if base + t < n]
            for b in range(grid) for t in range(threads)]


@pytest.mark.parametrize("kernel", ["trans", "alu"])
@pytest.mark.parametrize("sm_count,blocks_per_sm", [(132, 8), (4, 1), (3, 2)])
@pytest.mark.parametrize("program_rows,programs", [(3, 5), (8, 2), (37, 7), (256, 8)])
def test_trans_plan_walks_each_element_once(sm_count, blocks_per_sm, program_rows,
                                            programs, kernel):
    """The P1 launch plan (P1b's walk with k = kTransElems, P1a's tiles
    with kAluElems): a grid of at most the card's resident blocks (fewer
    where n needs fewer), k elements a thread, a grid-stride walk; every
    element is chained by exactly one thread, in order, for n a multiple
    of the program (rows x 128): at 5 programs of 3 rows and 7 of 37
    (chip_smoke.py's ragged P1a input) not a multiple of k x threads, at 2
    x 8 and 8 x 256 rows one."""
    threads = _constant("kThreads")
    elems = _constant("kTransElems" if kernel == "trans" else "kAluElems")
    n = programs * program_rows * LANES
    grid = cc.chain_plan(n, sm_count, blocks_per_sm, threads, elems)
    assert 1 <= grid <= sm_count * blocks_per_sm
    assert grid * threads * elems >= n or grid == sm_count * blocks_per_sm
    if kernel == "trans":
        walk = chain_elements(n, grid, threads, elems)
    else:
        walk = [[e for r in rounds for e in r] for rounds in alu_elements(n, grid, threads, elems)]
    assert sorted(e for mine in walk for e in mine) == list(range(n))
    assert all(mine == sorted(mine) for mine in walk)
    # the calibration shape on an H100 at 8 blocks an SM: one round, k a thread
    assert cc.chain_plan(2048 * 128, 132, 8, threads, elems) == 2048 * 128 // (threads * elems)
    assert cc.chain_plan(5 * 3 * LANES, 132, 8, threads, elems) == -(-15 * LANES // (threads * elems))


@pytest.mark.parametrize("program_rows,programs,shared", [(256, 8, "all"), (37, 7, "some"),
                                                          (8, 2, "all"), (3, 5, "none")])
def test_alu_elements_share_m_within_a_program(program_rows, programs, shared):
    """P1a's one m register for a round: the kernel takes it where the
    round's first and last elements lie in one program, so all of them do
    and m is each element's own (x0 * 1e-9 + 0.999931 of its program's
    first element); at the calibration's programs of 32,768 elements every
    round shares it, at chip_smoke.py's ragged programs of 37 rows some do
    not and keep an m each, and at programs of 3 rows, shorter than a
    round's span, none does."""
    threads, elems = _constant("kThreads"), _constant("kAluElems")
    n, program = programs * program_rows * LANES, program_rows * LANES
    grid = cc.chain_plan(n, 132, 8, threads, elems)
    rounds = [r for mine in alu_elements(n, grid, threads, elems) for r in mine]
    one = [r[0] // program == r[-1] // program for r in rounds]
    assert all(len({e // program for e in r}) == 1 for r, o in zip(rounds, one) if o)
    assert {"all": all(one), "some": any(one) and not all(one),
            "none": not any(one)}[shared]


def test_gather_constants_match_the_kernel():
    """The wrapper's model of P2's slice is the kernel's: its columns, its
    step of consecutive rows and the mbarrier's bytes before it."""
    assert (cc.SLICE_LANES, cc.GATHER_UNROLL, cc.GATHER_HEADER) == (
        _constant("kSliceLanes"), _constant("kGatherUnroll"), _constant("kGatherHeader"))
    assert _constant("kGatherRowsPerBlock") % _constant("kGatherChains") == 0


def gather_rows(n_rows: int, blocks_y: int) -> list[tuple[int, int]]:
    """csrc/chains.cu::gather_chain_kernel's rows and lanes in Python:
    the (row, lane) every chain of every thread of every block computes
    (rows past its block's end compute nothing)."""
    chains = _constant("kGatherChains")
    warps = _constant("kGatherRowsPerBlock") // chains
    slices = LANES // cc.SLICE_LANES
    out = []
    for b in range(slices * blocks_y):
        s = b // slices
        lo, hi = s * n_rows // blocks_y, (s + 1) * n_rows // blocks_y
        assert hi - lo <= warps * chains  # the block's threads hold its rows
        for ty in range(warps):
            for c in range(chains):
                r = lo + ty + c * warps
                if r < hi:
                    out += [(r, (b % slices) * cc.SLICE_LANES + tx)
                            for tx in range(cc.SLICE_LANES)]
    return out


@pytest.mark.parametrize("rows_per_block", [_constant("kGatherRowsPerBlock")])
@pytest.mark.parametrize("sms,blocks_per_sm", [(132, 1), (132, 2), (132, 4), (3, 1)])
@pytest.mark.parametrize("n_rows", [1, 5, 63, 64, 1003, 2048, 4099])
def test_gather_plan_computes_each_row_and_lane_once(n_rows, sms, blocks_per_sm,
                                                     rows_per_block):
    """P2's plan: enough blocks along the rows to hold n_rows and, where
    there are rows for it, to give every SM its blocks; every (row, lane)
    of idx computed by exactly one chain, at ragged n_rows too."""
    optin = 232_448  # an H100's 227 KB
    blocks_y = cc.gather_plan(n_rows, 1024, sms, blocks_per_sm, rows_per_block, optin)
    slices = LANES // cc.SLICE_LANES
    assert 1 <= blocks_y <= n_rows
    assert blocks_y >= min(n_rows, -(-sms * blocks_per_sm // slices))
    done = gather_rows(n_rows, blocks_y)
    assert len(done) == len(set(done)) == n_rows * LANES
    assert set(done) == {(r, l) for r in range(n_rows) for l in range(LANES)}
    # the calibration's 2,048 rows on an H100 at 1,024 table rows (one
    # block an SM): 33 blocks a slice, 132 in all, not 128
    assert cc.gather_plan(2048, 1024, 132, 1, rows_per_block, optin) == 33


def test_gather_slice_fits_one_block_for_every_rows_accepted():
    """Every table size the plan accepts puts its slice (and the
    mbarrier) within one block's 227 KB on an H100; one row more raises."""
    optin = 232_448
    top = cc.gather_max_rows(optin)
    assert top == 1808
    for rows in range(1, top + 1):
        assert cc.gather_slice_bytes(rows) <= optin
        cc.gather_plan(2048, rows, 132, 1, 64, optin)
    assert cc.gather_slice_bytes(top + 1) > optin
    for rows in (0, top + 1, 4096):
        with pytest.raises(ValueError, match="rows"):
            cc.gather_plan(2048, rows, 132, 1, 64, optin)


def gather_link_rows(v: int, rows: int, chain: int) -> list[int]:
    """csrc/chains.cu::gather_chain_kernel's index steps for one chain
    from idx value v, in Python: the table row of each link, in order. A
    step reads padded rows j .. j + kGatherUnroll - 1 (padded row p holds
    row p % rows) and moves j on by kGatherUnroll % rows with one wrap;
    the remainder reads the first links of one more step."""
    unroll = _constant("kGatherUnroll")
    r = abs(v) % rows
    j = rows - r if v < 0 and r else r  # C's % has the dividend's sign; then floor
    out, i = [], 0
    while i + unroll <= chain:
        out += [j + u for u in range(unroll)]
        j = j + unroll % rows - rows if j + unroll % rows >= rows else j + unroll % rows
        i += unroll
    out += [j + u for u in range(chain - i)]
    assert all(0 <= p < rows + unroll - 1 for p in out)  # inside the padded slice
    return [p % rows for p in out]


@pytest.mark.parametrize("rows", [1, 3, 8, 128, 1024])
def test_gather_index_model_equals_floor_modulo(rows):
    """The kernel's padded-slice steps give (idx + i) % rows with floor
    modulo for every link, at negative and large idx and at chains of whole
    steps and with a remainder; summed in its order they equal the twin to
    the bit."""
    values = [0, 1, rows - 1, rows, -1, -rows, -rows - 3, 2 ** 31 - 513, -2 ** 31,
              10 ** 9 + 7, -(10 ** 9 + 7)]
    for chain in (0, 1, 7, 8, 9, 17, 512):
        for v in values:
            assert gather_link_rows(v, rows, chain) == [(v + i) % rows for i in range(chain)]
    r = np.random.default_rng(rows)
    tbl = r.uniform(0, 1, (rows, LANES)).astype(np.float32)
    idx = np.array([values[:8]] * 2, dtype=np.int64).repeat(16, 1).astype(np.int32)
    chain = 41
    want = cc.gather_chain_torch(torch.tensor(tbl), torch.tensor(idx), chain).numpy()
    for (a, b), v in np.ndenumerate(idx):
        acc = np.float32(0)
        for row in gather_link_rows(int(v), rows, chain):
            acc = np.float32(acc + tbl[row, b])
        assert acc.view(np.int32) == want[a, b].view(np.int32)


@pytest.mark.parametrize("rows", [1, 8, 1024])
def test_gather_warp_reads_32_banks(rows):
    """A warp's 32 threads read 32 distinct banks of shared memory
    whichever padded rows they are at: the same row for all, or one each."""
    unroll = _constant("kGatherUnroll")
    base = cc.GATHER_HEADER // 4  # the slice's first word

    def banks(js):
        return {(base + j * cc.SLICE_LANES + tx) % 32 for tx, j in enumerate(js)}

    for j in range(rows + unroll - 1):
        assert len(banks([j] * 32)) == 32
    r = np.random.default_rng(rows)
    for _ in range(64):
        assert len(banks(r.integers(0, rows + unroll - 1, 32))) == 32


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
