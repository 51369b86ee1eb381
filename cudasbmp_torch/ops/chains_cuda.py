"""Wrappers of the calibration chains (csrc/chains.cu), which replace the TPU
probes of tools/roofline.py and tools/r3_probe1.py, and their plain twins:

- ``alu_chain_cuda`` (P1a, ``_alu_kernel``): y <- y*m + x, ``chain`` times,
  one FMA a link, with m = x0*1e-9 + 0.999931 and x0 the first element of
  the element's program (``program_rows`` rows of x; 256 on the TPU);
- ``trans_chain_cuda`` (P1b, ``_trans_kernel``): y <- op(y) + eps for op in
  ``TRANS_OPS``, with eps = x0*1e-12 per program;
- ``gather_chain_cuda`` (P2, ``_gather_kernel``): y <- y + tbl[(idx + i) %
  rows, lane] for i < chain from y = 0, tbl [rows, 128], idx int32 [N, 128],
  its rows split evenly over enough blocks to fill the card
  (``gather_plan``, from ``gather_geometry``).

P1a and P1b run on a grid of at most the card's resident blocks
(``chain_plan``, from ``chain_geometry``), a few elements a thread.

``sincos_cuda`` is no TPU kernel's port: sincosf, as the rollout kernels
take a heading's cosine and sine, held against ``torch.sin`` and
``torch.cos`` over every float by ``sincos_differences``.

``alu_chain_torch``, ``trans_chain_torch``, ``gather_chain_torch`` and
``sincos_torch`` are their plain twins. The ALU twin rounds the multiply and the add apart (the
kernel fuses them, as jitted XLA does), so the two agree within rounding;
the gather twin adds in the kernel's order, to the bit. One rule for every
wrapper: tensors on the CPU go through the plain twin; CUDA tensors launch
the kernel or raise. Each wrapper counts its launches in
``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cudasbmp_torch.ops import _build
from cudasbmp_torch.ops.rollout_cuda import (_check, _device_of, _index, _raise_on,
                                             sm_count, smem_optin)

TRANS_OPS = {"cos": 0, "sin": 1, "tan": 2}
CHAIN_KERNELS = {**TRANS_OPS, "alu": 3}  # csrc/chains.cu's ChainKernel
LANES = 128  # the gather table's width (the TPU's lane axis)
# P2's slice (csrc/chains.cu): 32 table columns a block, the links a chain
# reads from consecutive rows in one step (the slice repeats that many rows
# less one after its last), and the mbarrier's 16 bytes before the slice
SLICE_LANES, GATHER_UNROLL, GATHER_HEADER = 32, 8, 16


def _per_program(x: torch.Tensor, program_rows: int, scale: float) -> torch.Tensor:
    """x0 * scale for each row: x0 the first element of the row's program."""
    return (x[::program_rows, :1] * scale).repeat_interleave(program_rows, 0)


def alu_chain_torch(x: torch.Tensor, chain: int, program_rows: int = 256
                    ) -> torch.Tensor:
    m = _per_program(x, program_rows, 1e-9) + 0.999931
    y = x
    for _ in range(chain):
        y = y * m + x
    return y


def trans_chain_torch(x: torch.Tensor, chain: int, op: str,
                      program_rows: int = 256) -> torch.Tensor:
    fn = {"cos": torch.cos, "sin": torch.sin, "tan": torch.tan}[op]
    eps = _per_program(x, program_rows, 1e-12)
    y = x
    for _ in range(chain):
        y = fn(y) + eps
    return y


def gather_chain_torch(tbl: torch.Tensor, idx: torch.Tensor, chain: int
                       ) -> torch.Tensor:
    rows = tbl.shape[0]
    y = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
    for i in range(chain):
        y = y + torch.gather(tbl, 0, (idx + i) % rows)
    return y


def chain_plan(n: int, sms: int, blocks_per_sm: int, threads: int,
               elems: int) -> int:
    """P1's grid: the blocks the card holds at once (``sms`` x
    ``blocks_per_sm``), or fewer where n elements at ``elems`` a thread of
    ``threads`` a block need fewer."""
    need = -(-n // (threads * elems))
    return max(1, min(sms * blocks_per_sm, need))


@functools.cache
def chain_geometry(device_index: int, kernel: str) -> tuple[int, int, int]:
    """(threads a block, elements a thread, blocks an SM holds) of a P1
    kernel (``alu``, or P1b's op) on this card, from the occupancy query,
    once per device and kernel."""
    threads, elems, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _raise_on(_build.load().cudasbmp_chain_geometry(
        device_index, CHAIN_KERNELS[kernel], ctypes.byref(threads),
        ctypes.byref(elems), ctypes.byref(blocks)),
        "cudaOccupancyMaxActiveBlocksPerMultiprocessor")
    return threads.value, elems.value, blocks.value


def gather_slice_bytes(rows: int) -> int:
    """P2's shared memory a block at ``rows`` table rows: the mbarrier and
    the slice of rows + GATHER_UNROLL - 1 rows of 32 floats."""
    return GATHER_HEADER + 4 * SLICE_LANES * (rows + GATHER_UNROLL - 1)


def gather_max_rows(smem_optin: int) -> int:
    """The most table rows P2's slice holds in ``smem_optin`` bytes of
    shared memory (1,808 at an H100's 227 KB)."""
    return (smem_optin - GATHER_HEADER) // (4 * SLICE_LANES) - (GATHER_UNROLL - 1)


def gather_plan(n_rows: int, rows: int, sms: int, blocks_per_sm: int,
                rows_per_block: int, smem_optin: int) -> int:
    """P2's blocks along the rows of idx (the grid is LANES // SLICE_LANES
    times that): the fewest that hold n_rows at ``rows_per_block`` a block,
    or, where more fit on the card at once (``sms`` x ``blocks_per_sm``
    over the lane slices), that many, each of about n_rows / blocks rows;
    never more blocks than rows. Raises where the slice of ``rows`` table
    rows does not fit in ``smem_optin`` bytes."""
    if not 1 <= rows <= gather_max_rows(smem_optin):
        raise ValueError(f"tbl: {rows} rows; one block's shared memory "
                         f"({smem_optin} bytes) holds 1 to "
                         f"{gather_max_rows(smem_optin)}")
    need = -(-n_rows // rows_per_block)
    fill = -(-sms * blocks_per_sm // (LANES // SLICE_LANES))
    return max(1, min(n_rows, max(need, fill)))


@functools.cache
def gather_geometry(device_index: int, rows: int) -> tuple[int, int, int, int]:
    """(threads a block, rows of idx a block holds at most, blocks an SM
    holds at ``rows`` table rows, the most table rows a slice holds) of P2
    on this card, once per device and rows."""
    out = [ctypes.c_int() for _ in range(4)]
    _raise_on(_build.load().cudasbmp_gather_geometry(
        device_index, rows, *map(ctypes.byref, out)),
        "cudaOccupancyMaxActiveBlocksPerMultiprocessor")
    return tuple(v.value for v in out)


def _chain_args(x: torch.Tensor, chain: int, program_rows: int
                ) -> tuple[int | None, int]:
    """Check a P1 input; return (CUDA device index, or None on the CPU,
    elements of a program)."""
    if x.dim() != 2 or program_rows < 1 or x.shape[0] % program_rows or chain < 0:
        raise ValueError(f"x: expected [programs * {program_rows}, lanes], got "
                         f"{tuple(x.shape)} (chain {chain})")
    _check("x", x, tuple(x.shape), torch.float32)
    if _device_of(x).type == "cpu":
        return None, program_rows * x.shape[1]
    return _index(x.device), program_rows * x.shape[1]


def _chain_launch(kernel: str, x: torch.Tensor, dev: int, program: int,
                  chain: int) -> torch.Tensor:
    """Launch a P1 kernel on the grid ``chain_plan`` gives it."""
    y = torch.empty_like(x)
    threads, elems, per_sm = chain_geometry(dev, kernel)
    grid = chain_plan(x.numel(), sm_count(dev), per_sm, threads, elems)
    _raise_on(_build.load().cudasbmp_chain(
        dev, CHAIN_KERNELS[kernel], x.data_ptr(), y.data_ptr(), x.numel(), program,
        chain, grid, torch.cuda.current_stream(x.device).cuda_stream),
        "alu_chain_kernel" if kernel == "alu" else "trans_chain_kernel")
    return y


def alu_chain_cuda(x: torch.Tensor, chain: int, program_rows: int = 256
                   ) -> torch.Tensor:
    """Kernel P1a on x f32 [programs * program_rows, lanes]."""
    dev, program = _chain_args(x, chain, program_rows)
    if dev is None:
        return alu_chain_torch(x, chain, program_rows)
    y = _chain_launch("alu", x, dev, program, chain)
    alu_chain_cuda.launches += 1
    return y


def trans_chain_cuda(x: torch.Tensor, chain: int, op: str,
                     program_rows: int = 256) -> torch.Tensor:
    """Kernel P1b with op ``cos``, ``sin`` or ``tan`` (the accurate CUDA
    functions) on x f32 [programs * program_rows, lanes]."""
    if op not in TRANS_OPS:
        raise ValueError(f"op {op!r}: expected one of {sorted(TRANS_OPS)}")
    dev, program = _chain_args(x, chain, program_rows)
    if dev is None:
        return trans_chain_torch(x, chain, op, program_rows)
    y = _chain_launch(op, x, dev, program, chain)
    trans_chain_cuda.launches += 1
    return y


def gather_chain_cuda(tbl: torch.Tensor, idx: torch.Tensor, chain: int
                      ) -> torch.Tensor:
    """Kernel P2: tbl f32 [rows, 128], idx int32 [N, 128] -> y f32 [N, 128].
    A block keeps 32 columns of every row in shared memory (and 7 rows
    again), so rows are limited to what one block holds (1,808 on an H100,
    ``gather_max_rows``). A table not on a 16-byte boundary, which the bulk
    copy needs, is copied first."""
    if _device_of(tbl, idx).type == "cpu":
        return gather_chain_torch(tbl, idx, chain)
    rows = tbl.shape[0] if tbl.dim() == 2 else 0
    _check("tbl", tbl, (rows, LANES), torch.float32)
    _check("idx", idx, (idx.shape[0] if idx.dim() == 2 else 0, LANES), torch.int32)
    if rows < 1 or chain < 0:
        raise ValueError(f"tbl: {rows} rows, chain {chain}")
    dev = _index(idx.device)
    _, per_block, per_sm, _ = gather_geometry(dev, rows)
    blocks_y = gather_plan(idx.shape[0], rows, sm_count(dev), per_sm, per_block,
                           smem_optin(dev))
    if tbl.data_ptr() % 16:
        tbl = tbl.clone()
    y = torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
    rc = _build.load().cudasbmp_gather_chain(
        dev, tbl.data_ptr(), rows, idx.data_ptr(), y.data_ptr(), idx.shape[0], chain,
        blocks_y, torch.cuda.current_stream(idx.device).cuda_stream)
    _raise_on(rc, "gather_chain_kernel")
    gather_chain_cuda.launches += 1
    return y


def sincos_torch(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return torch.sin(x), torch.cos(x)


def sincos_cuda(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin x, cos x) of f32 x from one sincosf each, as
    csrc/rollout.cu::cos_sin computes a heading's pair."""
    _check("x", x, tuple(x.shape), torch.float32)
    if _device_of(x).type == "cpu":
        return sincos_torch(x)
    s, c = torch.empty_like(x), torch.empty_like(x)
    rc = _build.load().cudasbmp_sincos(
        _index(x.device), x.data_ptr(), s.data_ptr(), c.data_ptr(), x.numel(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "sincos_kernel")
    sincos_cuda.launches += 1
    return s, c


def sincos_differences(device, chunk: int = 1 << 26) -> int:
    """How many of the 2^32 float bit patterns ``sincos_cuda`` maps to
    another sine or cosine than ``torch.sin``/``torch.cos`` on ``device``
    (a NaN equals any NaN). 0 means the rollout kernels' one sincosf a
    heading rounds as the plain twins' separate cos and sin, for every
    input."""
    bad = 0
    for base in range(-2 ** 31, 2 ** 31, chunk):
        x = torch.arange(base, base + chunk, dtype=torch.int64, device=device)
        x = x.to(torch.int32).view(torch.float32)
        for a, b in zip(sincos_cuda(x), sincos_torch(x)):
            differ = a.view(torch.int32) != b.view(torch.int32)
            bad += int((differ & ~(a.isnan() & b.isnan())).sum())
    return bad


WRAPPERS = (alu_chain_cuda, trans_chain_cuda, gather_chain_cuda)


def reset_launch_counts() -> None:
    for wrapper in (*WRAPPERS, sincos_cuda):
        wrapper.launches = 0


reset_launch_counts()
