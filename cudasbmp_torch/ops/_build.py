"""Build the package's CUDA sources with nvcc and load them with ctypes.

``csrc/*.cu`` compile at first use into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), under
``cudasbmp_torch/_build/``, which git ignores, with the compiler's output
beside it (``.log``). Each source compiles in its own ``nvcc``, all started
together, and one more links the objects. The library's file name
carries a hash of the sources and flags, so an edited source rebuilds and an
unchanged one is loaded as it is.

A user's system with its own device struct (systems/base.py::
DeviceStructMixin) gets a library of its own, built at its first launch:
``rollout.cu`` and ``refine.cu`` compiled with ``-DCUDASBMP_USER_SYSTEM``
and the struct written into the header they then include
(``cudasbmp_user_system.cuh``, in the build's temporary directory), which
instantiates the kernels for that struct alone (``user_header``;
``library_path(struct)`` hashes the header's text too). A struct that does
not compile raises with nvcc's output; nothing falls back. Each build runs
in a temporary directory of its own and moves the log, then the library,
into place with ``os.replace``, so processes that build the same library
at once (torchrun's ranks) each find a whole one.

Flags: ``-gencode arch=compute_90a,code=sm_90a`` (Hopper) and no
``--use_fast_math`` (IEEE division, accurate cosf/sinf/tanf). FMA
contraction stays at nvcc's default: the kernels write each rounding step
of the rollout as an explicit ``__fadd_rn``/``__fmul_rn`` (never
contracted, matching the plain PyTorch version's one rounding per
operator), while the math library's trig functions compile as they do in
PyTorch's own kernels. ``-Xptxas -v`` reports registers and spills.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

from cudasbmp_torch.systems.base import struct_flags

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("rollout.cu", "chains.cu", "refine.cu")
USER_SOURCES = ("rollout.cu", "refine.cu")  # a user struct's library
USER_MACRO = "CUDASBMP_USER_SYSTEM"
USER_HEADER = "cudasbmp_user_system.cuh"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
SIGNATURES = {
    # device
    "cudasbmp_smem_optin": (_I,),
    # device, system, flags, x0, controls, obstacles, K, per_problem, x1,
    # valid, P, R, num_disc, width, height, param, hl, hw, windows, plan
    # (host bytes), pad, split, stream
    "cudasbmp_rollout": (_I, _I, _I, _P, _P, _P, _I, _I, _P, _P, _I, _I, _I,
                         _F, _F, _F, _F, _F, _I, _P, _F, _I, _P),
    # device, system, flags, keys, x0, obstacles, K, per_problem, x1,
    # controls, valid, P, R, num_disc, width, height, param, hl, hw,
    # windows, plan, pad, lo0, lo1, lo2, hi0, hi1, hi2, lane0, split, stream
    "cudasbmp_sample_and_rollout": (_I, _I, _I, _P, _P, _P, _I, _I, _P, _P,
                                    _P, _I, _I, _I, _F, _F, _F, _F, _F, _I,
                                    _P, _F, _F, _F, _F, _F, _F, _F, _I, _I,
                                    _P),
    # device, x, s, c, n, stream
    "cudasbmp_sincos": (_I, _P, _P, _P, _I, _P),
    # device, kernel (P1b's op or P1a), x, y, n, program, chain, grid, stream
    "cudasbmp_chain": (_I, _I, _P, _P, _I, _I, _I, _I, _P),
    # device, kernel, &threads, &elements a thread, &blocks an SM
    "cudasbmp_chain_geometry": (_I, _I, _P, _P, _P),
    # device, rows, &threads, &rows a block, &blocks an SM, &most rows
    "cudasbmp_gather_geometry": (_I, _I, _P, _P, _P, _P),
    # device, tbl, rows, idx, y, n_rows, chain, blocks along the rows, stream
    "cudasbmp_gather_chain": (_I, _P, _I, _P, _P, _I, _I, _I, _P),
    # device, system, param, x0, controls, wts, goal, obstacles, K,
    # per_problem, states, gpos, loss, grad, B, L, num_disc, margin, xhi,
    # yhi, goal_radius, collision_weight, goal_weight, stream
    "cudasbmp_refine": (_I, _I, _F, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P,
                        _I, _I, _I, _F, _F, _F, _F, _F, _F, _P),
    # device, system, L, num_disc, &bytes a problem (int64), &shared limit
    "cudasbmp_refine_adam_workspace": (_I, _I, _I, _I, _P, _P),
    # device, system, param, x0, raw0, controls0, mask, goal, obstacles, K,
    # per_problem, bias1, bias2, lo0, lo1, lo2, hi0, hi1, hi2, scratch,
    # workspace, shared, losses, refined, B, L, num_disc, iterations, margin,
    # xhi, yhi, goal_radius, collision_weight, goal_weight, time_weight,
    # learning_rate, clip_norm, stream
    "cudasbmp_refine_adam": (_I, _I, _F, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P,
                             _F, _F, _F, _F, _F, _F, _P, _LL, _I, _P, _P, _I, _I,
                             _I, _I, _F, _F, _F, _F, _F, _F, _F, _F, _F, _P),
    # (none): 1 where a user library's struct has R1's back(), else 0
    "cudasbmp_user_has_back": (),
}
# the entry points of a user struct's library; the package's has the others
USER_ENTRY_POINTS = ("cudasbmp_smem_optin", "cudasbmp_rollout",
                     "cudasbmp_sample_and_rollout", "cudasbmp_refine",
                     "cudasbmp_refine_adam_workspace", "cudasbmp_refine_adam",
                     "cudasbmp_user_has_back")
ENTRY_POINTS = tuple(n for n in SIGNATURES if n != "cudasbmp_user_has_back")


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels of cudasbmp_torch need the CUDA toolkit")


def user_header(struct: str) -> str:
    """The header a user library's sources include: the struct's text, and
    a static_assert of each flag ``struct_flags`` read from it, so the
    compiler holds the text to what the wrappers were told."""
    checks = "".join(f'static_assert(UserSystem::{k} == {str(v).lower()}, '
                     f'"UserSystem::{k}");\n' for k, v in struct_flags(struct).items())
    return (f"// {USER_HEADER}: a system's cuda_struct, written by "
            f"cudasbmp_torch/ops/_build.py\n{struct}\n{checks}")


def library_path(struct: str | None = None) -> Path:
    """The package's library, or with ``struct`` that user struct's."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (SOURCES if struct is None else USER_SOURCES):
        h.update((CSRC_DIR / name).read_bytes())
    if struct is None:
        return BUILD_DIR / f"libcudasbmp_kernels_{h.hexdigest()[:16]}.so"
    h.update(USER_MACRO.encode())
    h.update(user_header(struct).encode())
    return BUILD_DIR / f"libcudasbmp_user_{h.hexdigest()[:16]}.so"


def compile_commands(nvcc: str, tmp: str, struct: str | None = None
                     ) -> list[list[str]]:
    """One nvcc a source, objects into ``tmp``: the package's three, or a
    user struct's two with the macro and ``tmp`` (where its header is) on
    the include path."""
    if struct is None:
        sources, extra = SOURCES, ()
    else:
        sources, extra = USER_SOURCES, (f"-D{USER_MACRO}", "-I", tmp)
    return [[nvcc, *NVCC_FLAGS, *extra, "-c", str(CSRC_DIR / s),
             "-o", os.path.join(tmp, f"{Path(s).stem}.o")] for s in sources]


def _run(cmds: list[list[str]]) -> str:
    """Run the commands side by side; their joined output, or raise with
    the first failure's."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{out}")
    return "".join(outs)


def build(struct: str | None = None) -> tuple[Path, float, str]:
    """Compile the package's sources, or a user ``struct``'s library,
    unless this exact build exists. Returns (library path, build seconds
    (0.0 when cached), compiler output, which is kept beside the library
    and read back when cached)."""
    target = library_path(struct)
    log = target.with_suffix(".log")
    if target.exists():
        return target, 0.0, log.read_text() if log.exists() else ""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        if struct is not None:
            Path(tmp, USER_HEADER).write_text(user_header(struct))
        cmds = compile_commands(nvcc, tmp, struct)
        out = _run(cmds)
        lib = os.path.join(tmp, "lib.so")
        out += _run([[nvcc, *ARCH, "-shared", "-o", lib, *(c[-1] for c in cmds)]])
        Path(tmp, "lib.log").write_text(out)
        os.replace(os.path.join(tmp, "lib.log"), log)
        os.replace(lib, target)
    return target, time.perf_counter() - t0, out


def load(struct: str | None = None) -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's signature:
    the package's library, or with ``struct`` that user struct's (one
    handle each, kept)."""
    return _load(struct)


@functools.cache
def _load(struct: str | None) -> ctypes.CDLL:
    path, _, _ = build(struct)
    lib = ctypes.CDLL(str(path))
    for name in (ENTRY_POINTS if struct is None else USER_ENTRY_POINTS):
        fn = getattr(lib, name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib
