"""Build the package's CUDA sources with nvcc and load them with ctypes.

``csrc/*.cu`` compile at first use into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), under
``cudasbmp_torch/_build/``, which git ignores. The library's file name
carries a hash of the sources and flags, so an edited source rebuilds and an
unchanged one is loaded as it is.

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

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("rollout.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    # device, x0, controls, obstacles, K, x1, valid, B, num_disc, width,
    # height, L, stream
    "cudasbmp_rollout": (_I, _P, _P, _P, _I, _P, _P, _I, _I, _F, _F, _F, _P),
    # device, key, x0, obstacles, K, x1, controls, valid, B, num_disc, width,
    # height, L, lo0, lo1, lo2, hi0, hi1, hi2, stream
    "cudasbmp_sample_and_rollout": (_I, _P, _P, _P, _I, _P, _P, _P, _I, _I,
                                    _F, _F, _F, _F, _F, _F, _F, _F, _F, _P),
}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels of cudasbmp_torch need the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libcudasbmp_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float, str]:
    """Compile the sources unless this exact build exists. Returns (library
    path, build seconds (0.0 when cached), compiler output)."""
    target = library_path()
    if target.exists():
        return target, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(str(CSRC_DIR / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)
    return target, seconds, proc.stdout + proc.stderr


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's signature."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
