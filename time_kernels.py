"""Time the rollout kernels of a cudasbmp_torch checkout on one GPU.

    python3 time_kernels.py [--root CHECKOUT] [--reps 5] [--no-groups]
                            [--group-lanes 4096,32768] [--group-splits 1,4]
                            [--only b5,p1a,p1b,p2] [--sass] [--clocks]
                            [--demo-tts]

Imports cudasbmp_torch from CHECKOUT (default: the directory of this
script), builds its kernels, and times, on the demo's obstacles (K=8):
B1 (``rollout_cuda``) and B2 (``sample_and_rollout_cuda``) at the demo's
wave width (4,096 lanes), at the arena's 32,768 and at 2^17 lanes (B2 also
with fast math, the probe's ``cuda_rng`` fast row, ``b2_fast_131072``); B1 with
the footprint (B3, ``b3_4096``) and with footprint and fast math (B4,
``b4_4096``) at 4,096 lanes; the one-warp floor, B1 at 32 lanes
(``floor_b1_32``), and its parts: one step and no box (``floor_n1_k0``),
ten steps and no box (``floor_n10_k0``), one step and the demo's boxes
(``floor_n1_k8``); where the checkout has kernel B6
(``rollout_batched_cuda``), both B6 forms at the sweeps' shape (1,024
problems x 128 lanes x 8 boxes, ``b6_ms`` and ``b6_rng_ms``), B6 at the
widest extension bucket (256 x 128, ``b6_256x128_ms``) and the
all-options bicycle (footprint and fast math) at the sweeps' shape
(``b6_options_ms``); and where it has thread groups
(``lanes_per_rollout``), B1 exact and with the footprint at every G in
{1, 2, 4, 8} (``--group-splits``) at each of chip_smoke.py's SPLIT_WIDTHS,
1,024 to 2^17 lanes (``--group-lanes``), as ``g<G>_<exact|footprint>_
<lanes>``, and B6 at the extension rounds' buckets (EXTENSION_BUCKETS
problems x 128 lanes x 8 boxes, ``g<G>_b6_<P>x128``), with the floor at
G = 1; B5, the culled broad phase, at the cull table's shape (B2 on 2^17
Morton-grouped starts on Scenario.dense(24), probes/throughput.py::
cull_table) with cull off and at each W in {1, 2, 4, 5} (``b5_W<W>``), at
40 steps and W = 1 (``b5_n40_W1``, a window past the kernel's cap of
steps), on the probe's random starts at W = 1 and 4 (``b5_random_W<W>``,
lanes far apart: little to cull) and at its one-warp floor (the first 32 of those starts, W = 4,
``floor_b5_32``); and the calibration chains at the calibration shape
(f32 [2048, 128], probes/roofline.py::calibrate): P1a, the FMA chain, at
16,384 links (``p1a``), P1b, the accurate trig chains, for cos, sin and
tan at 2,048 links (``p1b_<op>``), and P2, the shared-memory gathers, at
512 links from tables of 8, 128 and 1,024 rows (``p2_<rows>``); where the
checkout has the whole refinement's kernel (``refine_adam_cuda``), a
refinement at RefineConfig() on the CLI demo's path (``refine_demo``), on
128 problems of 2 to 24 real edges padded to 24 (the quality pipeline's
lengths, ``refine_128x24``) and on one 24-edge path (``refine_1x24``). ``--only``
keeps the rows whose names start with one of its prefixes. Each is timed ``--reps`` times by its device time under
torch.profiler (with the regular profiler windows each reading took,
probes/timing.py) and by CUDA events (which measure the host's launch rate
where it is slower than the card), 20 launches a measurement, as
chip_smoke.py times them. Prints one JSON line with the card's name and
power limit, the checkout, the G each default launch took (``splits``,
where the checkout counts them), every time in ms, ``flagged``: the
rows with a reading of fewer than 3 regular windows, and, for the chains
kept, ``digests``: the sha256 (first 16 hex digits) of P1a's output at 64
and 16,384 links and of P2's at each table size, and of both at a ragged
size (chip_smoke.py::ragged_chain_inputs), so two checkouts can be shown
to give the same bits.

``--demo-tts`` also solves the reference demo at KGMTConfig() once to
warm up, then 3 times over seeds 0-7, and adds ``demo_tts``: the time to
solution (``KGMTResult.wall_time_s``) p50, p90, least and most, a digest
of every solve's (solved, iterations, tree size, cost), so two checkouts
can be shown to solve alike, and, where the checkout names its phases
(``utils/profiling.py``), the host cost in us of one ``phase_scope`` on
the card and of one NVTX push and pop. ``--only demo_tts --demo-tts``
times the demo alone.

``--clocks`` also runs each row kept back to back for 2 s while
nvidia-smi reads the SM clock and the power draw every 0.1-0.2 s, and adds
their median, least and most (``clocks``: the clock the card holds under
that load).

``--sass`` also dumps, with the toolkit's cuobjdump, the SASS of both B6
kernels for the exact bicycle without footprint (the instantiation the
sweeps run), of B2's culled form for it (B5 as the cull table runs it) and
of P1a, the three P1b kernels and P2 (csrc/chains.cu) to
chiprun_out/sass_<checkout>.txt,
and adds to the JSON line each loop of those kernels (a backward branch and
its target): its instruction count and its opcodes, the counts that
PERF.md attributes to the parts of a step or a link, and its fast path
(``fast_path``: the branches over the math library's Payne-Hanek paths
taken); each kernel's registers, stack and shared memory (cuobjdump
-res-usage) with the blocks of its launch one SM can hold
(``occupancy``); and the chains' issue limits at the card's top SM clock
and, with ``--clocks``, at the clock it held: P1b's (``p1b_issue``: its
fast path's instructions and conversions a link, at 4 warp-instructions
and 16 conversions a clock per SM), P1a's (``p1a_issue``: its unrolled
loop's instructions an FFMA at 4 warp-instructions a clock per SM, with
the FFMAs' source registers, how many read two registers of one bank
from the register file, ``bank_conflicts``, under the model of two banks
by the register number's parity, and how many take a source from the
operand reuse cache, ``reused``) and P2's (``p2_issue``: the larger of its
loop's instructions a shared-memory load at 4 warp-instructions a clock
per SM and its 4-byte loads at 128 bytes a clock per SM); and, where the
checkout has the whole refinement's kernel, its chain limit
(``refine_chain``): the staged chains' loops in the SASS of
refine_adam_kernel<Bicycle, shared> on their fast paths, their
instructions and cycles a step by the loop-carried critical path and by
one warp's in-order issue, at latencies a probe measures on the card
(``latency``: one warp's chain of 256 dependent FADD, FMUL, FFMA, IMAD,
MUFU, F2I+I2F or shared-memory loads between two clock64 reads), and a
refinement's limit in ms at each (``limit_ms``: 400 steps of the
bicycle's six passes over the refine rows' points at the card's top
clock).

To compare two checkouts, time both on the same card one after the other,
in the order parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import pathlib
import re
import statistics
import subprocess
import sys
import threading
import time
import timeit
from collections import Counter


def _ints(text: str | None) -> tuple[int, ...]:
    return tuple(int(v) for v in text.split(",")) if text else ()


# the B6 instantiations the sweeps run, B5 as the cull table runs it
# (demangled names of csrc/rollout.cu) and P1a, P1b and P2 (csrc/chains.cu),
# with each kernel's threads a block (P2's: the checkout's, main() sets it)
SASS_KERNELS = {
    **{f"{k}<(anonymous namespace)::Bicycle, false, false, false>": 128
       for k in ("rollout_kernel", "sample_and_rollout_kernel")},
    "sample_and_rollout_kernel<(anonymous namespace)::Bicycle, false, false, true>": 128,
    **{f"trans_chain_kernel<{op}>": 256 for op in range(3)},
    "alu_chain_kernel": 256, "gather_chain_kernel": 256,
    "refine_adam_kernel<(anonymous namespace)::Bicycle, true>": 256}
REFINE_ADAM = "refine_adam_kernel<(anonymous namespace)::Bicycle, true>"
# an H100's SM: threads, registers, blocks and shared memory (each block
# also takes 1 KB of it for the system) it holds at once
SM_THREADS, SM_REGISTERS, SM_BLOCKS, SM_SMEM = 2048, 65536, 32, 228 * 1024


def occupancy(registers: int, threads: int, smem: int = 0) -> int:
    """Blocks of ``threads`` threads at ``registers`` a thread and ``smem``
    bytes of shared memory that one SM holds: registers are allocated 256
    a warp at a time."""
    per_warp = -(-registers * 32 // 256) * 256
    warps = SM_REGISTERS // per_warp if per_warp else SM_THREADS // 32
    return min(SM_BLOCKS, SM_THREADS // threads, warps // (threads // 32),
               SM_SMEM // (smem + 1024))


def resource_usage(cuobjdump: pathlib.Path, library: pathlib.Path) -> dict:
    """{kernel (demangled, as SASS_KERNELS names it): {REG, STACK, SHARED,
    LOCAL, ...}} of the SASS_KERNELS in ``library``."""
    text = subprocess.run([str(cuobjdump), "-res-usage", str(library)],
                          capture_output=True, text=True, timeout=600, check=True).stdout
    pairs = re.findall(r"Function (\S+):\s*\n\s*(.*)", text)
    names = subprocess.run(["c++filt"], input="\n".join(m for m, _ in pairs), text=True,
                           capture_output=True, timeout=60, check=True).stdout.splitlines()
    out = {}
    for name, (_, usage) in zip(names, pairs):
        short = _short(name)
        if short in SASS_KERNELS:
            out[short] = {k: int(v) for k, v in re.findall(r"(\w+):(\d+)", usage)}
    return out


def _short(name: str) -> str:
    short = name.removeprefix("void ").removeprefix("(anonymous namespace)::")
    cut = short.find(">(")
    return short[:cut + 1] if cut >= 0 else short[:short.find("(")]
_INSTRUCTION = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def fast_path(ins: list, lo: int, hi: int, slow=("DMUL", "LDL", "STL"),
              whole: bool = False) -> tuple[list, int]:
    """One pass through the loop [lo, hi] of ``ins`` (address, predicate,
    opcode, operands) that takes each conditional forward branch over a
    path with double-precision multiplies or local-memory loads or stores
    (the math library's Payne-Hanek reduction, which the calibration inputs
    never take; ``slow`` names the opcodes that mark such a path): the
    opcodes it issues (with ``whole``, its instructions), and how many such
    paths it skips (one a trig call)."""
    body = [i for i in ins if lo <= i[0] <= hi]
    skipped = []
    for a, pred, op, args in ins:
        if not (lo <= a <= hi and pred and op.startswith("BRA")):
            continue
        target = int(re.search(r"0x([0-9a-f]+)", args)[1], 16)
        if target <= a or target > hi or any(s < a < e for s, e in skipped):
            continue
        if any(o.split(".")[0] in slow for b, _, o, _ in body if a < b < target):
            skipped.append((a, target))
    kept = [i for i in body if not any(s < i[0] < e for s, e in skipped)]
    return (kept if whole else [i[2].split(".")[0] for i in kept]), len(skipped)


def _issue_ms(elems: int, links: int, per_link: float, sm_count: int,
              clock_hz: float) -> float:
    """elems x links x per_link warp-instructions over 4 a clock per SM."""
    return 1e3 * elems * links * per_link / (sm_count * 4 * 32 * clock_hz)


def p1b_issue(sass: dict, elems: int, links: int, sm_count: int, clock_hz: float
              ) -> dict:
    """P1b's issue limit from its SASS: the fast path of its chain loop (the
    innermost loop that skips a Payne-Hanek path) over its trig calls gives
    the instructions and the conversions (F2I, I2F, I2FP) a link; elems x
    links of them at 4 warp-instructions, and 16 conversions, a clock per
    SM at ``clock_hz``."""
    out = {}
    for op in range(3):
        loops = [l for l in sass.get(f"trans_chain_kernel<{op}>", {}).get("loops", [])
                 if l["fast_path"]["local_paths"]]
        if not loops:
            continue
        fp = min(loops, key=lambda l: l["instructions"])["fast_path"]
        per_link = fp["instructions"] / fp["local_paths"]
        conv = sum(fp["opcodes"].get(k, 0) for k in ("F2I", "I2F", "I2FP")) / fp["local_paths"]
        out[("cos", "sin", "tan")[op]] = {
            "instructions_per_link": per_link, "conversions_per_link": conv,
            "issue_ms": _issue_ms(elems, links, per_link, sm_count, clock_hz),
            "conversion_ms": 1e3 * elems * links * conv / (sm_count * 16 * clock_hz)}
    return out


def _main_loops(sass: dict, kernel: str, opcode: str) -> list[dict]:
    """The innermost loops of ``kernel`` (each holding no other loop with
    ``opcode``) with the most ``opcode`` instructions: one, or one for each
    path the kernel may take."""
    loops = [l for l in sass.get(kernel, {}).get("loops", []) if opcode in l["opcodes"]]

    def holds(a: dict, b: dict) -> bool:
        return a is not b and int(a["from"], 16) <= int(b["from"], 16) \
            and int(b["to"], 16) <= int(a["to"], 16)

    inner = [a for a in loops if not any(holds(a, b) for b in loops)]
    most = max((l["opcodes"][opcode] for l in inner), default=0)
    return [l for l in inner if l["opcodes"][opcode] == most]


def p1a_issue(sass: dict, elems: int, links: int, sm_count: int, clock_hz: float
              ) -> dict:
    """P1a's issue limit from its SASS: its unrolled loop's instructions an
    FFMA (a link of one element), elems x links of them at 4
    warp-instructions a clock per SM at ``clock_hz``; with the loop's FFMA
    source registers, ``bank_conflicts`` and ``reused``, for each such
    loop (P1a has one where a thread's elements share m and one where they
    do not)."""
    loops = _main_loops(sass, "alu_chain_kernel", "FFMA")
    if not loops:
        return {}
    per_link = min(l["instructions"] for l in loops) / loops[0]["opcodes"]["FFMA"]
    return {"ffma_a_step": loops[0]["opcodes"]["FFMA"], "instructions_per_link": per_link,
            "issue_ms": _issue_ms(elems, links, per_link, sm_count, clock_hz),
            "loops": [{"from": l["from"], "instructions": l["instructions"],
                       "bank_conflicts": l["bank_conflicts"], "reused": l["reused"],
                       "ffma_sources": l["ffma_sources"][:8]} for l in loops]}


def p2_issue(sass: dict, elems: int, links: int, sm_count: int, clock_hz: float
             ) -> dict:
    """P2's issue limit from its SASS: the larger of its chain loop's
    instructions a shared-memory load (a link) at 4 warp-instructions a
    clock per SM and the links' 4-byte loads at 128 bytes (one warp-wide
    load) a clock per SM, at ``clock_hz``."""
    loops = _main_loops(sass, "gather_chain_kernel", "LDS")
    if not loops:
        return {}
    loop = min(loops, key=lambda l: l["instructions"])
    per_link = loop["instructions"] / loop["opcodes"]["LDS"]
    out = {"lds_a_step": loop["opcodes"]["LDS"], "instructions_per_link": per_link,
           "instruction_ms": _issue_ms(elems, links, per_link, sm_count, clock_hz),
           "load_ms": 1e3 * elems * links * 4 / (sm_count * 128 * clock_hz)}
    out["issue_ms"] = max(out["instruction_ms"], out["load_ms"])
    out["bound_by"] = "loads" if out["load_ms"] >= out["instruction_ms"] else "instructions"
    return out


# The latency probe: one warp runs a dependent chain of LATENCY_LINKS
# instructions of one kind between two clock64 reads (PTX written so that
# ptxas emits one SASS instruction a link; the F2I+I2F kind is a pair a
# link, the LDS kind a pointer chase through shared memory); cycles a link.
LATENCY_LINKS = 256
LATENCY_KINDS = ("FADD", "FMUL", "FFMA", "IMAD", "MUFU", "F2I+I2F", "LDS")
LATENCY_SOURCE = r"""
#include <cuda_runtime.h>
#define R2(x) x x
#define R16(x) R2(R2(R2(R2(x))))
#define R256(x) R16(R16(x))
__global__ void probe(int kind, float* out, long long* cycles) {
  __shared__ unsigned ring[32];
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(ring));
  ring[threadIdx.x] = base + 4u * ((threadIdx.x + 1) & 31);
  __syncwarp();
  float x = 1.0f + 1e-3f * threadIdx.x, y = 1e-7f, z = 0.5f;
  int i = threadIdx.x;
  unsigned a = base + 4u * threadIdx.x;
  const long long t0 = clock64();
  switch (kind) {
    case 0: R256(asm volatile("add.rn.f32 %0, %0, %1;" : "+f"(x) : "f"(y));) break;
    case 1: R256(asm volatile("mul.rn.f32 %0, %0, %1;" : "+f"(x) : "f"(y));) break;
    case 2: R256(asm volatile("fma.rn.f32 %0, %0, %1, %2;" : "+f"(x) : "f"(y), "f"(z));) break;
    case 3: R256(asm volatile("mad.lo.s32 %0, %0, %1, %2;" : "+r"(i) : "r"(3), "r"(1));) break;
    case 4: R256(asm volatile("ex2.approx.ftz.f32 %0, %0;" : "+f"(x));) break;
    case 5: R256(asm volatile("cvt.rni.s32.f32 %0, %1;\n\tcvt.rn.f32.s32 %1, %0;"
                              : "+r"(i), "+f"(x));) break;
    case 6: R256(asm volatile("ld.shared.u32 %0, [%0];" : "+r"(a));) break;
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) {
    cycles[kind] = t1 - t0;
    out[kind] = x + y + z + static_cast<float>(i) + static_cast<float>(a);
  }
}
extern "C" int latency_probe(int kind, void* out, void* cycles) {
  probe<<<1, 32>>>(kind, static_cast<float*>(out), static_cast<long long*>(cycles));
  return static_cast<int>(cudaDeviceSynchronize());
}
"""


def measure_latencies(out_dir: pathlib.Path) -> dict:
    """Cycles a link of each LATENCY_KINDS chain on this card (the probe
    built with the package's nvcc and flags into ``out_dir``), and the
    SASS opcodes of each chain, to show what was timed."""
    import ctypes
    import tempfile

    import torch

    from cudasbmp_torch.ops import _build

    out_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        src, lib = pathlib.Path(tmp, "latency.cu"), pathlib.Path(tmp, "latency.so")
        src.write_text(LATENCY_SOURCE)
        subprocess.run([_build.find_nvcc(), *_build.ARCH, "-std=c++17", "-O3", "-shared",
                        "-Xcompiler", "-fPIC", "-o", str(lib), str(src)], check=True,
                       capture_output=True, text=True, timeout=300)
        cuobjdump = pathlib.Path(_build.find_nvcc()).with_name("cuobjdump")
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                              text=True, timeout=300, check=True).stdout
        probe = ctypes.CDLL(str(lib))
        probe.latency_probe.argtypes = (ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)
        out = torch.zeros(len(LATENCY_KINDS), device="cuda")
        cycles = torch.zeros(len(LATENCY_KINDS), dtype=torch.int64, device="cuda")
        best = {}
        for _ in range(5):  # the least of five runs
            for k, kind in enumerate(LATENCY_KINDS):
                if probe.latency_probe(k, out.data_ptr(), cycles.data_ptr()) != 0:
                    raise RuntimeError(f"latency probe {kind} failed")
                best[kind] = min(best.get(kind, float("inf")),
                                 int(cycles[k]) / LATENCY_LINKS)
    ops = Counter(op.split(".")[0] for _, _, op, _ in _INSTRUCTION.findall(sass))
    return {"cycles_a_link": best, "links": LATENCY_LINKS,
            "sass_opcodes": {k: n for k, n in ops.items() if n >= LATENCY_LINKS}}


_REGS = re.compile(r"\b(UR\d+|R\d+|UP\d+|P\d+)\b")
_NO_DEST = {"ST", "STS", "STG", "STL", "RED", "BRA", "BSSY", "BSYNC", "CALL", "RET",
            "EXIT", "BAR", "WARPSYNC", "NOP", "YIELD", "DEPBAR", "MEMBAR", "JMP", "BRX"}
_TWO_PREDICATES = {"ISETP", "FSETP", "DSETP", "PLOP3"}
_FLOAT_ALU = {"FMNMX", "FSEL", "FSETP", "FSET", "FCHK", "FADD32I", "FMUL32I", "FFMA32I",
              "FSWZADD"}


def _registers(ins) -> tuple[list[str], list[str]]:
    """(registers an instruction writes, registers it reads), predicates
    included; a .64 or .128 result (or IMAD.WIDE's) spans 2 or 4 registers."""
    _, pred, op, args = ins
    parts = [a.strip() for a in args.split(",")]
    base = op.split(".")[0]
    n = 0 if base in _NO_DEST else 2 if base in _TWO_PREDICATES else 1
    width = 4 if ".128" in op else 2 if (".64" in op or ".WIDE" in op) else 1
    dests = []
    for part in parts[:n]:
        for r in _REGS.findall(part):
            dests += ([f"R{int(r[1:]) + k}" for k in range(width)]
                      if r.startswith("R") else [r])
    srcs = [r for part in parts[n:] for r in _REGS.findall(part)]
    srcs += _REGS.findall(pred or "")
    return dests, srcs


def _latency(op: str, lat: dict) -> float:
    """Cycles until an instruction's result can be read, from the probe's
    chains: FADD, FMUL and FFMA their own, other float ALU ops FADD's,
    MUFU its own, F2I/I2F/I2FP/F2F/FRND half an F2I+I2F pair, loads LDS's,
    every other op with a result IMAD's."""
    base = op.split(".")[0]
    if base in ("FADD", "FMUL", "FFMA"):
        return lat[base]
    if base in _FLOAT_ALU:
        return lat["FADD"]
    if base == "MUFU":
        return lat["MUFU"]
    if base in ("F2I", "I2F", "I2FP", "F2F", "FRND"):
        return lat["F2I+I2F"] / 2
    if base in ("LDS", "LDG", "LDC", "LD", "LDL"):
        return lat["LDS"]
    return lat["IMAD"]


def chain_cycles(body: list, lat: dict, in_order: bool, iterations: int = 32) -> float:
    """Cycles an iteration of a loop ``body`` (instructions in order) takes
    in steady state: with ``in_order`` as one warp issues it alone (an
    instruction a cycle at most, none before its operands are ready),
    else its loop-carried critical path (data dependencies alone: the
    heaviest recurrence through registers carried from one iteration to
    the next)."""
    ready: dict = {}
    issue, ends = 0.0, []
    for _ in range(iterations):
        for ins in body:
            dests, srcs = _registers(ins)
            start = max([issue + 1 if in_order else 0.0] + [ready.get(r, 0.0) for r in srcs])
            issue = start if in_order else issue
            for d in dests:
                ready[d] = start + _latency(ins[2], lat)
        ends.append(issue if in_order else max(ready.values(), default=0.0))
    half = iterations // 2
    return (ends[-1] - ends[half - 1]) / (iterations - half)


CHAIN_INSTRUCTIONS = 16  # a chain loop's instructions a step, at most


def refine_chain(library: pathlib.Path, lat: dict) -> dict:
    """The whole refinement's serial chains from the SASS of
    refine_adam_kernel<Bicycle, shared>: its chain loops, the innermost
    loops that on their fast path (the trig's Payne-Hanek paths and the
    division's slow call skipped) hold an add (FADD) and a shared-memory
    store a step, at most a shared-memory load a step (a batch's increments
    come in vector loads), at most CHAIN_INSTRUCTIONS instructions a step,
    and no global load or barrier: the staged forward and reverse passes
    (whole batches, and the rest one step at a time). For each
    loop its steps an iteration, instructions a step, and cycles a step by
    the loop-carried critical path and by one warp's in-order issue
    (``chain_cycles``), at the probe's latencies ``lat``; ``passes``: the
    bicycle's chains a refinement step (three levels forward, three in
    reverse)."""
    cuobjdump = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(library)], capture_output=True,
                          text=True, timeout=600, check=True).stdout
    chunks = re.split(r"\n\s*Function : (\S+)\n", text)
    names = subprocess.run(["c++filt"], input="\n".join(chunks[1::2]), text=True,
                           capture_output=True, timeout=60, check=True).stdout.splitlines()
    body = next((b for n, b in zip(names, chunks[2::2]) if _short(n) == REFINE_ADAM), None)
    if body is None:
        return {}
    ins = [(int(a, 16), pred, op, args) for a, pred, op, args in _INSTRUCTION.findall(body)]
    loops = []
    for addr, _, op, args in ins:
        m = re.search(r"0x([0-9a-f]+)", args) if op.startswith("BRA") else None
        if m and int(m[1], 16) <= addr:
            loops.append((int(m[1], 16), addr))
    chains = []
    for lo, hi in loops:
        fast, skipped = fast_path(ins, lo, hi, ("DMUL", "LDL", "STL", "CALL"), whole=True)
        if any(i[2].startswith("BRA") and lo <= int(re.search(r"0x([0-9a-f]+)", i[3])[1], 16)
               < i[0] < hi for i in fast):
            continue  # holds a loop on its fast path
        ops = [i[2].split(".")[0] for i in fast]
        steps = ops.count("FADD")
        if (steps and steps == ops.count("STS") and 1 <= ops.count("LDS") <= steps
                and len(fast) <= CHAIN_INSTRUCTIONS * steps and not {"LDG", "BAR"} & set(ops)):
            chains.append({"from": hex(lo), "to": hex(hi), "steps_an_iteration": steps,
                           "batched": ops.count("LDS") < steps,
                           "instructions_a_step": len(fast) / steps,
                           "slow_paths_skipped": skipped,
                           "carried_cycles_a_step": chain_cycles(fast, lat, False) / steps,
                           "in_order_cycles_a_step": chain_cycles(fast, lat, True) / steps})
    return {"loops": chains, "passes": {"forward": 3, "reverse": 3}} if chains else {}


def chain_limit_ms(chain: dict, points: int, iterations: int, clock_hz: float,
                   key: str) -> float:
    """A refinement's chains at ``key`` cycles a step of the slowest batched
    chain loop (vector loads of the increments: the whole batches; the rest
    are under a batch a pass): ``iterations`` forward and reverse passes
    over ``points`` steps and one more forward pass (the final loss), at
    ``clock_hz``."""
    cycles = max(loop[key] for loop in chain["loops"] if loop["batched"])
    fwd, rev = chain["passes"]["forward"], chain["passes"]["reverse"]
    return 1e3 * points * cycles * ((iterations + 1) * fwd + iterations * rev) / clock_hz


_REGISTER = re.compile(r"^-?\|?R(\d+)")


def ffma_reads(ins: list) -> dict:
    """Of the FFMAs in ``ins`` (address, predicate, opcode, operands, in
    order): how many read two registers of one bank from the register file
    (``bank_conflicts``, under the model of two banks by the register
    number's parity; a source the previous instruction marked ``.reuse``
    in the same slot comes from the reuse cache instead), how many take a
    source from the reuse cache (``reused``), and each FFMA's sources."""
    out, prev = {"bank_conflicts": 0, "reused": 0, "ffma_sources": []}, []
    for _, _, op, args in ins:
        ops = [a.strip() for a in args.split(",")][1:]
        if op.split(".")[0] == "FFMA":
            out["ffma_sources"].append(", ".join(ops))
            read, cached = set(), False
            for slot, o in enumerate(ops):
                m = _REGISTER.match(o)
                if m and slot < len(prev) and prev[slot] == f"R{m[1]}.reuse":
                    cached = True
                elif m:
                    read.add(int(m[1]))
            out["bank_conflicts"] += len({r % 2 for r in read}) < len(read)
            out["reused"] += cached
        prev = ops
    return out


def sass_loops(library: pathlib.Path, dump: pathlib.Path, smem: dict) -> dict:
    """The SASS of SASS_KERNELS in ``library`` (written to ``dump``) and,
    for each kernel, every loop: the range from a backward branch's target
    to the branch, its instruction count and its opcodes (the mnemonic
    before the first dot), innermost loops first; and its resource usage
    and ``occupancy`` at the dynamic shared memory ``smem`` gives it (0
    where it names none)."""
    cuobjdump = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    usage = resource_usage(cuobjdump, library)
    text = subprocess.run([str(cuobjdump), "-sass", str(library)], capture_output=True,
                          text=True, timeout=600, check=True).stdout
    chunks = re.split(r"\n\s*Function : (\S+)\n", text)
    names = subprocess.run(["c++filt"], input="\n".join(chunks[1::2]), text=True,
                           capture_output=True, timeout=60, check=True).stdout.splitlines()
    out, kept = {}, []
    for name, body in zip(names, chunks[2::2]):
        short = _short(name)
        if short not in SASS_KERNELS:
            continue
        kept.append(f"// {short}\n{body}")
        ins = [(int(a, 16), pred, op, args)
               for a, pred, op, args in _INSTRUCTION.findall(body)]
        loops = []
        for addr, _, op, args in ins:
            m = re.search(r"0x([0-9a-f]+)", args) if op.startswith("BRA") else None
            if m and int(m[1], 16) <= addr:
                lo = int(m[1], 16)
                body_ops = [o.split(".")[0] for a, _, o, _ in ins if lo <= a <= addr]
                fast, paths = fast_path(ins, lo, addr)
                loops.append({"from": hex(lo), "to": hex(addr), "instructions": len(body_ops),
                              "opcodes": dict(Counter(body_ops).most_common()),
                              "fast_path": {"instructions": len(fast), "local_paths": paths,
                                            "opcodes": dict(Counter(fast).most_common())}})
                if short == "alu_chain_kernel":
                    loops[-1].update(ffma_reads([i for i in ins if lo <= i[0] <= addr]))
        res = usage.get(short, {})
        out[short] = {"instructions": len(ins), "resources": res,
                      "occupancy": occupancy(res.get("REG", 0), SASS_KERNELS[short],
                                             smem.get(short, 0)),
                      "loops": sorted(loops, key=lambda x: x["instructions"])}
    dump.parent.mkdir(exist_ok=True)
    dump.write_text("\n".join(kept))
    return out


def digest(t) -> str:
    """The first 16 hex digits of the sha256 of a tensor's bytes."""
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def hold_clocks(fn, seconds: float = 2.0) -> dict:
    """Run ``fn`` back to back (100 launches, then a synchronize) for
    ``seconds`` while nvidia-smi reads the SM clock and the power draw as
    often as it can: the median, least and most of the readings taken
    wholly inside the run, after its first 0.2 s, and their count."""
    import torch

    readings, stop = [], threading.Event()

    def read() -> None:
        while not stop.is_set():
            t0 = time.perf_counter()
            out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                  "--format=csv,noheader,nounits"], capture_output=True,
                                 text=True, timeout=60).stdout.split(",")
            readings.append((t0, time.perf_counter(), *map(float, out[:2])))

    fn()
    torch.cuda.synchronize()
    reader = threading.Thread(target=read)
    reader.start()
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
    end = time.perf_counter()
    stop.set()
    reader.join()
    kept = [r for r in readings if r[0] >= start + 0.2 and r[1] <= end]
    return {"readings": len(kept), **{
        name: {"median": statistics.median(v), "min": min(v), "max": max(v)}
        for name, v in (("sm_mhz", [r[2] for r in kept]), ("power_w", [r[3] for r in kept]))
        if v}}


def demo_tts(root: pathlib.Path, seeds: int = 8, passes: int = 3) -> dict:
    """The ``--demo-tts`` reading (see the module docstring)."""
    import numpy as np
    import torch

    from cudasbmp_torch import KGMT, KGMTConfig, Scenario

    planner = KGMT(KGMTConfig(), device="cuda")
    planner.plan(Scenario.demo(), seed=100)
    walls, results = [], []
    for _ in range(passes):
        for seed in range(seeds):
            r = planner.plan(Scenario.demo(), seed=seed)
            walls.append(r.wall_time_s)
            results.append([r.solved, r.iterations, r.tree_size, r.cost])
    out = {"solves": len(walls), "tts_p50_s": float(np.percentile(walls, 50)),
           "tts_p90_s": float(np.percentile(walls, 90)), "tts_min_s": min(walls),
           "tts_max_s": max(walls),
           "results_digest": hashlib.sha256(json.dumps(results).encode()).hexdigest()[:16]}
    if (root / "cudasbmp_torch" / "utils" / "profiling.py").exists():
        from cudasbmp_torch.utils import profiling

        dev, n = torch.device("cuda", 0), 20_000

        def scope():
            with profiling.phase_scope("kgmt_expand", dev):
                pass

        def push_pop():
            torch.cuda.nvtx.range_push("kgmt_expand")
            torch.cuda.nvtx.range_pop()

        out["phase_scope_us"] = timeit.timeit(scope, number=n) / n * 1e6
        out["nvtx_push_pop_us"] = timeit.timeit(push_pop, number=n) / n * 1e6
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=pathlib.Path,
                    default=pathlib.Path(__file__).resolve().parent)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--no-groups", action="store_true",
                    help="skip the per-G table")
    ap.add_argument("--group-lanes", help="the per-G table's widths, comma-separated "
                    "(default: chip_smoke.SPLIT_WIDTHS)")
    ap.add_argument("--group-splits", help="the per-G table's G, comma-separated "
                    "(default: every G)")
    ap.add_argument("--only", help="time only the rows whose names start with one "
                    "of these comma-separated prefixes")
    ap.add_argument("--sass", action="store_true",
                    help="dump the SASS of B6, B5, P1a, P1b, P2 and the whole "
                    "refinement, count the instructions of their loops, and give the "
                    "refinement's chain limit")
    ap.add_argument("--clocks", action="store_true",
                    help="read the SM clock and power draw while each row runs 2 s")
    ap.add_argument("--demo-tts", action="store_true",
                    help="also time 24 demo solves and a phase scope's host cost")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_kernels: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import cudasbmp_torch
    from cudasbmp_torch import KGMTConfig, rng
    from cudasbmp_torch.config import Scenario
    from cudasbmp_torch.ops import chains_cuda as cc
    from cudasbmp_torch.ops import rollout_cuda as rc
    from cudasbmp_torch.probes import roofline as rf
    from cudasbmp_torch.probes import throughput as tp
    from cudasbmp_torch.systems.bicycle import KinematicBicycle

    # this script's helpers, and the timing module of this script's own
    # checkout by its path; cudasbmp_torch stays the one imported from root
    here = pathlib.Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    from chip_smoke import (EXTENSION_BUCKETS, RAGGED_PROGRAM_ROWS, SPLIT_WIDTHS,
                            SWEEP_SHAPE, demo_batch, problem_batch, ragged_chain_inputs,
                            refine_inputs)

    spec = importlib.util.spec_from_file_location(
        "_timing", here / "cudasbmp_torch" / "probes" / "timing.py")
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)
    device_ms, time_ms = timing.device_ms, timing.time_ms

    if not pathlib.Path(cudasbmp_torch.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"time_kernels: imported {cudasbmp_torch.__file__}, not {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    cfg = KGMTConfig()
    system = KinematicBicycle(agent_length=cfg.agent_length)
    obstacles = torch.tensor(Scenario.demo().padded_obstacles(cfg.max_obstacles)[0],
                             device=dev)
    kw = dict(num_disc=cfg.num_disc, width=cfg.width, height=cfg.height)
    key = rng.key(12345, dev)
    fp = dict(kw, footprint=(0.5, 0.25))
    runs = {}
    for B in (cfg.rollouts_per_iter, 32_768, 2 ** 17):
        x0, ctrl = demo_batch(B, 1, dev)
        runs[f"b1_{B}_ms"] = lambda x0=x0, ctrl=ctrl: rc.rollout_cuda(
            system, x0, ctrl, obstacles, **kw)
        runs[f"b2_{B}_ms"] = lambda x0=x0: rc.sample_and_rollout_cuda(
            system, key, x0, obstacles, **kw)
    x0, _ = demo_batch(2 ** 17, 1, dev)
    runs["b2_fast_131072_ms"] = lambda x0=x0: rc.sample_and_rollout_cuda(
        system, key, x0, obstacles, **kw, fast_math=True)
    groups = hasattr(rc, "lanes_per_rollout")  # thread groups and split=
    one = dict(split=1) if groups else {}
    x0, ctrl = demo_batch(cfg.rollouts_per_iter, 1, dev)
    runs["b3_4096_ms"] = lambda x0=x0, ctrl=ctrl: rc.rollout_cuda(
        system, x0, ctrl, obstacles, **fp)
    runs["b4_4096_ms"] = lambda x0=x0, ctrl=ctrl: rc.rollout_cuda(
        system, x0, ctrl, obstacles, **fp, fast_math=True)
    fx0, fctrl = demo_batch(32, 2, dev)
    runs["floor_b1_32_ms"] = lambda: rc.rollout_cuda(system, fx0, fctrl, obstacles,
                                                     **kw, **one)
    none = obstacles[:0]
    for tag, n, obs in (("n1_k0", 1, none), ("n10_k0", 10, none), ("n1_k8", 1, obstacles)):
        runs[f"floor_{tag}_ms"] = lambda n=n, obs=obs: rc.rollout_cuda(
            system, fx0, fctrl, obs, **dict(kw, num_disc=n), **one)
    if hasattr(rc, "rollout_batched_cuda"):
        nb, nr, nk = SWEEP_SHAPE
        bsys, bx0, bc, bobs = problem_batch("bicycle", nb, nr, nk, 98, dev)
        bkeys = rng.split(rng.key(8, dev), nb)
        runs["b6_ms"] = lambda: rc.rollout_batched_cuda(bsys, bx0, bc, bobs, **kw)
        runs["b6_rng_ms"] = lambda: rc.sample_and_rollout_batched_cuda(
            bsys, bkeys, bx0, bobs, **kw)
        runs["b6_options_ms"] = lambda: rc.rollout_batched_cuda(
            bsys, bx0, bc, bobs, **fp, fast_math=True)
        wide = problem_batch("bicycle", 256, nr, nk, 97, dev)
        runs["b6_256x128_ms"] = lambda: rc.rollout_batched_cuda(*wide, **kw)
    # B5 at the cull table's shape and its floor; P1b at the calibration shape
    dense = torch.tensor(Scenario.dense(24).obstacles, device=dev)
    gx0 = tp.start_states(2 ** 17, dev, grouped=True)
    for W in (0, 1, 2, 4, 5):
        runs[f"b5_W{W}_ms"] = lambda W=W: rc.sample_and_rollout_bicycle_cuda(
            key, gx0, dense, **kw, cull=W)
    rx0 = tp.start_states(2 ** 17, dev, grouped=False)
    for W in (1, 4):
        runs[f"b5_random_W{W}_ms"] = lambda W=W: rc.sample_and_rollout_bicycle_cuda(
            key, rx0, dense, **kw, cull=W)
    runs["b5_n40_W1_ms"] = lambda: rc.sample_and_rollout_bicycle_cuda(
        key, gx0, dense, **dict(kw, num_disc=40), cull=1)
    near = gx0[:32].contiguous()
    runs["floor_b5_32_ms"] = lambda: rc.sample_and_rollout_cuda(
        KinematicBicycle(), key, near, dense, **kw, cull=4)
    cx = rf.chain_inputs(dev)
    for op in ("cos", "sin", "tan"):
        runs[f"p1b_{op}_ms"] = lambda op=op: cc.trans_chain_cuda(cx, rf.TRANS_CHAIN, op)
    runs["p1a_ms"] = lambda: cc.alu_chain_cuda(cx, rf.ALU_CHAIN)
    gathers = {rows: rf.chain_inputs(dev, rows)[1:] for rows in rf.GATHER_ROWS}
    for rows, (tbl, idx) in gathers.items():
        runs[f"p2_{rows}_ms"] = lambda tbl=tbl, idx=idx: cc.gather_chain_cuda(
            tbl, idx, rf.GATHER_CHAIN)
    refine_points = {}
    from cudasbmp_torch.ops import refine_cuda as rfc
    if hasattr(rfc, "refine_adam_cuda"):  # the whole refinement, RefineConfig()
        import numpy as np

        from cudasbmp_torch.refine import RefineConfig, _refine_core

        rcfg = RefineConfig()

        def adam(x0, goal, obs, c0, mask):
            return _refine_core(system, cfg, rcfg, x0, goal, obs, c0, mask)

        demo = Scenario.demo()
        path = cudasbmp_torch.KGMT(cfg, device=dev).plan(demo).path
        one = [torch.tensor(np.ascontiguousarray(a), device=dev) for a in (
            path[None, 0, :4], demo.goal[None, :2], demo.obstacles, path[None, 1:, 4:])]
        one.append(torch.ones((1, len(path) - 1), dtype=torch.bool, device=dev))
        runs["refine_demo_ms"] = lambda: adam(*one)
        # 128 problems of 2 to 24 real edges (the quality pipeline's), one whole
        _, (rx0, rc0, _, rgoal, robs) = refine_inputs("bicycle", 128, 24, cfg.num_disc, 14,
                                                      dev, False, False)
        real = np.random.default_rng(14).integers(2, 25, 128)
        real[0] = 24
        rmask = torch.tensor(np.arange(24)[None] < real[:, None], device=dev)
        runs["refine_128x24_ms"] = lambda: adam(rx0, rgoal, robs, rc0, rmask)
        runs["refine_1x24_ms"] = lambda: adam(rx0[:1], rgoal[:1], robs, rc0[:1], rmask[:1])
        refine_points = {"demo": (len(path) - 1) * cfg.num_disc, "1x24": 24 * cfg.num_disc}
    only = tuple(args.only.split(",")) if args.only else ()
    splits = {}
    if groups:
        for name, fn in list(runs.items()):  # the G each launch takes
            if only and not name.startswith(only):
                continue
            rc.reset_launch_counts()
            fn()
            splits[name] = dict(sum((w.splits for w in rc.WRAPPERS), Counter()))
        widths = (() if args.no_groups else _ints(args.group_lanes) or SPLIT_WIDTHS)
        for B in widths:
            x0, ctrl = demo_batch(B, 1, dev)
            for tag, opts in (("exact", kw), ("footprint", fp)):
                for G in _ints(args.group_splits) or rc.SPLITS:
                    runs[f"g{G}_{tag}_{B}_ms"] = (
                        lambda x0=x0, ctrl=ctrl, opts=opts, G=G: rc.rollout_cuda(
                            system, x0, ctrl, obstacles, **opts, split=G))
        for P in () if args.no_groups else EXTENSION_BUCKETS:
            batch = problem_batch("bicycle", P, nr, nk, 98, dev)
            for G in _ints(args.group_splits) or rc.SPLITS:
                runs[f"g{G}_b6_{P}x{nr}_ms"] = (
                    lambda batch=batch, G=G: rc.rollout_batched_cuda(*batch, **kw, split=G))
    if only:
        runs = {k: v for k, v in runs.items() if k.startswith(only)}
    times = {}
    for name, fn in runs.items():
        readings = [device_ms(fn) for _ in range(args.reps)]
        times[name] = {"device_ms": [t.ms for t in readings],
                       "regular": [t.regular for t in readings],
                       "launch_ms": [time_ms(fn) for _ in range(args.reps)]}
    flagged = [name for name, t in times.items() if min(t["regular"]) < 3]
    result = {"card": smi, "root": str(root), "splits": splits, "times": times,
              "flagged": flagged, "digests": {}}
    digests = result["digests"]
    if "p1a_ms" in runs:
        for links in (64, rf.ALU_CHAIN):
            digests[f"p1a_{links}"] = digest(cc.alu_chain_cuda(cx, links))
        digests["p1a_ragged"] = digest(cc.alu_chain_cuda(
            ragged_chain_inputs(dev), 64, program_rows=RAGGED_PROGRAM_ROWS))
    for rows, (tbl, idx) in gathers.items():
        if f"p2_{rows}_ms" in runs:
            digests[f"p2_{rows}"] = digest(cc.gather_chain_cuda(tbl, idx, rf.GATHER_CHAIN))
            digests[f"p2_{rows}_ragged"] = digest(cc.gather_chain_cuda(
                *ragged_chain_inputs(dev, rows), rf.GATHER_CHAIN))
    if args.demo_tts:
        result["demo_tts"] = demo_tts(root)
    if args.clocks:
        result["clocks"] = {name: hold_clocks(fn) for name, fn in runs.items()}
    if args.sass:
        from cudasbmp_torch.ops import _build

        # B5's dynamic shared memory at the cull table: 24 boxes and, where
        # the checkout keeps one, its window store
        store = rc.cull_state_bytes(False) if hasattr(rc, "cull_state_bytes") else 0
        b5 = [k for k in SASS_KERNELS if k.endswith("true>")]
        # P2 at 1,024 rows: the checkout's block and slice (a block of 256
        # threads and the bare slice before they were planned)
        if hasattr(cc, "gather_geometry"):
            SASS_KERNELS["gather_chain_kernel"] = cc.gather_geometry(0, 1024)[0]
            slice_bytes = cc.gather_slice_bytes(1024)
        else:
            slice_bytes = 4 * 32 * 1024
        result["sass"] = sass_loops(_build.build()[0],
                                    here / "chiprun_out" / f"sass_{root.name}.txt",
                                    {**{k: 16 * 24 + store for k in b5},
                                     "gather_chain_kernel": slice_bytes})
        if REFINE_ADAM in result["sass"]:  # the whole refinement's chain limit
            lat = result["latency"] = measure_latencies(here / "chiprun_out")
            chain = result["refine_chain"] = refine_chain(_build.build()[0],
                                                          lat["cycles_a_link"])
        mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                    "--format=csv,noheader,nounits"], capture_output=True,
                                   text=True, timeout=60, check=True).stdout.split()[0])
        sms, elems = rc.sm_count(0), cx.numel()
        chain = result.get("refine_chain", {})
        if chain:
            chain["limit_ms"] = {
                tag: {key: chain_limit_ms(chain, points, 400, mhz * 1e6, key)
                      for key in ("carried_cycles_a_step", "in_order_cycles_a_step")}
                for tag, points in refine_points.items()}
            chain["points"], chain["clock_mhz"] = refine_points, mhz
        result["p1b_issue"] = p1b_issue(result["sass"], elems, rf.TRANS_CHAIN, sms, mhz * 1e6)
        result["p1b_issue"]["clock_mhz"] = mhz
        # P1a and P2 at the top clock and, where read, at the clock held
        for key, fn, links, row in (("p1a_issue", p1a_issue, rf.ALU_CHAIN, "p1a_ms"),
                                    ("p2_issue", p2_issue, rf.GATHER_CHAIN, "p2_1024_ms")):
            result[key] = dict(fn(result["sass"], elems, links, sms, mhz * 1e6),
                               clock_mhz=mhz)
            held = result.get("clocks", {}).get(row, {}).get("sm_mhz")
            if held:
                result[key]["held"] = dict(fn(result["sass"], elems, links, sms,
                                              held["median"] * 1e6),
                                           clock_mhz=held["median"])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
