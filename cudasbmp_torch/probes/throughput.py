"""The rollout-throughput probe: valid 10-step bicycle rollouts per second
through the fused propagate-and-check kernels (counterpart of bench.py's
``measure_prop_throughput``, bench.py:43-144), and the culled broad phase's
table (counterpart of tools/r4_cull_bench.py).

Backends: ``torch`` (the plain ``rollout_batch``, JAX's ``jnp``), ``cuda``
(kernel B1 on threefry controls, JAX's ``pallas``) and ``cuda_rng`` (kernel
B2, controls drawn in the kernel, JAX's ``pallas_rng``); ``cull`` runs B5.
Wave i draws from ``fold_in(key(0), i)``; the waves' keys are derived in
one batched call before the clock starts (the JAX probe runs every wave in
one dispatch). Rates come from the card's
device time per wave (torch.profiler) and, labelled ``wall_``, from the
host clock over ``repeats`` waves; on the CPU only the wall rates exist.
"""

from __future__ import annotations

import time

import torch

from cudasbmp_torch import rng
from cudasbmp_torch._math import div
from cudasbmp_torch.config import Scenario
from cudasbmp_torch.ops import rollout_cuda as rc
from cudasbmp_torch.ops.rollout import rollout_batch
from cudasbmp_torch.planners.kgmt import resolve_device
from cudasbmp_torch.probes.timing import TIMED, device_ms
from cudasbmp_torch.systems.bicycle import KinematicBicycle

BATCH = 1 << 17
NUM_DISC = 10
WIDTH = HEIGHT = 20.0
BACKENDS = ("torch", "cuda", "cuda_rng")
REPEATS = 20
REPEATS_BY_BACKEND = {"torch": 20, "cuda": 100, "cuda_rng": 200}  # on the card
TRIALS = 4
CULL_ROWS = (
    ("demo_reference", dict(dense=False)),
    ("dense24_nocull", dict(dense=True)),
    ("dense24_grouped_cull1", dict(dense=True, grouped=True, cull=1)),
    ("dense24_grouped_cull2", dict(dense=True, grouped=True, cull=2)),
    ("dense24_grouped_cull4", dict(dense=True, grouped=True, cull=4)),
    ("dense24_grouped_cull5", dict(dense=True, grouped=True, cull=5)),
)


def morton_order(x0: torch.Tensor) -> torch.Tensor:
    """The lanes' order by the Z-order (Morton) code of their cell of the
    16 x 16 R1 grid (cells of 1.25), stable: a wave's lanes then come in
    spatially square neighbourhoods, as a sorted planner wave's do."""
    cx = torch.floor(div(x0[:, 0], 1.25)).to(torch.int32)
    cy = torch.floor(div(x0[:, 1], 1.25)).to(torch.int32)
    z = torch.zeros_like(cx)
    for b in range(4):
        z = z | (((cx >> b) & 1) << (2 * b)) | (((cy >> b) & 1) << (2 * b + 1))
    return torch.argsort(z, stable=True)


def start_states(batch: int, device, grouped: bool = False) -> torch.Tensor:
    """Starts spread over free space like a mid-solve frontier: uniform in
    [1, 19) from key(0), heading and speed 0; Morton-ordered with
    ``grouped``."""
    x0 = rng.uniform(rng.key(0, device), (batch, 4), 1.0, 19.0)
    x0[:, 2:] = 0.0
    return x0[morton_order(x0)].contiguous() if grouped else x0


def measure_prop_throughput(batch: int = BATCH, repeats: int | None = None,
                            backend: str = "torch", dense: bool = False,
                            fast_math: bool = False,
                            cull: bool | int | None = None,
                            grouped: bool = False,
                            device: torch.device | str = "cuda") -> dict:
    """Valid propagations per second: ``batch`` bicycle rollouts a wave on
    the demo's boxes (``dense``: ``Scenario.dense(24)``), ``repeats`` waves.
    ``fast_math`` and ``cull`` apply to the kernel backends; ``grouped``
    orders the starts by ``morton_order``. Returns the rates from device
    time (None on the CPU) and from the wall clock (the best of ``TRIALS``
    runs of the waves), the valid fraction over every timed wave and the
    device time per wave."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if repeats is None:
        repeats = REPEATS_BY_BACKEND[backend] if on_card else REPEATS
    system = KinematicBicycle()
    scenario = Scenario.dense(24) if dense else Scenario.demo()
    obstacles = torch.tensor(scenario.obstacles, device=dev)
    kw = dict(num_disc=NUM_DISC, width=WIDTH, height=HEIGHT)
    x0 = start_states(batch, dev, grouped)
    first = 123  # the JAX probe's first timed wave
    keys = rng.fold_in(rng.key(0, dev), torch.arange(first + TRIALS * repeats,
                                                     device=dev))

    def wave(i: int) -> torch.Tensor:
        k = keys[i]
        if backend == "cuda_rng":
            valid = rc.sample_and_rollout_bicycle_cuda(
                k, x0, obstacles, **kw, fast_math=fast_math, cull=cull)[2]
        else:
            controls = system.control_spec.sample(k, (batch,))
            if backend == "cuda":
                valid = rc.rollout_bicycle_cuda(x0, controls, obstacles, **kw,
                                                fast_math=fast_math, cull=cull)[1]
            else:
                valid = rollout_batch(system, x0, controls, NUM_DISC, obstacles,
                                      WIDTH, HEIGHT)[1]
        return valid.sum(dtype=torch.int32)

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize(dev)

    int(wave(0))  # warm-up: kernel build and load, allocator
    best_dt, total_valid = float("inf"), 0
    for trial in range(TRIALS):
        sync()
        t0 = time.perf_counter()
        total = torch.zeros((), dtype=torch.int32, device=dev)
        for i in range(repeats):
            total += wave(first + trial * repeats + i)
        total_valid += int(total)  # the host read ends the trial
        best_dt = min(best_dt, time.perf_counter() - t0)
    # a window of 2 waves where the glue launches hundreds of kernels a wave:
    # a window of thousands of records fills the profiler's buffer, and a
    # record at the boundary is lost (probes/timing.py)
    calls = TIMED if backend == "cuda_rng" else 2
    wave_ms, wave_regular, _ = (device_ms(lambda: wave(1), calls) if on_card
                                else (None, 0, 0))
    # over every timed wave, so it depends on the inputs, not on the timing
    valid_per_wave = total_valid / (TRIALS * repeats)
    return {
        "backend": backend, "dense": dense, "fast_math": fast_math,
        "cull": cull, "grouped": grouped, "batch": batch, "repeats": repeats,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "valid_fraction": valid_per_wave / batch,
        "wave_device_ms": wave_ms,
        "wave_regular_windows": wave_regular,
        "rollouts_per_sec": batch / (wave_ms / 1e3) if wave_ms else None,
        "valid_per_sec": valid_per_wave / (wave_ms / 1e3) if wave_ms else None,
        "wall_seconds": best_dt,
        "wall_rollouts_per_sec": batch * repeats / best_dt,
        "wall_valid_per_sec": valid_per_wave * repeats / best_dt,
    }


def cull_table(device: torch.device | str = "cuda", batch: int = BATCH,
               repeats: int | None = None) -> dict:
    """The six rows of tools/r4_cull_bench.py through ``cuda_rng``: the demo
    for reference, the dense-24 field without the broad phase, and with it
    on Morton-grouped lanes at 1, 2, 4 and 5 windows."""
    rows = []
    for label, kw in CULL_ROWS:
        r = measure_prop_throughput(batch, repeats, backend="cuda_rng",
                                    device=device, **kw)
        rows.append({"label": label, **{k: r[k] for k in (
            "rollouts_per_sec", "valid_per_sec", "wall_rollouts_per_sec",
            "wall_valid_per_sec", "valid_fraction", "wave_device_ms",
            "wave_regular_windows")}})
    rate = "rollouts_per_sec" if rows[0]["rollouts_per_sec"] is not None \
        else "wall_rollouts_per_sec"
    best = max((r for r in rows if r["label"].startswith("dense24_grouped")),
               key=lambda r: r[rate])
    return {"rows": rows, "rate": rate, "best_dense_grouped": best["label"],
            "fraction_of_demo": best[rate] / rows[0][rate]}
