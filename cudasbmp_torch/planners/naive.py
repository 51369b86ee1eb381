"""Naive random-tree probe (counterpart of cudasbmp_tpu/planners/naive.py,
the reference's src/planners/NaivePlanner.cu): ``rows`` rows of
``width_rollouts`` kinematic-bicycle rollouts, every row from the root, with
no collision checking, the probe's narrower controls (a ~ U(-2.5, 2.5),
steering ~ U(-pi/2, pi/2), duration ~ U(0, 0.3)) and 20 Euler steps. Row r
draws its controls from the r-th split of ``key(seed)``, as the JAX scan
does, so the samples are the JAX planner's operator by operator. Timed as
the reference times its kernel: CUDA events around the propagation on the
card (host clock on the CPU), after a warm-up run.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from cudasbmp_torch import rng
from cudasbmp_torch.config import KGMTConfig, Scenario
from cudasbmp_torch.ops.rollout import rollout_unchecked
from cudasbmp_torch.planners.base import Planner
from cudasbmp_torch.planners.kgmt import resolve_device
from cudasbmp_torch.systems.base import ControlSpec
from cudasbmp_torch.systems.registry import get_system

PROBE_CONTROL_SPEC = ControlSpec(
    lo=(-2.5, -math.pi / 2, 0.0),
    hi=(2.5, math.pi / 2, 0.3),
)
PROBE_NUM_DISC = 20  # NaivePlanner.cu:70 / CostPropPlanner.cu:74 pass 20


@dataclasses.dataclass
class ProbeResult:
    samples: np.ndarray  # [rows, width, SAMPLE_DIM]
    num_rollouts: int
    kernel_time_s: float  # the propagation's time on the device
    rollouts_per_sec: float


def timed_tree(tree_fn, device: torch.device) -> tuple[torch.Tensor, float]:
    """Run ``tree_fn`` once to warm up, then once timed: CUDA events around
    it on the card, the host clock on the CPU. Returns (tree, seconds)."""
    tree_fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        tree = tree_fn()
        return tree, time.perf_counter() - t0
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    tree = tree_fn()
    end.record()
    end.synchronize()
    return tree, start.elapsed_time(end) / 1e3


class NaivePlanner(Planner):
    def __init__(self, config: KGMTConfig | None = None, system=None,
                 width_rollouts: int = 1024, rows: int = 10,
                 device: torch.device | str = "cuda"):
        self.config = config or KGMTConfig()
        self.system = system or get_system(self.config.system)
        # probes draw from their own control box (NaivePlanner.cu:31-35)
        self.system = dataclasses.replace(self.system, control_spec=PROBE_CONTROL_SPEC)
        self.width_rollouts = width_rollouts  # 32*32 in the reference
        self.rows = rows
        self.device = resolve_device(device)

    def _tree(self, root: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
        sys_, W = self.system, self.width_rollouts
        x0 = root[: sys_.state_dim].expand(W, sys_.state_dim)
        samples = []
        for _ in range(self.rows):
            key, sub = rng.split(key).unbind(0)
            controls = sys_.control_spec.sample(sub, (W,))
            x1 = rollout_unchecked(sys_, x0, controls, PROBE_NUM_DISC)
            samples.append(torch.cat([x1, controls], -1))
        return torch.stack(samples)  # [rows, W, SAMPLE_DIM]

    def plan(self, scenario: Scenario, seed: int = 0) -> ProbeResult:
        """The reference's NaivePlanner::plan just calls generateRandomTree
        (NaivePlanner.cu:18-23)."""
        return self.generate_random_tree(scenario, self.width_rollouts * self.rows,
                                         seed=seed)

    def generate_random_tree(self, scenario: Scenario, num_rollouts: int,
                             seed: int = 0) -> ProbeResult:
        root = torch.tensor(scenario.init, device=self.device)
        key = rng.key(seed, self.device)
        tree, dt = timed_tree(lambda: self._tree(root, key), self.device)
        n = self.width_rollouts * self.rows
        return ProbeResult(samples=tree.cpu().numpy(), num_rollouts=n,
                           kernel_time_s=dt, rollouts_per_sec=n / dt)
