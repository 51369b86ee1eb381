"""CostProp chained-rollout probe (counterpart of
cudasbmp_tpu/planners/costprop.py, the reference's
src/planners/CostPropPlanner.cu): 1024 x 512 = 524,288 bicycle rollouts a
row, no collision checking, rows chained: lane j of row r starts from the
row r-1 output of its group leader, lane ``j - j % group_size`` (the
reference's block-shared parent, a 1024-thread block); ``group_size=1``
chains every lane through its own output. Draws and timing as
``NaivePlanner``.
"""

from __future__ import annotations

import dataclasses

import torch

from cudasbmp_torch import rng
from cudasbmp_torch.config import KGMTConfig, Scenario
from cudasbmp_torch.ops.rollout import rollout_unchecked
from cudasbmp_torch.planners.base import Planner
from cudasbmp_torch.planners.kgmt import resolve_device
from cudasbmp_torch.planners.naive import (
    PROBE_CONTROL_SPEC,
    PROBE_NUM_DISC,
    ProbeResult,
    timed_tree,
)
from cudasbmp_torch.systems.registry import get_system


class CostPropPlanner(Planner):
    def __init__(self, config: KGMTConfig | None = None, system=None,
                 width_rollouts: int = 1024 * 512, rows: int = 1,
                 group_size: int = 1024, device: torch.device | str = "cuda"):
        self.config = config or KGMTConfig()
        self.system = system or get_system(self.config.system)
        self.system = dataclasses.replace(self.system, control_spec=PROBE_CONTROL_SPEC)
        self.width_rollouts = width_rollouts
        self.rows = rows
        self.group_size = group_size
        self.device = resolve_device(device)
        W, G = width_rollouts, group_size
        # the group-leader lane of each lane
        self._leader = torch.arange(W, device=self.device) // G * G

    def _tree(self, root: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
        sys_, W = self.system, self.width_rollouts
        x0 = root[: sys_.state_dim].expand(W, sys_.state_dim)
        samples = []
        for _ in range(self.rows):
            key, sub = rng.split(key).unbind(0)
            controls = sys_.control_spec.sample(sub, (W,))
            x1 = rollout_unchecked(sys_, x0, controls, PROBE_NUM_DISC)
            samples.append(torch.cat([x1, controls], -1))
            x0 = x1[self._leader]  # chain from the group leader
        return torch.stack(samples)  # [rows, W, SAMPLE_DIM]

    def plan(self, scenario: Scenario, seed: int = 0) -> ProbeResult:
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
