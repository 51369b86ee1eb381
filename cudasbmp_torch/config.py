"""Planner and scenario configuration (numpy only).

The counterpart of ``cudasbmp_tpu/config.py`` with identical field names and
defaults, kept as its own module because importing anything from
``cudasbmp_tpu`` pulls in JAX (its ``__init__`` imports the planner). A parity
test (tests/test_torch_config.py) holds the two against each other.

Differences from the JAX config:

- ``rollout_backend`` takes ``auto``/``cuda`` (the hand-written CUDA rollout
  kernel), ``cuda_rng`` (the kernel that also draws its controls with an
  in-kernel Philox stream) or ``torch`` (the plain PyTorch rollout, kept for
  kernel-versus-plain comparisons).
- ``unsupported_options()`` names the options this package does not run yet;
  the planner refuses a config that sets any of them.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

import numpy as np

SAMPLE_DIM = 7  # x, y, theta, v, accel, steering, duration
STATE_DIM = 4  # x, y, theta, v

ROLLOUT_BACKENDS = ("auto", "torch", "cuda", "cuda_rng")


@dataclasses.dataclass(frozen=True)
class KGMTConfig:
    """Static configuration of the KGMT planner; defaults reproduce the
    reference demo (see cudasbmp_tpu.config.KGMTConfig for every field)."""

    width: float = 20.0
    height: float = 20.0
    N: int = 16
    n: int = 8
    num_iterations: int = 100
    max_tree_size: int = 30000
    num_disc: int = 10
    agent_length: float = 1.0
    goal_threshold: float = 0.5
    fanout: int = 32
    rollouts_per_iter: int = 4096
    adaptive_waves: bool = True
    epsilon: float = 0.01
    system: str = "bicycle"
    seed: int = 0
    keep_frontier_on_stall: bool = True
    max_obstacles: int = 32
    stop_on_first_solution: bool = True
    goal_bias: float = 0.0
    goal_bias_k: int = 32
    footprint_width: float = 0.0
    exchange_frac: float = 0.25
    exchange_k: int = 64
    fast_math: bool = False
    need_path: bool = True
    rollout_backend: str = "auto"

    def __post_init__(self) -> None:
        problems = []
        for name, lo in (("N", 1), ("n", 1), ("num_disc", 1),
                         ("rollouts_per_iter", 1), ("fanout", 1),
                         ("max_tree_size", 1), ("max_obstacles", 1),
                         ("num_iterations", 0)):
            if getattr(self, name) < lo:
                problems.append(f"{name} must be >= {lo}")
        for name in ("width", "height", "goal_threshold", "agent_length"):
            if getattr(self, name) <= 0:
                problems.append(f"{name} must be > 0")
        if self.rollout_backend not in ROLLOUT_BACKENDS:
            problems.append(f"unknown rollout_backend {self.rollout_backend!r}")
        if not 0.0 <= self.goal_bias <= 1.0:
            problems.append("goal_bias must be in [0, 1]")
        if not 0.0 <= self.exchange_frac <= 1.0:
            problems.append("exchange_frac must be in [0, 1]")
        if self.exchange_k < 1:
            problems.append("exchange_k must be >= 1")
        if self.goal_bias_k < 1:
            problems.append("goal_bias_k must be >= 1")
        if self.footprint_width < 0:
            problems.append("footprint_width must be >= 0")
        if problems:
            raise ValueError("invalid KGMTConfig: " + "; ".join(problems))

    def unsupported_options(self) -> list[str]:
        """Options set to a value this package does not implement yet."""
        out = []
        if self.goal_bias > 0.0:
            out.append("goal_bias")
        if self.footprint_width > 0.0:
            out.append("footprint_width")
        if self.fast_math:
            out.append("fast_math")
        return out

    @property
    def r1_size(self) -> float:
        return self.width / self.N

    @property
    def r2_size(self) -> float:
        return self.width / (self.n * self.N)

    @property
    def num_r1(self) -> int:
        return self.N * self.N

    @property
    def num_r2(self) -> int:
        return self.N * self.N * self.n * self.n

    def replace(self, **kw: Any) -> "KGMTConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "KGMTConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    @classmethod
    def from_file(cls, path: str) -> "KGMTConfig":
        """Load from YAML (pyyaml, imported only here) or JSON."""
        with open(path) as f:
            text = f.read()
        if path.endswith((".yaml", ".yml")):
            import yaml

            data = yaml.safe_load(text) or {}
        else:
            data = json.loads(text)
        return cls.from_dict(data)


@dataclasses.dataclass
class Scenario:
    """A planning problem: start/goal samples + axis-aligned box obstacles
    (rows ``xmin, ymin, xmax, ymax``)."""

    init: np.ndarray  # [SAMPLE_DIM]
    goal: np.ndarray  # [SAMPLE_DIM]
    obstacles: np.ndarray  # [num_obstacles, 4]

    def __post_init__(self) -> None:
        self.init = np.asarray(self.init, dtype=np.float32).reshape(-1)[:SAMPLE_DIM]
        self.goal = np.asarray(self.goal, dtype=np.float32).reshape(-1)[:SAMPLE_DIM]
        self.init = np.pad(self.init, (0, SAMPLE_DIM - self.init.shape[0]))
        self.goal = np.pad(self.goal, (0, SAMPLE_DIM - self.goal.shape[0]))
        self.obstacles = np.asarray(self.obstacles, dtype=np.float32).reshape(-1, 4)

    @classmethod
    def demo(cls) -> "Scenario":
        """The reference demo: start (5,5), goal (2,18), 20x20 workspace,
        the 5 obstacles of default_obstacles()."""
        init = np.zeros(SAMPLE_DIM, np.float32)
        init[0], init[1] = 5.0, 5.0
        goal = np.zeros(SAMPLE_DIM, np.float32)
        goal[0], goal[1] = 2.0, 18.0
        return cls(init=init, goal=goal, obstacles=default_obstacles())

    def padded_obstacles(self, max_obstacles: int,
                         pad_to: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        """Pad the obstacle set to the smallest multiple of 8 that holds it
        (or ``pad_to``) with degenerate boxes (min 1, max 0) that never
        collide; returns (boxes, valid_mask)."""
        k = self.obstacles.shape[0]
        if k > max_obstacles:
            raise ValueError(f"{k} obstacles > max_obstacles={max_obstacles}")
        if pad_to is None:
            pad_to = min(max_obstacles, max(8, -(-k // 8) * 8))
        if pad_to < k:
            raise ValueError(f"pad_to={pad_to} < {k} obstacles")
        pad = np.zeros((pad_to - k, 4), np.float32)
        pad[:, 0:2] = 1.0
        boxes = np.concatenate([self.obstacles, pad], axis=0)
        mask = np.zeros(pad_to, bool)
        mask[:k] = True
        return boxes, mask


def default_obstacles() -> np.ndarray:
    """The 5 AABBs of configurations/obstacles/obstacles.csv."""
    return np.array(
        [
            [2.0, 2.0, 4.0, 4.0],
            [7.0, 2.0, 9.0, 5.0],
            [3.0, 18.0, 6.0, 20.0],
            [2.0, 10.0, 4.0, 12.0],
            [0.0, 6.0, 18.0, 8.0],
        ],
        dtype=np.float32,
    )
