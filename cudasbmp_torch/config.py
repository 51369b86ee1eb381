"""Planner and scenario configuration (numpy only).

The counterpart of ``cudasbmp_tpu/config.py`` with identical field names and
defaults, kept as its own module because importing anything from
``cudasbmp_tpu`` pulls in JAX (its ``__init__`` imports the planner). A parity
test (tests/test_torch_config.py) holds the two against each other.

Differences from the JAX config:

- ``rollout_backend`` takes ``auto``/``cuda`` (the hand-written CUDA rollout
  kernel), ``cuda_rng`` (the kernel that also draws its controls with an
  in-kernel Philox stream) or ``torch`` (the plain PyTorch rollout, kept for
  kernel-versus-plain comparisons). As the JAX package's ``jnp`` backend,
  ``torch`` ignores ``fast_math``, which changes only the kernel backends.
- YAML files are read by a small strict reader of flat ``key: value``
  scalars (``read_flat_yaml``), not pyyaml, which the GPU machine lacks.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
from typing import Any

import numpy as np

SAMPLE_DIM = 7  # x, y, theta, v, accel, steering, duration
STATE_DIM = 4  # x, y, theta, v
WORKSPACE_DIM = 2  # planar workspace

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

    @property
    def footprint(self) -> tuple[float, float] | None:
        """Narrow-phase body half extents (half_len, half_wid), or None when
        ``footprint_width`` is 0 (broad phase only). The body is
        ``agent_length`` long and ``footprint_width`` wide."""
        if self.footprint_width <= 0.0:
            return None
        return (self.agent_length / 2.0, self.footprint_width / 2.0)

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

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "KGMTConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    @classmethod
    def from_file(cls, path: str) -> "KGMTConfig":
        """Load from a flat YAML file (``read_flat_yaml``) or JSON."""
        with open(path) as f:
            text = f.read()
        if path.endswith((".yaml", ".yml")):
            data = read_flat_yaml(text, path)
        else:
            data = json.loads(text)
        return cls.from_dict(data)

    def to_file(self, path: str) -> None:
        """Write YAML (one ``key: value`` line per field, readable by
        ``from_file`` and by pyyaml alike) or JSON."""
        if path.endswith((".yaml", ".yml")):
            text = "".join(f"{k}: {_yaml_scalar(v)}\n"
                           for k, v in self.to_dict().items())
        else:
            text = json.dumps(self.to_dict(), indent=2)
        with open(path, "w") as f:
            f.write(text)


# YAML 1.1 plain scalars as pyyaml's safe loader resolves them; the int and
# float forms beyond these (octal, hex, binary, base 60) raise.
_YAML_NULL = re.compile(r"~|null|Null|NULL|")
_YAML_TRUE = re.compile(r"yes|Yes|YES|true|True|TRUE|on|On|ON")
_YAML_FALSE = re.compile(r"no|No|NO|false|False|FALSE|off|Off|OFF")
_YAML_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)")
_YAML_FLOAT = re.compile(r"[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                         r"|\.[0-9_]+(?:[eE][-+][0-9]+)?")
_YAML_INF = re.compile(r"([-+]?)\.(?:inf|Inf|INF)")
_YAML_NAN = re.compile(r"\.(?:nan|NaN|NAN)")
_YAML_OTHER_NUMBER = re.compile(r"[-+]?(?:0b[0-1_]+|0[0-7_]+|0x[0-9a-fA-F_]+"
                                r"|[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?)")
_YAML_KEY = re.compile(r"([A-Za-z_][A-Za-z0-9_]*):(?:\s+(.*))?")


def read_flat_yaml(text: str, name: str = "<yaml>") -> dict:
    """Parse a flat YAML mapping of scalars: ``key: value`` lines, comments
    and blank lines, as the repo's ``systems/*.yaml`` are written. Values
    resolve as pyyaml's safe loader resolves them (null, bool, decimal int,
    float, quoted or plain string). Anything else (nesting, lists, flow
    collections, anchors, tags, block scalars, several documents, repeated
    keys) raises ``ValueError``."""
    out: dict[str, Any] = {}
    for n, line in enumerate(text.splitlines(), 1):
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            continue
        m = _YAML_KEY.fullmatch(line.rstrip())
        if m is None:
            raise ValueError(f"{name}:{n}: not a flat 'key: value' line: {line!r}")
        key, value = m.group(1), _yaml_value(m.group(2) or "", f"{name}:{n}")
        if key in out:
            raise ValueError(f"{name}:{n}: key {key!r} repeated")
        out[key] = value
    return out


def _yaml_value(raw: str, where: str) -> Any:
    if raw[:1] in ("'", '"'):
        if raw[0] == '"':  # YAML's double-quoted escapes are JSON's
            value, end = json.JSONDecoder().raw_decode(raw)
        else:  # '' is one quote inside '...'
            m = re.match(r"'((?:[^']|'')*)'", raw)
            if m is None:
                raise ValueError(f"{where}: unterminated string {raw!r}")
            value, end = m.group(1).replace("''", "'"), m.end()
        rest = raw[end:].strip()
        if rest and not rest.startswith("#"):
            raise ValueError(f"{where}: text after a quoted string: {raw!r}")
        return value
    m = re.search(r"\s#", raw)
    value = (raw[:m.start()] if m else raw).strip()
    if value[:1] in tuple("[]{}&*!|>%@`,?") or value[:2] in ("- ", ":") or (
            value == "-") or ": " in value:
        raise ValueError(f"{where}: only flat scalars are read: {value!r}")
    if _YAML_NULL.fullmatch(value):
        return None
    if _YAML_TRUE.fullmatch(value):
        return True
    if _YAML_FALSE.fullmatch(value):
        return False
    if _YAML_INT.fullmatch(value):
        return int(value.replace("_", ""))
    if _YAML_FLOAT.fullmatch(value):
        return float(value.replace("_", ""))
    m = _YAML_INF.fullmatch(value)
    if m:
        return float(m.group(1) + "inf")
    if _YAML_NAN.fullmatch(value):
        return float("nan")
    if _YAML_OTHER_NUMBER.fullmatch(value):
        raise ValueError(f"{where}: number form not read here: {value!r}")
    return value


def _yaml_scalar(v: Any) -> str:
    """A field value as a YAML 1.1 scalar that reads back to itself."""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        # YAML 1.1 needs a dot in a float ('1e-07' would read as a string)
        return r.replace("e", ".0e") if "." not in r else r
    return json.dumps(str(v))


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

    @classmethod
    def dense(cls, num_obstacles: int = 24, seed: int = 0) -> "Scenario":
        """The dense-obstacle workload of the JAX package (BASELINE.json
        config 3): a jittered side x side grid of boxes over [2, 18]^2 with
        about one unit of corridor between neighbours, start (1, 1), goal
        (19, 19). The same boxes as cudasbmp_tpu's for the same seed."""
        rng = np.random.default_rng(seed)
        side = int(np.ceil(np.sqrt(num_obstacles)))
        boxes = []
        pitch = 16.0 / side
        for i in range(side):
            for j in range(side):
                if len(boxes) >= num_obstacles:
                    break
                cx = 2.0 + (i + 0.5) * pitch + rng.uniform(-0.15, 0.15) * pitch
                cy = 2.0 + (j + 0.5) * pitch + rng.uniform(-0.15, 0.15) * pitch
                w = rng.uniform(0.35, 0.6) * pitch
                h = rng.uniform(0.35, 0.6) * pitch
                boxes.append([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2])
        init = np.zeros(SAMPLE_DIM, np.float32)
        init[0], init[1] = 1.0, 1.0
        goal = np.zeros(SAMPLE_DIM, np.float32)
        goal[0], goal[1] = 19.0, 19.0
        return cls(init=init, goal=goal, obstacles=np.asarray(boxes, np.float32))

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
