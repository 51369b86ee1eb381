"""The one traffic generator: it reads a configuration's file and a traffic
mix's file, finds the mix's entry by name, makes every call's inputs and
drives the entry with them.

An entry is the module ``portbench/entries/<entry>.py`` (a traffic file's
``entry``); its class ``Entry(config, traffic, device)`` builds the
program's planner and has:

- ``problems``: the problems a call asks;
- ``inputs(rng)``: one call's inputs, drawn from a numpy Generator;
- ``call(x)``: drives the program once with them and returns its answers,
  a dict of numpy arrays with at least ``solved`` and ``cost`` (one a
  problem), and whatever the traffic's judge reads;
- ``launch_shape()``: a main-path rollout launch of the cell, the shape
  ``portbench/roofline.py`` counts.

The judge is ``portbench/judges/<judge>.py`` (a traffic file's ``judge``).
A new kind of call or of answer is a new file; nothing here names one.

Inputs: call ``i`` of a run draws from ``SeedSequence([seed, 0, i])``, so
the same seed gives the same inputs and every seed inputs of the same kind
and sizes. The warm-up call and the calls of a traced run's profiled slice
draw from the traffic file's ``fixed_seed`` (``[fixed_seed, 1, 0]`` and
``[fixed_seed, 2, j]``): the same work in every run, so that set-up and the
per-layer readings compare from run to run.
"""

from __future__ import annotations

import numpy as np

from portbench import cells

SAMPLE_DIM = 7
SEED_HI = 2**31 - 2**21  # planner seeds fit 32 bits with the restarts' offsets
PAD_TO = 8  # box sets are padded to a multiple of 8 with boxes that hit nothing


def stream(seed: int, tag: int, i: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed % 2**64, tag, i]))


def sample(xy: np.ndarray) -> np.ndarray:
    """[..., 2] positions as samples at rest, heading 0, no control."""
    out = np.zeros((*xy.shape[:-1], SAMPLE_DIM), np.float32)
    out[..., :2] = xy
    return out


def pad_boxes(boxes: np.ndarray) -> np.ndarray:
    """[..., K, 4] -> [..., K', 4], K' the next multiple of PAD_TO, the new
    rows (1, 1, 0, 0): empty boxes that no swept box overlaps."""
    k = boxes.shape[-2]
    extra = -k % PAD_TO
    pad = np.zeros((*boxes.shape[:-2], extra, 4), np.float32)
    pad[..., 0:2] = 1.0
    return np.concatenate([boxes.astype(np.float32), pad], axis=-2)


def fixed_scenario(config: dict) -> tuple[list, list, np.ndarray]:
    """The start, goal and boxes [K, 4] of a configuration whose scenario is
    ``fixed``."""
    scen = config["scenario"]
    if scen["kind"] != "fixed":
        raise ValueError(f"scenario kind {scen['kind']!r} is not fixed")
    return scen["start"], scen["goal"], np.asarray(scen["boxes"], np.float32)


def launch_shape(cfg, boxes: int, per_problem_boxes: bool, problems: int) -> dict:
    """The shape of one rollout launch of the planner configuration ``cfg``
    (a KGMTConfig) over ``problems`` problems of ``boxes`` boxes each."""
    return {"problems": problems, "lanes": cfg.rollouts_per_iter,
            "boxes": boxes + (-boxes % PAD_TO), "per_problem_boxes": per_problem_boxes,
            "sample": cfg.rollout_backend == "cuda_rng", "system": cfg.system,
            "footprint": cfg.footprint_width > 0, "fast_math": cfg.fast_math,
            "num_disc": cfg.num_disc}


class Traffic:
    """The calls of one run of ``cell`` (a ``cells.Cell``) under ``seed``,
    on ``device``."""

    def __init__(self, cell: cells.Cell, seed: int, device: str):
        module = cells.reader("entries", cell.traffic["entry"], cell.base)
        self.entry = module.Entry(cell.config, cell.traffic, device)
        self.seed, self.fixed_seed = seed, cell.traffic["fixed_seed"]

    def inputs(self, i: int) -> dict:
        """The window's call ``i``."""
        return self.entry.inputs(stream(self.seed, 0, i))

    def warm_inputs(self) -> dict:
        return self.entry.inputs(stream(self.fixed_seed, 1, 0))

    def slice_inputs(self, j: int) -> dict:
        """Call ``j`` of a traced run's profiled slice."""
        return self.entry.inputs(stream(self.fixed_seed, 2, j))

    def call(self, x: dict) -> dict:
        return self.entry.call(x)
