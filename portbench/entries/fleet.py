"""``fleet``: ``MultiQueryPlanner(cfg).plan_batch`` on ``batch`` start/goal
pairs in the configuration's fixed map a call, each goal moved by
U(-goal_jitter, goal_jitter) in x and y (the CLI's ``multi``), each call
with its own planner seed; the answers are the batch's paths (a ``paths``
judge reads them)."""

from __future__ import annotations

import numpy as np

from portbench.generator import SEED_HI, fixed_scenario, launch_shape, pad_boxes, sample


class Entry:
    def __init__(self, config: dict, traffic: dict, device: str):
        from cudasbmp_torch import KGMTConfig
        from cudasbmp_torch.parallel import MultiQueryPlanner

        self.cfg = KGMTConfig(**config["planner"])
        self.start, self.goal, self.boxes = fixed_scenario(config)
        self.problems, self.jitter = traffic["batch"], traffic["goal_jitter"]
        self.planner = MultiQueryPlanner(self.cfg, device=device)

    def inputs(self, rng: np.random.Generator) -> dict:
        B = self.problems
        seed = int(rng.integers(0, SEED_HI))
        start = np.broadcast_to(np.asarray(self.start[:2], np.float32), (B, 2))
        goal = np.asarray(self.goal[:2], np.float32) + rng.uniform(
            -self.jitter, self.jitter, (B, 2))
        return {"seed": seed, "init": sample(start), "goal": sample(goal.astype(np.float32)),
                "boxes": np.ascontiguousarray(np.broadcast_to(self.boxes, (B, *self.boxes.shape)))}

    def call(self, x: dict) -> dict:
        res = self.planner.plan_batch(x["init"], x["goal"], pad_boxes(self.boxes),
                                      seed=x["seed"])
        return {"init": x["init"], "goal": x["goal"], "boxes": x["boxes"],
                "solved": res.solved, "cost": res.costs, "paths": res.paths,
                "lengths": res.path_lengths}

    def launch_shape(self) -> dict:
        return launch_shape(self.cfg, len(self.boxes), True, self.problems)
