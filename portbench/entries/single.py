"""``single``: one query a call, ``KGMT(cfg).plan(scenario, seed)`` on the
configuration's fixed scenario, each call with its own planner seed; the
answer is the query's path (a ``paths`` judge reads it)."""

from __future__ import annotations

import numpy as np

from portbench.generator import SAMPLE_DIM, SEED_HI, fixed_scenario, launch_shape


class Entry:
    problems = 1

    def __init__(self, config: dict, traffic: dict, device: str):
        from cudasbmp_torch import KGMT, KGMTConfig, Scenario

        self.cfg = KGMTConfig(**config["planner"])
        start, goal, self.boxes = fixed_scenario(config)
        self.planner = KGMT(self.cfg, device=device)
        self.scenario = Scenario(init=start, goal=goal, obstacles=self.boxes)

    def inputs(self, rng: np.random.Generator) -> dict:
        return {"seed": int(rng.integers(0, SEED_HI))}

    def call(self, x: dict) -> dict:
        r = self.planner.plan(self.scenario, seed=x["seed"])
        path = np.asarray(r.path, np.float32).reshape(1, -1, SAMPLE_DIM)
        return {"init": self.scenario.init[None], "goal": self.scenario.goal[None],
                "boxes": self.boxes[None], "solved": np.array([bool(r.solved)]),
                "cost": np.array([r.cost], np.float32), "paths": path,
                "lengths": np.array([path.shape[1]])}

    def launch_shape(self) -> dict:
        return launch_shape(self.cfg, len(self.boxes), False, 1)
