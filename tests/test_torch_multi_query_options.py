"""The vmapped multi-query planner with the options (footprint, fast math,
goal bias; fixed waves with retry on stall) against the port's single
solve bit for bit, and a done problem frozen while the others run
(helpers: tests/test_torch_multi_query_batch.py)."""

import numpy as np
import pytest
import torch

from cudasbmp_torch import rng
from cudasbmp_torch.config import KGMTConfig
from cudasbmp_torch.parallel import MultiQueryPlanner
from cudasbmp_torch.parallel import multi_query as mq
from test_torch_multi_query_batch import (
    SMALL,
    STATE_FIELDS,
    assert_equals_single_solves,
    demo_batch,
    waves,
)

torch.set_num_threads(2)


@pytest.mark.parametrize("name,options", [
    ("all_options", dict(footprint_width=0.5, fast_math=True, goal_bias=0.25)),
    ("fixed_waves_and_retry", dict(adaptive_waves=False, rollouts_per_iter=512,
                                   max_tree_size=8192, keep_frontier_on_stall=True)),
])
def test_each_problem_equals_the_single_solve_with_options(name, options):
    cfg = KGMTConfig(**{**SMALL, **options})
    inits, goals, obstacles = demo_batch(3, jitter_seed=1)
    planner = MultiQueryPlanner(cfg, device="cpu")
    res = planner.plan_batch(inits, goals, obstacles, seed=3)
    singles = assert_equals_single_solves(planner, res, inits, goals, obstacles, 3)
    assert planner.last_state.trips == max(waves(cfg, one) for one in singles)


def test_done_problems_stay_frozen_while_others_run():
    """Trip by trip: once a problem's condition is false its state never
    changes again, while the others keep running."""
    cfg = KGMTConfig(**SMALL)
    inits, goals, obstacles = demo_batch(3, jitter_seed=1)
    planner = MultiQueryPlanner(cfg, device="cpu")
    s = mq.init_batch_state(cfg, planner.grid, torch.tensor(inits),
                            rng.fold_in(rng.key(3), torch.arange(3)))
    g = torch.tensor(goals)
    o = torch.tensor(np.stack([obstacles] * 3))
    frozen: dict[int, dict] = {}
    fields = (*STATE_FIELDS, "tree_size", "frontier_lo", "itr", "cost_to_goal",
              "goal_node", "stalled")
    more, trips_running = True, []
    while more:
        more = mq.multi_query_trip(cfg, planner.system, planner.grid, g, o, s)
        trips_running.append(s.running.tolist())
        for b in range(3):
            snap = {f: getattr(s, f)[b].clone() for f in fields}
            if b in frozen:
                for f in fields:
                    assert torch.equal(snap[f], frozen[b][f]), (b, f, s.trips)
            elif not bool(s.running[b]):
                frozen[b] = snap
    assert sorted(frozen) == [0, 1, 2]
    assert any(sum(r) not in (0, 3) for r in trips_running)  # some froze early
