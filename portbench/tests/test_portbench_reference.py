"""The judge accepts a path that a replay of its edges produces and refuses
one that steps through a box, leaves the workspace, or was computed in a
lower precision."""

import numpy as np
import pytest
import torch

from portbench import cells
from portbench.reference import bicycle
from portbench.reference.paths import _box_depth, judge, lower_precision

CFG = cells.load_json(cells.HERE / "configs" / "demo.json")["planner"]
BOX = [8.0, 8.0, 10.0, 10.0]
LIMIT = cells.load_json(cells.HERE / "limits" / "demo.fleet64.json")["path_gap"]


def replayed(controls, start=(5.0, 5.0, 0.0, 0.0), dtype=torch.float32):
    """A path whose every state is the replay of its edge from the last."""
    state = torch.tensor(start, dtype=dtype)
    rows = [np.r_[start, 0.0, 0.0, 0.0]]
    for c in controls:
        c = torch.tensor(c, dtype=torch.float64)
        state = bicycle.edge_states(state, c.to(dtype), CFG["num_disc"],
                                    CFG["agent_length"])[-1]
        rows.append(np.r_[state.double().numpy(), c.numpy()])
    return np.asarray(rows, np.float32)


def answers(path, boxes=(BOX,), goal=None):
    goal = path[-1, :2] if goal is None else goal
    g = np.zeros(7, np.float32)
    g[:2] = goal
    return {"init": path[:1].copy(), "goal": g[None], "boxes": np.asarray([boxes], np.float32),
            "solved": np.array([True]), "cost": np.array([path[1:, -1].sum()], np.float32),
            "paths": path[None], "lengths": np.array([len(path)])}


STRAIGHT = [(1.0, 0.0, 0.5), (0.0, 0.1, 0.8), (-0.5, -0.2, 0.6)]


def test_a_replayed_path_passes():
    n = judge(answers(replayed(STRAIGHT)), CFG)
    assert n["path_gap"] < 1e-5 and n["missing"] == 0 and n["unsolved_share"] == 0


def test_a_step_through_a_box_fails():
    path = replayed(STRAIGHT)
    box = [path[1, 0] - 0.1, path[1, 1] - 0.1, path[1, 0] + 0.1, path[1, 1] + 0.1]
    n = judge(answers(path, boxes=(box,)), CFG)
    assert n["gaps"]["boxes"] > LIMIT and n["path_gap"] > LIMIT


def test_a_step_out_of_bounds_fails():
    path = replayed([(5.0, 0.0, 1.05)] * 3, start=(15.0, 5.0, 0.0, 0.0))
    n = judge(answers(path), CFG)
    assert n["gaps"]["bounds"] > 20 * LIMIT


# Two edges of a path that the planner served on an H100 (demo.fleet64): a
# steering near -pi/2 had spun the heading to -4.1e5 rad, where a float32
# heading moves in steps of 0.03. The float32 edge into the goal clears the
# box (3, 18, 6, 20) by 1.3e-3; its float64 replay ends 0.33 away and its
# seventh step reaches 0.20 into that box.
SPUN = np.array([
    [1.65605793e+01, 1.49979057e+01, -4.10345250e+05, 1.00821829e+01, 0.0, 0.0, 0.0],
    [7.98674822e+00, 1.60748425e+01, -4.10345875e+05, 1.03449583e+01,
     3.05214882e-01, -6.68091774e-02, 8.60946655e-01],
    [1.25322866e+00, 1.83109093e+01, -4.10345562e+05, 1.30888510e+01,
     4.46029758e+00, 3.07738781e-02, 6.15180969e-01]], np.float32)


def test_a_spun_heading_is_judged_in_the_replays_units():
    boxes = cells.load_json(cells.HERE / "configs" / "demo.json")["scenario"]["boxes"]
    n = judge(answers(SPUN, boxes=boxes), CFG)
    assert n["gaps"]["replay"] < 1e-5 and n["gaps"]["boxes"] < 1e-6
    assert n["path_gap"] < LIMIT / 100
    f64 = bicycle.edge_states(torch.tensor(SPUN[1, :4], dtype=torch.float64),
                              torch.tensor(SPUN[2, 4:], dtype=torch.float64),
                              CFG["num_disc"], CFG["agent_length"])
    depth = _box_depth(f64[None, :-1, :2], f64[None, 1:, :2],
                       torch.tensor([[[3.0, 18.0, 6.0, 20.0]]], dtype=torch.float64))
    assert 0.19 < float(depth) < 0.21


def test_an_altered_state_a_missed_goal_and_a_wrong_cost_fail():
    path = replayed(STRAIGHT)
    bent = path.copy()
    bent[2, 0] += 0.01
    assert judge(answers(bent), CFG)["gaps"]["replay"] > 1e-3
    far = answers(path, goal=path[-1, :2] + 1.0)
    assert judge(far, CFG)["gaps"]["goal"] > 0.9
    dear = answers(path)
    dear["cost"] = dear["cost"] + 0.5
    assert judge(dear, CFG)["gaps"]["cost"] > 0.1


def test_the_lower_precision_control_fails():
    ans = answers(replayed(STRAIGHT * 3), goal=None)
    control = lower_precision(ans, CFG)
    assert judge(control, CFG)["path_gap"] > 1e-3
    assert judge(ans, CFG)["path_gap"] < 1e-5


def test_missing_and_unreadable_answers_count():
    ans = answers(replayed(STRAIGHT))
    ans["attempted"] = 4
    assert judge(ans, CFG)["missing"] == 3
    ans = answers(replayed(STRAIGHT))
    ans["paths"][0, 1, 0] = np.nan
    assert judge(ans, CFG)["missing"] == 1
    ans = answers(replayed(STRAIGHT))
    ans["lengths"][0] = 99
    assert judge(ans, CFG)["missing"] == 1


@pytest.mark.parametrize("solved", [False])
def test_unsolved_answers_are_not_judged_but_counted(solved):
    ans = answers(replayed(STRAIGHT))
    ans["solved"][0] = solved
    ans["paths"][0, 1, 0] += 1.0
    n = judge(ans, CFG)
    assert n["path_gap"] == 0.0 and n["unsolved_share"] == 1.0
