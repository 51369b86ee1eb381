"""A run whose timed path is broken underneath comes out not correct, and a
sound one correct: each cell at a size the CPU runs, the look for a card
skipped, every other step of a run as it is. The faults a cell can have: a
rollout that returns its state unchanged; half of a batch left out (its
answers reported unsolved); an answer altered where it is produced."""

import dataclasses

import numpy as np
import pytest

from portbench.tests._tiny import cpu_run, tiny

CELLS = ("demo.single", "demo.fleet64")


def frozen(traffic):
    """Every rollout returns its start state: the planner's bicycle with a
    step that moves nothing (the CPU rollout runs its SoA hooks)."""
    planner = traffic.entry.planner
    system = dataclasses.replace(planner.system)
    object.__setattr__(system, "soa_step", lambda comps, aux, dt: list(comps))
    planner.system = system
    return traffic


def half_left_out(traffic):
    call = traffic.call

    def half(x):
        ans = call(x)
        n = len(ans["solved"])
        ans["solved"] = ans["solved"].copy()
        ans["solved"][n // 2:] = False
        return ans

    traffic.call = half
    return traffic


def altered(traffic):
    call = traffic.call

    def alter(x):
        ans = call(x)
        ans["paths"] = ans["paths"].copy()
        k = int(np.flatnonzero(ans["solved"])[0])
        ans["paths"][k, 1, 0:2] += 1.0
        return ans

    traffic.call = alter
    return traffic


FAULTS = {"frozen": frozen, "half": half_left_out, "altered": altered}


def cell_for(name, fault=None):
    # a frozen planner never solves, so it runs every iteration: keep them few
    return tiny(name, num_iterations=4) if fault == "frozen" else tiny(name)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    out, lines = cpu_run(cell_for(name))
    assert out["correct"], lines
    assert out["checks"]["path_gap"]["value"] < 1e-4
    assert out["checks"]["unsolved_share"]["value"] == 0
    assert list(out)[-1] == "checks" and lines[-1].startswith("check ")


@pytest.mark.parametrize("name, fault", [
    (n, f) for n in CELLS for f in FAULTS if not (n == "demo.single" and f == "half")])
def test_a_broken_run_is_not_correct(name, fault):
    out, lines = cpu_run(cell_for(name, fault), wrap=FAULTS[fault])
    assert not out["correct"], lines


def test_one_query_in_ten_left_unsolved_is_not_correct():
    """A planner that gives up on its hardest tenth of the fleet (a change
    that would buy speed with dropped problems) fails the unsolved limit."""
    def tenth(traffic):
        call = traffic.call

        def drop(x):
            ans = call(x)
            ans["solved"] = ans["solved"].copy()
            ans["solved"][np.argmax(ans["cost"])] = False
            return ans

        traffic.call = drop
        return traffic

    cell = cell_for("demo.fleet64")
    cell.traffic["batch"] = 10
    out, lines = cpu_run(cell, wrap=tenth)
    assert not out["correct"], lines
    assert out["checks"]["unsolved_share"]["value"] == pytest.approx(0.1)
    assert out["checks"]["path_gap"]["value"] < 1e-4
