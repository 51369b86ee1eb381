"""``paths``: the judge of answers that are paths of the configuration's
system (``init``, ``goal``, ``boxes``, ``solved``, ``cost``, ``paths``,
``lengths``): every solved path replayed by the plain reference
(``portbench/reference/paths.py``). Its numbers: ``path_gap``,
``unsolved_share`` and ``missing``."""

from __future__ import annotations

from portbench.reference.paths import concat_answers, judge, lower_precision


def read(answers: list[dict], attempted: int, config: dict) -> dict:
    """The numbers of every answer of a run, ``attempted`` problems asked."""
    ans = concat_answers(answers)
    ans["attempted"] = attempted
    return judge(ans, config["planner"])


def control(answers: list[dict], config: dict) -> list[dict]:
    """The same answers as the control serves them: every solved path's
    states computed by the reference in bfloat16."""
    return [lower_precision(a, config["planner"]) for a in answers]
