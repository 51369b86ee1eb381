"""waves_per_solve: rollout-kernel launches over the problems solved, over
every call of the traced run: a count of work, which repeats for a seed."""


def read(run):
    if not run.solved_total:
        return None
    return run.waves_total / run.solved_total
