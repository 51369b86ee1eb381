"""solves_per_s: problems solved in the window over the window's seconds,
from the first call's start to the last call's end, every call counted."""


def read(window):
    return sum(c.solved for c in window.calls) / window.window_s
