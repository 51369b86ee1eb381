"""tts_p90_s: the 90th percentile of the time to solution of every query
started in the window, each from its call to its result after a
synchronize (a query that found no path counts with its time)."""

import numpy as np


def read(window):
    return float(np.quantile([c.seconds for c in window.calls], 0.9))
