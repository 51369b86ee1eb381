"""wall_ms_per_wave: the host wall of the traced run's window (its calls
before the profiled slice, with no profiler yet started) over the
rollout-kernel launches made in it, in ms: what a wave costs the planner's
host loop."""


def read(run):
    if not run.waves_window:
        return None
    return 1e3 * run.window_s / run.waves_window
