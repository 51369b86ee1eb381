"""idle_share: the share of the profiled slice in which the device ran
nothing (no kernel, copy or set), in %: 1 - busy / the slice's span."""


def read(run):
    return 100.0 * (1.0 - run.slice.busy_s / run.slice.span_s)
