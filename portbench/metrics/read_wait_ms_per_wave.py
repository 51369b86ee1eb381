"""read_wait_ms_per_wave: the self time of the program's ``kgmt_host_read``
spans in the profiled slice (the host blocked on a read of the card, the
copy included) over the slice's rollout-kernel launches, in ms. Nothing
where the program opens no such span."""

from portbench.spans import ms_per_wave


def read(run):
    return ms_per_wave(run, "kgmt_host_read")
