"""host_reads_per_wave: the program's reads of the card
(``utils/profiling.py::host_read.reads``: each ``tolist``/``.cpu()`` of the
planner loops) over its rollout-kernel launches (the wrappers'
``.launches``), both counted from process start (set-up, window and
slice): the host's waits on the card a wave, which a wave without a sync
would take to 0. Nothing where the program has no such counter."""


def read(run):
    from cudasbmp_torch.ops import rollout_cuda

    try:
        from cudasbmp_torch.utils.profiling import host_read
    except ImportError:
        return None
    waves = sum(w.launches for w in rollout_cuda.WRAPPERS)
    return host_read.reads / waves if waves else None
