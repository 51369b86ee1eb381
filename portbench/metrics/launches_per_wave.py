"""launches_per_wave: the runtime's kernel-launch records in the profiled
slice over the rollout-kernel launches made in it (the wrappers' counters):
what the torch glue launches around each wave (a vmap trip and an arena
iteration are one wave each)."""


def read(run):
    if not run.waves_slice:
        return None
    return run.slice.launch_records / run.waves_slice
