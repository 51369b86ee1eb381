"""rng_ms_per_wave: the self time of the program's ``kgmt_rng`` spans in the
profiled slice (every threefry draw of the planner loops: the wave keys,
``fold_in``/``split``, the controls and the acceptance uniforms) over the
slice's rollout-kernel launches, in ms. It is profiled host time: the
profiler adds its own cost to every op it records, so a traced wave takes
two to three times an untraced one and this reading swings with it.
Compare it between traced runs, or as a share of the slice's ms a wave
(the note's ``slice_ms_per_wave``), not with untraced times. Nothing where
the program opens no such span.

Its note gives every ``kgmt_`` span's self ms a wave, the slice's ms a
wave, and the shares of the slice's idle device time that fall under no
``kgmt_`` phase (the innermost annotation then open is a call or loop span
or the harness's) and under the harness's ``portbench.call``."""

from portbench.spans import ms_per_wave, self_ns
from portbench.trace import CALL_SPAN


def read(run):
    return ms_per_wave(run, "kgmt_rng")


def note(run):
    if not run.waves_slice:
        return {}
    per = {k: v / 1e6 / run.waves_slice for k, v in sorted(self_ns(run.slice).items())
           if k.startswith("kgmt_")}
    try:
        from cudasbmp_torch.utils.profiling import PHASES
    except ImportError:
        PHASES = ()
    gaps = run.slice.idle_gaps(top=1 << 30)
    idle = sum(s for _, s in gaps) or 1.0
    annotation = [label.split("/", 1)[0] for label, _ in gaps]
    return {"self_ms_per_wave": per,
            "slice_ms_per_wave": 1e3 * run.slice.span_s / run.waves_slice,
            "idle_outside_phases_share": sum(
                s for a, (_, s) in zip(annotation, gaps) if a not in PHASES) / idle,
            "idle_under_call_share": sum(
                s for a, (_, s) in zip(annotation, gaps) if a == CALL_SPAN) / idle}
