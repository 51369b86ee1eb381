"""rollout_roofline: the rollout kernels' share of their roofline in the
profiled slice, in %: the least time the card could take for every rollout
launch of the slice (portbench/roofline.py's counts at each launch's own
shape) over their summed device time. A launch's shape is that of the
states buffer its wrapper makes just before it (``torch.empty_like(x0)``:
[lanes, 4], or [problems, lanes, 4] with a box set a problem); the
boxes, system and options are the cell's. Nothing where the slice holds no
rollout record, or a record whose shape it cannot find."""

from collections import Counter
from math import prod

from portbench.roofline import launch_bound_ms

PATTERN = "rollout_kernel"
BUFFER = "aten::empty_like"


def _launches(run):
    for name, start, end, corr in run.slice.kernels(PATTERN):
        shapes = run.slice.shapes_before(corr, BUFFER)
        x0 = shapes[0] if shapes else None
        yield name, end - start, (list(x0) if x0 and len(x0) in (2, 3) else None)


def read(run):
    bound = device_ms = 0.0
    launches = list(_launches(run))
    if not launches:
        return None
    for name, ns, x0 in launches:
        if x0 is None:
            return None
        shape = dict(run.shape, problems=prod(x0[:-2]), lanes=x0[-2],
                     per_problem_boxes=len(x0) == 3, sample="sample_and_rollout" in name)
        bound += launch_bound_ms(shape)[0]
        device_ms += ns / 1e6
    return 100.0 * bound / device_ms


def note(run):
    shapes = Counter((name[:80], tuple(x0) if x0 else None) for name, _, x0 in _launches(run))
    return {"launches": [[n, s, c] for (n, s), c in shapes.most_common(6)]}
