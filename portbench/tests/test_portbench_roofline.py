"""The frozen copy of the roofline counts gives PERF.md's bounds for the
rollout kernels at the cells' shapes."""

import pytest

from portbench.roofline import launch_bound_ms


def shape(problems, lanes, per_problem, sample):
    return {"problems": problems, "lanes": lanes, "boxes": 8,
            "per_problem_boxes": per_problem, "sample": sample, "system": "bicycle",
            "footprint": False, "fast_math": False, "num_disc": 10}


@pytest.mark.parametrize("problems, lanes, per_problem, sample, ms", [
    (1, 4096, False, False, 0.0000551),  # B1 at the demo's width
    (1024, 128, True, True, 0.00180),  # B6 Philox at the sweep's shape
    (1024, 128, True, False, 0.00180),  # B6
    (64, 4096, True, False, 0.00352),  # B6 at the CLI multi default
])
def test_bounds_match_the_kernel_table(problems, lanes, per_problem, sample, ms):
    got, by = launch_bound_ms(shape(problems, lanes, per_problem, sample))
    assert by == "bytes"
    assert got == pytest.approx(ms, rel=5e-3)
