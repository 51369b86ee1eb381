"""The port's roofline accounting (probes/roofline.py): ``analyze`` is
tools/roofline.py's, formula for formula, on the same inputs; the kernel's
own operation counts (``ops_per_lane``, ``trig_per_lane``, ``kernel_ops``)
and the bounds they give. Measuring needs the card: ``calibrate`` refuses
the CPU."""

import sys
from pathlib import Path

import pytest

from cudasbmp_torch.probes import roofline as rf

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import roofline as tpu_roofline  # noqa: E402

CAL = {"alu_fma_issues_per_sec": 3.1e13, "cos_evals_per_sec": 2.2e12,
       "sin_evals_per_sec": 2.05e12, "tan_evals_per_sec": 9e11}


@pytest.mark.parametrize("ops", [
    tpu_roofline.count_rollout_ops(K=8),
    tpu_roofline.count_rollout_ops(K=24, fast_math=True),
    rf.kernel_ops("bicycle", False, False, 5, 10, True),
    rf.kernel_ops("bicycle", False, True, 24, 10, True),
    rf.kernel_ops("point2d", True, False, 8, 10, False),  # no trig at all
])
@pytest.mark.parametrize("rate", [1.3e9, 7.7e9])
def test_analyze_is_tools_roofline_analyze(ops, rate):
    assert rf.analyze(rate, ops, CAL) == tpu_roofline.analyze(rate, ops, CAL)


def test_ops_per_lane_counts_the_kernel():
    # the exact bicycle lane at K=8 and 10 steps: 1 + 1 + 10 x (14 + 8 + 4 x 8)
    assert rf.ops_per_lane("bicycle", False, False, 8, 10, False) == 542
    assert rf.ops_per_lane("bicycle", False, False, 8, 10, True) == 542 + 95
    # each box adds its 4-compare test every step; a footprint 42 more
    assert (rf.ops_per_lane("dubins", True, False, 9, 10, False)
            - rf.ops_per_lane("dubins", True, False, 8, 10, False)) == 10 * 46


@pytest.mark.parametrize("system,footprint,fast,trig", [
    ("bicycle", False, False, 21), ("bicycle", True, False, 41),
    ("bicycle", False, True, 7), ("unicycle", False, True, 4),
    ("dubins", True, False, 40), ("point2d", True, True, 0),
    ("double_integrator", False, False, 0)])
def test_trig_and_alu_split_the_count(system, footprint, fast, trig):
    ops = rf.kernel_ops(system, footprint, fast, 8, 10, False)
    assert ops["transcendentals"] == trig
    assert ops["alu_issues_fused"] == ops["alu_issues_conservative"]
    assert ops["alu_issues_fused"] + trig == rf.ops_per_lane(system, footprint,
                                                             fast, 8, 10, False)


def test_bounds():
    elems = 2048 * 128
    ms, by = rf.chain_bounds(elems)["alu"]
    # 2 x 16,384 x 262,144 flops over 67 TFLOP/s
    assert by == "operations" and ms == pytest.approx(0.128, rel=2e-3)
    ms, by = rf.chain_bounds(elems, rows=1024)["gather"]
    assert by == "operations" and ms == pytest.approx(512 * elems / 67e12 * 1e3)
    ms, by = rf.bound_ms(4096, 542, 8)
    assert by == "bytes" and ms == pytest.approx((45 * 4096 + 128) / 3.35e12 * 1e3)
    ms, by = rf.bound_ms(2 ** 17, rf.ops_per_lane("dubins", True, False, 8, 10, False), 8)
    assert by == "operations"


def test_calibrate_measures_only_the_card():
    with pytest.raises(ValueError, match="CUDA"):
        rf.calibrate("cpu")
    x, tbl, idx = rf.chain_inputs("cpu", rows=128)
    assert tuple(x.shape) == rf.CAL_SHAPE and float(x.min()) >= 0.5
    assert tuple(tbl.shape) == (128, 128) and 0 <= int(idx.min()) <= int(idx.max()) < 128
    assert rf.OUT.parts[-2:] == ("chiprun_out", "roofline.json")
