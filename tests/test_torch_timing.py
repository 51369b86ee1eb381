"""The profiler-window classification of cudasbmp_torch/probes/timing.py on
synthetic records (key, launches, device us): a window is regular only if
every kernel seen in any window of the call appears in it with a positive
multiple of the calls; the time is the median over the regular windows,
and there is no time where none is regular."""

import pytest

from cudasbmp_torch.probes.timing import Timing, summarize, window_verdicts

N = 20  # calls a window


def window(rollout_us: float = 60.0, copy_us: float = 20.0, rollouts: int = N,
           copies: int = N) -> list:
    """A window of N calls that each launch one rollout kernel and one copy;
    a CPU-side entry carries no device time."""
    return [("rollout_kernel", rollouts, rollout_us), ("Memcpy HtoD", copies, copy_us),
            ("cudaLaunchKernel", 2 * N, 0.0)]


def test_regular_windows_give_their_median():
    t = summarize([window(60.0), window(64.0), window(80.0)], N)
    assert t == Timing(ms=pytest.approx(84.0 / N / 1e3), regular=3, windows=3)
    assert window_verdicts([window(), window()], N) == ["", ""]


def test_a_dropped_kernel_makes_a_window_irregular():
    dropped = [r for r in window(10.0) if r[0] != "rollout_kernel"]
    verdicts = window_verdicts([window(), dropped, window()], N)
    assert verdicts[0] == verdicts[2] == ""
    assert verdicts[1].startswith("missing rollout_kernel")
    # the window whose rollout records vanished would read a third of the
    # time; it is left out of the median
    t = summarize([window(), dropped, window()], N)
    assert t.regular == 2 and t.windows == 3 and t.ms == pytest.approx(80.0 / N / 1e3)


@pytest.mark.parametrize("rollouts", [N - 1, N + 1, 2 * N - 3])
def test_an_odd_count_makes_a_window_irregular(rollouts):
    odd = window(rollouts=rollouts)
    verdicts = window_verdicts([window(), odd], N)
    assert verdicts == ["", f"{rollouts} launches of rollout_kernel for {N} calls"]
    assert summarize([window(), odd], N).regular == 1


def test_twice_the_calls_is_regular():
    assert window_verdicts([window(rollouts=2 * N)], N) == [""]


def test_no_regular_window_gives_a_count_of_zero_and_no_time():
    t = summarize([window(rollouts=N - 1), window(copies=N + 2), []], N)
    assert t == Timing(ms=None, regular=0, windows=3)
    assert window_verdicts([[]], N) == ["no record"]
    assert summarize([], N) == Timing(None, 0, 0)
