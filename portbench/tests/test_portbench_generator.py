"""The benchmark's inputs are a function of the seed; the warm-up call's
and the profiled slice's are the same in every run."""

import numpy as np

from portbench import cells
from portbench.generator import Traffic, pad_boxes


def traffic(seed, name="demo.fleet64"):
    return Traffic(cells.load_cell(name), seed, "cpu")


def same(x, y):
    return x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)


def test_inputs_repeat_for_a_seed_and_differ_across_seeds_and_calls():
    for name in ("demo.single", "demo.fleet64"):
        a, b, c = traffic(2**31 + 99, name), traffic(2**31 + 99, name), traffic(2**33 + 1, name)
        assert all(same(a.inputs(i), b.inputs(i)) for i in range(3))
        assert not same(a.inputs(0), c.inputs(0))
        assert not same(a.inputs(0), a.inputs(1))


def test_warm_and_slice_inputs_do_not_follow_the_seed():
    a, c = traffic(5), traffic(6)
    assert same(a.warm_inputs(), c.warm_inputs())
    assert same(a.slice_inputs(0), c.slice_inputs(0))
    assert not same(a.slice_inputs(0), a.warm_inputs())


def test_fleet_inputs_follow_the_traffic_file():
    t = traffic(2**31 + 5)
    x = t.inputs(0)
    assert x["init"].shape == x["goal"].shape == (64, 7)
    assert x["boxes"].shape == (64, 5, 4)
    assert (x["init"][:, :2] == [5.0, 5.0]).all()
    jitter = x["goal"][:, :2] - np.array([2.0, 18.0], np.float32)
    assert (np.abs(jitter) <= 1.0).all() and np.abs(jitter).max() > 0.5
    assert (x["goal"][:, 2:] == 0).all()


def test_padding_boxes_hit_nothing():
    padded = pad_boxes(np.zeros((3, 5, 4), np.float32))
    assert padded.shape == (3, 8, 4)
    assert (padded[:, 5:, :2] == 1).all() and (padded[:, 5:, 2:] == 0).all()
