"""The rollout-throughput probe (probes/throughput.py) against bench.py's
``measure_prop_throughput``: the start states and their Morton order,
bitwise against the same lines of bench.py:110-125 run as eager JAX at
B = 4,096; and the probe's waves on the CPU at a small size, through each
backend (the kernel backends take their plain twins on the CPU). Rates from
a CPU run are wall rates only: the device rates stay None.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudasbmp_torch.probes import throughput as tp

torch.set_num_threads(2)


def jax_start_states(batch: int, grouped: bool) -> np.ndarray:
    """bench.py:110-125, op by op."""
    with jax.disable_jit():
        key = jax.random.key(0)
        x0 = jax.random.uniform(key, (batch, 4), minval=1.0, maxval=19.0)
        x0 = x0.at[:, 2:].set(0.0)
        if grouped:
            cx = jnp.floor(x0[:, 0] / 1.25).astype(jnp.int32)
            cy = jnp.floor(x0[:, 1] / 1.25).astype(jnp.int32)
            z = jnp.zeros_like(cx)
            for b in range(4):
                z = z | (((cx >> b) & 1) << (2 * b)) | (((cy >> b) & 1)
                                                        << (2 * b + 1))
            x0 = x0[jnp.argsort(z)]
        return np.asarray(x0)


@pytest.mark.parametrize("grouped", [False, True], ids=["random", "morton"])
def test_start_states_and_morton_order_are_bench_pys(grouped):
    want = jax_start_states(4096, grouped)
    got = tp.start_states(4096, "cpu", grouped).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_morton_order_groups_cells():
    x0 = tp.start_states(4096, "cpu", grouped=True)
    cells = torch.floor(x0[:, :2] / 1.25).to(torch.int64)
    # a run of 16 lanes spans a small square of cells, not a strip
    spans = (cells.view(-1, 16, 2).amax(1) - cells.view(-1, 16, 2).amin(1)).amax(-1)
    assert float(spans.float().mean()) < 3.0
    assert torch.equal(torch.sort(tp.morton_order(x0)).values, torch.arange(4096))


@pytest.mark.parametrize("backend,kw", [
    ("torch", {}), ("cuda", {"fast_math": True}), ("cuda_rng", {}),
    ("cuda_rng", {"dense": True, "grouped": True, "cull": 2}),
])
def test_probe_runs_every_backend_on_the_cpu(backend, kw):
    r = tp.measure_prop_throughput(batch=512, repeats=2, backend=backend,
                                   device="cpu", **kw)
    assert r["device"] == "cpu" and r["rollouts_per_sec"] is None
    assert r["valid_per_sec"] is None and r["wave_device_ms"] is None
    assert r["wall_rollouts_per_sec"] > 0
    assert 0.0 < r["valid_fraction"] < 1.0
    assert r["wall_valid_per_sec"] == pytest.approx(
        r["wall_rollouts_per_sec"] * r["valid_fraction"])


def test_culled_probe_counts_what_the_unculled_one_counts():
    """cull changes speed only: the same waves give the same valid counts."""
    a = tp.measure_prop_throughput(batch=256, repeats=1, backend="cuda_rng",
                                   dense=True, grouped=True, device="cpu")
    b = tp.measure_prop_throughput(batch=256, repeats=1, backend="cuda_rng",
                                   dense=True, grouped=True, cull=5, device="cpu")
    assert a["valid_fraction"] == b["valid_fraction"]


def test_cull_table_has_the_six_rows():
    t = tp.cull_table(device="cpu", batch=256, repeats=1)
    assert [r["label"] for r in t["rows"]] == [label for label, _ in tp.CULL_ROWS]
    assert t["rate"] == "wall_rollouts_per_sec" and t["fraction_of_demo"] > 0
    assert t["best_dense_grouped"].startswith("dense24_grouped_cull")


def test_probe_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="is_available"):
        tp.measure_prop_throughput(batch=64, repeats=1)
    with pytest.raises(ValueError, match="backend"):
        tp.measure_prop_throughput(backend="pallas", device="cpu")
