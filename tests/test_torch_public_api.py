"""The JAX package's last public names in the port, held against JAX on the
CPU: ``ops.propagate_and_check``, ``geometry.OccupancyGrid``, the compaction
and segment ops (``compact_indices``, ``masked_bincount``,
``masked_multi_bincount``, ``scatter_or``, on tests/test_ops.py's cases),
the package's lazy ``refine_path``/``refine_batch``/``shortcut_path``/
``shortcut_batch``, ``config.WORKSPACE_DIM`` and ``planners.kgmt.
frontier_mask``; and one parity check that every public name of every JAX
module has its port counterpart, but for a listed set, each with its reason.

Tolerances: controls, masks, counts and indices exactly (threefry is
bitwise the JAX draw, op by op; the ops are integer); the rollout's states
within 1e-3, as tests/test_torch_rollout.py (XLA:CPU's and torch's trig
round apart)."""

import ast
import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cudasbmp_torch as ct
from cudasbmp_torch import rng
from cudasbmp_torch.geometry import OccupancyGrid, RegionGrid
from cudasbmp_torch.ops import (compact_indices, masked_bincount, masked_multi_bincount,
                                propagate_and_check, scatter_or)
from cudasbmp_torch.systems import get_system
import cudasbmp_tpu as jt
from cudasbmp_tpu.geometry.grid import OccupancyGrid as JOccupancyGrid
from cudasbmp_tpu.geometry.grid import RegionGrid as JRegionGrid
from cudasbmp_tpu.ops import compaction as jcompaction
from cudasbmp_tpu.ops import segments as jsegments
from cudasbmp_tpu.ops.rollout import propagate_and_check as j_propagate_and_check
from cudasbmp_tpu.systems import get_system as j_get_system

torch.set_num_threads(2)
JAX_DIR = pathlib.Path(jt.__file__).resolve().parent


@pytest.mark.parametrize("name,seed", [("bicycle", 0), ("double_integrator", 1),
                                       ("unicycle", 2)])
def test_propagate_and_check_matches_jax(name, seed):
    B = 1024
    r = np.random.default_rng(seed)
    x0 = np.zeros((B, 4), np.float32)
    x0[:, :2] = r.uniform(0.5, 19.5, (B, 2))
    if name != "double_integrator":
        x0[:, 2] = r.uniform(-np.pi, np.pi, B)
    obs = ct.Scenario.demo().padded_obstacles(8)[0]
    kw = dict(num_disc=10, width=20.0, height=20.0)
    with jax.disable_jit():  # jitted, XLA contracts lo + u * (hi - lo) into an FMA
        ws, wc, wv = j_propagate_and_check(j_get_system(name), jax.random.PRNGKey(seed),
                                           jnp.asarray(x0), jnp.asarray(obs), **kw)
    s, c, v = propagate_and_check(get_system(name), rng.key(seed), torch.tensor(x0),
                                  torch.tensor(obs), **kw)
    assert s.shape == (B, 7) and c.shape == (B, 3)
    np.testing.assert_array_equal(c.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(s[:, 4:].numpy(), c.numpy())
    np.testing.assert_array_equal(v.numpy(), np.asarray(wv))
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), atol=1e-3, rtol=0)
    assert 0 < int(v.sum()) < B


def test_occupancy_grid_matches_jax():
    r = np.random.default_rng(7)
    pts = r.uniform(-6, 26, (4096, 2)).astype(np.float32)  # a fifth outside
    queries = r.uniform(-6, 26, (512, 2)).astype(np.float32)
    want = JOccupancyGrid.create(JRegionGrid(20.0, 20.0, 16, 8))
    want = want.add_points(jnp.asarray(pts[:3000])).add_points(jnp.asarray(pts[3000:]))
    got = OccupancyGrid.create(RegionGrid(20.0, 20.0, 16, 8), device="cpu")
    got = got.add_points(torch.tensor(pts[:3000])).add_points(torch.tensor(pts[3000:]))
    assert got.counts.dtype == torch.int32
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    assert 0 < int(got.counts.sum()) < len(pts)
    np.testing.assert_array_equal(
        got.occupancy(torch.tensor(queries[:, 0]), torch.tensor(queries[:, 1])).numpy(),
        np.asarray(want.occupancy(jnp.asarray(queries[:, 0]), jnp.asarray(queries[:, 1]))))
    # tests/test_geometry.py's case: x in (-cell, 0) truncates into cell 0
    small = OccupancyGrid.create(RegionGrid(20.0, 20.0, 4, 2), device="cpu").add_points(
        torch.tensor([[1.0, 1.0], [2.0, 2.0], [19.0, 19.0], [-7.0, 0.0]]))
    assert int(small.occupancy(torch.tensor(1.5), torch.tensor(1.5))) == 2
    assert int(small.occupancy(torch.tensor(-7.0), torch.tensor(0.0))) == 0
    assert int(small.counts.sum()) == 3


def _masks():
    r = np.random.default_rng(1234)
    return {"basic": np.array([False, True, False, True, True, False]),
            "empty": np.zeros(8, bool), "full": np.ones(8, bool),
            "random": r.random(1000) < 0.3, "three": np.array([True, False, True])}


@pytest.mark.parametrize("case", list(_masks()))
def test_compact_indices_matches_jax(case):
    mask = _masks()[case]
    widx, wcount = jcompaction.compact_indices(jnp.asarray(mask))
    idx, count = compact_indices(torch.tensor(mask))
    assert idx.dtype == count.dtype == torch.int32 and count.shape == ()
    assert int(count) == int(wcount) == int(mask.sum())
    np.testing.assert_array_equal(idx.numpy(), np.asarray(widx))


def _segment_cases():
    r = np.random.default_rng(1234)
    n = 64
    indices = r.integers(-1, n, size=5000)
    active = r.random(5000) < 0.9
    return {
        "drops_negative_and_invalid": (np.array([0, 1, 1, -1, 2, 2]),
                                       np.array([True, True, True, True, False, True]), 4),
        "random": (indices, r.random(5000) < 0.7, n),
        "past_num": (np.array([0, 5, 3, 9, -1]), np.ones(5, bool), 4),
        "multi": (indices, active & (r.random(5000) < 0.6), n, active),
    }


@pytest.mark.parametrize("case", list(_segment_cases()))
def test_masked_bincounts_match_jax(case):
    indices, valid, n, *active = _segment_cases()[case]
    want = jsegments.masked_bincount(jnp.asarray(indices), jnp.asarray(valid), n)
    got = masked_bincount(torch.tensor(indices), torch.tensor(valid), n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cols = np.stack([valid, *(a for a in active)] if active else [valid, ~valid],
                    -1).astype(np.int32)
    wmulti = jsegments.masked_multi_bincount(jnp.asarray(indices), jnp.asarray(cols), n)
    multi = masked_multi_bincount(torch.tensor(indices), torch.tensor(cols), n)
    assert multi.dtype == torch.int32 and multi.shape == (n, 2)
    np.testing.assert_array_equal(multi.numpy(), np.asarray(wmulti))


@pytest.mark.parametrize("case", ["test_ops", "random"])
def test_scatter_or_matches_jax(case):
    if case == "test_ops":
        flags, indices, valid = (np.array([0, 1, 0, 0], np.int32), np.array([2, -1, 0]),
                                 np.array([True, True, False]))
    else:
        r = np.random.default_rng(5)
        flags = (r.random(256) < 0.2).astype(np.int32)
        indices, valid = r.integers(-1, 300, 2000), r.random(2000) < 0.5
    want = jsegments.scatter_or(jnp.asarray(flags), jnp.asarray(indices), jnp.asarray(valid))
    got = scatter_or(torch.tensor(flags), torch.tensor(indices), torch.tensor(valid))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lazy_package_names_and_constants():
    import cudasbmp_torch.refine as refine
    import cudasbmp_torch.shortcut as shortcut
    from cudasbmp_torch import config

    assert ct.refine_path is refine.refine_path and ct.refine_batch is refine.refine_batch
    assert ct.shortcut_path is shortcut.shortcut_path
    assert ct.shortcut_batch is shortcut.shortcut_batch
    with pytest.raises(AttributeError):
        ct.no_such_name  # noqa: B018
    from cudasbmp_tpu import config as jconfig

    assert config.WORKSPACE_DIM == jconfig.WORKSPACE_DIM == 2


def test_frontier_mask_matches_jax():
    from cudasbmp_torch.io.csv import frontier_mask as csv_frontier_mask
    from cudasbmp_torch.planners.kgmt import frontier_mask
    from cudasbmp_tpu.planners.kgmt import frontier_mask as j_frontier_mask

    cfg = dict(max_tree_size=4096, rollouts_per_iter=512, num_iterations=3)
    state = ct.KGMT(ct.KGMTConfig(**cfg), device="cpu").plan(ct.Scenario.demo()).state
    got = frontier_mask(state, 4096)
    assert got.dtype == torch.bool and 0 < int(got.sum()) < 4096
    np.testing.assert_array_equal(got.numpy(), csv_frontier_mask(state, 4096))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_frontier_mask(state, 4096)))


# -- every public name of the JAX package, but for a listed set ----------------

# whole modules with no port counterpart, and why
SET_ASIDE_MODULES = {
    "io.native": "an optional C++ CSV reader with a Python fallback; the port's "
                 "io/csv.py is numpy only and no record shows CSV time matters",
    "utils.vma": "shard_map's varying-axes typing, which has no torch meaning",
}
# names set aside within a ported module, and why
SET_ASIDE = {
    ("planners.kgmt", "pvary_tree"): "shard_map typing (utils/vma.py)",
    ("parallel.sharded_tree", "kgmt_run_sharded"):
        "the shard_map body; its counterpart is parallel/sharded_tree.py::sharded_run",
    ("ops.rollout_pallas", "seed_tiles"): "the TPU hardware PRNG's per-program seeds",
    ("ops.rollout_pallas", "np_hypot"):
        "a Pallas helper; the port's pad is rollout_cuda.py::footprint_pad",
    **{("ops.rollout_pallas", n): "the TPU's (8, 128) tiling and VMEM block"
       for n in ("SUBLANES", "LANES", "ROW_TILES", "BLOCK_ROWS")},
}
# a JAX module whose counterpart has another name, and its renamed names
COUNTERPARTS = {
    "ops.rollout_pallas": ("ops.rollout_cuda", {
        "rollout_pallas": "rollout_cuda",
        "rollout_bicycle_pallas": "rollout_bicycle_cuda",
        "sample_and_rollout_pallas": "sample_and_rollout_cuda",
        "sample_and_rollout_bicycle_pallas": "sample_and_rollout_bicycle_cuda"}),
}


def _public_names(path: pathlib.Path) -> list[str]:
    """The module's ``__all__`` where it has one, else its top-level
    functions, classes and upper-case constants not starting with _."""
    body = ast.parse(path.read_text()).body
    for node in body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return list(ast.literal_eval(node.value))
    names = [n.name for n in body if isinstance(n, (ast.FunctionDef, ast.ClassDef))]
    names += [t.id for n in body if isinstance(n, ast.Assign) for t in n.targets
              if isinstance(t, ast.Name) and t.id.isupper()]
    return [n for n in names if not n.startswith("_")]


JAX_MODULES = sorted(
    ".".join(p.relative_to(JAX_DIR).with_suffix("").parts).removesuffix("__init__")
    .rstrip(".") for p in JAX_DIR.rglob("*.py"))


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_jax_name_has_its_port_counterpart(module):
    src = JAX_DIR.joinpath(*module.split(".")) if module else JAX_DIR
    path = src / "__init__.py" if src.is_dir() else src.with_suffix(".py")
    if module in SET_ASIDE_MODULES:
        assert not (pathlib.Path(ct.__file__).parent / f"{module.replace('.', '/')}.py"
                    ).exists()
        return
    port_module, renamed = COUNTERPARTS.get(module, (module, {}))
    port = importlib.import_module("cudasbmp_torch" + (f".{port_module}" if port_module
                                                       else ""))
    missing = [n for n in _public_names(path) if (module, n) not in SET_ASIDE
               and not hasattr(port, renamed.get(n, n))]
    assert not missing, f"cudasbmp_tpu.{module}: no port counterpart for {missing}"
