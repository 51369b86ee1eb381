"""The port's plots (cudasbmp_torch/viz.py), mirroring tests/test_viz.py: the
replayed edges against the JAX package's numbers (the vmapped whole-tree
replay and the per-edge one, on random edges and on a solved tree's edges),
then each plot written from a result, from artifact CSVs, from recorded
frames and from a sharded result, and the module importing without
matplotlib."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import cudasbmp_torch as ct
from cudasbmp_torch import viz
from cudasbmp_torch.io.csv import write_artifacts
from cudasbmp_torch.systems.registry import get_system
from cudasbmp_tpu import viz as jviz
from cudasbmp_tpu.systems.registry import get_system as jget_system

torch.set_num_threads(2)
SMALL = dict(num_iterations=100, max_tree_size=16384, rollouts_per_iter=2048)
# tests/test_viz.py's replay tolerance: jitted f32 fusion and float trig
# (the JAX replay is jitted and vmapped; glibc's and SLEEF's trig differ by
# an ulp) against deliberately chaotic high-|tan| edges
REPLAY_TOL = dict(rtol=2e-5, atol=1e-4)
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def solved():
    cfg = ct.KGMTConfig(**SMALL)
    return cfg, ct.KGMT(cfg, device="cpu").plan(ct.Scenario.demo())


@pytest.mark.parametrize("system", ["bicycle", "unicycle", "dubins"])
def test_batched_edge_replay_matches_jax(system):
    r = np.random.default_rng(0)
    E = 40
    sys_t, sys_j = get_system(system), jget_system(system)
    x0s = r.uniform(1, 19, (E, 7)).astype(np.float32)
    lo, hi = np.asarray(sys_j.control_spec.lo), np.asarray(sys_j.control_spec.hi)
    ctrl = r.uniform(lo, hi, (E, len(lo))).astype(np.float32)
    got = viz._integrate_edges(sys_t, x0s, ctrl, 10)
    assert got.shape == (E, 11, sys_t.state_dim) and got.dtype == np.float32
    np.testing.assert_allclose(got, jviz._integrate_edges(sys_j, x0s, ctrl, 10),
                               **REPLAY_TOL)
    for i in (0, 7, 39):
        np.testing.assert_allclose(
            viz._integrate_edge_states(sys_t, x0s[i], ctrl[i], 10),
            jviz._integrate_edge_states(sys_j, x0s[i], ctrl[i], 10), **REPLAY_TOL)
        np.testing.assert_array_equal(viz._integrate_edge_states(sys_t, x0s[i], ctrl[i], 10),
                                      got[i])


def test_solved_trees_edges_replay_as_jaxs_and_reach_their_nodes(solved):
    """The polylines plot_tree draws for a solved tree: JAX's replay of the
    same edges, each ending on its child node. Tree angles are unwrapped
    and reach the thousands where the steering nears +-pi/2; there an ulp
    of theta (the trig libraries' difference) moves a step's position by
    up to |v| dt ulp(theta), so x and y are held within REPLAY_TOL plus
    four such ulps over the edge's duration, theta and v within
    REPLAY_TOL."""
    cfg, result = solved
    samples = result.state.tree_samples.numpy()
    parents = result.state.tree_parent.numpy()
    children = np.arange(1, result.tree_size)
    system = get_system(cfg.system)
    got = viz._integrate_edges(system, samples[parents[children]],
                               samples[children, 4:7], cfg.num_disc)
    want = jviz._integrate_edges(jget_system(cfg.system), samples[parents[children]],
                                 samples[children, 4:7], cfg.num_disc)
    np.testing.assert_allclose(got[..., 2:], want[..., 2:], **REPLAY_TOL)
    spin = (4 * np.abs(want[..., 3]).max(axis=1) * samples[children, 6]
            * np.spacing(np.abs(want[..., 2]).max(axis=1)))
    err = np.abs(got[..., :2] - want[..., :2]).max(axis=(1, 2))
    limit = REPLAY_TOL["atol"] + REPLAY_TOL["rtol"] * np.abs(want[..., :2]).max(axis=(1, 2))
    assert (err <= limit + spin).all(), (err - limit - spin).max()
    assert (spin < REPLAY_TOL["atol"]).mean() > 0.8
    np.testing.assert_allclose(got[:, -1, :4], samples[children, :4], rtol=1e-5, atol=1e-4)


def test_plot_tree_from_result(solved, tmp_path):
    cfg, result = solved
    out = viz.plot_tree(result=result, config=cfg, obstacles=ct.Scenario.demo().obstacles,
                        out_path=str(tmp_path / "tree.png"), max_edges=200)
    assert Path(out).stat().st_size > 10_000


def test_plot_tree_with_footprint_overlay(tmp_path):
    cfg = ct.KGMTConfig(**SMALL, footprint_width=0.5)
    result = ct.KGMT(cfg, device="cpu").plan(ct.Scenario.demo())
    out = viz.plot_tree(result=result, config=cfg, obstacles=ct.Scenario.demo().obstacles,
                        out_path=str(tmp_path / "tree_fp.png"), max_edges=200,
                        footprint=cfg.footprint)
    assert Path(out).stat().st_size > 10_000


def test_plot_tree_from_artifacts_and_uncapped(solved, tmp_path):
    cfg, result = solved
    write_artifacts(result.state, cfg, tmp_path)
    out = viz.plot_tree(artifacts_dir=tmp_path, config=cfg,
                        out_path=str(tmp_path / "tree2.png"), max_edges=50)
    assert Path(out).exists()
    full = viz.plot_tree(result=result, config=cfg, out_path=str(tmp_path / "full.png"))
    assert Path(full).stat().st_size > 10_000


def test_plot_metrics(solved, tmp_path):
    _, result = solved
    out = viz.plot_metrics(result.metrics, out_path=str(tmp_path / "m.png"))
    assert Path(out).stat().st_size > 5_000


def test_plot_steps_frames(tmp_path):
    cfg = ct.KGMTConfig(num_iterations=6, max_tree_size=2048, rollouts_per_iter=512)
    ct.KGMT(cfg, device="cpu").plan_recorded(ct.Scenario.demo(), tmp_path / "rec",
                                             dump_every=2)
    frames = viz.plot_steps(tmp_path / "rec", config=cfg,
                            obstacles=ct.Scenario.demo().obstacles,
                            out_dir=tmp_path / "frames", max_edges=50)
    assert len(frames) >= 1 and Path(frames[0]).exists()


def test_plot_sharded_path(tmp_path):
    from cudasbmp_torch.parallel import ShardedTreePlanner, make_planner_mesh

    cfg = ct.KGMTConfig(num_iterations=60, max_tree_size=2048, rollouts_per_iter=512,
                        adaptive_waves=False)
    res = ShardedTreePlanner(cfg, mesh=make_planner_mesh(n_tree=8, device="cpu")).plan(
        ct.Scenario.demo())
    assert res.solved
    out = viz.plot_sharded_path(res, config=cfg, obstacles=ct.Scenario.demo().obstacles,
                                out_path=str(tmp_path / "sp.png"))
    assert Path(out).stat().st_size > 10_000
    # the stitched edges replay onto their child nodes across shard borders
    sts = viz._integrate_edges(get_system(cfg.system), res.path[:-1], res.path[1:, 4:7],
                               cfg.num_disc)
    np.testing.assert_allclose(sts[:, -1, :4], res.path[1:, :4], rtol=1e-5, atol=1e-4)


def test_imports_without_matplotlib():
    code = ("import sys; sys.modules['matplotlib'] = None\n"
            "import cudasbmp_torch.viz as v\n"
            "try:\n"
            "    v.plot_metrics({'frontier_size': [1], 'valid': [1], 'accepted': [1],"
            " 'tree_size': [1]})\n"
            "except ImportError:\n"
            "    print('no matplotlib')\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0 and p.stdout.strip() == "no matplotlib", p.stderr
