"""Configuration files and scenario/artifact CSVs of the port against the
JAX package: the strict flat-YAML reader against JAX's pyyaml-based
``from_file`` on the shipped systems/*.yaml, ``to_file`` round trips,
``load_scenario`` on configurations/, and ``write_artifacts`` on a JAX
state (a run with options) converted to a port state, compared by value
(the JAX writer may format numbers natively)."""

import dataclasses
import pathlib

import jax
import numpy as np
import pytest
import torch

import cudasbmp_torch as ct
import cudasbmp_tpu as jt
from cudasbmp_torch import config as tconfig
from cudasbmp_torch import convert
from cudasbmp_torch.io import csv as tcsv
from cudasbmp_tpu.io import csv as jcsv

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent
YAMLS = sorted(p.name for p in (REPO / "systems").glob("*.yaml"))


@pytest.mark.parametrize("name", YAMLS)
def test_yaml_reader_matches_jax_from_file(name):
    path = str(REPO / "systems" / name)
    want = jt.KGMTConfig.from_file(path)
    got = tconfig.KGMTConfig.from_file(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.system == pathlib.Path(name).stem.replace("car", "bicycle")


def test_yaml_reader_reads_scalars_as_pyyaml_does():
    import yaml

    text = ("# comment\n\nseed: 7   # trailing\nfast_math: yes\nneed_path: off\n"
            "goal_bias: 2.5e-1\nwidth: 1_0.0\nsystem: 'dubins'\nN: +16\n"
            'rollout_backend: "cuda"\nepsilon: .5\nn: 0\n')
    assert tconfig.read_flat_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a:\n  b: 1\n", "a: [1, 2]\n", "- 1\n", "a: {b: 1}\n", "a: &x 1\n",
    "a: !!str 1\n", "a: |\n  x\n", "a: 1\na: 2\n", "---\na: 1\n", "a: 0x1f\n",
    "a: 017\n", "a: 1:30\n", "a: 'open\n",
])
def test_yaml_reader_is_strict(text):
    with pytest.raises(ValueError):
        tconfig.read_flat_yaml(text)


@pytest.mark.parametrize("suffix", [".yaml", ".json"])
def test_to_file_round_trips_and_jax_reads_it(tmp_path, suffix):
    cfg = tconfig.KGMTConfig(system="unicycle", goal_bias=0.25, fast_math=True,
                             footprint_width=1e-7, seed=42, rollout_backend="torch")
    path = str(tmp_path / f"cfg{suffix}")
    cfg.to_file(path)
    assert tconfig.KGMTConfig.from_file(path) == cfg
    want = cfg.to_dict()
    want["rollout_backend"] = "auto"  # a JAX backend name; the rest as written
    jpath = str(tmp_path / f"j{suffix}")
    tconfig.KGMTConfig(**want).to_file(jpath)
    assert dataclasses.asdict(jt.KGMTConfig.from_file(jpath)) == want
    assert cfg.footprint == (0.5, 5e-8)


def test_load_scenario_matches_jax():
    want_sc, want_grid = jcsv.load_scenario(REPO / "configurations")
    got_sc, got_grid = tcsv.load_scenario(REPO / "configurations")
    assert got_grid == want_grid == {"N": 16, "n": 16}
    for k in ("init", "goal", "obstacles"):
        np.testing.assert_array_equal(getattr(got_sc, k), getattr(want_sc, k))


def test_load_scenario_absent_grid_files_defer(tmp_path):
    for sub, text in (("init/init.csv", "1,1,0,0,0,0,0"), ("goal/goal.csv", "9,9"),
                      ("obstacles/obstacles.csv", "2,2,4,4\n7,2,9,5\n")):
        (tmp_path / sub).parent.mkdir(parents=True)
        (tmp_path / sub).write_text(text)
    sc, grid = tcsv.load_scenario(tmp_path)
    assert grid == {"N": None, "n": None}
    assert sc.obstacles.shape == (2, 4) and sc.goal[1] == 9.0 and sc.goal[2] == 0


@pytest.fixture(scope="module")
def jax_state_with_options():
    """A JAX tree-mode state of a short unicycle run with goal bias and a
    footprint, op by op, with its numpy image."""
    cfg = jt.KGMTConfig(system="unicycle", num_iterations=3, max_tree_size=2048,
                        rollouts_per_iter=256, goal_bias=0.25, footprint_width=0.5)
    with jax.disable_jit():
        r = jt.KGMT(cfg).plan(jt.Scenario.demo(), seed=3)
    s = r.state
    d = jax.device_get({**s._asdict(), "key": jax.random.key_data(s.key)})
    return cfg, s, d


def test_convert_infers_the_state_kind(jax_state_with_options):
    _, s, d = jax_state_with_options
    ps = convert.state_from_numpy(None, d, "cpu")
    assert type(ps).__name__ == "KGMTState" and ps.tree_size == int(s.tree_size) > 1
    back = convert.state_to_numpy(ps)
    for k, v in d.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)


def test_write_artifacts_values_match_jax(jax_state_with_options, tmp_path):
    cfg, s, d = jax_state_with_options
    ps = convert.state_from_numpy(None, d, "cpu")
    tcfg = tconfig.KGMTConfig(**cfg.to_dict())
    got = tcsv.write_artifacts(ps, tcfg, tmp_path / "port", extras=True)
    want = jcsv.write_artifacts(s, cfg, tmp_path / "jax", extras=True)
    names = {pathlib.Path(p).name for p in got}
    assert names == {pathlib.Path(p).name for p in want}
    assert tcsv.REFERENCE_ARTIFACT_NAMES == jcsv.REFERENCE_ARTIFACT_NAMES
    assert names == tcsv.REFERENCE_ARTIFACT_NAMES | {"R2.csv", "costs.csv"}
    for name in sorted(names):
        a = np.loadtxt(tmp_path / "port" / name, delimiter=",", ndmin=2)
        b = np.loadtxt(tmp_path / "jax" / name, delimiter=",", ndmin=2)
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a.astype(np.float32), b.astype(np.float32),
                                      err_msg=name)
    g = np.loadtxt(tmp_path / "port" / "G.csv")
    assert g.sum() == int(s.tree_size) - int(s.frontier_lo)


def test_write_artifacts_of_a_port_solve(tmp_path):
    """The port's own state writes too (tensors on its device)."""
    cfg = ct.KGMTConfig(num_iterations=2, max_tree_size=512, rollouts_per_iter=64)
    r = ct.KGMT(cfg, device="cpu").plan(ct.Scenario.demo(), seed=0)
    written = tcsv.write_artifacts(r.state, cfg, tmp_path)
    assert len(written) == 13
    samples = np.loadtxt(tmp_path / "samples.csv", delimiter=",")
    np.testing.assert_array_equal(samples.astype(np.float32),
                                  r.state.tree_samples.numpy())
