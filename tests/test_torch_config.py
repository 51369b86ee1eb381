"""cudasbmp_torch.config against cudasbmp_tpu.config, and the port's
import isolation: the package imports torch and numpy, never JAX."""

import dataclasses
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from cudasbmp_tpu import config as jconfig
from cudasbmp_torch import config as tconfig

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent


def test_config_fields_and_defaults_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(jconfig.KGMTConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tconfig.KGMTConfig)}
    assert list(jf) == list(tf)
    assert jf == tf  # rollout_backend defaults to "auto" in both
    assert tconfig.SAMPLE_DIM == jconfig.SAMPLE_DIM
    assert tconfig.STATE_DIM == jconfig.STATE_DIM
    j, t = jconfig.KGMTConfig(), tconfig.KGMTConfig()
    for prop in ("r1_size", "r2_size", "num_r1", "num_r2"):
        assert getattr(j, prop) == getattr(t, prop)


def test_backend_values_and_validation():
    for b in ("auto", "torch", "cuda", "cuda_rng"):
        tconfig.KGMTConfig(rollout_backend=b)
    for b in ("jnp", "pallas", "pallas_rng"):
        with pytest.raises(ValueError, match="rollout_backend"):
            tconfig.KGMTConfig(rollout_backend=b)
    with pytest.raises(ValueError, match="N must be"):
        tconfig.KGMTConfig(N=0)


def test_scenario_demo_and_padding_match_jax():
    j, t = jconfig.Scenario.demo(), tconfig.Scenario.demo()
    np.testing.assert_array_equal(j.init, t.init)
    np.testing.assert_array_equal(j.goal, t.goal)
    np.testing.assert_array_equal(j.obstacles, t.obstacles)
    for max_obs, pad_to in ((32, None), (8, None), (32, 16)):
        jb, jm = j.padded_obstacles(max_obs, pad_to)
        tb, tm = t.padded_obstacles(max_obs, pad_to)
        np.testing.assert_array_equal(jb, tb)
        np.testing.assert_array_equal(jm, tm)
    with pytest.raises(ValueError, match="obstacles"):
        t.padded_obstacles(4)


def test_from_file_matches_jax():
    path = str(REPO / "systems" / "car.yaml")
    assert (dataclasses.asdict(jconfig.KGMTConfig.from_file(path))
            == dataclasses.asdict(tconfig.KGMTConfig.from_file(path)))


def test_unsupported_options_raise():
    from cudasbmp_torch import KGMT

    for kw in ({"goal_bias": 0.25}, {"footprint_width": 0.5},
               {"fast_math": True}):
        with pytest.raises(NotImplementedError, match=next(iter(kw))):
            KGMT(tconfig.KGMTConfig(**kw))
    for name in ("point2d", "double_integrator", "unicycle", "dubins"):
        with pytest.raises(KeyError, match="not yet ported"):
            KGMT(tconfig.KGMTConfig(system=name))


def test_package_source_never_mentions_jax_imports():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|cudasbmp_tpu)\b", re.M)
    files = sorted((REPO / "cudasbmp_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(p) for p in files if pat.search(p.read_text())]
    assert not offenders, offenders


def test_package_imports_and_solves_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['cudasbmp_tpu'] = None\n"
        "import pkgutil, importlib, cudasbmp_torch\n"
        "for m in pkgutil.walk_packages(cudasbmp_torch.__path__, 'cudasbmp_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import torch; torch.set_num_threads(1)\n"
        "cfg = cudasbmp_torch.KGMTConfig(num_iterations=2, max_tree_size=256,\n"
        "                                rollouts_per_iter=64)\n"
        "r = cudasbmp_torch.KGMT(cfg).plan(cudasbmp_torch.Scenario.demo())\n"
        "assert r.iterations == 2 and r.tree_size > 1, r\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
