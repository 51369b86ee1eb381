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


def test_scenario_dense_matches_jax():
    for n, seed in ((24, 0), (40, 3)):
        j, t = jconfig.Scenario.dense(n, seed), tconfig.Scenario.dense(n, seed)
        for k in ("init", "goal", "obstacles"):
            np.testing.assert_array_equal(getattr(t, k), getattr(j, k))
        assert t.obstacles.shape == (n, 4)


def test_from_file_matches_jax():
    path = str(REPO / "systems" / "car.yaml")
    assert (dataclasses.asdict(jconfig.KGMTConfig.from_file(path))
            == dataclasses.asdict(tconfig.KGMTConfig.from_file(path)))


def test_unsupported_options_raise():
    """goal_bias, footprint_width and fast_math plan now, on every system of
    the registry, and expansion_wave takes the sharded exchange pool; a
    system name no registry knows raises."""
    import torch as _torch

    from cudasbmp_torch import KGMT
    from cudasbmp_torch.planners import kgmt as tk

    for name in ("bicycle", "point2d", "double_integrator", "unicycle", "dubins"):
        cfg = tconfig.KGMTConfig(system=name, num_iterations=2, max_tree_size=256,
                                 rollouts_per_iter=64, goal_bias=0.25,
                                 footprint_width=0.5, fast_math=True)
        r = KGMT(cfg, device="cpu").plan(tconfig.Scenario.demo())
        assert r.iterations == 2 and r.tree_size > 1, name
    planner = KGMT(cfg, device="cpu")
    sc = tconfig.Scenario.demo()
    s = tk.init_state(cfg, planner.grid, _torch.tensor(sc.init), tk.rng.key(0))
    pool = (_torch.ones((2, 7)), _torch.tensor([5, -1], dtype=_torch.int32),
            _torch.ones(2))
    gid = tk.expansion_wave(cfg, planner.system, _torch.tensor(sc.obstacles),
                            _torch.tensor(sc.goal), s, pool=pool, gid_base=256)[1]
    n_pool = round(cfg.exchange_frac * 64)
    assert (gid[64 - n_pool:][::2] == 5).all() and (gid[:64 - n_pool] == 256).all()
    with pytest.raises(KeyError, match="unknown system"):
        KGMT(tconfig.KGMTConfig(system="quadrotor"), device="cpu")


def test_package_source_never_mentions_jax_imports():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|cudasbmp_tpu)\b", re.M)
    files = sorted((REPO / "cudasbmp_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(p) for p in files if pat.search(p.read_text())]
    assert not offenders, offenders


def test_package_imports_and_solves_with_jax_blocked():
    """Every module of the port, parallel/ and probes/ included, imports
    with JAX and the JAX package blocked, and the single query, the arena
    sweep, the streaming sweep, the vmap sweep and multi-query planner, the
    shortcut, the probe planners, the throughput probe, the refinement, the
    recorded solve and a resume from its checkpoint, the sharded tree
    (chunked, with checkpoints), the sharded multi-query planner,
    ``run_sharded`` and the distribution layer's entry point (a no-op
    without torchrun's environment), the state validator, the Agent model,
    a profiler trace, the edge replay of the plots and a registered system
    with only ``step`` (the generic rollout) run."""
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
        "r = cudasbmp_torch.KGMT(cfg, device='cpu').plan(cudasbmp_torch.Scenario.demo())\n"
        "assert r.iterations == 2 and r.tree_size > 1, r\n"
        "from cudasbmp_torch import parallel\n"
        "s = parallel.MonteCarloPlanner(cfg, impl='arena', device='cpu').run(4, num_obstacles=5)\n"
        "assert s.costs.shape == (4,), s\n"
        "s = parallel.StreamingMonteCarloPlanner(cfg, pool=2, device='cpu').run(\n"
        "    4, num_obstacles=5)\n"
        "assert s.iters.shape == (4,), s\n"
        "s = parallel.MonteCarloPlanner(cfg, device='cpu').run(3, num_obstacles=5)\n"
        "assert s.costs.shape == (3,), s\n"
        "import numpy as np\n"
        "sc = cudasbmp_torch.Scenario.demo()\n"
        "m = parallel.MultiQueryPlanner(cfg, device='cpu').plan_scenarios([sc, sc])\n"
        "assert m.paths.shape == (2, 3, 7), m\n"
        "from cudasbmp_torch.shortcut import ShortcutConfig, shortcut_batch\n"
        "o = shortcut_batch(cudasbmp_torch.KGMT(cfg, device='cpu').system, cfg,\n"
        "                   m.paths, m.path_lengths, np.stack([sc.goal] * 2),\n"
        "                   sc.obstacles, ShortcutConfig(rounds=2, candidates=8),\n"
        "                   device='cpu')\n"
        "assert o['paths'].shape == (2, 3, 7), o\n"
        "from cudasbmp_torch.planners import CostPropPlanner, NaivePlanner\n"
        "for P in (NaivePlanner, CostPropPlanner):\n"
        "    assert P(width_rollouts=64, rows=2, device='cpu').plan(\n"
        "        cudasbmp_torch.Scenario.demo()).samples.shape == (2, 64, 7)\n"
        "from cudasbmp_torch.probes import roofline, throughput\n"
        "r = throughput.measure_prop_throughput(64, 1, 'cuda_rng', dense=True,\n"
        "                                       cull=2, device='cpu')\n"
        "assert r['wall_rollouts_per_sec'] > 0, r\n"
        "assert roofline.ops_per_lane('bicycle', False, False, 8, 10, False) == 542\n"
        "for name in ('refine', 'io.checkpoint', 'ops.refine_cuda'):\n"
        "    assert 'cudasbmp_torch.' + name in sys.modules, name\n"
        "from cudasbmp_torch.refine import RefineConfig, refine_batch\n"
        "o = refine_batch(cudasbmp_torch.KGMT(cfg, device='cpu').system, cfg, m.paths,\n"
        "                 np.maximum(m.path_lengths, 2), np.stack([sc.goal] * 2),\n"
        "                 sc.obstacles, RefineConfig(iterations=2), device='cpu')\n"
        "assert o['controls'].shape == (2, 2, 3), o\n"
        "import tempfile\n"
        "from cudasbmp_torch.io.checkpoint import load_checkpoint\n"
        "d = tempfile.mkdtemp()\n"
        "p = cudasbmp_torch.KGMT(cfg, device='cpu')\n"
        "r = p.plan_recorded(sc, d, checkpoint_every=1)\n"
        "assert p.resume(load_checkpoint(d + '/checkpoint_1.npz', device='cpu'),\n"
        "                sc).tree_size == r.tree_size\n"
        "for name in ('models', 'viz', 'utils.validate', 'utils.profiling',\n"
        "             'parallel.mesh', 'parallel.sharded_tree', 'parallel.collectives',\n"
        "             'parallel.sharded_multi_query'):\n"
        "    assert 'cudasbmp_torch.' + name in sys.modules, name\n"
        "mesh = parallel.make_planner_mesh(n_tree=2, device='cpu')\n"
        "res = parallel.ShardedTreePlanner(cfg, mesh=mesh).plan_checkpointed(\n"
        "    sc, d + '/sharded', checkpoint_every=1)\n"
        "assert res.iterations == 2 and res.tree_sizes_by_shard.shape == (2,), res\n"
        "mesh = parallel.make_planner_mesh(n_scenario=2, n_tree=2, device='cpu')\n"
        "q = parallel.ShardedMultiQueryPlanner(cfg, mesh=mesh).plan_scenarios([sc, sc])\n"
        "assert q.iterations.tolist() == [2, 2] and len(q.paths) == 2, q\n"
        "s = parallel.StreamingMonteCarloPlanner(cfg, pool=2, device='cpu').run_sharded(\n"
        "    4, mesh=mesh, num_obstacles=5)\n"
        "assert s.iters.shape == (4,), s\n"
        "assert parallel.maybe_initialize_distributed('cpu') is False\n"
        "from cudasbmp_torch.utils.validate import validate_state\n"
        "assert validate_state(r.state, cfg)['tree_size'] == r.tree_size\n"
        "from cudasbmp_torch.models import Agent\n"
        "a = Agent(v=1.0)\n"
        "a.update_state(1.0, 0.1, 0.1)\n"
        "assert a.x > 0 and a.v > 1.0, a\n"
        "from cudasbmp_torch.utils.profiling import trace_to\n"
        "with trace_to(d + '/trace'):\n"
        "    p.plan(sc)\n"
        "from cudasbmp_torch import viz\n"
        "t = r.state.tree_samples[:r.tree_size].numpy()\n"
        "e = viz._integrate_edges(p.system, t[:-1], t[1:, 4:7], cfg.num_disc)\n"
        "assert e.shape == (r.tree_size - 1, cfg.num_disc + 1, 4), e.shape\n"
        "import dataclasses\n"
        "from cudasbmp_torch.systems import ControlSpec, register_system\n"
        "@dataclasses.dataclass(frozen=True)\n"
        "class Drift:\n"
        "    name: str = 'drift'\n"
        "    state_dim: int = 4\n"
        "    control_spec: ControlSpec = ControlSpec((-3.0, -3.0, 0.05), (3.0, 3.0, 1.05))\n"
        "    def step(self, s, c, dt):\n"
        "        x, y, vx, vy = s.unbind(-1)\n"
        "        return torch.stack([x + vx * dt, y + vy * dt, vx + (c[..., 0] - 0.3 * vx)\n"
        "                            * dt, vy + (c[..., 1] - 0.3 * vy) * dt], -1)\n"
        "register_system('drift', Drift)\n"
        "r = cudasbmp_torch.KGMT(dataclasses.replace(cfg, system='drift'), device='cpu'\n"
        "                        ).plan(sc)\n"
        "assert r.iterations == 2 and r.metrics['rollout'] == 'generic', r\n"
        "assert 'jax' not in sys.modules or sys.modules['jax'] is None\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
