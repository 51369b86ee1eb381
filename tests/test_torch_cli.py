"""The port's CLI (python -m cudasbmp_torch.cli), in process with
``--device cpu`` at small sizes: the reference parity lines, a JSON summary
equal to KGMT.plan's, the flag-over-file override rule of the JAX CLI, the
artifact dump, the batch subcommands ``multi`` and ``sweep`` (the JAX CLI's
JSON keys, values equal to the library call's; the vmapped multi-query
planner by default), ``--shortcut``, ``--refine``, the throughput probe
``probe``, the sharded tree ``sharded``, ``profile``, ``viz`` and
``--plot``."""

import argparse
import json
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import cudasbmp_torch as ct
from cudasbmp_torch import cli
from cudasbmp_torch.utils.metrics import summarize_result
from cudasbmp_tpu import cli as jcli

torch.set_num_threads(2)
SMALL = ["--max-tree-size", "8192", "--rollouts-per-iter", "1024"]
OPTIONS = ["--goal-bias", "0.25", "--footprint-width", "0.5", "--fast-math"]
TIMING_KEYS = ("wall_time_s", "valid_rollouts_per_sec")
REPO = pathlib.Path(__file__).resolve().parent.parent
CONFIGURATIONS = str(REPO / "configurations")
UNICYCLE = str(REPO / "systems" / "unicycle.yaml")


def run(capsys, *argv) -> tuple[int, str, str]:
    rc = cli.main(list(argv))
    out, err = capsys.readouterr()
    return rc, out, err


def summary_of(out: str) -> dict:
    start = out.index("{\n")
    return json.loads(out[start:out.index("\n}", start) + 2])


def without_timing(d: dict) -> dict:
    return {k: v for k, v in d.items() if k not in TIMING_KEYS}


def test_demo_with_every_option_prints_parity_lines_and_summary(capsys):
    rc, out, _ = run(capsys, "demo", "--device", "cpu", "--seed", "3", *SMALL,
                     *OPTIONS, "--verbose")
    lines = out.splitlines()
    assert lines[0] == "Goal: 2.000000, 18.000000"
    assert re.fullmatch(r"time inside KGMT is \d+\.\d+(e-?\d+)?", lines[1])
    m = re.fullmatch(r"Iteration (\d+), Tree size (\d+)", lines[2])
    got = summary_of(out)
    assert m and (int(m[1]), int(m[2])) == (got["iterations"], got["tree_size"])
    assert "iter frontier    valid accepted tree_size accept_rate" in out
    cfg = ct.KGMTConfig(max_tree_size=8192, rollouts_per_iter=1024, seed=3,
                        goal_bias=0.25, footprint_width=0.5, fast_math=True)
    want = summarize_result(ct.KGMT(cfg, device="cpu").plan(ct.Scenario.demo()))
    assert without_timing(got) == without_timing(want)
    assert rc == (0 if want["solved"] else 1) and want["solved"]


def test_plan_configurations_with_config_file_and_artifacts(capsys, tmp_path):
    rc, out, _ = run(capsys, "plan", "--configurations", CONFIGURATIONS,
                     "--config", UNICYCLE, "--device", "cpu",
                     "--num-iterations", "4", *SMALL, "--out-dir", str(tmp_path))
    assert out.startswith("Goal: 9.000000, 9.000000\n")
    assert rc in (0, 1)
    got = summary_of(out)
    cfg = ct.KGMTConfig.from_file(UNICYCLE).replace(
        num_iterations=4, max_tree_size=8192, rollouts_per_iter=1024, n=16)
    from cudasbmp_torch.io.csv import load_scenario

    want = summarize_result(ct.KGMT(cfg, device="cpu").plan(load_scenario(CONFIGURATIONS)[0]))
    assert without_timing(got) == without_timing(want)
    assert f"wrote 13 artifact CSVs to {tmp_path}" in out
    assert len(list(tmp_path.glob("*.csv"))) == 13


def test_pathless_demo(capsys):
    rc, out, _ = run(capsys, "demo", "--device", "cpu", "--no-need-path",
                     "--max-tree-size", "16384", "--rollouts-per-iter", "2048")
    assert rc == 0 and summary_of(out)["path_length"] == 0
    rc, _, err = run(capsys, "demo", "--device", "cpu", "--no-need-path",
                     "--out-dir", "x", *SMALL)
    assert rc == 2 and "--out-dir" in err


def _parse(mod, argv):
    parser = argparse.ArgumentParser()
    mod._add_config_args(parser)
    return mod._config_from_args(parser.parse_args(argv))


def test_flag_overrides_config_file_as_in_the_jax_cli(tmp_path):
    """An explicit flag beats --config even at the dataclass default; unset
    flags defer to the file; the same rule as cudasbmp_tpu.cli."""
    path = str(tmp_path / "cfg.yaml")
    ct.KGMTConfig(seed=42, N=8, n=4, fast_math=True, goal_bias=0.5).to_file(path)
    argv = ["--config", path, "--seed", "0", "--no-fast-math"]
    got = _parse(cli, argv)
    assert (got.seed, got.N, got.n, got.fast_math, got.goal_bias) == (0, 8, 4, False, 0.5)
    want = _parse(jcli, argv)
    assert got.to_dict() == want.to_dict()


SHARDED_SMALL = ["--num-iterations", "60", "--max-tree-size", "2048",
                 "--rollouts-per-iter", "512", "--no-adaptive-waves"]
SOLVING = ["--max-tree-size", "16384", "--rollouts-per-iter", "2048"]  # seed 0 solves
SHARDED_KEYS = ["n_tree", "solved", "cost", "iterations", "total_tree_size",
                "best_shard", "path_crosses_shards", "wall_time_s"]


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A demo's artifact CSVs, dumped by the CLI."""
    out = tmp_path_factory.mktemp("artifacts")
    assert cli.main(["demo", "--device", "cpu", *SMALL, "--out-dir", str(out)]) in (0, 1)
    assert (out / "samples.csv").exists()
    return out


@pytest.mark.parametrize("case", ["viz", "viz_out", "profile", "sharded", "plan_plot",
                                  "demo_plot_without_out_dir"])
def test_ported_commands_run(capsys, tmp_path, monkeypatch, artifacts, case):
    """The commands the JAX CLI has (cudasbmp_tpu/cli.py:158-166, 309-314,
    393-460), at small sizes on the CPU: ``viz`` writes its plot,
    ``profile`` its trace, ``sharded`` the JAX CLI's JSON keys with the
    library call's values, ``--plot`` tree.png beside the artifacts, and
    ``--plot`` without ``--out-dir`` draws nothing, as in the JAX CLI."""
    if case.startswith("viz"):
        argv = ["viz", "--artifacts", str(artifacts)]
        if case == "viz_out":
            png = tmp_path / "v.png"
            argv += ["--out", str(png)]
        else:  # the default --out, tree.png in the working directory
            png = pathlib.Path("tree.png")
            monkeypatch.chdir(tmp_path)
        rc, out, err = run(capsys, *argv)
        assert rc == 0 and out == f"wrote {png}\n" and png.stat().st_size > 10_000
    elif case == "profile":
        rc, out, err = run(capsys, "profile", "--device", "cpu", "--trace-dir",
                           str(tmp_path / "trace"), *SOLVING)
        assert rc == 0
        assert re.fullmatch(rf"trace written to {re.escape(str(tmp_path / 'trace'))}; "
                            r"solved=True wall=\d+\.\d{3}s", out.strip())
        assert len(list((tmp_path / "trace").glob("*.pt.trace.json"))) == 1
    elif case == "sharded":
        rc, out, err = run(capsys, "sharded", "--device", "cpu", "--seed", "3",
                           *SHARDED_SMALL)
        got = json_of(out)
        assert list(got) == SHARDED_KEYS and got["n_tree"] == 1
        from cudasbmp_torch.parallel import ShardedTreePlanner, make_planner_mesh

        cfg = ct.KGMTConfig(num_iterations=60, max_tree_size=2048, rollouts_per_iter=512,
                            adaptive_waves=False, seed=3)
        want = ShardedTreePlanner(cfg, mesh=make_planner_mesh(n_tree=1, device="cpu")
                                  ).plan(ct.Scenario.demo())
        assert (got["solved"], got["iterations"], got["total_tree_size"],
                got["best_shard"]) == (want.solved, want.iterations,
                                       want.total_tree_size, want.best_shard)
        assert got["cost"] == (want.cost if want.solved else None)
        assert rc == (0 if want.solved else 1)
    elif case == "plan_plot":
        rc, out, err = run(capsys, "plan", "--configurations", CONFIGURATIONS,
                           "--device", "cpu", *SMALL, "--plot", "--out-dir", str(tmp_path))
        assert rc in (0, 1) and f"wrote {tmp_path}/tree.png" in out
        assert (tmp_path / "tree.png").stat().st_size > 10_000
    else:
        rc, out, err = run(capsys, "demo", "--device", "cpu", *SOLVING, "--plot")
        assert rc == 0 and "wrote" not in out and summary_of(out)["solved"]


def test_sharded_checkpoints_resume_and_refusals(capsys, tmp_path):
    """--checkpoint-dir writes a checkpoint a chunk and ends as the plain
    run; --resume-from continues one to the same summary; --resume-from
    without --checkpoint-dir, an --n-tree that does not divide the device
    count and --no-need-path exit 2, as in the JAX CLI."""
    rc, out, _ = run(capsys, "sharded", "--device", "cpu", *SHARDED_SMALL)
    plain = without_timing(json_of(out))
    rc2, out, _ = run(capsys, "sharded", "--device", "cpu", *SHARDED_SMALL,
                      "--checkpoint-dir", str(tmp_path / "a"), "--checkpoint-every", "5")
    assert rc2 == rc and without_timing(json_of(out)) == plain
    ckpts = sorted((tmp_path / "a").glob("sharded_checkpoint_*.npz"),
                   key=lambda q: int(q.stem.split("_")[-1]))
    assert [int(q.stem.split("_")[-1]) for q in ckpts][:2] == [5, 10]
    rc3, out, _ = run(capsys, "sharded", "--device", "cpu", *SHARDED_SMALL,
                      "--checkpoint-dir", str(tmp_path / "b"), "--resume-from", str(ckpts[0]))
    assert rc3 == rc and without_timing(json_of(out)) == plain
    for argv, msg in ((["--resume-from", str(ckpts[0])], "requires --checkpoint-dir"),
                      (["--n-tree", "2"], "must divide the device count 1"),
                      (["--no-need-path"], "--no-need-path")):
        rc, out, err = run(capsys, "sharded", "--device", "cpu", *argv)
        assert rc == 2 and msg in err and out == ""


def test_plots_without_matplotlib_exit_2(artifacts):
    """Where matplotlib is absent (the package does not depend on it), viz
    and demo --plot --out-dir exit 2 with a message, before any solve."""
    code = ("import sys; sys.modules['matplotlib'] = None\n"
            "import importlib.util as u; u.find_spec = lambda name, *a: None\n"
            "from cudasbmp_torch import cli\n"
            "sys.exit(cli.main(sys.argv[1:]))\n")
    for argv in (["viz", "--artifacts", str(artifacts)],
                 ["demo", "--device", "cpu", "--plot", "--out-dir", str(artifacts / "x")]):
        p = subprocess.run([sys.executable, "-c", code, *argv], cwd=REPO,
                           capture_output=True, text=True, timeout=120)
        assert p.returncode == 2 and p.stdout == "", p.stderr
        assert "matplotlib is not installed" in p.stderr
    assert not (artifacts / "x").exists()


@pytest.mark.parametrize("planner,width,rows", [("naive", 256, 3),
                                                ("costprop", 4096, 2)])
def test_probe_prints_the_reference_lines(capsys, planner, width, rows):
    """probe --device cpu: the JAX CLI's three lines (cudasbmp_tpu/cli.py:
    301-304), over ``--width`` x ``--rows`` unchecked rollouts."""
    rc, out, err = run(capsys, "probe", "--planner", planner, "--width", str(width),
                       "--rows", str(rows), "--device", "cpu")
    lines = out.splitlines()
    assert rc == 0 and err == "" and len(lines) == 3
    assert re.fullmatch(r"Kernel execution time: \d+\.\d{6} milliseconds", lines[0])
    assert lines[1] == f"Tree size: {width * rows}"
    assert json.loads(lines[2])["rollouts_per_sec"] > 0


def test_probe_needs_the_card_unless_told_otherwise(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc, out, err = run(capsys, "probe", "--width", "64")
    assert rc == 2 and "torch.cuda.is_available() is false" in err and out == ""


def test_device_cuda_without_a_card_fails_loudly(capsys):
    """No move to the CPU: --device cuda (the default) on a host without
    CUDA is an error."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc, out, err = run(capsys, "demo", *SMALL)
    assert rc == 2 and "torch.cuda.is_available() is false" in err
    assert "Goal:" not in out


@pytest.mark.parametrize("argv", [["--help"], ["demo", "--help"], ["plan", "--help"],
                                  ["sharded", "--help"], ["profile", "--help"]])
def test_help_renders(capsys, argv):
    """argparse %-formats help strings: a stray '%' would crash --help."""
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code == 0
    assert ("--device" in capsys.readouterr().out) == (argv != ["--help"])


BATCH_SMALL = ["--num-iterations", "30", "--rollouts-per-iter", "128",
               "--max-tree-size", str(128 * 31), "--seed", "1"]
BATCH_RUNS = {
    "multi": ["multi", "--impl", "arena", "--batch", "8", "--goal-jitter", "1.0",
              "--num-iterations", "4", "--rollouts-per-iter", "64",
              "--max-tree-size", "320", "--seed", "1"],
    "sweep_arena": ["sweep", "--impl", "arena", "--scenarios", "8", "--obstacles",
                    "5", *BATCH_SMALL],
    "sweep_stream": ["sweep", "--impl", "stream", "--scenarios", "10", "--pool", "4",
                     "--obstacles", "5", *BATCH_SMALL],
}


def json_of(out: str) -> dict:
    return json.loads(out[out.index("{"):out.rindex("}") + 1])


@pytest.mark.parametrize("name", list(BATCH_RUNS))
def test_batch_subcommands_print_the_jax_clis_summary(capsys, name):
    argv = BATCH_RUNS[name]
    rc, out, _ = run(capsys, *argv, "--device", "cpu")
    assert rc == 0
    got = json_of(out)
    assert jcli.main(argv) == 0
    assert list(got) == list(json_of(capsys.readouterr().out))
    cfg = ct.KGMTConfig(num_iterations=int(argv[argv.index("--num-iterations") + 1]),
                        rollouts_per_iter=int(argv[argv.index("--rollouts-per-iter") + 1]),
                        max_tree_size=int(argv[argv.index("--max-tree-size") + 1]), seed=1)
    from cudasbmp_torch import parallel

    if name == "sweep_stream":
        s = parallel.StreamingMonteCarloPlanner(cfg, pool=4, device="cpu").run(
            10, seed=1, num_obstacles=5)
        want = {"solve_rate": s.solve_rate, "cost_quantiles": s.cost_quantiles,
                "num_budget_exhausted": s.num_budget_exhausted}
    elif name == "sweep_arena":
        s = parallel.MonteCarloPlanner(cfg, impl="arena", device="cpu").run(
            8, seed=1, num_obstacles=5)
        want = {"solve_rate": s.solve_rate, "mean_tree_size": s.mean_tree_size,
                "num_budget_exhausted": s.num_budget_exhausted}
    else:
        want = {"batch": 8, "solved": got["solved"]}
    assert {k: got[k] for k in want} == want
    if name != "multi":
        assert got["solve_rate"] > 0


# the JAX CLI's JSON keys (cudasbmp_tpu/cli.py:345-352, 380-388), the same
# for every --impl of a subcommand (test_batch_subcommands_print_the_jax_clis_summary
# reads them from the JAX CLI for --impl arena)
MULTI_KEYS = ["batch", "solved", "solve_rate", "mean_cost", "wall_time_s",
              "solves_per_sec"]
SWEEP_KEYS = ["scenarios", "solve_rate", "mean_cost_solved", "mean_tree_size",
              "wall_time_s", "solves_per_sec", "num_budget_exhausted"]
VMAP_SMALL = ["--num-iterations", "40", "--rollouts-per-iter", "512",
              "--max-tree-size", "8192", "--seed", "1"]
# the demo's pairs need small_config's trees; random scenarios solve in less
DEMO_SMALL = ["--max-tree-size", "16384", "--rollouts-per-iter", "2048", "--seed", "1"]
VMAP_RUNS = {
    "multi": ["multi", "--batch", "4", *DEMO_SMALL],
    "multi_vmap": ["multi", "--impl", "vmap", "--batch", "3", "--goal-jitter", "0.5",
                   *DEMO_SMALL],
    "sweep": ["sweep", "--scenarios", "4", "--obstacles", "5", *VMAP_SMALL],
    "sweep_vmap": ["sweep", "--impl", "vmap", "--scenarios", "3", "--obstacles", "6",
                   *VMAP_SMALL],
}


@pytest.mark.parametrize("name", list(VMAP_RUNS))
def test_batch_subcommands_default_to_the_vmapped_planner(capsys, name):
    """multi and sweep with no --impl, or --impl vmap, exit 0 with the JAX
    CLI's keys and the values of MultiQueryPlanner / MonteCarloPlanner."""
    import numpy as np

    from cudasbmp_torch import parallel

    argv = VMAP_RUNS[name]
    rc, out, err = run(capsys, *argv, "--device", "cpu")
    assert rc == 0 and err == ""
    got = json_of(out)
    if argv[0] == "multi":
        cfg = ct.KGMTConfig(rollouts_per_iter=2048, max_tree_size=16384, seed=1)
        assert list(got) == MULTI_KEYS
        B, jitter = int(argv[argv.index("--batch") + 1]), 1.0
        if "--goal-jitter" in argv:
            jitter = float(argv[argv.index("--goal-jitter") + 1])
        base = ct.Scenario.demo()
        inits = np.tile(base.init, (B, 1)).astype(np.float32)
        goals = np.tile(base.goal, (B, 1)).astype(np.float32)
        goals[:, :2] += np.random.default_rng(1).uniform(
            -jitter, jitter, (B, 2)).astype(np.float32)
        res = parallel.MultiQueryPlanner(cfg, device="cpu").plan_batch(
            inits, goals, base.padded_obstacles(cfg.max_obstacles)[0], seed=1)
        want = {"batch": B, "solved": int(res.solved.sum()),
                "mean_cost": float(res.costs[res.solved].mean())}
    else:
        cfg = ct.KGMTConfig(num_iterations=40, rollouts_per_iter=512,
                            max_tree_size=8192, seed=1)
        assert list(got) == SWEEP_KEYS
        n = int(argv[argv.index("--scenarios") + 1])
        s = parallel.MonteCarloPlanner(cfg, device="cpu").run(
            n, seed=1, num_obstacles=int(argv[argv.index("--obstacles") + 1]))
        want = {"scenarios": n, "solve_rate": s.solve_rate,
                "mean_cost_solved": s.mean_cost_solved,
                "mean_tree_size": s.mean_tree_size,
                "num_budget_exhausted": s.num_budget_exhausted}
    assert {k: got[k] for k in want} == want
    assert got["solve_rate"] > 0.5 and got["solves_per_sec"] > 0


def test_demo_shortcut_prints_the_jax_clis_line(capsys):
    """demo --shortcut: the JAX CLI's line (cudasbmp_tpu/cli.py:141-143)
    after the parity lines, equal to shortcut_path on the solved path."""
    from cudasbmp_torch.shortcut import shortcut_path

    rc, out, err = run(capsys, "demo", "--device", "cpu", *DEMO_SMALL, "--shortcut")
    lines = out.splitlines()
    assert rc == 0 and err == ""
    m = re.fullmatch(r"shortcut: cost (\d+\.\d{3}) -> (\d+\.\d{3}) \((\d+) -> (\d+) edges\)",
                     lines[3])
    assert m, lines[3]
    cfg = ct.KGMTConfig(max_tree_size=16384, rollouts_per_iter=2048, seed=1)
    planner = ct.KGMT(cfg, device="cpu")
    r = planner.plan(ct.Scenario.demo())
    sc = shortcut_path(planner.system, cfg, r.path, ct.Scenario.demo().goal,
                       ct.Scenario.demo().obstacles, device="cpu")
    assert m.groups() == (f"{sc['cost_before']:.3f}", f"{sc['cost_after']:.3f}",
                          str(len(r.path) - 1), str(sc["n_edges"]))
    assert summary_of(out)["cost"] == pytest.approx(r.cost)
    rc, out, err = run(capsys, "demo", "--device", "cpu", "--no-need-path",
                       "--shortcut", *SMALL)
    assert rc == 2 and "--shortcut" in err and out == ""


def test_sweep_vmap_refuses_max_extensions():
    """The planner sweep --impl vmap builds has no restart mechanism:
    max_extensions is the arena's (cudasbmp_tpu/parallel/monte_carlo.py:
    119-131)."""
    from cudasbmp_torch import parallel

    mc = parallel.MonteCarloPlanner(ct.KGMTConfig(rollouts_per_iter=64,
                                                  max_tree_size=640),
                                    impl="vmap", device="cpu")
    with pytest.raises(ValueError, match="max_extensions requires impl='arena'"):
        mc.run(2, max_extensions=1)


@pytest.mark.parametrize("argv", [
    ["multi", "--impl", "arena"], ["sweep", "--impl", "arena"],
    ["sweep", "--impl", "stream"], ["sharded"]])
def test_batch_subcommands_reject_no_need_path(capsys, argv):
    rc, out, err = run(capsys, *argv, "--no-need-path", "--device", "cpu")
    assert rc == 2 and "--no-need-path" in err and out == ""


def test_batch_subcommands_default_to_the_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for argv in (["multi", "--impl", "arena"], ["sweep", "--impl", "stream"]):
        rc, out, err = run(capsys, *argv)
        assert rc == 2 and "torch.cuda.is_available() is false" in err and out == ""


def test_demo_refine_prints_the_jax_clis_line(capsys, monkeypatch):
    """demo --refine: the JAX CLI's line (cudasbmp_tpu/cli.py:144-152) after
    the parity lines, equal to refine_path on the solved path. RefineConfig's
    400 Adam steps take tens of seconds of the plain twin on the CPU, so the
    default is cut to 20 steps here for the CLI and the library alike."""
    import functools

    from cudasbmp_torch import refine

    monkeypatch.setattr(refine, "RefineConfig",
                        functools.partial(refine.RefineConfig, iterations=20))
    rc, out, err = run(capsys, "demo", "--device", "cpu", *DEMO_SMALL, "--refine")
    lines = out.splitlines()
    assert rc == 0 and err == ""
    m = re.fullmatch(r"refine: cost (\d+\.\d{3}) -> (\d+\.\d{3}) \((kept|rejected — "
                     r"original retained); hard-revalidation (ok|FAILED)\)", lines[3])
    assert m, lines[3]
    cfg = ct.KGMTConfig(max_tree_size=16384, rollouts_per_iter=2048, seed=1)
    planner = ct.KGMT(cfg, device="cpu")
    r = planner.plan(ct.Scenario.demo())
    want = refine.refine_path(planner.system, cfg, r.path, ct.Scenario.demo().goal,
                              ct.Scenario.demo().obstacles, device="cpu")
    kept = want["valid"] and want["cost_after"] < want["cost_before"]
    assert m.groups() == (f"{want['cost_before']:.3f}", f"{want['cost_after']:.3f}",
                          "kept" if kept else "rejected — original retained",
                          "ok" if want["valid"] else "FAILED")
    assert summary_of(out)["cost"] == pytest.approx(r.cost)
    rc, out, err = run(capsys, "demo", "--device", "cpu", "--no-need-path", "--refine",
                       *SMALL)
    assert rc == 2 and "--refine" in err and out == ""
