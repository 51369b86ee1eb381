"""The port's CLI (python -m cudasbmp_torch.cli), in process with
``--device cpu`` at small sizes: the reference parity lines, a JSON summary
equal to KGMT.plan's, the flag-over-file override rule of the JAX CLI, the
artifact dump, the batch subcommands ``multi`` and ``sweep`` (the JAX CLI's
JSON keys, values equal to the library call's; the vmapped multi-query
planner by default), ``--shortcut``, ``--refine``, the throughput probe
``probe``, and exit code 2 for what is not yet ported."""

import argparse
import json
import pathlib
import re

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


@pytest.mark.parametrize("argv", [
    ["viz", "--artifacts", "x"], ["viz", "--out", "tree.png"],
    ["profile", "--trace-dir", "x"], ["sharded"],
    ["plan", "--configurations", CONFIGURATIONS, "--device", "cpu", "--plot"],
    ["demo", "--device", "cpu", "--plot"],
])
def test_not_yet_ported_exits_2(capsys, argv):
    rc, out, err = run(capsys, *argv)
    assert rc == 2 and "not yet ported" in err and out == ""


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


@pytest.mark.parametrize("argv", [["--help"], ["demo", "--help"], ["plan", "--help"]])
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
    ["sweep", "--impl", "stream"]])
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
