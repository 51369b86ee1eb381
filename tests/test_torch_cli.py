"""The port's CLI (python -m cudasbmp_torch.cli), in process with
``--device cpu`` at small sizes: the reference parity lines, a JSON summary
equal to KGMT.plan's, the flag-over-file override rule of the JAX CLI, the
artifact dump, and exit code 2 for what is not yet ported."""

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
    want = summarize_result(ct.KGMT(cfg).plan(ct.Scenario.demo()))
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

    want = summarize_result(ct.KGMT(cfg).plan(load_scenario(CONFIGURATIONS)[0]))
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
    ["probe"], ["viz", "--artifacts", "x"], ["record", "--out-dir", "x"],
    ["profile", "--trace-dir", "x"], ["multi", "--batch", "2"], ["sweep"],
    ["sharded"], ["demo", "--device", "cpu", "--shortcut"],
    ["demo", "--device", "cpu", "--refine"], ["demo", "--device", "cpu", "--plot"],
])
def test_not_yet_ported_exits_2(capsys, argv):
    rc, out, err = run(capsys, *argv)
    assert rc == 2 and "not yet ported" in err and out == ""


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
