"""The recorded solve (KGMT.plan_recorded over kgmt_iteration), its resume,
KGMT.generate_random_tree and the CLI's ``record`` on the CPU:

- ``plan_recorded`` at 3 iterations of one wave writes the JAX package's 8
  directories and file names, and each CSV holds the values of op-by-op
  JAX's ``plan_recorded`` (integers equal; samples within 1e-3, glibc and
  SLEEF trig differing by an ulp; scores within rtol 1e-5); the checkpoint
  holds the same fields and the results agree;
- resuming from its ``checkpoint_5.npz`` ends where ``plan()`` on the same
  seed ends, bit for bit, and ``plan_recorded``'s own result is ``plan()``'s;
- ``generate_random_tree`` gives op-by-op JAX's samples: the controls to
  the bit, the states within an ulp and at least 98% of values bitwise (the
  two CPU trig libraries differ by an ulp on a few percent of inputs);
- ``record`` prints ``plan_recorded``'s summary, with the JAX CLI's keys.
"""

import json

import jax
import numpy as np
import pytest
import torch

import cudasbmp_torch as ct
import cudasbmp_tpu as jt
from cudasbmp_torch import cli
from cudasbmp_torch.convert import state_to_numpy
from cudasbmp_torch.io.checkpoint import load_checkpoint
from cudasbmp_torch.utils.metrics import summarize_result
from cudasbmp_tpu import cli as jcli

torch.set_num_threads(2)
DIRS = ("Samples", "Parents", "R1Scores", "R1Avail", "R1", "G", "UnexploredSamples",
        "UParentIdx")
EXACT = ("Parents", "R1Avail", "R1", "G", "UParentIdx")
ONE_WAVE = dict(num_iterations=3, max_tree_size=8192, rollouts_per_iter=1024,
                adaptive_waves=False)
SMALL = dict(num_iterations=100, max_tree_size=16384, rollouts_per_iter=2048)
TIMING_KEYS = ("wall_time_s", "valid_rollouts_per_sec")


def _files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def test_recorded_csvs_match_op_by_op_jax(tmp_path):
    got = ct.KGMT(ct.KGMTConfig(**ONE_WAVE), device="cpu").plan_recorded(
        ct.Scenario.demo(), tmp_path / "port", seed=4, checkpoint_every=2)
    with jax.disable_jit():
        want = jt.KGMT(jt.KGMTConfig(**ONE_WAVE)).plan_recorded(
            jt.Scenario.demo(), str(tmp_path / "jax"), seed=4, checkpoint_every=2)
    port, jax_dir = tmp_path / "port", tmp_path / "jax"
    names = _files(port)
    assert names == _files(jax_dir)
    assert sorted({n.split("/")[0] for n in names if "/" in n}) == sorted(DIRS)
    assert "Samples/samples3.csv" in names and "checkpoint_2.npz" in names
    for name in names:
        if name.endswith(".npz"):
            continue
        a = np.loadtxt(port / name, delimiter=",", ndmin=2)
        b = np.loadtxt(jax_dir / name, delimiter=",", ndmin=2)
        kind = name.split("/")[0]
        if kind in EXACT:
            np.testing.assert_array_equal(a, b, err_msg=name)
        elif kind == "R1Scores":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=0, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-3, err_msg=name)
    with np.load(port / "checkpoint_2.npz") as p, np.load(jax_dir / "checkpoint_2.npz") as j:
        assert set(j.files) <= set(p.files)
        for k in j.files:
            if p[k].dtype.kind == "f":
                np.testing.assert_allclose(p[k], j[k], rtol=1e-5, atol=1e-3, err_msg=k)
            else:
                np.testing.assert_array_equal(p[k], j[k], err_msg=k)
    assert (got.solved, got.iterations, got.tree_size) == (
        want.solved, want.iterations, want.tree_size)
    for k in ("valid", "accepted", "tree_size", "frontier_size"):
        np.testing.assert_array_equal(got.metrics[k], np.asarray(want.metrics[k]))


def test_resume_from_a_recorded_checkpoint_ends_where_plan_ends(tmp_path):
    cfg = ct.KGMTConfig(**SMALL)
    planner = ct.KGMT(cfg, device="cpu")
    recorded = planner.plan_recorded(ct.Scenario.demo(), tmp_path, seed=3, dump_every=4,
                                     checkpoint_every=5)
    want = planner.plan(ct.Scenario.demo(), seed=3)
    assert want.solved and want.iterations > 5
    assert (tmp_path / "Samples" / "samples5.csv").exists()
    assert not (tmp_path / "Samples" / "samples2.csv").exists()
    state = load_checkpoint(tmp_path / "checkpoint_5.npz", device="cpu")
    assert state.itr == 5
    got = planner.resume(state, ct.Scenario.demo())
    for r in (got, recorded):
        assert (r.solved, r.iterations, r.tree_size, r.cost) == (
            want.solved, want.iterations, want.tree_size, want.cost)
        np.testing.assert_array_equal(r.path.view(np.uint32), want.path.view(np.uint32))
        for k in ("valid", "accepted", "tree_size", "frontier_size"):
            np.testing.assert_array_equal(r.metrics[k], want.metrics[k])
    a, b = state_to_numpy(got.state), state_to_numpy(want.state)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with pytest.raises(ValueError, match="tree-mode"):
        ct.KGMT(cfg.replace(need_path=False), device="cpu").plan_recorded(
            ct.Scenario.demo(), tmp_path / "x")


def test_generate_random_tree_is_the_naive_probe():
    cfg = ct.KGMTConfig()
    got = ct.KGMT(cfg, device="cpu").generate_random_tree(ct.Scenario.demo(), 1024 * 10)
    with jax.disable_jit():
        want = jt.KGMT(jt.KGMTConfig()).generate_random_tree(jt.Scenario.demo(),
                                                             1024 * 10)
    assert got.num_rollouts == want.num_rollouts == 10 * 1024
    ours, theirs = got.samples, np.asarray(want.samples)
    assert ours.shape == theirs.shape == (10, 1024, 7)
    np.testing.assert_array_equal(ours[..., 4:], theirs[..., 4:])  # the controls
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=1e-6)
    assert (ours.view(np.int32) == theirs.view(np.int32)).mean() >= 0.98


def test_record_subcommand(capsys, tmp_path):
    argv = ["record", "--out-dir", str(tmp_path / "port"), "--num-iterations", "4",
            "--max-tree-size", "8192", "--rollouts-per-iter", "1024", "--seed", "2",
            "--checkpoint-every", "2"]
    rc = cli.main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out
    got = json.loads(out)
    cfg = ct.KGMTConfig(num_iterations=4, max_tree_size=8192, rollouts_per_iter=1024,
                        seed=2)
    want = summarize_result(ct.KGMT(cfg, device="cpu").plan_recorded(
        ct.Scenario.demo(), tmp_path / "lib"))
    assert rc == (0 if want["solved"] else 1)
    assert {k: v for k, v in got.items() if k not in TIMING_KEYS} == {
        k: v for k, v in want.items() if k not in TIMING_KEYS}
    assert (tmp_path / "port" / "checkpoint_4.npz").exists()
    assert _files(tmp_path / "port") == _files(tmp_path / "lib") + [
        "checkpoint_2.npz", "checkpoint_4.npz"]
    jcli.main(["record", "--out-dir", str(tmp_path / "jax"), "--num-iterations", "1",
               "--max-tree-size", "8192", "--rollouts-per-iter", "1024"])
    assert list(got) == list(json.loads(capsys.readouterr().out))
