"""The port's distribution layer over two processes (cudasbmp_torch/
parallel/mesh.py, collectives.py and the planners' ``mesh=``) on the CPU.

Two ranks join a ``gloo`` group through torchrun's environment variables
(``maybe_initialize_distributed``) and run the cases of
tests/torch_distributed_cases.py at the small sizes of tests/test_parallel.py;
this process runs the same cases with no process group, every mesh position
its own. Each rank's results must be this process's bit for bit: the
sharded tree at four shards, two a rank (result, path and every stacked
state field), the same tree with rank 0's shards walled in (it runs the
collectives all the same), the vmapped, arena and Monte-Carlo batch
planners over the scenario axis, ``run_sharded`` (also against ``run`` on
one pool, the check of tests/test_multihost.py:91-103) and the sharded
multi-query planner with its tree axis over the ranks. Every child has a
timeout and is killed when the fixture ends. The kill-and-restart of a
checkpointed solve is in tests/test_torch_distributed_recovery.py."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_distributed_cases as cases
from cudasbmp_torch.config import KGMTConfig
from cudasbmp_torch.parallel import StreamingMonteCarloPlanner, mesh as tmesh

WORLD = 2
TIMEOUT_S = 240


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(args: list[str]) -> list[subprocess.Popen]:
    """WORLD children running ``python <args> <rank>``-style commands built
    by the caller (``{rank}`` in an argument is the child's rank)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, *(a.format(rank=r) for a in args)], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(this process's results, each rank's results)."""
    out = tmp_path_factory.mktemp("ranks")
    procs = start_ranks([cases.__file__, "{rank}", str(WORLD), str(free_port()), str(out)])
    try:
        torch.set_num_threads(2)
        ref = cases.run_cases()
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}: exit {p.returncode}\n{log[-3000:]}"
    return ref, [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


def assert_ranks_equal(runs, prefix: str) -> dict:
    ref, ranks = runs
    names = [k for k in ref if k.startswith(prefix + "/")]
    assert names
    for r, got in enumerate(ranks):
        for k in names:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=f"rank {r}: {k}")
    return {k[len(prefix) + 1:]: ref[k] for k in names}


def test_mesh_shapes_over_two_ranks(runs):
    """tests/test_parallel.py::test_mesh_shapes over two ranks: the default
    mesh fills the world on the scenario axis, a 2x4 takes four positions a
    rank, a 3x3 does not split over two ranks; device_count is the world."""
    ref, ranks = runs
    for r, got in enumerate(ranks):
        assert got["mesh/device_count"] == WORLD
        np.testing.assert_array_equal(got["mesh/default"], [2, 1, 2, r, r, r + 1, 0, 1])
        np.testing.assert_array_equal(got["mesh/2x4"], [2, 4, 2, r, r, r + 1, 0, 4])
        assert got["mesh/3x3_refused"]
    np.testing.assert_array_equal(ref["mesh/default"], [1, 1, 1, 0, 0, 1, 0, 1])
    assert not ref["mesh/3x3_refused"]


def test_sharded_tree_over_two_ranks_is_the_one_process_solve(runs):
    """Four shards, two a rank: cost, path, every stacked state field and
    the trips, bitwise; the path crosses from one rank's shards to the
    other's."""
    got = assert_ranks_equal(runs, "tree")
    assert got["solved"] and got["state/itr"].tolist() == [int(got["iterations"])] * 4
    shards = set(got["path_shards"].tolist())
    assert shards & {0, 1} and shards & {2, 3}, shards
    assert (got["r1_scores_by_shard"] == got["r1_scores_by_shard"][0]).all()


def test_walled_in_rank_still_runs_the_collectives(runs):
    """Rank 0's shards rooted inside a box: with the exchange they grow from
    rank 1's nodes; without it they stay at their roots while their rank
    runs every iteration's collectives with the other, and both solves
    equal the one-process solves."""
    with_ex = assert_ranks_equal(runs, "sterile_with")
    without = assert_ranks_equal(runs, "sterile_without")
    assert with_ex["solved"] and without["solved"]
    assert (with_ex["tree_sizes_by_shard"][:2] > 1).all()
    assert (without["tree_sizes_by_shard"][:2] == 1).all()
    assert (without["tree_sizes_by_shard"][2:] > 1).all()


def test_multi_query_over_two_ranks_is_bitwise_no_mesh(runs):
    got = assert_ranks_equal(runs, "multi")
    assert got["solved"].any() and not got["solved"].all()


@pytest.mark.parametrize("backend", ["auto", "cuda_rng"])
def test_arena_over_two_ranks_is_bitwise_no_mesh(runs, backend):
    """Shared boxes, one extension round (its bucket of 8 split over the
    ranks); under cuda_rng rank 1 draws its lanes of the batch's Philox
    launch from lane 2 * 128 on."""
    got = assert_ranks_equal(runs, f"arena_{backend}")
    assert got["solved"].any() and got["budget_exhausted"].any()


def test_monte_carlo_over_two_ranks_is_bitwise_no_mesh(runs):
    got = assert_ranks_equal(runs, "monte_carlo")
    assert got["solved"].any()


def test_run_sharded_over_two_ranks_is_one_pool(runs):
    """One pool of 2 a rank over ids [0, 4) and [4, 8): the single pool of
    4's sweep, bit for bit."""
    got = assert_ranks_equal(runs, "stream")
    torch.set_num_threads(2)
    single = StreamingMonteCarloPlanner(KGMTConfig(**cases.STREAM), pool=4,
                                        device="cpu").run(8, seed=5, num_obstacles=5)
    np.testing.assert_array_equal(got["costs"], single.costs)
    np.testing.assert_array_equal(got["iters"], single.iters)


def test_sharded_multi_query_over_two_ranks(runs):
    """Two problems of four shards, two shards of each a rank: each
    problem's statistics and pool cross the ranks."""
    got = assert_ranks_equal(runs, "smq")
    assert got["solved"].all()
    crossing = [set(got[f"path_shards{b}"].tolist()) for b in range(2)]
    assert any(s & {0, 1} and s & {2, 3} for s in crossing), crossing


def test_backend_rule(monkeypatch):
    """nccl only where every rank of the host has a card of its own."""
    assert tmesh.backend_for("cpu", 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tmesh.backend_for("cuda", 2) == "nccl"
    assert tmesh.backend_for("cuda", 4) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tmesh.backend_for("cuda", 2) == "gloo"
    for name in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    assert tmesh.maybe_initialize_distributed("cpu") is False


def test_layouts_and_refusals(monkeypatch):
    """Positions over ranks, scenario outermost: a rank holds whole slots or
    an equal share of one slot's tree axis; the rest is refused with the
    sizes."""
    m = tmesh.PlannerMesh(n_scenario=2, n_tree=4, device="cpu", world=4, rank=3)
    assert m.local_range("scenario") == (1, 2) and m.local_range("tree") == (2, 4)
    assert m.spans("tree") and m.spans("scenario") and m.batch_range(6) == (3, 6)
    assert tmesh._axis_ranks(2, 4, 4, "tree") == [[0, 1], [2, 3]]
    assert tmesh._axis_ranks(2, 4, 4, "scenario") == [[0, 2], [1, 3]]
    m = tmesh.PlannerMesh(n_scenario=4, n_tree=2, device="cpu", world=2, rank=1)
    assert m.local_range("scenario") == (2, 4) and not m.spans("tree")
    assert tmesh._axis_ranks(4, 2, 2, "scenario") == [[0, 1]]
    monkeypatch.setattr(tmesh, "_world", lambda: (3, 0))
    with pytest.raises(ValueError, match="4 positions do not split evenly over 3"):
        tmesh.make_planner_mesh(n_scenario=1, n_tree=4, device="cpu")
    monkeypatch.setattr(tmesh, "_world", lambda: (2, 0))
    with pytest.raises(ValueError, match="split a scenario slot's 2 tree positions"):
        tmesh.make_planner_mesh(n_scenario=3, n_tree=2, device="cpu")


def test_cli_under_torchrun(capsys):
    """``torchrun --nproc-per-node 2 -m cudasbmp_torch.cli multi|sharded
    --device cpu``: rank 0 alone prints, and the summary is the one-process
    run's (multi: the CLI in this process; sharded: its tree axis defaults
    to the world's two devices, so the library's two-shard solve)."""
    import json

    from cudasbmp_torch import cli
    from cudasbmp_torch.config import Scenario
    from cudasbmp_torch.parallel import ShardedTreePlanner, make_planner_mesh

    multi = ["multi", "--impl", "arena", "--batch", "4", "--device", "cpu",
             "--rollouts-per-iter", "128", "--num-iterations", "12", "--max-tree-size", "1664"]
    sharded = ["sharded", "--device", "cpu", "--max-tree-size", "4096",
               "--rollouts-per-iter", "512", "--no-adaptive-waves"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-m", "torch.distributed.run",
                               "--nproc-per-node", str(WORLD), "--master-port",
                               str(free_port()), "-m", "cudasbmp_torch.cli", *argv],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for argv in (multi, sharded)]
    try:
        torch.set_num_threads(2)
        assert cli.main(multi) == 0
        want = json.loads(capsys.readouterr().out)
        ref = ShardedTreePlanner(KGMTConfig(max_tree_size=4096, rollouts_per_iter=512,
                                            adaptive_waves=False),
                                 mesh=make_planner_mesh(n_tree=WORLD, device="cpu")
                                 ).plan(Scenario.demo())
        outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode in (0, 1), err[-3000:]
        assert out.count('"wall_time_s"') == 1, out
    got = [json.loads(out) for out, _ in outs]
    drop = ("wall_time_s", "solves_per_sec")
    assert {k: v for k, v in got[0].items() if k not in drop} == {
        k: v for k, v in want.items() if k not in drop}
    assert got[1]["n_tree"] == WORLD and got[1]["solved"] == ref.solved
    assert got[1]["cost"] == (ref.cost if ref.solved else None)
    assert got[1]["iterations"] == ref.iterations
    assert got[1]["total_tree_size"] == ref.total_tree_size
