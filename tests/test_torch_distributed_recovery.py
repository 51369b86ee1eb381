"""Kill and restart of the port's checkpointed sharded tree over two
processes on the CPU (the port's counterpart of
tests/test_multihost.py:136-260): two ``gloo`` ranks run
``plan_checkpointed`` at four shards, two a rank; rank 1 is SIGKILLed after
the first checkpoint (rank 0, left in a collective, is killed too, as a
job scheduler would); a fresh two-rank job resumes from the newest
checkpoint and finishes with the uninterrupted solve's cost, iterations
and path digest. The checkpoint, written by rank 0 alone, holds the whole
stacked state in the JAX package's layout: it resumes in one process too,
and loads in the JAX package. Every child has a timeout and is killed when
the fixture ends."""

import signal
import time

import numpy as np
import pytest
import torch

import torch_distributed_cases as cases
from cudasbmp_torch.config import KGMTConfig, Scenario
from cudasbmp_torch.parallel import ShardedTreePlanner, make_planner_mesh
from test_torch_distributed import TIMEOUT_S, WORLD, free_port, start_ranks


def reference():
    torch.set_num_threads(2)
    p = ShardedTreePlanner(KGMTConfig(**cases.SHARDED),
                           mesh=make_planner_mesh(n_tree=cases.D, device="cpu"))
    return p.plan(Scenario.demo(), seed=0)


@pytest.fixture(scope="module")
def recovered(tmp_path_factory):
    """(the uninterrupted solve, the checkpoint directory, the resumed
    ranks' output lines)."""
    ckpt_dir = tmp_path_factory.mktemp("ckpt")
    script = [cases.__file__, "{rank}", str(WORLD)]
    victims = start_ranks([*script, str(free_port()), str(ckpt_dir), "victim"])
    try:
        ref = reference()
        deadline = time.monotonic() + TIMEOUT_S
        while not cases.checkpoints(ckpt_dir) and time.monotonic() < deadline:
            assert all(v.poll() is None for v in victims), "a rank ended before the kill"
            time.sleep(0.05)
        assert cases.checkpoints(ckpt_dir), "no checkpoint within the timeout"
        victims[1].send_signal(signal.SIGKILL)
        victims[1].wait(timeout=TIMEOUT_S)
        assert victims[1].returncode == -signal.SIGKILL
        victims[0].send_signal(signal.SIGKILL)
        out0 = victims[0].communicate(timeout=TIMEOUT_S)[0]
        assert "FINISHED_UNKILLED" not in out0, "the kill landed after the solve"
    finally:
        for v in victims:
            if v.poll() is None:
                v.kill()
                v.wait()
    killed_at = cases.checkpoints(ckpt_dir)[0].name
    resumers = start_ranks([*script, str(free_port()), str(ckpt_dir), "resume"])
    try:
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in resumers]
    finally:
        for p in resumers:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(resumers, logs)):
        assert p.returncode == 0, f"resumed rank {r}: exit {p.returncode}\n{log[-3000:]}"
    return ref, ckpt_dir, killed_at, logs


def test_kill_and_restart_resumes_to_the_uninterrupted_solve(recovered):
    ref, _, killed_at, logs = recovered
    assert ref.solved
    n = int(killed_at.split("_")[-1].split(".")[0])
    assert 0 < n < ref.iterations, killed_at
    for r, log in enumerate(logs):
        assert f"{cases.result_line(ref)} from={killed_at}" in log, f"rank {r}: {log[-1500:]}"


def test_a_two_rank_checkpoint_resumes_in_one_process(recovered, tmp_path):
    """Rank 0's file holds every shard: one process with the same tree axis
    resumes it to the same solve."""
    ref, ckpt_dir, killed_at, _ = recovered
    torch.set_num_threads(2)
    p = ShardedTreePlanner(KGMTConfig(**cases.SHARDED),
                           mesh=make_planner_mesh(n_tree=cases.D, device="cpu"))
    r = p.plan_checkpointed(Scenario.demo(), tmp_path, checkpoint_every=2,
                            resume_from=ckpt_dir / killed_at)
    assert cases.result_line(r) == cases.result_line(ref)
    np.testing.assert_array_equal(r.tree_sizes_by_shard, ref.tree_sizes_by_shard)


def test_the_checkpoint_loads_in_the_jax_package(recovered):
    """The JAX package's loader reads the whole stacked state: four shards,
    one iteration count."""
    from cudasbmp_tpu.io.checkpoint import load_checkpoint

    _, ckpt_dir, killed_at, _ = recovered
    state = load_checkpoint(ckpt_dir / killed_at)
    n = int(killed_at.split("_")[-1].split(".")[0])
    assert np.asarray(state.itr).tolist() == [n] * cases.D
    assert np.asarray(state.tree_samples).shape == (cases.D, cases.SHARDED["max_tree_size"], 7)
