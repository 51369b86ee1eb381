"""Longer refinements (cudasbmp_torch/refine.py on the CPU, the plain twin
of kernel R1) against the JAX package's jitted refine_batch, statistically:
the chained Euler gradients are chaotic and Adam scales each gradient
component to about the learning rate, so ulp-level differences move single
paths apart after some tens of steps (tests/test_torch_refine.py holds the
first steps element for element). On 16 jittered demo problems of the
port's vmapped planner at 100 Adam steps: the counts of valid and of
improved paths within 2 of JAX's, the verdicts equal on at least 13 of 16,
and the median cost after refinement within 1% of JAX's."""

import numpy as np
import torch

import cudasbmp_torch as ct
import cudasbmp_tpu as jt
from cudasbmp_torch import refine as tr
from cudasbmp_torch.parallel import MultiQueryPlanner
from cudasbmp_tpu import refine as jr
from cudasbmp_tpu.systems.registry import get_system as jget

torch.set_num_threads(2)
SMALL = dict(num_iterations=100, max_tree_size=16384, rollouts_per_iter=2048)
B, STEPS = 16, 100


def test_refine_batch_against_jax_statistically():
    cfg, sc = ct.KGMTConfig(**SMALL), ct.Scenario.demo()
    inits = np.tile(sc.init, (B, 1)).astype(np.float32)
    goals = np.tile(sc.goal, (B, 1)).astype(np.float32)
    goals[:, :2] += np.random.default_rng(0).uniform(-1, 1, (B, 2)).astype(np.float32)
    obstacles = sc.padded_obstacles(cfg.max_obstacles)[0]
    res = MultiQueryPlanner(cfg, device="cpu").plan_batch(inits, goals, obstacles, seed=5)
    assert res.solved.all()
    paths = res.paths[:, :res.path_lengths.max()]
    got = tr.refine_batch(ct.KGMT(cfg, device="cpu").system, cfg, paths, res.path_lengths,
                          goals, obstacles, tr.RefineConfig(iterations=STEPS), device="cpu")
    want = jr.refine_batch(jget("bicycle"), jt.KGMTConfig(**SMALL), paths, res.path_lengths,
                           goals, obstacles, jr.RefineConfig(iterations=STEPS))
    valid, improved = np.asarray(want["valid"]), np.asarray(want["improved"])
    assert abs(int(got["valid"].sum()) - int(valid.sum())) <= 2
    assert abs(int(got["improved"].sum()) - int(improved.sum())) <= 2
    assert (got["valid"] == valid).sum() >= 13
    assert got["improved"].any()
    np.testing.assert_allclose(np.median(got["cost_after"]),
                               np.median(np.asarray(want["cost_after"])), rtol=1e-2)
    np.testing.assert_allclose(got["cost_before"], np.asarray(want["cost_before"]), rtol=1e-5)
