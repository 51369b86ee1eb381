"""The port's sharded-tree planner (cudasbmp_torch/parallel/sharded_tree.py)
against the JAX package's, on the CPU.

Against op-by-op JAX (``jax.disable_jit``) on the same seeded numpy
inputs, the port with ``rollout_backend="torch"`` (the plain rollout in the
JAX function's op order): the exchange pool, ``expansion_wave`` with a pool and a
``gid_base``, ``stitch_path``, and whole sharded iterations. JAX's sharded
iteration is ``kgmt_iteration`` with ``axis_name`` under ``jax.vmap`` over
the named axis (psum, all_gather and axis_index as in ``shard_map``). Its
sub-wave ``lax.while_loop`` has a per-shard trip count, so under ``vmap``
it cannot run as a Python loop and would be compiled (XLA:CPU then
contracts FMAs); the tests run it instead as the batched while loop's
definition, a fixed count of masked trips (every shard runs the body, a
shard past its own count keeps its old carry), each primitive op by op.
Every field is bitwise JAX's (ids, parents, counts, keys, costs, controls)
except the rolled-out states, which glibc's and SLEEF's cos, sin and tan
put an ulp apart, and the region scores, whose 256-term sum XLA orders its
own way (``_math.row_sum``): those within STATE_TOL.
The invariants of tests/test_parallel.py and the checkpoints are in
tests/test_torch_sharded_tree_invariants.py, the whole solve against jitted
JAX, statistically, in tests/test_torch_sharded_tree_stats.py."""

import contextlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cudasbmp_torch as ct
import cudasbmp_tpu as jt
from cudasbmp_torch.parallel import ShardedTreePlanner, make_planner_mesh
from cudasbmp_torch.parallel import sharded_tree as st
from cudasbmp_torch.planners import kgmt as tk
from cudasbmp_tpu.geometry.grid import RegionGrid as JGrid
from cudasbmp_tpu.parallel import sharded_tree as jst
from cudasbmp_tpu.planners import kgmt as jk
from cudasbmp_tpu.systems.registry import get_system as jget_system

torch.set_num_threads(2)
STATE_TOL = dict(rtol=1e-5, atol=1e-5)
# the exact tests' sizes (one set of shapes: op-by-op JAX compiles each
# primitive once a shape)
SMALL = dict(num_iterations=20, max_tree_size=512, rollouts_per_iter=128, exchange_k=16,
             rollout_backend="torch")


def planner(cfg: dict, D: int) -> ShardedTreePlanner:
    return ShardedTreePlanner(ct.KGMTConfig(**cfg),
                              mesh=make_planner_mesh(n_scenario=1, n_tree=D, device="cpu"))


def port_state(cfg: dict, D: int, iterations: int, seed: int = 0, inits=None):
    """The port's stacked state after ``iterations`` sharded iterations on
    the demo, with its goal and boxes."""
    p = planner(dict(cfg, num_iterations=max(cfg["num_iterations"], iterations)), D)
    goal, boxes = p._inputs(ct.Scenario.demo())
    s = p._init(ct.Scenario.demo(), seed, inits)
    for _ in range(iterations):
        _, trips = st.sharded_readout(p.config, s)
        st.sharded_iteration(p.config, p.system, p.grid, goal, boxes, s, trips)
    return p, s, goal, boxes


def to_jax(fields: dict):
    out = {k: jnp.asarray(v) for k, v in fields.items() if k != "key"}
    return jk.KGMTState(**out, key=jax.random.wrap_key_data(jnp.asarray(fields["key"])))


def jax_fields(s) -> dict:
    d = jax.device_get(s._asdict())
    d["key"] = np.asarray(jax.random.key_data(s.key))
    return {k: np.asarray(v) for k, v in d.items()}


@contextlib.contextmanager
def _masked_while_loop(trips: int):
    """``lax.while_loop`` as ``trips`` masked trips (see the module
    docstring), for the span of one op-by-op JAX call. Yields the shards'
    loop conditions before each trip and after the last ([trips + 1]
    lists), so the caller can hold the port's trip count against JAX's."""
    orig = jax.lax.while_loop
    conds = [[] for _ in range(trips + 1)]

    def while_loop(cond, body, init):
        val = init
        for t in range(trips + 1):
            keep = cond(val)
            jax.debug.callback(lambda k, t=t: conds[t].append(bool(k)), keep)
            if t == trips:
                break
            new = body(val)
            val = jax.tree.map(lambda a, b: jnp.where(keep, a, b), new, val)
        return val

    jax.lax.while_loop = while_loop
    try:
        yield conds
    finally:
        jax.lax.while_loop = orig


def _jax_config(cfg: dict) -> jt.KGMTConfig:
    return jt.KGMTConfig(**{k: v for k, v in cfg.items() if k != "rollout_backend"})


def _jax_iteration(cfg: dict, fields: dict, trips: int) -> dict:
    jcfg = _jax_config(cfg)
    grid = JGrid(width=jcfg.width, height=jcfg.height, N=jcfg.N, n=jcfg.n)
    sc = jt.Scenario.demo()
    obstacles = jnp.asarray(sc.padded_obstacles(jcfg.max_obstacles)[0])
    step = jax.vmap(partial(jk.kgmt_iteration, jcfg, jget_system(jcfg.system), grid,
                            obstacles, jnp.asarray(sc.goal), axis_name="tree"),
                    axis_name="tree")
    with jax.disable_jit(), _masked_while_loop(trips) as conds:
        out = jax_fields(step(to_jax(fields)))
    # the port's count is JAX's: every shard's sub-wave loop has ended after
    # the trips, and some shard's still ran at the last one
    assert conds[trips] and not any(conds[trips])
    assert trips == 0 or any(conds[trips - 1])
    return out


def assert_fields_equal(got: dict, want: dict, states: bool = False) -> None:
    """Every field bitwise; with ``states``, the scores and the state
    columns of the sample rows (x, y, theta, v) within STATE_TOL."""
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        if states and k in ("r1_score", "r1_threshold"):
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **STATE_TOL)
        elif states and k in ("tree_samples", "u_samples"):
            np.testing.assert_allclose(got[k][..., :4], want[k][..., :4],
                                       err_msg=k, **STATE_TOL)
            np.testing.assert_array_equal(got[k][..., 4:], want[k][..., 4:], err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("cfg,D,start", [
    # adaptive waves (several a shard and iteration, shards unequal), goal bias
    (dict(SMALL, goal_bias=0.25), 3, 1),
    # one wave an iteration
    (dict(SMALL, adaptive_waves=False), 3, 3),
])
def test_one_sharded_iteration_matches_jax(cfg, D, start):
    p, s, _, _ = port_state(cfg, D, start)
    before = st.sharded_state_to_numpy(s)
    _, trips = st.sharded_readout(p.config, s)
    want = _jax_iteration(cfg, before, trips)
    goal, boxes = p._inputs(ct.Scenario.demo())
    st.sharded_iteration(p.config, p.system, p.grid, goal, boxes, s, trips)
    got = st.sharded_state_to_numpy(s)
    assert_fields_equal(got, want, states=True)
    # the iteration grew every shard, crossed shards and used the pool
    assert (got["tree_size"] > before["tree_size"]).all()
    M = cfg["max_tree_size"]
    foreign = [(got["tree_parent"][d] // M != d) & (got["tree_parent"][d] >= 0)
               for d in range(D)]
    assert any(f.any() for f in foreign)
    np.testing.assert_array_equal(got["r1_score"], np.broadcast_to(got["r1_score"][0],
                                                                   got["r1_score"].shape))


def _jax_pool(cfg: dict, fields: dict):
    """JAX's exchange (cudasbmp_tpu/planners/kgmt.py:632-648, the same
    primitives: top_k of -d2, the gathers, all_gather over the axis), op by
    op under vmap."""
    M = cfg["max_tree_size"]
    goal = jnp.asarray(jt.Scenario.demo().goal)

    def one(ts, costs, lo, size):
        gid_base = jax.lax.axis_index("tree").astype(jnp.int32) * M
        idx = jnp.arange(M)
        in_frontier = (idx >= lo) & (idx < size)
        d2x = (ts[:, 0] - goal[0]) ** 2 + (ts[:, 1] - goal[1]) ** 2
        d2x = jnp.where(in_frontier, d2x, jnp.inf)
        neg_best, cand = jax.lax.top_k(-d2x, min(cfg["exchange_k"], M))
        cand = cand.astype(jnp.int32)
        ids = jnp.where(jnp.isfinite(-neg_best), gid_base + cand, -1)
        return tuple(jax.lax.all_gather(x, "tree")
                     for x in (ts[cand], ids, costs[cand]))

    with jax.disable_jit():
        rows, ids, costs = jax.vmap(one, axis_name="tree")(
            *(jnp.asarray(fields[k]) for k in ("tree_samples", "costs", "frontier_lo",
                                                "tree_size")))
    return (np.asarray(rows[0]).reshape(-1, 7), np.asarray(ids[0]).reshape(-1),
            np.asarray(costs[0]).reshape(-1))


def test_exchange_pool_matches_jax():
    """ids, rows and costs on a grown 3-shard tree, and with frontiers of 0,
    5 and 40 nodes against k = 16 (padding ids -1, padding rows from the
    lowest slots outside the frontier), ties included."""
    cfg = SMALL
    p, s, goal, _ = port_state(cfg, 3, 2)
    fields = st.sharded_state_to_numpy(s)
    r = np.random.default_rng(0)
    odd = {k: v.copy() for k, v in fields.items()}
    odd["frontier_lo"] = np.array([7, 100, 3], np.int32)
    odd["tree_size"] = np.array([7, 105, 43], np.int32)
    # two equidistant rows in shard 2's frontier: ties to the lower slot
    odd["tree_samples"][2, 10] = odd["tree_samples"][2, 20]
    odd["tree_samples"][2, :60, 2:] = r.normal(size=(60, 5)).astype(np.float32)
    for f in (fields, odd):
        want = _jax_pool(cfg, f)
        got = st.exchange_pool(p.config, torch.as_tensor(f["tree_samples"]),
                               torch.as_tensor(f["costs"]),
                               torch.as_tensor(f["frontier_lo"].astype(np.int64)),
                               torch.as_tensor(f["tree_size"].astype(np.int64)), goal)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
    assert (want[1] == -1).sum() == 16 + 11 and (want[1] >= 0).sum() == 5 + 16


def test_expansion_wave_with_pool_matches_jax():
    """expansion_wave of sub-wave 1 of shard 1's iteration with a pool (real
    ids, padding ids and repeats) and gid_base = M, every output bitwise."""
    cfg = ct.KGMTConfig(num_iterations=20, max_tree_size=1024, rollouts_per_iter=256,
                        goal_bias=0.25, rollout_backend="torch")
    planner = ct.KGMT(cfg, device="cpu")
    sc = ct.Scenario.demo()
    obstacles = torch.as_tensor(sc.padded_obstacles(cfg.max_obstacles)[0])
    goal = torch.as_tensor(sc.goal)
    s = tk.init_state(cfg, planner.grid, torch.as_tensor(sc.init),
                      ct.rng.fold_in(ct.rng.key(4), 1))
    for _ in range(2):
        s = tk.kgmt_iteration(cfg, planner.system, planner.grid, obstacles, goal, s)
    r = np.random.default_rng(1)
    P = 48
    rows = np.concatenate([r.uniform(1, 19, (P, 2)), r.normal(size=(P, 5))], 1)
    ids = r.integers(0, 3 * 1024, P).astype(np.int32)
    ids[::5] = -1
    costs = r.uniform(0, 5, P)
    pool = (rows.astype(np.float32), ids, costs.astype(np.float32))
    kw = dict(wave=1, frontier_lo=s.frontier_lo, frontier_size=s.tree_size - s.frontier_lo,
              n_target=300)
    got = tk.expansion_wave(cfg, planner.system, obstacles, goal, s,
                            pool=tuple(torch.as_tensor(x) for x in pool),
                            gid_base=1024, **kw)
    from cudasbmp_torch.convert import state_to_numpy

    fields = state_to_numpy(s)
    jcfg = _jax_config(cfg.to_dict())
    with jax.disable_jit():
        want = jk.expansion_wave(
            jcfg, jget_system(jcfg.system), jnp.asarray(obstacles.numpy()),
            jnp.asarray(sc.goal), to_jax(fields), pool=tuple(map(jnp.asarray, pool)),
            gid_base=1024, **kw)
    for name, g, w in zip(("slot_active", "parent_gid", "parent_cost", "x1",
                           "controls", "valid", "samples1"), got, want):
        g, w = g.numpy(), np.asarray(w)
        if name in ("x1", "samples1"):
            np.testing.assert_allclose(g[:, :4], w[:, :4], err_msg=name, **STATE_TOL)
            g, w = g[:, 4:], w[:, 4:]
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_array_equal(got[-1].numpy().astype(np.uint32),
                                  np.asarray(jax.random.key_data(want[-1])))
    # the pool's slots: the last round(0.25 * 256) = 64, where the id is
    # real; every other slot a local parent under gid_base, active or not
    gid, active = got[1].numpy(), got[0].numpy()
    pooled = np.zeros(256, bool)
    pooled[192:] = ids[(256 + np.arange(192, 256)) % P] >= 0
    np.testing.assert_array_equal(gid[pooled], ids[(256 + np.arange(256)) % P][pooled])
    assert (gid[~pooled] >= 1024).all() and active[pooled].all()
    assert active[:44].all() and not active[44:192].any()


def test_expansion_wave_without_pool_is_the_single_wave():
    """pool=None, gid_base=0: the parent ids are the local indices, every
    output as before the pool existed (the single solve's bits)."""
    cfg = ct.KGMTConfig(num_iterations=20, max_tree_size=1024, rollouts_per_iter=256)
    planner = ct.KGMT(cfg, device="cpu")
    sc = ct.Scenario.demo()
    obstacles = torch.as_tensor(sc.padded_obstacles(cfg.max_obstacles)[0])
    goal = torch.as_tensor(sc.goal)
    s = tk.init_state(cfg, planner.grid, torch.as_tensor(sc.init), ct.rng.key(2))
    s = tk.kgmt_iteration(cfg, planner.system, planner.grid, obstacles, goal, s)
    a = tk.expansion_wave(cfg, planner.system, obstacles, goal, s)
    b = tk.expansion_wave(cfg, planner.system, obstacles, goal, s, pool=None, gid_base=0)
    fl, fs = s.frontier_lo, s.tree_size - s.frontier_lo
    want = (fl + np.arange(256) % fs).astype(np.int32)
    np.testing.assert_array_equal(a[1].numpy(), want)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_stitch_path_matches_jax():
    """A chain that hops shards 2 -> 0 -> 1 -> 0, and the cycle guard."""
    D, M = 3, 50
    r = np.random.default_rng(3)
    parents = np.full((D, M), -1, np.int32)
    samples = r.normal(size=(D, M, 7)).astype(np.float32)
    chain = [2 * M + 0, 0 * M + 4, 1 * M + 9, 0 * M + 17, 0 * M + 30]
    for child, parent in zip(chain[1:], chain[:-1]):
        parents[child // M, child % M] = parent
    parents[1, 3] = 2 * M + 7  # an unrelated node
    for goal in (chain[-1], chain[2], chain[0]):
        got = st.stitch_path(parents, samples, goal, M)
        want = jst.stitch_path(parents, samples, goal, M)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert list(st.stitch_path(parents, samples, chain[-1], M)[1]) == [2, 0, 1, 0, 0]
    parents[2, 0] = chain[-1]
    with pytest.raises(AssertionError, match="cycle"):
        st.stitch_path(parents, samples, chain[-1], M)
