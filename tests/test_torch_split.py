"""Thread groups of the rollout kernels B1-B4 and B6 (csrc/rollout.cu): the
split rule ``lanes_per_rollout``, the launch geometry the kernels use,
written here in Python (``launch_geometry`` for ``prepare``, ``thread_map``
for ``locate``, with the kernel's constants read from the source), and an
emulation of the sub-lane box partition on the CPU.

The emulation runs each lane on G sub-lanes, as the kernel does: every
sub-lane integrates its own copy of the chain, tests only the boxes
``sublane_boxes(K, G, g)`` (o = g mod G), and the group's step verdict is
the AND over its sub-lanes (the kernel's ballot). It must equal the plain
twin ``rollout_soa`` bit for bit, states and masks, for every G, system
and option: the partition changes which thread tests a box, never a
result. The twin itself is held against the JAX kernel body in
tests/test_torch_rollout_soa.py; here the emulation is also held against
``_integrate`` op by op, to the bit for the systems without trig.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudasbmp_torch import rng
from cudasbmp_torch._math import div
from cudasbmp_torch.geometry.aabb import segment_aabb, segment_clear
from cudasbmp_torch.geometry.footprint import footprint_clear_cs
from cudasbmp_torch.ops import rollout_cuda as rc
from cudasbmp_torch.systems import get_system
from cudasbmp_tpu.ops.rollout_pallas import _integrate
from cudasbmp_tpu.systems import get_system as j_get_system

torch.set_num_threads(2)
NAMES = ["bicycle", "point2d", "double_integrator", "unicycle", "dubins"]
KW = dict(num_disc=10, width=20.0, height=20.0)
FP = (0.5, 0.25)
H100_SMS = 132
SOURCE = pathlib.Path(rc.__file__).resolve().parent.parent / "csrc" / "rollout.cu"


def constant(name: str) -> int:
    """``constexpr int <name> = <value>;`` of csrc/rollout.cu."""
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())[1])


THREADS = constant("kThreads")  # a block of either kernel
REG_BOXES = constant("kRegBoxes")  # boxes a sub-lane holds in registers, at most
WALK = constant("kWalk")  # the one-thread walk's boxes a pass
NEUTRAL = (float("inf"), float("inf"), float("-inf"), float("-inf"))


def launch_geometry(P: int, R: int, split: int) -> tuple[int, int]:
    """(blocks a problem, blocks) of a launch of P problems of R lanes at G
    = ``split`` threads a rollout, as ``prepare`` computes them: ceil(R * G
    / THREADS) blocks a problem, so every problem starts on a block
    boundary (at least one a problem, none at all for no lanes)."""
    per = -(-R * split // THREADS)
    return max(per, 1), P * per


def thread_map(P: int, R: int, split: int) -> dict[str, torch.Tensor]:
    """For every thread of the launch's grid, in order of block and
    thread: its problem, lane, sub-lane and whether it is active (its lane
    exists), as ``locate`` computes them."""
    per, blocks = launch_geometry(P, R, split)
    gid = torch.arange(blocks * THREADS)
    block, t = gid // THREADS, gid % THREADS
    problem = block // per
    lane = (block - problem * per) * (THREADS // split) + t // split
    return {"problem": problem, "lane": lane, "sub_lane": t % split,
            "active": lane < R}


def boxes_in_registers(K: int, split: int) -> bool:
    """``prepare``'s reg_boxes: each sub-lane's boxes (at most ceil(K / G))
    fit its register slots."""
    return -(-K // split) <= REG_BOXES


def walk_set(obstacles: torch.Tensor) -> torch.Tensor:
    """The block's shared set of the one-thread walk, as ``load_boxes``
    writes it: the K boxes, then neutral boxes up to a multiple of WALK
    (``padded``)."""
    K = obstacles.shape[-2]
    pad = torch.tensor(NEUTRAL).expand(*obstacles.shape[:-2], -(-K // WALK) * WALK - K, 4)
    return torch.cat([obstacles, pad], -2)


def sublane_boxes(K: int, split: int, g: int) -> range:
    """The boxes sub-lane ``g`` of a group of ``split`` tests: o = g mod G."""
    return range(g, K, split)


def test_the_geometry_takes_the_kernels_constants():
    """The wrapper's G values are the kernel's (powers of two up to
    kMaxSplit, each dividing the warp and the block), and the block and
    register cap written here are the source's."""
    assert rc.SPLITS == tuple(2 ** i for i in range(constant("kMaxSplit").bit_length()))
    assert all(rc.WARP % G == 0 and THREADS % G == 0 for G in rc.SPLITS)
    assert THREADS % rc.WARP == 0 and REG_BOXES >= 1


# ---- the rule ----------------------------------------------------------

@pytest.mark.parametrize("sm_count", [1, 16, 78, 114, 132, 144])
def test_rule_picks_a_power_of_two_no_wider_than_the_card(sm_count):
    """G is one of the kernel's, never grows with the lanes, and is above 1
    only where lanes * G stays within the rule's thread budget."""
    budget = rc.SPLIT_THREADS_PER_SM * sm_count
    prev = 8
    for lanes in (1, 31, 32, 33, 512, 2048, 4096, 4097, 8192, 16_384, 16_896,
                  16_897, 32_768, 131_072, 524_288):
        G = rc.lanes_per_rollout(lanes, sm_count)
        assert G in rc.SPLITS and G <= prev
        assert G == (rc.NARROW_SPLIT if lanes * rc.NARROW_SPLIT <= budget else 1)
        prev = G


def test_rule_on_an_h100():
    """4 from one warp to 8,448 lanes: the demo's wave of 4,096 (its 8 boxes
    fill 4 sub-lanes' registers), the CPU tests' 2,048 and the extension
    rounds' buckets of 8 to 64 problems x 128 lanes; 1 from the buckets of
    128 problems (16,384 lanes), at the arena's 256 x 128 = 32,768
    flattened lanes, the sweeps' 1,024 x 128 and the probe's 2^17."""
    for lanes in (32, 1024, 2048, 4096, 8192, 64 * 128, 8448):
        assert rc.lanes_per_rollout(lanes, H100_SMS) == 4
    for lanes in (8449, 16_384, 128 * 128, 32_768, 131_072, 1024 * 128, 2 ** 17,
                  524_288):
        assert rc.lanes_per_rollout(lanes, H100_SMS) == 1


# ---- the launch geometry -------------------------------------------------

@pytest.mark.parametrize("G", rc.SPLITS)
@pytest.mark.parametrize("P,R", [(1, 1), (1, 33), (1, 4096), (1, 4097), (3, 300),
                                 (8, 512), (5, 128), (2, 0), (7, 2)])
def test_every_lane_is_covered_once_by_one_group(P, R, G):
    """Every (problem, lane) has exactly one thread of each sub-lane, the G
    threads of a lane lie in one warp, every block serves one problem and
    each problem starts on a block boundary; threads past R are inactive."""
    per, blocks = launch_geometry(P, R, G)
    assert blocks == P * -(-R * G // THREADS) and per >= 1
    m = thread_map(P, R, G)
    n = blocks * THREADS
    assert all(len(v) == n for v in m.values())
    act = m["active"]
    assert bool((m["lane"][act] < R).all()) and bool((m["problem"] < max(P, 1)).all())
    pairs = (m["problem"][act] * R + m["lane"][act]) * G + m["sub_lane"][act]
    assert torch.equal(torch.sort(pairs).values, torch.arange(P * R * G))
    gid = torch.arange(n)
    # a group is G adjacent threads of one (problem, lane), in one warp
    lane_id = (m["problem"] * (R + THREADS) + m["lane"]).view(-1, G)
    assert bool((lane_id == lane_id[:, :1]).all())
    warp = (gid // rc.WARP).view(-1, G)
    assert bool((warp == warp[:, :1]).all())
    block = gid // THREADS
    assert torch.equal(m["problem"], block // per)
    starts = (block % per == 0) & (gid % THREADS == 0)
    assert bool((m["lane"][starts] == 0).all())
    assert torch.equal(m["sub_lane"], gid % G)


@pytest.mark.parametrize("K", [0, 1, 4, 7, 8, 9, 16, 33, 40])
def test_sub_lanes_partition_the_boxes(K):
    """The sub-lanes of a group test every box once between them, at most
    ceil(K / G) each, in registers while that is at most REG_BOXES."""
    for G in rc.SPLITS:
        parts = [list(sublane_boxes(K, G, g)) for g in range(G)]
        assert sorted(sum(parts, [])) == list(range(K))
        assert max(map(len, parts)) == -(-K // G)
        assert boxes_in_registers(K, G) == (-(-K // G) <= REG_BOXES)
    assert boxes_in_registers(8, 8) and not boxes_in_registers(8, 1)


# ---- the sub-lane box partition, emulated --------------------------------

def split_twin(system, x0, controls, obstacles, G, *, num_disc, width, height,
               footprint=None, fast_math=False):
    """``rollout_soa``'s loop with each lane on G sub-lanes (a last axis of
    G): sub-lane g tests the workspace bounds and the boxes
    ``sublane_boxes(K, G, g)``; the group's verdict is the AND over its
    sub-lanes. Returns every sub-lane's (x1, alive)."""
    per_problem = obstacles.dim() == 3
    K = obstacles.shape[-2]
    sub = [obstacles[..., list(sublane_boxes(K, G, g)), :] for g in range(G)]
    if per_problem:  # lanes [B, R]: one set per problem, [B, 1, k, 4]
        sub = [o[:, None] for o in sub]
    comps = [c[..., None].expand(*c.shape, G) for c in x0.unbind(-1)]
    ctrl = [c[..., None].expand(*c.shape, G) for c in controls[..., :-1].unbind(-1)]
    dt = div(controls[..., -1], num_disc)[..., None].expand(*controls.shape[:-1], G)
    use_fast = fast_math and hasattr(system, "soa_step_fast")
    if use_fast:
        carry, aux = system.soa_prepare_fast(comps, ctrl, dt)
    else:
        aux = system.soa_prepare(ctrl)
    heading_index = getattr(system, "heading_index", None)
    alive = torch.ones(comps[0].shape, dtype=torch.bool)
    for _ in range(num_disc):
        if use_fast:
            new, new_carry = system.soa_step_fast(comps, carry, aux, dt)
        else:
            new = system.soa_step(comps, aux, dt)
        nx, ny = new[0], new[1]
        if use_fast:
            ct, st = new_carry[0], new_carry[1]
        elif heading_index is not None:
            ct, st = torch.cos(new[heading_index]), torch.sin(new[heading_index])
        else:
            ct, st = torch.ones_like(nx), torch.zeros_like(nx)
        votes = []
        for g in range(G):  # each sub-lane's own verdict
            x, y, sx, sy = nx[..., g], ny[..., g], comps[0][..., g], comps[1][..., g]
            clear = (x > 0.0) & (x < width) & (y > 0.0) & (y < height)
            lo, hi = segment_aabb(torch.stack([sx, sy], -1), torch.stack([x, y], -1))
            clear = clear & segment_clear(lo, hi, sub[g])
            if footprint is not None:
                clear = clear & footprint_clear_cs(x, y, ct[..., g], st[..., g],
                                                   footprint[0], footprint[1], sub[g])
            votes.append(clear)
        group = torch.stack(votes, -1).all(-1, keepdim=True)  # the ballot
        comps = [torch.where(alive, n, c) for n, c in zip(new, comps)]
        if use_fast:
            carry = new_carry
        alive = alive & group
    return torch.stack(comps, -2), alive


def walk_twin(system, x0, controls, obstacles, *, num_disc, width, height,
              footprint=None, fast_math=False):
    """The one-thread body (``integrate_group`` with WalkBoxes) in PyTorch:
    the chain runs unconditionally from u, each step tests the bounds and
    the padded set (``walk_set``) a pass of WALK boxes at a time, and (s,
    alive) take the candidate while the rollout lives."""
    per_problem = obstacles.dim() == 3
    padded = walk_set(obstacles)
    passes = [padded[..., o:o + WALK, :] for o in range(0, padded.shape[-2], WALK)]
    if per_problem:
        passes = [b[:, None] for b in passes]
    u = list(x0.unbind(-1))
    s = list(u)
    ctrl = list(controls[..., :-1].unbind(-1))
    dt = div(controls[..., -1], num_disc)
    use_fast = fast_math and hasattr(system, "soa_step_fast")
    if use_fast:
        carry, aux = system.soa_prepare_fast(u, ctrl, dt)
    else:
        aux = system.soa_prepare(ctrl)
    heading_index = getattr(system, "heading_index", None)
    alive = torch.ones(x0.shape[:-1], dtype=torch.bool)
    for _ in range(num_disc):
        if use_fast:
            new, carry = system.soa_step_fast(u, carry, aux, dt)
            ct, st = carry[0], carry[1]
        else:
            new = system.soa_step(u, aux, dt)
            if heading_index is not None:
                ct, st = torch.cos(new[heading_index]), torch.sin(new[heading_index])
            else:
                ct, st = torch.ones_like(new[0]), torch.zeros_like(new[0])
        nx, ny = new[0], new[1]
        clear = (nx > 0.0) & (nx < width) & (ny > 0.0) & (ny < height)
        lo, hi = segment_aabb(torch.stack(u[:2], -1), torch.stack([nx, ny], -1))
        for boxes in passes:
            clear = clear & segment_clear(lo, hi, boxes)
            if footprint is not None:
                clear = clear & footprint_clear_cs(nx, ny, ct, st, footprint[0],
                                                   footprint[1], boxes)
        s = [torch.where(alive, n, c) for n, c in zip(new, s)]
        alive = alive & clear
        u = new
    return torch.stack(s, -1), alive


def lanes(name: str, B: int, seed: int):
    r = np.random.default_rng(seed)
    spec = j_get_system(name).control_spec
    x0 = np.zeros((B, 4), np.float32)
    x0[:, 0] = r.uniform(0.5, 19.5, B)
    x0[:, 1] = r.uniform(0.5, 19.5, B)
    if name != "point2d":
        x0[:, 2] = r.uniform(-np.pi, np.pi, B)
    if name in ("bicycle", "double_integrator"):
        x0[:, 3] = r.uniform(-3, 3, B)
    u = r.uniform(0, 1, (B, spec.dim))
    c = np.asarray(spec.lo) + u * (np.asarray(spec.hi) - np.asarray(spec.lo))
    return x0, c.astype(np.float32)


def field(K: int, seed: int, P: int | None = None) -> np.ndarray:
    """K random boxes (the last two padding rows), or P such sets."""
    r = np.random.default_rng(seed)
    shape = (K,) if P is None else (P, K)
    lo = r.uniform(0.0, 17.0, (*shape, 2))
    boxes = np.concatenate([lo, lo + r.uniform(0.5, 3.0, (*shape, 2))], -1)
    boxes[..., -2:, :] = (1.0, 1.0, 0.0, 0.0)
    return boxes.astype(np.float32)


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("fast_math", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("footprint", [None, FP], ids=["broad", "footprint"])
@pytest.mark.parametrize("name", NAMES)
def test_sub_lane_partition_is_the_twin_to_the_bit(name, footprint, fast_math):
    """Every G at K=11 (no multiple of any G > 1, past the register cap at
    G <= 2) and K=5 (fewer boxes than sub-lanes at G=8): every sub-lane
    ends with the twin's state, to the bit, and the group with its mask."""
    system = get_system(name)
    x0, c = (torch.tensor(a) for a in lanes(name, 384, NAMES.index(name)))
    opts = dict(KW, footprint=footprint, fast_math=fast_math)
    for K in (11, 5):
        obs = torch.tensor(field(K, 10 + K))
        want_x1, want_v = rc.rollout_soa(system, x0, c, obs, **opts)
        for G in rc.SPLITS:
            x1, v = split_twin(system, x0, c, obs, G, **opts)
            assert torch.equal(v, want_v[..., None].expand_as(v)), (K, G)
            assert torch.equal(bits(x1), bits(want_x1[..., None].expand_as(x1))), (K, G)
        assert 0.05 < want_v.float().mean() < (0.99 if K == 11 else 1.0)


@pytest.mark.parametrize("G", rc.SPLITS)
def test_sub_lane_partition_per_problem_is_the_twin(G):
    """B6's form: lanes [P, R] with one box set per problem."""
    system = get_system("bicycle")
    x0, c = lanes("bicycle", 6 * 40, 3)
    x0, c = torch.tensor(x0).reshape(6, 40, 4), torch.tensor(c).reshape(6, 40, 3)
    obs = torch.tensor(field(9, 4, P=6))
    for footprint in (None, FP):
        opts = dict(KW, footprint=footprint)
        want_x1, want_v = rc.rollout_soa(system, x0, c, obs, **opts)
        x1, v = split_twin(system, x0, c, obs, G, **opts)
        assert torch.equal(v, want_v[..., None].expand_as(v))
        assert torch.equal(bits(x1), bits(want_x1[..., None].expand_as(x1)))


@pytest.mark.parametrize("name", ["point2d", "double_integrator"])
def test_sub_lane_partition_is_the_jax_body(name):
    """Against ``_integrate`` (rollout_pallas.py:66-140) op by op, with the
    footprint: to the bit for the systems without trig."""
    x0, c = lanes(name, 256, 21)
    obs = field(11, 22)
    xj, cj = jnp.asarray(x0), jnp.asarray(c)
    boxes = [tuple(jnp.float32(v) for v in row) for row in obs]
    with jax.disable_jit():
        comps, alive = _integrate(j_get_system(name), [xj[:, i] for i in range(4)],
                                  [cj[:, 0], cj[:, 1]], cj[:, 2], boxes,
                                  KW["num_disc"], KW["width"], KW["height"], FP, False)
    jx, jv = np.asarray(jnp.stack(comps, -1)), np.asarray(alive)
    for G in (2, 8):
        x1, v = split_twin(get_system(name), torch.tensor(x0), torch.tensor(c),
                           torch.tensor(obs), G, **KW, footprint=FP)
        np.testing.assert_array_equal(v[:, 0].numpy(), jv)
        np.testing.assert_array_equal(x1[..., 0].numpy().view(np.int32),
                                      jx.view(np.int32))
    assert 0.0 < jv.mean() < 1.0


# ---- the one-thread walk, emulated ---------------------------------------

def test_walk_set_pads_to_whole_passes():
    """K boxes, then neutral ones up to a multiple of WALK, per problem."""
    for K in (0, 1, 4, 5, 8, 9, 40):
        boxes = torch.tensor(field(K, K)) if K else torch.zeros(0, 4)
        padded = walk_set(boxes)
        assert padded.shape[0] % WALK == 0 and padded.shape[0] - K < WALK
        assert torch.equal(padded[:K], boxes)
        assert (padded[K:] == torch.tensor(NEUTRAL)).all()
    assert walk_set(torch.tensor(field(5, 1, P=3))).shape == (3, 8, 4)


@pytest.mark.parametrize("fast_math", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("footprint", [None, FP], ids=["broad", "footprint"])
@pytest.mark.parametrize("name", NAMES)
def test_unconditional_walk_is_the_twin_to_the_bit(name, footprint, fast_math):
    """The one-thread body at K = 1, 5, 8, 9 (neutral boxes fill the last
    pass) equals ``rollout_soa``, states to the bit and masks: a neutral
    box clears every in-bounds step, and the unconditional chain is the
    freeze-on-failure chain wherever the rollout lives."""
    system = get_system(name)
    x0, c = (torch.tensor(a) for a in lanes(name, 256, 30 + NAMES.index(name)))
    opts = dict(KW, footprint=footprint, fast_math=fast_math)
    for K in (1, 5, 8, 9):
        obs = torch.tensor(field(K, 40 + K))
        if K == 1:
            obs[0] = torch.tensor([6.0, 6.0, 12.0, 12.0])  # one real box
        want_x1, want_v = rc.rollout_soa(system, x0, c, obs, **opts)
        x1, v = walk_twin(system, x0, c, obs, **opts)
        assert torch.equal(v, want_v) and torch.equal(bits(x1), bits(want_x1)), K
        assert 0.05 < want_v.float().mean() < 1.0, K


def test_unconditional_walk_per_problem_is_the_twin():
    """B6's form: lanes [P, R] with one set of 9 boxes per problem."""
    system = get_system("bicycle")
    x0, c = lanes("bicycle", 6 * 40, 7)
    x0, c = torch.tensor(x0).reshape(6, 40, 4), torch.tensor(c).reshape(6, 40, 3)
    obs = torch.tensor(field(9, 8, P=6))
    for footprint in (None, FP):
        opts = dict(KW, footprint=footprint)
        want_x1, want_v = rc.rollout_soa(system, x0, c, obs, **opts)
        x1, v = walk_twin(system, x0, c, obs, **opts)
        assert torch.equal(v, want_v) and torch.equal(bits(x1), bits(want_x1))


# ---- the wrappers' split= on the CPU -------------------------------------

def test_split_is_checked_on_cpu_tensors_and_ignored():
    """A power of two up to 8 (or None) is accepted and changes nothing on
    the CPU, where the twin runs; anything else raises, and so does G > 1
    with the culled body. Nothing counts as a launch."""
    system = get_system("bicycle")
    x0, c = (torch.tensor(a) for a in lanes("bicycle", 128, 5))
    obs = torch.tensor(field(8, 6))
    key = rng.key(4)
    rc.reset_launch_counts()
    want = rc.rollout_cuda(system, x0, c, obs, **KW)
    want_s = rc.sample_and_rollout_cuda(system, key, x0, obs, **KW)
    bx0, bc = x0.reshape(2, 64, 4), c.reshape(2, 64, 3)
    bobs = obs.expand(2, -1, -1).contiguous()
    keys = rng.split(key, 2)
    for G in (None, *rc.SPLITS):
        got = rc.rollout_cuda(system, x0, c, obs, **KW, split=G)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        got = rc.sample_and_rollout_cuda(system, key, x0, obs, **KW, split=G)
        assert all(torch.equal(a, b) for a, b in zip(got, want_s))
        rc.rollout_batched_cuda(system, bx0, bc, bobs, **KW, split=G)
        rc.sample_and_rollout_batched_cuda(system, keys, bx0, bobs, **KW, split=G)
        rc.rollout_bicycle_cuda(x0, c, obs, **KW, split=G)
        rc.sample_and_rollout_bicycle_cuda(key, x0, obs, **KW, split=G)
    rc.rollout_cuda(system, x0, c, obs, **KW, cull=4, split=1)
    for bad in (0, 3, 16, -2, 2.0, "8"):
        with pytest.raises(ValueError, match="split"):
            rc.rollout_cuda(system, x0, c, obs, **KW, split=bad)
        with pytest.raises(ValueError, match="split"):
            rc.sample_and_rollout_batched_cuda(system, keys, bx0, bobs, **KW, split=bad)
    with pytest.raises(ValueError, match="culled"):
        rc.rollout_cuda(system, x0, c, obs, **KW, cull=4, split=2)
    with pytest.raises(ValueError, match="culled"):
        rc.sample_and_rollout_cuda(system, key, x0, obs, **KW, cull=True, split=8)
    assert all(w.launches == 0 and not w.splits for w in rc.WRAPPERS)
