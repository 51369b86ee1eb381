"""Kernel branch B3 (the oriented-footprint narrow phase), with and without
B4 (fast math): the port's plain twin ``rollout_soa`` against the TPU kernel
itself, ``rollout_pallas(..., interpret=True)``, for every system. (The
footprint function and the other rollout paths are held against JAX in
tests/test_torch_footprint.py; the kernel body for every option in
tests/test_torch_rollout_soa.py.)"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudasbmp_torch.config import Scenario
from cudasbmp_tpu.ops.rollout_pallas import rollout_pallas
from cudasbmp_tpu.systems import get_system as j_get_system
from test_torch_rollout_soa import assert_twin_matches, batch

torch.set_num_threads(2)
KW = dict(num_disc=10, width=20.0, height=20.0)
OBS = Scenario.demo().padded_obstacles(32)[0]


@pytest.mark.parametrize("fast_math", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("name", ["bicycle", "point2d", "double_integrator",
                                  "unicycle", "dubins"])
def test_twin_with_footprint_matches_interpret_mode_kernel(name, fast_math):
    """B3 (and B3 with B4): the plain twin against the TPU kernel itself in
    interpret mode, as tests/test_pallas.py runs it, for every system. The
    jitted kernel contracts multiply-adds on XLA:CPU, so states agree to
    1e-3 and masks on every lane that passes no edge within 1e-3. Three
    demo boxes (one the long wall) and a padding row: XLA:CPU's compile
    time grows steeply with the unrolled box count."""
    obs = OBS[[0, 1, 4, 5]]
    x0, c = batch(name, 512, 4)
    px1, pv = rollout_pallas(j_get_system(name), jnp.asarray(x0), jnp.asarray(c),
                             jnp.asarray(obs), interpret=True, footprint=(0.5, 0.25),
                             fast_math=fast_math, **KW)
    assert_twin_matches(name, x0, c, obs, (0.5, 0.25), fast_math,
                        np.asarray(px1), np.asarray(pv))
