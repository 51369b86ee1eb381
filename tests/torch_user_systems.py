"""User systems for the port's tests (no JAX here: the card tests import
this module too).

- ``Drift``: a damped double integrator with only the generic ``step``, the
  system a user writes first; ``DriftSoA`` adds the torch SoA hooks and
  ``DriftStruct`` its device struct (``cuda_struct``, with R1's ``back``),
  ``DriftNoBack`` the struct without ``back``;
- ``BicycleCopy``: the built-in bicycle under another name, its device struct
  a copy of csrc/rollout.cu's ``Bicycle`` with csrc/refine.cu's ``back``, so
  its kernels must give the built-in's bits.

State (x, y, vx, vy), controls (ax, ay) plus the duration:

    x += vx * dt;  y += vy * dt;  vx += (ax - c * vx) * dt;  vy += (ay - c * vy) * dt
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from cudasbmp_torch.systems import ControlSpec, KinematicBicycle

DRIFT_STRUCT = """
struct UserSystem {  // damped double integrator: (x, y, vx, vy); controls (ax, ay)
  static constexpr bool kHeading = false, kFast = false;
  float c;  // damping
  struct Aux { float ax, ay; };
  __device__ Aux prepare(float ax, float ay) const { return {ax, ay}; }
  __device__ float4 step(float4 s, Aux q, float dt) const {
    return make_float4(add(s.x, mul(s.z, dt)), add(s.y, mul(s.w, dt)),
                       add(s.z, mul(sub(q.ax, mul(c, s.z)), dt)),
                       add(s.w, mul(sub(q.ay, mul(c, s.w)), dt)));
  }
  BACK
};
"""
DRIFT_BACK = """
  __device__ float4 back(float4 s, Aux q, float dt, float4 lam, Grad& g) const {
    g.dt = add(g.dt, add(add(add(mul(lam.x, s.z), mul(lam.y, s.w)),
                             mul(lam.z, sub(q.ax, mul(c, s.z)))),
                         mul(lam.w, sub(q.ay, mul(c, s.w)))));
    g.c0 = add(g.c0, mul(lam.z, dt));
    g.c1 = add(g.c1, mul(lam.w, dt));
    return make_float4(lam.x, lam.y,
                       add(lam.z, sub(mul(lam.x, dt), mul(mul(lam.z, c), dt))),
                       add(lam.w, sub(mul(lam.y, dt), mul(mul(lam.w, c), dt))));
  }"""

BICYCLE_STRUCT = """
struct UserSystem {  // csrc/rollout.cu's Bicycle, csrc/refine.cu's back()
  static constexpr bool kHeading = true, kFast = true;
  float L;
  struct Aux { float a, tan_s; };
  struct Carry { float ct, st, dct, dst, dth; };
  struct FastAux { float a, cc2, sc2, c2; };
  __device__ Aux prepare(float a, float steering) const {
    return {a, tanf(steering)};
  }
  __device__ float4 step(float4 s, Aux q, float dt) const {
    const float2 cs = cos_sin(s.z);
    return make_float4(advance(s.x, s.w, cs.x, dt),
                       advance(s.y, s.w, cs.y, dt),
                       add(s.z, mul(mul(__fdiv_rn(s.w, L), q.tan_s), dt)),
                       add(s.w, mul(q.a, dt)));
  }
  __device__ void prepare_fast(float4 s, float a, float steering, float dt,
                               Carry& k, FastAux& q) const {
    const float tan_s = tanf(steering);
    const float d0 = mul(mul(__fdiv_rn(s.w, L), tan_s), dt);
    const float c2 = mul(mul(__fdiv_rn(mul(a, dt), L), tan_s), dt);
    k = {cosf(s.z), sinf(s.z), cosf(d0), sinf(d0), d0};
    q = {a, cosf(c2), sinf(c2), c2};
  }
  __device__ float4 step_fast(float4 s, Carry& k, FastAux q, float dt) const {
    const float4 n = make_float4(advance(s.x, s.w, k.ct, dt),
                                 advance(s.y, s.w, k.st, dt), add(s.z, k.dth),
                                 add(s.w, mul(q.a, dt)));
    rotate(k.ct, k.st, k.dct, k.dst);
    rotate(k.dct, k.dst, q.cc2, q.sc2);
    k.dth = add(k.dth, q.c2);
    return n;
  }
  __device__ float4 back(float4 s, Aux q, float dt, float4 lam, Grad& g) const {
    const float2 cs = cos_sin(s.z);
    const float vc = mul(s.w, cs.x), vs = mul(s.w, cs.y);
    const float vl = dvd(s.w, L), turn = mul(vl, q.tan_s);
    const float g_vc = mul(lam.x, dt), g_vs = mul(lam.y, dt);
    const float g_turn = mul(lam.z, dt);
    g.dt = add(g.dt, add(add(add(mul(lam.x, vc), mul(lam.y, vs)),
                             mul(lam.z, turn)), mul(lam.w, q.a)));
    g.c0 = add(g.c0, mul(lam.w, dt));
    g.c1 = add(g.c1, mul(mul(g_turn, vl), add(1.0f, mul(q.tan_s, q.tan_s))));
    const float g_th = sub(mul(mul(g_vs, s.w), cs.x), mul(mul(g_vc, s.w), cs.y));
    const float g_v = add(add(mul(g_vc, cs.x), mul(g_vs, cs.y)),
                          dvd(mul(g_turn, q.tan_s), L));
    return make_float4(lam.x, lam.y, add(lam.z, g_th), add(lam.w, g_v));
  }
};
"""


@dataclasses.dataclass(frozen=True)
class Drift:
    name: str = "drift"
    state_dim: int = 4
    damping: float = 0.3
    control_spec: ControlSpec = dataclasses.field(
        default_factory=lambda: ControlSpec(lo=(-3.0, -3.0, 0.05), hi=(3.0, 3.0, 1.05)))

    def step(self, state: torch.Tensor, control: torch.Tensor,
             dt: torch.Tensor) -> torch.Tensor:
        x, y, vx, vy = state.unbind(-1)
        ax, ay = control[..., 0], control[..., 1]
        return torch.stack([x + vx * dt, y + vy * dt,
                            vx + (ax - self.damping * vx) * dt,
                            vy + (ay - self.damping * vy) * dt], dim=-1)


@dataclasses.dataclass(frozen=True)
class DriftSoA(Drift):
    def soa_prepare(self, ctrl):
        return tuple(ctrl)

    def soa_step(self, comps, aux, dt):
        x, y, vx, vy = comps
        ax, ay = aux
        return [x + vx * dt, y + vy * dt, vx + (ax - self.damping * vx) * dt,
                vy + (ay - self.damping * vy) * dt]


@dataclasses.dataclass(frozen=True)
class DriftStruct(DriftSoA):
    cuda_struct: ClassVar[str] = DRIFT_STRUCT.replace("BACK", DRIFT_BACK)

    @property
    def cuda_param(self) -> float:
        return self.damping


@dataclasses.dataclass(frozen=True)
class DriftNoBack(DriftSoA):
    name: str = "drift_noback"
    cuda_struct: ClassVar[str] = DRIFT_STRUCT.replace("BACK", "")

    @property
    def cuda_param(self) -> float:
        return self.damping


@dataclasses.dataclass(frozen=True)
class BicycleCopy(KinematicBicycle):
    name: str = "bicycle_copy"
    cuda_struct: ClassVar[str] = BICYCLE_STRUCT

    @property
    def cuda_param(self) -> float:
        return self.agent_length
