// Fused propagate-and-check rollout kernels for Hopper (sm_90a), generic
// over the package's five dynamical systems and, in a library of its own
// (CUDASBMP_USER_SYSTEM), over a user's system's device struct.
//
// Replaces cudasbmp_tpu/ops/rollout_pallas.py::rollout_pallas (kernel B1,
// rollout_kernel) and ::sample_and_rollout_pallas (kernel B2,
// sample_and_rollout_kernel), with both options of their one-pass body
// _integrate: the oriented-footprint narrow phase (B3, template flag
// kFootprint) and the chained-rotation fast math (B4, template flag kFast);
// and their cull=W body _integrate_culled, the culled broad phase (B5,
// template flag kCull, integrate_culled below), which gives B1's results.
// Both kernels integrate num_disc explicit-Euler steps and test every step
// against the workspace bounds, the step's swept AABB against every
// obstacle and, with a footprint, the agent's oriented rectangle at the new
// pose against every obstacle (separating axes); a rollout freezes at the
// candidate state of its first failing step (the reference's break).
//
// What bounds it on this card depends on the width of the launch. A 10-step
// rollout reads 28 B (a float4 state and three controls) and writes 17 B (a
// float4 state and a valid byte), but computes up to 2 trig functions per
// step (4 with a footprint on the exact path) and a 4-axis test per step
// and obstacle, so bytes never bound it. Where the launch fills the card
// (2^17 probe lanes, the sweeps' 1,024 x 128) ALU issue slots do: a step of
// the exact bicycle at 8 boxes is some 107 instructions on one thread, 30
// of them sincosf, 11 the division and 36 the box compares (PERF.md). At
// the demo's wave of 4,096 lanes, one thread per rollout is 32 blocks on
// 32 of the 132 SMs, and the time is the latency of one
// rollout's serial chain: 10 dependent steps, each its trig and a walk over
// the K boxes in shared memory. The design keeps the whole step loop in
// registers, with the obstacle set in dynamic shared memory (16 B per box,
// loaded once per block), so device memory is touched once on the way in
// and once on the way out. Shared memory caps K at what one block can hold
// (cudaDevAttrMaxSharedMemoryPerBlockOptin / 16: 14,528 boxes at 227 KB on
// an H100; B5 gives up its window store: 13,248, or 12,608 with a
// footprint).
//
// Thread groups (Params::split, G in {1, 2, 4, 8}, a runtime value, so no
// instantiation of its own) shorten that chain at narrow widths. G adjacent
// threads of a warp serve one rollout. Every sub-lane g runs the same Euler
// chain (the same instructions on the same values, so the same bits) and
// tests only the boxes o = g mod G; the step's clear is the AND over the
// group, from one __ballot_sync a step. Where ceil(K / G) <= kRegBoxes a
// sub-lane reads its boxes from device memory into registers, neutral boxes
// filling the other slots, so a step tests kRegBoxes boxes without a branch
// and needs no block barrier (the boxes reach registers through the
// thread's own shared-memory slots, by cp.async). The chain runs
// unconditionally (integrate_group), so a step never waits on the previous
// step's box tests and ballot; (x1, valid) stay the one-thread body's to the
// bit whatever G. At the demo's 8 boxes G = 4 gives each sub-lane two, in
// registers: 128 blocks on 128 SMs, each step 2 box tests instead of 8. The
// heading's cosine and sine come from one sincosf (cos_sin), one range
// reduction for the pair instead of two in a row; it rounds as cosf and
// sinf apart for every float (ops/chains_cuda.py::sincos_differences).
// With G > 1 the threads past R stay in their warp (neutral state, masked
// loads and stores) for the ballot, and sub-lane 0 alone writes the
// outputs. Blocks stay kThreads threads, kThreads / G rollouts each, so
// B6's problems still start on block boundaries. Where the card is full,
// G > 1 only adds work (the chain runs G times), so the wrapper's rule
// (ops/rollout_cuda.py::lanes_per_rollout) picks G = 1 there. At G = 1 the
// same body walks the block's whole set in shared memory (WalkBoxes),
// padded with neutral boxes to a multiple of kWalk so it reads whole passes
// of 16-byte boxes, and the broad phase's 8 boxes (the demo's and the
// sweeps') as one unrolled walk without a branch; no ballot. Its
// unconditional chain lets a step's trig and division start before the
// previous step's box tests end, which pays where a few warps share a
// scheduler. The culled instantiations (kCull) always run with G = 1:
// their warp is the unit that skips boxes together, which sub-lanes would
// split.
//
// Floating point: every add, subtract, multiply and divide of the step, of
// the rotation recurrence and of the footprint test is an explicit
// round-to-nearest intrinsic (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn),
// which nvcc never contracts into an FMA, in the plain PyTorch version's op
// order (cudasbmp_torch/systems/*.py, geometry/footprint.py), so kernel and
// plain version agree to the bit. The build keeps nvcc's default
// --fmad=true and no --use_fast_math: sincosf/cosf/sinf/tanf are the
// accurate CUDA math-library functions, compiled as PyTorch's own
// cos/sin/tan kernels are (sincosf rounds as cosf and sinf apart). dt =
// dur / num_disc is a true division.
//
// B2 draws its controls from Philox-4x32-10 (Random123): key = the two
// words of the wave's threefry control key, counter = (lane, 0, 0, 0),
// word j -> u = (bits >> 8) * 2^-24 -> lo_j + u * (hi_j - lo_j).
//
// Kernel B6, the per-problem form of B1 and B2, replaces jax.vmap of
// rollout_pallas / sample_and_rollout_pallas over per-problem obstacle sets
// (cudasbmp_tpu/parallel/batch_kgmt.py:200-211, 226-230): the batched
// arena's Monte-Carlo sweep and the streaming sweep, where every problem
// has its own boxes. It is the same two kernels. A launch runs P problems
// of R lanes each, G threads per lane in blocks of kThreads: block j
// serves problem j / ceil(R * G / kThreads) and loads only that problem's
// boxes, at obstacles + stride * problem, with a stride of 4*K floats for
// B6 and 0 for B1/B2 (P = 1, one shared set). The Philox form keys
// problem b with keys[b] (a key stride of 2, or 0 for B2's one key) and
// draws lane r at counter (r, 0, 0, 0), so a problem's controls depend on
// its key and lane only, not on P or on the slot it occupies (the
// streaming sweep's partition invariance needs that). Problems lie on grid.x, so no grid
// extent caps P; P * R lanes must fit an int. B6 is bounded as B1 is, by
// the step loop's ALU and trig work, not by bytes (the boxes add 16*K bytes
// per block, once). Blocks are 128 threads, the sweeps' wave width R =
// 128 (bench.py's arena and sweep settings): in 256-thread blocks half of
// each B6 block idled while holding its registers, so 1,024 problems took
// more than one wave of blocks, and the demo's G = 4 waves used 64 SMs
// instead of 128 (PERF.md: 5-16% slower). Lane indices stay
// 32-bit: 64-bit ones made B1 and B2 4-13% slower on the card; with 32-bit
// ones they run as fast as before B6 joined them, to 1-2%.

#include <climits>
#include <cmath>
#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kStaticSmemLimit = 48 * 1024;
constexpr int kMaxSplit = 8;   // threads a rollout, at most
constexpr int kRegBoxes = 2;   // boxes a sub-lane holds in registers, at most
constexpr int kWalk = 4;       // the one-thread walk's boxes a pass (K padded to it)
constexpr int kCullSteps = 10; // B5: the most steps of a window, kept in shared memory
constexpr int kMaxPlan = 256;  // B5: the most windows a launch's plan holds
constexpr unsigned kFullWarp = 0xffffffffu;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// (cos x, sin x) from one sincosf
__device__ __forceinline__ float2 cos_sin(float x) {
  float sn, cs;
  sincosf(x, &sn, &cs);
  return make_float2(cs, sn);
}

// x + (v * c) * dt, the position update every system shares
__device__ __forceinline__ float advance(float x, float v, float c, float dt) {
  return add(x, mul(mul(v, c), dt));
}

// (c, s) rotated by (dc, ds): (c*dc - s*ds, s*dc + c*ds)
__device__ __forceinline__ void rotate(float& c, float& s, float dc, float ds) {
  const float nc = sub(mul(c, dc), mul(s, ds));
  const float ns = add(mul(s, dc), mul(c, ds));
  c = nc;
  s = ns;
}

// ---- systems: state (x, y, z, w) in a float4, controls (c0, c1) + dur ----
// kHeading: z is the heading (footprint narrow phase); kFast: the system has
// the fast-math hooks. Each struct is the device form of
// cudasbmp_torch/systems/<name>.py, op for op.

struct Bicycle {  // (x, y, theta, v); controls (a, steering)
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
  // the new state from the pre-step carry; the carry then moves to the new
  // state (the rollout reads k.ct/k.st as the new pose's heading)
  __device__ float4 step_fast(float4 s, Carry& k, FastAux q, float dt) const {
    const float4 n = make_float4(advance(s.x, s.w, k.ct, dt),
                                 advance(s.y, s.w, k.st, dt), add(s.z, k.dth),
                                 add(s.w, mul(q.a, dt)));
    rotate(k.ct, k.st, k.dct, k.dst);
    rotate(k.dct, k.dst, q.cc2, q.sc2);
    k.dth = add(k.dth, q.c2);
    return n;
  }
};

struct Point2D {  // (x, y, 0, 0); controls (vx, vy)
  static constexpr bool kHeading = false, kFast = false;
  struct Aux { float vx, vy; };
  __device__ Aux prepare(float vx, float vy) const { return {vx, vy}; }
  __device__ float4 step(float4 s, Aux q, float dt) const {
    return make_float4(add(s.x, mul(q.vx, dt)), add(s.y, mul(q.vy, dt)), 0.0f,
                       0.0f);
  }
};

struct DoubleIntegrator {  // (x, y, vx, vy); controls (ax, ay)
  static constexpr bool kHeading = false, kFast = false;
  struct Aux { float ax, ay; };
  __device__ Aux prepare(float ax, float ay) const { return {ax, ay}; }
  __device__ float4 step(float4 s, Aux q, float dt) const {
    return make_float4(add(s.x, mul(s.z, dt)), add(s.y, mul(s.w, dt)),
                       add(s.z, mul(q.ax, dt)), add(s.w, mul(q.ay, dt)));
  }
};

// Unicycle (omega) and Dubins (v * kappa): a constant heading rate per
// rollout, so fast math is one rotation per step.
template <bool kCurvature>
struct ConstantTurn {  // (x, y, theta, 0); controls (v, omega | kappa)
  static constexpr bool kHeading = true, kFast = true;
  struct Aux { float v, turn; };
  struct Carry { float ct, st; };
  struct FastAux { float v, turn, dct, dst; };
  __device__ Aux prepare(float v, float turn) const { return {v, turn}; }
  __device__ float dtheta(float v, float turn, float dt) const {
    return kCurvature ? mul(mul(v, turn), dt) : mul(turn, dt);
  }
  __device__ float4 step(float4 s, Aux q, float dt) const {
    const float2 cs = cos_sin(s.z);
    return make_float4(advance(s.x, q.v, cs.x, dt),
                       advance(s.y, q.v, cs.y, dt),
                       add(s.z, dtheta(q.v, q.turn, dt)), 0.0f);
  }
  __device__ void prepare_fast(float4 s, float v, float turn, float dt,
                               Carry& k, FastAux& q) const {
    const float d0 = dtheta(v, turn, dt);
    k = {cosf(s.z), sinf(s.z)};
    q = {v, turn, cosf(d0), sinf(d0)};
  }
  __device__ float4 step_fast(float4 s, Carry& k, FastAux q, float dt) const {
    const float4 n = make_float4(advance(s.x, q.v, k.ct, dt),
                                 advance(s.y, q.v, k.st, dt),
                                 add(s.z, dtheta(q.v, q.turn, dt)), 0.0f);
    rotate(k.ct, k.st, q.dct, q.dst);
    return n;
  }
};
using Unicycle = ConstantTurn<false>;
using Dubins = ConstantTurn<true>;

#ifdef CUDASBMP_USER_SYSTEM
// A user's system (cudasbmp_torch/systems/base.py::DeviceStructMixin):
// struct UserSystem, with the interface of the structs above, written into
// this header by ops/_build.py. A library built with the macro instantiates
// the kernels for UserSystem alone (kUser below), none of the five above;
// the package's own library is built without it. R1's adjoint sums and
// dvd are here so that one struct, back() and all, compiles in both files.
struct Grad { float c0, c1, dt; };
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
#include <cudasbmp_user_system.cuh>
// UserSystem{param} where the struct holds one float, else UserSystem{}
template <class S>
auto make_user(float param, int) -> decltype(S{param}) { return S{param}; }
template <class S>
S make_user(float, long) { return S{}; }
#endif

// System ids of the C entry points (ops/rollout_cuda.py::SYSTEM_IDS; kUser,
// USER_SYSTEM_ID, in a user library only).
enum SystemId { kBicycle = 0, kPoint2D = 1, kDoubleIntegrator = 2,
                kUnicycle = 3, kDubins = 4, kUser = 5 };
enum Flags { kFlagFootprint = 1, kFlagFast = 2 };

struct Params {
  const float* obstacles;  // [K, 4] xmin, ymin, xmax, ymax, or [P, K, 4]
  size_t obstacle_stride;  // floats from one problem's set to the next: 4*K or 0
  int K, R, num_disc;      // R lanes per problem
  int blocks_per_problem;  // ceil(R * split / kThreads)
  float width, height;
  float hl, hw;  // footprint half length / half width
  int windows;   // B5: windows of the culled broad phase's plan (0: off)
  float pad;     // B5: how far the body reaches from (x, y): hl + hypot(hl, hw)
  int split, split_log2;  // G threads a rollout (1 with windows) and log2 G
  int reg_boxes;          // ceil(K / G) <= kRegBoxes: boxes in registers
  unsigned lane0;         // sample: the Philox counter of a problem's lane 0
};

// B5's window plan, by value among the culled kernels' parameters: n
// windows of steps[w] steps each (1 to kCullSteps), in order, covering
// num_disc. The other kernels take NoPlan.
struct Plan {
  int n;
  unsigned char steps[kMaxPlan];
};
struct NoPlan {};
template <bool kCull>
using PlanOf = typename std::conditional<kCull, Plan, NoPlan>::type;

// The shared memory B5 keeps a block's window in: kCullSteps candidate
// states (float4) a thread and, with a footprint, as many poses (float2).
__host__ __device__ constexpr size_t cull_state_bytes(bool footprint) {
  return static_cast<size_t>(kThreads) * kCullSteps *
         (sizeof(float4) + (footprint ? sizeof(float2) : 0));
}

// K rounded up to a multiple of kWalk: the boxes of the block's shared set
__host__ __device__ __forceinline__ int padded(int K) {
  return (K + kWalk - 1) & ~(kWalk - 1);
}

__device__ __forceinline__ bool in_bounds(float nx, float ny, const Params& p) {
  return (nx > 0.0f) & (nx < p.width) & (ny > 0.0f) & (ny < p.height);
}

// One step's geometry: the swept AABB of (x, y) -> (nx, ny) and, with
// kFootprint, the body centred hl ahead of (nx, ny) along (ct, st).
// clears(box) is the step's test against one box. Padding boxes (min 1,
// max 0) are separated on every axis of the broad phase and fail valid_box
// in the narrow phase.
template <bool kFootprint>
struct StepTest {
  float bminx, bmaxx, bminy, bmaxy;
  float fcx = 0.0f, fcy = 0.0f, ct, st, act = 0.0f, ast = 0.0f;
  __device__ __forceinline__ StepTest(float x, float y, float nx, float ny,
                                      float ct_, float st_, const Params& p)
      : bminx(fminf(x, nx)), bmaxx(fmaxf(x, nx)), bminy(fminf(y, ny)),
        bmaxy(fmaxf(y, ny)), ct(ct_), st(st_) {
    if constexpr (kFootprint) {
      fcx = add(nx, mul(p.hl, ct));
      fcy = add(ny, mul(p.hl, st));
      act = fabsf(ct);
      ast = fabsf(st);
    }
  }
  __device__ __forceinline__ bool clears(const float* o, const Params& p) const {
    return clears(make_float4(o[0], o[1], o[2], o[3]), p);
  }
  __device__ __forceinline__ bool clears(float4 o, const Params& p) const {
    const float b0 = o.x, b1 = o.y, b2 = o.z, b3 = o.w;
    bool clear = (bmaxx <= b0) | (b2 <= bminx) | (bmaxy <= b1) | (b3 <= bminy);
    if constexpr (kFootprint) {
      const float bcx = mul(add(b0, b2), 0.5f), bcy = mul(add(b1, b3), 0.5f);
      const float bhx = mul(sub(b2, b0), 0.5f), bhy = mul(sub(b3, b1), 0.5f);
      const bool valid_box = (bhx >= 0.0f) & (bhy >= 0.0f);
      const float dx = sub(fcx, bcx), dy = sub(fcy, bcy);
      const bool sep_x =
          fabsf(dx) >= add(add(bhx, mul(p.hl, act)), mul(p.hw, ast));
      const bool sep_y =
          fabsf(dy) >= add(add(bhy, mul(p.hl, ast)), mul(p.hw, act));
      const bool sep_u = fabsf(add(mul(dx, ct), mul(dy, st))) >=
                         add(add(p.hl, mul(bhx, act)), mul(bhy, ast));
      const bool sep_v = fabsf(sub(mul(dy, ct), mul(dx, st))) >=
                         add(add(p.hw, mul(bhx, ast)), mul(bhy, act));
      clear &= !(valid_box & !(sep_x | sep_y | sep_u | sep_v));
    }
    return clear;
  }
};

// One rollout's Euler chain: the per-rollout precomputation of the exact
// step, or the fast-math carry. step() returns the candidate from s (and
// with fast math moves the carry on: a dead lane's carry keeps rotating,
// harmless, its state is frozen); pose() is the heading the footprint test
// takes at that candidate.
template <class Sys, bool kFast>
struct Chain {
  typename Sys::Aux q;
  __device__ __forceinline__ Chain(const Sys& sys, float4, float c0, float c1,
                                   float)
      : q(sys.prepare(c0, c1)) {}
  __device__ __forceinline__ float4 step(const Sys& sys, float4 s, float dt) {
    return sys.step(s, q, dt);
  }
  template <bool kFootprint>
  __device__ __forceinline__ void pose(float4 n, float& ct, float& st) const {
    ct = 1.0f;  // no heading: an axis-aligned body
    st = 0.0f;
    if constexpr (kFootprint && Sys::kHeading) {
      const float2 cs = cos_sin(n.z);
      ct = cs.x;
      st = cs.y;
    }
  }
};

template <class Sys>
struct Chain<Sys, true> {
  static_assert(Sys::kFast && Sys::kHeading, "fast math needs the hooks");
  typename Sys::Carry k;
  typename Sys::FastAux q;
  __device__ __forceinline__ Chain(const Sys& sys, float4 s, float c0,
                                   float c1, float dt) {
    sys.prepare_fast(s, c0, c1, dt, k, q);
  }
  __device__ __forceinline__ float4 step(const Sys& sys, float4 s, float dt) {
    return sys.step_fast(s, k, q, dt);
  }
  template <bool kFootprint>
  __device__ __forceinline__ void pose(float4, float& ct, float& st) const {
    ct = k.ct;  // the carry has moved to the candidate's heading
    st = k.st;
  }
};

// One step against the block's whole set in shared memory, for one thread a
// rollout (G = 1, more boxes than registers hold). load_boxes pads the set
// with neutral boxes to a multiple of kWalk, so the walk reads whole passes
// of kWalk boxes, 16 bytes a box, and has no remainder: a first pass of
// 2 * kWalk where the set has as many (the demo's and the sweeps' 8 boxes,
// with no loop test), then passes of kWalk.
template <bool kFootprint>
__device__ __forceinline__ bool walk(const StepTest<kFootprint>& t,
                                     const float4* obs, int K,
                                     const Params& p) {
  bool c = true;
  int o = 0;
  if (K >= 2 * kWalk) {
#pragma unroll
    for (int j = 0; j < 2 * kWalk; ++j) c &= t.clears(obs[j], p);
    o = 2 * kWalk;
  }
  for (; o < K; o += kWalk) {
#pragma unroll
    for (int j = 0; j < kWalk; ++j) c &= t.clears(obs[o + j], p);
  }
  return c;
}

// The AND of ``clear`` over the G sub-lanes of this thread's group (G > 1):
// one ballot of the whole warp, so every thread of the warp calls it.
__device__ __forceinline__ bool group_all(bool clear, const Params& p) {
  const unsigned votes = __ballot_sync(kFullWarp, clear);
  const unsigned group = ((1u << p.split) - 1u)
                         << ((threadIdx.x & 31) & ~(p.split - 1));
  return (votes & group) == group;
}

// How many boxes sub-lane g tests: those of o = g mod G below K.
__device__ __forceinline__ int boxes_of(int g, const Params& p) {
  return g < p.K ? ((p.K - 1 - g) >> p.split_log2) + 1 : 0;
}

// A box that clears every step that is in bounds: it is separated on every
// broad-phase axis from any finite swept box and fails valid_box in the
// narrow phase (a step out of bounds fails whatever the boxes say).
__device__ __forceinline__ float4 neutral_box() {
  return make_float4(INFINITY, INFINITY, -INFINITY, -INFINITY);
}

// Sub-lane g's boxes in registers (p.reg_boxes): its few, neutral boxes in
// the other slots, so every step tests all kRegBoxes slots without a branch.
// When the thread starts, stage() copies them from device memory into its
// own kRegBoxes slots of shared memory with cp.async, which holds no
// register while it runs; load() waits for the copy and reads them into
// registers once the chain is prepared. So their latency overlaps the
// prologue's, and no box is live in a register across its divisions and
// trig. No other thread reads the slots: no barrier.
struct RegBoxes {
  static constexpr bool kGroups = true;  // G = 1 (K <= kRegBoxes) or G > 1
  const float4* src;  // the problem's boxes in device memory
  float4* slot;       // this thread's kRegBoxes slots in shared memory
  int g;
  float4 box[kRegBoxes];
  __device__ __forceinline__ void stage(const Params& p) const {
    const int mine = boxes_of(g, p);
#pragma unroll
    for (int j = 0; j < kRegBoxes; ++j)
      if (j < mine)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 16;"
                     :: "r"(static_cast<unsigned>(
                            __cvta_generic_to_shared(slot + j))),
                        "l"(src + g + (j << p.split_log2))
                     : "memory");
  }
  __device__ __forceinline__ void load(const Params& p) {
    asm volatile("cp.async.wait_all;" ::: "memory");
    const int mine = boxes_of(g, p);
#pragma unroll
    for (int j = 0; j < kRegBoxes; ++j)
      box[j] = j < mine ? slot[j] : neutral_box();
  }
  template <bool kFootprint>
  __device__ __forceinline__ bool clear(const StepTest<kFootprint>& t,
                                        const Params& p) const {
    bool c = true;
#pragma unroll
    for (int j = 0; j < kRegBoxes; ++j) c &= t.clears(box[j], p);
    return c;
  }
};

// Sub-lane g's boxes in shared memory: o = g, g + G, ... below K.
struct SharedBoxes {
  static constexpr bool kGroups = true;
  const float4* obs;
  int g;
  __device__ __forceinline__ void load(const Params&) const {}
  template <bool kFootprint>
  __device__ __forceinline__ bool clear(const StepTest<kFootprint>& t,
                                        const Params& p) const {
    bool c = true;
    for (int o = g; o < p.K; o += p.split) c &= t.clears(obs[o], p);
    return c;
  }
};

// All K boxes of the block's set in shared memory, for one thread a rollout
// (G = 1, more boxes than registers hold): the padded walk, or with kK > 0
// exactly kK boxes, unrolled, with no branch (the broad phase at the demo's
// and the sweeps' 8 boxes).
template <int kK>
struct WalkBoxes {
  static constexpr bool kGroups = false;
  const float4* obs;
  __device__ __forceinline__ void load(const Params&) const {}
  template <bool kFootprint>
  __device__ __forceinline__ bool clear(const StepTest<kFootprint>& t,
                                        const Params& p) const {
    if constexpr (kK > 0) {
      bool c = true;
#pragma unroll
      for (int j = 0; j < kK; ++j) c &= t.clears(obs[j], p);
      return c;
    } else {
      return walk(t, obs, padded(p.K), p);
    }
  }
};

// The one-pass body of B1-B4 and B6, on a group of G threads or on one:
// sub-lane g tests the workspace bounds and its boxes (``boxes``: its few in
// registers, every G-th in shared memory, or with WalkBoxes at G = 1 the
// whole padded set), the group ANDs its verdicts with one ballot a step
// (kGroups), and a rollout freezes at the candidate of its first failing
// step. The chain runs unconditionally (u), as the culled body's pass 1
// does: a live rollout's state is u, and a dead one's candidates are never
// taken, so (s, alive) are those of the freeze-on-failure loop to the bit,
// while the next step's trig and division no longer wait on this step's
// box tests; the loop is unrolled by two so the compiler can overlap them.
template <class Sys, bool kFootprint, bool kFast, class Boxes>
__device__ __forceinline__ bool integrate_group(const Sys& sys, float4& s,
                                                float c0, float c1, float dur,
                                                Boxes boxes, const Params& p) {
  const float dt = __fdiv_rn(dur, static_cast<float>(p.num_disc));
  Chain<Sys, kFast> chain(sys, s, c0, c1, dt);
  boxes.load(p);
  float4 u = s;
  bool alive = true;
#pragma unroll 2
  for (int i = 0; i < p.num_disc; ++i) {
    const float4 n = chain.step(sys, u, dt);
    float ct, st;
    chain.template pose<kFootprint>(n, ct, st);
    const StepTest<kFootprint> t(u.x, u.y, n.x, n.y, ct, st, p);
    bool clear = in_bounds(n.x, n.y, p) & boxes.clear(t, p);
    if constexpr (Boxes::kGroups) {
      if (p.split > 1) clear = group_all(clear, p);
    }
    if (alive) s = n;
    alive &= clear;
    u = n;
  }
  return alive;
}

// ---- B5: the culled broad phase --------------------------------------
// Replaces _integrate_culled (cudasbmp_tpu/ops/rollout_pallas.py:143-328),
// the cull=W body of both TPU kernels. A TPU program of 8,192 lanes can only
// skip a box for all its lanes at once; here the unit is the warp, 32 lanes
// that branch together. The wrapper's plan (ops/rollout_cuda.py::cull_plan)
// gives the windows: Python's round(w * num_disc / W) (halves to even, as
// the JAX body splits the steps), each cut into sub-windows of at most
// kCullSteps steps. For each window:
//   the lane integrates the window's steps once, on the unconditional chain
//   (as integrate_group does), keeping each step's candidate state (and,
//   with a footprint, its pose) in the block's shared memory, the bounds
//   failures in a bit mask and the union box of its positions; the warp
//   takes the union over its live lanes (warp_union: one redux a side,
//   exact in any order), padded by the body's reach;
//   then the boxes that overlap that union box, found once a window by a
//   ballot over chunks of 32 boxes (one box a lane, so no list sized by K
//   is kept), each against every stored step of the window, OR their
//   failures into the mask. Its first set bit is the first failing step:
//   the lane takes that step's candidate and dies, or, with none, the
//   window's last state.
// A skipped box is separated from every swept box and body of the window,
// so (x1, valid) are B1's to the bit, whatever the grouping of lanes and
// whatever the windows, which only decide how much is skipped. Lanes dead
// at a window's start add nothing to its box and test nothing.
//
// What bounds it on this card: at the cull table's 2^17 lanes the ALU issue
// of one integration (its trig and true division) plus the culled box
// tests; one warp alone (the floor) waits on one lane's chain of steps,
// then on each window's reductions and ballots. So each step is
// integrated once (not once for the union box and again for the tests),
// the near boxes are balloted once a window (not once a step), and no
// step's trig waits on the previous step's box tests. Boxes
// outer, steps inner: on grouped lanes a warp has few near boxes a window,
// each tested against the window's steps in one short loop; the other
// order (each step against all near boxes, or either order chosen by the
// near count) ran slower there, and faster only on lanes far apart, where
// culling does not pay (PERF.md). The states cost shared memory,
// cull_state_bytes (20 KB a block, 30 KB with a footprint's poses), which
// the culled box cap gives up (max_obstacles): at the cull table's 24
// boxes eight blocks still fit an SM, so its 1,024 blocks run in one wave.
// kCullSteps = 10 is the repo's num_disc, so no window of any W is cut
// there. Lanes past R stay in the warp with neutral boxes, so every
// reduction and ballot has all 32 threads; B6's problems start on block
// boundaries, so no warp spans two problems.

// A float's bits as an int that orders as the float does (-0 below +0),
// and back: the map is its own inverse.
__device__ __forceinline__ int ordered(float v) {
  const int i = __float_as_int(v);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// The warp's union box of its lanes' boxes, padded by `pad`: one redux a
// side (__reduce_min_sync/__reduce_max_sync on the ordered bits, exact),
// in place of five shuffles and five fminf/fmaxf a side. A NaN position
// widens its side to NaN, so every box counts as near: conservative, and
// such a step fails the bounds test anyway.
__device__ __forceinline__ void warp_union(float& mnx, float& mxx, float& mny,
                                           float& mxy, float pad) {
  mnx = sub(unordered(__reduce_min_sync(kFullWarp, ordered(mnx))), pad);
  mxx = add(unordered(__reduce_max_sync(kFullWarp, ordered(mxx))), pad);
  mny = sub(unordered(__reduce_min_sync(kFullWarp, ordered(mny))), pad);
  mxy = add(unordered(__reduce_max_sync(kFullWarp, ordered(mxy))), pad);
}

// ``store`` is the block's window store (cull_state_bytes): this thread's
// candidate of step j at store[j * kThreads + threadIdx.x], then the poses.
template <class Sys, bool kFootprint, bool kFast>
__device__ __forceinline__ bool integrate_culled(const Sys& sys, float4& s,
                                                 float c0, float c1, float dur,
                                                 const float4* obs,
                                                 float4* store,
                                                 const Plan& plan,
                                                 const Params& p, bool active) {
  constexpr bool kPose = kFootprint && Sys::kHeading;
  const float dt = __fdiv_rn(dur, static_cast<float>(p.num_disc));
  Chain<Sys, kFast> chain(sys, s, c0, c1, dt);
  float4* const window = store + threadIdx.x;
  float2* const pose =
      reinterpret_cast<float2*>(store + kThreads * kCullSteps) + threadIdx.x;
  const int lane = threadIdx.x & 31;
  bool alive = active;
  float4 u = s;
  for (int w = 0; w < plan.n; ++w) {
    const int len = plan.steps[w];
    const float x = u.x, y = u.y;
    float mnx = x, mxx = x, mny = y, mxy = y;
    unsigned fail = 0;  // bit j: step j of the window fails
    for (int j = 0; j < len; ++j) {
      const float4 n = chain.step(sys, u, dt);
      if constexpr (kPose) {
        float ct, st;
        chain.template pose<kFootprint>(n, ct, st);
        pose[j * kThreads] = make_float2(ct, st);
      }
      window[j * kThreads] = n;
      fail |= static_cast<unsigned>(!in_bounds(n.x, n.y, p)) << j;
      mnx = fminf(mnx, n.x);
      mxx = fmaxf(mxx, n.x);
      mny = fminf(mny, n.y);
      mxy = fmaxf(mxy, n.y);
      u = n;
    }
    if (!alive) {
      mnx = mny = INFINITY;
      mxx = mxy = -INFINITY;
    }
    warp_union(mnx, mxx, mny, mxy, p.pad);
    for (int base = 0; base < p.K; base += 32) {
      bool near = false;
      if (base + lane < p.K) {
        const float4 o = obs[base + lane];
        near = !((mxx <= o.x) | (o.z <= mnx) | (mxy <= o.y) | (o.w <= mny));
      }
      for (unsigned m = __ballot_sync(kFullWarp, near); m; m &= m - 1) {
        if (!alive) continue;
        const float4 o = obs[base + __ffs(m) - 1];
        float px = x, py = y;
        for (int j = 0; j < len; ++j) {
          const float4 n = window[j * kThreads];
          float ct = 1.0f, st = 0.0f;  // no heading: an axis-aligned body
          if constexpr (kPose) {
            const float2 cs = pose[j * kThreads];
            ct = cs.x;
            st = cs.y;
          }
          const StepTest<kFootprint> t(px, py, n.x, n.y, ct, st, p);
          fail |= static_cast<unsigned>(!t.clears(o, p)) << j;
          px = n.x;
          py = n.y;
        }
      }
    }
    if (alive) {
      s = window[(fail ? __ffs(fail) - 1 : len - 1) * kThreads];
      alive = !fail;
    }
  }
  return alive;
}

template <class Sys, bool kFootprint, bool kFast, bool kCull>
__device__ __forceinline__ bool run(const Sys& sys, float4& s, float c0,
                                    float c1, float dur, const RegBoxes& regs,
                                    float* obs, const PlanOf<kCull>& plan,
                                    const Params& p, bool active, int g) {
  float4* const boxes = reinterpret_cast<float4*>(obs);
  if constexpr (kCull) {
    // the window store follows the padded set
    return integrate_culled<Sys, kFootprint, kFast>(
        sys, s, c0, c1, dur, boxes, boxes + padded(p.K), plan, p, active);
  } else {
    if (p.reg_boxes)
      return integrate_group<Sys, kFootprint, kFast>(sys, s, c0, c1, dur,
                                                     regs, p);
    if (p.split > 1)
      return integrate_group<Sys, kFootprint, kFast>(sys, s, c0, c1, dur,
                                                     SharedBoxes{boxes, g}, p);
    // the broad phase's 8 boxes as a fixed walk (with the footprint's test,
    // 8 unrolled boxes would only add registers)
    if constexpr (!kFootprint) {
      if (padded(p.K) == 2 * kWalk)
        return integrate_group<Sys, kFootprint, kFast>(
            sys, s, c0, c1, dur, WalkBoxes<2 * kWalk>{boxes}, p);
    }
    return integrate_group<Sys, kFootprint, kFast>(sys, s, c0, c1, dur,
                                                   WalkBoxes<0>{boxes}, p);
  }
}

// This thread's problem b, its lane r within it and its sub-lane g: the
// block holds kThreads / G rollouts, G adjacent threads each. False for a
// thread past the problem's last lane, which returns once the boxes are in
// place unless its warp needs it: the culled body (kCull) and G > 1.
// tests/test_torch_split.py::thread_map is this map in Python.
__device__ __forceinline__ bool locate(const Params& p, int& b, int& r,
                                       int& g) {
  b = p.obstacle_stride ? blockIdx.x / p.blocks_per_problem : 0;
  g = threadIdx.x & (p.split - 1);
  r = (blockIdx.x - b * p.blocks_per_problem) * (kThreads >> p.split_log2) +
      (threadIdx.x >> p.split_log2);
  return r < p.R;
}

// Problem b's boxes: sub-lane g's few staged for registers (p.reg_boxes,
// read in integrate_group), or all K copied into the block's shared memory.
// Called after the thread's own loads are issued, so their latencies
// overlap; a thread that returns at once (``runs`` false) stages none.
__device__ __forceinline__ RegBoxes load_boxes(const Params& p, int b, int g,
                                               float* obs, bool runs) {
  const float* src = p.obstacles + p.obstacle_stride * b;
  const RegBoxes regs{reinterpret_cast<const float4*>(src),
                      reinterpret_cast<float4*>(obs) + threadIdx.x * kRegBoxes,
                      g, {}};
  if (p.reg_boxes) {
    if (runs) regs.stage(p);
    return regs;
  }
  // the set, then neutral boxes up to a multiple of kWalk (walk)
  const int n = 4 * p.K;
  for (int j = threadIdx.x; j < 4 * padded(p.K); j += blockDim.x)
    obs[j] = j < n ? src[j] : ((j & 3) < 2 ? INFINITY : -INFINITY);
  __syncthreads();
  return regs;
}

template <class Sys, bool kFootprint, bool kFast, bool kCull>
__global__ void __launch_bounds__(kThreads)
    rollout_kernel(Sys sys, Params p, PlanOf<kCull> plan,
                   const float4* __restrict__ x0,
                   const float* __restrict__ controls,
                   float4* __restrict__ x1, uint8_t* __restrict__ valid) {
  extern __shared__ float4 smem[];  // the boxes, 16-byte aligned
  float* obs = reinterpret_cast<float*>(smem);
  int b, r, g;
  const bool active = locate(p, b, r, g);
  const int i = b * p.R + r;
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float c0 = 0.0f, c1 = 0.0f, dur = 0.0f;
  if (active) {
    s = x0[i];
    const float* c = controls + 3 * i;
    c0 = c[0];
    c1 = c[1];
    dur = c[2];
  }
  const bool runs = kCull || p.split > 1 || active;
  const RegBoxes regs = load_boxes(p, b, g, obs, runs);
  if (!runs) return;
  const bool alive = run<Sys, kFootprint, kFast, kCull>(
      sys, s, c0, c1, dur, regs, obs, plan, p, active, g);
  if (active && g == 0) {
    x1[i] = s;
    valid[i] = alive;
  }
}

__device__ __forceinline__ uint32_t mulhilo(uint32_t a, uint32_t b,
                                            uint32_t* hi) {
  const uint64_t prod = static_cast<uint64_t>(a) * b;
  *hi = static_cast<uint32_t>(prod >> 32);
  return static_cast<uint32_t>(prod);
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    uint32_t hi0, hi1;
    const uint32_t lo0 = mulhilo(0xD2511F53u, c.x, &hi0);
    const uint32_t lo1 = mulhilo(0xCD9E8D57u, c.z, &hi1);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ float draw(uint32_t bits, float lo, float hi) {
  const float u = static_cast<float>(bits >> 8) * (1.0f / 16777216.0f);
  return add(lo, mul(u, sub(hi, lo)));
}

struct Bounds { float lo0, lo1, lo2, hi0, hi1, hi2; };

// Lane r of problem b draws at counter (lane0 + r, 0, 0, 0) under the key
// words keys[key_stride * b]; every sub-lane of its group draws the same
// bits, and sub-lane 0 writes them.
template <class Sys, bool kFootprint, bool kFast, bool kCull>
__global__ void __launch_bounds__(kThreads)
    sample_and_rollout_kernel(Sys sys, Params p, PlanOf<kCull> plan,
                              Bounds bounds,
                              const int64_t* __restrict__ keys, int key_stride,
                              const float4* __restrict__ x0,
                              float4* __restrict__ x1,
                              float* __restrict__ controls,
                              uint8_t* __restrict__ valid) {
  extern __shared__ float4 smem[];  // the boxes, 16-byte aligned
  float* obs = reinterpret_cast<float*>(smem);
  int b, r, g;
  const bool active = locate(p, b, r, g);
  const int i = b * p.R + r;
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (active) s = x0[i];
  const int64_t* key = keys + static_cast<size_t>(key_stride) * b;
  const uint4 bits =
      philox4x32_10(make_uint4(p.lane0 + static_cast<uint32_t>(r), 0u, 0u, 0u),
                    static_cast<uint32_t>(key[0]),
                    static_cast<uint32_t>(key[1]));
  const float c0 = draw(bits.x, bounds.lo0, bounds.hi0);
  const float c1 = draw(bits.y, bounds.lo1, bounds.hi1);
  const float dur = draw(bits.z, bounds.lo2, bounds.hi2);
  const bool runs = kCull || p.split > 1 || active;
  const RegBoxes regs = load_boxes(p, b, g, obs, runs);
  if (!runs) return;
  const bool alive = run<Sys, kFootprint, kFast, kCull>(
      sys, s, c0, c1, dur, regs, obs, plan, p, active, g);
  if (active && g == 0) {
    float* c = controls + 3 * i;
    c[0] = c0;
    c[1] = c1;
    c[2] = dur;
    x1[i] = s;
    valid[i] = alive;
  }
}

// The two kernels: rollout (B1, B6) and sample-and-rollout (B2, B6 Philox).
enum Form { kRollout = 0, kSample = 1 };

// Launch arguments other than the system, the template flags and Params.
struct Buffers {
  const void* x0;
  const void* controls;  // rollout: input
  void* x1;
  void* controls_out;  // sample: output
  void* valid;
  const void* keys;    // sample: [2], or [P, 2] with key_stride 2
  int key_stride;      // sample: 0 or 2
  Bounds bounds;       // sample
  Plan plan;           // B5 (p.windows > 0)
  int blocks;          // P * blocks_per_problem
  cudaStream_t stream;
};

// Opt in to more than 48 KB of dynamic shared memory where K needs it.
template <class Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= kStaticSmemLimit) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) cudaGetLastError();  // leave no error for a later launch
  return static_cast<int>(e);
}

template <int kForm, class Sys, bool kFootprint, bool kFast, bool kCull>
int launch(const Sys& sys, const Params& p, const Buffers& b) {
  // the walk's K boxes padded (B5: and its window store), or each
  // thread's kRegBoxes staging slots
  size_t smem = p.reg_boxes ? sizeof(float4) * kThreads * kRegBoxes
                            : sizeof(float4) * padded(p.K);
  PlanOf<kCull> plan{};
  if constexpr (kCull) {
    smem += cull_state_bytes(kFootprint);
    plan = b.plan;
  }
  const auto x0 = static_cast<const float4*>(b.x0);
  const auto x1 = static_cast<float4*>(b.x1);
  const auto valid = static_cast<uint8_t*>(b.valid);
  int err = 0;
  if constexpr (kForm == kSample) {
    auto kernel = sample_and_rollout_kernel<Sys, kFootprint, kFast, kCull>;
    if ((err = allow_smem(kernel, smem))) return err;
    kernel<<<b.blocks, kThreads, smem, b.stream>>>(
        sys, p, plan, b.bounds, static_cast<const int64_t*>(b.keys),
        b.key_stride, x0, x1, static_cast<float*>(b.controls_out), valid);
  } else {
    auto kernel = rollout_kernel<Sys, kFootprint, kFast, kCull>;
    if ((err = allow_smem(kernel, smem))) return err;
    kernel<<<b.blocks, kThreads, smem, b.stream>>>(
        sys, p, plan, x0, static_cast<const float*>(b.controls), x1, valid);
  }
  return static_cast<int>(cudaGetLastError());
}

// B5 is its own instantiation, so the one-pass kernels stay as they were.
template <int kForm, class Sys, bool kFootprint, bool kFast>
int launch_cull(const Sys& sys, const Params& p, const Buffers& b) {
  if (p.windows) return launch<kForm, Sys, kFootprint, kFast, true>(sys, p, b);
  return launch<kForm, Sys, kFootprint, kFast, false>(sys, p, b);
}

// Fast math on a system without the hooks is the exact path, as in the JAX
// kernel (use_fast = fast_math and hasattr(system, "soa_step_fast")).
template <int kForm, class Sys>
int launch_flags(const Sys& sys, int flags, const Params& p,
                 const Buffers& b) {
  const bool fast = Sys::kFast && (flags & kFlagFast);
  if (flags & kFlagFootprint) {
    if constexpr (Sys::kFast) {
      if (fast) return launch_cull<kForm, Sys, true, true>(sys, p, b);
    }
    return launch_cull<kForm, Sys, true, false>(sys, p, b);
  }
  if constexpr (Sys::kFast) {
    if (fast) return launch_cull<kForm, Sys, false, true>(sys, p, b);
  }
  return launch_cull<kForm, Sys, false, false>(sys, p, b);
}

template <int kForm>
int launch_system(int system, float param, int flags, const Params& p,
                  const Buffers& b) {
#ifdef CUDASBMP_USER_SYSTEM
  if (system != kUser) return static_cast<int>(cudaErrorInvalidValue);
  return launch_flags<kForm>(make_user<UserSystem>(param, 0), flags, p, b);
#else
  switch (system) {
    case kBicycle: return launch_flags<kForm>(Bicycle{param}, flags, p, b);
    case kPoint2D: return launch_flags<kForm>(Point2D{}, flags, p, b);
    case kDoubleIntegrator:
      return launch_flags<kForm>(DoubleIntegrator{}, flags, p, b);
    case kUnicycle: return launch_flags<kForm>(Unicycle{}, flags, p, b);
    case kDubins: return launch_flags<kForm>(Dubins{}, flags, p, b);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#endif
}

// The shared memory a block may opt in to, in bytes, or -cudaError_t.
int smem_optin(int device) {
  int bytes = 0;
  const cudaError_t e = cudaDeviceGetAttribute(
      &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return e == cudaSuccess ? bytes : -static_cast<int>(e);
}

// The most boxes a block's shared memory holds beside `state_bytes` (B5's
// window store), padded set included (ops/rollout_cuda.py::box_cap).
int max_obstacles(int optin, size_t state_bytes) {
  const long long room =
      static_cast<long long>(optin) - static_cast<long long>(state_bytes);
  return room > 0 ? static_cast<int>(room / 16) & ~(kWalk - 1) : 0;
}

// Check a launch of P problems of R lanes at G = split threads a rollout
// and fill p and b's grid (no blocks: nothing to launch): ceil(R * G /
// kThreads) blocks a problem (tests/test_torch_split.py::launch_geometry).
// Returns 0 or a cudaError_t.
int prepare(int device, int flags, const void* obstacles, int K,
            int per_problem, int P, int R, int num_disc, float width,
            float height, float hl, float hw, int windows,
            const unsigned char* plan, float pad, int split, Params* p,
            Buffers* b) {
  const cudaError_t invalid = cudaErrorInvalidValue;
  if (P < 0 || R < 0 || K < 0 || num_disc < 1 || (flags & ~3) ||
      (per_problem & ~1) || windows < 0 || windows > kMaxPlan ||
      (windows && !plan) || split < 1 || split > kMaxSplit ||
      (split & (split - 1)) || (windows && split != 1))
    return static_cast<int>(invalid);
  // B5's plan: windows of 1 to kCullSteps steps that cover num_disc
  int steps = 0;
  for (int w = 0; w < windows; ++w) {
    if (plan[w] < 1 || plan[w] > kCullSteps) return static_cast<int>(invalid);
    b->plan.steps[w] = plan[w];
    steps += plan[w];
  }
  if (windows && steps != num_disc) return static_cast<int>(invalid);
  b->plan.n = windows;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int optin = smem_optin(device);
  if (optin < 0) return -optin;
  if (K > max_obstacles(optin, windows ? cull_state_bytes(flags & kFlagFootprint)
                                       : 0))
    return static_cast<int>(invalid);
  const long long per =
      (static_cast<long long>(R) * split + kThreads - 1) / kThreads;
  if (static_cast<long long>(P) * R > INT_MAX || P * per > INT_MAX)
    return static_cast<int>(invalid);
  b->blocks = static_cast<int>(P * per);
  const int split_log2 = __builtin_ctz(split);
  *p = Params{static_cast<const float*>(obstacles),
              per_problem ? 4 * static_cast<size_t>(K) : 0, K, R, num_disc,
              per > 0 ? static_cast<int>(per) : 1, width, height, hl, hw,
              windows, pad, split, split_log2,
              !windows && ((K + split - 1) >> split_log2) <= kRegBoxes, 0u};
  return 0;
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers of
// contiguous tensors holding P problems of R lanes: x0/x1 f32 [P, R, 4],
// controls f32 [P, R, 3], valid bool [P, R]; obstacles f32 [K, 4] and key
// int64 [2] shared by every problem (per_problem 0: B1, B2 with P = 1), or
// obstacles f32 [P, K, 4] and keys int64 [P, 2] (per_problem 1: B6).
// `system` is a SystemId (kUser, and only it, in a user library), `param`
// the bicycle's wheelbase L or a user struct's float (unused by the other
// systems), `flags` ORs 1 = footprint (half extents hl, hw) and 2 =
// fast math; `windows` > 0 runs the culled broad phase B5 on the plan of
// that many windows (at most kMaxPlan) at `plan`, host memory, one byte a
// window: its steps (1 to kCullSteps, summing to num_disc), with the union
// boxes padded by `pad`; `split` is G, the threads a rollout (1, 2, 4 or
// 8; 1 with windows). `lane0` (sample only, >= 0) is the Philox counter of
// a problem's lane 0: a launch of lanes [lane0, lane0 + R) of a larger
// batch draws their controls. Each launches on `stream` without
// synchronising and returns 0 or a cudaError_t.

extern "C" int cudasbmp_smem_optin(int device) { return smem_optin(device); }

extern "C" int cudasbmp_rollout(int device, int system, int flags,
                                const void* x0, const void* controls,
                                const void* obstacles, int K, int per_problem,
                                void* x1, void* valid, int P, int R,
                                int num_disc, float width, float height,
                                float param, float hl, float hw,
                                int windows, const void* plan, float pad,
                                int split, void* stream) {
  Params p;
  Buffers b{};
  const int err = prepare(device, flags, obstacles, K, per_problem, P, R,
                          num_disc, width, height, hl, hw, windows,
                          static_cast<const unsigned char*>(plan), pad, split,
                          &p, &b);
  if (err || b.blocks == 0) return err;
  b.x0 = x0;
  b.controls = controls;
  b.x1 = x1;
  b.valid = valid;
  b.stream = static_cast<cudaStream_t>(stream);
  return launch_system<kRollout>(system, param, flags, p, b);
}

extern "C" int cudasbmp_sample_and_rollout(
    int device, int system, int flags, const void* keys, const void* x0,
    const void* obstacles, int K, int per_problem, void* x1, void* controls,
    void* valid, int P, int R, int num_disc, float width, float height,
    float param, float hl, float hw, int windows, const void* plan,
    float pad, float lo0, float lo1, float lo2, float hi0, float hi1,
    float hi2, int lane0, int split, void* stream) {
  if (lane0 < 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  Buffers b{};
  const int err = prepare(device, flags, obstacles, K, per_problem, P, R,
                          num_disc, width, height, hl, hw, windows,
                          static_cast<const unsigned char*>(plan), pad, split,
                          &p, &b);
  if (err || b.blocks == 0) return err;
  p.lane0 = static_cast<unsigned>(lane0);
  b.x0 = x0;
  b.x1 = x1;
  b.controls_out = controls;
  b.valid = valid;
  b.keys = keys;
  b.key_stride = per_problem ? 2 : 0;
  b.bounds = Bounds{lo0, lo1, lo2, hi0, hi1, hi2};
  b.stream = static_cast<cudaStream_t>(stream);
  return launch_system<kSample>(system, param, flags, p, b);
}
