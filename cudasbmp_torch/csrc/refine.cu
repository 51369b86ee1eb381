// Trajectory refinement for Hopper (sm_90a): kernel R1 (refine_kernel, the
// penalty's value and gradient, one launch an Adam step) and its redesign
// (refine_adam_kernel, the whole refinement in one launch), generic over the
// package's five dynamical systems and, in a library of its own
// (CUDASBMP_USER_SYSTEM), over a user's system's device struct that has the
// adjoint hook back().
//
// Neither replaces a TPU kernel: they compute what jitted XLA computes in
// cudasbmp_tpu/refine.py. R1 is jax.value_and_grad of _loss (refine.py:77-107,
// 122) for the penalty part of the objective,
//
//   collision_weight * (collision + oob) + goal_weight * goal_pen,
//
// and its gradient with respect to the controls (the time term, the sigmoid
// box, the masks and Adam stay torch ops around it: cudasbmp_torch/refine.py,
// the step path). Its plain twin is ops/refine_cuda.py::refine_penalty_torch
// under autograd. refine_adam_kernel is the jitted scan of _refine_core
// (refine.py:111-151) vmapped over problems (_refine_batch_jit): every Adam
// step, the best iterate and the final choice; its plain twin is
// ops/refine_cuda.py::refine_adam_torch.
//
// What bounds them: one problem is a dependent chain of T = L * num_disc
// Euler steps forward and as many reverse steps back (T reaches some 1,500 at
// the quality pipeline's padded paths, 240 on its longest real one), against
// a few kilobytes of inputs, so neither bytes nor the card's operation rate
// bound them: the latency of the two serial chains does, 400 times over for
// a refinement. R1 keeps the chain on one thread and gives the block's other
// threads the work that is not a chain:
//
// - one block a problem (B = 1 for the CLI's path, 128 for the pipeline),
//   kThreads threads;
// - phase 1: thread 0 runs the Euler chain of all T steps and stores the
//   T + 1 states in global scratch (24 KB a problem at T = 1,500, resident
//   in L2; the wrapper sizes it, so no T is cut);
// - phase 2: all threads score the points, point t on thread t mod
//   kThreads: the penalty of each point over the K boxes and the four
//   bounds, and d penalty / d (x, y) of the point into scratch; each thread
//   sums its points in order, then a tree over the block (a fixed order, no
//   float atomics: block_terms);
// - phase 3: thread 0 adds the goal term on the last point and runs the
//   reverse sweep: the state adjoint goes back through each step's Jacobian
//   (Sys::back, one device function a system beside its step) and each
//   edge's two controls and dt collect their gradients; d/d dur is d/d dt
//   over num_disc.
//
// refine_adam_kernel runs R1's three phases and the Adam step around them
// in a loop inside one block a problem, so a refinement is one launch where
// R1's step path is 401 launches of R1 and a dozen torch ops each:
//
// - each problem integrates its own path only: T_b = L_b * num_disc steps,
//   L_b = 1 + its last unmasked edge (0 for an unsolved row, which still
//   scores the goal term at x0 every step). Edges past it have duration 0
//   and weight 0: they leave the states, the penalty's sums and the adjoint
//   as they are, so the bits are those of the padded run;
// - its working set lives in dynamic shared memory (Layout: the T_b + 1
//   states, each point's position gradient, heading trig, adjoint and
//   chain increments, each edge's prepared controls and dt, and the raw
//   controls, Adam's m and v, the best iterate, the sigmoid outputs, the
//   boxed controls and the gradient, 3 an edge), or, where a problem's set
//   does not fit in the block's opt-in shared memory, in global scratch
//   (the kShared = false instantiation, chosen by the wrapper by size);
// - the chains are staged for the five built-in systems, whose step is
//   triangular: the speed does not depend on the heading, nor either on
//   the position (level()). A level's increments of every step come from
//   the system's own step (back in reverse) by all threads at once, with
//   the components not yet known set to -0, the identity of add, so each
//   is exactly the increment R1's step adds; then one lane a component adds
//   them in order (chain_up, chain_down: eight increments from two vector
//   loads made a batch ahead, laid out component by component). The
//   forward is three add chains for the bicycle (speed, heading, then x
//   and y side by side), the sweep three more (the point gradients into
//   x and y, then the heading's and the speed's adjoints), and every
//   step's contributions to the controls' gradient are summed an edge a
//   thread in R1's order. R1's operations on R1's operands in R1's order:
//   the states and gradients are R1's to the bit. The serial path is an
//   add a step where R1's is a step's whole arithmetic (its sincosf and two
//   IEEE divisions in the sweep). A user struct runs R1's simple chain on
//   thread 0, with each state, trig pair and point gradient loaded one
//   step ahead in the sweep;
// - the sigmoid box, the time term, the per-problem clip by the gradient's
//   norm (row_sum's pairwise tree over the 3 L_b entries), Adam with the
//   bias tables the wrapper makes with torch's pow, the best iterate and the
//   final choice run on all threads in the op order of cudasbmp_torch/
//   refine.py's step path, each rounding an explicit intrinsic: losses
//   [iterations, B] and the refined controls equal the step path's to the
//   bit on the card.
//
// Floating point: the forward chain rounds as the systems' step does, every
// add, subtract, multiply and divide an explicit round-to-nearest intrinsic
// (never contracted into an FMA), dt = dur / num_disc a true division and
// the trig the accurate CUDA math-library functions (the heading's cosine
// and sine from one sincosf, which rounds as cosf and sinf apart), so the
// states equal the twin's to the bit on the card. The penalty and the
// gradient sum in another order than autograd: they agree within rounding.
// The sigmoid is 1 / (1 + expf(-x)) and its backward (g (1 - y)) y, as
// PyTorch's CUDA kernels compute them. Kinks follow JAX's (and torch's)
// conventions: max gives each side half the gradient at a tie, relu'(0) = 0.

#include <climits>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kTerms = 5;  // collision and the four bounds, summed apart

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// (cos x, sin x) from one sincosf
__device__ __forceinline__ float2 cos_sin(float x) {
  float sn, cs;
  sincosf(x, &sn, &cs);
  return make_float2(cs, sn);
}

// ---- systems: state (x, y, z, w) in a float4, controls (c0, c1) + dur ----
// step() is the device form of cudasbmp_torch/systems/<name>.py::step, op
// for op. back(s, q, dt, lam, g) takes the adjoint lam of the state after a
// step from s, adds the step's contributions to g = (d/dc0, d/dc1, d/ddt)
// and returns the adjoint of s. A system with a heading also has step_cs
// and back_cs, the same with the heading's (cos, sin) handed in, so the
// whole refinement computes them once a step and keeps them for the sweep.
// level(c) says how the step updates component c (x, y, z, w): -1 sets it
// to a constant, a level k >= 0 adds to it an increment that depends only on
// controls and on components of levels below k (a triangular step: the
// whole refinement runs each level's additions as a chain of adds of
// increments computed beforehand, and the adjoint's in reverse order).

struct Grad { float c0, c1, dt; };

struct Bicycle {  // (x, y, theta, v); controls (a, steering)
  float L;
  __host__ __device__ static constexpr int level(int c) {
    return c < 2 ? 2 : c == 2 ? 1 : 0;  // x, y from theta and v; theta from v
  }
  struct Aux { float a, tan_s; };
  __device__ Aux prepare(float a, float steering) const {
    return {a, tanf(steering)};
  }
  __device__ float4 step_cs(float4 s, float2 cs, Aux q, float dt) const {
    return make_float4(add(s.x, mul(mul(s.w, cs.x), dt)),
                       add(s.y, mul(mul(s.w, cs.y), dt)),
                       add(s.z, mul(mul(dvd(s.w, L), q.tan_s), dt)),
                       add(s.w, mul(q.a, dt)));
  }
  __device__ float4 step(float4 s, Aux q, float dt) const {
    return step_cs(s, cos_sin(s.z), q, dt);
  }
  __device__ float4 back_cs(float4 s, float2 cs, Aux q, float dt, float4 lam,
                            Grad& g) const {
    const float vc = mul(s.w, cs.x), vs = mul(s.w, cs.y);
    const float vl = dvd(s.w, L), turn = mul(vl, q.tan_s);
    const float g_vc = mul(lam.x, dt), g_vs = mul(lam.y, dt);
    const float g_turn = mul(lam.z, dt);
    g.dt = add(g.dt, add(add(add(mul(lam.x, vc), mul(lam.y, vs)),
                             mul(lam.z, turn)), mul(lam.w, q.a)));
    g.c0 = add(g.c0, mul(lam.w, dt));
    // d tan(s) / ds = 1 + tan(s)^2, as JAX's tan rule
    g.c1 = add(g.c1, mul(mul(g_turn, vl), add(1.0f, mul(q.tan_s, q.tan_s))));
    const float g_th = sub(mul(mul(g_vs, s.w), cs.x), mul(mul(g_vc, s.w), cs.y));
    const float g_v = add(add(mul(g_vc, cs.x), mul(g_vs, cs.y)),
                          dvd(mul(g_turn, q.tan_s), L));
    return make_float4(lam.x, lam.y, add(lam.z, g_th), add(lam.w, g_v));
  }
  __device__ float4 back(float4 s, Aux q, float dt, float4 lam, Grad& g) const {
    return back_cs(s, cos_sin(s.z), q, dt, lam, g);
  }
};

struct Point2D {  // (x, y, 0, 0); controls (vx, vy)
  __host__ __device__ static constexpr int level(int c) { return c < 2 ? 0 : -1; }
  struct Aux { float vx, vy; };
  __device__ Aux prepare(float vx, float vy) const { return {vx, vy}; }
  __device__ float4 step(float4 s, Aux q, float dt) const {
    return make_float4(add(s.x, mul(q.vx, dt)), add(s.y, mul(q.vy, dt)), 0.0f,
                       0.0f);
  }
  __device__ float4 back(float4, Aux q, float dt, float4 lam, Grad& g) const {
    g.dt = add(g.dt, add(mul(lam.x, q.vx), mul(lam.y, q.vy)));
    g.c0 = add(g.c0, mul(lam.x, dt));
    g.c1 = add(g.c1, mul(lam.y, dt));
    return make_float4(lam.x, lam.y, 0.0f, 0.0f);
  }
};

struct DoubleIntegrator {  // (x, y, vx, vy); controls (ax, ay)
  __host__ __device__ static constexpr int level(int c) { return c < 2 ? 1 : 0; }
  struct Aux { float ax, ay; };
  __device__ Aux prepare(float ax, float ay) const { return {ax, ay}; }
  __device__ float4 step(float4 s, Aux q, float dt) const {
    return make_float4(add(s.x, mul(s.z, dt)), add(s.y, mul(s.w, dt)),
                       add(s.z, mul(q.ax, dt)), add(s.w, mul(q.ay, dt)));
  }
  __device__ float4 back(float4 s, Aux q, float dt, float4 lam, Grad& g) const {
    g.dt = add(g.dt, add(add(add(mul(lam.x, s.z), mul(lam.y, s.w)),
                             mul(lam.z, q.ax)), mul(lam.w, q.ay)));
    g.c0 = add(g.c0, mul(lam.z, dt));
    g.c1 = add(g.c1, mul(lam.w, dt));
    return make_float4(lam.x, lam.y, add(lam.z, mul(lam.x, dt)),
                       add(lam.w, mul(lam.y, dt)));
  }
};

// Unicycle (theta += omega * dt) and Dubins (theta += (v * kappa) * dt)
template <bool kCurvature>
struct ConstantTurn {  // (x, y, theta, 0); controls (v, omega | kappa)
  __host__ __device__ static constexpr int level(int c) {
    return c < 2 ? 1 : c == 2 ? 0 : -1;  // x, y from theta; the 4th set to 0
  }
  struct Aux { float v, turn; };
  __device__ Aux prepare(float v, float turn) const { return {v, turn}; }
  __device__ float rate(Aux q) const { return kCurvature ? mul(q.v, q.turn) : q.turn; }
  __device__ float4 step_cs(float4 s, float2 cs, Aux q, float dt) const {
    return make_float4(add(s.x, mul(mul(q.v, cs.x), dt)),
                       add(s.y, mul(mul(q.v, cs.y), dt)),
                       add(s.z, mul(rate(q), dt)), 0.0f);
  }
  __device__ float4 step(float4 s, Aux q, float dt) const {
    return step_cs(s, cos_sin(s.z), q, dt);
  }
  __device__ float4 back_cs(float4 s, float2 cs, Aux q, float dt, float4 lam,
                            Grad& g) const {
    const float g_vc = mul(lam.x, dt), g_vs = mul(lam.y, dt);
    const float g_rate = mul(lam.z, dt);
    g.dt = add(g.dt, add(add(mul(lam.x, mul(q.v, cs.x)), mul(lam.y, mul(q.v, cs.y))),
                         mul(lam.z, rate(q))));
    float g_v = add(mul(g_vc, cs.x), mul(g_vs, cs.y));
    if (kCurvature) {
      g_v = add(g_v, mul(g_rate, q.turn));
      g.c1 = add(g.c1, mul(g_rate, q.v));
    } else {
      g.c1 = add(g.c1, g_rate);
    }
    g.c0 = add(g.c0, g_v);
    const float g_th = sub(mul(mul(g_vs, q.v), cs.x), mul(mul(g_vc, q.v), cs.y));
    return make_float4(lam.x, lam.y, add(lam.z, g_th), 0.0f);
  }
  __device__ float4 back(float4 s, Aux q, float dt, float4 lam, Grad& g) const {
    return back_cs(s, cos_sin(s.z), q, dt, lam, g);
  }
};
using Unicycle = ConstantTurn<false>;
using Dubins = ConstantTurn<true>;

#ifdef CUDASBMP_USER_SYSTEM
// A user's system, as in rollout.cu (which has the struct's other helpers,
// repeated here): R1 instantiates for UserSystem alone, where it has back().
__device__ __forceinline__ float advance(float x, float v, float c, float dt) {
  return add(x, mul(mul(v, c), dt));
}
__device__ __forceinline__ void rotate(float& c, float& s, float dc, float ds) {
  const float nc = sub(mul(c, dc), mul(s, ds));
  const float ns = add(mul(s, dc), mul(c, ds));
  c = nc;
  s = ns;
}
#include <cudasbmp_user_system.cuh>
template <class S>
auto make_user(float param, int) -> decltype(S{param}) { return S{param}; }
template <class S>
S make_user(float, long) { return S{}; }
template <class S, class = void>
struct HasBack : std::false_type {};
template <class S>
struct HasBack<S, std::void_t<decltype(&S::back)>> : std::true_type {};
#endif

// A system whose heading trig the whole refinement keeps for the sweep: the
// built-in ones with step_cs and back_cs (a user struct runs step and back)
template <class S, class = void>
struct Hoisted : std::false_type {};
template <class S>
struct Hoisted<S, std::void_t<decltype(&S::back_cs)>> : std::true_type {};
// A system whose step is triangular (level(c)): the built-in ones; the
// whole refinement stages its chains (a user struct runs the simple chain)
template <class S, class = void>
struct Staged : std::false_type {};
template <class S>
struct Staged<S, std::void_t<decltype(&S::level)>> : std::true_type {};

// System ids of the C entry points (ops/rollout_cuda.py::SYSTEM_IDS; kUser,
// USER_SYSTEM_ID, in a user library only)
enum SystemId { kBicycle = 0, kPoint2D = 1, kDoubleIntegrator = 2,
                kUnicycle = 3, kDubins = 4, kUser = 5 };

// The penalty's constants: bounds penalised below margin and above xhi,
// yhi; the goal's radius 0.8 * goal_threshold; the two weights
struct Weights {
  float margin, xhi, yhi, goal_radius, collision_weight, goal_weight;
};

struct Params {
  const float* x0;         // [B, 4]
  const float* controls;   // [B, L, 3], masked durations 0
  const float* wts;        // [B, L], a weight per edge
  const float* goal;       // [B, 2]
  const float* obstacles;  // [K, 4] or [B, K, 4]
  size_t obstacle_stride;  // floats from one problem's boxes to the next: 4*K or 0
  int K, L, num_disc;
  Weights w;
  float4* states;  // scratch [B, T + 1, 4]
  float2* gpos;    // scratch [B, T, 2]: d penalty / d (x, y) of each point
  float* loss;     // [B]
  float* grad;     // [B, L, 3]
};

__device__ __forceinline__ float relu(float z) { return z > 0.0f ? z : 0.0f; }

// d max(a, b) / da for a cotangent g: all of it, none, or half at a tie
__device__ __forceinline__ float max_share(float a, float b, float g) {
  return a > b ? g : (a == b ? mul(0.5f, g) : 0.0f);
}

// One point's penalty terms (collision and the four bounds, weight w) added
// to acc, and its d penalty / d (x, y)
__device__ __forceinline__ float2 score_point(const Weights& c, const float* obs,
                                              int K, float px, float py, float w,
                                              float acc[kTerms]) {
  const float w2 = mul(w, 2.0f);
  float gx = 0.0f, gy = 0.0f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float* o = obs + 4 * k;
    const float dxa = sub(sub(o[0], c.margin), px), dxb = sub(sub(px, o[2]), c.margin);
    const float dya = sub(sub(o[1], c.margin), py), dyb = sub(sub(py, o[3]), c.margin);
    const float dx = fmaxf(dxa, dxb), dy = fmaxf(dya, dyb);
    const float depth = -fmaxf(dx, dy);  // > 0 inside the inflated box
    if (depth > 0.0f) {
      acc[0] = add(acc[0], mul(mul(depth, depth), w));
      const float g_out = -mul(w2, depth);  // d / d outside
      const float g_dx = max_share(dx, dy, g_out), g_dy = max_share(dy, dx, g_out);
      gx = add(gx, sub(max_share(dxb, dxa, g_dx), max_share(dxa, dxb, g_dx)));
      gy = add(gy, sub(max_share(dyb, dya, g_dy), max_share(dya, dyb, g_dy)));
    }
  }
  const float zx0 = sub(c.margin, px), zx1 = sub(px, c.xhi);
  const float zy0 = sub(c.margin, py), zy1 = sub(py, c.yhi);
  acc[1] = add(acc[1], mul(mul(relu(zx0), relu(zx0)), w));
  acc[2] = add(acc[2], mul(mul(relu(zx1), relu(zx1)), w));
  acc[3] = add(acc[3], mul(mul(relu(zy0), relu(zy0)), w));
  acc[4] = add(acc[4], mul(mul(relu(zy1), relu(zy1)), w));
  gx = add(gx, sub(mul(w2, relu(zx1)), mul(w2, relu(zx0))));
  gy = add(gy, sub(mul(w2, relu(zy1)), mul(w2, relu(zy0))));
  return make_float2(mul(c.collision_weight, gx), mul(c.collision_weight, gy));
}

// Each thread's kTerms sums, summed over the block in one fixed tree: level
// h adds thread i + h's partial to thread i's for h = kThreads / 2 down to
// 1, the levels below a warp by shuffles in warp 0. Only the first `live`
// threads hold points: a level h >= live adds +0 to sums of non-negative
// terms, which leaves them as they are, so its barrier is skipped. The
// totals are returned in thread 0.
__device__ __forceinline__ void block_terms(float (*partial)[kThreads],
                                            float acc[kTerms], int live) {
  for (int i = 0; i < kTerms; ++i) partial[i][threadIdx.x] = acc[i];
  __syncthreads();
  for (int half = kThreads / 2; half >= 32; half >>= 1) {
    if (half >= live) continue;
    if (threadIdx.x < half)
      for (int i = 0; i < kTerms; ++i)
        partial[i][threadIdx.x] = add(partial[i][threadIdx.x],
                                      partial[i][threadIdx.x + half]);
    __syncthreads();
  }
  if (threadIdx.x < 32)
    for (int i = 0; i < kTerms; ++i) {
      float v = partial[i][threadIdx.x];
      for (int half = 16; half > 0; half >>= 1)
        v = add(v, __shfl_down_sync(0xffffffffu, v, half));
      acc[i] = v;
    }
}

// The penalty from the block's totals and the end point's goal term; the
// goal term's d / d (x, y) of the end point in dgoal
__device__ __forceinline__ float penalty(const Weights& c, const float sums[kTerms],
                                         float4 end, float gx, float gy,
                                         float2& dgoal) {
  const float ex = sub(end.x, gx), ey = sub(end.y, gy);
  const float root = __fsqrt_rn(add(add(mul(ex, ex), mul(ey, ey)), 1e-9f));
  const float reach = relu(sub(root, c.goal_radius));
  const float oob = add(add(add(sums[1], sums[2]), sums[3]), sums[4]);
  // d goal_pen: 2 reach (relu'), d sqrt = 0.5 / root, d |e|^2 = 2 e
  const float g_sq = dvd(mul(mul(c.goal_weight, mul(2.0f, reach)), 0.5f), root);
  dgoal = make_float2(mul(g_sq, mul(2.0f, ex)), mul(g_sq, mul(2.0f, ey)));
  return add(mul(c.collision_weight, add(sums[0], oob)),
             mul(c.goal_weight, mul(reach, reach)));
}

template <class Sys>
__global__ void __launch_bounds__(kThreads) refine_kernel(Sys sys, Params p) {
  __shared__ float partial[kTerms][kThreads];
  const int b = blockIdx.x;
  const int nd = p.num_disc, T = p.L * nd;
  const float ndf = static_cast<float>(nd);
  float4* states = p.states + static_cast<size_t>(b) * (T + 1);
  float2* gpos = p.gpos + static_cast<size_t>(b) * T;
  const float* ctrl = p.controls + static_cast<size_t>(b) * p.L * 3;
  const float* wts = p.wts + static_cast<size_t>(b) * p.L;
  const float* obs = p.obstacles + p.obstacle_stride * b;

  // phase 1: the Euler chain
  if (threadIdx.x == 0) {
    const float* x = p.x0 + 4 * static_cast<size_t>(b);
    float4 s = make_float4(x[0], x[1], x[2], x[3]);
    states[0] = s;
    for (int l = 0; l < p.L; ++l) {
      const float dt = dvd(ctrl[3 * l + 2], ndf);
      const typename Sys::Aux q = sys.prepare(ctrl[3 * l], ctrl[3 * l + 1]);
      for (int k = 0; k < nd; ++k) {
        s = sys.step(s, q, dt);
        states[1 + l * nd + k] = s;
      }
    }
  }
  __syncthreads();

  // phase 2: each point's penalty and d penalty / d (x, y)
  float acc[kTerms] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int t = threadIdx.x; t < T; t += kThreads) {
    const float4 s = states[t + 1];
    gpos[t] = score_point(p.w, obs, p.K, s.x, s.y, wts[t / nd], acc);
  }
  block_terms(partial, acc, T);

  // phase 3: the goal term and the reverse sweep
  if (threadIdx.x != 0) return;
  float2 dgoal;
  p.loss[b] = penalty(p.w, acc, states[T], p.goal[2 * b], p.goal[2 * b + 1], dgoal);
  float4 lam = make_float4(add(dgoal.x, gpos[T - 1].x), add(dgoal.y, gpos[T - 1].y),
                           0.0f, 0.0f);
  float* grad = p.grad + static_cast<size_t>(b) * p.L * 3;
  for (int l = p.L - 1; l >= 0; --l) {
    const float dt = dvd(ctrl[3 * l + 2], ndf);
    const typename Sys::Aux q = sys.prepare(ctrl[3 * l], ctrl[3 * l + 1]);
    Grad g{0.0f, 0.0f, 0.0f};
    for (int k = nd - 1; k >= 0; --k) {
      const int t = l * nd + k;
      lam = sys.back(states[t], q, dt, lam, g);
      if (t > 0) {
        lam.x = add(lam.x, gpos[t - 1].x);
        lam.y = add(lam.y, gpos[t - 1].y);
      }
    }
    grad[3 * l] = g.c0;
    grad[3 * l + 1] = g.c1;
    grad[3 * l + 2] = dvd(g.dt, ndf);
  }
}

// ---- the whole refinement: refine_adam_kernel ----

struct AdamParams {
  const float* x0;               // [B, 4]
  const float* raw0;             // [B, L, 3]: the inverse sigmoid of controls0
  const float* controls0;        // [B, L, 3]
  const unsigned char* mask;     // [B, L]
  const float* goal;             // [B, 2]
  const float* obstacles;        // [K, 4] or [B, K, 4]
  size_t obstacle_stride;        // as Params
  const float* bias1;            // [iterations]: 1 - 0.9^(t+1)
  const float* bias2;            // [iterations]: 1 - 0.999^(t+1)
  float lo[3], hi[3];            // the control box
  int K, L, num_disc, iterations;
  Weights w;
  float time_weight, learning_rate, clip_norm;
  unsigned char* scratch;        // [B, workspace] bytes (kShared false)
  size_t workspace;              // bytes of a problem's working set
  float* losses;                 // [iterations, B]
  float* refined;                // [B, L, 3]
};

__host__ __device__ __forceinline__ size_t up16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// row_sum's width: the least power of two >= n (1 for n <= 1)
__host__ __device__ __forceinline__ int tree_width(int n) {
  int w = 1;
  while (w < n) w <<= 1;
  return w;
}

// A problem's working set for L edges of num_disc steps: byte offsets of
// each array (16-byte aligned) and the total
struct Layout {
  size_t states, trig, gpos, adj, inc, aux, dt, raw, m, v, best, y, ctrl, grad, tree, bytes;
};

// A component's stride in the arrays laid out component by component: T
// rounded up to whole batches of 8 (so each component's array is aligned)
__host__ __device__ __forceinline__ size_t component_stride(int L, int nd) {
  return (static_cast<size_t>(L) * nd + 7) & ~static_cast<size_t>(7);
}

__host__ __device__ __forceinline__ Layout layout(int L, int nd, size_t aux_bytes) {
  const size_t T = static_cast<size_t>(L) * nd, E = 3 * static_cast<size_t>(L);
  const size_t Tc = component_stride(L, nd);
  Layout o;
  size_t at = 0;
  o.states = at; at = up16(at + 16 * (T + 1));  // float4
  o.trig = at; at = up16(at + 8 * T);           // float2 (cos, sin) of a state's heading
  o.gpos = at; at = up16(at + 4 * 2 * Tc);      // d penalty / d x, then d / d y, a point
  o.adj = at; at = up16(at + 16 * T);           // float4 the adjoint entering a step's back
  o.inc = at; at = up16(at + 4 * 4 * Tc);       // a staged chain's increments, x, y, z, w
  o.aux = at; at = up16(at + aux_bytes * L);    // Sys::Aux an edge
  o.dt = at; at = up16(at + 4 * L);
  o.raw = at; at = up16(at + 4 * E);            // and m, v, best, y, ctrl, grad: 3 an edge
  o.m = at; at = up16(at + 4 * E);
  o.v = at; at = up16(at + 4 * E);
  o.best = at; at = up16(at + 4 * E);
  o.y = at; at = up16(at + 4 * E);
  o.ctrl = at; at = up16(at + 4 * E);
  o.grad = at; at = up16(at + 4 * E);
  o.tree = at; at = up16(at + 4 * static_cast<size_t>(tree_width(static_cast<int>(E))));
  o.bytes = at;
  return o;
}

// row_sum of buf[0, n) (_math.py: zero-padded to tree_width(n), then
// buf[i] + buf[i + s] for s = 1, 2, 4, ...), by the 32 lanes of one warp.
// Up to 256 entries each lane sums its own W / 32 in registers (the first
// levels pair neighbours); more, the levels that leave more than 32 partial
// sums run in buf. The rest by shuffles, a partial a lane; every lane
// returns the sum.
constexpr int kLaneSums = 8;  // entries a lane holds in registers, at most

__device__ __forceinline__ float warp_row_sum(float* buf, int n) {
  const int lane = threadIdx.x & 31, W = tree_width(n);
  if (W <= 32 * kLaneSums) {
    const int per = W > 32 ? W / 32 : 1;
    float x[kLaneSums];
#pragma unroll
    for (int k = 0; k < kLaneSums; ++k) {
      const int i = lane * per + k;
      x[k] = k < per && i < n ? buf[i] : 0.0f;
    }
#pragma unroll
    for (int s = 1; s < kLaneSums; s <<= 1)
#pragma unroll
      for (int k = 0; k + s < kLaneSums; k += 2 * s)
        if (s < per) x[k] = add(x[k], x[k + s]);
    float v = x[0];
    for (int h = 1; h * per < W; h <<= 1) v = add(v, __shfl_down_sync(0xffffffffu, v, h));
    return __shfl_sync(0xffffffffu, v, 0);
  }
  int s = 1;
  {
    for (int i = n + lane; i < W; i += 32) buf[i] = 0.0f;
    __syncwarp();
    for (; W / s > 32; s <<= 1) {
      for (int i = 2 * s * lane; i < W; i += 64 * s) buf[i] = add(buf[i], buf[i + s]);
      __syncwarp();
    }
  }
  float v = lane * s < n ? buf[lane * s] : 0.0f;  // partials past n sum zeros
  for (int h = 1; h * s < W; h <<= 1) v = add(v, __shfl_down_sync(0xffffffffu, v, h));
  return __shfl_sync(0xffffffffu, v, 0);
}

__device__ __forceinline__ float sigmoid(float x) {
  return dvd(1.0f, add(1.0f, expf(-x)));
}

// ---- the whole refinement's chains ----
// Every chain below runs R1's operations on R1's operands in R1's order;
// the staged forms only move work that is not a chain off it.

// The heading's (cos, sin) where the system takes them from the caller
template <class Sys>
__device__ __forceinline__ float4 step_at(const Sys& sys, float4 s, float2 cs,
                                          typename Sys::Aux q, float dt) {
  if constexpr (Hoisted<Sys>::value) return sys.step_cs(s, cs, q, dt);
  else return sys.step(s, q, dt);
}

template <class Sys>
__device__ __forceinline__ float4 back_at(const Sys& sys, float4 s, float2 cs,
                                          typename Sys::Aux q, float dt, float4 lam,
                                          Grad& g) {
  if constexpr (Hoisted<Sys>::value) return sys.back_cs(s, cs, q, dt, lam, g);
  else return sys.back(s, q, dt, lam, g);
}

// The forward chain on thread 0, R1's: each step's state, and the
// heading's (cos, sin) for the sweep
template <class Sys>
__device__ void forward_simple(const Sys& sys, float4* states, float2* trig,
                               const typename Sys::Aux* aux, const float* dts, int Lb,
                               int nd) {
  float4 s = states[0];
  for (int l = 0, t = 0; l < Lb; ++l) {
    const float dt = dts[l];
    const typename Sys::Aux q = aux[l];
    for (int k = 0; k < nd; ++k, ++t) {
      float2 cs = make_float2(0.0f, 0.0f);
      if constexpr (Hoisted<Sys>::value) {
        cs = cos_sin(s.z);
        trig[t] = cs;
      }
      s = step_at(sys, s, cs, q, dt);
      states[t + 1] = s;
    }
  }
}

// The reverse sweep on thread 0, R1's, from the adjoint lam of the last
// step: each state, trig pair and point gradient loaded one step ahead
template <class Sys>
__device__ void reverse_simple(const Sys& sys, const float4* states, const float2* trig,
                               const float* gpos, size_t Tc, const typename Sys::Aux* aux,
                               const float* dts, float* grad, int Lb, int nd, float4 lam) {
  const float ndf = static_cast<float>(nd);
  auto point = [=](int u) { return make_float2(gpos[u], gpos[Tc + u]); };
  int t = Lb * nd - 1;
  float4 s = states[t];
  float2 cs = Hoisted<Sys>::value ? trig[t] : make_float2(0.0f, 0.0f);
  float2 gp = t > 0 ? point(t - 1) : make_float2(0.0f, 0.0f);
  for (int l = Lb - 1; l >= 0; --l) {
    const float dt = dts[l];
    const typename Sys::Aux q = aux[l];
    Grad g{0.0f, 0.0f, 0.0f};
    for (int k = nd - 1; k >= 0; --k, --t) {
      const int u = t > 0 ? t - 1 : 0;
      const float4 s_next = states[u];
      const float2 cs_next = Hoisted<Sys>::value ? trig[u] : cs;
      const float2 gp_next = point(u > 0 ? u - 1 : 0);
      lam = back_at(sys, s, cs, q, dt, lam, g);
      if (t > 0) {
        lam.x = add(lam.x, gp.x);
        lam.y = add(lam.y, gp.y);
      }
      s = s_next;
      cs = cs_next;
      gp = gp_next;
    }
    grad[3 * l] = g.c0;
    grad[3 * l + 1] = g.c1;
    grad[3 * l + 2] = dvd(g.dt, ndf);
  }
}

template <class Sys>
__host__ __device__ constexpr int top_level() {
  int top = 0;
  for (int c = 0; c < 4; ++c) top = Sys::level(c) > top ? Sys::level(c) : top;
  return top;
}

// s with the components a stage does not know set to -0, the identity of
// add: forward at level lv those of level lv and above (and the
// constants), so a step from it gives each level-lv component exactly the
// increment R1's step adds to it; in reverse those of level lv and below,
// so back gives each level-lv adjoint exactly the increment R1's back adds
template <class Sys, bool kReverse>
__device__ __forceinline__ float4 unknown_as_identity(float4 s, int lv) {
  auto hide = [lv](int c, float v) {
    const int k = Sys::level(c);
    return k < 0 || (kReverse ? k <= lv : k >= lv) ? -0.0f : v;
  };
  return make_float4(hide(0, s.x), hide(1, s.y), hide(2, s.z), hide(3, s.w));
}

template <class Sys>
__device__ __forceinline__ void put_level(float4& dst, float4 src, int lv) {
  if (Sys::level(0) == lv) dst.x = src.x;
  if (Sys::level(1) == lv) dst.y = src.y;
  if (Sys::level(2) == lv) dst.z = src.z;
  if (Sys::level(3) == lv) dst.w = src.w;
}

// The component warp `warp` chains at level lv, or -1
template <class Sys>
__device__ __forceinline__ int chained(int lv, int warp) {
  int c = -1;
  for (int i = 0, k = 0; i < 4; ++i)
    if (Sys::level(i) == lv) c = k++ == warp ? i : c;
  return c;
}

// One lane's add chains. chain_up: v <- v + src[k] for k = 0, 1, ..., n -
// 1 in order, each sum stored to dst[4 k]; chain_down: the same for k =
// n - 1 down to 0. src is 16-byte aligned; whole batches of kBatch steps
// take their increments from two vector loads made a batch ahead (a load
// would otherwise wait behind the store before it: the compiler cannot
// tell the arrays apart), the rest one step at a time.
constexpr int kBatch = 8;

__device__ __forceinline__ void chain_up(float v, const float* src, float* dst, int n) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  const int whole = n & ~(kBatch - 1);
  float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b = a;  // steps i..i + 3, i + 4..i + 7
  if (whole > 0) {
    a = s4[0];
    b = s4[1];
  }
  for (int i = 0; i < whole; i += kBatch) {
    const int j = (i + kBatch < whole ? i + kBatch : i) / 4;  // the last reloads its own
    const float4 na = s4[j], nb = s4[j + 1];
    const float d[kBatch] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      v = add(v, d[k]);
      dst[4 * (i + k)] = v;
    }
    a = na;
    b = nb;
  }
  for (int i = whole; i < n; ++i) {
    v = add(v, src[i]);
    dst[4 * i] = v;
  }
}

__device__ __forceinline__ void chain_down(float v, const float* src, float* dst, int n) {
  const int whole = n & ~(kBatch - 1);
  for (int i = n - 1; i >= whole; --i) {
    v = add(v, src[i]);
    dst[4 * i] = v;
  }
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b = a;  // steps i..i + 3, i + 4..i + 7
  if (whole > 0) {
    a = s4[(whole - kBatch) / 4];
    b = s4[(whole - kBatch) / 4 + 1];
  }
  for (int i = whole - kBatch; i >= 0; i -= kBatch) {
    const int j = (i >= kBatch ? i - kBatch : i) / 4;  // the last reloads its own
    const float4 na = s4[j], nb = s4[j + 1];
    const float d[kBatch] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int k = kBatch - 1; k >= 0; --k) {
      v = add(v, d[k]);
      dst[4 * (i + k)] = v;
    }
    a = na;
    b = nb;
  }
}

// comp c of v, the components of level lv of v into dst[c * stride + at]
__device__ __forceinline__ float comp(float4 v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

template <class Sys>
__device__ __forceinline__ void put_components(float* dst, size_t stride, int at, float4 v,
                                               int lv) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (Sys::level(c) == lv) dst[c * stride + at] = comp(v, c);
}

// The forward chain staged by level: all threads compute the level's
// increments of every step (the top level also the heading's trig), then
// one lane a component adds them in order, R1's add on R1's operands.
// side() runs on warp 3 beside the first chains.
template <class Sys, class Side>
__device__ void forward_staged(const Sys& sys, float4* states, float2* trig, float* inc,
                               size_t Tc, const typename Sys::Aux* aux, const float* dts,
                               int Tb, int nd, Side side) {
  constexpr int kTop = top_level<Sys>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll  // each level's step keeps only the arithmetic of its components
  for (int lv = 0; lv <= kTop; ++lv) {
    for (int t = threadIdx.x; t < Tb; t += kThreads) {
      const int l = t / nd;
      float2 cs = make_float2(0.0f, 0.0f);
      if (Hoisted<Sys>::value && lv == kTop) {
        cs = cos_sin(states[t].z);
        trig[t] = cs;
      }
      // nothing is known at level 0: states[t + 1] is being written
      const float4 known = lv == 0 ? make_float4(-0.0f, -0.0f, -0.0f, -0.0f) : states[t];
      const float4 n = step_at(sys, unknown_as_identity<Sys, false>(known, lv), cs, aux[l],
                               dts[l]);
      put_components<Sys>(inc, Tc, t, n, lv);
      if (lv == 0) put_level<Sys>(states[t + 1], n, -1);
    }
    __syncthreads();
    const int c = chained<Sys>(lv, warp);
    if (c >= 0 && lane == 0) {
      float* S = reinterpret_cast<float*>(states) + c;
      chain_up(S[0], inc + c * Tc, S + 4, Tb);
    } else if (lv == 0 && warp == 3) {
      side();
    }
    __syncthreads();
  }
}

// The reverse sweep staged by level: the adjoint of each step (adj[t],
// entering its back) from lam at the last step; the top level's chains add
// the point gradients, each lower level's add the increments back gives
// its components with the unknown ones at -0; then every step's
// contributions to the controls' gradient (back with g at -0) and, a thread
// an edge, their sums in R1's order
template <class Sys>
__device__ void reverse_staged(const Sys& sys, const float4* states, const float2* trig,
                               const float* gpos, float4* adj, float* inc, size_t Tc,
                               const typename Sys::Aux* aux, const float* dts, float* grad,
                               int Lb, int nd) {
  constexpr int kTop = top_level<Sys>();
  const int Tb = Lb * nd, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll  // each level's back keeps only the arithmetic of its components
  for (int lv = kTop; lv >= 0; --lv) {
    if (lv < kTop) {  // step t's increments, at t - 1 (step 0's are not used)
      for (int t = 1 + threadIdx.x; t < Tb; t += kThreads) {
        Grad g{-0.0f, -0.0f, -0.0f};
        const float2 cs = Hoisted<Sys>::value ? trig[t] : make_float2(0.0f, 0.0f);
        const float4 n = back_at(sys, states[t], cs, aux[t / nd], dts[t / nd],
                                 unknown_as_identity<Sys, true>(adj[t], lv), g);
        put_components<Sys>(inc, Tc, t - 1, n, lv);
      }
      __syncthreads();
    }
    const int c = chained<Sys>(lv, warp);
    if (c >= 0 && lane == 0) {  // t = Tb - 1 down to 1: adj[t - 1] = adj[t] + ...
      float* A = reinterpret_cast<float*>(adj) + c;
      // the point gradient of t - 1, or the increment back gives at step t
      chain_down(A[4 * (Tb - 1)], (lv == kTop ? gpos : inc) + c * Tc, A, Tb - 1);
    }
    __syncthreads();
  }
  for (int t = threadIdx.x; t < Tb; t += kThreads) {
    Grad g{-0.0f, -0.0f, -0.0f};
    const float2 cs = Hoisted<Sys>::value ? trig[t] : make_float2(0.0f, 0.0f);
    float4 lam = adj[t];
    lam = make_float4(lam.x, lam.y, Sys::level(2) < 0 ? 0.0f : lam.z,
                      Sys::level(3) < 0 ? 0.0f : lam.w);
    back_at(sys, states[t], cs, aux[t / nd], dts[t / nd], lam, g);
    inc[t] = g.dt;
    inc[Tc + t] = g.c0;
    inc[2 * Tc + t] = g.c1;
  }
  __syncthreads();
  const float ndf = static_cast<float>(nd);
  for (int l = threadIdx.x; l < Lb; l += kThreads) {
    Grad g{0.0f, 0.0f, 0.0f};
    for (int k = nd - 1; k >= 0; --k) {
      const int t = l * nd + k;
      g.dt = add(g.dt, inc[t]);
      g.c0 = add(g.c0, inc[Tc + t]);
      g.c1 = add(g.c1, inc[2 * Tc + t]);
    }
    grad[3 * l] = g.c0;
    grad[3 * l + 1] = g.c1;
    grad[3 * l + 2] = dvd(g.dt, ndf);
  }
}

// one block a problem and an SM each: registers need not be shared
template <class Sys, bool kShared>
__global__ void __launch_bounds__(kThreads, 1) refine_adam_kernel(Sys sys, AdamParams p) {
  extern __shared__ __align__(16) unsigned char dynamic[];
  __shared__ float partial[kTerms][kThreads];
  __shared__ int edges;
  __shared__ float time_cost, scale;
  __shared__ bool better;
  using Aux = typename Sys::Aux;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int L = p.L, nd = p.num_disc;
  const float ndf = static_cast<float>(nd);
  const Layout lay = layout(L, nd, sizeof(Aux));
  unsigned char* ws = kShared ? dynamic : p.scratch + p.workspace * b;
  float4* states = reinterpret_cast<float4*>(ws + lay.states);
  float2* trig = reinterpret_cast<float2*>(ws + lay.trig);
  float* gpos = reinterpret_cast<float*>(ws + lay.gpos);  // x, then y: Tc apart
  float4* adj = reinterpret_cast<float4*>(ws + lay.adj);
  float* inc = reinterpret_cast<float*>(ws + lay.inc);
  const size_t Tc = component_stride(L, nd);
  Aux* aux = reinterpret_cast<Aux*>(ws + lay.aux);
  float* dts = reinterpret_cast<float*>(ws + lay.dt);
  float* raw = reinterpret_cast<float*>(ws + lay.raw);
  float* m = reinterpret_cast<float*>(ws + lay.m);
  float* v = reinterpret_cast<float*>(ws + lay.v);
  float* best = reinterpret_cast<float*>(ws + lay.best);
  float* ys = reinterpret_cast<float*>(ws + lay.y);
  float* ctrl = reinterpret_cast<float*>(ws + lay.ctrl);
  float* grad = reinterpret_cast<float*>(ws + lay.grad);
  float* tree = reinterpret_cast<float*>(ws + lay.tree);
  const unsigned char* mask = p.mask + static_cast<size_t>(b) * L;
  const float* raw0 = p.raw0 + static_cast<size_t>(b) * L * 3;
  const float* obs = p.obstacles + p.obstacle_stride * b;
  const float hl0 = sub(p.hi[0], p.lo[0]), hl1 = sub(p.hi[1], p.lo[1]),
              hl2 = sub(p.hi[2], p.lo[2]);
  auto span = [=](int j) { return j == 0 ? hl0 : j == 1 ? hl1 : hl2; };  // hi - lo

  // the problem's own path: 1 + its last unmasked edge
  if (tid == 0) edges = 0;
  __syncthreads();
  for (int l = tid; l < L; l += kThreads)
    if (mask[l]) atomicMax(&edges, l + 1);
  __syncthreads();
  const int Lb = edges, E = 3 * Lb, Tb = Lb * nd;
  for (int i = tid; i < E; i += kThreads) {
    raw[i] = best[i] = raw0[i];
    m[i] = v[i] = 0.0f;
  }
  float gx = 0.0f, gy = 0.0f, best_loss = __int_as_float(0x7f800000);  // +inf
  if (tid == 0) {
    const float* x = p.x0 + 4 * static_cast<size_t>(b);
    states[0] = make_float4(x[0], x[1], x[2], x[3]);
    gx = p.goal[2 * b];
    gy = p.goal[2 * b + 1];
  }
  // the time term: row_sum of the masked durations, by one warp
  auto time_term = [&] {
    for (int l = tid & 31; l < Lb; l += 32) tree[l] = ctrl[3 * l + 2];
    __syncwarp();
    const float total = Lb > 0 ? warp_row_sum(tree, Lb) : 0.0f;
    if ((tid & 31) == 0) time_cost = total;
  };
  __syncthreads();

  for (int it = 0; it <= p.iterations; ++it) {
    const bool last = it == p.iterations;  // the final loss of the last iterate
    // the sigmoid box: controls lo + (hi - lo) sigmoid(raw), masked
    // durations 0 (masked raw entries stay raw0); each edge's dt and
    // prepared controls
    for (int l = tid; l < Lb; l += kThreads) {
      for (int j = 0; j < 3; ++j) {
        const float y = sigmoid(raw[3 * l + j]);
        ys[3 * l + j] = y;
        ctrl[3 * l + j] = add(p.lo[j], mul(span(j), y));
      }
      if (!mask[l]) ctrl[3 * l + 2] = 0.0f;
      dts[l] = dvd(ctrl[3 * l + 2], ndf);
      aux[l] = sys.prepare(ctrl[3 * l], ctrl[3 * l + 1]);
    }
    __syncthreads();

    // the Euler chain, and the time term beside it on warp 3
    if constexpr (Staged<Sys>::value) {
      forward_staged(sys, states, trig, inc, Tc, aux, dts, Tb, nd, time_term);
    } else {
      if (tid == 0) forward_simple(sys, states, trig, aux, dts, Lb, nd);
      else if (tid >> 5 == 3) time_term();
      __syncthreads();
    }

    // each point's penalty and d penalty / d (x, y), R1's phase 2
    float acc[kTerms] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int t = tid; t < Tb; t += kThreads) {
      const float4 s = states[t + 1];
      const float w = mask[t / nd] ? 1.0f : 0.0f;
      const float2 g = score_point(p.w, obs, p.K, s.x, s.y, w, acc);
      gpos[t] = g.x;
      gpos[Tc + t] = g.y;
    }
    block_terms(partial, acc, Tb);

    // the loss and the best iterate on thread 0, then the reverse sweep
    float4 lam = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (tid == 0) {
      float2 dgoal;
      const float loss = add(mul(time_cost, p.time_weight),
                             penalty(p.w, acc, states[Tb], gx, gy, dgoal));
      better = loss < best_loss;  // last: keep the last iterate, else the best
      if (better) best_loss = loss;
      if (!last) p.losses[static_cast<size_t>(it) * gridDim.x + b] = loss;
      if (Tb > 0) {
        lam = make_float4(add(dgoal.x, gpos[Tb - 1]), add(dgoal.y, gpos[Tc + Tb - 1]),
                          0.0f, 0.0f);
        if (Staged<Sys>::value) adj[Tb - 1] = lam;
      }
    }
    if constexpr (Staged<Sys>::value) {
      __syncthreads();
      if (!last && Tb > 0)
        reverse_staged(sys, states, trig, gpos, adj, inc, Tc, aux, dts, grad, Lb, nd);
    } else {
      if (tid == 0 && !last && Tb > 0)
        reverse_simple(sys, states, trig, gpos, Tc, aux, dts, grad, Lb, nd, lam);
    }
    __syncthreads();
    if (last) break;

    // keep the iterate that scored better; d loss / d raw: the time term's
    // d/d dur, the box's (hi - lo), the sigmoid's (g (1 - y)) y, 0 where
    // masked; its squares for the norm
    const bool keep_it = better;
    for (int i = tid; i < E; i += kThreads) {
      const int j = i % 3;
      if (keep_it) best[i] = raw[i];
      float g = 0.0f;
      if (mask[i / 3]) {
        const float gc = j == 2 ? add(grad[i], p.time_weight) : grad[i];
        g = mul(mul(mul(gc, span(j)), sub(1.0f, ys[i])), ys[i]);
      }
      grad[i] = g;
      tree[i] = mul(g, g);
    }
    __syncthreads();
    // the clip by the problem's gradient norm: min(1, clip / sqrt(|g|^2 + 1e-12))
    if (tid < 32) {
      const float total = E > 0 ? warp_row_sum(tree, E) : 0.0f;
      if (tid == 0) {
        const float q = dvd(p.clip_norm, __fsqrt_rn(add(total, 1e-12f)));
        scale = q != q ? q : fminf(1.0f, q);  // torch.minimum keeps a NaN
      }
    }
    __syncthreads();
    // Adam; masked entries keep raw0 (their gradient is 0)
    const float b1 = p.bias1[it], b2 = p.bias2[it], c = scale;
    for (int i = tid; i < E; i += kThreads) {
      if (!mask[i / 3]) continue;
      const float g = mul(grad[i], c);
      const float mi = add(mul(0.9f, m[i]), mul(0.1f, g));
      const float vi = add(mul(0.999f, v[i]), mul(mul(0.001f, g), g));
      m[i] = mi;
      v[i] = vi;
      const float mhat = dvd(mi, b1), vhat = dvd(vi, b2);
      raw[i] = sub(raw[i], dvd(mul(p.learning_rate, mhat), add(__fsqrt_rn(vhat), 1e-8f)));
    }
    __syncthreads();
  }

  // the refined controls: the last iterate where its loss beat the best,
  // else the best, through the box; masked and trimmed entries controls0
  const float* chosen = better ? raw : best;
  const float* c0 = p.controls0 + static_cast<size_t>(b) * L * 3;
  float* out = p.refined + static_cast<size_t>(b) * L * 3;
  for (int i = tid; i < 3 * L; i += kThreads) {
    const int l = i / 3, j = i - 3 * l;
    out[i] = l < Lb && mask[l] ? add(p.lo[j], mul(span(j), sigmoid(chosen[i]))) : c0[i];
  }
}

template <class Sys>
int launch(const Sys& sys, const Params& p, int B, cudaStream_t stream) {
  refine_kernel<Sys><<<B, kThreads, 0, stream>>>(sys, p);
  return static_cast<int>(cudaGetLastError());
}

// The working set's bytes a problem and the dynamic shared memory a block
// of the shared-memory instantiation may take on this device
template <class Sys>
int adam_workspace(int L, int num_disc, long long* bytes, int* shared_limit) {
  *bytes = static_cast<long long>(layout(L, num_disc, sizeof(typename Sys::Aux)).bytes);
  int device, optin;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaFuncAttributes a;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, refine_adam_kernel<Sys, true>);
  if (e != cudaSuccess) return static_cast<int>(e);
  *shared_limit = optin - static_cast<int>(a.sharedSizeBytes);
  return 0;
}

template <class Sys>
int launch_adam(const Sys& sys, const AdamParams& p, int B, int shared,
                cudaStream_t stream) {
  if (shared) {
    const size_t bytes = layout(p.L, p.num_disc, sizeof(typename Sys::Aux)).bytes;
    const cudaError_t e = cudaFuncSetAttribute(
        refine_adam_kernel<Sys, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    refine_adam_kernel<Sys, true><<<B, kThreads, bytes, stream>>>(sys, p);
  } else {
    refine_adam_kernel<Sys, false><<<B, kThreads, 0, stream>>>(sys, p);
  }
  return static_cast<int>(cudaGetLastError());
}

#ifdef CUDASBMP_USER_SYSTEM
// R1 and the whole refinement for a user struct where it has back(), else
// cudaErrorNotSupported (templates, so the kernels are instantiated only
// for a struct with the hook)
template <class S>
int launch_user(float param, const Params& p, int B, cudaStream_t stream) {
  if constexpr (HasBack<S>::value)
    return launch(make_user<S>(param, 0), p, B, stream);
  else
    return static_cast<int>(cudaErrorNotSupported);
}
template <class S>
int adam_workspace_user(int L, int num_disc, long long* bytes, int* shared_limit) {
  if constexpr (HasBack<S>::value)
    return adam_workspace<S>(L, num_disc, bytes, shared_limit);
  else
    return static_cast<int>(cudaErrorNotSupported);
}
template <class S>
int launch_adam_user(float param, const AdamParams& p, int B, int shared,
                     cudaStream_t stream) {
  if constexpr (HasBack<S>::value)
    return launch_adam(make_user<S>(param, 0), p, B, shared, stream);
  else
    return static_cast<int>(cudaErrorNotSupported);
}
#endif

}  // namespace

// Plain C entry point for ctypes. Device pointers of contiguous tensors:
// x0 f32 [B, 4], controls f32 [B, L, 3] (masked durations 0), wts f32
// [B, L], goal f32 [B, 2], obstacles f32 [K, 4] (per_problem 0) or
// [B, K, 4] (per_problem 1); scratch states f32 [B, L*num_disc + 1, 4] and
// gpos f32 [B, L*num_disc, 2]; outputs loss f32 [B] and grad f32 [B, L, 3].
// `system` is a SystemId (kUser, and only it, in a user library), `param`
// the bicycle's wheelbase or a user struct's float. Launches one
// block a problem on `stream` without synchronising and returns 0 or a
// cudaError_t.
extern "C" int cudasbmp_refine(int device, int system, float param,
                               const void* x0, const void* controls,
                               const void* wts, const void* goal,
                               const void* obstacles, int K, int per_problem,
                               void* states, void* gpos, void* loss, void* grad,
                               int B, int L, int num_disc, float margin,
                               float xhi, float yhi, float goal_radius,
                               float collision_weight, float goal_weight,
                               void* stream) {
  if (B < 0 || L < 1 || K < 0 || num_disc < 1 || (per_problem & ~1) ||
      static_cast<long long>(L) * num_disc > INT_MAX - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Params p{static_cast<const float*>(x0), static_cast<const float*>(controls),
                 static_cast<const float*>(wts), static_cast<const float*>(goal),
                 static_cast<const float*>(obstacles),
                 per_problem ? 4 * static_cast<size_t>(K) : 0, K, L, num_disc,
                 {margin, xhi, yhi, goal_radius, collision_weight, goal_weight},
                 static_cast<float4*>(states), static_cast<float2*>(gpos),
                 static_cast<float*>(loss), static_cast<float*>(grad)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#ifdef CUDASBMP_USER_SYSTEM
  if (system != kUser) return static_cast<int>(cudaErrorInvalidValue);
  return launch_user<UserSystem>(param, p, B, s);
#else
  switch (system) {
    case kBicycle: return launch(Bicycle{param}, p, B, s);
    case kPoint2D: return launch(Point2D{}, p, B, s);
    case kDoubleIntegrator: return launch(DoubleIntegrator{}, p, B, s);
    case kUnicycle: return launch(Unicycle{}, p, B, s);
    case kDubins: return launch(Dubins{}, p, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#endif
}

// The whole refinement's working set: into *bytes (int64) the bytes one
// problem of L edges x num_disc steps needs, into *shared_limit (int) the
// dynamic shared memory a block may take; 0 or a cudaError_t.
extern "C" int cudasbmp_refine_adam_workspace(int device, int system, int L,
                                              int num_disc, void* bytes,
                                              void* shared_limit) {
  if (L < 1 || num_disc < 1 || static_cast<long long>(L) * num_disc > INT_MAX - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  long long* n = static_cast<long long*>(bytes);
  int* limit = static_cast<int*>(shared_limit);
#ifdef CUDASBMP_USER_SYSTEM
  if (system != kUser) return static_cast<int>(cudaErrorInvalidValue);
  return adam_workspace_user<UserSystem>(L, num_disc, n, limit);
#else
  switch (system) {
    case kBicycle: return adam_workspace<Bicycle>(L, num_disc, n, limit);
    case kPoint2D: return adam_workspace<Point2D>(L, num_disc, n, limit);
    case kDoubleIntegrator: return adam_workspace<DoubleIntegrator>(L, num_disc, n, limit);
    case kUnicycle: return adam_workspace<Unicycle>(L, num_disc, n, limit);
    case kDubins: return adam_workspace<Dubins>(L, num_disc, n, limit);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#endif
}

// The whole refinement, refine_adam_kernel, for B problems. Device pointers
// of contiguous tensors: x0 f32 [B, 4], raw0 and controls0 f32 [B, L, 3],
// mask bool [B, L], goal f32 [B, 2], obstacles as cudasbmp_refine's, bias1
// and bias2 f32 [iterations]; scratch [B, workspace] bytes where `shared`
// is 0 (the working set in global memory), else unused (the working set in
// `workspace` bytes of dynamic shared memory a block); outputs losses f32
// [iterations, B] and refined f32 [B, L, 3]. lo*, hi* the control box;
// the rest as cudasbmp_refine's and RefineConfig's. Launches one block a
// problem on `stream` without synchronising and returns 0 or a cudaError_t.
extern "C" int cudasbmp_refine_adam(int device, int system, float param,
                                    const void* x0, const void* raw0,
                                    const void* controls0, const void* mask,
                                    const void* goal, const void* obstacles, int K,
                                    int per_problem, const void* bias1,
                                    const void* bias2, float lo0, float lo1,
                                    float lo2, float hi0, float hi1, float hi2,
                                    void* scratch, long long workspace, int shared,
                                    void* losses, void* refined, int B, int L,
                                    int num_disc, int iterations, float margin,
                                    float xhi, float yhi, float goal_radius,
                                    float collision_weight, float goal_weight,
                                    float time_weight, float learning_rate,
                                    float clip_norm, void* stream) {
  if (B < 0 || L < 1 || K < 0 || num_disc < 1 || iterations < 0 ||
      (per_problem & ~1) || (shared & ~1) || workspace < 0 ||
      static_cast<long long>(L) * num_disc > INT_MAX - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const AdamParams p{static_cast<const float*>(x0), static_cast<const float*>(raw0),
                     static_cast<const float*>(controls0),
                     static_cast<const unsigned char*>(mask),
                     static_cast<const float*>(goal), static_cast<const float*>(obstacles),
                     per_problem ? 4 * static_cast<size_t>(K) : 0,
                     static_cast<const float*>(bias1), static_cast<const float*>(bias2),
                     {lo0, lo1, lo2}, {hi0, hi1, hi2}, K, L, num_disc, iterations,
                     {margin, xhi, yhi, goal_radius, collision_weight, goal_weight},
                     time_weight, learning_rate, clip_norm,
                     static_cast<unsigned char*>(scratch), static_cast<size_t>(workspace),
                     static_cast<float*>(losses), static_cast<float*>(refined)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#ifdef CUDASBMP_USER_SYSTEM
  if (system != kUser) return static_cast<int>(cudaErrorInvalidValue);
  return launch_adam_user<UserSystem>(param, p, B, shared, s);
#else
  switch (system) {
    case kBicycle: return launch_adam(Bicycle{param}, p, B, shared, s);
    case kPoint2D: return launch_adam(Point2D{}, p, B, shared, s);
    case kDoubleIntegrator: return launch_adam(DoubleIntegrator{}, p, B, shared, s);
    case kUnicycle: return launch_adam(Unicycle{}, p, B, shared, s);
    case kDubins: return launch_adam(Dubins{}, p, B, shared, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#endif
}

#ifdef CUDASBMP_USER_SYSTEM
// 1 where the user library's struct has R1's adjoint hook back(), else 0
// (cudasbmp_refine then refuses it with cudaErrorNotSupported).
extern "C" int cudasbmp_user_has_back() { return HasBack<UserSystem>::value; }
#endif
