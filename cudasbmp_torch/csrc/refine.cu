// Value and gradient of trajectory refinement's penalty for Hopper (sm_90a),
// kernel R1, generic over the package's five dynamical systems and, in a
// library of its own (CUDASBMP_USER_SYSTEM), over a user's system's device
// struct that has the adjoint hook back().
//
// R1 replaces no TPU kernel: it computes what jitted XLA computes in
// jax.value_and_grad of cudasbmp_tpu/refine.py::_loss (refine.py:77-107,
// 122) for the penalty part of the objective,
//
//   collision_weight * (collision + oob) + goal_weight * goal_pen,
//
// and its gradient with respect to the controls (the time term, the sigmoid
// box and the masks stay torch ops around it: cudasbmp_torch/refine.py).
// Its plain twin is ops/refine_cuda.py::refine_penalty_torch under autograd.
//
// What bounds it: one problem is a dependent chain of T = L * num_disc Euler
// steps forward and as many reverse steps back (T reaches some 1,500 at the
// quality pipeline's paths), against a few kilobytes of inputs, so neither
// bytes nor the card's operation rate bound it: the latency of the two
// serial chains does. The design keeps the chain on one thread and gives
// the block's other threads the work that is not a chain:
//
// - one block a problem (B = 1 for the CLI's path, 128 for the pipeline),
//   kThreads threads;
// - phase 1: thread 0 runs the Euler chain of all T steps and stores the
//   T + 1 states in global scratch (24 KB a problem at T = 1,500, resident
//   in L2; the wrapper sizes it, so no T is cut);
// - phase 2: all threads score the points, point t on thread t mod
//   kThreads: the penalty of each point over the K boxes and the four
//   bounds, and d penalty / d (x, y) of the point into scratch; each thread
//   sums its points in order, then a tree over the block in shared memory
//   (a fixed order, no float atomics);
// - phase 3: thread 0 adds the goal term on the last point and runs the
//   reverse sweep: the state adjoint goes back through each step's Jacobian
//   (Sys::back, one device function a system beside its step) and each
//   edge's two controls and dt collect their gradients; d/d dur is d/d dt
//   over num_disc.
//
// Floating point: the forward chain rounds as the systems' step does, every
// add, subtract, multiply and divide an explicit round-to-nearest intrinsic
// (never contracted into an FMA), dt = dur / num_disc a true division and
// the trig the accurate CUDA math-library functions (the heading's cosine
// and sine from one sincosf, which rounds as cosf and sinf apart), so the
// states equal the twin's to the bit on the card. The penalty and the
// gradient sum in another order than autograd: they agree within rounding.
// Kinks follow JAX's (and torch's) conventions: max gives each side half
// the gradient at a tie, relu'(0) = 0.

#include <climits>
#include <cuda_runtime.h>
#ifdef CUDASBMP_USER_SYSTEM
#include <type_traits>
#endif

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
// and returns the adjoint of s.

struct Grad { float c0, c1, dt; };

struct Bicycle {  // (x, y, theta, v); controls (a, steering)
  float L;
  struct Aux { float a, tan_s; };
  __device__ Aux prepare(float a, float steering) const {
    return {a, tanf(steering)};
  }
  __device__ float4 step(float4 s, Aux q, float dt) const {
    const float2 cs = cos_sin(s.z);
    return make_float4(add(s.x, mul(mul(s.w, cs.x), dt)),
                       add(s.y, mul(mul(s.w, cs.y), dt)),
                       add(s.z, mul(mul(dvd(s.w, L), q.tan_s), dt)),
                       add(s.w, mul(q.a, dt)));
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
    // d tan(s) / ds = 1 + tan(s)^2, as JAX's tan rule
    g.c1 = add(g.c1, mul(mul(g_turn, vl), add(1.0f, mul(q.tan_s, q.tan_s))));
    const float g_th = sub(mul(mul(g_vs, s.w), cs.x), mul(mul(g_vc, s.w), cs.y));
    const float g_v = add(add(mul(g_vc, cs.x), mul(g_vs, cs.y)),
                          dvd(mul(g_turn, q.tan_s), L));
    return make_float4(lam.x, lam.y, add(lam.z, g_th), add(lam.w, g_v));
  }
};

struct Point2D {  // (x, y, 0, 0); controls (vx, vy)
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
  struct Aux { float v, turn; };
  __device__ Aux prepare(float v, float turn) const { return {v, turn}; }
  __device__ float rate(Aux q) const { return kCurvature ? mul(q.v, q.turn) : q.turn; }
  __device__ float4 step(float4 s, Aux q, float dt) const {
    const float2 cs = cos_sin(s.z);
    return make_float4(add(s.x, mul(mul(q.v, cs.x), dt)),
                       add(s.y, mul(mul(q.v, cs.y), dt)),
                       add(s.z, mul(rate(q), dt)), 0.0f);
  }
  __device__ float4 back(float4 s, Aux q, float dt, float4 lam, Grad& g) const {
    const float2 cs = cos_sin(s.z);
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

// System ids of the C entry point (ops/rollout_cuda.py::SYSTEM_IDS; kUser,
// USER_SYSTEM_ID, in a user library only)
enum SystemId { kBicycle = 0, kPoint2D = 1, kDoubleIntegrator = 2,
                kUnicycle = 3, kDubins = 4, kUser = 5 };

struct Params {
  const float* x0;         // [B, 4]
  const float* controls;   // [B, L, 3], masked durations 0
  const float* wts;        // [B, L], a weight per edge
  const float* goal;       // [B, 2]
  const float* obstacles;  // [K, 4] or [B, K, 4]
  size_t obstacle_stride;  // floats from one problem's boxes to the next: 4*K or 0
  int K, L, num_disc;
  float margin, xhi, yhi;  // bounds penalised below margin and above xhi, yhi
  float goal_radius;       // 0.8 * goal_threshold
  float collision_weight, goal_weight;
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
    const float px = s.x, py = s.y, w = wts[t / nd];
    const float w2 = mul(w, 2.0f);
    float gx = 0.0f, gy = 0.0f;
    for (int k = 0; k < p.K; ++k) {
      const float* o = obs + 4 * k;
      const float dxa = sub(sub(o[0], p.margin), px), dxb = sub(sub(px, o[2]), p.margin);
      const float dya = sub(sub(o[1], p.margin), py), dyb = sub(sub(py, o[3]), p.margin);
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
    const float zx0 = sub(p.margin, px), zx1 = sub(px, p.xhi);
    const float zy0 = sub(p.margin, py), zy1 = sub(py, p.yhi);
    acc[1] = add(acc[1], mul(mul(relu(zx0), relu(zx0)), w));
    acc[2] = add(acc[2], mul(mul(relu(zx1), relu(zx1)), w));
    acc[3] = add(acc[3], mul(mul(relu(zy0), relu(zy0)), w));
    acc[4] = add(acc[4], mul(mul(relu(zy1), relu(zy1)), w));
    gx = add(gx, sub(mul(w2, relu(zx1)), mul(w2, relu(zx0))));
    gy = add(gy, sub(mul(w2, relu(zy1)), mul(w2, relu(zy0))));
    gpos[t] = make_float2(mul(p.collision_weight, gx), mul(p.collision_weight, gy));
  }
  for (int i = 0; i < kTerms; ++i) partial[i][threadIdx.x] = acc[i];
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half)
      for (int i = 0; i < kTerms; ++i)
        partial[i][threadIdx.x] = add(partial[i][threadIdx.x],
                                      partial[i][threadIdx.x + half]);
    __syncthreads();
  }

  // phase 3: the goal term and the reverse sweep
  if (threadIdx.x != 0) return;
  const float4 end = states[T];
  const float ex = sub(end.x, p.goal[2 * b]), ey = sub(end.y, p.goal[2 * b + 1]);
  const float root = __fsqrt_rn(add(add(mul(ex, ex), mul(ey, ey)), 1e-9f));
  const float reach = relu(sub(root, p.goal_radius));
  const float oob = add(add(add(partial[1][0], partial[2][0]), partial[3][0]),
                        partial[4][0]);
  p.loss[b] = add(mul(p.collision_weight, add(partial[0][0], oob)),
                  mul(p.goal_weight, mul(reach, reach)));
  // d goal_pen: 2 reach (relu'), d sqrt = 0.5 / root, d |e|^2 = 2 e
  const float g_sq = dvd(mul(mul(p.goal_weight, mul(2.0f, reach)), 0.5f), root);
  float4 lam = make_float4(add(mul(g_sq, mul(2.0f, ex)), gpos[T - 1].x),
                           add(mul(g_sq, mul(2.0f, ey)), gpos[T - 1].y), 0.0f, 0.0f);
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

template <class Sys>
int launch(const Sys& sys, const Params& p, int B, cudaStream_t stream) {
  refine_kernel<Sys><<<B, kThreads, 0, stream>>>(sys, p);
  return static_cast<int>(cudaGetLastError());
}

#ifdef CUDASBMP_USER_SYSTEM
// R1 for a user struct where it has back(), else cudaErrorNotSupported (a
// template, so the kernel is instantiated only for a struct with the hook)
template <class S>
int launch_user(float param, const Params& p, int B, cudaStream_t stream) {
  if constexpr (HasBack<S>::value)
    return launch(make_user<S>(param, 0), p, B, stream);
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
                 margin, xhi, yhi, goal_radius, collision_weight, goal_weight,
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

#ifdef CUDASBMP_USER_SYSTEM
// 1 where the user library's struct has R1's adjoint hook back(), else 0
// (cudasbmp_refine then refuses it with cudaErrorNotSupported).
extern "C" int cudasbmp_user_has_back() { return HasBack<UserSystem>::value; }
#endif
