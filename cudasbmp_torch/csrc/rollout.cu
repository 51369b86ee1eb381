// Fused propagate-and-check rollout kernels for the kinematic bicycle, for
// Hopper (sm_90a).
//
// Replaces cudasbmp_tpu/ops/rollout_pallas.py::rollout_pallas (kernel B1,
// rollout_kernel) and ::sample_and_rollout_pallas (kernel B2,
// sample_and_rollout_kernel). Both integrate num_disc explicit-Euler steps
// of the bicycle and test every step against the workspace bounds and the
// step's swept AABB against every obstacle; a rollout freezes at the
// candidate state of its first failing step (the reference's break).
//
// What bounds it on this card: transcendental throughput, not bytes. A
// 10-step rollout reads 28 B (a float4 state and three controls) and writes
// 20 B (a float4 state and a valid byte), but computes 2 trig functions per
// step and one tan per rollout, through the accurate (non-intrinsic) cosf,
// sinf and tanf. The design therefore keeps the whole step loop in
// registers, one thread per rollout, with the obstacle set (K <= 32 boxes)
// in shared memory, so device memory is touched once on the way in and
// once on the way out.
//
// Floating point: every add, multiply and divide of the step is an explicit
// round-to-nearest intrinsic (__fadd_rn, __fmul_rn, __fdiv_rn), which nvcc
// never contracts into an FMA. nvcc would otherwise fuse x + v*c*dt into one
// FMA, rounding once where the plain PyTorch version (one kernel per
// operator) rounds twice. The build keeps nvcc's default --fmad=true and no
// --use_fast_math, so cosf/sinf/tanf are the accurate CUDA math-library
// functions compiled as PyTorch's own cos/sin/tan kernels are. The op order
// is the plain version's:
//   dt = dur / num_disc (true division); tan_s = tanf(steering), unscaled;
//   x += (v*cos(th))*dt; y += (v*sin(th))*dt; th += ((v/L)*tan_s)*dt;
//   v += a*dt.
// B2 draws its controls from Philox-4x32-10 (Random123): key = the two
// words of the wave's threefry control key, counter = (lane, 0, 0, 0),
// word j -> u = (bits >> 8) * 2^-24 -> lo_j + u * (hi_j - lo_j).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxObstacles = 32;
constexpr int kThreads = 256;

__device__ __forceinline__ bool integrate(float& x, float& y, float& th,
                                          float& v, float a, float steering,
                                          float dur, const float* obs, int K,
                                          int num_disc, float width,
                                          float height, float L) {
  const float dt = __fdiv_rn(dur, static_cast<float>(num_disc));
  const float tan_s = tanf(steering);
  bool alive = true;
  for (int k = 0; k < num_disc; ++k) {
    const float nx = __fadd_rn(x, __fmul_rn(__fmul_rn(v, cosf(th)), dt));
    const float ny = __fadd_rn(y, __fmul_rn(__fmul_rn(v, sinf(th)), dt));
    const float nth =
        __fadd_rn(th, __fmul_rn(__fmul_rn(__fdiv_rn(v, L), tan_s), dt));
    const float nv = __fadd_rn(v, __fmul_rn(a, dt));
    // exclusive workspace bounds
    bool clear = (nx > 0.0f) & (nx < width) & (ny > 0.0f) & (ny < height);
    const float bminx = fminf(x, nx), bmaxx = fmaxf(x, nx);
    const float bminy = fminf(y, ny), bmaxy = fmaxf(y, ny);
    for (int o = 0; o < K; ++o) {
      const float* b = obs + 4 * o;
      // separated on some axis; degenerate padding boxes always are
      clear &= (bmaxx <= b[0]) | (b[2] <= bminx) | (bmaxy <= b[1]) |
               (b[3] <= bminy);
    }
    if (alive) {
      x = nx;
      y = ny;
      th = nth;
      v = nv;
    }
    alive &= clear;
  }
  return alive;
}

__device__ __forceinline__ void load_obstacles(float* obs,
                                               const float* obstacles, int K) {
  for (int j = threadIdx.x; j < 4 * K; j += blockDim.x) obs[j] = obstacles[j];
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    rollout_kernel(const float4* __restrict__ x0,
                   const float* __restrict__ controls,
                   const float* __restrict__ obstacles, int K,
                   float4* __restrict__ x1, uint8_t* __restrict__ valid, int B,
                   int num_disc, float width, float height, float L) {
  __shared__ float obs[4 * kMaxObstacles];
  load_obstacles(obs, obstacles, K);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  float4 s = x0[i];
  const float* c = controls + 3 * i;
  const bool alive = integrate(s.x, s.y, s.z, s.w, c[0], c[1], c[2], obs, K,
                               num_disc, width, height, L);
  x1[i] = s;
  valid[i] = alive;
}

__device__ __forceinline__ uint32_t mulhilo(uint32_t a, uint32_t b,
                                            uint32_t* hi) {
  const uint64_t p = static_cast<uint64_t>(a) * b;
  *hi = static_cast<uint32_t>(p >> 32);
  return static_cast<uint32_t>(p);
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
  return __fadd_rn(lo, __fmul_rn(u, __fsub_rn(hi, lo)));
}

__global__ void __launch_bounds__(kThreads)
    sample_and_rollout_kernel(const int64_t* __restrict__ key,
                              const float4* __restrict__ x0,
                              const float* __restrict__ obstacles, int K,
                              float4* __restrict__ x1,
                              float* __restrict__ controls,
                              uint8_t* __restrict__ valid, int B, int num_disc,
                              float width, float height, float L, float lo0,
                              float lo1, float lo2, float hi0, float hi1,
                              float hi2) {
  __shared__ float obs[4 * kMaxObstacles];
  load_obstacles(obs, obstacles, K);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const uint4 bits =
      philox4x32_10(make_uint4(static_cast<uint32_t>(i), 0u, 0u, 0u),
                    static_cast<uint32_t>(key[0]),
                    static_cast<uint32_t>(key[1]));
  const float a = draw(bits.x, lo0, hi0);
  const float steering = draw(bits.y, lo1, hi1);
  const float dur = draw(bits.z, lo2, hi2);
  float* c = controls + 3 * i;
  c[0] = a;
  c[1] = steering;
  c[2] = dur;
  float4 s = x0[i];
  const bool alive = integrate(s.x, s.y, s.z, s.w, a, steering, dur, obs, K,
                               num_disc, width, height, L);
  x1[i] = s;
  valid[i] = alive;
}

int check_args(int device, int B, int K, int num_disc) {
  if (B < 0 || K < 0 || K > kMaxObstacles || num_disc < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaSetDevice(device));
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers of
// contiguous tensors: x0/x1 f32 [B, 4], controls f32 [B, 3], obstacles f32
// [K, 4], valid bool [B], key int64 [2]. Each launches on `stream` without
// synchronising and returns cudaGetLastError() (0 on success).

extern "C" int cudasbmp_rollout(int device, const void* x0,
                                const void* controls, const void* obstacles,
                                int K, void* x1, void* valid, int B,
                                int num_disc, float width, float height,
                                float L, void* stream) {
  const int err = check_args(device, B, K, num_disc);
  if (err) return err;
  if (B == 0) return 0;
  rollout_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x0), static_cast<const float*>(controls),
      static_cast<const float*>(obstacles), K, static_cast<float4*>(x1),
      static_cast<uint8_t*>(valid), B, num_disc, width, height, L);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cudasbmp_sample_and_rollout(
    int device, const void* key, const void* x0, const void* obstacles, int K,
    void* x1, void* controls, void* valid, int B, int num_disc, float width,
    float height, float L, float lo0, float lo1, float lo2, float hi0,
    float hi1, float hi2, void* stream) {
  const int err = check_args(device, B, K, num_disc);
  if (err) return err;
  if (B == 0) return 0;
  sample_and_rollout_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(key), static_cast<const float4*>(x0),
      static_cast<const float*>(obstacles), K, static_cast<float4*>(x1),
      static_cast<float*>(controls), static_cast<uint8_t*>(valid), B,
      num_disc, width, height, L, lo0, lo1, lo2, hi0, hi1, hi2);
  return static_cast<int>(cudaGetLastError());
}
