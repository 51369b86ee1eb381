// Threefry-2x32 (20 rounds) on the card: every threefry draw of
// cudasbmp_torch/rng.py on a CUDA key, one launch a draw
// (ops/threefry_cuda.py). It replaces no TPU kernel: JAX's jax.random
// threefry is an XLA fusion on the TPU, and the port's torch twin
// (rng.py::threefry2x32 and its callers) ran it as some 170 int64
// elementwise launches a hash, five hashes a planner wave.
//
// Modes, each the bits of its rng.py twin:
//   0 fold_in:     out[b] = hash(key[b]; 0, data[b])
//   1 split:       out[b, i] = hash(key[b]; 0, offset + i), i < n
//   2 random_bits: out[b, i] = x0 ^ x1 of hash(key[b]; c >> 32, c mod 2^32),
//                  c = offset + i
//   3 uniform:     random_bits' word >> 9 | 0x3F800000 as f32, minus 1,
//                  then max(lo, u * (hi - lo) + lo) (`clamp`, jax.random.
//                  uniform) or lo + u * (hi - lo) (ControlSpec.sample),
//                  each operation rounded on its own (__fsub_rn, __fmul_rn,
//                  __fadd_rn: never an FMA), as the torch ops round it
//   4 wave_keys:   k = fold_in(key[b], data0[b]), then fold_in(k, data1[b])
//                  where data1[b] > 0 (`folds` 2), then split(k, 2),
//                  written as two arrays [2][batch][2], so a planner's
//                  control and acceptance keys are each contiguous
// Keys are int64 pairs holding uint32 words, read at key_row and
// key_word strides. Every operand (the keys over the batch, data over the
// batch, lo and hi over the output) is read at (index / div) % mod: a
// broadcast operand has mod 1, a per-problem one the batch's size; the
// wrapper makes any other broadcast contiguous first.
//
// What bounds it on an H100: the function needs some 87 instructions a
// control (a hash is 20 rounds of an add, a funnel shift and a xor, and
// the key schedule's injections, 73; then the counter, the mantissa and
// the scaling; probes/roofline.py::threefry_bound_ms), at 4
// warp-instructions a clock an SM, and its bytes (4 an output) less:
// issue-bound, 64 x 4,096 x 3 controls in 2.0 us at 1.98 GHz. This kernel
// issues 259 instructions an output: the operands' (index / div) % mod
// reads cost some 7 integer divisions, two thirds of its body, which is
// why it runs those controls in 9.7 us. At the demo's 4,096 x 3 the
// launch itself (1.5-2 us on the card, some 30-60 us of the host's Python)
// is the whole cost. The design: one thread an output (wave_keys: an output
// pair, so the two folds are hashed once), a grid stride past 2^20 blocks,
// 32-bit index arithmetic: a draw of 2^31 outputs or more is refused (the
// planners' largest, 64 x 4,096 x 3, is 786,432).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

enum Mode : int { kFoldIn = 0, kSplit = 1, kBits = 2, kUniform = 3, kWaveKeys = 4 };

// An int operand: `ptr` (int64 where `wide`, else int32) read at
// (index / div) % mod, or, where ptr is null, `value`.
struct IntArg {
  const void* ptr;
  long long value, div, mod;
  int wide;
};

// A float operand: `ptr` read at (index / div) % mod, or `value`.
struct FloatArg {
  const float* ptr;
  float value;
  long long div, mod;
};

struct Args {
  const long long* keys;
  long long key_row, key_word, key_div, key_mod;
  IntArg data[2];
  int folds;
  FloatArg lo, hi;
  int clamp;
  long long n, offset, total;
  void* out;
};

__host__ __device__ constexpr int rotation(int i, int j) {
  return i % 2 == 0 ? (j == 0 ? 13 : j == 1 ? 15 : j == 2 ? 26 : 6)
                    : (j == 0 ? 17 : j == 1 ? 29 : j == 2 ? 16 : 24);
}

__device__ __forceinline__ uint2 threefry(uint32_t k0, uint32_t k1, uint32_t x0,
                                          uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, rotation(i, j)) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return make_uint2(x0, x1);
}

__device__ __forceinline__ uint32_t at(uint32_t index, long long div, long long mod) {
  return index / static_cast<uint32_t>(div) % static_cast<uint32_t>(mod);
}

__device__ __forceinline__ long long read(const IntArg& a, uint32_t index) {
  if (!a.ptr) return a.value;
  const uint32_t i = at(index, a.div, a.mod);
  return a.wide ? static_cast<const long long*>(a.ptr)[i]
                : static_cast<long long>(static_cast<const int*>(a.ptr)[i]);
}

__device__ __forceinline__ float read(const FloatArg& a, uint32_t index) {
  return a.ptr ? a.ptr[at(index, a.div, a.mod)] : a.value;
}

__device__ __forceinline__ uint2 key_of(const Args& a, uint32_t b) {
  const long long* k = a.keys + static_cast<long long>(at(b, a.key_div, a.key_mod)) * a.key_row;
  return make_uint2(static_cast<uint32_t>(k[0]), static_cast<uint32_t>(k[a.key_word]));
}

__device__ __forceinline__ uint2 fold(uint2 k, long long data) {
  return threefry(k.x, k.y, 0u, static_cast<uint32_t>(data));
}

__device__ __forceinline__ void put_key(long long* out, long long i, uint2 h) {
  out[2 * i] = static_cast<long long>(h.x);
  out[2 * i + 1] = static_cast<long long>(h.y);
}

// torch.maximum's rule on the card: NaN from either side, else the larger
__device__ __forceinline__ float maximum(float a, float b) {
  return a != a ? a : b != b ? b : fmaxf(a, b);
}

// e + stride stays below 2^31 + 2^28: no index wraps
template <int kMode>
__global__ void __launch_bounds__(kThreads) threefry_kernel(const Args a) {
  const uint32_t total = static_cast<uint32_t>(a.total);
  const uint32_t stride = gridDim.x * kThreads;
  for (uint32_t e = blockIdx.x * kThreads + threadIdx.x; e < total; e += stride) {
    if constexpr (kMode == kFoldIn) {
      put_key(static_cast<long long*>(a.out), e, fold(key_of(a, e), read(a.data[0], e)));
    } else if constexpr (kMode == kSplit) {
      const uint32_t b = e / static_cast<uint32_t>(a.n);
      const long long c = a.offset + static_cast<long long>(e - b * static_cast<uint32_t>(a.n));
      const uint2 k = key_of(a, b);
      put_key(static_cast<long long*>(a.out), e, threefry(k.x, k.y, 0u, static_cast<uint32_t>(c)));
    } else if constexpr (kMode == kWaveKeys) {
      uint2 k = fold(key_of(a, e), read(a.data[0], e));
      if (a.folds == 2) {
        const long long w = read(a.data[1], e);
        if (w > 0) k = fold(k, w);
      }
      long long* out = static_cast<long long*>(a.out);
      put_key(out, e, threefry(k.x, k.y, 0u, 0u));
      put_key(out, static_cast<long long>(e) + a.total, threefry(k.x, k.y, 0u, 1u));
    } else {
      const uint32_t b = e / static_cast<uint32_t>(a.n);
      const long long c = a.offset + static_cast<long long>(e - b * static_cast<uint32_t>(a.n));
      const uint2 k = key_of(a, b);
      const uint2 h = threefry(k.x, k.y, static_cast<uint32_t>(c >> 32), static_cast<uint32_t>(c));
      const uint32_t bits = h.x ^ h.y;
      if constexpr (kMode == kBits) {
        static_cast<long long*>(a.out)[e] = static_cast<long long>(bits);
      } else {
        const float u = __fsub_rn(__uint_as_float(bits >> 9 | 0x3F800000u), 1.0f);
        const float lo = read(a.lo, e), hi = read(a.hi, e);
        const float scaled = __fmul_rn(u, __fsub_rn(hi, lo));
        static_cast<float*>(a.out)[e] = a.clamp ? maximum(lo, __fadd_rn(scaled, lo))
                                                : __fadd_rn(lo, scaled);
      }
    }
  }
}

template <int kMode>
int launch(const Args& a, cudaStream_t stream) {
  const long long blocks = (a.total + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
  threefry_kernel<kMode><<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool bad(long long div, long long mod) {
  return div < 1 || mod < 1 || div > INT_MAX || mod > INT_MAX;
}

}  // namespace

// Plain C entry point for ctypes: one launch of `mode` (0-4 above) over
// `total` outputs (wave_keys: output pairs) into `out` (int64 pairs for
// the key modes, int64 for random_bits, f32 for uniform), on `stream`
// without synchronising. Returns 0 or a cudaError_t: cudaErrorInvalidValue
// for a bad mode or operand map, or for `total` of 2^31 or more.
extern "C" int cudasbmp_threefry(
    int device, int mode, const void* keys, long long key_row, long long key_word,
    long long key_div, long long key_mod, const void* data0, long long value0,
    long long div0, long long mod0, int wide0, const void* data1, long long value1,
    long long div1, long long mod1, int wide1, int folds, const void* lo,
    float lo_value, long long lo_div, long long lo_mod, const void* hi, float hi_value,
    long long hi_div, long long hi_mod, int clamp, long long n, long long offset,
    long long total, void* out, void* stream) {
  if (mode < kFoldIn || mode > kWaveKeys || total < 0 || total > INT_MAX || n < 1 ||
      n > INT_MAX || bad(key_div, key_mod) ||
      bad(div0, mod0) || bad(div1, mod1) || bad(lo_div, lo_mod) || bad(hi_div, hi_mod) ||
      folds < 1 || folds > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (const cudaError_t err = cudaSetDevice(device)) return static_cast<int>(err);
  if (total == 0) return 0;
  const Args a{static_cast<const long long*>(keys),
               key_row,
               key_word,
               key_div,
               key_mod,
               {{data0, value0, div0, mod0, wide0}, {data1, value1, div1, mod1, wide1}},
               folds,
               {static_cast<const float*>(lo), lo_value, lo_div, lo_mod},
               {static_cast<const float*>(hi), hi_value, hi_div, hi_mod},
               clamp,
               n,
               offset,
               total,
               out};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kFoldIn: return launch<kFoldIn>(a, s);
    case kSplit: return launch<kSplit>(a, s);
    case kBits: return launch<kBits>(a, s);
    case kUniform: return launch<kUniform>(a, s);
    default: return launch<kWaveKeys>(a, s);
  }
}
