// Calibration chains for Hopper (sm_90a): the card's dependent FMA rate,
// its accurate cos/sin/tan rate and its shared-memory gather rate, against
// which the rollout kernels' roofline shares are read
// (cudasbmp_torch/probes/roofline.py).
//
// Replaces the TPU probes of tools/roofline.py and tools/r3_probe1.py:
//   P1a _alu_kernel under _chain_call (roofline.py:57-76): y <- y*m + x,
//       `chain` times, m = x0*1e-9 + 0.999931 with x0 the first element of
//       the element's program (256 x 128 elements on the TPU);
//   P1b _trans_kernel(op) (roofline.py:79-86): y <- op(y) + eps with
//       op in {cos, sin, tan} and eps = x0*1e-12 per program;
//   P2  _gather_kernel (r3_probe1.py:97-108): y <- y + tbl[(idx + i) % rows,
//       lane] for i < chain, from y = 0, with tbl [rows, 128].
//
// What bounds them on this card: operations, by design. P1a is one thread per
// element; at 2048 x 128 elements (one wave of about 1,986 threads per SM,
// some 15 warps per scheduler) the dependent chain's 4-cycle FFMA latency
// should be hidden and P1a run at the FFMA issue rate: one __fmaf_rn per
// link, which nvcc neither splits nor reorders. On an H100 at 700 W it ran
// at 47% of that rate, rolled or unrolled by 16 alike; why is not measured.
// P1b calls the accurate cosf, sinf and tanf (no fast math, as the rollout
// kernels build), so its rate is the math library's, not the SFU's: a cos
// link is 32 SASS instructions on its fast path (the Cody-Waite reduction
// with its F2I and I2FP, the polynomial, the guard of the Payne-Hanek path
// that inputs in [0.5, 1) never take, the add and the loop), so the
// instruction issue of 4 warps a clock an SM bounds it, and it ran at some
// 89% of that (PERF.md). Its registers (18 to 29) never limited it: 8
// blocks of 256 threads an SM, the thread limit. What the design does:
// each thread carries kTransElems elements whose chains interleave, so two
// links share one loop test and the scheduler finds independent work in
// each thread; a grid of at most the card's resident blocks walks the
// elements with a grid stride. kTransElems = 2 won over 1 (one element a
// thread, 1,024 blocks) for cos, sin and tan and over 4 for cos and tan
// (PERF.md). P2 keeps a slice of 32 table columns (all
// rows of them: 128 KB at 1,024 rows, below a block's 227 KB) in shared
// memory, one column per thread of a warp, so the 32 threads of a warp read
// 32 distinct banks whatever rows they gather: conflict-free by
// construction. Each thread carries 8 independent chains (8 rows of idx) so
// shared-memory latency overlaps; (idx + i) % rows becomes one wrap-around
// increment per link after one floor modulo, the same integers.
// The program of P1 is a runtime size (`program` elements): the element's
// m and eps come from its program's first element, never from blockIdx.
//
// sincos_kernel is no TPU kernel's port: it checks the rollout kernels'
// heading trig (csrc/rollout.cu::cos_sin, one sincosf for the pair) against
// the separate cosf and sinf that PyTorch's cos and sin, and so the plain
// twins, call (ops/chains_cuda.py::sincos_differences, every float).

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStaticSmemLimit = 48 * 1024;
constexpr int kLanes = 128;       // P2: table and idx width
constexpr int kSliceLanes = 32;   // P2: table columns one block holds
constexpr int kRowsY = 8;         // P2: threadIdx.y extent
constexpr int kRowsPerThread = 8; // P2: independent chains per thread
constexpr int kRowsPerBlock = kRowsY * kRowsPerThread;

// P1b: the elements a thread carries at once (see trans_chain_kernel)
constexpr int kTransElems = 2;

enum TransOp { kCos = 0, kSin = 1, kTan = 2 };

__global__ void __launch_bounds__(kThreads)
    alu_chain_kernel(const float* __restrict__ x, float* __restrict__ y,
                     int n, int program, int chain) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const float xe = x[e];
  const float m = __fadd_rn(__fmul_rn(x[e - e % program], 1e-9f), 0.999931f);
  float v = xe;
  for (int i = 0; i < chain; ++i) v = __fmaf_rn(v, m, xe);
  y[e] = v;
}

template <int kOp>
__device__ __forceinline__ float trans(float v) {
  if constexpr (kOp == kCos) return cosf(v);
  else if constexpr (kOp == kSin) return sinf(v);
  else return tanf(v);
}

// P1b on a grid of at most the card's resident blocks (the wrapper's
// trans_plan: SMs x cudaOccupancyMaxActiveBlocksPerMultiprocessor, fewer
// where n needs fewer), walking the elements with a grid stride. Thread t
// of T = gridDim.x * kThreads carries kTransElems elements a round, e0 + k
// * T for k < kTransElems with e0 = t + round * T * kTransElems, their
// chains interleaved link by link: each element's chain is the same
// sequence of operations as one thread an element gives it, and the
// scheduler has kTransElems independent chains in every thread. A slot past
// n repeats e0's chain and stores nothing.
// tests/test_torch_chains.py::trans_elements is this walk in Python.
template <int kOp>
__global__ void __launch_bounds__(kThreads)
    trans_chain_kernel(const float* __restrict__ x, float* __restrict__ y,
                       int n, int program, int chain) {
  const int stride = gridDim.x * kThreads;
  for (int e0 = blockIdx.x * kThreads + threadIdx.x; e0 < n;
       e0 += stride * kTransElems) {
    float v[kTransElems], eps[kTransElems];
#pragma unroll
    for (int k = 0; k < kTransElems; ++k) {
      const int e = e0 + k * stride < n ? e0 + k * stride : e0;
      eps[k] = __fmul_rn(x[e - e % program], 1e-12f);
      v[k] = x[e];
    }
    for (int i = 0; i < chain; ++i) {
#pragma unroll
      for (int k = 0; k < kTransElems; ++k)
        v[k] = __fadd_rn(trans<kOp>(v[k]), eps[k]);
    }
#pragma unroll
    for (int k = 0; k < kTransElems; ++k)
      if (e0 + k * stride < n) y[e0 + k * stride] = v[k];
  }
}

// grid (kLanes / kSliceLanes, ceil(n_rows / kRowsPerBlock)), block
// (kSliceLanes, kRowsY); thread (tx, ty) of block (bx, by) runs lane
// bx*32 + tx of rows by*64 + ty + 8k, k < 8.
__global__ void __launch_bounds__(kThreads)
    gather_chain_kernel(const float* __restrict__ tbl, int rows,
                        const int* __restrict__ idx, float* __restrict__ y,
                        int n_rows, int chain) {
  extern __shared__ float slice[];  // [rows][kSliceLanes]
  const int lane0 = blockIdx.x * kSliceLanes;
  const int t = threadIdx.y * kSliceLanes + threadIdx.x;
  for (int j = t; j < rows * kSliceLanes; j += kThreads)
    slice[j] = tbl[(j / kSliceLanes) * kLanes + lane0 + j % kSliceLanes];
  __syncthreads();
  const int lane = lane0 + threadIdx.x;
  const int row0 = blockIdx.y * kRowsPerBlock + threadIdx.y;
  int j[kRowsPerThread];
  float acc[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int r = row0 + k * kRowsY;
    const int v = r < n_rows ? idx[r * kLanes + lane] % rows : 0;
    j[k] = v < 0 ? v + rows : v;  // floor modulo, as Python's and torch's %
    acc[k] = 0.0f;
  }
  for (int i = 0; i < chain; ++i) {
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      acc[k] = __fadd_rn(acc[k], slice[j[k] * kSliceLanes + threadIdx.x]);
      j[k] = j[k] + 1 == rows ? 0 : j[k] + 1;
    }
  }
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int r = row0 + k * kRowsY;
    if (r < n_rows) y[r * kLanes + lane] = acc[k];
  }
}

__global__ void __launch_bounds__(kThreads)
    sincos_kernel(const float* __restrict__ x, float* __restrict__ s,
                  float* __restrict__ c, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n) sincosf(x[e], s + e, c + e);
}

using TransKernel = void (*)(const float*, float*, int, int, int);

TransKernel trans_kernel(int op) {
  return op == kCos   ? trans_chain_kernel<kCos>
         : op == kSin ? trans_chain_kernel<kSin>
                      : trans_chain_kernel<kTan>;
}

int start(int device) { return static_cast<int>(cudaSetDevice(device)); }

}  // namespace

// Plain C entry points for ctypes: device pointers of contiguous f32
// tensors x, y of n elements (P1, `program` elements a program) or tbl f32
// [rows, 128], idx int32 [n_rows, 128], y f32 [n_rows, 128] (P2). Each
// launches on `stream` without synchronising and returns 0 or a
// cudaError_t.

extern "C" int cudasbmp_sincos(int device, const void* x, void* s, void* c,
                               int n, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (const int err = start(device)) return err;
  if (n == 0) return 0;
  sincos_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(s),
      static_cast<float*>(c), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cudasbmp_alu_chain(int device, const void* x, void* y, int n,
                                  int program, int chain, void* stream) {
  if (n < 0 || program < 1 || n % program || chain < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (const int err = start(device)) return err;
  if (n == 0) return 0;
  alu_chain_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n, program, chain);
  return static_cast<int>(cudaGetLastError());
}

// P1b's launch geometry: its block size, the elements a thread carries and
// the blocks of op's kernel one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); the wrapper plans the
// grid from them (ops/chains_cuda.py::trans_plan). 0 or a cudaError_t.
extern "C" int cudasbmp_trans_geometry(int device, int op, int* threads,
                                       int* elems, int* blocks_per_sm) {
  if (op < kCos || op > kTan) return static_cast<int>(cudaErrorInvalidValue);
  if (const int err = start(device)) return err;
  *threads = kThreads;
  *elems = kTransElems;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, trans_kernel(op), kThreads, 0));
}

extern "C" int cudasbmp_trans_chain(int device, int op, const void* x,
                                    void* y, int n, int program, int chain,
                                    int grid, void* stream) {
  if (n < 0 || program < 1 || n % program || chain < 0 || op < kCos ||
      op > kTan || grid < 1 ||
      n > INT_MAX - static_cast<long long>(grid) * kThreads * kTransElems)
    return static_cast<int>(cudaErrorInvalidValue);
  if (const int err = start(device)) return err;
  if (n == 0) return 0;
  trans_kernel(op)<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n, program, chain);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cudasbmp_gather_chain(int device, const void* tbl, int rows,
                                     const void* idx, void* y, int n_rows,
                                     int chain, void* stream) {
  if (rows < 1 || n_rows < 0 || chain < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (const int err = start(device)) return err;
  const size_t smem = sizeof(float) * kSliceLanes * static_cast<size_t>(rows);
  if (smem > kStaticSmemLimit) {
    const cudaError_t e = cudaFuncSetAttribute(
        gather_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();  // leave no error for a later launch
      return static_cast<int>(e);
    }
  }
  if (n_rows == 0) return 0;
  const dim3 grid(kLanes / kSliceLanes,
                  (n_rows + kRowsPerBlock - 1) / kRowsPerBlock);
  gather_chain_kernel<<<grid, dim3(kSliceLanes, kRowsY), smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tbl), rows, static_cast<const int*>(idx),
      static_cast<float*>(y), n_rows, chain);
  return static_cast<int>(cudaGetLastError());
}
