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
// What bounds them on this card, and what the designs do about it.
// P1a is bound by FFMA issue: one __fmaf_rn a link, which nvcc neither
// splits nor reorders, at 4 warp-instructions a clock an SM. One thread an
// element (1,024 blocks, one dependent chain a thread) ran at 47% of that
// rate on an H100 at 700 W, rolled or unrolled by 16 alike, at a held
// 1,980 MHz clock: each FFMA read its three sources (v, m, x) from the
// register file, two of them in one bank, and such an FFMA issues at half
// rate (PERF.md: k elements a thread with an m register each stayed at
// 0.20-0.28 ms; sharing m, 0.140). The design: each thread carries
// kAluElems elements of one tile of contiguous elements, their chains
// interleaved link by link in a loop unrolled by kAluUnroll (the
// remainder after it); where they lie in one program they share one m
// register, which nvcc marks for the operand reuse cache, so each FFMA
// reads two registers from the file and ptxas places those two in
// different banks. A grid of at most the card's resident blocks walks the
// tiles with a grid stride (ops/chains_cuda.py::chain_plan). Every element
// gets exactly one thread-an-element's sequence of __fmaf_rn, so the
// output is the same bits. kAluElems = 4 (0.140 ms, 96% of its issue
// limit) won over 2 (0.205: every other FFMA still reads three registers)
// and 8 (0.142: 40 registers, 6 blocks an SM).
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
// (PERF.md).
// P2 is bound by the shared-memory load rate: one 4-byte load a link, 128
// bytes a clock an SM, one warp-wide load. A block keeps a slice of 32
// table columns (all rows of them, and the first kGatherUnroll - 1 rows
// again after the last) in shared memory, one column per thread of a
// warp, so the 32 threads of a warp read 32 distinct banks whatever rows
// they gather: conflict-free by construction. The slice arrives by
// Hopper's bulk copy, one 128-byte row a copy, completing on an mbarrier,
// while the threads load their indices. A chain then reads kGatherUnroll
// consecutive rows from one shared address at fixed offsets (the repeated
// rows make a wrap inside them unnecessary) and wraps once a step: 2.8
// instructions a link in all, so the loads bind (a wrap a link took 7.2,
// and then the instructions bound the loop). Blocks of kGatherWarps warps carry kGatherChains
// chains a thread (at most kGatherRowsPerBlock rows of idx a block), and
// the wrapper splits the rows evenly over enough blocks to fill the card
// (ops/chains_cuda.py::gather_plan), so every SM gets work; a warp runs
// only the chains its block's rows fill. kGatherChains = 2 ran as fast
// as 4 at 1,024 table rows and 2-3% faster at 8 and 128 (PERF.md). Each
// chain adds in the order i = 0, 1, ..., as the plain twin does, to the
// bit.
// The program of P1 is a runtime size (`program` elements): the element's
// m and eps come from its program's first element, never from blockIdx.
//
// sincos_kernel is no TPU kernel's port: it checks the rollout kernels'
// heading trig (csrc/rollout.cu::cos_sin, one sincosf for the pair) against
// the separate cosf and sinf that PyTorch's cos and sin, and so the plain
// twins, call (ops/chains_cuda.py::sincos_differences, every float).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // P1a, P1b, sincos
constexpr int kLanes = 128;       // P2: table and idx width
constexpr int kSliceLanes = 32;   // P2: table columns one block holds
constexpr int kSlices = kLanes / kSliceLanes;

// P1a: the elements a thread carries at once, and the links of one step of
// its unrolled loop (see alu_chain_kernel)
constexpr int kAluElems = 4;
constexpr int kAluUnroll = 8;
// P1b: the elements a thread carries at once (see trans_chain_kernel)
constexpr int kTransElems = 2;
// P2: the links a chain reads from consecutive rows in one step, the chains
// a thread carries, and the rows of idx a block holds at most
constexpr int kGatherUnroll = 8;
constexpr int kGatherChains = 2;
constexpr int kGatherRowsPerBlock = 64;
constexpr int kGatherWarps = kGatherRowsPerBlock / kGatherChains;
constexpr int kGatherThreads = kGatherWarps * kSliceLanes;
// P2's shared memory: the mbarrier (16 bytes, so the slice stays 16-byte
// aligned for the bulk copies), then [rows + kGatherUnroll - 1][32] floats
constexpr int kGatherHeader = 16;

enum ChainKernel { kCos = 0, kSin = 1, kTan = 2, kAlu = 3 };

// P1a's links of one thread's elements: kAluUnroll links of every element a
// step, then the remainder link by link, each element's chain the sequence
// of __fmaf_rn(v, m, x) that one thread an element gives it. With kShared
// the elements lie in one program and take m[0], one register, which
// nvcc marks for the operand reuse cache: each FFMA then reads two
// registers from the register file, not three.
template <bool kShared>
__device__ __forceinline__ void alu_links(float (&v)[kAluElems],
                                          const float (&m)[kAluElems],
                                          const float (&xe)[kAluElems], int chain) {
  int i = 0;
  for (; i + kAluUnroll <= chain; i += kAluUnroll) {
#pragma unroll
    for (int u = 0; u < kAluUnroll; ++u)
#pragma unroll
      for (int k = 0; k < kAluElems; ++k)
        v[k] = __fmaf_rn(v[k], kShared ? m[0] : m[k], xe[k]);
  }
#pragma unroll 1
  for (; i < chain; ++i) {
#pragma unroll
    for (int k = 0; k < kAluElems; ++k)
      v[k] = __fmaf_rn(v[k], kShared ? m[0] : m[k], xe[k]);
  }
}

// P1a on a grid of at most the card's resident blocks (chain_plan), each
// block walking tiles of kThreads * kAluElems contiguous elements with a
// grid stride: thread t of a tile at `base` carries base + t + k *
// kThreads for k < kAluElems, their chains interleaved link by link. A
// slot past n repeats the thread's first element and stores nothing.
// Where a thread's elements share a program (at the calibration's
// programs of 32,768 elements, always) they share its m register.
// tests/test_torch_chains.py::alu_elements is this walk in Python.
__global__ void __launch_bounds__(kThreads)
    alu_chain_kernel(const float* __restrict__ x, float* __restrict__ y,
                     int n, int program, int chain) {
  constexpr int kTile = kThreads * kAluElems;
  for (int base = blockIdx.x * kTile; base < n; base += gridDim.x * kTile) {
    const int e0 = base + threadIdx.x;
    if (e0 >= n) break;
    float v[kAluElems], m[kAluElems], xe[kAluElems];
    int last = e0;
#pragma unroll
    for (int k = 0; k < kAluElems; ++k) {
      const int e = e0 + k * kThreads < n ? e0 + k * kThreads : e0;
      last = e > last ? e : last;
      m[k] = __fadd_rn(__fmul_rn(x[e - e % program], 1e-9f), 0.999931f);
      xe[k] = x[e];
      v[k] = xe[k];
    }
    if (e0 / program == last / program) alu_links<true>(v, m, xe, chain);
    else alu_links<false>(v, m, xe, chain);
#pragma unroll
    for (int k = 0; k < kAluElems; ++k)
      if (e0 + k * kThreads < n) y[e0 + k * kThreads] = v[k];
  }
}

template <int kOp>
__device__ __forceinline__ float trans(float v) {
  if constexpr (kOp == kCos) return cosf(v);
  else if constexpr (kOp == kSin) return sinf(v);
  else return tanf(v);
}

// P1b on a grid of at most the card's resident blocks (the wrapper's
// chain_plan: SMs x cudaOccupancyMaxActiveBlocksPerMultiprocessor, fewer
// where n needs fewer), walking the elements with a grid stride. Thread t
// of T = gridDim.x * kThreads carries kTransElems elements a round, e0 + k
// * T for k < kTransElems with e0 = t + round * T * kTransElems, their
// chains interleaved link by link: each element's chain is the same
// sequence of operations as one thread an element gives it, and the
// scheduler has kTransElems independent chains in every thread. A slot past
// n repeats e0's chain and stores nothing.
// tests/test_torch_chains.py::chain_elements is this walk in Python.
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

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// P2's links for the first kActive chains of a thread: kGatherUnroll
// links of each a step, read at fixed offsets from the chain's slice
// offset `at` (in floats), which then moves on by `step` with one wrap at
// `wrap`; then the remainder, fewer than kGatherUnroll links.
template <int kActive>
__device__ __forceinline__ void gather_links(const float* slice,
                                             int (&at)[kGatherChains],
                                             float (&acc)[kGatherChains],
                                             int chain, int step, int wrap) {
  int i = 0;
  for (; i + kGatherUnroll <= chain; i += kGatherUnroll) {
#pragma unroll
    for (int u = 0; u < kGatherUnroll; ++u)
#pragma unroll
      for (int c = 0; c < kActive; ++c)
        acc[c] = __fadd_rn(acc[c], slice[at[c] + u * kSliceLanes]);
#pragma unroll
    for (int c = 0; c < kActive; ++c)
      at[c] = at[c] + step >= wrap ? at[c] + step - wrap : at[c] + step;
  }
#pragma unroll
  for (int u = 0; u < kGatherUnroll - 1; ++u)
    if (i + u < chain)
#pragma unroll
      for (int c = 0; c < kActive; ++c)
        acc[c] = __fadd_rn(acc[c], slice[at[c] + u * kSliceLanes]);
}

// gather_links for the warp's `active` chains (1 to kActive): a warp whose
// block holds fewer rows than its chain slots runs only the chains it has.
template <int kActive>
__device__ __forceinline__ void gather_active(int active, const float* slice,
                                              int (&at)[kGatherChains],
                                              float (&acc)[kGatherChains],
                                              int chain, int step, int wrap) {
  if constexpr (kActive > 1) {
    if (active < kActive) {
      gather_active<kActive - 1>(active, slice, at, acc, chain, step, wrap);
      return;
    }
  }
  gather_links<kActive>(slice, at, acc, chain, step, wrap);
}

// P2. Block b of the grid takes lane slice b % 4 (32 columns) and the rows
// [s * n_rows / blocks_y, (s + 1) * n_rows / blocks_y) of idx, s = b / 4;
// thread (tx, ty) runs lane 32 * (b % 4) + tx of the block's rows ty + c *
// kGatherWarps, c < kGatherChains, those below the block's end (the same
// count for a whole warp). Shared memory holds the mbarrier, then the
// slice: padded row p < rows + kGatherUnroll - 1 is table row p % rows,
// so a chain at row j < rows reads rows j .. j + kGatherUnroll - 1 without
// a wrap. tests/test_torch_chains.py models the rows, the index steps and
// the banks in Python.
__global__ void __launch_bounds__(kGatherThreads)
    gather_chain_kernel(const float* __restrict__ tbl, int rows,
                        const int* __restrict__ idx, float* __restrict__ y,
                        int n_rows, int chain, int blocks_y) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* slice = reinterpret_cast<float*>(smem + kGatherHeader);
  const uint32_t bar = shared_address(smem);
  const int lane0 = (blockIdx.x % kSlices) * kSliceLanes;
  const int t = threadIdx.y * kSliceLanes + threadIdx.x;
  const int padded = rows + kGatherUnroll - 1;
  if (t == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(bar), "r"(padded * kSliceLanes * 4) : "memory");
  }
  __syncthreads();
  for (int p = t; p < padded; p += kGatherThreads)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        ::"r"(shared_address(slice + p * kSliceLanes)),
        "l"(reinterpret_cast<uint64_t>(tbl + static_cast<size_t>(p % rows) * kLanes + lane0)),
        "r"(kSliceLanes * 4), "r"(bar) : "memory");
  // the chains' first rows while the slice is in flight
  const long long s = blockIdx.x / kSlices;
  const int lo = static_cast<int>(s * n_rows / blocks_y);
  const int hi = static_cast<int>((s + 1) * n_rows / blocks_y);
  const int lane = lane0 + threadIdx.x;
  const int left = hi - lo - static_cast<int>(threadIdx.y);
  const int active = left <= 0 ? 0
                     : left >= kGatherChains * kGatherWarps
                         ? kGatherChains
                         : (left + kGatherWarps - 1) / kGatherWarps;
  int at[kGatherChains];  // slice offset of the chain's next row, in floats
  float acc[kGatherChains];
#pragma unroll
  for (int c = 0; c < kGatherChains; ++c) {
    const int r = lo + threadIdx.y + c * kGatherWarps;
    const int v = r < hi ? idx[static_cast<size_t>(r) * kLanes + lane] % rows : 0;
    at[c] = (v < 0 ? v + rows : v) * kSliceLanes + threadIdx.x;  // floor modulo
    acc[c] = 0.0f;
  }
  asm volatile(
      "{\n .reg .pred P1;\n LAB_WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], 0;\n"
      " @!P1 bra LAB_WAIT;\n}" ::"r"(bar) : "memory");
  if (active == 0) return;
  gather_active<kGatherChains>(active, slice, at, acc, chain,
                               (kGatherUnroll % rows) * kSliceLanes,
                               rows * kSliceLanes);
#pragma unroll
  for (int c = 0; c < kGatherChains; ++c) {
    const int r = lo + threadIdx.y + c * kGatherWarps;
    if (r < hi) y[static_cast<size_t>(r) * kLanes + lane] = acc[c];
  }
}

size_t gather_smem(int rows) {
  return kGatherHeader +
         sizeof(float) * kSliceLanes * (static_cast<size_t>(rows) + kGatherUnroll - 1);
}

__global__ void __launch_bounds__(kThreads)
    sincos_kernel(const float* __restrict__ x, float* __restrict__ s,
                  float* __restrict__ c, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n) sincosf(x[e], s + e, c + e);
}

using ChainFn = void (*)(const float*, float*, int, int, int);

ChainFn chain_kernel(int kernel) {
  return kernel == kCos   ? trans_chain_kernel<kCos>
         : kernel == kSin ? trans_chain_kernel<kSin>
         : kernel == kTan ? trans_chain_kernel<kTan>
                          : alu_chain_kernel;
}

int start(int device) { return static_cast<int>(cudaSetDevice(device)); }

// Let gather_chain_kernel take all the shared memory a block may opt in
// to; the most rows its slice can then hold, through *max_rows.
int gather_prepare(int device, int* max_rows) {
  int optin = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gather_chain_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e != cudaSuccess) {
    cudaGetLastError();  // leave no error for a later launch
    return static_cast<int>(e);
  }
  *max_rows = static_cast<int>((optin - kGatherHeader) / (sizeof(float) * kSliceLanes)) -
              (kGatherUnroll - 1);
  return 0;
}

}  // namespace

// Plain C entry points for ctypes: device pointers of contiguous f32
// tensors x, y of n elements (P1, `program` elements a program) or tbl f32
// [rows, 128] (16-byte aligned), idx int32 [n_rows, 128], y f32 [n_rows,
// 128] (P2). Each launches on `stream` without synchronising and returns 0
// or a cudaError_t.

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

// P1's launch geometry: the block size, the elements a thread carries and
// the blocks of the kernel (0-2: P1b's cos, sin, tan; 3: P1a) one SM holds
// at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor); the wrapper
// plans the grid from them (ops/chains_cuda.py::chain_plan). 0 or a
// cudaError_t.
extern "C" int cudasbmp_chain_geometry(int device, int kernel, int* threads,
                                       int* elems, int* blocks_per_sm) {
  if (kernel < kCos || kernel > kAlu) return static_cast<int>(cudaErrorInvalidValue);
  if (const int err = start(device)) return err;
  *threads = kThreads;
  *elems = kernel == kAlu ? kAluElems : kTransElems;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, chain_kernel(kernel), kThreads, 0));
}

// P1a (kernel 3) or P1b (0-2) on `grid` blocks of kThreads.
extern "C" int cudasbmp_chain(int device, int kernel, const void* x, void* y,
                              int n, int program, int chain, int grid,
                              void* stream) {
  const int elems = kernel == kAlu ? kAluElems : kTransElems;
  if (n < 0 || program < 1 || n % program || chain < 0 || kernel < kCos ||
      kernel > kAlu || grid < 1 ||
      n > INT_MAX - static_cast<long long>(grid) * kThreads * elems)
    return static_cast<int>(cudaErrorInvalidValue);
  if (const int err = start(device)) return err;
  if (n == 0) return 0;
  chain_kernel(kernel)<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n, program, chain);
  return static_cast<int>(cudaGetLastError());
}

// P2's launch geometry at `rows` table rows: its threads a block, the rows
// of idx a block holds at most, the blocks one SM holds at once with the
// slice of `rows` rows (0 where it does not fit) and the most rows a slice
// can have. 0 or a cudaError_t.
extern "C" int cudasbmp_gather_geometry(int device, int rows, int* threads,
                                        int* rows_per_block, int* blocks_per_sm,
                                        int* max_rows) {
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (const int err = start(device)) return err;
  if (const int err = gather_prepare(device, max_rows)) return err;
  *threads = kGatherThreads;
  *rows_per_block = kGatherRowsPerBlock;
  *blocks_per_sm = 0;
  if (rows > *max_rows) return 0;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, gather_chain_kernel, kGatherThreads, gather_smem(rows)));
}

// P2 on 4 lane slices x `blocks_y` blocks of rows (ops/chains_cuda.py::
// gather_plan).
extern "C" int cudasbmp_gather_chain(int device, const void* tbl, int rows,
                                     const void* idx, void* y, int n_rows,
                                     int chain, int blocks_y, void* stream) {
  if (rows < 1 || n_rows < 0 || n_rows > INT_MAX / kLanes || chain < 0 ||
      blocks_y < 1 || blocks_y > INT_MAX / kSlices ||
      reinterpret_cast<uintptr_t>(tbl) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (const int err = start(device)) return err;
  int max_rows = 0;
  if (const int err = gather_prepare(device, &max_rows)) return err;
  if (rows > max_rows) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  gather_chain_kernel<<<kSlices * blocks_y, dim3(kSliceLanes, kGatherWarps),
                        gather_smem(rows), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tbl), rows, static_cast<const int*>(idx),
      static_cast<float*>(y), n_rows, chain, blocks_y);
  return static_cast<int>(cudaGetLastError());
}
