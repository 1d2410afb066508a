// MEDIAN's per-turn weighted-median cut scan, hand-written for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/median_cut.py
// (median_cut_scores_batched, body _median_cut_kernel).  For every instance b
// and every allowed direction i of the shared grid V it scores
//     min(#live points whose whole at-risk arc lies at rows <= i,
//         #live points whose whole at-risk arc lies at rows  > i)
// and -1 at disallowed directions.  A positive point is at risk at row j iff
// v_j.x > lo_r[j], a negative one iff v_j.x < hi_r[j], where the bounds are
// folded with the nonempty mask exactly as the JAX engine's inline path does
// (src/repro/engine/median.py, step, stage 2).
//
// Rounding.  The projection is (v0*x0) + (v1*x1) with one rounding per
// operation, written with __fmul_rn/__fadd_rn, which nvcc never contracts
// into an FMA (the library is also built with --fmad=false).  The strict
// risk test compares a shipped point's projection with a band edge built
// from that same point's projection at append time, so any other rounding
// flips ties.
//
// Bound on this card.  B*n*m risk tests of 3 f32 operations each (two
// multiplies and an add, plus the compare) over ~80 MB of inputs: at the
// smoke sweep's full-batch shape (B=3072, n=1000, m=1024) the operations,
// not the bytes, bound it.  Design: the TPU kernel streams n-tiles through
// VMEM accumulators in grid order; blocks on Hopper run in no order, so the
// scan is the same histogram formulation as the inline path, split in two
// kernels:
//   1. cut_hist: a grid of (point tile, instance) blocks.  Each block stages
//      the instance's grid and folded bounds in shared memory (24 bytes per
//      direction), each thread takes one point and walks the m directions
//      with the exact projection, recording its first and last risk row;
//      the block histograms those rows with shared-memory atomics and adds
//      the nonzero bins into a global (B, 2, m) int32 buffer.  Integer
//      atomics make the result exact and independent of block order.
//   2. cut_score: one block per instance prefix-scans the two histograms:
//      below = cumsum(hist_last), above = live - cumsum(hist_first).
// Every thread of a warp reads the same direction in a step, so the shared
// loads are broadcasts; the label is selected per thread without branching.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kHistThreads = 256;
constexpr int kScoreThreads = 1024;

__global__ void cut_hist(const float2* __restrict__ V,          // (m,)
                         const unsigned char* __restrict__ dir_ok,  // (B, m)
                         const float* __restrict__ lo,          // (B, m)
                         const float* __restrict__ hi,          // (B, m)
                         const float2* __restrict__ X,          // (B, n)
                         const int* __restrict__ y,             // (B, n)
                         int* __restrict__ hist,                // (B, 2, m)
                         int m, int n) {
  extern __shared__ float2 smem[];
  float2* sV = smem;                  // (m,) directions
  float2* sB = smem + m;              // (m,) folded (lo_r, hi_r)
  int* h_first = reinterpret_cast<int*>(smem + 2 * m);
  int* h_last = h_first + m;

  const int b = blockIdx.y;
  const size_t row = static_cast<size_t>(b) * m;
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    sV[j] = V[j];
    const float l = lo[row + j];
    const float h = hi[row + j];
    const bool nonempty = (l < h) && dir_ok[row + j];
    sB[j] = make_float2(nonempty ? l : INFINITY, nonempty ? h : -INFINITY);
    h_first[j] = 0;
    h_last[j] = 0;
  }
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lab = i < n ? y[static_cast<size_t>(b) * n + i] : 0;
  if (lab != 0) {
    const float2 x = X[static_cast<size_t>(b) * n + i];
    const bool pos = lab == 1;
    int first = m;
    int last = -1;
#pragma unroll 4
    for (int j = 0; j < m; ++j) {
      const float2 v = sV[j];
      const float2 bd = sB[j];
      const float p = __fadd_rn(__fmul_rn(v.x, x.x), __fmul_rn(v.y, x.y));
      const bool risk = pos ? (p > bd.x) : (p < bd.y);
      first = (risk && first == m) ? j : first;
      last = risk ? j : last;
    }
    if (last >= 0) {
      atomicAdd(&h_first[first], 1);
      atomicAdd(&h_last[last], 1);
    }
  }
  __syncthreads();

  int* g = hist + static_cast<size_t>(b) * 2 * m;
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    if (h_first[j]) atomicAdd(&g[j], h_first[j]);
    if (h_last[j]) atomicAdd(&g[m + j], h_last[j]);
  }
}

// Inclusive block-wide scan of one int per thread (Hillis-Steele in shared
// memory); blockDim.x must be kScoreThreads.
__device__ int block_inclusive_scan(int v, int* buf) {
  buf[threadIdx.x] = v;
  __syncthreads();
  for (int off = 1; off < kScoreThreads; off <<= 1) {
    const int add = threadIdx.x >= off ? buf[threadIdx.x - off] : 0;
    __syncthreads();
    buf[threadIdx.x] += add;
    __syncthreads();
  }
  return buf[threadIdx.x];
}

__global__ void cut_score(const int* __restrict__ hist,             // (B, 2, m)
                          const unsigned char* __restrict__ dir_ok,  // (B, m)
                          int* __restrict__ score,                  // (B, m)
                          int m) {
  __shared__ int buf_first[kScoreThreads];
  __shared__ int buf_last[kScoreThreads];
  const int b = blockIdx.x;
  const int* hf = hist + static_cast<size_t>(b) * 2 * m;
  const int* hl = hf + m;
  const int chunk = (m + kScoreThreads - 1) / kScoreThreads;
  const int j0 = min(m, threadIdx.x * chunk);
  const int j1 = min(m, j0 + chunk);

  int sum_first = 0, sum_last = 0;
  for (int j = j0; j < j1; ++j) {
    sum_first += hf[j];
    sum_last += hl[j];
  }
  const int inc_first = block_inclusive_scan(sum_first, buf_first);
  const int inc_last = block_inclusive_scan(sum_last, buf_last);
  const int live = buf_last[kScoreThreads - 1];   // every live point once

  int run_first = inc_first - sum_first;          // exclusive offsets
  int run_last = inc_last - sum_last;
  const size_t row = static_cast<size_t>(b) * m;
  for (int j = j0; j < j1; ++j) {
    run_first += hf[j];
    run_last += hl[j];
    const int below = run_last;
    const int above = live - run_first;
    score[row + j] = dir_ok[row + j] ? min(below, above) : -1;
  }
}

}  // namespace

extern "C" int median_cut_launch(const void* V, const void* dir_ok,
                                 const void* lo, const void* hi,
                                 const void* X, const void* y, void* hist,
                                 void* score, int B, int m, int n,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(m) * (2 * sizeof(float2) +
                                                2 * sizeof(int));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cut_hist, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((n + kHistThreads - 1) / kHistThreads, B);
  cut_hist<<<grid, kHistThreads, smem, s>>>(
      static_cast<const float2*>(V), static_cast<const unsigned char*>(dir_ok),
      static_cast<const float*>(lo), static_cast<const float*>(hi),
      static_cast<const float2*>(X), static_cast<const int*>(y),
      static_cast<int*>(hist), m, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  cut_score<<<B, kScoreThreads, 0, s>>>(
      static_cast<const int*>(hist), static_cast<const unsigned char*>(dir_ok),
      static_cast<int*>(score), m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* median_cut_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
