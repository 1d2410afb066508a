// MAXMARG's fused per-turn margin scan, written by hand for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/support_margin.py
// (maxmarg_turn_scan_batched, body _maxmarg_turn_kernel with _rank_rows).
// For every instance and its refit proposal (w, b) it returns integers
// only:
//   sup_rank (N,)   the (margin, index) rank of the max_support tightest
//                   fit-set rows inside the active-margin band
//                   mK <= max(min mK, 1e-12) * (1 + rtol), sentinel N
//                   elsewhere;
//   err_k (k,)      per node, the rows the proposal misclassifies
//                   (predict +1 iff dec > 0; label-0 rows never count);
//   viol_rank (k,n) per node, the (margin, index) rank of the viol_ship
//                   most-violated valid rows, sentinel n elsewhere.
//
// Rounding.  Every margin is y * (((x0*w0) + (x1*w1) + ...) + b) left to
// right over d, each operation rounded (__fmul_rn/__fadd_rn; the library
// is also built with --fmad=false), and 1 + rtol comes in rounded to f32
// once, as the plain PyTorch version forms them.  So the integers agree
// with it exactly.
//
// Bound on this card.  Each row of K and X is read once (4d bytes of point,
// 4 of label) for about 2d + 4 operations, and each rank written once, so
// bytes bound it: (B, N, d) + (B, k, n, d) f32 in, (B, N) + (B, k, n) i32
// labels in and ranks out.
//
// Design.  The TPU kernel ranks through an (N, N) compare matrix held in
// VMEM.  Here one block owns one instance: threads stride over the rows,
// form each margin once into a scratch row of device memory (the block's
// own, read back after __syncthreads) and initialise the ranks to the
// sentinel; a block min gives the band edge; then r rounds of a block
// argmin under (key, index) order over the members not yet ranked each
// rank one row.  With r = max_support <= 8 and viol_ship = 2 that is
// O(rN) work, not O(N^2), and it gives the same integers as the JAX
// package's ref._topr_ranks.  Error counts are a block sum of integers.

#include <cuda_runtime.h>
#include <climits>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct KeyIdx {
  float key;
  int idx;
};

// (key, index) order; idx == INT_MAX marks "no candidate"
__device__ __forceinline__ bool before(const KeyIdx& a, const KeyIdx& b) {
  return a.key < b.key || (a.key == b.key && a.idx < b.idx);
}

__device__ __forceinline__ float dec_of(const float* __restrict__ x,
                                        const float* w, int d, float b) {
  float dec = __fmul_rn(x[0], w[0]);
  for (int i = 1; i < d; ++i) dec = __fadd_rn(dec, __fmul_rn(x[i], w[i]));
  return __fadd_rn(dec, b);
}

// Block-wide (key, index) argmin, the same result on every thread.
__device__ KeyIdx block_argmin(KeyIdx v, KeyIdx* red) {
  for (int off = 16; off > 0; off >>= 1) {
    KeyIdx o;
    o.key = __shfl_xor_sync(0xffffffffu, v.key, off);
    o.idx = __shfl_xor_sync(0xffffffffu, v.idx, off);
    if (before(o, v)) v = o;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  KeyIdx best = red[0];
  for (int k = 1; k < kWarps; ++k)
    if (before(red[k], best)) best = red[k];
  __syncthreads();                    // red is reused by the next call
  return best;
}

__device__ float block_min(float v, KeyIdx* red) {
  KeyIdx ki = {v, 0};
  return block_argmin(ki, red).key;
}

__device__ int block_sum(int v, int* red) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int total = 0;
  for (int k = 0; k < kWarps; ++k) total += red[k];
  __syncthreads();
  return total;
}

// Rank the r smallest members (member[i] && key finite) of key[0..len)
// under (key, index) order into rank[], whose entries start at the
// sentinel len; a row is a candidate while its rank is still len.
template <typename Member>
__device__ void rank_smallest(const float* key, int* rank, int len, int r,
                              Member member, KeyIdx* red) {
  for (int t = 0; t < r; ++t) {
    KeyIdx best = {INFINITY, INT_MAX};
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const KeyIdx c = {key[i], i};
      if (rank[i] == len && member(i) && c.key < INFINITY && before(c, best))
        best = c;
    }
    best = block_argmin(best, red);
    if (best.idx == INT_MAX) return;  // fewer than r members
    if (threadIdx.x == 0) rank[best.idx] = t;
    __syncthreads();
  }
}

__global__ void maxmarg_turn(const float* __restrict__ w,
                             const float* __restrict__ b,
                             const float* __restrict__ K,
                             const int* __restrict__ yK,
                             const float* __restrict__ X,
                             const int* __restrict__ y,
                             int* __restrict__ sup_rank,
                             int* __restrict__ err_k,
                             int* __restrict__ viol_rank,
                             float* __restrict__ scratch, int N, int k, int n,
                             int d, float band_scale, int max_support,
                             int viol_ship) {
  extern __shared__ float w_s[];      // (d,)
  __shared__ KeyIdx red[kWarps];
  __shared__ int ired[kWarps];

  const int inst = blockIdx.x;
  for (int i = threadIdx.x; i < d; i += kThreads) w_s[i] = w[inst * d + i];
  __syncthreads();
  const float bb = b[inst];

  // fit-set margins, band edge and support ranks
  const float* Ki = K + static_cast<size_t>(inst) * N * d;
  const int* yKi = yK + static_cast<size_t>(inst) * N;
  float* mK = scratch + static_cast<size_t>(inst) * (N + k * n);
  int* sup = sup_rank + static_cast<size_t>(inst) * N;
  float lmin = INFINITY;
  for (int i = threadIdx.x; i < N; i += kThreads) {
    const float m = __fmul_rn(static_cast<float>(yKi[i]),
                              dec_of(Ki + static_cast<size_t>(i) * d, w_s, d,
                                     bb));
    mK[i] = m;
    sup[i] = N;
    if (yKi[i] != 0) lmin = fminf(lmin, m);
  }
  const float mmin = fmaxf(block_min(lmin, red), 1e-12f);
  const float thr = __fmul_rn(mmin, band_scale);
  rank_smallest(mK, sup, N, max_support,
                [&](int i) { return yKi[i] != 0 && mK[i] <= thr; }, red);

  // per node: error counts and most-violated ranks
  for (int j = 0; j < k; ++j) {
    const size_t row0 = (static_cast<size_t>(inst) * k + j) * n;
    const float* Xj = X + row0 * d;
    const int* yj = y + row0;
    float* mj = mK + N + static_cast<size_t>(j) * n;
    int* vj = viol_rank + row0;
    int errs = 0;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float dec = dec_of(Xj + static_cast<size_t>(i) * d, w_s, d, bb);
      const int lab = yj[i];
      const int pred = dec > 0.f ? 1 : -1;
      errs += (lab != 0 && pred != lab) ? 1 : 0;
      mj[i] = __fmul_rn(static_cast<float>(lab), dec);
      vj[i] = n;
    }
    const int total = block_sum(errs, ired);
    if (threadIdx.x == 0) err_k[static_cast<size_t>(inst) * k + j] = total;
    rank_smallest(mj, vj, n, viol_ship, [&](int i) { return yj[i] != 0; },
                  red);
  }
}

}  // namespace

extern "C" int maxmarg_turn_launch(const void* w, const void* b,
                                   const void* K, const void* yK,
                                   const void* X, const void* y,
                                   void* sup_rank, void* err_k,
                                   void* viol_rank, void* scratch, int B,
                                   int N, int k, int n, int d,
                                   float band_scale, int max_support,
                                   int viol_ship, void* stream) {
  // w in dynamic shared memory; the wrapper keeps d <= 4096 (16 KB)
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  maxmarg_turn<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<const float*>(K), static_cast<const int*>(yK),
      static_cast<const float*>(X), static_cast<const int*>(y),
      static_cast<int*>(sup_rank), static_cast<int*>(err_k),
      static_cast<int*>(viol_rank), static_cast<float*>(scratch), N, k, n, d,
      band_scale, max_support, viol_ship);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* maxmarg_turn_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
