// MEDIAN's stage-5 per-node extremes scan, hand-written for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/support_margin.py
// (median_extremes_batched, body _median_extremes_kernel).  For every
// instance b and node j it returns the row of own ∪ fill-capped transcript
// with the largest projection on v_b among label +1 rows (first index on
// ties) and the row with the smallest projection among label -1 rows (first
// index on ties); 0 where the class is absent.  The caller recomputes the
// band edges from the chosen rows.
//
// Rounding.  The projection is (x0*v0) + (x1*v1) with one rounding per
// operation (__fmul_rn/__fadd_rn, never contracted; the library is also
// built with --fmad=false), as the JAX engine's inline path forms it.
//
// Bound on this card.  Each row is read once (8 bytes of point, 4 of label)
// for 3 f32 operations, so the bytes bound it: (B, k, nW, 2) f32 plus
// (B, k, nW) i32.  Design: one warp per (instance, node) row block; lanes
// stride over the rows so a warp's loads are contiguous 8- and 4-byte
// words, each lane keeps its running (max, first index) over +1 rows and
// (min, first index) over -1 rows, and the warp reduces with shuffles,
// ties going to the smaller index.  No shared memory, no atomics.

#include <cuda_runtime.h>
#include <climits>
#include <math.h>

namespace {

constexpr int kThreads = 256;   // 8 warps, one (instance, node) each

__device__ __forceinline__ void keep_max(float& best, int& idx, float ob,
                                         int oi) {
  if (ob > best || (ob == best && oi < idx)) {
    best = ob;
    idx = oi;
  }
}

__device__ __forceinline__ void keep_min(float& best, int& idx, float ob,
                                         int oi) {
  if (ob < best || (ob == best && oi < idx)) {
    best = ob;
    idx = oi;
  }
}

__global__ void median_extremes(const float2* __restrict__ v,    // (B,)
                                const float2* __restrict__ XW,   // (B*k, nW)
                                const int* __restrict__ yW,      // (B*k, nW)
                                int* __restrict__ i_p,           // (B*k,)
                                int* __restrict__ i_q,           // (B*k,)
                                int k, int nW, int rows) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= rows) return;   // whole warps leave together
  const float2 d = v[w / k];
  const float2* xr = XW + static_cast<size_t>(w) * nW;
  const int* yr = yW + static_cast<size_t>(w) * nW;

  float bp = -INFINITY, bq = INFINITY;
  int ip = INT_MAX, iq = INT_MAX;
  for (int r = lane; r < nW; r += 32) {
    const int lab = yr[r];
    const float2 x = xr[r];
    const float p = __fadd_rn(__fmul_rn(x.x, d.x), __fmul_rn(x.y, d.y));
    if (lab == 1 && p > bp) {
      bp = p;
      ip = r;
    }
    if (lab == -1 && p < bq) {
      bq = p;
      iq = r;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float obp = __shfl_xor_sync(0xffffffffu, bp, off);
    const int oip = __shfl_xor_sync(0xffffffffu, ip, off);
    const float obq = __shfl_xor_sync(0xffffffffu, bq, off);
    const int oiq = __shfl_xor_sync(0xffffffffu, iq, off);
    keep_max(bp, ip, obp, oip);
    keep_min(bq, iq, obq, oiq);
  }
  if (lane == 0) {
    i_p[w] = ip == INT_MAX ? 0 : ip;
    i_q[w] = iq == INT_MAX ? 0 : iq;
  }
}

}  // namespace

extern "C" int median_extremes_launch(const void* v, const void* XW,
                                      const void* yW, void* i_p, void* i_q,
                                      int B, int k, int nW, void* stream) {
  const int rows = B * k;
  const int warps_per_block = kThreads / 32;
  const int blocks = (rows + warps_per_block - 1) / warps_per_block;
  median_extremes<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(v), static_cast<const float2*>(XW),
      static_cast<const int*>(yW), static_cast<int*>(i_p),
      static_cast<int*>(i_q), k, nW, rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* median_extremes_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
