// Set-of-uncertainty membership, hand-written for Hopper.
//
// Replaces the TPU kernels src/repro/kernels/support_margin.py
// uncertain_mask_batched (body _uncertain_kernel_batched) and, as a call
// with B = 1, uncertain_mask (body _uncertain_kernel).  For every instance b
// and point i it answers whether some allowed direction j with a nonempty
// consistent-threshold interval (lo < hi) puts the point at risk (paper
// §4.1):
//     out[b, i] = any over j of  dir_ok[b, j] & (lo[b, j] < hi[b, j])
//                 & (y == 1 ? v_j . x > lo[b, j] : v_j . x < hi[b, j]),
// with the strict comparisons of the JAX package's ref.uncertain_mask_ref.
// A label-0 row takes the -1 branch there too; the caller masks padding.
//
// Rounding.  The projection is ((v0*x0) + (v1*x1)) + ... left to right over
// d, one rounding per operation (__fmul_rn/__fadd_rn; the library is also
// built with --fmad=false), as repro_torch.core.geometry.project forms it,
// so a point on a band edge built from its own projection compares exactly
// as in the plain version.
//
// Bound on this card.  Each point, label and per-direction bound is read
// once and one byte written per point; a point costs 2d-1 f32 operations
// and a compare per nonempty allowed direction it tests, up to its first
// hit.  With m = 1024 and d = 2 the operations of the points that no
// direction puts at risk bound it.  Design: the TPU kernel streams m-tiles
// through a VMEM accumulator in grid order; here one thread owns one point
// (kept in shared memory, transposed) and walks the directions, which the
// block stages kDirs at a time in shared memory, compacted: each thread
// tests one direction of the tile, a warp ballot and a prefix over the
// block's warps give each nonempty allowed direction its slot, and only
// those are copied in, in grid order.  A direction that is not allowed or
// whose interval is empty is never projected.  Every thread reads the same
// direction in a step: broadcasts.  A thread stops testing at its first
// hit, and the block leaves the direction loop once every point of the
// block has hit (__syncthreads_and).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;   // points per block
constexpr int kDirs = kThreads; // directions looked at per pass
constexpr int kWarps = kThreads / 32;

__global__ void uncertain_mask(const float* __restrict__ V,   // (m, d)
                               const unsigned char* __restrict__ dir_ok,
                               const float* __restrict__ lo,  // (B, m)
                               const float* __restrict__ hi,  // (B, m)
                               const float* __restrict__ X,   // (B, n, d)
                               const int* __restrict__ y,     // (B, n)
                               unsigned char* __restrict__ out,   // (B, n)
                               int m, int n, int d, int tiles) {
  extern __shared__ float smem[];
  float* sV = smem;                       // (kDirs, d), compacted
  float* sLo = sV + kDirs * d;            // (kDirs,)
  float* sHi = sLo + kDirs;
  float* sX = sHi + kDirs;                // (d, kThreads), transposed
  int* sCount = reinterpret_cast<int*>(sX + d * kThreads);   // (kWarps,)

  const int b = blockIdx.x / tiles;
  const int i = (blockIdx.x % tiles) * kThreads + threadIdx.x;
  const bool live = i < n;
  const size_t pt = static_cast<size_t>(b) * n + i;
  for (int c = 0; c < d; ++c)
    sX[c * kThreads + threadIdx.x] = live ? X[pt * d + c] : 0.0f;
  const bool pos = live && y[pt] == 1;
  bool hit = !live;   // a thread without a point never holds the block

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t row = static_cast<size_t>(b) * m;
  for (int j0 = 0; j0 < m; j0 += kDirs) {
    // thread t looks at direction j0 + t of the tile (kDirs == kThreads)
    const int jt = j0 + threadIdx.x;
    float l = 0.0f, h = 0.0f;
    bool keep = false;
    if (jt < m) {
      l = lo[row + jt];
      h = hi[row + jt];
      keep = (l < h) && dir_ok[row + jt];
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    __syncthreads();   // the previous pass is done with the tile and counts
    if (lane == 0) sCount[warp] = __popc(ballot);
    __syncthreads();
    int slot = __popc(ballot & ((1u << lane) - 1u));
    int dirs = 0;
    for (int w = 0; w < kWarps; ++w) {
      slot += w < warp ? sCount[w] : 0;
      dirs += sCount[w];
    }
    if (keep) {
      sLo[slot] = l;
      sHi[slot] = h;
      for (int c = 0; c < d; ++c)
        sV[slot * d + c] = V[static_cast<size_t>(jt) * d + c];
    }
    __syncthreads();
    for (int j = 0; j < dirs && !hit; ++j) {
      const float* v = sV + j * d;
      float p = __fmul_rn(v[0], sX[threadIdx.x]);
      for (int c = 1; c < d; ++c)
        p = __fadd_rn(p, __fmul_rn(v[c], sX[c * kThreads + threadIdx.x]));
      hit = pos ? (p > sLo[j]) : (p < sHi[j]);
    }
    if (__syncthreads_and(hit)) break;   // uniform: every thread sees it
  }
  if (live) out[pt] = hit ? 1 : 0;
}

}  // namespace

extern "C" int uncertain_mask_launch(const void* V, const void* dir_ok,
                                     const void* lo, const void* hi,
                                     const void* X, const void* y, void* out,
                                     int B, int m, int n, int d,
                                     void* stream) {
  const size_t smem = (static_cast<size_t>(kDirs) * (d + 2) +
                       static_cast<size_t>(d) * kThreads) * sizeof(float) +
                      kWarps * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        uncertain_mask, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int tiles = (n + kThreads - 1) / kThreads;
  uncertain_mask<<<B * tiles, kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(V), static_cast<const unsigned char*>(dir_ok),
      static_cast<const float*>(lo), static_cast<const float*>(hi),
      static_cast<const float*>(X), static_cast<const int*>(y),
      static_cast<unsigned char*>(out), m, n, d, tiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* uncertain_mask_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
