// Consistent-threshold ranges over transcripts, hand-written for Hopper.
//
// Replaces the TPU kernels src/repro/kernels/support_margin.py
// threshold_ranges_batched (body _ranges_kernel_batched) and, as a call with
// B = 1, threshold_ranges (body _ranges_kernel).  For every instance b and
// every direction j of the shared grid V it returns
//     lo[b, j] = max over rows with label +1 of v_j . x,
//     hi[b, j] = min over rows with label -1 of v_j . x,
// -inf / +inf where the class is absent; label-0 rows (padding and the
// unfilled tail of a transcript) constrain nothing.  This is the rescan
// oracle of the MEDIAN engine's incremental ranges and the first half of
// the set-of-uncertainty diagnostics.
//
// Rounding.  The projection is ((v0*x0) + (v1*x1)) + ... left to right over
// d, one rounding per multiply and per add (__fmul_rn/__fadd_rn, never
// contracted; the library is also built with --fmad=false), as
// repro_torch.core.geometry.project forms it.  A max or a min is exact, so
// the rescan equals the ranges the engine keeps at append time bit for bit.
//
// Bound on this card.  Each transcript label is read once (4 bytes), each
// live row's point once (4d bytes; a label-0 row's point is never needed)
// and each (b, j) pair written once (8 bytes); every live row costs 2d-1
// f32 operations of projection and one compare per direction.
// With m = 1024 directions and d = 2 that is about 4 operations for every
// 12 bytes of a live row per direction, so at the MEDIAN smoke sweep's
// final state (a few dozen live rows per transcript) the outputs' bytes and
// the operations are of the same size.  Design: the TPU kernel streams
// n-tiles of the transcript through a VMEM accumulator in grid order and
// projects with a matrix product; here one block owns one instance and a
// tile of kThreads directions, one direction per thread, kept in shared
// memory transposed (conflict-free).  The block looks at kRows transcript
// labels at a time, one per thread; a warp ballot and a prefix over the
// block's warps give each row of label +1 or -1 its slot, and only those
// rows' points are read and staged in shared memory, in row order, so a
// label-0 row (padding, the unfilled tail) costs its label and nothing
// else.  Every thread reads the same staged row, so those loads are
// broadcasts.  Each thread keeps its running max and min in registers and
// writes them once.  No atomics, no order between blocks.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;   // directions per block
constexpr int kRows = kThreads; // transcript labels looked at per pass
constexpr int kWarps = kThreads / 32;

__global__ void threshold_ranges(const float* __restrict__ V,    // (m, d)
                                 const float* __restrict__ Xw,   // (B, n, d)
                                 const int* __restrict__ yw,     // (B, n)
                                 float* __restrict__ lo,         // (B, m)
                                 float* __restrict__ hi,         // (B, m)
                                 int m, int n, int d, int tiles) {
  extern __shared__ float smem[];
  float* sV = smem;                          // (d, kThreads), transposed
  float* sX = sV + d * kThreads;             // (kRows, d), compacted
  int* sY = reinterpret_cast<int*>(sX + kRows * d);   // (kRows,)
  int* sCount = sY + kRows;                  // (kWarps,)

  const int b = blockIdx.x / tiles;
  const int j = (blockIdx.x % tiles) * kThreads + threadIdx.x;
  const bool live = j < m;
  for (int i = 0; i < d; ++i)
    sV[i * kThreads + threadIdx.x] =
        live ? V[static_cast<size_t>(j) * d + i] : 0.0f;

  const float* xb = Xw + static_cast<size_t>(b) * n * d;
  const int* yb = yw + static_cast<size_t>(b) * n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float best_lo = -INFINITY;
  float best_hi = INFINITY;
  for (int r0 = 0; r0 < n; r0 += kRows) {
    // thread t looks at row r0 + t (kRows == kThreads)
    const int rt = r0 + threadIdx.x;
    const int lab = rt < n ? yb[rt] : 0;
    const bool keep = lab == 1 || lab == -1;
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    __syncthreads();   // the previous pass is done with sX/sY and counts
    if (lane == 0) sCount[warp] = __popc(ballot);
    __syncthreads();
    int slot = __popc(ballot & ((1u << lane) - 1u));
    int rows = 0;
    for (int w = 0; w < kWarps; ++w) {
      slot += w < warp ? sCount[w] : 0;
      rows += sCount[w];
    }
    if (keep) {
      sY[slot] = lab;
      for (int i = 0; i < d; ++i)
        sX[slot * d + i] = xb[static_cast<size_t>(rt) * d + i];
    }
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      const float* x = sX + r * d;
      float p = __fmul_rn(sV[threadIdx.x], x[0]);
      for (int i = 1; i < d; ++i)
        p = __fadd_rn(p, __fmul_rn(sV[i * kThreads + threadIdx.x], x[i]));
      if (sY[r] == 1) {
        best_lo = p > best_lo ? p : best_lo;
      } else {
        best_hi = p < best_hi ? p : best_hi;
      }
    }
  }
  if (live) {
    lo[static_cast<size_t>(b) * m + j] = best_lo;
    hi[static_cast<size_t>(b) * m + j] = best_hi;
  }
}

}  // namespace

extern "C" int threshold_ranges_launch(const void* V, const void* Xw,
                                       const void* yw, void* lo, void* hi,
                                       int B, int m, int n, int d,
                                       void* stream) {
  const size_t smem = (static_cast<size_t>(d) * (kThreads + kRows) + kRows +
                       kWarps) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        threshold_ranges, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int tiles = (m + kThreads - 1) / kThreads;
  threshold_ranges<<<B * tiles, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(V), static_cast<const float*>(Xw),
      static_cast<const int*>(yw), static_cast<float*>(lo),
      static_cast<float*>(hi), m, n, d, tiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* threshold_ranges_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
