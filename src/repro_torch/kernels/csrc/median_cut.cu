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
// flips ties.  A negative point is staged negated and tested as
//     fl(fl(v0*(-x0)) + fl(v1*(-x1))) > -hi_r[j]:
// negation is exact and round-to-nearest is symmetric, so the left side is
// -p (up to the sign of a zero, which no comparison sees) and the test is
// p < hi_r[j] bit for bit, infinities included.  Every test is then the
// same `p' > bound`, against one bound column per label.
//
// Bound on this card.  B*n*m risk tests of 3 f32 operations each (two
// multiplies and an add) over ~80 MB of inputs: at the smoke sweep's
// full-batch shape (B=3072, n=1000, m=1024) the operations bound it, 0.14 ms
// at 67 TFLOP/s.  The card issues one instruction a clock on each of its
// 528 schedulers, so the issue slots a test takes set the time: at least 4
// (the three operations and the compare), 0.38 ms there.  The first design
// took about ten a test, three launches a call and a zeroed global buffer.
//
// Design.  One block owns one instance for the whole call, one launch, no
// global scratch:
//   1. it stages the instance's directions and folded bounds once, 16 bytes
//      a direction: V (8), lo_r (4) and -hi_r (4), padded to a multiple of
//      32 directions with bounds that no point passes, and zeroes two
//      per-direction histograms (first and last risk row) in shared memory
//      (at m = 9000, 216 KB);
//   2. it stages its points in rounds: a stable compaction drops padding
//      rows and orders the rest by label (positives, then negatives
//      negated), each label padded to a whole register tile with NaN points
//      (NaN passes no test, so such a point is never live);
//   3. each thread holds a tile of kPts points of one label in registers
//      and walks the directions: all of them, or a 1/D share when the batch
//      is too small to fill the card (the noisy tail's 128 instances), D
//      threads then splitting one tile's directions and merging first and
//      last rows with shared atomics.  Per direction it makes one 8-byte
//      load of v and one 4-byte load of its label's bound, shared by the
//      tile's tests; per test it issues the two multiplies, the add, the
//      compare and one predicated bit-set in a 32-direction mask: 5 issue
//      slots.  Once per 32 directions __ffs and __clz fold each mask into
//      the point's first and last risk rows.  kPts = 4 keeps a thread near 58
//      registers (8 points a thread need about twice as many, and lost
//      more in resident warps than they saved in loads);
//   4. live points add their first and last rows to the histograms with
//      shared atomics (integers: exact, in any order);
//   5. the block prefix-scans the histograms (below = cumsum(last), above =
//      live - cumsum(first)) and writes min(below, above), or -1 at
//      disallowed directions, coalesced.

#include <algorithm>
#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kPts = 4;            // points in a thread's register tile
constexpr int kMaxThreads = 512;   // a block: tile threads x direction splits
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCounts = kPts * kMaxWarps;   // (load slot, warp) counts

// Dynamic shared memory.
struct Layout {
  // shared arrays, in this order: V (m_pad float2), lo_r (m_pad + 1
  // floats: the +1 puts -hi_r in another bank), -hi_r (m_pad), the two
  // histograms (m ints each), the staged points (nt*kPts float2) and,
  // with direction splits, the merged first / last rows (nt*kPts ints
  // each)
  __host__ __device__ static size_t fixed(int m) {
    const int mp = (m + 31) & ~31;
    const size_t b = static_cast<size_t>(mp) * 8 + (2 * mp + 1) * 4 +
                     static_cast<size_t>(m) * 8;
    return (b + 15) & ~static_cast<size_t>(15);
  }
  __host__ __device__ static size_t per_tile() { return kPts * (8 + 8); }
};

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned r;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(r));
  return r;
}

// The register tile's scan over direction groups [g0, g1) of 32.
__device__ __forceinline__ void scan_tile(const float2* __restrict__ sV,
                                          const float* __restrict__ bnd,
                                          int g0, int g1,
                                          const float (&px)[kPts],
                                          const float (&py)[kPts],
                                          int (&first)[kPts],
                                          int (&last)[kPts]) {
  for (int g = g0; g < g1; ++g) {
    const int j0 = g * 32;
    unsigned mask[kPts];
#pragma unroll
    for (int q = 0; q < kPts; ++q) mask[q] = 0u;
#pragma unroll
    for (int jj = 0; jj < 32; ++jj) {
      const float2 v = sV[j0 + jj];
      const float bd = bnd[j0 + jj];
#pragma unroll
      for (int q = 0; q < kPts; ++q) {
        const float p =
            __fadd_rn(__fmul_rn(v.x, px[q]), __fmul_rn(v.y, py[q]));
        if (p > bd) mask[q] |= 1u << jj;
      }
    }
#pragma unroll
    for (int q = 0; q < kPts; ++q) {
      if (mask[q] != 0u) {
        first[q] = min(first[q], j0 + __ffs(mask[q]) - 1);
        last[q] = j0 + 31 - __clz(mask[q]);
      }
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
    cut_scan(const float2* __restrict__ V,              // (m,)
             const unsigned char* __restrict__ dir_ok,  // (B, m)
             const float* __restrict__ lo,              // (B, m)
             const float* __restrict__ hi,              // (B, m)
             const float2* __restrict__ X,              // (B, n)
             const int* __restrict__ y,                 // (B, n)
             int* __restrict__ score,                   // (B, m)
             int m, int n, int m_pad, int nt, int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* sV = reinterpret_cast<float2*>(smem);
  float* sLo = reinterpret_cast<float*>(sV + m_pad);
  float* sNhi = sLo + m_pad + 1;
  int* hFirst = reinterpret_cast<int*>(sNhi + m_pad);
  int* hLast = hFirst + m;
  float2* sP = reinterpret_cast<float2*>(smem + Layout::fixed(m));
  int* pFirst = reinterpret_cast<int*>(sP + nt * kPts);
  int* pLast = pFirst + nt * kPts;
  __shared__ int cntP[kMaxCounts], cntN[kMaxCounts];
  __shared__ int totals[2];
  __shared__ int wsum[2][kMaxWarps];

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.x;
  const size_t row = static_cast<size_t>(b) * m;

  // 1. directions, folded bounds, zeroed histograms
  for (int j = tid; j < m_pad; j += nthreads) {
    if (j < m) {
      const float l = lo[row + j];
      const float h = hi[row + j];
      const bool nonempty = (l < h) && dir_ok[row + j];
      sV[j] = V[j];
      sLo[j] = nonempty ? l : INFINITY;
      sNhi[j] = nonempty ? -h : INFINITY;
      hFirst[j] = 0;
      hLast[j] = 0;
    } else {
      sV[j] = make_float2(0.0f, 0.0f);
      sLo[j] = INFINITY;
      sNhi[j] = INFINITY;
    }
  }

  const int tiles = nt * kPts;               // staged points a round
  const int per_round = (nt - 2) * kPts;     // input points a round
  const int slots = (per_round + nthreads - 1) / nthreads;   // <= kPts
  const int ncounts = slots * nwarps;
  const int groups = m_pad >> 5;
  const int gs = (groups + splits - 1) / splits;
  const int tile = tid % nt;                 // this thread's register tile
  const int g0 = min(groups, (tid / nt) * gs);
  const int g1 = min(groups, g0 + gs);
  const float2 nan2 = make_float2(NAN, NAN);
  const float2* Xb = X + static_cast<size_t>(b) * n;
  const int* yb = y + static_cast<size_t>(b) * n;

  for (int r0 = 0; r0 < n; r0 += per_round) {
    const int r1 = min(n, r0 + per_round);
    // 2a. this round's labels, counted per (slot, warp) in index order
    int lab[kPts], rank[kPts];
    float2 x[kPts];
#pragma unroll
    for (int q = 0; q < kPts; ++q) {
      const int i = r0 + q * nthreads + tid;
      lab[q] = (q < slots && i < r1) ? yb[i] : 0;
      x[q] = lab[q] != 0 ? Xb[i] : make_float2(0.0f, 0.0f);
      // a live label other than 1 is negative, as in the plain version
      const unsigned bp = __ballot_sync(0xffffffffu, lab[q] == 1);
      const unsigned bn = __ballot_sync(0xffffffffu, lab[q] != 0 &&
                                                         lab[q] != 1);
      rank[q] = __popc((lab[q] == 1 ? bp : bn) & lanemask_lt());
      if (lane == 0 && q < slots) {
        cntP[q * nwarps + warp] = __popc(bp);
        cntN[q * nwarps + warp] = __popc(bn);
      }
    }
    if (splits > 1) {
      for (int t = tid; t < tiles; t += nthreads) {
        pFirst[t] = INT_MAX;
        pLast[t] = -1;
      }
    }
    __syncthreads();
    // 2b. exclusive offsets of the counts (one warp, in place)
    if (warp == 0) {
      constexpr int E = (kMaxCounts + 31) / 32;
      int cp[E], cn[E], sp = 0, sn = 0;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int c = lane * E + e;
        cp[e] = c < ncounts ? cntP[c] : 0;
        cn[e] = c < ncounts ? cntN[c] : 0;
        sp += cp[e];
        sn += cn[e];
      }
      int ip = sp, in = sn;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int tp = __shfl_up_sync(0xffffffffu, ip, off);
        const int tn = __shfl_up_sync(0xffffffffu, in, off);
        if (lane >= off) {
          ip += tp;
          in += tn;
        }
      }
      int ep = ip - sp, en = in - sn;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int c = lane * E + e;
        if (c < ncounts) {
          cntP[c] = ep;
          cntN[c] = en;
        }
        ep += cp[e];
        en += cn[e];
      }
      if (lane == 31) {
        totals[0] = ip;
        totals[1] = in;
      }
    }
    __syncthreads();
    // 2c. scatter: positives from 0, negatives (negated) from pos_end
    const int npos = totals[0];
    const int nneg = totals[1];
    const int pos_end = (npos + kPts - 1) / kPts * kPts;
    const int staged = pos_end + (nneg + kPts - 1) / kPts * kPts;
#pragma unroll
    for (int q = 0; q < kPts; ++q) {
      if (lab[q] == 1) {
        sP[cntP[q * nwarps + warp] + rank[q]] = x[q];
      } else if (lab[q] != 0) {
        sP[pos_end + cntN[q * nwarps + warp] + rank[q]] =
            make_float2(-x[q].x, -x[q].y);
      }
    }
    if (tid < pos_end - npos) sP[npos + tid] = nan2;
    if (tid < staged - pos_end - nneg) sP[pos_end + nneg + tid] = nan2;
    __syncthreads();
    // 3. the register tiles
    const int base = tile * kPts;
    if (base < staged) {
      const float* bnd = base < pos_end ? sLo : sNhi;
      float px[kPts], py[kPts];
      int first[kPts], last[kPts];
#pragma unroll
      for (int q = 0; q < kPts; ++q) {
        const float2 p = sP[base + q];
        px[q] = p.x;
        py[q] = p.y;
        first[q] = INT_MAX;
        last[q] = -1;
      }
      scan_tile(sV, bnd, g0, g1, px, py, first, last);
      // 4. live points into the histograms (split tiles merge first)
#pragma unroll
      for (int q = 0; q < kPts; ++q) {
        if (last[q] >= 0) {
          if (splits == 1) {
            atomicAdd(&hFirst[first[q]], 1);
            atomicAdd(&hLast[last[q]], 1);
          } else {
            atomicMin(&pFirst[base + q], first[q]);
            atomicMax(&pLast[base + q], last[q]);
          }
        }
      }
    }
    __syncthreads();
    if (splits > 1) {
      for (int t = tid; t < staged; t += nthreads) {
        const int l = pLast[t];
        if (l >= 0) {
          atomicAdd(&hFirst[pFirst[t]], 1);
          atomicAdd(&hLast[l], 1);
        }
      }
      __syncthreads();
    }
  }

  // 5. below = cumsum(hLast), above = live - cumsum(hFirst), in place
  const int chunk = (m + nthreads - 1) / nthreads;
  const int j0 = min(m, tid * chunk);
  const int j1 = min(m, j0 + chunk);
  int sf = 0, sl = 0;
  for (int j = j0; j < j1; ++j) {
    sf += hFirst[j];
    sl += hLast[j];
  }
  int incf = sf, incl = sl;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int tf = __shfl_up_sync(0xffffffffu, incf, off);
    const int tl = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) {
      incf += tf;
      incl += tl;
    }
  }
  if (lane == 31) {
    wsum[0][warp] = incf;
    wsum[1][warp] = incl;
  }
  __syncthreads();
  int runf = incf - sf, runl = incl - sl, live = 0;
  for (int w = 0; w < nwarps; ++w) {
    if (w < warp) {
      runf += wsum[0][w];
      runl += wsum[1][w];
    }
    live += wsum[1][w];     // every live point has one last row
  }
  for (int j = j0; j < j1; ++j) {
    runf += hFirst[j];
    runl += hLast[j];
    hFirst[j] = min(runl, live - runf);
  }
  __syncthreads();
  for (int j = tid; j < m; j += nthreads)
    score[row + j] = dir_ok[row + j] ? hFirst[j] : -1;
}

int g_sms = 0;

}  // namespace

// One launch: a block per instance.  Returns cudaGetLastError() (or the
// error of the shared-memory attribute).
extern "C" int median_cut_launch(const void* V, const void* dir_ok,
                                 const void* lo, const void* hi,
                                 const void* X, const void* y, void* score,
                                 int B, int m, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(cut_scan,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               232448 - 2048);
    if (e != cudaSuccess) {
      g_sms = 0;
      return static_cast<int>(e);
    }
  }
  const int m_pad = (m + 31) & ~31;
  // enough tile threads for one round of n points (a round stages up to 2
  // tiles of label padding), within the shared memory left by the
  // directions
  const size_t room = 232448 - 2048 - Layout::fixed(m);
  const int nt_room = static_cast<int>(room / Layout::per_tile()) & ~31;
  int nt = ((n + kPts - 1) / kPts + 2 + 31) & ~31;
  nt = std::min(nt, std::min(kMaxThreads, nt_room));
  if (nt < 32) return static_cast<int>(cudaErrorInvalidValue);
  // direction splits: aim at 24 resident warps an SM when B is small
  const long want = static_cast<long>(g_sms) * 24 * 32;
  const long have = static_cast<long>(B) * nt;
  int splits = static_cast<int>((want + have - 1) / have);
  splits = std::max(1, std::min(splits, std::min(kMaxThreads / nt,
                                                  m_pad / 32)));
  const size_t bytes = Layout::fixed(m) + static_cast<size_t>(nt) * kPts *
                                             (splits > 1 ? 16 : 8);
  cut_scan<<<B, nt * splits, bytes, s>>>(
      static_cast<const float2*>(V), static_cast<const unsigned char*>(dir_ok),
      static_cast<const float*>(lo), static_cast<const float*>(hi),
      static_cast<const float2*>(X), static_cast<const int*>(y),
      static_cast<int*>(score), m, n, m_pad, nt, splits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* median_cut_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
