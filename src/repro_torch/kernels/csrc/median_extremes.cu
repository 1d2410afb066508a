// MEDIAN's stage-5 per-node extremes scan, hand-written for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/support_margin.py
// (median_extremes_batched, body _median_extremes_kernel).  For every
// instance b and node j it scans the rows of own ∪ fill-capped transcript
// and returns the row with the largest projection on v_b among label +1
// rows (first index on ties) and the row with the smallest projection
// among label -1 rows (first index on ties); index 0 where the class is
// absent.  The rows come in two segments, read where they lie: the node's
// own rows X (B, k, n, 2), y (B, k, n), and its transcript wx (B, k, cap,
// 2), wy (B, k, cap) up to a width W <= cap, numbered from n on as their
// concatenation would number them.  Beside the two indices it writes, on
// request, whether each class is present, the chosen rows themselves and
// their projections (-inf / +inf where the class is absent): all that
// MEDIAN's step needs, with no copy of the concatenation and no eager
// reductions around the call.
//
// Rounding.  The projection is (x0*v0) + (x1*v1) with one rounding per
// operation (__fmul_rn/__fadd_rn, never contracted; the library is also
// built with --fmad=false), as the JAX engine's inline path forms it.
//
// Bound on this card.  Each row is read once (8 bytes of point, 4 of label)
// for 3 f32 operations, so the bytes bound it: at MEDIAN's turn 1
// (B=3072, k=2, n=1000, W=8) 74 MB, 0.022 ms at 3.35 TB/s.
//
// Design.  A team of 32 to 256 threads per (instance, node) row block:
// one warp when there are enough row blocks to fill the card (turn 1's
// 6144), more when there are fewer (two at 2048-4095, up to eight for the
// noisy tail's 256).  The team strides over each segment's rows, so a
// warp's loads are contiguous 8-byte points and 4-byte labels, kAhead rows
// a thread in flight; at 32 registers every block of turn 1 is resident at
// once.  (Groups of four rows a thread, loaded as one 16-byte int4 of
// labels and two 16-byte float4s of points, and one stream over both
// segments were slower on this card.)  A thread visits its rows in
// increasing index order and keeps a running (max, index) over +1 rows
// and (min, index) over -1 rows with strict compares, so it holds the
// first index of its extremes, and whether it saw each class; the team
// merges with warp shuffles and, across warps, in shared memory, ties
// going to the smaller index.  The team's first thread then reads the two
// chosen rows again from their segments and writes them with their
// projections.  No atomics, no global scratch.

#include <cuda_runtime.h>
#include <climits>
#include <math.h>

namespace {

constexpr int kThreads = 256;      // 8 warps a block
constexpr int kMinBlocks = 8;      // resident blocks an SM: 32 registers
constexpr int kAhead = 2;          // rows a thread loads ahead
constexpr int kFillWarps = 4096;   // split row blocks below this many warps

struct Best {   // one class's running extreme
  float v;
  int i;
};

__device__ __forceinline__ float proj(float2 x, float2 d) {
  return __fadd_rn(__fmul_rn(x.x, d.x), __fmul_rn(x.y, d.y));
}

__device__ __forceinline__ void visit(Best& p, Best& q, bool& hp, bool& hq,
                                      float2 x, int lab, int idx, float2 d) {
  const float v = proj(x, d);
  const bool pos = lab == 1, neg = lab == -1;   // predicated, no branches
  hp |= pos;
  hq |= neg;
  if (pos && v > p.v) p = Best{v, idx};
  if (neg && v < q.v) q = Best{v, idx};
}

// Rows [0, count) of one segment, numbered first + row; this thread is r of
// a team of T and takes rows r, r + T, ...
__device__ __forceinline__ void scan(Best& p, Best& q, bool& hp, bool& hq,
                                     const float2* __restrict__ pts,
                                     const int* __restrict__ labs, int count,
                                     int first, int r, int T, float2 d) {
  int row = r;
  for (; row + (kAhead - 1) * T < count; row += kAhead * T) {
    int l[kAhead];
    float2 x[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      l[u] = __ldg(labs + row + u * T);
      x[u] = __ldg(pts + row + u * T);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      visit(p, q, hp, hq, x[u], l[u], first + row + u * T, d);
  }
  for (; row < count; row += T)
    visit(p, q, hp, hq, __ldg(pts + row), __ldg(labs + row), first + row, d);
}

// (value, index) merges; ties go to the smaller index
__device__ __forceinline__ void keep_max(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) v = ov, i = oi;
}
__device__ __forceinline__ void keep_min(float& v, int& i, float ov, int oi) {
  if (ov < v || (ov == v && oi < i)) v = ov, i = oi;
}

struct Out {   // all but i_p and i_q null for the indices alone
  int* i_p;
  int* i_q;
  bool* has_p;
  bool* has_q;
  float2* p;
  float2* q;
  float* lo;
  float* hi;
};

// team = warps a row block (1, 2, 4 or 8); a block holds 8 / team row
// blocks
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    median_extremes(const float2* __restrict__ v,     // (B,)
                    const float2* __restrict__ X,     // (B*k, n)
                    const int* __restrict__ y,        // (B*k, n)
                    const float2* __restrict__ wx,    // (B*k, cap)
                    const int* __restrict__ wy,       // (B*k, cap)
                    Out out, int k, int n, int cap, int W, int rows,
                    int team) {
  constexpr int kWarps = kThreads / 32;
  __shared__ float sbp[kWarps], sbq[kWarps];
  __shared__ int sip[kWarps], siq[kWarps];
  __shared__ bool shp[kWarps], shq[kWarps];

  const int T = 32 * team;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int r = tid % T;                         // rank in the team
  const int w = blockIdx.x * (kThreads / T) + tid / T;   // row block
  const bool mine = w < rows;

  Best p{-INFINITY, INT_MAX}, q{INFINITY, INT_MAX};
  bool hp = false, hq = false;
  float2 d{};
  if (mine) {
    d = v[w / k];
    scan(p, q, hp, hq, X + static_cast<size_t>(w) * n,
         y + static_cast<size_t>(w) * n, n, 0, r, T, d);
    scan(p, q, hp, hq, wx + static_cast<size_t>(w) * cap,
         wy + static_cast<size_t>(w) * cap, W, n, r, T, d);
  }
  // the warp's extremes, in every lane (butterfly)
  float bp = p.v, bq = q.v;
  int ip = p.i, iq = q.i;
  for (int off = 16; off > 0; off >>= 1) {
    const float obp = __shfl_xor_sync(0xffffffffu, bp, off);
    const int oip = __shfl_xor_sync(0xffffffffu, ip, off);
    const float obq = __shfl_xor_sync(0xffffffffu, bq, off);
    const int oiq = __shfl_xor_sync(0xffffffffu, iq, off);
    keep_max(bp, ip, obp, oip);
    keep_min(bq, iq, obq, oiq);
  }
  hp = __any_sync(0xffffffffu, hp);
  hq = __any_sync(0xffffffffu, hq);
  if (team > 1) {   // the team's warps, merged in warp order
    if (lane == 0) {
      sbp[wid] = bp, sip[wid] = ip, shp[wid] = hp;
      sbq[wid] = bq, siq[wid] = iq, shq[wid] = hq;
    }
    __syncthreads();
    if (r == 0) {
      for (int j = 1; j < team; ++j) {
        keep_max(bp, ip, sbp[wid + j], sip[wid + j]);
        keep_min(bq, iq, sbq[wid + j], siq[wid + j]);
        hp |= shp[wid + j];
        hq |= shq[wid + j];
      }
    }
  }
  if (!mine || r != 0) return;
  ip = ip == INT_MAX ? 0 : ip;
  iq = iq == INT_MAX ? 0 : iq;
  out.i_p[w] = ip;
  out.i_q[w] = iq;
  if (out.p == nullptr) return;
  // the chosen rows, read again from their own segments
  const float2* own = X + static_cast<size_t>(w) * n;
  const float2* tr = wx + static_cast<size_t>(w) * cap - n;
  const float2 pp = ip < n ? own[ip] : tr[ip];
  const float2 qq = iq < n ? own[iq] : tr[iq];
  out.has_p[w] = hp;
  out.has_q[w] = hq;
  out.p[w] = pp;
  out.q[w] = qq;
  out.lo[w] = hp ? proj(pp, d) : -INFINITY;
  out.hi[w] = hq ? proj(qq, d) : INFINITY;
}

int team_for(int rows) {
  int team = 1;
  while (team < kThreads / 32 && rows * team < kFillWarps) team *= 2;
  return team;
}

}  // namespace

// v (B, 2); X (B, k, n, 2) and y (B, k, n), the own rows; wx (B, k, cap, 2)
// and wy (B, k, cap), the transcripts, read up to W <= cap (W = 0: none;
// wx and wy may then be null); v, X and wx 8-byte aligned.  Writes i_p,
// i_q (B, k) int32, and has_p, has_q (bool), p, q (float2) and lo, hi
// (float), all (B, k), unless p is null.  `team` warps a row block (1,
// 2, 4 or 8; 0: team_for's choice): any team gives the same outputs,
// ties going to the smaller index.
extern "C" int median_extremes_launch(const void* v, const void* X,
                                      const void* y, const void* wx,
                                      const void* wy, void* i_p, void* i_q,
                                      void* has_p, void* has_q, void* p,
                                      void* q, void* lo, void* hi, int B,
                                      int k, int n, int cap, int W,
                                      int team, void* stream) {
  const int rows = B * k;
  if (team == 0) team = team_for(rows);
  if (team != 1 && team != 2 && team != 4 && team != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = kThreads / (32 * team);
  const int blocks = (rows + per_block - 1) / per_block;
  const Out out{static_cast<int*>(i_p),     static_cast<int*>(i_q),
                static_cast<bool*>(has_p),  static_cast<bool*>(has_q),
                static_cast<float2*>(p),    static_cast<float2*>(q),
                static_cast<float*>(lo),    static_cast<float*>(hi)};
  median_extremes<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(v), static_cast<const float2*>(X),
      static_cast<const int*>(y), static_cast<const float2*>(wx),
      static_cast<const int*>(wy), out, k, n, cap, W, rows, team);
  return static_cast<int>(cudaGetLastError());
}

// Warps a row block takes for `rows` row blocks, and blocks of the kernel
// resident on one SM.
extern "C" int median_extremes_occupancy(int rows, int* team, int* blocks) {
  *team = team_for(rows);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, median_extremes, kThreads, 0));
}

extern "C" const char* median_extremes_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
