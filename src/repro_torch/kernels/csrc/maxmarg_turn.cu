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
// VMEM.  Here every segment (an instance's fit set, or one node's shard)
// is read once, by one warp or by a team of up to eight warps, and nothing
// goes through device memory but inputs and outputs.  Each lane walks the
// rows r, r + T, ... of its segment (T the team's threads; 8-byte points
// when d = 2, kAhead rows in flight), forms each margin once, counts
// errors, and keeps a sorted register list of its C smallest (margin,
// index) pairs among valid rows with a finite margin (C, a power of two up
// to 8, the smallest that holds max(max_support, viol_ship)).  The lanes'
// lists are merged in C rounds of a warp argmin over their heads (shuffles;
// the winner pops its head), the team's warps' lists once more through
// shared memory after one named barrier.  That gives the segment's C
// smallest valid rows in order, with no second walk: the band holds the
// valid rows whose margin is at most thr, and thr comes from the smallest
// of them, so the band's r smallest rows are the first of the merged list
// whose margin is <= thr.  The ranks start at the sentinel, written with
// 16-byte stores before the walk; after the barrier lane t writes rank t.
// A max_support or viol_ship above 8 takes more passes of the same walk,
// each collecting the next 8 rows after the last one ranked.  The team is
// the largest (up to 8 warps, at least 64 rows a warp) that keeps every
// segment's warps resident at once on the card, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor.

#include <cuda_runtime.h>
#include <climits>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxList = 8;         // register list capacity
constexpr int kAhead = 8;           // rows a lane loads at a time

struct KeyIdx {
  float key;
  int idx;
};

__device__ __forceinline__ KeyIdx empty() { return {INFINITY, INT_MAX}; }

// (key, index) order; idx == INT_MAX marks an empty entry
__device__ __forceinline__ bool before(const KeyIdx& a, const KeyIdx& b) {
  return a.key < b.key || (a.key == b.key && a.idx < b.idx);
}

// The C smallest pairs offered to it, in order.  A lane offers its rows
// in increasing index order, so a pair goes before an entry exactly when
// its margin is smaller: on equal margins the entry's index is smaller.
template <int C>
struct TopList {
  KeyIdx e[C];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int t = 0; t < C; ++t) e[t] = empty();
  }
  // Insert (key, idx) where it belongs, dropping the last entry; a key of
  // +inf changes nothing.  Branch-free: every lane runs the same code.
  __device__ __forceinline__ void offer(float key, int idx) {
    bool lt[C];
#pragma unroll
    for (int t = 0; t < C; ++t) lt[t] = key < e[t].key;
#pragma unroll
    for (int t = C - 1; t > 0; --t) {
      e[t].key = lt[t - 1] ? e[t - 1].key : (lt[t] ? key : e[t].key);
      e[t].idx = lt[t - 1] ? e[t - 1].idx : (lt[t] ? idx : e[t].idx);
    }
    if (lt[0]) e[0] = {key, idx};
  }
  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int t = 0; t + 1 < C; ++t) e[t] = e[t + 1];
    e[C - 1] = empty();
  }
};

// The warp's C smallest pairs over its lanes' lists, in every lane: C
// rounds of a butterfly argmin over the lanes' heads.
template <int C>
__device__ __forceinline__ void warp_merge(TopList<C>& l, KeyIdx (&m)[C]) {
#pragma unroll
  for (int t = 0; t < C; ++t) {
    KeyIdx best = l.e[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      KeyIdx o;
      o.key = __shfl_xor_sync(0xffffffffu, best.key, off);
      o.idx = __shfl_xor_sync(0xffffffffu, best.idx, off);
      if (before(o, best)) best = o;
    }
    m[t] = best;
    if (best.idx != INT_MAX && l.e[0].idx == best.idx) l.pop();
  }
}

// The team's threads meet: a warp's __syncwarp, or the named barrier
// 1 + (the team's index in its block) over its 32 * team threads.
__device__ __forceinline__ void team_sync(int team) {
  if (team == 1) {
    __syncwarp();
    return;
  }
  const int id = 1 + (threadIdx.x >> 5) / team;
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(32 * team) : "memory");
}

// Every entry of out[0, len) set to value: 16-byte stores where aligned,
// this thread being r of T.
__device__ __forceinline__ void fill(int* out, int len, int value, int r,
                                     int T) {
  const int head = min(
      len, static_cast<int>((0u - (reinterpret_cast<uintptr_t>(out) >> 2)) &
                            3u));
  if (r < head) out[r] = value;
  int4* body = reinterpret_cast<int4*>(out + head);
  const int quads = (len - head) >> 2;
  const int4 v4 = make_int4(value, value, value, value);
  for (int q = r; q < quads; q += T) body[q] = v4;
  const int tail = head + 4 * quads + r;
  if (r < 4 && tail < len) out[tail] = value;
}

// A segment's rows: points (len, d), labels (len,)
struct Segment {
  const float* pts;
  const int* labs;
  int len;
};

// One row's decision value, one rounding per operation.  D = 2: the point
// is a pair (load2, dec2); D = 0: any d, w read from w (d,) (dec).
template <int D>
struct Row {
  float2 w2;
  const float* w;
  int d;
  float b;

  __device__ __forceinline__ float dec(const float* x) const {
    float s = __fmul_rn(__ldg(x), __ldg(w));
    for (int i = 1; i < d; ++i)
      s = __fadd_rn(s, __fmul_rn(__ldg(x + i), __ldg(w + i)));
    return __fadd_rn(s, b);
  }
  __device__ __forceinline__ float2 load2(const float* x) const {
    return __ldg(reinterpret_cast<const float2*>(x));
  }
  __device__ __forceinline__ float dec2(float2 p) const {
    return __fadd_rn(__fadd_rn(__fmul_rn(p.x, w2.x), __fmul_rn(p.y, w2.y)),
                     b);
  }
};

// Visit one row: count its error (node rows) and offer its margin if the
// row is valid, its margin finite and (kAfter) after floor.
template <int C, bool kAfter>
__device__ __forceinline__ void visit(TopList<C>& l, int& errs, float dec,
                                      int lab, int idx, bool node,
                                      const KeyIdx& floor) {
  const float key = __fmul_rn(static_cast<float>(lab), dec);
  if (node) errs += (lab != 0 && (dec > 0.f ? 1 : -1) != lab) ? 1 : 0;
  bool cand = lab != 0 && key < INFINITY;
  if (kAfter) cand = cand && before(floor, {key, idx});
  l.offer(cand ? key : INFINITY, idx);
}

// This lane's walk over its rows r, r + T, ... of the segment, kAhead
// rows loaded at a time (a row past the end reads as label 0); kAfter:
// only pairs after floor are offered.
template <int D, int C, bool kAfter>
__device__ void walk(const Segment& s, const Row<D>& row, int r, int T,
                     bool node, const KeyIdx& floor, TopList<C>& l,
                     int& errs) {
  for (int i = r; i < s.len; i += kAhead * T) {
    int lab[kAhead];
    float2 p[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int iu = i + u * T;
      lab[u] = iu < s.len ? __ldg(s.labs + iu) : 0;
      if constexpr (D == 2)
        p[u] = iu < s.len ? row.load2(s.pts + static_cast<size_t>(iu) * 2)
                          : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int iu = i + u * T;
      float dec;
      if constexpr (D == 2)
        dec = row.dec2(p[u]);
      else
        dec = iu < s.len ? row.dec(s.pts + static_cast<size_t>(iu) * row.d)
                         : 0.f;
      visit<C, kAfter>(l, errs, dec, lab[u], iu, node, floor);
    }
  }
}

struct Args {
  const float* w;
  const float* b;
  const float* K;
  const int* yK;
  const float* X;
  const int* y;
  int* sup_rank;
  int* err_k;
  int* viol_rank;
  int B, N, k, n, d;
  float band_scale;
  int max_support, viol_ship;
};

// team = warps a segment (1, 2, 4 or 8); a block holds 8 / team segments,
// the segments of instance i being i * (k + 1) (the fit set) and
// i * (k + 1) + 1 + j (node j).
template <int D, int C>
__global__ void __launch_bounds__(kThreads)
    maxmarg_turn(const Args a, int team) {
  __shared__ KeyIdx s_list[kWarps][C];
  __shared__ int s_err[kWarps];
  __shared__ KeyIdx s_floor[kWarps];
  __shared__ int s_more[kWarps];

  const int T = 32 * team;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lead = warp - warp % team;            // the team's first warp
  const int r = threadIdx.x - 32 * lead;          // rank in the team
  const int seg = blockIdx.x * (kWarps / team) + warp / team;
  if (seg >= a.B * (a.k + 1)) return;             // the whole team
  const int inst = seg / (a.k + 1);
  const int j = seg % (a.k + 1) - 1;              // -1: the fit set
  const bool node = j >= 0;

  Row<D> row;
  row.w = a.w + static_cast<size_t>(inst) * a.d;
  row.d = a.d;
  row.b = a.b[inst];
  if constexpr (D == 2)
    row.w2 = __ldg(reinterpret_cast<const float2*>(row.w));
  Segment s;
  int* rank;
  int rr;   // ranks to hand out
  if (node) {
    const size_t row0 = (static_cast<size_t>(inst) * a.k + j) * a.n;
    s = {a.X + row0 * a.d, a.y + row0, a.n};
    rank = a.viol_rank + row0;
    rr = a.viol_ship;
  } else {
    const size_t row0 = static_cast<size_t>(inst) * a.N;
    s = {a.K + row0 * a.d, a.yK + row0, a.N};
    rank = a.sup_rank + row0;
    rr = a.max_support;
  }
  fill(rank, s.len, s.len, r, T);

  float thr = INFINITY;        // the band edge (fit set); none for nodes
  KeyIdx floor = {-INFINITY, -1};
  for (int base = 0;; base += C) {
    TopList<C> l;
    l.clear();
    int errs = 0;
    if (base == 0)
      walk<D, C, false>(s, row, r, T, node, floor, l, errs);
    else
      walk<D, C, true>(s, row, r, T, node, floor, l, errs);
    KeyIdx m[C];
    warp_merge(l, m);
    if (base == 0 && node) errs = __reduce_add_sync(0xffffffffu, errs);
    if (team > 1) {
      if (lane == 0) {
#pragma unroll
        for (int t = 0; t < C; ++t) s_list[warp][t] = m[t];
        s_err[warp] = errs;
      }
      team_sync(team);
      if (warp == lead) {
        l.clear();
        if (lane < team) {
#pragma unroll
          for (int t = 0; t < C; ++t) l.e[t] = s_list[lead + lane][t];
        }
        warp_merge(l, m);
        for (int w = 1; w < team; ++w) errs += s_err[lead + w];
      }
    } else {
      team_sync(team);   // the sentinels are in place
    }
    int more = 0;
    if (warp == lead) {
      if (base == 0) {
        if (node && lane == 0)
          a.err_k[static_cast<size_t>(inst) * a.k + j] = errs;
        if (!node) {
          const float mmin = m[0].idx != INT_MAX ? m[0].key : INFINITY;
          thr = __fmul_rn(fmaxf(mmin, 1e-12f), a.band_scale);
        }
      }
      // the merged list is sorted: the rows ranked now are a prefix
      int placed = 0;
#pragma unroll
      for (int t = 0; t < C; ++t) {
        const bool ok = base + t < rr && m[t].idx != INT_MAX &&
                        m[t].key <= thr;
        placed += ok ? 1 : 0;
        if (ok && lane == t) rank[m[t].idx] = base + t;
      }
      more = placed == C && base + C < rr;
      floor = m[C - 1];
    }
    if (team > 1) {
      if (warp == lead && lane == 0) {
        s_more[lead] = more;
        s_floor[lead] = floor;
      }
      team_sync(team);
      more = s_more[lead];
      floor = s_floor[lead];
      team_sync(team);   // s_list, s_more and s_floor are free again
    }
    if (!more) break;
  }
}

int list_for(int max_support, int viol_ship) {
  const int r = max(max_support, viol_ship);
  return r <= 1 ? 1 : r <= 2 ? 2 : r <= 4 ? 4 : kMaxList;
}

template <int D, int C>
cudaError_t blocks_per_sm(int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, maxmarg_turn<D, C>, kThreads, 0);
}

cudaError_t occupancy(int d, int C, int* blocks) {
  if (d == 2) {
    switch (C) {
      case 1: return blocks_per_sm<2, 1>(blocks);
      case 2: return blocks_per_sm<2, 2>(blocks);
      case 4: return blocks_per_sm<2, 4>(blocks);
      default: return blocks_per_sm<2, 8>(blocks);
    }
  }
  switch (C) {
    case 1: return blocks_per_sm<0, 1>(blocks);
    case 2: return blocks_per_sm<0, 2>(blocks);
    case 4: return blocks_per_sm<0, 4>(blocks);
    default: return blocks_per_sm<0, 8>(blocks);
  }
}

// Warps a segment for these shapes: the most (up to 8, each with at least
// 64 rows) that keep every segment resident at once.  The SM count and
// the kernels' residency are read once and kept (a launch is short).
cudaError_t plan(int B, int N, int k, int n, int d, int C, int* team,
                 int* blocks) {
  static int sms_of[64];
  static int blocks_of[2][kMaxList + 1];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int sms = dev < 64 ? sms_of[dev] : 0;
  if (sms == 0) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    if (dev < 64) sms_of[dev] = sms;
  }
  int& per_sm = blocks_of[d == 2][C];
  if (per_sm == 0) {
    e = occupancy(d, C, &per_sm);
    if (e != cudaSuccess) return e;
  }
  *blocks = per_sm;
  const long long slots = static_cast<long long>(sms) * per_sm * kWarps;
  const long long segs = static_cast<long long>(B) * (k + 1);
  const int longest = max(N, n);
  *team = 1;
  while (*team < kWarps && segs * *team * 2 <= slots &&
         64 * *team * 2 <= longest)
    *team *= 2;
  return cudaSuccess;
}

template <int D, int C>
void run(const Args& a, int team, cudaStream_t stream) {
  const long long segs = static_cast<long long>(a.B) * (a.k + 1);
  const int per_block = kWarps / team;
  const int grid = static_cast<int>((segs + per_block - 1) / per_block);
  maxmarg_turn<D, C><<<grid, kThreads, 0, stream>>>(a, team);
}

}  // namespace

// w (B, d), b (B,), K (B, N, d), yK (B, N), X (B, k, n, d), y (B, k, n);
// K, X and w 8-byte aligned when d = 2.  Writes sup_rank (B, N), err_k
// (B, k) and viol_rank (B, k, n), int32.
extern "C" int maxmarg_turn_launch(const void* w, const void* b,
                                   const void* K, const void* yK,
                                   const void* X, const void* y,
                                   void* sup_rank, void* err_k,
                                   void* viol_rank, int B, int N, int k,
                                   int n, int d, float band_scale,
                                   int max_support, int viol_ship,
                                   void* stream) {
  const Args a = {static_cast<const float*>(w), static_cast<const float*>(b),
                  static_cast<const float*>(K), static_cast<const int*>(yK),
                  static_cast<const float*>(X), static_cast<const int*>(y),
                  static_cast<int*>(sup_rank),  static_cast<int*>(err_k),
                  static_cast<int*>(viol_rank), B, N, k, n, d, band_scale,
                  max_support, viol_ship};
  const int C = list_for(max_support, viol_ship);
  int team = 1, blocks = 0;
  cudaError_t e = plan(B, N, k, n, d, C, &team, &blocks);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 2) {
    switch (C) {
      case 1: run<2, 1>(a, team, s); break;
      case 2: run<2, 2>(a, team, s); break;
      case 4: run<2, 4>(a, team, s); break;
      default: run<2, 8>(a, team, s); break;
    }
  } else {
    switch (C) {
      case 1: run<0, 1>(a, team, s); break;
      case 2: run<0, 2>(a, team, s); break;
      case 4: run<0, 4>(a, team, s); break;
      default: run<0, 8>(a, team, s); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// For these shapes: the warps a segment takes, the register list's
// capacity, and blocks of that kernel resident on one SM.
extern "C" int maxmarg_turn_occupancy(int B, int N, int k, int n, int d,
                                      int max_support, int viol_ship,
                                      int* team, int* list, int* blocks) {
  *list = list_for(max_support, viol_ship);
  return static_cast<int>(plan(B, N, k, n, d, *list, team, blocks));
}

extern "C" const char* maxmarg_turn_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
