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
// as in the plain version.  A point not labelled +1 is tested negated
// against -hi: every product and sum of -x is the negation of that of x,
// so -(v.x) > -hi is v.x < hi, on the same rounded value.
//
// Bound on this card.  Each point, label and per-direction bound is read
// once and one byte written per point; a point costs 2d-1 f32 operations
// and a compare per nonempty allowed direction it tests, up to its first
// hit.  At the MEDIAN final state (m = 1024, d = 2) the operations bound
// it.
//
// Design.  The TPU kernel streams m-tiles through a VMEM accumulator in
// grid order.  Here a block takes one instance, or a range of its points
// when the batch is too small to fill the card (the split read from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor).  The block compacts the
// instance's nonempty allowed directions once, in grid order, into shared
// memory (a ballot and a prefix over the block's warps per 256
// directions): for d = 2 one 16-byte slot {v0, v1, lo, -hi} each, padded
// with slots no point passes to a multiple of 128.  Then each warp takes
// its points one at a time, direction-parallel: 32 points are loaded at
// once (the next 32 while these are tested), one a lane, staged (negated
// unless labelled +1) and handed round with shuffles; for a point each
// lane tests four directions of the next 128 (lane + 32u), and one
// __any_sync tells the whole warp whether the point hit, so it moves on at
// the first 128 with a hit: no lane waits on another point.  (An instance
// with 128 directions or fewer is tested point-parallel instead: a lane a
// point, every lane reading the same slot in turn, since a warp would
// spend a whole vote on each point anyway.)  A lane keeps
// its directions of the first two rounds in registers, with their bounds
// for one label: a warp takes its 32 points' +1 points and the others in
// two runs, reloading the bounds between them, so the bound is never
// chosen per test.  Later rounds read the 16-byte slots.  More than a
// chunk's directions (m above what shared memory holds) are taken a chunk
// at a time, points that already hit skipped.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRound = 128;             // directions a warp tests per vote
constexpr int kPer = kRound / 32;       // of them a lane
constexpr int kMinPoints = 64;          // points a block at least
constexpr size_t kChunkBytes = 96 * 1024;
constexpr int kRegRounds = 2;           // d = 2: rounds held in registers

struct Args {
  const float* V;               // (m, d)
  const unsigned char* dir_ok;  // (B, m)
  const float* lo;              // (B, m)
  const float* hi;              // (B, m)
  const float* X;               // (B, n, d)
  const int* y;                 // (B, n)
  unsigned char* out;           // (B, n)
  int m, n, d, parts, cap;
};

// Directions in a chunk's shared memory: D = 2, float4 slots {v0, v1, lo,
// -hi}; D = 0 (any d), v coordinate-major (d, cap) and {lo, -hi} pairs.
template <int D>
struct Dirs {
  float4* slot;
  float* v;
  float2* bound;
  int cap;

  __device__ __forceinline__ void put(int s, const float* Vj, int d, float l,
                                      float h) {
    if constexpr (D == 2) {
      const float2 vj = *reinterpret_cast<const float2*>(Vj);
      slot[s] = make_float4(vj.x, vj.y, l, -h);
    } else {
      for (int c = 0; c < d; ++c) v[c * cap + s] = Vj[c];
      bound[s] = make_float2(l, -h);
    }
  }
  __device__ __forceinline__ void inert(int s, int d) {
    if constexpr (D == 2) {
      slot[s] = make_float4(0.f, 0.f, INFINITY, INFINITY);
    } else {
      for (int c = 0; c < d; ++c) v[c * cap + s] = 0.f;
      bound[s] = make_float2(INFINITY, INFINITY);
    }
  }
};

__device__ __forceinline__ float proj2(float4 s, float x0, float x1) {
  return __fadd_rn(__fmul_rn(s.x, x0), __fmul_rn(s.y, x1));
}

// d = 2: a lane's directions of the first kRegRounds rounds (128g + 32u +
// lane), and their bounds for the label being tested (lo, or -hi).
struct Regs {
  float2 v[kRegRounds][kPer];
  float b[kRegRounds][kPer];
};

// Whether any of the first 128 * rounds directions puts the staged point at
// risk, the first kRegRounds rounds from this lane's registers and the rest
// from shared memory; pos: labelled +1 (compared with lo), else with -hi.
__device__ __forceinline__ bool risky2(const Regs& r, const float4* slot,
                                       bool pos, int rounds, float x0,
                                       float x1, int lane) {
#pragma unroll
  for (int g = 0; g < kRegRounds; ++g) {
    if (g >= rounds) return false;
    bool h = false;
#pragma unroll
    for (int u = 0; u < kPer; ++u)
      h |= __fadd_rn(__fmul_rn(r.v[g][u].x, x0),
                     __fmul_rn(r.v[g][u].y, x1)) > r.b[g][u];
    if (__any_sync(0xffffffffu, h)) return true;
  }
  for (int g = kRegRounds; g < rounds; ++g) {
    bool h = false;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const float4 s = slot[kRound * g + 32 * u + lane];
      h |= proj2(s, x0, x1) > (pos ? s.z : s.w);
    }
    if (__any_sync(0xffffffffu, h)) return true;
  }
  return false;
}

// The same for any d: the staged point in x (d,), shared.
__device__ __forceinline__ bool risky(const Dirs<0>& s, int rounds,
                                      const float* x, int d, bool pos,
                                      int lane) {
  for (int g = 0; g < rounds; ++g) {
    bool h = false;
    for (int u = 0; u < kRound; u += 32) {
      const int j = kRound * g + u + lane;
      float p = __fmul_rn(s.v[j], x[0]);
      for (int c = 1; c < d; ++c)
        p = __fadd_rn(p, __fmul_rn(s.v[c * s.cap + j], x[c]));
      const float2 bd = s.bound[j];
      h |= p > (pos ? bd.x : bd.y);
    }
    if (__any_sync(0xffffffffu, h)) return true;
  }
  return false;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 4)
    uncertain_mask(const Args a) {
  extern __shared__ float4 smem[];
  __shared__ int s_count[kWarps];
  __shared__ float s_x[kWarps][64];   // D = 0: each warp's staged point

  const int d = D == 2 ? 2 : a.d;
  Dirs<D> dirs;
  dirs.cap = a.cap;
  dirs.slot = smem;
  dirs.v = reinterpret_cast<float*>(smem);
  dirs.bound = reinterpret_cast<float2*>(dirs.v + static_cast<size_t>(d) *
                                         a.cap);

  const int b = blockIdx.x / a.parts;
  const int part = blockIdx.x % a.parts;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // this block's points, and this warp's share of them
  const int per_block = (a.n + a.parts - 1) / a.parts;
  const int p0 = min(a.n, part * per_block);
  const int p1 = min(a.n, p0 + per_block);
  const int per_warp = (p1 - p0 + kWarps - 1) / kWarps;
  const int w0 = min(p1, p0 + warp * per_warp);
  const int w1 = min(p1, w0 + per_warp);

  const size_t row = static_cast<size_t>(b) * a.m;
  const size_t pts = static_cast<size_t>(b) * a.n;
  for (int j0 = 0; j0 < a.m; j0 += a.cap) {
    // compact this chunk's nonempty allowed directions, in grid order
    const int j1 = min(a.m, j0 + a.cap);
    // each tile's flags and bounds are loaded while the one before is
    // compacted
    int count = 0;
    auto fetch = [&](int j, float& l, float& h, bool& ok) {
      ok = j < j1;
      l = ok ? a.lo[row + j] : 0.f;
      h = ok ? a.hi[row + j] : 0.f;
      ok = ok && a.dir_ok[row + j];
    };
    float l_next, h_next;
    bool ok_next;
    fetch(j0 + threadIdx.x, l_next, h_next, ok_next);
    for (int t0 = j0; t0 < j1; t0 += kThreads) {
      const int j = t0 + threadIdx.x;
      const float l = l_next, h = h_next;
      const bool keep = ok_next && l < h;
      if (t0 + kThreads < j1)
        fetch(j + kThreads, l_next, h_next, ok_next);
      const unsigned ballot = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) s_count[warp] = __popc(ballot);
      __syncthreads();
      int slot = count + __popc(ballot & ((1u << lane) - 1u));
      for (int w = 0; w < kWarps; ++w) {
        slot += w < warp ? s_count[w] : 0;
        count += s_count[w];
      }
      if (keep)
        dirs.put(slot, a.V + static_cast<size_t>(j) * d, d, l, h);
      __syncthreads();   // s_count is read before the next tile writes it
    }
    const int rounds = (count + kRound - 1) / kRound;
    for (int s = count + threadIdx.x; s < rounds * kRound; s += kThreads)
      dirs.inert(s, d);
    __syncthreads();
    Regs regs;
    bool regs_pos = true;   // the label whose bounds regs holds
    auto bounds = [&](bool pos) {
#pragma unroll
      for (int g = 0; g < kRegRounds; ++g) {
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const float4 s = dirs.slot[kRound * g + 32 * u + lane];
          if (g < rounds) regs.b[g][u] = pos ? s.z : s.w;
        }
      }
      regs_pos = pos;
    };
    if constexpr (D == 2) {
#pragma unroll
      for (int g = 0; g < kRegRounds; ++g) {
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const float4 s = dirs.slot[kRound * g + 32 * u + lane];
          if (g < rounds) regs.v[g][u] = make_float2(s.x, s.y);
        }
      }
      bounds(true);
    }

    // this warp's points, 32 at a time, one a lane; the next 32 are loaded
    // while these are tested
    struct Batch {
      bool live, pos, prev;   // prev: hit in an earlier chunk
      float x0, x1;           // d = 2: the point, staged
    };
    auto load = [&](int q0) {
      const int i = q0 + lane;
      Batch p = {i < w1, false, false, 0.f, 0.f};
      if (p.live) {
        p.pos = a.y[pts + i] == 1;
        if (j0 > 0) p.prev = a.out[pts + i] != 0;
        if constexpr (D == 2) {
          const float2 x =
              *reinterpret_cast<const float2*>(a.X + (pts + i) * 2);
          p.x0 = p.pos ? x.x : -x.x;
          p.x1 = p.pos ? x.y : -x.y;
        }
      }
      return p;
    };
    Batch next = load(w0);
    for (int q0 = w0; q0 < w1; q0 += 32) {
      const Batch cur = next;
      if (q0 + 32 < w1) next = load(q0 + 32);
      if (D == 2 && rounds == 1) {
        // one round's directions or fewer: each lane tests its own point
        // against them in grid order (the warp reads each slot once),
        // leaving at its first hit
        bool hit = cur.prev;
        if (cur.live)
          for (int j = 0; j < count && !hit; ++j) {
            const float4 sj = dirs.slot[j];
            hit = proj2(sj, cur.x0, cur.x1) > (cur.pos ? sj.z : sj.w);
          }
        if (cur.live) a.out[pts + q0 + lane] = hit ? 1 : 0;
        continue;
      }
      const unsigned posmask = __ballot_sync(0xffffffffu, cur.pos);
      unsigned todo =
          rounds > 0 ? __ballot_sync(0xffffffffu, cur.live && !cur.prev)
                     : 0u;
      unsigned hits = 0;
      if constexpr (D == 2) {
        // the points of the label whose bounds the registers hold first,
        // then the others
        for (int phase = 0; phase < 2; ++phase) {
          const bool pos = phase == 0 ? regs_pos : !regs_pos;
          unsigned mine = todo & (pos ? posmask : ~posmask);
          if (mine == 0) continue;
          if (pos != regs_pos) bounds(pos);
          while (mine) {
            const int t = __ffs(mine) - 1;
            mine &= mine - 1;
            const float u0 = __shfl_sync(0xffffffffu, cur.x0, t);
            const float u1 = __shfl_sync(0xffffffffu, cur.x1, t);
            hits |= static_cast<unsigned>(
                        risky2(regs, dirs.slot, pos, rounds, u0, u1, lane))
                    << t;
          }
        }
      } else {
        while (todo) {
          const int t = __ffs(todo) - 1;
          todo &= todo - 1;
          const bool tpos = (posmask >> t) & 1u;
          const float* xt = a.X + (pts + q0 + t) * d;
          for (int c = lane; c < d; c += 32)
            s_x[warp][c] = tpos ? xt[c] : -xt[c];
          __syncwarp();
          hits |= static_cast<unsigned>(
                      risky(dirs, rounds, s_x[warp], d, tpos, lane))
                  << t;
          __syncwarp();   // s_x is read before the next point writes it
        }
      }
      if (cur.live)
        a.out[pts + q0 + lane] = (cur.prev || ((hits >> lane) & 1u)) ? 1 : 0;
    }
    __syncthreads();   // the chunk is read before the next one is written
  }
}

// Directions a chunk holds (a multiple of 256, at least 256) and its bytes.
int chunk_for(int m, int d, size_t* bytes) {
  const size_t per = static_cast<size_t>(d + 2) * sizeof(float);
  int cap = static_cast<int>(kChunkBytes / (per * kThreads)) * kThreads;
  cap = max(kThreads, min(cap, (m + kThreads - 1) / kThreads * kThreads));
  *bytes = per * cap;
  return cap;
}

// Blocks of the kernel resident on one SM with `bytes` of dynamic shared
// memory, allowed above 48 KB first.  Kept for the last `bytes` asked.
template <int D>
cudaError_t prepare(size_t bytes, int* blocks) {
  static size_t allowed = 48 * 1024, asked = 0;
  static int per_sm = 0;
  if (bytes == asked) {
    *blocks = per_sm;
    return cudaSuccess;
  }
  if (bytes > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        uncertain_mask<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    allowed = bytes;
  }
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, uncertain_mask<D>, kThreads, bytes);
  if (e == cudaSuccess) asked = bytes, per_sm = *blocks;
  return e;
}

// Blocks an instance's points are split over: enough blocks to fill the
// card once, each with at least kMinPoints points.
cudaError_t plan(int B, int m, int n, int d, int* parts, int* cap,
                 size_t* bytes, int* blocks) {
  static int sms_of[64];
  *cap = chunk_for(m, d, bytes);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int sms = dev < 64 ? sms_of[dev] : 0;
  if (sms == 0) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    if (dev < 64) sms_of[dev] = sms;
  }
  e = d == 2 ? prepare<2>(*bytes, blocks) : prepare<0>(*bytes, blocks);
  if (e != cudaSuccess) return e;
  const long long slots = static_cast<long long>(sms) * *blocks;
  const long long want = (slots + B - 1) / B;
  const int most = max(1, (n + kMinPoints - 1) / kMinPoints);
  *parts = want < 1 ? 1 : want < most ? static_cast<int>(want) : most;
  return cudaSuccess;
}

}  // namespace

extern "C" int uncertain_mask_launch(const void* V, const void* dir_ok,
                                     const void* lo, const void* hi,
                                     const void* X, const void* y, void* out,
                                     int B, int m, int n, int d,
                                     void* stream) {
  int parts = 1, cap = 0, blocks = 0;
  size_t bytes = 0;
  const cudaError_t e = plan(B, m, n, d, &parts, &cap, &bytes, &blocks);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Args a = {static_cast<const float*>(V),
                  static_cast<const unsigned char*>(dir_ok),
                  static_cast<const float*>(lo),
                  static_cast<const float*>(hi),
                  static_cast<const float*>(X),
                  static_cast<const int*>(y),
                  static_cast<unsigned char*>(out),
                  m, n, d, parts, cap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 2)
    uncertain_mask<2><<<B * parts, kThreads, bytes, s>>>(a);
  else
    uncertain_mask<0><<<B * parts, kThreads, bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// For these shapes: the blocks each instance's points are split over, the
// directions a chunk holds, and blocks of the kernel resident on one SM.
extern "C" int uncertain_mask_occupancy(int B, int m, int n, int d,
                                        int* parts, int* cap, int* blocks) {
  size_t bytes = 0;
  return static_cast<int>(plan(B, m, n, d, parts, cap, &bytes, blocks));
}

extern "C" const char* uncertain_mask_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
