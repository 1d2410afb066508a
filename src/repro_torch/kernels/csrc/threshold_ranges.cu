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
// Merge rule: a value replaces the running one only if it is strictly
// greater (lo) or strictly less (hi), so a NaN projection never enters and,
// of +0 and -0, the one met first stays.  Rows are met in the order
// (row group, chunk, place in the chunk's list): each row group folds its
// rows, chunk after chunk, and the groups' partials are folded in group
// order.  The numpy replica chip_smoke.ranges_replica spells this order
// out; the values are the plain version's under ==, whatever the order.
//
// Bound on this card.  Each transcript label is read once (4 bytes), each
// live row's point once (4d bytes; a label-0 row's point is never needed)
// and each (b, j) pair written once (8 bytes); a live row costs 2d-1 f32
// operations of projection and one compare per direction.  At the SOU
// diagnostics' shape (B = 3072, m = 1024, d = 2, transcripts of 392 rows
// holding about 20 live ones on average, 384 in every 24th) the outputs
// are 25.2 MB of the 30.5 MB to move (0.0091 ms at 3.35 TB/s) and the
// 61k live rows' 2.5e8 operations take 0.0037 ms at 67 TFLOP/s; issued one
// warp instruction a clock on 528 schedulers, FMUL, FMUL, FADD, FSETP and
// FSEL per (row, direction) are about 0.009 ms.
//
// Design.  The TPU kernel streams n-tiles of the transcript through a VMEM
// accumulator in grid order and projects with a matrix product.  Here a
// block of 256 threads owns a tile of directions of one instance, or of
// up to three:
//   - Directions.  A thread takes per_thread consecutive directions (4, or
//     1 when a small batch is split finely), and a row group of `warps`
//     warps covers the tile, 32 * warps * per_thread directions; the block's
//     8 / warps row groups split the rows.  At d = 2 and d = 3 the
//     directions' coordinates sit in registers (the kernel is templated on
//     d: no loop over d); any other d up to 64 keeps them in shared memory,
//     each direction's row padded to an odd number of 16-byte units so the
//     threads' float4 reads do not conflict.  lo and hi leave as one float4
//     store each when m is a multiple of 4, else one scalar store per
//     direction.
//   - Rows.  An instance's labels are read once a block, four a thread
//     with one 16-byte load (scalar loads where n is not a multiple of 4 or
//     the labels are not 16-byte aligned), chunk rows at a time (1024 at
//     d = 2 and 3).  Warp shuffles and one prefix over the block's 8 warps
//     give each row of label +1 a place in a list of +1 rows and each row
//     of label -1 a place in a list of -1 rows that follows it, in row
//     order; the owner of a row copies its point there with cp.async (8
//     bytes at d = 2), all copies in flight together.  A row group walks
//     the +1 list (places g, g + groups, ...) keeping maxima and the -1
//     list keeping minima, every lane reading the same staged point (a
//     broadcast), with no branch on a label.
//   - Latency.  Where the transcripts fit one chunk and the blocks would
//     fill the card more than once, a block stages up to three instances
//     together: their labels read at once, one barrier, their points
//     copied at once, one barrier, then each folded and written in turn.  Where they do not, the next chunk's labels are
//     read, and its points copied into the other buffer, while this chunk
//     is folded.
//   - Long lists at d = 2 (a noisy instance's transcript holds 384 rows:
//     folded whole, its block took longer than the rest of the batch, and
//     those blocks met on a few SMs).  Two kinds of row change no output
//     under the strict rule, not even a sign of zero, and are passed over.
//     (1) A row that cannot be largest: a warp's 128 directions lie within
//     R of their mean c (R holds the rounding slack), so every rounded
//     projection of x lies within R |x| of c . x; a +1 row's projections
//     are at most the final lo, so lo is at least the largest c . x - R |x|
//     of the list and at least the exact projections of the row of
//     largest c . x, and a row with c . x + R |x| strictly below that edge
//     is no maximum (likewise for -1 rows and hi).  (2) A row whose point
//     is bit for bit the one before it in the list: a transcript ships
//     the same extreme points turn after turn, and its copies follow one
//     another.  The warp bounds 32 rows at once, a lane a row, and folds
//     the others in order, handed round by shuffles.
//   - Small batches.  Where the batch gives fewer blocks than the card
//     holds at once, support_margin.ranges_occupancy picks a smaller tile
//     (more blocks an instance) and more row groups; the groups' partials
//     meet in shared memory and group 0 folds them in order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLabels = 4;     // labels a thread reads per chunk: one int4
constexpr int kFewRows = 16;   // d = 2: a group's list this short is not
                               // bounded first
constexpr int kMaxBatch = 3;   // instances a block stages together

struct Args {
  const float* V;    // (m, d)
  const float* X;    // (B, n, d)
  const int* y;      // (B, n)
  float* lo;         // (B, m)
  float* hi;         // (B, m)
  int m, n, d;
  int B;
  int groups;        // row groups of a block: 1, 2, 4 or 8
  int gshift;        // log2(groups)
  int tiles;         // direction tiles an instance
  int per_block;     // instances a block stages together (n <= chunk)
  int chunk;         // rows staged at a time, a multiple of kLabels
  int xs;            // floats a staged row takes
  int vs;            // any d: floats a staged direction takes
  bool vec_labels;   // labels read as int4
  bool vec_out;      // lo and hi written as float4
};

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int bytes) {
  const uint32_t s =
      static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(s),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s),
                 "l"(src));
}

// v . x, left to right over d, one rounding per operation; v and x are
// 16-byte aligned in shared memory.
__device__ __forceinline__ float dot_any(const float* v, const float* x,
                                         int d) {
  float p;
  int c;
  if (d >= 4) {
    float4 a = *reinterpret_cast<const float4*>(v);
    float4 b = *reinterpret_cast<const float4*>(x);
    p = __fmul_rn(a.x, b.x);
    p = __fadd_rn(p, __fmul_rn(a.y, b.y));
    p = __fadd_rn(p, __fmul_rn(a.z, b.z));
    p = __fadd_rn(p, __fmul_rn(a.w, b.w));
    for (c = 4; c + 4 <= d; c += 4) {
      a = *reinterpret_cast<const float4*>(v + c);
      b = *reinterpret_cast<const float4*>(x + c);
      p = __fadd_rn(p, __fmul_rn(a.x, b.x));
      p = __fadd_rn(p, __fmul_rn(a.y, b.y));
      p = __fadd_rn(p, __fmul_rn(a.z, b.z));
      p = __fadd_rn(p, __fmul_rn(a.w, b.w));
    }
  } else {
    p = __fmul_rn(v[0], x[0]);
    c = 1;
  }
  for (; c < d; ++c) p = __fadd_rn(p, __fmul_rn(v[c], x[c]));
  return p;
}

__device__ __forceinline__ float warp_max(float t) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    t = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, o));
  return t;
}

__device__ __forceinline__ float warp_min(float t) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    t = fminf(t, __shfl_xor_sync(0xffffffffu, t, o));
  return t;
}

// D = 2 or 3: coordinates in registers; D = 0: any d, in shared memory.
// A block takes one instance and one tile of its directions.
// At d = 2 the compiler is held to 64 registers, four blocks an SM: with
// its own choice (over 100) two fit, and at 48 or 40 the spills cost more
// than the fifth and sixth block bring.
template <int D, int DPT>
__global__ void __launch_bounds__(kThreads, D == 2 ? 4 : 1)
    threshold_ranges(const Args a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_tot[kMaxBatch][kWarps];

  const int d = D == 0 ? a.d : D;
  const int xs = D == 2 ? 2 : D == 3 ? 4 : a.xs;
  const int gsize = kThreads >> a.gshift;  // threads of a row group
  const int group = threadIdx.x / gsize;
  const int gt = threadIdx.x % gsize;
  const int tile_dirs = gsize * DPT;
  const int b0 = (blockIdx.x / a.tiles) * a.per_block;   // first instance
  const int count = min(a.per_block, a.B - b0);
  const int jt = (blockIdx.x % a.tiles) * tile_dirs;
  const int j0 = jt + gt * DPT;            // this thread's first direction
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bufs = max(2, a.per_block);
  float* rows = smem;                      // buffers of chunk rows
  const int buf_floats = a.chunk * xs;
  float* sv = rows + bufs * buf_floats;    // D = 0: the tile's directions
  float* part = sv + (D == 0 ? kThreads * a.vs : 0);   // groups' partials

  // this thread's directions (D = 2, 3), loaded while the labels are
  float v[DPT][D == 0 ? 1 : D];
  if constexpr (D == 2) {
#pragma unroll
    for (int u = 0; u < DPT; ++u) {
      const float2 q = j0 + u < a.m ? reinterpret_cast<const float2*>(a.V)
                                          [j0 + u]
                                    : make_float2(0.f, 0.f);
      v[u][0] = q.x;
      v[u][1] = q.y;
    }
  } else if constexpr (D == 3) {
#pragma unroll
    for (int u = 0; u < DPT; ++u)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        v[u][c] = j0 + u < a.m ? a.V[static_cast<size_t>(j0 + u) * 3 + c]
                               : 0.f;
  }

  // this thread's labels of rows r0 + 4t .. r0 + 4t + 3 of instance b
  auto load = [&](int b, int r0) {
    const int* yb = a.y + static_cast<size_t>(b) * a.n;
    const int r = r0 + kLabels * threadIdx.x;
    int4 q = make_int4(0, 0, 0, 0);
    if (kLabels * threadIdx.x < a.chunk && r < a.n) {
      if (a.vec_labels) {
        q = *reinterpret_cast<const int4*>(yb + r);
      } else {
        q.x = yb[r];
        q.y = r + 1 < a.n ? yb[r + 1] : 0;
        q.z = r + 2 < a.n ? yb[r + 2] : 0;
        q.w = r + 3 < a.n ? yb[r + 3] : 0;
      }
    }
    return q;
  };
  // their +1 rows' mask, and their -1 rows' shifted by 4
  auto masks = [](int4 q) {
    const int lab[kLabels] = {q.x, q.y, q.z, q.w};
    unsigned pm = 0, nm = 0;
#pragma unroll
    for (int i = 0; i < kLabels; ++i) {
      pm |= static_cast<unsigned>(lab[i] == 1) << i;
      nm |= static_cast<unsigned>(lab[i] == -1) << i;
    }
    return pm | nm << kLabels;
  };
  // the warp's exclusive prefix of (+1 count) | (-1 count) << 16; the
  // warp's total goes to s_tot[k]
  auto prefix = [&](unsigned mask, int k) {
    const int c = __popc(mask & 15u) | (__popc(mask >> kLabels) << 16);
    int s = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += t;
    }
    if (lane == 31) s_tot[k][warp] = s;
    return s - c;
  };
  // after a __syncthreads: the list lengths of instance b's rows from r0,
  // and the copies of this thread's live rows into their places in buffer
  // k, in flight as one group
  auto stage = [&](int b, int r0, unsigned mask, int excl, int k, int& P,
                   int& N) {
    const unsigned pm = mask & 15u, nm = mask >> kLabels;
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int t = s_tot[k][w];
      before += w < warp ? t : 0;
      total += t;
    }
    P = total & 0xffff;
    N = total >> 16;
    int ps = (excl & 0xffff) + (before & 0xffff);
    int ns = P + (excl >> 16) + (before >> 16);
    float* buf = rows + k * buf_floats;
    const float* xr =
        a.X + (static_cast<size_t>(b) * a.n + r0 + kLabels * threadIdx.x) * d;
#pragma unroll
    for (int i = 0; i < kLabels; ++i) {
      if (!(((pm | nm) >> i) & 1u)) continue;
      float* dst = buf + ((pm >> i) & 1u ? ps++ : ns++) * xs;
      const float* src = xr + i * d;
      if constexpr (D == 2) {
        cp_async(dst, src, 8);
      } else {
        for (int c = 0; c < d; ++c) cp_async(dst + c, src + c, 4);
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  float lo[DPT], hi[DPT];
#pragma unroll
  for (int u = 0; u < DPT; ++u) lo[u] = -INFINITY, hi[u] = INFINITY;
  auto proj = [&](const float* x, int u) {
    if constexpr (D == 2) {
      const float2 q = *reinterpret_cast<const float2*>(x);
      return __fadd_rn(__fmul_rn(v[u][0], q.x), __fmul_rn(v[u][1], q.y));
    } else if constexpr (D == 3) {
      const float4 q = *reinterpret_cast<const float4*>(x);
      return __fadd_rn(__fadd_rn(__fmul_rn(v[u][0], q.x),
                                 __fmul_rn(v[u][1], q.y)),
                       __fmul_rn(v[u][2], q.z));
    } else {
      return dot_any(sv + gt * a.vs, x, d);
    }
  };

  // D = 2: bounds on the warp's rounded projections of a point x.  With c
  // the mean of the warp's directions and r their largest distance from
  // c, |v . x - c . x| <= r |x| for each of them, and a rounded projection
  // is within 2^-22 (|v0 x0| + |v1 x1|) <= 2^-22 (|v0| + |v1|) |x| of
  // v . x; so R = r + 1e-5 max(|v0| + |v1|) covers that and the rounding
  // of the bounds themselves (|x| from rsqrtf is within 2^-21 of its
  // value), 1e-44 the subnormal range.
  float c0 = 0.f, c1 = 0.f, R = -1.f;      // R < 0: not computed yet
  auto bound = [&]() {
    float s0 = 0.f, s1 = 0.f, cnt = 0.f;
#pragma unroll
    for (int u = 0; u < DPT; ++u) {
      if (j0 + u < a.m) s0 += v[u][0], s1 += v[u][1], cnt += 1.f;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
    }
    if (cnt > 0.f) c0 = s0 / cnt, c1 = s1 / cnt;
    float r = 0.f, vmax = 0.f;
#pragma unroll
    for (int u = 0; u < DPT; ++u) {
      if (j0 + u < a.m) {
        const float dx = v[u][0] - c0, dy = v[u][1] - c1;
        r = fmaxf(r, sqrtf(dx * dx + dy * dy));
        vmax = fmaxf(vmax, fabsf(v[u][0]) + fabsf(v[u][1]));
      }
    }
    R = warp_max(r) + 1e-5f * warp_max(vmax);
  };
  // this row group's rows of one list, places group + i * groups for
  // i < cnt, folded in order into lo (Pos) or hi
  auto fold_list = [&](auto pos_tag, const float* list, int cnt) {
    constexpr bool Pos = decltype(pos_tag)::value;
    constexpr float sign = Pos ? 1.f : -1.f;
    auto take = [&](float p, int u) {
      if constexpr (Pos) lo[u] = p > lo[u] ? p : lo[u];
      else hi[u] = p < hi[u] ? p : hi[u];
    };
    if (D != 2 || cnt <= kFewRows) {
#pragma unroll 4
      for (int i = 0; i < cnt; ++i) {
        const float* x = list + (group + (i << a.gshift)) * xs;
#pragma unroll
        for (int u = 0; u < DPT; ++u) take(proj(x, u), u);
      }
      return;
    }
    if constexpr (D == 2) {
      // d = 2, a long list.  Its rows bound the warp's final outputs from
      // below (above, for -1 rows): a +1 row's projections are at most lo,
      // so lo is at least the largest lower bound of a row, and at least
      // the projections of the row likeliest to be largest (largest c . x),
      // computed exactly.  A row whose upper bound falls strictly below
      // that edge is no maximum and is passed over: the outputs are the
      // same bit for bit, signs of zero included.
      if (R < 0.f) bound();
      const float2* rows2 = reinterpret_cast<const float2*>(list);
      // in sign-folded units (sign * projection): row i's centre value and
      // its half-width
      auto bounds = [&](int i, float2& q, float& cx, float& w) {
        q = i < cnt ? rows2[group + (i << a.gshift)] : make_float2(0.f, 0.f);
        cx = sign * __fmaf_rn(c1, q.y, __fmul_rn(c0, q.x));
        const float t =
            fmaxf(__fmaf_rn(q.x, q.x, __fmul_rn(q.y, q.y)), 1e-38f);
        w = __fmul_rn(R, __fmul_rn(t, rsqrtf(t))) + 1e-44f;
      };
      float edge = -INFINITY, best = -INFINITY;
      int arg = 0;
#pragma unroll 4
      for (int base = 0; base < cnt; base += 32) {
        float2 q;
        float cx, w;
        bounds(base + lane, q, cx, w);
        if (base + lane < cnt) {
          edge = fmaxf(edge, cx - w);
          if (cx > best) best = cx, arg = base + lane;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, o);
        const int oa = __shfl_xor_sync(0xffffffffu, arg, o);
        if (ob > best || (ob == best && oa < arg)) best = ob, arg = oa;
      }
      float cur = INFINITY;     // the warp's least sign * output
      {
        const float2 q = rows2[group + (arg << a.gshift)];
#pragma unroll
        for (int u = 0; u < DPT; ++u) {
          const float p =
              __fadd_rn(__fmul_rn(v[u][0], q.x), __fmul_rn(v[u][1], q.y));
          const float o = Pos ? fmaxf(lo[u], p) : -fminf(hi[u], p);
          cur = fminf(cur, j0 + u < a.m ? o : cur);
        }
      }
      edge = fmaxf(warp_max(edge), warp_min(cur));
      // A row whose point is bit for bit the one before it in the list
      // changes nothing either (a transcript ships the same extreme points
      // turn after turn, so its copies follow one another): it is passed
      // over too.
      unsigned long long last = 0ull;   // the previous batch's last point
      for (int base = 0; base < cnt; base += 32) {
        float2 q;
        float cx, w;
        bounds(base + lane, q, cx, w);
        const unsigned long long key =
            static_cast<unsigned long long>(__float_as_uint(q.y)) << 32 |
            __float_as_uint(q.x);
        const unsigned long long up = __shfl_up_sync(0xffffffffu, key, 1);
        const bool copy = (lane > 0 || base > 0) &&
                          (lane > 0 ? up : last) == key;
        last = __shfl_sync(0xffffffffu, key, 31);
        const bool keep = base + lane < cnt && !(cx + w < edge) && !copy;
        const unsigned todo = __ballot_sync(0xffffffffu, keep);
        for (unsigned left = todo; left;) {
          const int l = __ffs(left) - 1;
          left &= left - 1;
          const float x0 = __shfl_sync(0xffffffffu, q.x, l);
          const float x1 = __shfl_sync(0xffffffffu, q.y, l);
#pragma unroll
          for (int u = 0; u < DPT; ++u)
            take(__fadd_rn(__fmul_rn(v[u][0], x0), __fmul_rn(v[u][1], x1)),
                 u);
        }
      }
    }
  };
  // this row group's share of a staged chunk's two lists
  auto fold = [&](const float* buf, int P, int N) {
    fold_list(std::true_type{}, buf,
              P > group ? (P - group + a.groups - 1) >> a.gshift : 0);
    fold_list(std::false_type{}, buf + P * xs,
              N > group ? (N - group + a.groups - 1) >> a.gshift : 0);
  };

  // instance b is folded: the groups' partials meet in shared memory,
  // folded in group order, and lo and hi are written
  auto finish = [&](int b) {
    bool store = true;
    if (a.groups > 1) {
      if (group > 0) {
        float* pl = part + (group - 1) * 2 * tile_dirs + gt * DPT;
#pragma unroll
        for (int u = 0; u < DPT; ++u)
          pl[u] = lo[u], pl[tile_dirs + u] = hi[u];
      }
      __syncthreads();
      store = group == 0;
      if (store) {
        for (int g = 1; g < a.groups; ++g) {
          const float* pl = part + (g - 1) * 2 * tile_dirs + gt * DPT;
#pragma unroll
          for (int u = 0; u < DPT; ++u) {
            const float l = pl[u], h = pl[tile_dirs + u];
            lo[u] = l > lo[u] ? l : lo[u];
            hi[u] = h < hi[u] ? h : hi[u];
          }
        }
      }
      __syncthreads();   // the partials are read before the next are
    }
    if (store) {
      const size_t row = static_cast<size_t>(b) * a.m;
      bool vec = false;
      if constexpr (DPT == 4) vec = a.vec_out;
      if (vec) {
        if (j0 < a.m) {   // m is a multiple of 4: all four are directions
          *reinterpret_cast<float4*>(a.lo + row + j0) =
              make_float4(lo[0], lo[DPT > 1 ? 1 : 0], lo[DPT > 2 ? 2 : 0],
                          lo[DPT > 3 ? 3 : 0]);
          *reinterpret_cast<float4*>(a.hi + row + j0) =
              make_float4(hi[0], hi[DPT > 1 ? 1 : 0], hi[DPT > 2 ? 2 : 0],
                          hi[DPT > 3 ? 3 : 0]);
        }
      } else {
#pragma unroll
        for (int u = 0; u < DPT; ++u) {
          if (j0 + u < a.m) {
            a.lo[row + j0 + u] = lo[u];
            a.hi[row + j0 + u] = hi[u];
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < DPT; ++u) lo[u] = -INFINITY, hi[u] = INFINITY;
  };

  if constexpr (D == 0) {
    for (int i = threadIdx.x; i < tile_dirs * d; i += kThreads) {
      const int j = i / d, c = i % d;
      sv[j * a.vs + c] =
          jt + j < a.m ? a.V[static_cast<size_t>(jt + j) * d + c] : 0.f;
    }
  }
  if (a.n <= a.chunk) {
    // the block's instances staged together: every label read at once,
    // one barrier, every point copied at once, one barrier; then each is
    // folded and written in turn
    unsigned mask[kMaxBatch];
    int excl[kMaxBatch], pn[kMaxBatch];
    int4 q[kMaxBatch];
#pragma unroll
    for (int k = 0; k < kMaxBatch; ++k)
      if (k < count) q[k] = load(b0 + k, 0);
#pragma unroll
    for (int k = 0; k < kMaxBatch; ++k)
      if (k < count) mask[k] = masks(q[k]), excl[k] = prefix(mask[k], k);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMaxBatch; ++k) {
      if (k < count) {
        int P, N;
        stage(b0 + k, 0, mask[k], excl[k], k, P, N);
        pn[k] = P | N << 16;
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMaxBatch; ++k) {
      if (k < count) {
        fold(rows + k * buf_floats, pn[k] & 0xffff, pn[k] >> 16);
        finish(b0 + k);
      }
    }
    return;
  }
  // one instance over chunks: a chunk's points copied while the chunk
  // before is folded, its labels read a chunk ahead
  const int cps = (a.n + a.chunk - 1) / a.chunk;
  unsigned mask = masks(load(b0, 0));
  int excl = prefix(mask, 0);
  __syncthreads();
  int P, N;
  stage(b0, 0, mask, excl, 0, P, N);
  mask = masks(load(b0, a.chunk));
  for (int c = 0; c < cps; ++c) {
    const bool more = c + 1 < cps;
    const int k = (c + 1) & 1;
    if (more) excl = prefix(mask, k);
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();   // chunk c staged; chunk c - 1's buffer free
    int Pn = 0, Nn = 0;
    if (more) {
      stage(b0, (c + 1) * a.chunk, mask, excl, k, Pn, Nn);
      if (c + 2 < cps) mask = masks(load(b0, (c + 2) * a.chunk));
    }
    fold(rows + (c & 1) * buf_floats, P, N);
    P = Pn, N = Nn;
  }
  finish(b0);
}

// The launch's geometry: floats a staged row and a staged direction take,
// and the dynamic shared memory: a row buffer for each instance staged
// together (two at least, for chunks), for any d the tile's directions,
// and the row groups' partials.
struct Shape {
  int xs, vs;
  size_t bytes;
};

Shape shape_of(int d, int per_thread, int chunk, int per_block) {
  Shape s;
  const int units = (d + 3) / 4;
  s.xs = d == 2 ? 2 : 4 * units;
  s.vs = (d == 2 || d == 3) ? 0 : 4 * (units | 1);
  s.bytes = (max(2, per_block) * static_cast<size_t>(chunk) * s.xs +
             static_cast<size_t>(kThreads) * s.vs +
             2 * static_cast<size_t>(kThreads) * per_thread) * sizeof(float);
  return s;
}

// Allow `bytes` of dynamic shared memory to the kernel, once per size
// above what was allowed before.
template <int D, int DPT>
cudaError_t allow(size_t bytes) {
  static size_t allowed = 48 * 1024;
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      threshold_ranges<D, DPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e == cudaSuccess) allowed = bytes;
  return e;
}

template <int D, int DPT>
cudaError_t run(const Args& a, int blocks, size_t bytes, cudaStream_t s) {
  const cudaError_t e = allow<D, DPT>(bytes);
  if (e != cudaSuccess) return e;
  threshold_ranges<D, DPT><<<blocks, kThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

template <int D, int DPT>
cudaError_t resident(size_t bytes, int* blocks) {
  const cudaError_t e = allow<D, DPT>(bytes);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, threshold_ranges<D, DPT>, kThreads, bytes);
}

bool valid(int d, int warps, int per_thread, int chunk) {
  return d > 0 && d <= 64 && chunk > 0 && chunk % kLabels == 0 &&
         chunk <= kThreads * kLabels &&
         (warps == 1 || warps == 2 || warps == 4 || warps == 8) &&
         (per_thread == 1 || ((d == 2 || d == 3) && per_thread == 4));
}

}  // namespace

// lo and hi for B instances: out holds lo (B, m) and then hi (B, m).  The
// split (warps a row group, directions a thread, rows a chunk, instances
// a block) is support_margin.ranges_occupancy's.
extern "C" int threshold_ranges_launch(const void* V, const void* X,
                                       const void* y, void* out, int B,
                                       int m, int n, int d, int warps,
                                       int per_thread, int chunk,
                                       int per_block, void* stream) {
  if (!valid(d, warps, per_thread, chunk) || per_block < 1 ||
      per_block > kMaxBatch || (per_block > 1 && n > chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh = shape_of(d, per_thread, chunk, per_block);
  const int tile_dirs = 32 * warps * per_thread;
  Args a;
  a.V = static_cast<const float*>(V);
  a.X = static_cast<const float*>(X);
  a.y = static_cast<const int*>(y);
  a.lo = static_cast<float*>(out);
  a.hi = a.lo + static_cast<size_t>(B) * m;
  a.B = B, a.m = m, a.n = n, a.d = d;
  a.groups = 8 / warps;
  a.gshift = __builtin_ctz(a.groups);
  a.tiles = (m + tile_dirs - 1) / tile_dirs;
  a.per_block = per_block;
  a.chunk = chunk, a.xs = sh.xs, a.vs = sh.vs;
  a.vec_labels = n % kLabels == 0 &&
                 reinterpret_cast<uintptr_t>(y) % 16 == 0;
  a.vec_out = m % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int blocks = (B + per_block - 1) / per_block * a.tiles;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (d == 2)
    e = per_thread == 4 ? run<2, 4>(a, blocks, sh.bytes, s)
                        : run<2, 1>(a, blocks, sh.bytes, s);
  else if (d == 3)
    e = per_thread == 4 ? run<3, 4>(a, blocks, sh.bytes, s)
                        : run<3, 1>(a, blocks, sh.bytes, s);
  else
    e = run<0, 1>(a, blocks, sh.bytes, s);
  return static_cast<int>(e);
}

// Blocks of the kernel for d and per_thread resident on one SM, with the
// shared memory of `per_block` buffers of `chunk` rows.
extern "C" int threshold_ranges_residency(int d, int per_thread, int chunk,
                                          int per_block, int* blocks) {
  if (!valid(d, 8, per_thread, chunk) || per_block < 1 ||
      per_block > kMaxBatch)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = shape_of(d, per_thread, chunk, per_block).bytes;
  cudaError_t e;
  if (d == 2)
    e = per_thread == 4 ? resident<2, 4>(bytes, blocks)
                        : resident<2, 1>(bytes, blocks);
  else if (d == 3)
    e = per_thread == 4 ? resident<3, 4>(bytes, blocks)
                        : resident<3, 1>(bytes, blocks);
  else
    e = resident<0, 1>(bytes, blocks);
  return static_cast<int>(e);
}

extern "C" const char* threshold_ranges_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
