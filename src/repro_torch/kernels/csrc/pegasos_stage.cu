// One λ stage of the batched Pegasos solver (the MAXMARG refit), written
// by hand for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/pegasos.py
// (pegasos_stage_batched, body _pegasos_stage_kernel).  For every instance
// it runs nsteps masked hinge-gradient updates of (w, b) with step size
// 1/(lam*(s+2+t0)), each followed by the projection onto the ball of radius
// 1/sqrt(lam); then the min functional margin over the valid rows (1e30
// where there are none) is folded into the first-0-error latch:
// ok = mmin > 0, take = ok & !found, found |= ok, (w_best, b_best) = (w, b)
// where take.  Label-0 rows are inert and the gradient is normalised by the
// caller's valid count nv.
//
// Rounding.  Every margin is y (((x0*w0) + (x1*w1) + ...) + b) left to
// right over d, each operation rounded (__fmul_rn/__fadd_rn; the library
// is also built with --fmad=false), as the plain PyTorch version forms it
// (stage_small forms the same value from z = y x; see there).  Lane l of
// an instance's warp sums the hinge gradient over rows l, l+32, ... onto
// 0, then the lanes fold by xor shuffles at offsets 16, 8, 4, 2, 1.  A
// float sum is commutative, so after the fold every lane holds the value
// that lane 0 of a shuffle-down fold holds; the plain version
// (kernels/pegasos.py block_sum) spells out that order.  Divisions and
// square roots are correctly rounded (div_nv, __fdiv_rn, __fsqrt_rn) and
// 1/sqrt(lam) is formed once per stage, as the plain version forms it, so
// every output agrees with it bit for bit.
//
// Bound on this card.  Per step every valid row costs 2d operations for
// its margin, one compare and, when it violates the hinge, 2d more for the
// gradient: about nsteps * N * (4d + 6) operations per instance, while X
// and y are read from device memory once (a fit set is a few tens of KB).
// So operations bound it: 0.21 ms at the MAXMARG turn-1 shape (B=1152,
// N=1008, d=2, nsteps=2000).  A step of one instance is a dependent chain
// (its margins need the last step's w).
//
// Design.  The TPU grid is (instance block, step, N tile) and carries w, b
// and the gradient accumulators across sequential grid steps in VMEM.
// Here one warp owns one instance for the whole stage, kWarps instances a
// block, and no step takes a block barrier.  For d <= kSmallD (templated
// on d) w, b and the gradient live in registers and, where (d + 1) rows'
// worth fit in kRowRegs registers (8 to 48 rows a lane: N <= 1536 at
// d = 2, N <= 256 at d = 16), so do the lane's rows, read once; the d + 1
// live sums reduce by xor shuffles, and every lane applies the same update
// to its own copy of (w, b): no shared memory and no barrier a step.  The
// gradient adds are predicated on the hinge test, and the divisions by nv
// take a precomputed reciprocal and one correction (div_nv), not
// __fdiv_rn, whose branches would serialise the step's chain.  Larger N
// reads the rows from device memory (L1) each step; larger d (the wrapper
// allows 4096) keeps w and the reduced gradient in the warp's slice of
// shared memory, sums the gradient in chunks of kChunk features, and lane
// 0 applies the update between two __syncwarp.  An instance that enters
// latched with skip_latched set runs no steps: the solver throws its
// later iterates away.
//
// What holds it back now.  1152 instances on 132 SMs are about 2 warps on
// each of an SM's 4 schedulers, too few to hide a step's chain: the
// 5-level shuffle fold of d + 1 sums, then the update's division by
// lam*c, square root and division for the projection; a step with 2
// rows a lane is not much shorter than one with 32.  Splitting an
// instance over 2 warps (a named barrier a step) is the next step; it
// changes the reduction order, and the plain version with it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;          // lanes per instance: one warp
constexpr int kWarps = 4;             // instances per block
constexpr int kSmallD = 16;           // w and gradient in registers up to here
constexpr int kChunk = 16;            // gradient features a pass (larger d)
constexpr int kRowRegs = 144;        // registers a lane may give its rows
constexpr float kBig = 1e30f;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kAll, v, off));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(kAll, v, off));
  return v;
}

// x / nv for nv >= 1, correctly rounded, without the branches of
// __fdiv_rn (which serialise a step's critical path): q = RN(x r) with r =
// RN(1/nv), then one correction q + RN(x - nv q) r, which is RN(x / nv) by
// Markstein's theorem while the quotient stays out of the subnormal range
// (a gradient sum over a fit set, divided by its row count).  +-0 / nv is
// +-0 and is returned as it is.
__device__ __forceinline__ float div_nv(float x, float nv, float rnv) {
  const float q = __fmul_rn(x, rnv);
  const float q1 = __fmaf_rn(__fmaf_rn(-nv, q, x), rnv, q);
  return x == 0.f ? x : q1;
}

struct Stage {
  const float* X;          // (B, N, d)
  const float* y;          // (B, N)
  const float* nv;
  const float* w_in;
  const float* b_in;
  const float* lam;
  const uint8_t* found_in;
  const float* wb_in;
  const float* bb_in;
  float* w_out;
  float* b_out;
  float* mmin_out;
  uint8_t* found_out;
  float* wb_out;
  float* bb_out;
  int B, N, d, nsteps, skip_latched;
  float t0;
};

// the latch and the outputs of one instance, from lane 0
__device__ __forceinline__ void emit_scalars(const Stage& p, int inst,
                                             float mm, float b, bool latched,
                                             bool take) {
  p.mmin_out[inst] = mm;
  p.found_out[inst] = (latched || mm > 0.f) ? 1 : 0;
  p.b_out[inst] = b;
  p.bb_out[inst] = take ? b : p.bb_in[inst];
}

// d = D <= kSmallD: w, b and the gradient in registers, and with RPL > 0
// the lane's rows too (lane + 32 k for k < RPL; rows past N read as label
// 0); RPL == 0 reads the rows from device memory (cached in L1) each step.
// A row is held as z = y x and y.  With y = +-1 every product, sum and
// rounding of the margin only changes sign (round to nearest is
// symmetric), so y ((x0*w0 + x1*w1 + ...) + b) = (z0*w0 + z1*w1 + ...) +
// y b, where y b = +-b is exact and the last addition may be one fused
// multiply-add; y = 0 gives 0 either way.  The hinge gradient y x of a
// violating row is z.
template <int D, int RPL>
__global__ void __launch_bounds__(kWarps * kThreads) stage_small(Stage p) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int inst = blockIdx.x * kWarps + warp;
  if (inst >= p.B) return;             // no block barrier follows
  const int N = p.N;
  const float* Xg = p.X + static_cast<size_t>(inst) * N * D;
  const float* yg = p.y + static_cast<size_t>(inst) * N;
  constexpr int K = RPL > 0 ? RPL : 1;
  float zk[K][D], yk[K];
  if constexpr (RPL > 0) {
#pragma unroll
    for (int k = 0; k < RPL; ++k) {
      const int r = lane + 32 * k;
      yk[k] = r < N ? yg[r] : 0.f;
#pragma unroll
      for (int i = 0; i < D; ++i)
        zk[k][i] = __fmul_rn(yk[k], r < N ? Xg[r * D + i] : 0.f);
    }
  }

  const float lam = p.lam[inst];
  const float nv = p.nv[inst];
  const bool latched = p.found_in[inst] != 0;
  const float inv_sqrt_lam = __fdiv_rn(1.f, __fsqrt_rn(lam));
  const float rnv = __frcp_rn(nv);
  float w[D];
#pragma unroll
  for (int i = 0; i < D; ++i) w[i] = p.w_in[inst * D + i];
  float b = p.b_in[inst];

  // the margin y ((x0*w0 + x1*w1 + ...) + b) of the row (z, y)
  auto margin_of = [&](const float (&z)[D], float yv) {
    float dec = __fmul_rn(z[0], w[0]);
#pragma unroll
    for (int i = 1; i < D; ++i) dec = __fadd_rn(dec, __fmul_rn(z[i], w[i]));
    return __fmaf_rn(yv, b, dec);
  };
  // (z, y) of row r read from device memory
  auto load_row = [&](int r, float (&z)[D]) {
    const float yv = yg[r];
#pragma unroll
    for (int i = 0; i < D; ++i) z[i] = __fmul_rn(yv, Xg[r * D + i]);
    return yv;
  };

  const int steps = (p.skip_latched && latched) ? 0 : p.nsteps;
  for (int s = 0; s < steps; ++s) {
    // the step size needs no row: formed first, off the step's chain
    const float c = __fadd_rn(__fadd_rn(static_cast<float>(s), 2.f), p.t0);
    const float eta = __fdiv_rn(1.f, __fmul_rn(lam, c));
    float g[D];
#pragma unroll
    for (int i = 0; i < D; ++i) g[i] = 0.f;
    float gb = 0.f;
    // a violating row adds (z, y); a label-0 row's margin is 0, so it
    // "violates" and adds (+-0, 0), which leaves every sum as it is (a sum
    // started at +0 is never -0)
    auto add_row = [&](const float (&z)[D], float yv) {
      if (margin_of(z, yv) < 1.f) {
#pragma unroll
        for (int i = 0; i < D; ++i) g[i] = __fadd_rn(g[i], z[i]);
        gb = __fadd_rn(gb, yv);
      }
    };
    if constexpr (RPL > 0) {
#pragma unroll
      for (int k = 0; k < RPL; ++k) add_row(zk[k], yk[k]);
    } else {
#pragma unroll 4
      for (int r = lane; r < N; r += 32) {
        float z[D];
        const float yv = load_row(r, z);
        add_row(z, yv);
      }
    }
#pragma unroll
    for (int i = 0; i < D; ++i) g[i] = warp_sum(g[i]);
    gb = warp_sum(gb);
    // every lane: the same inputs, the same roundings, the same (w, b)
    float nrm2 = 0.f;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const float gw = __fsub_rn(__fmul_rn(lam, w[i]), div_nv(g[i], nv, rnv));
      w[i] = __fsub_rn(w[i], __fmul_rn(eta, gw));
      nrm2 = i == 0 ? __fmul_rn(w[i], w[i])
                    : __fadd_rn(nrm2, __fmul_rn(w[i], w[i]));
    }
    const float b2 = __fsub_rn(b, __fmul_rn(eta, div_nv(-gb, nv, rnv)));
    const float scale = fminf(
        1.f, __fdiv_rn(inv_sqrt_lam, __fadd_rn(__fsqrt_rn(nrm2), 1e-12f)));
#pragma unroll
    for (int i = 0; i < D; ++i) w[i] = __fmul_rn(w[i], scale);
    b = __fmul_rn(b2, scale);
  }

  // trailing min-margin scan, folded into the first-0-error latch
  float mm = kBig;
  if constexpr (RPL > 0) {
#pragma unroll
    for (int k = 0; k < RPL; ++k)
      if (yk[k] != 0.f) mm = fminf(mm, margin_of(zk[k], yk[k]));
  } else {
    for (int r = lane; r < N; r += 32) {
      float z[D];
      const float yv = load_row(r, z);
      if (yv != 0.f) mm = fminf(mm, margin_of(z, yv));
    }
  }
  mm = warp_min(mm);
  const bool take = mm > 0.f && !latched;
  if (lane == 0) {
    emit_scalars(p, inst, mm, b, latched, take);
#pragma unroll
    for (int i = 0; i < D; ++i) {
      p.w_out[inst * D + i] = w[i];
      p.wb_out[inst * D + i] = take ? w[i] : p.wb_in[inst * D + i];
    }
  }
}

__device__ __forceinline__ float margin(const float* __restrict__ x,
                                        const float* w, int d, float b,
                                        float yv) {
  float dec = __fmul_rn(x[0], w[0]);
  for (int i = 1; i < d; ++i) dec = __fadd_rn(dec, __fmul_rn(x[i], w[i]));
  return __fmul_rn(yv, __fadd_rn(dec, b));
}

// d > kSmallD: w and the reduced gradient in the warp's shared memory
__global__ void __launch_bounds__(kWarps * kThreads) stage_wide(Stage p) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int inst = blockIdx.x * kWarps + warp;
  if (inst >= p.B) return;
  const int N = p.N, d = p.d;
  float* w_s = smem + static_cast<size_t>(warp) * 2 * d;   // (d,) iterate
  float* g_s = w_s + d;                                    // (d,) gradient
  const float* Xi = p.X + static_cast<size_t>(inst) * N * d;
  const float* yi = p.y + static_cast<size_t>(inst) * N;
  const float lam = p.lam[inst];
  const float nv = p.nv[inst];
  const bool latched = p.found_in[inst] != 0;
  const float inv_sqrt_lam = __fdiv_rn(1.f, __fsqrt_rn(lam));
  const float rnv = __frcp_rn(nv);
  for (int i = lane; i < d; i += 32) w_s[i] = p.w_in[inst * d + i];
  float b = p.b_in[inst];
  __syncwarp();

  const int steps = (p.skip_latched && latched) ? 0 : p.nsteps;
  for (int s = 0; s < steps; ++s) {
    float gb_total = 0.f;
    for (int c0 = 0; c0 < d; c0 += kChunk) {
      float g[kChunk];
#pragma unroll
      for (int i = 0; i < kChunk; ++i) g[i] = 0.f;
      float gb = 0.f;
      for (int r = lane; r < N; r += 32) {
        const float yv = yi[r];
        if (yv == 0.f) continue;
        const float* x = Xi + static_cast<size_t>(r) * d;
        if (margin(x, w_s, d, b, yv) < 1.f) {   // hinge violated: vy = y
#pragma unroll
          for (int i = 0; i < kChunk; ++i)
            if (c0 + i < d) g[i] = __fadd_rn(g[i], __fmul_rn(yv, x[c0 + i]));
          gb = __fadd_rn(gb, yv);
        }
      }
#pragma unroll
      for (int i = 0; i < kChunk; ++i) g[i] = warp_sum(g[i]);
      if (c0 == 0) gb_total = warp_sum(gb);
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < kChunk; ++i)
          if (c0 + i < d) g_s[c0 + i] = g[i];
      }
    }
    __syncwarp();                      // every lane is done reading w_s
    if (lane == 0) {
      const float c = __fadd_rn(__fadd_rn(static_cast<float>(s), 2.f), p.t0);
      const float eta = __fdiv_rn(1.f, __fmul_rn(lam, c));
      float nrm2 = 0.f;
      for (int i = 0; i < d; ++i) {
        const float gw = __fsub_rn(__fmul_rn(lam, w_s[i]),
                                   div_nv(g_s[i], nv, rnv));
        const float w2 = __fsub_rn(w_s[i], __fmul_rn(eta, gw));
        w_s[i] = w2;
        nrm2 = i == 0 ? __fmul_rn(w2, w2) : __fadd_rn(nrm2, __fmul_rn(w2, w2));
      }
      const float b2 = __fsub_rn(b, __fmul_rn(eta, div_nv(-gb_total, nv, rnv)));
      const float scale = fminf(
          1.f, __fdiv_rn(inv_sqrt_lam, __fadd_rn(__fsqrt_rn(nrm2), 1e-12f)));
      for (int i = 0; i < d; ++i) w_s[i] = __fmul_rn(w_s[i], scale);
      b = __fmul_rn(b2, scale);
    }
    b = __shfl_sync(kAll, b, 0);
    __syncwarp();                      // w_s is the new iterate
  }

  float mm = kBig;
  for (int r = lane; r < N; r += 32) {
    const float yv = yi[r];
    if (yv != 0.f)
      mm = fminf(mm, margin(Xi + static_cast<size_t>(r) * d, w_s, d, b, yv));
  }
  mm = warp_min(mm);
  const bool take = mm > 0.f && !latched;
  if (lane == 0) emit_scalars(p, inst, mm, b, latched, take);
  for (int i = lane; i < d; i += 32) {
    p.w_out[inst * d + i] = w_s[i];
    p.wb_out[inst * d + i] = take ? w_s[i] : p.wb_in[inst * d + i];
  }
}

template <typename K>
int launch(K kernel, const Stage& p, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (p.B + kWarps - 1) / kWarps;
  kernel<<<blocks, kWarps * kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the rows a lane holds in registers: the fewest of 8, 16, 32, 48, 64
// that cover N, while (D + 1) x RPL stays within kRowRegs; else 0 (device
// memory)
template <int D, int RPL>
int launch_rows(const Stage& p, cudaStream_t stream) {
  if constexpr (RPL > 64 || (D + 1) * RPL > kRowRegs) {
    return launch(stage_small<D, 0>, p, 0, stream);
  } else {
    if (p.N <= 32 * RPL) return launch(stage_small<D, RPL>, p, 0, stream);
    return launch_rows<D, RPL < 32 ? 2 * RPL : RPL + 16>(p, stream);
  }
}

template <int D>
int launch_small(const Stage& p, cudaStream_t stream) {
  static_assert(D <= kSmallD, "larger d takes stage_wide");
  return launch_rows<D, 8>(p, stream);
}

}  // namespace

extern "C" int pegasos_stage_launch(
    const void* X, const void* y, const void* nv, const void* w,
    const void* b, const void* lam, const void* found, const void* w_best,
    const void* b_best, void* w_out, void* b_out, void* mmin_out,
    void* found_out, void* wb_out, void* bb_out, int B, int N, int d,
    int nsteps, int skip_latched, float t0, void* stream) {
  Stage p{static_cast<const float*>(X), static_cast<const float*>(y),
          static_cast<const float*>(nv), static_cast<const float*>(w),
          static_cast<const float*>(b), static_cast<const float*>(lam),
          static_cast<const uint8_t*>(found),
          static_cast<const float*>(w_best),
          static_cast<const float*>(b_best), static_cast<float*>(w_out),
          static_cast<float*>(b_out), static_cast<float*>(mmin_out),
          static_cast<uint8_t*>(found_out), static_cast<float*>(wb_out),
          static_cast<float*>(bb_out), B, N, d, nsteps, skip_latched, t0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
#define PEGASOS_SMALL(D) \
  case D:                \
    return launch_small<D>(p, s);
    PEGASOS_SMALL(1) PEGASOS_SMALL(2) PEGASOS_SMALL(3) PEGASOS_SMALL(4)
    PEGASOS_SMALL(5) PEGASOS_SMALL(6) PEGASOS_SMALL(7) PEGASOS_SMALL(8)
    PEGASOS_SMALL(9) PEGASOS_SMALL(10) PEGASOS_SMALL(11) PEGASOS_SMALL(12)
    PEGASOS_SMALL(13) PEGASOS_SMALL(14) PEGASOS_SMALL(15) PEGASOS_SMALL(16)
#undef PEGASOS_SMALL
    default:
      // the wrapper keeps d <= 4096: w and its gradient, 8 bytes a feature
      // for each of the block's warps, stay under 128 KB
      return launch(stage_wide, p, static_cast<size_t>(kWarps) * 2 * d * 4,
                    s);
  }
}

extern "C" const char* pegasos_stage_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
