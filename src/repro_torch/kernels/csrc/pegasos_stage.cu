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
// Rounding.  Every margin is ((x0*w0) + (x1*w1) + ...) + b left to right
// over d, each operation rounded (__fmul_rn/__fadd_rn; the library is
// also built with --fmad=false), as the plain PyTorch version forms it.
// The hinge gradient is summed per thread over rows t, t+kThreads, ...,
// then by warp shuffle-down and across the warps in order; the plain
// version (kernels/pegasos.py block_sum) spells out that same order, so
// every output agrees with it bit for bit.
//
// Bound on this card.  Per step every valid row costs 2d operations for
// its margin, one compare and, when it violates the hinge, 2d more for the
// gradient: about nsteps * N * (4d + 6) operations per instance, while X
// and y are read from device memory once and then stay in L1/L2 (a fit
// set is a few tens of KB).  So operations bound it.
//
// Design.  The TPU grid is (instance block, step, N tile) and carries w, b
// and the gradient accumulators across sequential grid steps in VMEM;
// Hopper runs blocks in no order.  So one block owns one instance for the
// whole stage and the step loop runs inside it: threads stride over the
// rows, each keeps its share of the (d+1)-vector sum(y*x), sum(y) over the
// violating rows in registers (features in chunks of kChunk, so any d
// works), the block reduces with warp shuffles and one shared-memory pass
// in a fixed order, one thread applies the update and the projection and
// publishes (w, b) in shared memory, and __syncthreads closes the step.
// An instance that enters latched with skip_latched set runs no steps:
// the solver throws its later iterates away.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;            // gradient features held per thread
constexpr float kBig = 1e30f;

__device__ __forceinline__ float margin(const float* __restrict__ x,
                                        const float* w, int d, float b,
                                        float yv) {
  float dec = __fmul_rn(x[0], w[0]);
  for (int i = 1; i < d; ++i) dec = __fadd_rn(dec, __fmul_rn(x[i], w[i]));
  return __fmul_rn(yv, __fadd_rn(dec, b));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

__global__ void pegasos_stage(
    const float* __restrict__ X, const float* __restrict__ y,
    const float* __restrict__ nv_in, const float* __restrict__ w_in,
    const float* __restrict__ b_in, const float* __restrict__ lam_in,
    const uint8_t* __restrict__ found_in, const float* __restrict__ wb_in,
    const float* __restrict__ bb_in, float* __restrict__ w_out,
    float* __restrict__ b_out, float* __restrict__ mmin_out,
    uint8_t* __restrict__ found_out, float* __restrict__ wb_out,
    float* __restrict__ bb_out, int N, int d, int nsteps, int skip_latched,
    float t0) {
  extern __shared__ float smem[];
  float* w_s = smem;                  // (d,) current iterate
  float* g_s = smem + d;              // (d,) reduced hinge gradient
  __shared__ float red[kWarps][kChunk + 1];
  __shared__ float b_s, gb_s;

  const int inst = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* Xi = X + static_cast<size_t>(inst) * N * d;
  const float* yi = y + static_cast<size_t>(inst) * N;
  const float lam = lam_in[inst];
  const float nv = nv_in[inst];
  const bool latched = found_in[inst] != 0;

  for (int i = tid; i < d; i += kThreads) w_s[i] = w_in[inst * d + i];
  if (tid == 0) b_s = b_in[inst];
  __syncthreads();

  const int steps = (skip_latched && latched) ? 0 : nsteps;
  for (int s = 0; s < steps; ++s) {
    const float b = b_s;
    for (int c0 = 0; c0 < d; c0 += kChunk) {
      float g[kChunk];
#pragma unroll
      for (int i = 0; i < kChunk; ++i) g[i] = 0.f;
      float gb = 0.f;
      for (int r = tid; r < N; r += kThreads) {
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
      gb = warp_sum(gb);
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < kChunk; ++i) red[warp][i] = g[i];
        red[warp][kChunk] = gb;
      }
      __syncthreads();
      if (tid <= kChunk && (tid == kChunk ? c0 == 0 : c0 + tid < d)) {
        float acc = red[0][tid];
        for (int k = 1; k < kWarps; ++k) acc = __fadd_rn(acc, red[k][tid]);
        if (tid == kChunk) gb_s = acc;
        else g_s[c0 + tid] = acc;
      }
      __syncthreads();
    }
    if (tid == 0) {
      const float c = __fadd_rn(__fadd_rn(static_cast<float>(s), 2.f), t0);
      const float eta = __fdiv_rn(1.f, __fmul_rn(lam, c));
      float nrm2 = 0.f;
      for (int i = 0; i < d; ++i) {
        const float gw = __fsub_rn(__fmul_rn(lam, w_s[i]),
                                   __fdiv_rn(g_s[i], nv));
        const float w2 = __fsub_rn(w_s[i], __fmul_rn(eta, gw));
        w_s[i] = w2;
        nrm2 = i == 0 ? __fmul_rn(w2, w2) : __fadd_rn(nrm2, __fmul_rn(w2, w2));
      }
      const float gbn = __fdiv_rn(-gb_s, nv);
      const float b2 = __fsub_rn(b, __fmul_rn(eta, gbn));
      const float scale = fminf(
          1.f, __fdiv_rn(__fdiv_rn(1.f, __fsqrt_rn(lam)),
                         __fadd_rn(__fsqrt_rn(nrm2), 1e-12f)));
      for (int i = 0; i < d; ++i) w_s[i] = __fmul_rn(w_s[i], scale);
      b_s = __fmul_rn(b2, scale);
    }
    __syncthreads();
  }

  // trailing min-margin scan, folded into the first-0-error latch
  const float b = b_s;
  float mm = kBig;
  for (int r = tid; r < N; r += kThreads) {
    const float yv = yi[r];
    if (yv != 0.f)
      mm = fminf(mm, margin(Xi + static_cast<size_t>(r) * d, w_s, d, b, yv));
  }
  mm = warp_min(mm);
  if (lane == 0) red[warp][0] = mm;
  __syncthreads();
  mm = red[0][0];
  for (int k = 1; k < kWarps; ++k) mm = fminf(mm, red[k][0]);
  const bool ok = mm > 0.f;
  const bool take = ok && !latched;
  if (tid == 0) {
    mmin_out[inst] = mm;
    found_out[inst] = (latched || ok) ? 1 : 0;
    b_out[inst] = b;
    bb_out[inst] = take ? b : bb_in[inst];
  }
  for (int i = tid; i < d; i += kThreads) {
    w_out[inst * d + i] = w_s[i];
    wb_out[inst * d + i] = take ? w_s[i] : wb_in[inst * d + i];
  }
}

}  // namespace

extern "C" int pegasos_stage_launch(
    const void* X, const void* y, const void* nv, const void* w,
    const void* b, const void* lam, const void* found, const void* w_best,
    const void* b_best, void* w_out, void* b_out, void* mmin_out,
    void* found_out, void* wb_out, void* bb_out, int B, int N, int d,
    int nsteps, int skip_latched, float t0, void* stream) {
  // w and its gradient in dynamic shared memory; the wrapper keeps
  // d <= 4096, so this stays under the default 48 KB
  const size_t smem = 2 * static_cast<size_t>(d) * sizeof(float);
  pegasos_stage<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(X), static_cast<const float*>(y),
      static_cast<const float*>(nv), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<const float*>(lam),
      static_cast<const uint8_t*>(found), static_cast<const float*>(w_best),
      static_cast<const float*>(b_best), static_cast<float*>(w_out),
      static_cast<float*>(b_out), static_cast<float*>(mmin_out),
      static_cast<uint8_t*>(found_out), static_cast<float*>(wb_out),
      static_cast<float*>(bb_out), N, d, nsteps, skip_latched, t0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pegasos_stage_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
