// RWKV-6 (Finch) WKV recurrence, hand-written for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6.py rwkv6_chunked (body
// _rwkv6_kernel).  For r, k, v, w (B, S, H, hd) and u (H, hd), all float
// and contiguous, it runs the recurrence of the JAX package's oracle
// ref.rwkv6_ref, one step per token, from the state S0 (B, H, hd, hd)
// (zeros when none is given):
//     kv[i][j] = k_t[i] v_t[j]
//     y_t[j]   = sum_i r_t[i] (S[i][j] + u[i] kv[i][j])
//     S[i][j]  = w_t[i] S[i][j] + kv[i][j]
// and writes y (B, S, H, hd) and the final state (B, H, hd, hd), both
// float.  The state may be read from and written to the same buffer: the
// serving caches are updated in place.
//
// Arithmetic.  The library is built with --fmad=false; every product and
// sum here rounds once (__fmul_rn / __fadd_rn) in the oracle's order, so
// the state follows the plain version (kernels/rwkv6.py rwkv6_plain)
// bit for bit.  Only y's dot over i is fused (__fmaf_rn) and summed in
// another order than the plain version's einsum: y agrees to float
// rounding, not bit for bit.
//
// Bound on this card.  A call reads r, k, v, w once and writes y and the
// state once: at rwkv6-7b's scoring shape (B=8, S=2048, H=64, hd=64) that
// is 1.35 GB, 0.40 ms at 3.35 TB/s.  The function needs 5 operations per
// (step, i, j) (r S summed; w S + k v) and 5 per (step, j), the bonus term
// factoring as v_j sum_i r_i u_i k_i: 2.2e10 in all, 0.33 ms at 67
// TFLOP/s f32.  So the bytes bound it, at about 0.40 ms.  (This kernel
// forms u kv per (i, j), 7 operations; the bound counts the function.)
//
// Design.  The classic sequential GPU form, not the TPU's chunked closed
// form (three matrix products a chunk on the MXU): one block per (head,
// batch row), one thread per value column j, which keeps its column
// S[:, j] (hd floats) in registers for the whole call.  A chunk of kChunk
// steps of r, k, w and v is staged in shared memory by coalesced loads
// (one latency a chunk, not a step); each thread then walks the chunk,
// reading r_t, k_t, w_t and u as float4 broadcasts, and writes y_t[j]
// (coalesced over j).  y's dot over i runs in four partial sums to shorten
// the dependency chain.  What holds it back: B·H blocks of hd threads
// (512 blocks of 64 at the scoring shape) leave most of each SM's warp
// slots empty, so each step's latency is exposed and neither the memory
// nor the CUDA cores are kept busy.  The redesign: the chunked form on
// wgmma (intra-chunk products as a masked matrix product, the state
// carried between chunks) to fill the card, and bf16 r, k, v, w to halve
// the bytes that bound it.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 32;   // steps staged in shared memory at a time

template <int HD>
__global__ void __launch_bounds__(HD)
    rwkv6_wkv(const float* __restrict__ r, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ w,
              const float* __restrict__ u, const float* s0, float* y,
              float* sT, int S, int H) {
  __shared__ __align__(16) float sr[kChunk][HD];
  __shared__ __align__(16) float sk[kChunk][HD];
  __shared__ __align__(16) float sw[kChunk][HD];
  __shared__ __align__(16) float sv[kChunk][HD];
  __shared__ __align__(16) float su[HD];

  const int j = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t state_off = (static_cast<size_t>(b) * H + h) * HD * HD;

  float st[HD];  // S[:, j]
#pragma unroll
  for (int i = 0; i < HD; ++i)
    st[i] = s0 != nullptr ? s0[state_off + static_cast<size_t>(i) * HD + j]
                          : 0.0f;
  su[j] = u[h * HD + j];

  const size_t step = static_cast<size_t>(H) * HD;  // stride of one token
  const size_t base = (static_cast<size_t>(b) * S * H + h) * HD;
  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int n = min(kChunk, S - t0);
    __syncthreads();  // the previous chunk is consumed
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      const size_t off = base + static_cast<size_t>(t0 + t) * step + j;
      sr[t][j] = r[off];
      sk[t][j] = k[off];
      sw[t][j] = w[off];
      sv[t][j] = v[off];
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float vj = sv[t][j];
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < HD; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&sr[t][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&sk[t][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&sw[t][i]);
        const float4 u4 = *reinterpret_cast<const float4*>(&su[i]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
        const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float kv = __fmul_rn(kk[q], vj);
          const float term = __fadd_rn(st[i + q], __fmul_rn(uu[q], kv));
          acc[q] = __fmaf_rn(rr[q], term, acc[q]);
          st[i + q] = __fadd_rn(__fmul_rn(ww[q], st[i + q]), kv);
        }
      }
      y[base + static_cast<size_t>(t0 + t) * step + j] =
          __fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[2], acc[3]));
    }
  }
#pragma unroll
  for (int i = 0; i < HD; ++i)
    sT[state_off + static_cast<size_t>(i) * HD + j] = st[i];
}

template <int HD>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* y, float* sT, int B, int S,
           int H, cudaStream_t stream) {
  const dim3 grid(H, B);
  rwkv6_wkv<HD><<<grid, HD, 0, stream>>>(r, k, v, w, u, s0, y, sT, S, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// s0 may be null (a zero initial state) and may equal sT (in place).
extern "C" int rwkv6_launch(const void* r, const void* k, const void* v,
                            const void* w, const void* u, const void* s0,
                            void* y, void* sT, int B, int S, int H, int hd,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* args[] = {static_cast<const float*>(r),
                         static_cast<const float*>(k),
                         static_cast<const float*>(v),
                         static_cast<const float*>(w),
                         static_cast<const float*>(u),
                         static_cast<const float*>(s0)};
  switch (hd) {
    case 32:
      return launch<32>(args[0], args[1], args[2], args[3], args[4], args[5],
                        static_cast<float*>(y), static_cast<float*>(sT), B, S,
                        H, s);
    case 64:
      return launch<64>(args[0], args[1], args[2], args[3], args[4], args[5],
                        static_cast<float*>(y), static_cast<float*>(sT), B, S,
                        H, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* rwkv6_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
