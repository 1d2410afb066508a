// RWKV-6 (Finch) WKV recurrence, hand-written for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6.py rwkv6_chunked (body
// _rwkv6_kernel).  For r, k, v (B, S, H, hd) in float or bf16, w
// (B, S, H, hd) and u (H, hd) in float, all contiguous, it runs the
// recurrence of the JAX package's oracle ref.rwkv6_ref, one step per token,
// from the state S0 (B, H, hd, hd) (zeros when none is given):
//     kv[i][j] = k_t[i] v_t[j]
//     y_t[j]   = sum_i r_t[i] (S[i][j] + u[i] kv[i][j])
//     S[i][j]  = w_t[i] S[i][j] + kv[i][j]
// and writes y (B, S, H, hd) and the final state (B, H, hd, hd), both
// float.  bf16 inputs are converted to float exactly, in shared memory, so
// both input types compute the same function as their float values do.
// The state may be read from and written to the same buffer: the serving
// caches are updated in place.
//
// Arithmetic.  The library is built with --fmad=false; the state update
// rounds each product and sum once (__fmul_rn / __fadd_rn) in the
// oracle's order, so the state follows the plain version
// (kernels/rwkv6.py rwkv6_plain) bit for bit.  y is factored as
//     y_t[j] = sum_i r_t[i] S[i][j] + v_t[j] c_t,
//     c_t = sum_i r_t[i] u[i] k_t[i]
// with the dot over i fused (__fmaf_rn), split over lanes and the lanes'
// sums added in lane order: it agrees with the plain version's einsum to
// float rounding, not bit for bit.
//
// Bound on this card.  A call reads r, k, v, w once and writes y and the
// state once: at rwkv6-7b's scoring shape (B=8, S=2048, H=64, hd=64) with
// bf16 r, k, v, as the model passes them, that is 0.94 GB, 0.28 ms at
// 3.35 TB/s (1.35 GB, 0.40 ms in float).  The function needs 5 operations
// per (step, i, j) (r S summed; w S + k v) and 5 per (step, j): 2.2e10,
// 0.33 ms at 67 TFLOP/s f32.  So the operations bound it in bf16, the
// bytes in float.  In issue slots the factored form takes 4 instructions
// per (step, i, j): one FMA of r S, and k v, w S and their sum; at one
// instruction a clock on each of the card's 528 schedulers that is
// 0.51 ms.  At decode (S=1) the state's read and write are the bound.
//
// Design.  The sequential GPU form, not the TPU's chunked closed form
// (three matrix products a chunk on the MXU, which on the tensor cores
// would take TF32 and lose the state's bit-for-bit agreement): one block
// per (head, batch row) for the whole sequence, the state in registers.
// What limits it is shared memory, not arithmetic: a block's threads all
// read r, k and w of their rows every step, and the SM's shared memory
// serves 128 bytes a clock against 4 warp instructions issued.
//   - A lane holds a 16 x 4 tile of S (kLanes = 4 lanes share a group of
//     kCols = 4 value columns, each lane interleaved 4-row groups, so the
//     lanes' 16-byte loads fall in distinct banks): its r, k, w loads (48
//     floats a step) serve 64 state elements, and the 4 columns of v and y
//     move as one 16-byte vector.  That is 64 threads a block at hd 64;
//     one column a lane (4x the warps) spent more time waiting on shared
//     memory than it gained in warps.
//   - The bonus term is one number a step: c_t is reduced once per step,
//     8 rows a thread, in the same pass over the landed chunk that widens
//     bf16 r, k, v to float (once per block, not once per column).
//   - The lanes' partial y go to shared memory each step (one 16-byte
//     store, no shuffles in the step loop); after the chunk all threads sum
//     them, add v_j c_t and write y coalesced.
//   - Chunks of kChunk steps are double-buffered in shared memory with
//     16-byte cp.async: the (chunk, hd) slab of one head is kChunk rows of
//     stride H*hd, and chunk c+1 is in flight while chunk c is consumed.
//     The step loop is unrolled twice so one step's loads overlap the last
//     one's arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kLanes = 4;    // lanes sharing one value column's rows
constexpr int kCols = 4;     // value columns a lane holds
constexpr int kChunk = 16;   // steps a shared-memory stage

__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&f)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 g =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[q]));
    f[2 * q] = g.x;
    f[2 * q + 1] = g.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float (&f)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(f[4], f[5], f[6], f[7]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// kCols consecutive floats of a row, moved as one vector
struct alignas(4 * kCols) Cols {
  float f[kCols];
};

template <typename T, int HD>
struct Stage {
  static constexpr bool kWiden = !std::is_same<T, float>::value;
  alignas(16) T r[2][kChunk][HD];
  alignas(16) T k[2][kChunk][HD];
  alignas(16) T v[2][kChunk][HD];
  alignas(16) float w[2][kChunk][HD];
  // bf16: the current chunk's r, k, v widened to float
  alignas(16) float fr[kWiden ? kChunk : 1][HD];
  alignas(16) float fk[kWiden ? kChunk : 1][HD];
  alignas(16) float fv[kWiden ? kChunk : 1][HD];
  float bonus[kChunk];
  // per step, lane share and column: partial y (rows padded by 8 floats so
  // the lanes' 16-byte stores fall in distinct banks)
  alignas(16) float part[kChunk][kLanes][HD + 8];
};

// Start the copies of `rows` steps, from element offset `at`, into stage s.
template <typename T, int HD, int NT>
__device__ __forceinline__ void issue(Stage<T, HD>& sm, int s,
                                      const T* __restrict__ r,
                                      const T* __restrict__ k,
                                      const T* __restrict__ v,
                                      const float* __restrict__ w, size_t at,
                                      size_t step, int rows, int tid) {
  constexpr int ET = 16 / static_cast<int>(sizeof(T));   // elements a copy
  constexpr int PT = HD / ET;                             // copies a row
  for (int p = tid; p < rows * PT; p += NT) {
    const int t = p / PT, c = (p % PT) * ET;
    const size_t off = at + t * step + c;
    cp_async16(&sm.r[s][t][c], r + off);
    cp_async16(&sm.k[s][t][c], k + off);
    cp_async16(&sm.v[s][t][c], v + off);
  }
  for (int p = tid; p < rows * (HD / 4); p += NT) {
    const int t = p / (HD / 4), c = (p % (HD / 4)) * 4;
    cp_async16(&sm.w[s][t][c], w + at + t * step + c);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD / kCols * kLanes)
    rwkv6_wkv(const T* __restrict__ r, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ w,
              const float* __restrict__ u, const float* s0, float* y,
              float* sT, int S, int H) {
  constexpr int NT = HD / kCols * kLanes;
  constexpr int NG = HD / 4 / kLanes;   // 4-row groups a thread holds
  constexpr int PR = HD / 8;            // 8-row pieces of a row
  constexpr bool kWiden = Stage<T, HD>::kWiden;
  static_assert(NG >= 1 && NT % 32 == 0 && NT % PR == 0 &&
                    kChunk * PR % NT == 0,
                "head width");
  extern __shared__ __align__(16) unsigned char smem[];
  Stage<T, HD>& sm = *reinterpret_cast<Stage<T, HD>*>(smem);

  const int tid = threadIdx.x;
  const int j0 = tid / kLanes * kCols;   // first of this lane's columns
  const int l = tid % kLanes;            // share of their rows
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t step = static_cast<size_t>(H) * HD;   // stride of one token
  const size_t base = (static_cast<size_t>(b) * S * H + h) * HD;
  const size_t state_off = (static_cast<size_t>(b) * H + h) * HD * HD;
  const int chunks = (S + kChunk - 1) / kChunk;

  issue<T, HD, NT>(sm, 0, r, k, v, w, base, step, min(kChunk, S), tid);

  float st[4 * NG][kCols];   // S[i][j0 + c] for this lane's rows i
#pragma unroll
  for (int q = 0; q < NG; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * (q * kLanes + l) + e;
      Cols row{};
      if (s0 != nullptr)
        row = *reinterpret_cast<const Cols*>(
            s0 + state_off + static_cast<size_t>(i) * HD + j0);
#pragma unroll
      for (int c = 0; c < kCols; ++c) st[4 * q + e][c] = row.f[c];
    }
  const int e0 = tid % PR * 8;   // this thread's 8 rows in the chunk pass
  float ub[8];
#pragma unroll
  for (int x = 0; x < 8; ++x) ub[x] = u[h * HD + e0 + x];

  for (int ch = 0; ch < chunks; ++ch) {
    const int t0 = ch * kChunk;
    const int n = min(kChunk, S - t0);
    const int s = ch & 1;
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();   // chunk ch has landed; chunk ch-1 is consumed
    if (ch + 1 < chunks)
      issue<T, HD, NT>(sm, s ^ 1, r, k, v, w,
                       base + static_cast<size_t>(t0 + kChunk) * step, step,
                       min(kChunk, S - t0 - kChunk), tid);
    // one pass over the landed chunk, 8 rows of a step a thread: widen
    // bf16 r, k, v into float, and reduce the bonus
    // c_t = sum_i (r_t[i] u[i]) k_t[i], folded over a step's PR threads
#pragma unroll
    for (int it = 0; it < kChunk * PR / NT; ++it) {
      const int t = (tid + it * NT) / PR;
      float rr[8], kk[8];
      load8(sm.r[s][t] + e0, rr);
      load8(sm.k[s][t] + e0, kk);
      if constexpr (kWiden) {
        float vv[8];
        load8(sm.v[s][t] + e0, vv);
        store8(sm.fr[t] + e0, rr);
        store8(sm.fk[t] + e0, kk);
        store8(sm.fv[t] + e0, vv);
      }
      float part = 0.0f;
#pragma unroll
      for (int x = 0; x < 8; ++x)
        part = __fadd_rn(part, __fmul_rn(__fmul_rn(rr[x], ub[x]), kk[x]));
#pragma unroll
      for (int off = 1; off < PR; off <<= 1)
        part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, off));
      if (t < n && e0 == 0) sm.bonus[t] = part;
    }
    __syncthreads();

#pragma unroll 2
    for (int t = 0; t < n; ++t) {
      const float* rt;
      const float* kt;
      const float* vt;
      if constexpr (kWiden) {
        rt = sm.fr[t];
        kt = sm.fk[t];
        vt = sm.fv[t];
      } else {
        rt = sm.r[s][t];
        kt = sm.k[s][t];
        vt = sm.v[s][t];
      }
      const float* wt = sm.w[s][t];
      const Cols vc = *reinterpret_cast<const Cols*>(vt + j0);
      const float* vj = vc.f;
      float acc[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] = 0.0f;
#pragma unroll
      for (int q = 0; q < NG; ++q) {
        const int g = 4 * (q * kLanes + l);
        const float4 r4 = *reinterpret_cast<const float4*>(rt + g);
        const float4 k4 = *reinterpret_cast<const float4*>(kt + g);
        const float4 w4 = *reinterpret_cast<const float4*>(wt + g);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            float& sij = st[4 * q + e][c];
            acc[c] = __fmaf_rn(rr[e], sij, acc[c]);
            const float kv = __fmul_rn(kk[e], vj[c]);
            sij = __fadd_rn(__fmul_rn(ww[e], sij), kv);
          }
      }
      Cols part;
#pragma unroll
      for (int c = 0; c < kCols; ++c) part.f[c] = acc[c];
      *reinterpret_cast<Cols*>(&sm.part[t][l][j0]) = part;
    }
    __syncthreads();
    // the chunk's y: the lanes' partial sums over rows, then the bonus,
    // four columns a thread, coalesced
    for (int p = tid; p < n * (HD / 4); p += NT) {
      const int t = p / (HD / 4), j = p % (HD / 4) * 4;
      float4 acc = *reinterpret_cast<const float4*>(&sm.part[t][0][j]);
#pragma unroll
      for (int q = 1; q < kLanes; ++q) {
        const float4 a = *reinterpret_cast<const float4*>(&sm.part[t][q][j]);
        acc = make_float4(__fadd_rn(acc.x, a.x), __fadd_rn(acc.y, a.y),
                          __fadd_rn(acc.z, a.z), __fadd_rn(acc.w, a.w));
      }
      const float* vt;
      if constexpr (kWiden)
        vt = sm.fv[t];
      else
        vt = sm.v[s][t];
      const float4 v4 = *reinterpret_cast<const float4*>(vt + j);
      const float c = sm.bonus[t];
      *reinterpret_cast<float4*>(y + base + static_cast<size_t>(t0 + t) *
                                                step + j) =
          make_float4(__fadd_rn(acc.x, __fmul_rn(v4.x, c)),
                      __fadd_rn(acc.y, __fmul_rn(v4.y, c)),
                      __fadd_rn(acc.z, __fmul_rn(v4.z, c)),
                      __fadd_rn(acc.w, __fmul_rn(v4.w, c)));
    }
  }
#pragma unroll
  for (int q = 0; q < NG; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * (q * kLanes + l) + e;
      Cols row;
#pragma unroll
      for (int c = 0; c < kCols; ++c) row.f[c] = st[4 * q + e][c];
      *reinterpret_cast<Cols*>(sT + state_off + static_cast<size_t>(i) * HD +
                               j0) = row;
    }
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* sT, int B, int S,
           int H, cudaStream_t stream) {
  constexpr int bytes = sizeof(Stage<T, HD>);
  static bool ready = false;   // the shared-memory limit, set once
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        rwkv6_wkv<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  const dim3 grid(H, B);
  rwkv6_wkv<T, HD><<<grid, HD / kCols * kLanes, bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(sT), S, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v are float (bf16 == 0) or bf16 (bf16 == 1); every pointer is
// 16-byte aligned.  s0 may be null (a zero initial state) and may equal sT
// (in place).
extern "C" int rwkv6_launch(const void* r, const void* k, const void* v,
                            const void* w, const void* u, const void* s0,
                            void* y, void* sT, int B, int S, int H, int hd,
                            int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return bf16 ? launch<__nv_bfloat16, 64>(r, k, v, w, u, s0, y, sT, B, S,
                                            H, s)
                : launch<float, 64>(r, k, v, w, u, s0, y, sT, B, S, H, s);
  if (hd == 32)
    return bf16 ? launch<__nv_bfloat16, 32>(r, k, v, w, u, s0, y, sT, B, S,
                                            H, s)
                : launch<float, 32>(r, k, v, w, u, s0, y, sT, B, S, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* rwkv6_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
