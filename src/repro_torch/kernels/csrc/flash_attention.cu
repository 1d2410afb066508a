// Online-softmax GQA attention on the CUDA cores: the "simt" route of
// kernels/flash_attention.py, which takes every supported call the other
// two routes do not: f32 above SPLITKV_MAX_SQ query rows (the scoring
// passes' f32 checks, card against CPU) and bf16 at head width 32 or 256.
// It is the f32 route because the f32 tiers (1e-5 against the plain
// version, card against CPU at 1e-5 of the loss) leave no room for the
// tensor cores' TF32, which keeps 10 bits of mantissa.  bf16 at head
// width 64 or 128 goes to flash_attention_tc.cu, a few query rows to
// flash_attention_splitkv.cu.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// flash_attention (body _flash_kernel).  For q (B, Sq, H, hd) and k, v
// (B, Skv, KV, hd), all contiguous in that layout, it returns
//     out[b, i, h] = sum_j softmax_j(s[i, j]) v[b, j, h / (H / KV)],
//     s[i, j] = (q[b, i, h] * scale) . k[b, j, h / (H / KV)],
// scale = 1/sqrt(hd), over the columns j that the masks keep: j < kv_end
// (= min(Skv, kv_valid)), j <= i when causal, j > i - window when a window
// is given (queries start at position 0).  A row with no column kept is 0.
// Inputs are float or bf16; scores, the softmax statistics and the output
// accumulator are f32; the output is written in the input type.
//
// Arithmetic.  q is scaled before the dot, as the TPU kernel does.  Masked
// scores are -1e30 and the running (m, l, acc) follow the TPU kernel's
// recursion tile by tile: m' = max(m, max_j s), alpha = exp(m - m'),
// p = exp(s - m') on kept columns (0 elsewhere), l' = l alpha + sum p,
// acc' = acc alpha + p v, out = acc / l (l = 0 -> 1).  The library is built
// with --fmad=false (for the MEDIAN kernels' strict ties); the dot loops
// here call __fmaf_rn, which that flag leaves fused, and every other
// product and sum rounds once (__fmul_rn / __fadd_rn).  A key tile that
// the masks remove for every row of the query tile is skipped: its p are 0
// and its alpha 1, so the result is the same.
//
// Bound on this card.  A call reads q, k, v once and writes out once and
// does 4 hd operations per kept (query, key) pair.  At the scoring shape
// of smollm-135m (B=8, S=2048, H=9, KV=3, hd=64, causal) in f32 that is
// 3.9e10 operations against 100 MB: 0.58 ms at 67 TFLOP/s f32 on the CUDA
// cores, against 0.03 ms of bytes.
//
// Design.  One block per (64-row query tile, head, batch row); 256 threads
// form a 16 x 16 grid of 4 x 4 micro-tiles.  The query tile (scaled) stays
// in shared memory for the whole call, transposed; each 64-row key tile is
// staged transposed and the value tile as it is, converted to f32.  A
// thread computes 4 x 4 scores with float4 shared loads, the 16 threads of
// a row group reduce the row max and sum with warp shuffles, the
// probabilities go through shared memory, and each thread accumulates 4
// rows x hd/16 output columns in registers.  The kv head is h / (H / KV),
// so GQA never copies K or V.  Ragged Sq and Skv are handled by bounds:
// rows past Sq are never written, key rows past kv_end load as 0 and are
// masked.  What holds it back: loads are synchronous, one element at a
// time (no cp.async, no double buffering), and shared memory (up to 217 KB
// at hd=256) limits a multiprocessor to one to three blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 64;           // query rows per block
constexpr int kCols = 64;           // key rows per tile
constexpr int kThreads = 256;       // 16 x 16 micro-tiles of 4 x 4
constexpr int kPad = kRows + 4;     // stride of a transposed tile (floats)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int HD>
constexpr size_t smem_bytes() {
  return (2 * HD * kPad + kCols * HD + kCols * kPad) * sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attention(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out, int Sq,
                    int Skv, int H, int KV, int causal, int window,
                    int kv_end, float scale) {
  constexpr int NC = (HD + 63) / 64;   // 64-column chunks of the output
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                    // (HD, kPad): q * scale, transposed
  float* sK = sQ + HD * kPad;          // (HD, kPad): key tile, transposed
  float* sV = sK + HD * kPad;          // (kCols, HD): value tile
  float* sP = sV + kCols * HD;         // (kCols, kPad): p, transposed

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int tr = tid >> 4;             // rows tr*4 .. tr*4+3
  const int tc = tid & 15;             // score columns tc*4 .. tc*4+3

  for (int i = tid; i < kRows * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i % HD;
    const int row = q0 + r;
    float x = 0.0f;
    if (row < Sq)
      x = __fmul_rn(
          to_f32(q[((static_cast<size_t>(b) * Sq + row) * H + h) * HD + d]),
          scale);
    sQ[d * kPad + r] = x;
  }

  // the key tiles some row of this query tile can see
  const int q_last = min(q0 + kRows, Sq) - 1;
  int k_hi = kv_end;
  if (causal) k_hi = min(k_hi, q_last + 1);
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / kCols;
  const int t_hi = k_hi > k_lo ? (k_hi + kCols - 1) / kCols : t_lo;

  float m[4], l[4], acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.0f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kCols;
    __syncthreads();   // sQ is staged; the last tile is done with sK/sV/sP
    for (int i = tid; i < kCols * HD; i += kThreads) {
      const int c = i / HD;
      const int d = i % HD;
      const int col = k0 + c;
      float kx = 0.0f, vx = 0.0f;
      if (col < kv_end) {
        const size_t off =
            ((static_cast<size_t>(b) * Skv + col) * KV + kvh) * HD + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      sK[d * kPad + c] = kx;
      sV[c * HD + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(sQ + d * kPad + tr * 4);
      const float4 kk =
          *reinterpret_cast<const float4*>(sK + d * kPad + tc * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = __fmaf_rn(av[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + tr * 4 + i;
      bool keep[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tc * 4 + j;
        keep[j] = col < kv_end && (!causal || col <= row) &&
                  (window <= 0 || col > row - window);
        if (!keep[j]) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row group are 16 neighbouring lanes
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(__fsub_rn(m[i], m_new));
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = keep[j] ? expf(__fsub_rn(s[i][j], m_new)) : 0.0f;
        rs = __fadd_rn(rs, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, off));
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha), rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] = __fmul_rn(acc[i][c], alpha);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(sP + (tc * 4 + j) * kPad + tr * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    const int jn = min(kCols, k_hi - k0);   // columns past it have p = 0
    for (int j = 0; j < jn; ++j) {
      const float4 p4 = *reinterpret_cast<const float4*>(sP + j * kPad + tr * 4);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = c * 64 + tc * 4;
        if (col < HD) {
          const float4 w4 = *reinterpret_cast<const float4*>(sV + j * HD + col);
          const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              acc[i][c * 4 + jj] = __fmaf_rn(pv[i], wv[jj], acc[i][c * 4 + jj]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr * 4 + i;
    if (row >= Sq) continue;
    const float li = l[i] == 0.0f ? 1.0f : l[i];
    T* o = out + ((static_cast<size_t>(b) * Sq + row) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = c * 64 + tc * 4;
      if (col < HD) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          store(o + col + jj, __fdiv_rn(acc[i][c * 4 + jj], li));
      }
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int H, int KV, int causal, int window, int kv_end,
           float scale, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      flash_attention<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<HD>()));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + kRows - 1) / kRows, H, B);
  flash_attention<T, HD><<<grid, kThreads, smem_bytes<HD>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, H, KV, causal,
      window, kv_end, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* out,
              int B, int Sq, int Skv, int H, int KV, int causal, int window,
              int kv_end, float scale, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, out, B, Sq, Skv, H, KV, causal, window,
                           kv_end, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, B, Sq, Skv, H, KV, causal, window,
                           kv_end, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, Sq, Skv, H, KV, causal, window,
                            kv_end, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, B, Sq, Skv, H, KV, causal, window,
                            kv_end, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// window <= 0: no window; kv_end = min(Skv, kv_valid); bf16 != 0: inputs
// and output are __nv_bfloat16, else float.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int Skv, int H, int KV, int hd, int bf16,
                                      int causal, int window, int kv_end,
                                      float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, out, B, Sq, Skv, H, KV,
                                    causal, window, kv_end, scale, s);
  return launch_hd<float>(hd, q, k, v, out, B, Sq, Skv, H, KV, causal, window,
                          kv_end, scale, s);
}

extern "C" const char* flash_attention_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
