// Split-KV attention for a few query rows: the "splitkv" route of
// kernels/flash_attention.py (any supported dtype and head width, at most
// SPLITKV_MAX_SQ query rows), which serves decode-time cross-attention.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// flash_attention (body _flash_kernel) where the query is a row or a few:
// the same function as the other routes, out[b, i, h] = sum_j softmax_j(
// s[i, j]) v[b, j, h / (H / KV)] with s[i, j] = q[b, i, h] . k[b, j,
// h / (H / KV)] / sqrt(hd), over the columns kept by kv_end, causal and
// window (queries at positions 0..Sq-1); a row with no column kept is 0.
// Everything is f32 from the loaded values on; the output is rounded to
// the input type once.
//
// Bound on this card.  A call reads K and V whole for a handful of
// operations per byte: bytes bound it.  Whisper-medium's cross-attention
// at decode (q 8x1x16x64 against an 8x1500x16x64 bf16 cache) moves 49.2
// MB, 0.0147 ms at 3.35 TB/s.
//
// Design.  Pass 1, grid (key split, kv head, batch row), 128 threads: a
// block copies its split_keys(HD) = 8192/hd keys of K and then of V into
// shared memory once with 16-byte cp.async, two copy groups, so V keeps
// arriving while the scores are formed (rows padded by 16 bytes, so a
// quarter-warp reading 16 bytes from 8 neighbouring rows hits 8 bank
// groups), then serves every query row of that kv head from them, all G =
// H/KV heads and all Sq rows, up to kRowPass rows a pass: scores (a thread
// a (row, key) pair, 16-byte loads), a warp a row for the max and the sum
// of the exponentials, and P V with a thread on four columns of a row over
// one group of keys, the groups then added in order (a decode row alone
// still fills the block).  It writes the partial (m, l) and acc of each
// (split, row) to scratch that the wrapper allocates.  GQA therefore reads
// the cache once, not G times.  Pass 2, grid (row, kv head, batch row),
// hd threads, merges the splits: with M = max_s m_s and weights e_s =
// exp(m_s - M) (0 for a split that kept nothing), out = sum_s e_s acc_s /
// sum_s e_s l_s.  Whisper's decode shape gives 12 splits x 16 heads x 8
// rows = 1536 blocks, about 12 an SM.  No TMA: a tensor map encoded on the
// host for every call would cost more than the kernel.
//
// What holds it back now.  The two passes are two launches, and a block
// holds all its keys at once (one stage), so the card runs about 6 blocks
// an SM in two waves; a call's time from an idle card is mostly the
// host's (the Python wrapper and two launches), which exceeds the
// kernels' device time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxDevices = 64;   // shared-memory size set once per device

constexpr int kThreads = 128;
constexpr int kRowPass = 32;     // query rows a pass over the staged keys

template <int HD>
constexpr int split_keys() {     // keys a block: kSplit in the note
  return 8192 / HD;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 8 consecutive values of a staged row as f32 (16 bytes of bf16, 32 of f32)
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float2 x = __bfloat1622float2(h[t]);
    f[2 * t] = x.x;
    f[2 * t + 1] = x.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

template <typename T, int HD>
struct SplitLayout {
  static constexpr int KC = split_keys<HD>();
  static constexpr int LD = HD + 16 / static_cast<int>(sizeof(T));  // padded
  static size_t bytes(int rows) {   // staged K, V; q, scores, P V partials
    const size_t partials = max(4 * kThreads, rows * HD);
    return 2 * static_cast<size_t>(KC) * LD * sizeof(T) +
           (static_cast<size_t>(rows) * (HD + KC) + partials) * sizeof(float);
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    splitkv_partial(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, float* __restrict__ acc_out,
                    float* __restrict__ ml_out, int Sq, int Skv, int H,
                    int KV, int causal, int window, int kv_end, int rows,
                    float scale) {
  using L = SplitLayout<T, HD>;
  constexpr int KC = L::KC, LD = L::LD;
  constexpr int V16 = HD * static_cast<int>(sizeof(T)) / 16;  // pieces a row
  constexpr int E16 = 16 / static_cast<int>(sizeof(T));       // values a piece
  extern __shared__ __align__(16) uint8_t smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + KC * LD;
  float* sQ = reinterpret_cast<float*>(sV + KC * LD);   // (rows, HD)
  float* sS = sQ + rows * HD;                           // (rows, KC)
  float* sP = sS + rows * KC;   // P V partials: 4 floats an (idx) below

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int B = gridDim.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = H / KV, R = G * Sq;
  const int j0 = split * KC;
  const int jn = max(0, min(KC, kv_end - j0));

  // K, then V, as two copy groups: the scores need only K, so V keeps
  // arriving while they are formed
  for (int idx = tid; idx < jn * V16; idx += kThreads) {
    const int j = idx / V16, c = idx % V16;
    cp_async16(sK + j * LD + c * E16,
               k + ((static_cast<size_t>(b) * Skv + j0 + j) * KV + kvh) * HD +
                   c * E16);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  for (int idx = tid; idx < jn * V16; idx += kThreads) {
    const int j = idx / V16, c = idx % V16;
    cp_async16(sV + j * LD + c * E16,
               v + ((static_cast<size_t>(b) * Skv + j0 + j) * KV + kvh) * HD +
                   c * E16);
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 1;" ::: "memory");
  __syncthreads();

  // row r of the kv head = (query row i, head kvh * G + g), r = i * G + g
  for (int p0 = 0; p0 < R; p0 += rows) {
    const int rn = min(rows, R - p0);
    for (int idx = tid; idx < rn * HD; idx += kThreads) {
      const int r = p0 + idx / HD, d = idx % HD;
      const int i = r / G, h = kvh * G + r % G;
      sQ[idx] = to_f32(q[((static_cast<size_t>(b) * Sq + i) * H + h) * HD + d]);
    }
    __syncthreads();
    for (int idx = tid; idx < rn * KC; idx += kThreads) {
      const int rr = idx / KC, j = idx % KC;
      const int i = (p0 + rr) / G, col = j0 + j;
      float s = -INFINITY;
      if (j < jn && (!causal || col <= i) &&
          (window <= 0 || col > i - window)) {
        const float* qr = sQ + rr * HD;
        const T* kr = sK + j * LD;
        float dot = 0.f;
#pragma unroll 4
        for (int d = 0; d < HD; d += 8) {
          float kf[8], qf[8];
          load8(kr + d, kf);
          load8(qr + d, qf);
#pragma unroll
          for (int e = 0; e < 8; ++e) dot = __fmaf_rn(qf[e], kf[e], dot);
        }
        s = __fmul_rn(dot, scale);
      }
      sS[idx] = s;
    }
    __syncthreads();
    for (int rr = warp; rr < rn; rr += kThreads / 32) {
      float* sr = sS + rr * KC;
      float mx = -INFINITY;
      for (int j = lane; j < KC; j += 32) mx = fmaxf(mx, sr[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.f;
      for (int j = lane; j < KC; j += 32) {
        const float p = mx == -INFINITY ? 0.f : expf(__fsub_rn(sr[j], mx));
        sr[j] = p;
        sum = __fadd_rn(sum, p);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
      if (lane == 0) {
        const size_t row =
            ((static_cast<size_t>(split) * B + b) * KV + kvh) * R + p0 + rr;
        float* ml = ml_out + 2 * row;
        ml[0] = mx;
        ml[1] = sum;
      }
    }
    // this thread's V copies have landed (a no-op after the first pass);
    // the barrier publishes everyone's, and the probabilities
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
    // P V: a thread four columns of a row over one of kg key groups, so
    // that few rows still fill the block; the groups then add in order
    constexpr int C4 = HD / 4;
    const int kg = max(1, kThreads / (rn * C4));
    for (int idx = tid; idx < kg * rn * C4; idx += kThreads) {
      const int grp = idx / (rn * C4), rc = idx % (rn * C4);
      const int rr = rc / C4, d = 4 * (rc % C4);
      const float* pr = sS + rr * KC;
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j = grp; j < jn; j += kg) {
        const float p = pr[j];
        const T* vr = sV + j * LD + d;
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = __fmaf_rn(p, to_f32(vr[e]), a[e]);
      }
      *reinterpret_cast<float4*>(sP + 4 * idx) =
          make_float4(a[0], a[1], a[2], a[3]);
    }
    __syncthreads();
    for (int idx = tid; idx < rn * C4; idx += kThreads) {
      float4 t = *reinterpret_cast<const float4*>(sP + 4 * idx);
      for (int grp = 1; grp < kg; ++grp) {
        const float4 u =
            *reinterpret_cast<const float4*>(sP + 4 * (grp * rn * C4 + idx));
        t = make_float4(__fadd_rn(t.x, u.x), __fadd_rn(t.y, u.y),
                        __fadd_rn(t.z, u.z), __fadd_rn(t.w, u.w));
      }
      const int rr = idx / C4, d = 4 * (idx % C4);
      *reinterpret_cast<float4*>(
          acc_out +
          (((static_cast<size_t>(split) * B + b) * KV + kvh) * R + p0 + rr) *
              HD +
          d) = t;
    }
    __syncthreads();   // the next pass overwrites sQ and sS
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
    splitkv_merge(const float* __restrict__ acc, const float* __restrict__ ml,
                  T* __restrict__ out, int nsplit, int Sq, int H, int KV) {
  const int r = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int R = gridDim.x, B = gridDim.z, d = threadIdx.x;
  const int G = H / KV;
  const size_t row = (static_cast<size_t>(b) * KV + kvh) * R + r;
  const size_t per_split = static_cast<size_t>(B) * KV * R;
  float M = -INFINITY;
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, ml[2 * (s * per_split + row)]);
  float L = 0.f, O = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const float ms = ml[2 * (s * per_split + row)];
    const float w = ms == -INFINITY ? 0.f : expf(__fsub_rn(ms, M));
    L = __fadd_rn(L, __fmul_rn(ml[2 * (s * per_split + row) + 1], w));
    O = __fadd_rn(O, __fmul_rn(acc[(s * per_split + row) * HD + d], w));
  }
  const int i = r / G, h = kvh * G + r % G;
  store(out + ((static_cast<size_t>(b) * Sq + i) * H + h) * HD + d,
        L > 0.f ? __fdiv_rn(O, L) : 0.f);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           float* acc, float* ml, int B, int Sq, int Skv, int H, int KV,
           int causal, int window, int kv_end, int nsplit, float scale,
           cudaStream_t stream) {
  using L = SplitLayout<T, HD>;
  const int R = (H / KV) * Sq;
  const int rows = min(kRowPass, R);
  const size_t smem = L::bytes(rows);
  if (nsplit != max(1, (kv_end + L::KC - 1) / L::KC))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool sized[kMaxDevices] = {};  // per device; outlives the call
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!sized[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        splitkv_partial<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::bytes(kRowPass)));
    if (e != cudaSuccess) return static_cast<int>(e);
    sized[dev] = true;
  }
  splitkv_partial<T, HD><<<dim3(nsplit, KV, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), acc, ml, Sq, Skv, H, KV, causal, window,
      kv_end, rows, scale);
  const cudaError_t e1 = cudaGetLastError();
  if (e1 != cudaSuccess) return static_cast<int>(e1);
  splitkv_merge<T, HD><<<dim3(R, KV, B), HD, 0, stream>>>(
      acc, ml, static_cast<T*>(out), nsplit, Sq, H, KV);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* out,
              float* acc, float* ml, int B, int Sq, int Skv, int H, int KV,
              int causal, int window, int kv_end, int nsplit, float scale,
              cudaStream_t stream) {
  switch (hd) {
#define SPLITKV_HD(D)                                                       \
  case D:                                                                   \
    return launch<T, D>(q, k, v, out, acc, ml, B, Sq, Skv, H, KV, causal,   \
                        window, kv_end, nsplit, scale, stream);
    SPLITKV_HD(32) SPLITKV_HD(64) SPLITKV_HD(128) SPLITKV_HD(256)
#undef SPLITKV_HD
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// acc: (nsplit, B, KV, R, hd) f32 and ml: (nsplit, B, KV, R, 2) f32
// scratch, R = (H / KV) * Sq; nsplit = max(1, ceil(kv_end / (8192 / hd)));
// window <= 0: no window; bf16 != 0: q, k, v and out are bf16, else float.
extern "C" int flash_attention_splitkv_launch(
    const void* q, const void* k, const void* v, void* out, void* acc,
    void* ml, int B, int Sq, int Skv, int H, int KV, int hd, int bf16,
    int causal, int window, int kv_end, int nsplit, float scale,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(acc);
  float* m = static_cast<float*>(ml);
  if (bf16)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, out, a, m, B, Sq, Skv, H,
                                    KV, causal, window, kv_end, nsplit, scale,
                                    s);
  return launch_hd<float>(hd, q, k, v, out, a, m, B, Sq, Skv, H, KV, causal,
                          window, kv_end, nsplit, scale, s);
}

extern "C" const char* flash_attention_splitkv_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
