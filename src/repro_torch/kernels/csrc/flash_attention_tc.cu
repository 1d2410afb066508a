// Online-softmax GQA attention on Hopper's tensor cores: the "tc" route of
// kernels/flash_attention.py (bf16, head width 64 or 128, more than
// SPLITKV_MAX_SQ query rows): smollm-135m's scoring pass, whisper-medium's
// encoder, Jamba's attention layer, qwen2.5-14b's heads.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// flash_attention (body _flash_kernel).  For q (B, Sq, H, hd) and k, v
// (B, Skv, KV, hd), bf16 and contiguous in that layout, it returns
//     out[b, i, h] = sum_j softmax_j(s[i, j]) v[b, j, h / (H / KV)],
//     s[i, j] = q[b, i, h] . k[b, j, h / (H / KV)] / sqrt(hd),
// over the columns j that the masks keep: j < kv_end (= min(Skv,
// kv_valid)), j <= i when causal, j > i - window when a window is given
// (queries start at position 0).  A row with no column kept is 0.
//
// Arithmetic.  Scores and the softmax statistics are f32 (bf16 products
// are exact in the f32 accumulator); p is rounded to bf16 for the P.V
// product, whose sum is f32; the output is rounded to bf16 once.  The
// running (m, l, acc) follow the TPU kernel's recursion tile by tile, in
// base 2: p = 2^(s*c - m*c) with c = log2(e)/sqrt(hd), alpha =
// 2^(m*c - m'*c), l' = l alpha + sum p, acc' = acc alpha + p v, out =
// acc (1/l) (l = 0 -> 0).  A masked score is -inf, so its p is 0; a row
// whose max is still -inf takes m = 0 for the exponentials.  Outside the
// products every operation rounds once (__fmul_rn, __fadd_rn, one
// __fmaf_rn for s*c - m*c).
//
// Bound on this card.  A call reads q, k, v once and writes out once and
// does 4 hd operations per kept (query, key) pair.  At smollm-135m's
// scoring shape (B=8, S=2048, H=9, KV=3, hd=64, causal) that is 3.9e10
// operations against 50 MB: 0.039 ms at 989 TFLOP/s bf16, against 0.015
// ms of bytes; at Jamba's (H 64, KV 8, hd 128) 5.5e11 operations, 0.56 ms.
// So the tensor cores bound it.
//
// Design.  One block per (query tile, head, batch row): CONS consumer
// warpgroups of 64 query rows each (1 at hd 64, 2 sharing every key tile
// at hd 128) and one producer warp.  The producer's lane 0 loads 64-key
// tiles of K and V by TMA (4-D tensor maps over (hd, heads, rows, batch),
// boxes of 64 columns = one 128-byte swizzle row, rows past Skv filled
// with 0) into a ring of kStages stages with full/empty mbarriers; the
// kv head is h / (H / KV), so GQA never copies K or V.  A consumer
// warpgroup computes S = Q K^T with wgmma m64n64k16 (K K-major in shared
// memory, 128-byte swizzle); its Q rows are wgmma's A operand, held in
// registers at hd 64 (read once from device memory: a register-sourced A
// spares the shared-memory bandwidth that two shared operands of a 64-wide
// product would saturate) and loaded by the producer as TMA tiles at hd
// 128 (QS: at 140 registers a thread the 32 more of a register-held Q
// cost more than the shared reads).  It masks the tiles that cross
// kv_end, the diagonal or the window, runs the online softmax on the
// accumulator fragments (row max and sum across the quad by shuffles),
// rounds P to bf16 in registers and feeds it as wgmma's A operand for O
// += P V, V read MN-major from shared memory (one m64n64 product per 64
// output columns).  The loop queues S of tile t and P V of tile t - 1
// together and runs the softmax of tile t while P V runs.  Key tiles that
// no row of the block keeps are never loaded; a warpgroup skips the tiles
// its own rows do not keep.  The longest causal query tiles are issued
// first (blockIdx.z counts down), so the triangle leaves no tail.
//
// What holds it back now.  At hd 64 the tensor cores, the exponentials
// (one per kept pair on 16 special-function units an SM) and the softmax's
// other instructions each need about 0.04 ms at the scoring shape, and
// the kernel's time is close to their sum: a warpgroup still waits for S
// before its softmax, and nothing orders the three warpgroups on an SM so
// that one's softmax covers another's products (FlashAttention-3's
// ping-pong).  At hd 128 registers (140 a thread) allow one block of two
// consumer warpgroups per SM.  The output is stored from the fragments, 4
// bytes a lane.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxDevices = 64;   // shared-memory size set once per device

constexpr int kRows = 64;        // query rows per consumer warpgroup
constexpr int kCols = 64;        // keys per tile
constexpr int kChunk = 64;       // bf16 columns per TMA box: 128 bytes
constexpr int kStages = 3;       // K/V ring depth
constexpr int kBox = 64 * kChunk * 2;   // bytes of a 64-row box (Q or K/V)
constexpr float kLog2e = 1.4426950408889634f;

template <int HD, int CONS, bool QS>
struct Layout {                  // byte offsets from a 1024-aligned base
  static constexpr int NK = HD / kChunk;
  static constexpr int q = 0;                        // QS: the Q tiles
  static constexpr int k = q + (QS ? CONS * NK * kBox : 0);
  static constexpr int v = k + kStages * NK * kBox;
  static constexpr int bars = v + kStages * NK * kBox;  // q, full[], empty[]
  static constexpr int bytes = bars + 8 * (1 + 2 * kStages);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle: 8-row groups 1024
// bytes apart.  Both byte offsets are 1024: a K-major operand reads only
// the stride between 8-row groups, and an MN-major operand 64 columns wide
// (one swizzle atom) reads only the stride between 8-row groups of K.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// after a wait: the accumulators are defined here, not at the issue
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define WG_D32(d)                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])
#define WG_R32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (+)= A B, m64n64k16, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A B, m64n64k16, A in registers (bf16 pairs, the mma.sync A
// fragment of each warp's 16 rows), B in shared memory: K-major (TRANS_B
// 0) or MN-major (TRANS_B 1, 16-bit types only)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : WG_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
        "n"(TRANS_B));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int HD, int CONS, bool QS>
__global__ void __launch_bounds__(CONS * 128 + 32)
    flash_tc(const __nv_bfloat16* __restrict__ q,
             const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             __nv_bfloat16* __restrict__ out, int Sq, int H, int KV,
             int causal, int window, int kv_end, float c_log2) {
  using L = Layout<HD, CONS, QS>;
  constexpr int NK = L::NK;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bar_q = base + L::bars;
  auto full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto empty = [&](int s) { return bar_q + 8u * (1 + kStages + s); };

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * (CONS * kRows);
  const int kvh = h / (H / KV);
  // the key tiles that some row of the block keeps
  const int q_last = min(q0 + CONS * kRows, Sq) - 1;
  const int k_hi = causal ? min(kv_end, q_last + 1) : kv_end;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / kCols;
  const int t_hi = k_hi > k_lo ? (k_hi + kCols - 1) / kCols : t_lo;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == CONS * 4) {                // the producer warp
    if (lane == 0) {
      if constexpr (QS) {
        mbar_expect_tx(bar_q, CONS * NK * kBox);
        for (int c = 0; c < CONS; ++c)
          for (int kc = 0; kc < NK; ++kc)
            tma_load(base + L::q + (c * NK + kc) * kBox, &tq, bar_q,
                     kc * kChunk, h, q0 + c * kRows, b);
      }
      for (int t = t_lo, i = 0; t < t_hi; ++t, ++i) {
        const int s = i % kStages;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * NK * kBox);
        for (int kc = 0; kc < NK; ++kc) {
          tma_load(base + L::k + (s * NK + kc) * kBox, &tk, full(s),
                   kc * kChunk, kvh, t * kCols, b);
          tma_load(base + L::v + (s * NK + kc) * kBox, &tv, full(s),
                   kc * kChunk, kvh, t * kCols, b);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows wq0 .. wq0 + 63; this thread holds rows
  // r0 and r0 + 8, columns 8 j + cq and 8 j + cq + 1 of every n8 block j
  const int wg = warp >> 2;
  const int wq0 = q0 + wg * kRows;
  const int r0 = wq0 + (warp & 3) * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const int w_last = min(wq0 + kRows, Sq) - 1;
  const int wk_hi = causal ? min(kv_end, w_last + 1) : kv_end;
  const int wk_lo = window > 0 ? max(0, wq0 - window + 1) : 0;
  // the tiles this warpgroup's rows keep: [wt_lo, wt_hi), within the block's
  const int wt_lo = min(max(t_lo, wk_lo / kCols), t_hi);
  const int wt_hi = (wq0 < Sq && wk_hi > wk_lo)
                        ? max(wt_lo, min(t_hi, (wk_hi + kCols - 1) / kCols))
                        : wt_lo;

  // without QS, Q stays in registers as wgmma's A fragments, read once
  // from device memory (rows past Sq are 0): k slice kk holds rows r0 and
  // r0 + 8 at columns 16 kk + cq (+1) and 16 kk + 8 + cq (+1)
  uint32_t qa[QS ? 1 : HD / 16][4];
  if constexpr (!QS) {
    const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q);
    const size_t row_words = static_cast<size_t>(H) * HD / 2;
    const size_t w0 = ((static_cast<size_t>(b) * Sq + r0) * H + h) * HD / 2;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + 8 * (e & 1);
        const size_t w = w0 + (e & 1) * 8 * row_words + (16 * kk + cq) / 2 +
                         (e >> 1) * 4;
        qa[kk][e] = row < Sq ? q32[w] : 0u;
      }
  }
  float o[NK][32], sc[32];
  uint32_t pa[kCols / 16][4];          // P of the tile in flight, bf16 pairs
#pragma unroll
  for (int c = 0; c < NK; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  auto stage = [&](int t) { return (t - t_lo) % kStages; };
  auto wait_full = [&](int t) {
    mbar_wait(full(stage(t)), ((t - t_lo) / kStages) & 1);
  };
  auto release = [&](int t) { mbar_arrive(empty(stage(t))); };
  auto issue_s = [&](int t) {          // sc = Q K_t^T, committed, not waited
#pragma unroll
    for (int r = 0; r < 32; ++r) sc[r] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
      const uint64_t dk = desc_sw128(base + L::k + stage(t) * NK * kBox + off);
      if constexpr (QS)
        wgmma_ss(sc, desc_sw128(base + L::q + wg * NK * kBox + off), dk,
                 kk > 0);
      else
        wgmma_rs<0>(sc, qa[kk], dk, kk > 0);
    }
    wgmma_commit();
  };
  auto issue_pv = [&](int t) {         // o += P V_t, committed, not waited
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NK; ++c)
#pragma unroll
      for (int kk = 0; kk < kCols / 16; ++kk)
        wgmma_rs<1>(o[c], pa[kk],
                    desc_sw128(base + L::v + (stage(t) * NK + c) * kBox +
                               kk * 16 * kChunk * 2),
                    1);
    wgmma_commit();
#pragma unroll
    for (int c = 0; c < NK; ++c) fence_regs(o[c]);
  };
  // masks (on tiles that cross kv_end, the diagonal or the window) and the
  // online softmax of sc, rows r0 (registers 4j, 4j+1) and r0 + 8 (4j+2,
  // 4j+3); returns each row's alpha and leaves p in sc
  auto softmax = [&](int t, float (&alpha)[2]) {
    const int k0 = t * kCols;
    if (k0 + kCols > kv_end || (causal && k0 + kCols - 1 > wq0) ||
        (window > 0 && k0 <= w_last - window)) {
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int row = r0 + 8 * ((r >> 1) & 1);
        const int col = k0 + 8 * (r >> 2) + cq + (r & 1);
        const bool keep = col < kv_end && (!causal || col <= row) &&
                          (window <= 0 || col > row - window);
        if (!keep) sc[r] = -INFINITY;
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * rr], sc[4 * j + 2 * rr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[rr], mx);
      const float mc = __fmul_rn(m_new == -INFINITY ? 0.f : m_new, c_log2);
      alpha[rr] = ex2(__fsub_rn(__fmul_rn(m[rr], c_log2), mc));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 4 * j + 2 * rr + e;
          sc[r] = ex2(__fmaf_rn(sc[r], c_log2, -mc));
          rs = __fadd_rn(rs, sc[r]);
        }
      l[rr] = __fadd_rn(__fmul_rn(l[rr], alpha[rr]), rs);
      m[rr] = m_new;
    }
  };
  // P as wgmma's A fragments: keys 16 kk .. 16 kk + 15 are n8 blocks 2 kk
  // and 2 kk + 1
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kCols / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  };

  if constexpr (QS) mbar_wait(bar_q, 0);
  for (int t = t_lo; t < wt_lo; ++t) {    // tiles before this warpgroup's
    wait_full(t);
    release(t);
  }
  if (wt_lo < wt_hi) {
    // S of tile t runs on the tensor cores while nothing else is queued;
    // then each step queues S of the next tile and P V of this one, and the
    // softmax of the next tile overlaps P V
    float alpha[2];
    wait_full(wt_lo);
    issue_s(wt_lo);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(wt_lo, alpha);
    pack_p();
    for (int t = wt_lo + 1; t < wt_hi; ++t) {
      wait_full(t);
      issue_s(t);
      issue_pv(t - 1);
      wgmma_wait<1>();                   // S of tile t is done
      fence_regs(sc);
      softmax(t, alpha);
      wgmma_wait<0>();                   // P V of tile t - 1 is done
#pragma unroll
      for (int c = 0; c < NK; ++c) fence_regs(o[c]);
      release(t - 1);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int c = 0; c < NK; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            o[c][4 * j + 2 * rr] = __fmul_rn(o[c][4 * j + 2 * rr], alpha[rr]);
            o[c][4 * j + 2 * rr + 1] =
                __fmul_rn(o[c][4 * j + 2 * rr + 1], alpha[rr]);
          }
      pack_p();
    }
    issue_pv(wt_hi - 1);
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NK; ++c) fence_regs(o[c]);
    release(wt_hi - 1);
  }
  for (int t = wt_hi; t < t_hi; ++t) {    // tiles after this warpgroup's
    wait_full(t);
    release(t);
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float lt = l[rr];
    lt = __fadd_rn(lt, __shfl_xor_sync(0xffffffffu, lt, 1));
    lt = __fadd_rn(lt, __shfl_xor_sync(0xffffffffu, lt, 2));
    const float inv = lt > 0.f ? __frcp_rn(lt) : 0.f;
    const int row = r0 + 8 * rr;
    if (row >= Sq) continue;
    __nv_bfloat16* orow =
        out + ((static_cast<size_t>(b) * Sq + row) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < NK; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + c * 64 + 8 * j + cq) =
            __floats2bfloat162_rn(__fmul_rn(o[c][4 * j + 2 * rr], inv),
                                  __fmul_rn(o[c][4 * j + 2 * rr + 1], inv));
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (batch, rows, heads, hd) bf16 tensor as a 4-D map, boxes of 64 columns
// x `rows` rows of one head
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
                int hd, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(heads) * hd * 2,
                                 static_cast<cuuint64_t>(S) * heads * hd * 2};
  const cuuint32_t box[4] = {kChunk, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int CONS, bool QS>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int H, int KV, int causal, int window, int kv_end,
           float scale, cudaStream_t stream) {
  const int smem = Layout<HD, CONS, QS>::bytes + 1024;   // + alignment slack
  static bool sized[kMaxDevices] = {};  // per device; outlives the call
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!sized[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_tc<HD, CONS, QS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized[dev] = true;
  }
  CUtensorMap tq = {}, tk, tv;
  if ((QS && !tensor_map(&tq, q, B, Sq, H, HD, kRows)) ||
      !tensor_map(&tk, k, B, Skv, KV, HD, kCols) ||
      !tensor_map(&tv, v, B, Skv, KV, HD, kCols))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(H, B, (Sq + CONS * kRows - 1) / (CONS * kRows));
  flash_tc<HD, CONS, QS><<<grid, CONS * 128 + 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), tq, tk, tv,
      static_cast<__nv_bfloat16*>(out), Sq, H, KV, causal, window,
      kv_end, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// window <= 0: no window; kv_end = min(Skv, kv_valid); bf16 in and out
extern "C" int flash_attention_tc_launch(const void* q, const void* k,
                                         const void* v, void* out, int B,
                                         int Sq, int Skv, int H, int KV,
                                         int hd, int causal, int window,
                                         int kv_end, float scale,
                                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch<64, 1, false>(q, k, v, out, B, Sq, Skv, H, KV, causal,
                                  window, kv_end, scale, s);
    case 128:
      return launch<128, 2, true>(q, k, v, out, B, Sq, Skv, H, KV, causal,
                                  window, kv_end, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_tc_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
