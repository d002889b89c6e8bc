// Flash attention forward: softmax(Q K^T * scale) V for every (batch, head),
// any sequence length, optional causal mask and key-length mask
// (`valid_len`).
//
// Replaces: embodied_captioning_tpu/ops/pallas/flash_attention.py
//   flash_attention (single-block _attn_single_block_kernel, T <= 512, and
//   the blocked _flash_kernel for longer T) -- one entry point for every T,
//   with the single-block kernel's numerics: f32 scores from bf16 operands,
//   f32 row max and sum, probabilities NORMALISED and then rounded to bf16
//   before the PV product (f32 accumulation), bf16 output.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): at the ViT-L encode
// shape q,k,v,o = [64,16,257,64] bf16 the four tensors are 4 x 33.7 MB, so
// memory bounds it at ~40 us; its 4*B*H*T*T*D = 17.3 GFLOP take ~17.5 us at
// the tensor-core peak. At [64,16,640,64] the operations bound it (~108
// us), and the exponentials come close: one ex2 a score is 27 G, ~110 us
// on the SMs' special-function units at 16 a clock.
//
// Two kernels; `flash_plan` in kernels/flash_attention.py picks one by the
// head dim and the live keys, and `ecap_flash_attention` refuses a choice
// the picked instance cannot take.
//
// flash_wg, head dims 64 and 128 (the ViT, the text encoders' heads, T =
// 640): Hopper's warpgroup products fed by TMA.
//  - A block is three warpgroups, persistent over heads (one block an SM):
//    two consumers and a producer that hands them its registers
//    (setmaxnreg: 240 a consumer thread, 24 a producer thread). The
//    producer's one thread issues every copy: TMA loads of 64-row tiles of
//    a 3-D tensor map [bh, t, d] (128-byte swizzle; rows past t
//    zero-filled by the hardware, so the ragged last tile of T = 257 needs
//    no code), each completing on an mbarrier. Consumer warpgroup c takes
//    the query tiles c, c + 2, ... of the block's flat (head, query tile)
//    sequence, so T = 257's five tiles a head (the fifth one row) spread
//    evenly over heads.
//  - K and V of a head are RESIDENT where the ring holds them (2 ceil(k/64)
//    tiles of 24 at D = 64, so up to 768 keys; of 10 at D = 128): loaded
//    once, read by every query tile of the head, released when both
//    warpgroups are done with it; the next head's tiles stream into the
//    free stages meanwhile. Longer heads stream each query tile's tiles
//    through the ring (K for pass 1, then K, V for pass 2), one warpgroup
//    a tile.
//  - QK^T is wgmma m64n64k16 with Q and K from shared memory (K-major); PV
//    is wgmma m64n64k16 with p from registers (the accumulator fragment
//    packed to bf16 is the A fragment) and V read transposed from its
//    row-major tile.
//  - Where a head's live keys fit in registers (D = 64 and at most 4 tiles,
//    or 4 tiles and 16 keys: T = 257 is S of 64 x 272 f32, 136 registers a
//    thread), QK^T runs ONCE: the whole row of scores stays in registers
//    between its max and sum and the normalised p, one ex2 a score. The
//    last 16 keys of T = 257 are an m64n16k16 product. Otherwise (T = 640,
//    D = 128) the kernel recomputes S in a second pass, as the numerics
//    need the row sum before any p is rounded: pass 1 keeps the running
//    max and sum, pass 2 forms p = exp(s - m) / l as one ex2 with log2 l
//    folded into the exponent.
//  - The code between a consumer's products has no branch that differs
//    between its threads (masks are selects, the barrier waits retry
//    inside their asm): ptxas serialises the products (C7520) where a
//    register they read is defined on a divergent path. So rows past t
//    are computed like the others (their zero q gives finite p; they are
//    not stored), every key tile of a resident head is multiplied, and
//    keys past the last live one are masked, not skipped; the two-pass
//    path skips key tiles past a query tile's causal diagonal.
//
// Measured (H100 80GB HBM3, 700 W; `chip_smoke.py --rows .
// flash_attention`): 86.2 us at [64,16,257,64] beside SDPA's 117.8, 611.5
// us at [64,16,640,64] beside 246.8. What holds T = 640 back: the second pass, two ex2 a score on the
// special-function units and 1.5x the products, with a warpgroup's
// products and exponentials serial.
// Tried and dropped: the first version, one producer warp beside the two
// consumers (288 threads), was capped at 168 registers and spilled 1,152
// bytes at T = 257, and branches on the live row, on the causal tiles and
// a C++ retry loop around the barrier wait made ptxas serialise every
// product: 374.1 us at T = 257, 810.0 at T = 640. Three consumer
// warpgroups for the two-pass instances (160 registers each): 574.3 us
// against 589.0 with two in the same build state, within the spread of
// repeated runs.
//
// flash_head / flash_stream, head dims 8, 16 and 32 (the query detector's
// decoder, fpn_dim / 8 heads over 64 queries, and MiniLM's heads): too
// small for a 64-row warpgroup product to pay; mma.sync m16n8k16 kernels
// (FlashAttention-2's inner loop, RowTile below):
//  - A warp owns 16 query rows. QK^T and PV are mma.sync.m16n8k16 with
//    bf16 inputs and f32 accumulators; K and V come from shared memory
//    through ldmatrix (V through ldmatrix.trans), the q fragments stay in
//    registers for both passes.
//  - Two passes over 64-key tiles: pass 1 keeps the running row max and
//    denominator of each S tile in registers; pass 2 recomputes S, forms
//    p = exp(s - m) / l as one ex2 and packs it straight from the
//    accumulator fragment into the A fragment of the PV product.
//  - flash_head: one block per (b, h) stages the head's whole K and V in
//    shared memory with 16-byte cp.async copies, and its warps walk the
//    16-row query tiles. flash_stream (K/V beyond 200 KB): a block of 8
//    warps takes 128 queries and streams 64-key K/V tiles through a
//    3-stage cp.async ring.
//  - Head dims 8 and 16: the mma k-extent is 16, so a head of 8 is
//    computed 16 wide -- the upper 8 columns of the K and V tiles are
//    zero-filled in shared memory and those of the q fragments are zero.
//
// Before flash_wg (H100 80GB HBM3, 700 W; chip_smoke.py phase 2), D = 64
// ran flash_head / flash_stream too: 216.3 us at [64,16,257,64] (8 warps of
// 16 rows a head: T = 257's 17 row tiles take 3 rounds, one warp busy in
// the last; K/V staged whole before any math) and 892.4 us at T = 640,
// against SDPA's 117.2 and 248.9 us.
#include <algorithm>

#include "hopper.cuh"
#include "mma.cuh"

namespace {

constexpr int kBK = 64;          // keys per tile
constexpr int kStreamWarps = 8;  // flash_stream: 128 queries per block
constexpr int kStages = 3;       // flash_stream's cp.async ring depth
// flash_head: one (b, h) per block, 8 warps while two blocks fit an SM,
// else 16
constexpr int kHeadSmem2 = 110 * 1024;
constexpr int kHeadSmem1 = 200 * 1024;

// the width a head of D is computed at: the mma k-extent, 16, at least
template <int D>
__host__ __device__ constexpr int padded() {
  return D < 16 ? 16 : D;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One warp's softmax state for its 16 query rows (rows g and g + 8 of the
// mma fragments): the running max in log2 units (after pass 1: max +
// log2(denominator)), this lane's share of the denominator (summed across
// the quad after pass 1), and the f32 output accumulator.
template <int D>
struct RowTile {
  static constexpr int DP = padded<D>();
  uint32_t qf[DP / 16][4];
  float acc[DP / 8][4];
  float m[2], l[2];
  int row[2];

  __device__ __forceinline__ void init(int r0) {
    const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = ecap::kNegInf;
      l[r] = 0.f;
      row[r] = r0 + g + 8 * r;
    }
  }

  // after pass 1: the quad's denominator shares summed, and folded into
  // the exponent of pass 2: exp(s - max) / l = ex2(s c - (max c + log2 l));
  // l >= 1, as the max itself contributes 1
  __device__ __forceinline__ void finish_pass1() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float s = l[r];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      m[r] += log2f(s);
    }
  }

  // One 64-key tile at key k0 of K (and V) rows in shared memory (row
  // stride DP + 8). Keys at or beyond `kend` and, if causal, beyond a row
  // are masked; only the 16-key steps below kend are computed. Pass 1
  // updates the running max and denominator; pass 2 adds bf16(p) V with p
  // normalised before the rounding.
  template <bool kPass2>
  __device__ __forceinline__ void tile(const __nv_bfloat16* kt,
                                       const __nv_bfloat16* vt, int k0,
                                       int kend, bool causal,
                                       float scale_log2) {
    constexpr int LD = DP + 8;
    const int lane = threadIdx.x & 31, tq = lane & 3;
    const int nlive = min(kBK, kend - k0);

    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int nj = 0; nj < kBK / 16; ++nj) {
        if (nj * 16 >= nlive) continue;
        uint32_t b[4];
        ecap::ldmatrix_x4(b, kt + (nj * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                                 kk * 16 + ((lane >> 3) & 1) * 8);
        ecap::mma_bf16(s[2 * nj], qf[kk], b[0], b[1]);
        ecap::mma_bf16(s[2 * nj + 1], qf[kk], b[2], b[3]);
      }
    }
    // masked scores are -1e30, whose ex2 is 0 against any row max (finite:
    // key 0 is live for every row)
    if (nlive < kBK || (causal && k0 + kBK - 1 > row[0])) {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + j * 8 + 2 * tq + (e & 1);
          if (key >= kend || (causal && key > row[e >> 1]))
            s[j][e] = ecap::kNegInf;
        }
    }

    // exp(s * scale - max) = ex2(s * c - max * c) with c = scale * log2(e):
    // the max is kept in those units, one fused multiply-add per score
    if constexpr (!kPass2) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = ecap::kNegInf;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx * scale_log2);
        float add[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
          if ((j >> 1) * 16 < nlive)
            add[j & 1] += ex2(fmaf(s[j][2 * r], scale_log2, -m_new)) +
                          ex2(fmaf(s[j][2 * r + 1], scale_log2, -m_new));
        l[r] = l[r] * ex2(m[r] - m_new) + (add[0] + add[1]);
        m[r] = m_new;
      }
    } else {
      // p straight from the S accumulator fragment into the A fragment
#pragma unroll
      for (int nj = 0; nj < kBK / 16; ++nj) {
        if (nj * 16 >= nlive) continue;
        float p[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            p[h][e] = ex2(fmaf(s[2 * nj + h][e], scale_log2, -m[e >> 1]));
        const uint32_t a[4] = {ecap::pack_bf16(p[0][0], p[0][1]),
                               ecap::pack_bf16(p[0][2], p[0][3]),
                               ecap::pack_bf16(p[1][0], p[1][1]),
                               ecap::pack_bf16(p[1][2], p[1][3])};
#pragma unroll
        for (int dj = 0; dj < DP / 16; ++dj) {
          uint32_t b[4];
          ecap::ldmatrix_x4_trans(
              b, vt + (nj * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                     dj * 16 + (lane >> 4) * 8);
          ecap::mma_bf16(acc[2 * dj], a, b[0], b[1]);
          ecap::mma_bf16(acc[2 * dj + 1], a, b[2], b[3]);
        }
      }
    }
  }

  // bf16 rows of o below t (the first D columns)
  __device__ __forceinline__ void store(__nv_bfloat16* o, int t) const {
    const int tq = threadIdx.x & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= t) continue;
      __nv_bfloat16* orow = o + static_cast<size_t>(row[r]) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * tq) =
            ecap::pack_bf16(acc[j][2 * r], acc[j][2 * r + 1]);
    }
  }
};

// rows [0, n) x D bf16 of `src` into smem rows of DP + 8, rows [n, np)
// and columns [D, DP) zero-filled; 16-byte cp.async copies
template <int D>
__device__ __forceinline__ void stage(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, int n, int np,
                                      int nthreads) {
  constexpr int DP = padded<D>(), VEC = DP / 8;
  for (int c = threadIdx.x; c < np * VEC; c += nthreads) {
    const int r = c / VEC, col = (c % VEC) * 8;
    const bool live = r < n && col < D;
    ecap::cp_async16(dst + r * (DP + 8) + col,
                     src + (live ? static_cast<size_t>(r) * D + col : 0),
                     live);
  }
}

// flash_head: one block per (b, h) holds the head's whole K and V in shared
// memory (read from device memory once, no ring, one barrier); each of the
// WARPS warps walks its 16-row query tiles (tile w, w + WARPS, ...) through
// both passes, q fragments loaded from device memory into registers.
template <int D, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
flash_head(const __nv_bfloat16* __restrict__ q,
           const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v,
           __nv_bfloat16* __restrict__ o, int t, int causal, int valid_len,
           float scale_log2) {
  constexpr int DP = padded<D>(), LD = DP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kend = min(t, valid_len);
  const int kp = (kend + 15) & ~15;  // keys staged, zero-filled past kend
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kp * LD;
  const size_t base = static_cast<size_t>(blockIdx.x) * t * D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;

  stage<D>(ks, k + base, kend, kp, WARPS * 32);
  stage<D>(vs, v + base, kend, kp, WARPS * 32);
  ecap::cp_async_commit();
  ecap::cp_async_wait<0>();
  __syncthreads();

  RowTile<D> rt;
  for (int r0 = warp * 16; r0 < t; r0 += WARPS * 16) {
    rt.init(r0);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + g + 8 * (i & 1);
        const int col = kk * 16 + 8 * (i >> 1) + 2 * tq;
        rt.qf[kk][i] =
            r < t && col < D ? *reinterpret_cast<const uint32_t*>(
                                   q + base + static_cast<size_t>(r) * D + col)
                             : 0u;
      }
    const int kstop = causal ? min(kend, r0 + 16) : kend;
    for (int k0 = 0; k0 < kstop; k0 += kBK)
      rt.template tile<false>(ks + k0 * LD, nullptr, k0, kstop, causal,
                              scale_log2);
    rt.finish_pass1();
    for (int k0 = 0; k0 < kstop; k0 += kBK)
      rt.template tile<true>(ks + k0 * LD, vs + k0 * LD, k0, kstop, causal,
                             scale_log2);
    rt.store(o + base, t);
  }
}

// flash_stream, for heads whose K and V do not fit flash_head: a block of
// 8 warps takes 128 queries of one (b, h) and streams K/V tiles of 64 keys
// through a 3-stage cp.async ring (pass 1 loads K, pass 2 K and V); the
// query tiles of one (b, h) are adjacent in the grid, so their K/V re-reads
// hit L2.
template <int D>
__global__ void __launch_bounds__(kStreamWarps * 32)
flash_stream(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             __nv_bfloat16* __restrict__ o, int t, int causal, int valid_len,
             float scale_log2) {
  constexpr int BQ = kStreamWarps * 16;
  constexpr int DP = padded<D>(), LD = DP + 8;
  constexpr int NT = kStreamWarps * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + BQ * LD;
  __nv_bfloat16* vs = ks + kStages * kBK * LD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t base = static_cast<size_t>(blockIdx.y) * t * D;
  const int q0 = blockIdx.x * BQ;
  const int w0 = q0 + warp * 16;  // this warp's first query row
  int kend = min(t, valid_len);
  if (causal) kend = min(kend, q0 + BQ);
  const int ntiles = (kend + kBK - 1) / kBK;
  const int total = 2 * ntiles;  // pass 1 tiles, then pass 2 tiles

  // load i into stage i % kStages: K of tile i (pass 1) or K and V of tile
  // i - ntiles (pass 2)
  auto load = [&](int i) {
    const bool with_v = i >= ntiles;
    const int k0 = (with_v ? i - ntiles : i) * kBK;
    const int n = min(kBK, kend - k0);
    stage<D>(ks + (i % kStages) * kBK * LD, k + base + static_cast<size_t>(k0) * D,
             n, kBK, NT);
    if (with_v)
      stage<D>(vs + (i % kStages) * kBK * LD,
               v + base + static_cast<size_t>(k0) * D, n, kBK, NT);
  };

  stage<D>(qs, q + base + static_cast<size_t>(q0) * D, min(BQ, t - q0), BQ, NT);
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load(s);
    ecap::cp_async_commit();  // the Q tile rides in group 0
  }

  RowTile<D> rt;
  rt.init(w0);
  for (int i = 0; i < total; ++i) {
    ecap::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (i + kStages - 1 < total) load(i + kStages - 1);
    ecap::cp_async_commit();
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        ecap::ldmatrix_x4(rt.qf[kk], qs + (warp * 16 + (lane & 15)) * LD +
                                         kk * 16 + (lane >> 4) * 8);
    }
    if (i == ntiles) rt.finish_pass1();
    const int k0 = (i < ntiles ? i : i - ntiles) * kBK;
    // a warp past the last row, or (causal) whose rows all precede the
    // tile, has nothing to do
    if (w0 >= t || (causal && k0 > w0 + 15)) continue;
    const int st = (i % kStages) * kBK * LD;
    if (i < ntiles)
      rt.template tile<false>(ks + st, nullptr, k0, kend, causal, scale_log2);
    else
      rt.template tile<true>(ks + st, vs + st, k0, kend, causal, scale_log2);
  }
  ecap::cp_async_wait<0>();
  rt.store(o + base, t);
}

template <int D>
__host__ __device__ constexpr int stream_smem() {
  return (kStreamWarps * 16 + 2 * kStages * kBK) * (padded<D>() + 8) * 2;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int t, int causal, int valid_len, float scale,
                   cudaStream_t stream) {
  static const cudaError_t configured = [] {
    cudaError_t e = cudaFuncSetAttribute(
        flash_head<D, 8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kHeadSmem2);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_head<D, 16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kHeadSmem1);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(flash_stream<D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                stream_smem<D>());
  }();
  if (configured != cudaSuccess) return configured;
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  auto* ob = static_cast<__nv_bfloat16*>(o);
  const float sl2 = scale * 1.4426950408889634f;  // exp(x) = ex2(x log2 e)
  const int kp = (std::min(t, valid_len) + 15) & ~15;
  const int head_smem = 2 * kp * (padded<D>() + 8) * 2;
  if (head_smem <= kHeadSmem2) {
    flash_head<D, 8><<<bh, 8 * 32, head_smem, stream>>>(
        qb, kb, vb, ob, t, causal, valid_len, sl2);
  } else if (head_smem <= kHeadSmem1) {
    flash_head<D, 16><<<bh, 16 * 32, head_smem, stream>>>(
        qb, kb, vb, ob, t, causal, valid_len, sl2);
  } else {
    const dim3 grid((t + kStreamWarps * 16 - 1) / (kStreamWarps * 16), bh);
    flash_stream<D><<<grid, kStreamWarps * 32, stream_smem<D>(), stream>>>(
        qb, kb, vb, ob, t, causal, valid_len, sl2);
  }
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// flash_wg: head dims 64 and 128
// ---------------------------------------------------------------------------
namespace wg {

namespace hw = ecap::hopper;

constexpr int kT = 64;          // keys a K/V tile, queries a Q tile
constexpr int kConsumers = 2;   // consumer warpgroups a block
constexpr int kThreads = (kConsumers + 1) * 128;  // and the producer
constexpr int kConsumerRegs = 240;  // registers a thread after setmaxnreg
constexpr int kProducerRegs = 24;
constexpr int kMaxStages = 24;  // the K/V ring
constexpr int kBox = kT * 64 * 2;  // one TMA box: 64 rows of 64 bf16

template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return kT * D * 2;  // D / 64 boxes side by side
}
template <int D>
__host__ __device__ constexpr int q_bytes() {
  return kConsumers * 2 * tile_bytes<D>();  // two Q slots a warpgroup
}
template <int D>
int stages() {
  const int room = static_cast<int>(ecap::kMaxSmem) - 1024 - q_bytes<D>() -
                   32 * kConsumers;
  return std::min(kMaxStages, room / (tile_bytes<D>() + 16));
}
template <int D>
int smem_bytes(int stages) {
  return 1024 + q_bytes<D>() + stages * (tile_bytes<D>() + 16) +
         32 * kConsumers;
}

struct Params {
  __nv_bfloat16* o;
  int bh, t, causal, kend;
  int stages, resident;
  float scale_log2;
};

// key tiles a query tile needs: up to its last row's diagonal if causal
__device__ __forceinline__ int item_tiles(const Params& p, int qt) {
  const int kstop = p.causal ? min(p.kend, (qt + 1) * kT) : p.kend;
  return (kstop + kT - 1) / kT;
}

// the producer's thread: every TMA load of the block, in the order the
// consumers use them
template <int D>
__device__ void produce(const CUtensorMap* tq, const CUtensorMap* tk,
                        const CUtensorMap* tv, unsigned char* qs,
                        unsigned char* ring, uint64_t* full, uint64_t* empty,
                        uint64_t* qfull, uint64_t* qempty, const Params& p) {
  constexpr int TB = tile_bytes<D>();
  const int nq = (p.t + kT - 1) / kT, n = (p.kend + kT - 1) / kT;
  uint32_t g = 0, qn[kConsumers] = {};
  int item = 0;
  auto load = [&](const CUtensorMap* m, unsigned char* dst, uint64_t* bar,
                  int row, int head) {
    hw::mbar_expect_tx(bar, TB);
#pragma unroll
    for (int h = 0; h < D / 64; ++h)
      hw::tma_load_3d(dst + h * kBox, m, bar, 64 * h, row, head);
  };
  auto put = [&](const CUtensorMap* m, int row, int head) {
    const uint32_t s = g % p.stages;
    hw::mbar_wait(empty + s, ((g / p.stages) & 1) ^ 1);
    load(m, ring + s * TB, full + s, row, head);
    ++g;
  };
  for (int head = blockIdx.x; head < p.bh; head += gridDim.x) {
    if (p.resident) {
      for (int j = 0; j < n; ++j) put(tk, j * kT, head);
      for (int j = 0; j < n; ++j) put(tv, j * kT, head);
    }
    for (int qt = 0; qt < nq; ++qt, ++item) {
      const int c = item % kConsumers;
      const uint32_t slot = 2 * c + (qn[c] & 1);
      hw::mbar_wait(qempty + slot, ((qn[c] >> 1) & 1) ^ 1);
      load(tq, qs + slot * TB, qfull + slot, qt * kT, head);
      ++qn[c];
      if (!p.resident) {
        const int ni = item_tiles(p, qt);
        for (int j = 0; j < ni; ++j) put(tk, j * kT, head);
        for (int j = 0; j < ni; ++j) {
          put(tk, j * kT, head);
          put(tv, j * kT, head);
        }
      }
    }
  }
}

// Scores at or past `kend` and, if causal, past a row are -1e30: the
// W / 2 accumulator registers of a W-key tile at key k0, rows row0 and
// row0 + 8 (selects, no branches)
template <int W>
__device__ __forceinline__ void mask_tile(float* s, int k0, int kend,
                                          int causal, int row0) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int e = 0; e < W / 2; ++e) {
    const int key = k0 + 8 * (e >> 2) + 2 * tq + (e & 1);
    const int row = row0 + 8 * ((e >> 1) & 1);
    s[e] = key >= kend || (causal && key > row) ? ecap::kNegInf : s[e];
  }
}

// the max and the sum over a quad: the four lanes that hold a row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// p of 16 keys (accumulator registers s[0..7] of two 8-key chunks) times
// the rows' factors -> the bf16 A fragment of the PV product
__device__ __forceinline__ void pack_p(uint32_t a[4], const float* s,
                                       float f0, float f1) {
  a[0] = ecap::pack_bf16(s[0] * f0, s[1] * f0);
  a[1] = ecap::pack_bf16(s[2] * f1, s[3] * f1);
  a[2] = ecap::pack_bf16(s[4] * f0, s[5] * f0);
  a[3] = ecap::pack_bf16(s[6] * f1, s[7] * f1);
}

// S = Q K^T for one K tile into the W / 2 registers at s
template <int D, int W>
__device__ __forceinline__ void qk_tile(float* s, const unsigned char* qt,
                                        const unsigned char* kt) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / 4) * kBox + (kk % 4) * 32;
    const uint64_t da = hw::desc_sw128(qt + off);
    const uint64_t db = hw::desc_sw128(kt + off);
    if constexpr (W == 16)
      hw::wgmma_ss_n16<0>(s, da, db, kk);
    else
      hw::wgmma_ss_n64<0>(s, da, db, kk);
  }
}

// O += P V for one 16-key chunk (chunk c4 of a V tile)
template <int D>
__device__ __forceinline__ void pv_chunk(float* o, const uint32_t a[4],
                                         const unsigned char* vt, int c4,
                                         int scale_d) {
#pragma unroll
  for (int h = 0; h < D / 64; ++h)
    hw::wgmma_rs_n64_tb(o + 32 * h, a,
                        hw::desc_sw128(vt + h * kBox + c4 * 2048), scale_d);
}

// The code between warpgroup products has no branch that differs between
// the threads of a warpgroup (the masks are selects; rows past t are
// computed like the others, their zero q giving finite p, and not
// stored): a divergent definition of a register a product reads makes the
// compiler serialise the products.

// One query tile with the whole row of scores in registers: NKT key tiles
// (all of the head's, K/V resident), the last one 16 keys wide where NKT
// is 5 (D = 64).
template <int NKT>
__device__ __forceinline__ void tile_in_registers(
    float* o, const unsigned char* qt, const unsigned char* ring,
    uint64_t* full, uint32_t hbase, int q0, int row0, const Params& p) {
  constexpr int D = 64, TB = tile_bytes<D>();
  constexpr int LW = NKT == 5 ? 16 : 64;  // the last tile's keys
  constexpr int NR = (NKT - 1) * 32 + LW / 2;
  constexpr int NCH = (NKT - 1) * 4 + LW / 16;  // 16-key chunks
  const uint32_t S = p.stages;

  float s[NR];
  hw::wgmma_fence();
#pragma unroll
  for (int j = 0; j < NKT; ++j) {
    const uint32_t u = hbase + j;
    hw::mbar_wait(full + u % S, (u / S) & 1);
    if (j == NKT - 1)
      qk_tile<D, LW>(s + 32 * j, qt, ring + (u % S) * TB);
    else
      qk_tile<D, 64>(s + 32 * j, qt, ring + (u % S) * TB);
  }
  hw::wgmma_commit();
  hw::wgmma_wait<0>();
  hw::fence_regs<NR>(s);

#pragma unroll
  for (int j = 0; j < NKT; ++j) {
    if (j == NKT - 1) {
      if (p.causal || 64 * j + LW > p.kend)
        mask_tile<LW>(s + 32 * j, 64 * j, p.kend, p.causal, row0);
    } else if (p.causal || 64 * j + 64 > p.kend) {
      mask_tile<64>(s + 32 * j, 64 * j, p.kend, p.causal, row0);
    }
  }
  float mx0 = ecap::kNegInf, mx1 = ecap::kNegInf;
#pragma unroll
  for (int e = 0; e < NR; e += 4) {
    mx0 = fmaxf(mx0, fmaxf(s[e], s[e + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[e + 2], s[e + 3]));
  }
  const float c = p.scale_log2;
  const float m0 = quad_max(mx0) * c, m1 = quad_max(mx1) * c;
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int e = 0; e < NR; e += 4) {
    s[e] = ex2(fmaf(s[e], c, -m0));
    s[e + 1] = ex2(fmaf(s[e + 1], c, -m0));
    s[e + 2] = ex2(fmaf(s[e + 2], c, -m1));
    s[e + 3] = ex2(fmaf(s[e + 3], c, -m1));
    l0 += s[e] + s[e + 1];
    l1 += s[e + 2] + s[e + 3];
  }
  const float f0 = 1.f / quad_sum(l0), f1 = 1.f / quad_sum(l1);

  uint32_t pa[NCH][4];
#pragma unroll
  for (int k = 0; k < NCH; ++k)
    pack_p(pa[k], s + 32 * (k / 4) + 8 * (k % 4), f0, f1);
  hw::wgmma_fence();
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    const uint32_t u = hbase + NKT + k / 4;
    if (k % 4 == 0) hw::mbar_wait(full + u % S, (u / S) & 1);
    pv_chunk<D>(o, pa[k], ring + (u % S) * TB, k % 4, k > 0);
  }
  hw::wgmma_commit();
  hw::wgmma_wait<0>();
  hw::fence_regs<32>(o);
}

// One query tile in two passes over its nt key tiles (S recomputed), K/V
// resident (stage of K_j: hbase + j, V_j: hbase + n + j) or streamed for
// this tile (K_j: ibase + j in pass 1; K_j, V_j: ibase + nt + 2 j and + 1
// in pass 2, each released once read)
template <int D>
__device__ __forceinline__ void tile_two_pass(
    float* o, const unsigned char* qt, const unsigned char* ring,
    uint64_t* full, uint64_t* empty, uint32_t hbase, uint32_t ibase, int n,
    int nt, int row0, const Params& p) {
  constexpr int TB = tile_bytes<D>();
  const uint32_t S = p.stages;
  const float c = p.scale_log2;
  auto scores = [&](float* s, uint32_t u, int j) {
    hw::mbar_wait(full + u % S, (u / S) & 1);
    hw::wgmma_fence();
    qk_tile<D, 64>(s, qt, ring + (u % S) * TB);
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs<32>(s);
    if (!p.resident) hw::mbar_arrive(empty + u % S);
    mask_tile<64>(s, 64 * j, p.kend, p.causal, row0);
  };

  float s[32];
  float m0 = ecap::kNegInf, m1 = ecap::kNegInf, l0 = 0.f, l1 = 0.f;
  for (int j = 0; j < nt; ++j) {
    scores(s, p.resident ? hbase + j : ibase + j, j);
    float mx0 = ecap::kNegInf, mx1 = ecap::kNegInf;
#pragma unroll
    for (int e = 0; e < 32; e += 4) {
      mx0 = fmaxf(mx0, fmaxf(s[e], s[e + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[e + 2], s[e + 3]));
    }
    const float n0 = fmaxf(m0, quad_max(mx0) * c);
    const float n1 = fmaxf(m1, quad_max(mx1) * c);
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int e = 0; e < 32; e += 4) {
      a0 += ex2(fmaf(s[e], c, -n0)) + ex2(fmaf(s[e + 1], c, -n0));
      a1 += ex2(fmaf(s[e + 2], c, -n1)) + ex2(fmaf(s[e + 3], c, -n1));
    }
    l0 = l0 * ex2(m0 - n0) + a0;
    l1 = l1 * ex2(m1 - n1) + a1;
    m0 = n0;
    m1 = n1;
  }
  // exp(s - max) / l = ex2(s c - (max c + log2 l)); l >= 1
  m0 += log2f(quad_sum(l0));
  m1 += log2f(quad_sum(l1));

#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  for (int j = 0; j < nt; ++j) {
    const uint32_t uk = p.resident ? hbase + j : ibase + nt + 2 * j;
    const uint32_t uv = p.resident ? hbase + n + j : ibase + nt + 2 * j + 1;
    scores(s, uk, j);
#pragma unroll
    for (int e = 0; e < 32; e += 4) {
      s[e] = ex2(fmaf(s[e], c, -m0));
      s[e + 1] = ex2(fmaf(s[e + 1], c, -m0));
      s[e + 2] = ex2(fmaf(s[e + 2], c, -m1));
      s[e + 3] = ex2(fmaf(s[e + 3], c, -m1));
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int c4 = 0; c4 < 4; ++c4) pack_p(pa[c4], s + 8 * c4, 1.f, 1.f);
    hw::mbar_wait(full + uv % S, (uv / S) & 1);
    hw::wgmma_fence();
#pragma unroll
    for (int c4 = 0; c4 < 4; ++c4)
      pv_chunk<D>(o, pa[c4], ring + (uv % S) * TB, c4, 1);
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs<D / 2>(o);
    if (!p.resident) hw::mbar_arrive(empty + uv % S);
  }
}

// NKT > 0: the score rows in registers (D = 64, resident K/V); 0: two
// passes. Warpgroups 0 and 1 consume; warpgroup 2 produces (one thread)
// and hands its registers to them.
template <int D, int NKT>
__global__ void __launch_bounds__(kThreads, 1)
flash_wg(const __grid_constant__ CUtensorMap tq,
         const __grid_constant__ CUtensorMap tk,
         const __grid_constant__ CUtensorMap tv, const Params p) {
  static_assert(NKT == 0 || D == 64, "register scores are for D = 64");
  constexpr int TB = tile_bytes<D>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = hw::align1024(smem_raw);
  unsigned char* ring = qs + q_bytes<D>();
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + p.stages * TB);
  uint64_t* empty = full + p.stages;
  uint64_t* qfull = empty + p.stages;       // [kConsumers][2]
  uint64_t* qempty = qfull + 2 * kConsumers;
  if (threadIdx.x == 0) {
    const uint32_t readers = 128 * (p.resident ? kConsumers : 1);
    for (int s = 0; s < p.stages; ++s) {
      hw::mbar_init(full + s, 1);
      hw::mbar_init(empty + s, readers);
    }
    for (int i = 0; i < 2 * kConsumers; ++i) {
      hw::mbar_init(qfull + i, 1);
      hw::mbar_init(qempty + i, 128);
    }
    hw::mbar_init_fence();
  }
  __syncthreads();
  // the warpgroup, shuffled from lane 0 so the compiler knows it uniform
  // over the warp
  const int c = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (c == kConsumers) {
    hw::regs_dec<kProducerRegs>();
    if (threadIdx.x == 128 * kConsumers)
      produce<D>(&tq, &tk, &tv, qs, ring, full, empty, qfull, qempty, p);
    return;
  }
  hw::regs_inc<kConsumerRegs>();

  const int w = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq4 = lane & 3;
  const int nq = (p.t + kT - 1) / kT, n = (p.kend + kT - 1) / kT;
  uint32_t u = 0, qn = 0;  // ring tiles and own query tiles so far
  int item = 0;
  for (int head = blockIdx.x; head < p.bh; head += gridDim.x) {
    const uint32_t hbase = u;
    if (p.resident) u += 2 * n;
    __nv_bfloat16* ob = p.o + static_cast<size_t>(head) * p.t * D;
    for (int qt = 0; qt < nq; ++qt, ++item) {
      const uint32_t ibase = u;
      const int nt = item_tiles(p, qt);
      if (!p.resident) u += 3 * nt;
      if (item % kConsumers != c) continue;
      const uint32_t slot = 2 * c + (qn & 1);
      hw::mbar_wait(qfull + slot, (qn >> 1) & 1);
      const unsigned char* qtile = qs + slot * TB;
      const int row0 = qt * kT + 16 * w + g;
      float o[D / 2];
      if constexpr (NKT > 0)
        tile_in_registers<NKT>(o, qtile, ring, full, hbase, qt * kT, row0, p);
      else
        tile_two_pass<D>(o, qtile, ring, full, empty, hbase, ibase, n, nt,
                         row0, p);
      hw::mbar_arrive(qempty + slot);
      ++qn;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = row0 + 8 * i;
        if (r >= p.t) continue;
        __nv_bfloat16* orow = ob + static_cast<size_t>(r) * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * tq4) =
              ecap::pack_bf16(o[4 * j + 2 * i], o[4 * j + 2 * i + 1]);
      }
    }
    if (p.resident)
      for (int i = 0; i < 2 * n; ++i)
        hw::mbar_arrive(empty + (hbase + i) % p.stages);
  }
}

inline int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
}

template <int D, int NKT>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int t, int causal, int kend, float scale,
                   cudaStream_t stream) {
  static const cudaError_t configured = cudaFuncSetAttribute(
      flash_wg<D, NKT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(ecap::kMaxSmem));
  if (configured != cudaSuccess) return configured;
  CUtensorMap maps[3];
  const uint64_t dims[3] = {static_cast<uint64_t>(D),
                            static_cast<uint64_t>(t),
                            static_cast<uint64_t>(bh)};
  const uint64_t strides[2] = {static_cast<uint64_t>(D) * 2,
                               static_cast<uint64_t>(t) * D * 2};
  const uint32_t box[3] = {64, kT, 1};
  const void* src[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t e = hw::make_map(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                       3, src[i], dims, strides, box, true);
    if (e != cudaSuccess) return e;
  }
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.bh = bh;
  p.t = t;
  p.causal = causal;
  p.kend = kend;
  p.stages = stages<D>();
  p.resident = 2 * ((kend + kT - 1) / kT) <= p.stages;
  p.scale_log2 = scale * 1.4426950408889634f;  // exp(x) = ex2(x log2 e)
  const int grid = std::min(bh, sm_count());
  flash_wg<D, NKT><<<grid, kThreads, smem_bytes<D>(p.stages), stream>>>(
      maps[0], maps[1], maps[2], p);
  return cudaGetLastError();
}

// nkt > 0: the register-score instance over nkt key tiles (D = 64, at most
// 5); 0: two passes
template <int D>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int bh, int t, int causal, int kend, float scale,
                     int nkt, cudaStream_t s) {
  if constexpr (D == 64) {
    switch (nkt) {
      case 1: return launch<D, 1>(q, k, v, o, bh, t, causal, kend, scale, s);
      case 2: return launch<D, 2>(q, k, v, o, bh, t, causal, kend, scale, s);
      case 3: return launch<D, 3>(q, k, v, o, bh, t, causal, kend, scale, s);
      case 4: return launch<D, 4>(q, k, v, o, bh, t, causal, kend, scale, s);
      case 5: return launch<D, 5>(q, k, v, o, bh, t, causal, kend, scale, s);
      default: break;
    }
  }
  return launch<D, 0>(q, k, v, o, bh, t, causal, kend, scale, s);
}

}  // namespace wg

}  // namespace

// q, k, v, o: contiguous bf16 [bh, t, d], 16-byte aligned; keys at index
// >= valid_len are masked. `kernel` is the choice of `flash_plan`
// (kernels/flash_attention.py), which alone decides; it is checked here
// only against what each kernel instance can take: -1 flash_head /
// flash_stream at head dims 8-32; 0 flash_wg in two passes at 64 and 128;
// n in 1..5 flash_wg<64, n>, whose scores in registers are n key tiles
// (the fifth 16 keys wide), where those are the live keys' tiles. Returns
// the launch's cudaError_t, cudaErrorInvalidValue for a kernel that
// cannot take the call.
extern "C" int ecap_flash_attention(const void* q, const void* k,
                                    const void* v, void* o, int bh, int t,
                                    int d, int causal, int valid_len,
                                    float sm_scale, int kernel,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kend = std::min(t, valid_len);
  const int tiles = (kend + wg::kT - 1) / wg::kT;
  const int reach = kernel == 5 ? 4 * wg::kT + 16 : kernel * wg::kT;
  const bool takes =
      kernel == -1  ? d == 8 || d == 16 || d == 32
      : kernel == 0 ? d == 64 || d == 128
                    : d == 64 && kernel <= 5 && kernel == tiles &&
                          kend <= reach;
  if (!takes) return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 8: return launch<8>(q, k, v, o, bh, t, causal, valid_len, sm_scale, s);
    case 16: return launch<16>(q, k, v, o, bh, t, causal, valid_len, sm_scale, s);
    case 32: return launch<32>(q, k, v, o, bh, t, causal, valid_len, sm_scale, s);
    case 64:
      return wg::dispatch<64>(q, k, v, o, bh, t, causal, kend, sm_scale,
                              kernel, s);
    case 128:
      return wg::dispatch<128>(q, k, v, o, bh, t, causal, kend, sm_scale, 0,
                               s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
