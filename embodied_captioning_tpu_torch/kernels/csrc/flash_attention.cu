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
// the tensor-core peak. The numerics need the row sum before any p is
// rounded, so the kernel makes two passes over the keys: 1.5x the matrix
// work and two exponentials per score, where a one-pass flash kernel
// (SDPA's) does one.
//
// Design (FlashAttention-2's inner loop on mma.sync, RowTile below):
//  - Tensor cores. A warp owns 16 query rows. QK^T and PV are
//    mma.sync.m16n8k16 with bf16 inputs and f32 accumulators; K and V come
//    from shared memory through ldmatrix (V through ldmatrix.trans), the q
//    fragments stay in registers for both passes.
//  - Two passes over 64-key tiles: pass 1 keeps the running row max and
//    denominator of each S tile in registers (quad shuffles across the 4
//    lanes that share a row); pass 2 recomputes S, forms
//    p = exp(s - m) / l as one ex2 of a fused multiply-add (the scale, log2
//    e and log2 l folded in), rounds it to bf16 and packs it straight from
//    the accumulator fragment into the A fragment of the PV product -- no
//    shared-memory round trip. A single online pass would round
//    unnormalised p (the blocked TPU kernel's numerics), so the extra QK^T
//    pass stays.
//  - Work skipped: 16-key steps at or past the last live key (the last tile
//    of T=257 computes 16 keys, not 64), key tiles wholly above a warp's
//    causal diagonal; masking only on tiles that reach past either.
//  - flash_head (the ViT path): one block per (b, h) stages the head's whole
//    K and V in shared memory with 16-byte cp.async copies -- read from
//    device memory once, one barrier, no ring -- and its warps walk the
//    16-row query tiles. 8 warps while two blocks fit an SM (78 KB at
//    T=257, D=64: 16 warps per SM); 16 warps and one block up to 200 KB
//    (T=640, D=64). Rows are padded by 16 bytes so that the 8 row addresses
//    of an ldmatrix fall in 8 different bank groups.
//  - flash_stream (K/V beyond 200 KB, or D=128 past 110 KB, where 16 warps
//    do not fit the register file): a block of 8 warps takes 128 queries
//    and streams 64-key K/V tiles through a 3-stage cp.async ring (pass 1
//    loads K, pass 2 K and V); the query blocks of one head are adjacent in
//    the grid, so their K/V re-reads hit L2.
//    Streaming 64-query blocks at T=257 as well spent the time waiting on
//    the ring (3 blocks of 4 warps per SM); holding the whole head removes
//    the waits and the K/V re-reads. At T=640 one 16-warp flash_head per SM
//    beats two 8-warp flash_stream blocks; one 8-warp flash_head per SM
//    loses to both.
//  - Head dims 8 and 16 (the query detector's decoder: fpn_dim / 8 heads):
//    the mma k-extent is 16, so a head of 8 is computed 16 wide -- the
//    upper 8 columns of the K and V tiles are zero-filled in shared memory
//    and those of the q fragments are zero, so the scores are unchanged and
//    the extra output columns (zero) are not stored. D = 16 needs no
//    padding: one k-step for QK^T and two n-steps of 8 for PV.
#include <algorithm>

#include "mma.cuh"

namespace {

constexpr int kBK = 64;          // keys per tile
constexpr int kStreamWarps = 8;  // flash_stream: 128 queries per block
constexpr int kStages = 3;       // flash_stream's cp.async ring depth
// flash_head: one (b, h) per block, 8 warps while two blocks fit an SM,
// else 16 (D <= 64, where 16 warps fit the register file)
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
  constexpr bool kWide = D <= 64;  // 16 warps of flash_head fit
  static const cudaError_t configured = [] {
    cudaError_t e = cudaFuncSetAttribute(
        flash_head<D, 8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kHeadSmem2);
    if (e == cudaSuccess && kWide)
      e = cudaFuncSetAttribute(flash_head<D, kWide ? 16 : 8>,
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
  } else if (kWide && head_smem <= kHeadSmem1) {
    flash_head<D, kWide ? 16 : 8><<<bh, (kWide ? 16 : 8) * 32, head_smem,
                                    stream>>>(qb, kb, vb, ob, t, causal,
                                              valid_len, sl2);
  } else {
    const dim3 grid((t + kStreamWarps * 16 - 1) / (kStreamWarps * 16), bh);
    flash_stream<D><<<grid, kStreamWarps * 32, stream_smem<D>(), stream>>>(
        qb, kb, vb, ob, t, causal, valid_len, sl2);
  }
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: contiguous bf16 [bh, t, d], 16-byte aligned; keys at index
// >= valid_len are masked. Returns the launch's cudaError_t.
extern "C" int ecap_flash_attention(const void* q, const void* k,
                                    const void* v, void* o, int bh, int t,
                                    int d, int causal, int valid_len,
                                    float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 8: return launch<8>(q, k, v, o, bh, t, causal, valid_len, sm_scale, s);
    case 16: return launch<16>(q, k, v, o, bh, t, causal, valid_len, sm_scale, s);
    case 32: return launch<32>(q, k, v, o, bh, t, causal, valid_len, sm_scale, s);
    case 64: return launch<64>(q, k, v, o, bh, t, causal, valid_len, sm_scale, s);
    case 128: return launch<128>(q, k, v, o, bh, t, causal, valid_len, sm_scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
