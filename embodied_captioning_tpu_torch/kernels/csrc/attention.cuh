// Single-query decode attention, shared by the standalone attention kernels
// (decode_attention.cu: bf16 query, f32 output) and the whole-block decode
// kernels (decode_block.cu: f32 query, bf16 output).
//
// Self-attention (decode_self_kernel): one block per (batch row, head). The
// block stages q in shared memory, gives each thread a key (the q.k
// reduction runs over Dh with the key index as the fastest-moving address,
// so a warp's loads of the time-minor kt layout are contiguous), masks,
// takes the f32 softmax with block reductions (probabilities stay f32, as
// in the TPU kernels), then splits the PV sum over Dh lanes x groups of
// keys and reduces the groups in shared memory. K and V are read once,
// straight from device memory.
//
// Cross-attention (cross_attn_kernel), which the serving decode loop runs
// 12 times per step: at 64 rows, 12 heads of 64 and 256 int8 keys it reads
// 25.2 MB of K/V, ~7.5 us at 3.35 TB/s, so it is a copy with a little
// arithmetic. A block of 4 warps per (row, head) puts the head's whole kt
// [Dh, K] and v [K, Dh] blocks (16 KB each), kt_scale [K] and v_scale [Dh]
// in flight at once as 16-byte cp.async copies into shared memory: one
// memory latency per block, where a serial walk over Dh pays one per step.
// At 37 KB of shared memory six blocks share an SM, so the 768 blocks of
// the serving step run in one wave. Then thread i takes keys 4i .. 4i + 3
// of QK^T (one 4- or 8-byte shared load per dim feeds four sums over Dh,
// in order) while V is still landing, the block takes the f32 softmax,
// and thread (g, c) sums dims 4c .. 4c + 3 of PV over keys g, g + G, ...;
// the G group sums are added in group order. No sum depends on the
// schedule, so two runs give the same bits. Each K/V element is converted
// to f32 once, 32 K per block, and at int8 by a byte permute and an add
// (`load4`): the card's integer-to-float conversion runs at 16 a clock per
// SM, which for 25M elements a call is ~7 us. K/V are inputs of the decode
// step, not outputs of the launch before, so in the cross block their
// copies go out before grid_dependency_wait, and only q waits for the q
// product. cross_attn_tiled_kernel takes every other shape, so that the
// cross attention takes any number of keys, as the TPU kernel does: a
// head whose K/V do not fit one block's shared memory (some 870 bf16 or
// 1700 int8 keys at Dh 64; no preset comes near) goes through in tiles of
// keys with an online softmax, the next tile's K in flight while the
// current one's softmax and PV run; so do K not a multiple of 4 and heads
// wider than 512.
#pragma once

#include "mma.cuh"

namespace ecap {

constexpr int kAttnThreads = 256;

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// out[d] = sum_j p[j] * V(j, d) / denom, with V(j, d) read at
// v[j * vstride + d]. `red` holds kAttnThreads floats.
template <typename T, typename TO>
__device__ void pv_sum(const float* p, const T* __restrict__ v, int n,
                       int vstride, int dh, float denom, float* red,
                       TO* __restrict__ out) {
  const int groups = max(1, kAttnThreads / dh);
  for (int base = 0; base < dh; base += kAttnThreads) {
    const int idx = threadIdx.x;
    const int g = idx / dh;
    const int d = base + idx % dh;
    float acc = 0.f;
    if (g < groups && d < dh) {
      for (int j = g; j < n; j += groups)
        acc = fmaf(p[j], to_float(v[static_cast<size_t>(j) * vstride + d]),
                   acc);
    }
    __syncthreads();
    red[idx] = acc;
    __syncthreads();
    if (idx < dh && base + idx < dh) {
      float s = 0.f;
      for (int gg = 0; gg < groups; ++gg) s += red[gg * dh + idx];
      store_out(out + base + idx, s / denom);
    }
  }
}

// q [B,H,Dh]; kt [B,H,Dh,T] bf16; v [B,T,H,Dh] bf16; out [B,H,Dh]. Keys at
// positions > pos are masked.
template <typename TQ, typename TO>
__global__ void __launch_bounds__(kAttnThreads)
decode_self_kernel(const TQ* __restrict__ q,
                   const __nv_bfloat16* __restrict__ kt,
                   const __nv_bfloat16* __restrict__ v, TO* __restrict__ out,
                   int h, int dh, int t, int pos) {
  extern __shared__ float sm[];
  float* qs = sm;            // dh
  float* p = qs + dh;        // t
  float* red = p + t;        // kAttnThreads
  const int bh = blockIdx.x;
  const int b = bh / h, hh = bh % h;
  for (int d = threadIdx.x; d < dh; d += kAttnThreads)
    qs[d] = to_float(q[static_cast<size_t>(bh) * dh + d]);
  __syncthreads();
  const __nv_bfloat16* kp = kt + static_cast<size_t>(bh) * dh * t;
  const float rs = sqrtf(static_cast<float>(dh));
  float lmax = kNegInf;
  for (int j = threadIdx.x; j < t; j += kAttnThreads) {
    float acc = 0.f;
    for (int d = 0; d < dh; ++d)
      acc = fmaf(qs[d], to_float(kp[static_cast<size_t>(d) * t + j]), acc);
    const float s = j <= pos ? acc / rs : kNegInf;
    p[j] = s;
    lmax = fmaxf(lmax, s);
  }
  const float m = block_max(lmax, red);
  float lsum = 0.f;
  for (int j = threadIdx.x; j < t; j += kAttnThreads) {
    const float e = expf(p[j] - m);
    p[j] = e;
    lsum += e;
  }
  const float denom = block_sum(lsum, red);
  __syncthreads();
  // V(j, d) = v[((b * T + j) * H + hh) * Dh + d]
  pv_sum(p, v + (static_cast<size_t>(b) * t * h + hh) * dh, t, h * dh, dh,
         denom, red, out + static_cast<size_t>(bh) * dh);
}

inline size_t attn_smem_bytes(int dh, int n) {
  return sizeof(float) * (static_cast<size_t>(dh) + n + kAttnThreads);
}

// Opt in to more than 48 KB of dynamic shared memory where a long key axis
// needs it.
template <typename K>
cudaError_t attn_set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Launch helpers, shared by both translation units.
template <typename TQ, typename TO>
cudaError_t launch_decode_self(const TQ* q, const __nv_bfloat16* kt,
                               const __nv_bfloat16* v, TO* out, int b, int h,
                               int dh, int t, int pos, cudaStream_t s) {
  const size_t bytes = attn_smem_bytes(dh, t);
  cudaError_t err = attn_set_smem(decode_self_kernel<TQ, TO>, bytes);
  if (err != cudaSuccess) return err;
  decode_self_kernel<TQ, TO><<<b * h, kAttnThreads, bytes, s>>>(
      q, kt, v, out, h, dh, t, pos);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// cross-attention
// ---------------------------------------------------------------------------

constexpr int kCrossThreads = 128;
constexpr int kCrossBlocksPerSm = 6;  // at the serving shape (int8 K/V)
constexpr int kCrossMaxDh = 4096;     // a tile of 4 keys fits at any type

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// PV's groups of keys: thread (g, c) of G = kCrossThreads / (Dh / 4)
// groups sums dims 4c .. 4c + 3; past Dh = 512 one group, each thread
// taking every 128th four dims
__host__ __device__ constexpr int cross_groups(int dh) {
  return dh / 4 >= kCrossThreads ? 1 : kCrossThreads / (dh / 4);
}

// Shared memory of the cross-attention kernels for tiles of tk keys (the
// whole head: tk = K), byte offsets of its parts (each 16-byte aligned):
// kt as Dh rows of ldk keys (tk rounded up to 4), v as tk rows of Dh, then
// f32 q, kt_scale, v_scale, the output sums (tiled kernel only), the
// scores and the reduction scratch.
struct CrossSmem {
  int ldk;
  size_t vs, qs, ksc, vsc, o, p, red, total;
};
__host__ __device__ inline CrossSmem cross_smem(int dh, int tk, int tsize) {
  CrossSmem s;
  s.ldk = (tk + 3) & ~3;
  s.vs = align16(static_cast<size_t>(dh) * s.ldk * tsize);
  s.qs = s.vs + align16(static_cast<size_t>(tk) * dh * tsize);
  s.ksc = s.qs + align16(sizeof(float) * dh);
  s.vsc = s.ksc + align16(sizeof(float) * s.ldk);
  s.o = s.vsc + align16(sizeof(float) * dh);
  s.p = s.o + align16(sizeof(float) * dh);
  s.red = s.p + align16(sizeof(float) * s.ldk);
  const int red = cross_groups(dh) * dh;
  s.total = s.red + sizeof(float) * (red > 32 ? red : 32);
  return s;
}

// cross_attn_kernel takes a head whole: K a multiple of 4 (16-byte copies
// at either type), Dh up to 512 (one thread per four dims of PV), the
// head's K/V in one block's shared memory and 16-byte aligned blocks --
// every preset. cross_attn_tiled_kernel takes the rest.
inline bool cross_whole(int dh, int nk, int tsize, const void* kt,
                        const void* v, const float* kt_scale,
                        const float* v_scale) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  return nk % 4 == 0 && dh <= 512 &&
         cross_smem(dh, nk, tsize).total <= kMaxSmem && aligned(kt) &&
         aligned(v) && aligned(kt_scale) && aligned(v_scale);
}

// Keys per tile of cross_attn_tiled_kernel: all of them where the head's
// K/V fit one block's shared memory, else the most that fit, a multiple of
// 16 (rows of 16-byte copies at either type) where one fits, else of 4; 0
// if none.
inline int cross_tile(int dh, int nk, int tsize) {
  if (cross_smem(dh, nk, tsize).total <= kMaxSmem) return nk;
  const int most = static_cast<int>(kMaxSmem / (2 * dh * tsize));
  for (int step : {16, 4})
    for (int tk = (nk < most ? nk : most) / step * step; tk >= step;
         tk -= step)
      if (cross_smem(dh, tk, tsize).total <= kMaxSmem) return tk;
  return 0;
}

// The shapes the cross attention takes: Dh a multiple of 8 (q and the
// scales in 16-byte vectors, four dims per PV thread) up to kCrossMaxDh,
// and any number of keys.
inline bool cross_attn_fits(int dh, int nk, int tsize) {
  return dh >= 8 && dh % 8 == 0 && dh <= kCrossMaxDh && nk >= 1 &&
         cross_tile(dh, nk, tsize) > 0;
}

// rows x cols elements from src (row stride lds) into shared memory at dst
// (row stride ldd): 16-byte cp.async copies where every row allows them,
// else element by element (in place by the next __syncthreads); one row
// (a tile's V, a whole head's kt) with no index arithmetic past the
// vector's.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ldd, const T* src,
                                      size_t lds, int rows, int cols) {
  const int row_bytes = cols * static_cast<int>(sizeof(T));
  const bool vec =
      row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
      (rows == 1 ||
       ((lds * sizeof(T)) % 16 == 0 && (ldd * sizeof(T)) % 16 == 0));
  const int per_row = row_bytes / 16;
  if (vec && rows == 1) {
    for (int c = threadIdx.x; c < per_row; c += kCrossThreads)
      cp_async16(reinterpret_cast<uint4*>(dst) + c,
                 reinterpret_cast<const uint4*>(src) + c, true);
  } else if (vec) {
    for (int c = threadIdx.x; c < rows * per_row; c += kCrossThreads) {
      const int r = c / per_row, e = c - r * per_row;
      cp_async16(reinterpret_cast<uint4*>(dst + r * ldd) + e,
                 reinterpret_cast<const uint4*>(src + r * lds) + e, true);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += kCrossThreads) {
      const int r = e / cols, c = e - r * cols;
      dst[r * ldd + c] = src[r * lds + c];
    }
  }
}

// four consecutive elements of shared memory as floats (4- or 8-byte
// aligned). int8: the card converts an integer to a float at 16 a clock
// per SM, a quarter of the rate of a byte permute and an eighth of an
// add, so each byte b + 128 is put into the mantissa of 2^23 and
// 2^23 + 128 subtracted -- exact, as every int8 is.
__device__ __forceinline__ void load4(const int8_t* p, float f[4]) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __int_as_float(static_cast<int>(
               __byte_perm(w, 0x4b000000u, 0x7540u | i))) -
           8388736.f;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float f[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  f[0] = a.x;
  f[1] = a.y;
  f[2] = b.x;
  f[3] = b.y;
}

// q [B,H,Dh]; kt [B,H,Dh,K] and v [B,H,K,Dh] (int8 or bf16); kt_scale
// [B,H,K] and v_scale [B,H,Dh] f32 or null (= 1); out [B,H,Dh]. One block
// per (row, head); the shape as cross_whole takes it. The scores are
// (q.k) / sqrt(Dh) * kt_scale; v_scale multiplies PV before the division
// by the denominator.
template <typename T, typename TQ, typename TO>
__global__ void __launch_bounds__(kCrossThreads, kCrossBlocksPerSm)
cross_attn_kernel(const TQ* __restrict__ q, const T* __restrict__ kt,
                  const T* __restrict__ v, const float* __restrict__ kt_scale,
                  const float* __restrict__ v_scale, TO* __restrict__ out,
                  int dh, int nk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const CrossSmem L = cross_smem(dh, nk, sizeof(T));
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = reinterpret_cast<T*>(smem_raw + L.vs);
  float* qs = reinterpret_cast<float*>(smem_raw + L.qs);
  float* ksc = reinterpret_cast<float*>(smem_raw + L.ksc);
  float* vsc = reinterpret_cast<float*>(smem_raw + L.vsc);
  float* p = reinterpret_cast<float*>(smem_raw + L.p);
  float* red = reinterpret_cast<float*>(smem_raw + L.red);
  const int tid = threadIdx.x, ldk = L.ldk;
  const size_t bh = blockIdx.x;
  const T* kg = kt + bh * dh * nk;
  const T* vg = v + bh * nk * dh;
  const float* kscg = kt_scale == nullptr ? nullptr : kt_scale + bh * nk;
  const float* vscg = v_scale == nullptr ? nullptr : v_scale + bh * dh;

  // K and kt_scale, then V and v_scale, as two groups of copies, all in
  // flight at once; QK^T starts when the first group has landed
  const int kv = dh * nk * static_cast<int>(sizeof(T)) / 16;
  {
    const int nks = kscg == nullptr ? 0 : nk / 4;
    for (int c = tid; c < kv + nks; c += kCrossThreads) {
      if (c < kv)
        cp_async16(reinterpret_cast<uint4*>(ks) + c,
                   reinterpret_cast<const uint4*>(kg) + c, true);
      else
        cp_async16(ksc + 4 * (c - kv), kscg + 4 * (c - kv), true);
    }
  }
  cp_async_commit();
  {
    const int nvs = vscg == nullptr ? 0 : dh / 4;
    for (int c = tid; c < kv + nvs; c += kCrossThreads) {
      if (c < kv)
        cp_async16(reinterpret_cast<uint4*>(vs) + c,
                   reinterpret_cast<const uint4*>(vg) + c, true);
      else
        cp_async16(vsc + 4 * (c - kv), vscg + 4 * (c - kv), true);
    }
  }
  cp_async_commit();
  // a missing scale is 1, which changes no bit
  if (kscg == nullptr)
    for (int j = tid; j < nk; j += kCrossThreads) ksc[j] = 1.f;
  if (vscg == nullptr)
    for (int d = tid; d < dh; d += kCrossThreads) vsc[d] = 1.f;
  // q is the output of the launch before in the cross block
  grid_dependency_wait();
  for (int d = tid; d < dh; d += kCrossThreads)
    qs[d] = to_float(q[bh * dh + d]);
  cp_async_wait<1>();
  __syncthreads();

  // QK^T: thread i, keys 4i .. 4i + 3, each summed over Dh in order
  const float rs = sqrtf(static_cast<float>(dh));
  for (int j4 = 4 * tid; j4 < nk; j4 += 4 * kCrossThreads) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
    for (int d = 0; d < dh; d += 4) {
      const float4 q4 = *reinterpret_cast<const float4*>(qs + d);
      const float qv[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float k4[4];
        load4(ks + (d + e) * ldk + j4, k4);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] = fmaf(qv[e], k4[i], acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (j4 + i < nk) p[j4 + i] = acc[i] / rs * ksc[j4 + i];
  }
  __syncthreads();
  float lmax = kNegInf;
  for (int j = tid; j < nk; j += kCrossThreads) lmax = fmaxf(lmax, p[j]);
  const float m = block_max(lmax, red);
  float lsum = 0.f;
  for (int j = tid; j < nk; j += kCrossThreads) {
    const float e = expf(p[j] - m);
    p[j] = e;
    lsum += e;
  }
  const float denom = block_sum(lsum, red);
  cp_async_wait<0>();
  __syncthreads();

  // PV: thread (g, c) sums dims 4c .. 4c + 3 over keys g, g + G, ...
  const int nq = dh / 4, groups = cross_groups(dh);
  const int g = tid / nq, c4 = 4 * (tid % nq);
  if (g < groups) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = g; j < nk; j += groups) {
      float v4[4];
      load4(vs + j * dh + c4, v4);
      const float pj = p[j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = fmaf(pj, v4[i], acc[i]);
    }
    *reinterpret_cast<float4*>(red + g * dh + c4) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
  __syncthreads();
  for (int d = tid; d < dh; d += kCrossThreads) {
    float s = 0.f;
    for (int gg = 0; gg < groups; ++gg) s += red[gg * dh + d];
    store_out(out + bh * dh + d, s * vsc[d] / denom);
  }
}

// As cross_attn_kernel, for every shape cross_attn_fits takes: one block
// per (row, head) over tiles of tk keys (cross_tile), each copied as
// 16-byte vectors where its rows allow and element by element otherwise,
// and PV over every 128th four dims past Dh 512. Past the first tile the
// softmax is online: the running maximum, denominator and output sums are
// rescaled by exp(m_old - m_new); with one tile the arithmetic is
// cross_attn_kernel's, bit for bit. Kept apart from it because the loop
// costs the main path's launch 1.6 us of its 11.2 on an H100 (PERF.md).
template <typename T, typename TQ, typename TO>
__global__ void __launch_bounds__(kCrossThreads, kCrossBlocksPerSm)
cross_attn_tiled_kernel(const TQ* __restrict__ q, const T* __restrict__ kt,
                  const T* __restrict__ v, const float* __restrict__ kt_scale,
                  const float* __restrict__ v_scale, TO* __restrict__ out,
                  int dh, int nk, int tk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const CrossSmem L = cross_smem(dh, tk, sizeof(T));
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = reinterpret_cast<T*>(smem_raw + L.vs);
  float* qs = reinterpret_cast<float*>(smem_raw + L.qs);
  float* ksc = reinterpret_cast<float*>(smem_raw + L.ksc);
  float* vsc = reinterpret_cast<float*>(smem_raw + L.vsc);
  float* o = reinterpret_cast<float*>(smem_raw + L.o);
  float* p = reinterpret_cast<float*>(smem_raw + L.p);
  float* red = reinterpret_cast<float*>(smem_raw + L.red);
  const int tid = threadIdx.x, ldk = L.ldk;
  const size_t bh = blockIdx.x;
  const T* kg = kt + bh * dh * nk;
  const T* vg = v + bh * nk * dh;
  const float* kscg = kt_scale == nullptr ? nullptr : kt_scale + bh * nk;
  const float* vscg = v_scale == nullptr ? nullptr : v_scale + bh * dh;

  // a tile's K and kt_scale, and its V, as two groups of copies
  const auto stage_k = [&](int j0) {
    const int n = min(tk, nk - j0);
    if (n == nk && ldk == nk)  // the whole head's kt: one contiguous block
      stage(ks, 0, kg, 0, 1, dh * nk);
    else
      stage(ks, ldk, kg + j0, nk, dh, n);
    if (kscg != nullptr) stage(ksc, 0, kscg + j0, 0, 1, n);
  };
  const auto stage_v = [&](int j0) {
    stage(vs, 0, vg + static_cast<size_t>(j0) * dh, 0, 1,
          min(tk, nk - j0) * dh);
  };
  // the first tile's K, then its V with v_scale, all in flight at once
  stage_k(0);
  cp_async_commit();
  stage_v(0);
  if (vscg != nullptr) stage(vsc, 0, vscg, 0, 1, dh);
  cp_async_commit();
  // a missing scale is 1, which changes no bit
  if (kscg == nullptr)
    for (int j = tid; j < ldk; j += kCrossThreads) ksc[j] = 1.f;
  if (vscg == nullptr)
    for (int d = tid; d < dh; d += kCrossThreads) vsc[d] = 1.f;
  // q is the output of the launch before in the cross block
  grid_dependency_wait();
  for (int d = tid; d < dh; d += kCrossThreads)
    qs[d] = to_float(q[bh * dh + d]);

  const float rs = sqrtf(static_cast<float>(dh));
  const int nq = dh / 4, groups = cross_groups(dh);
  const int g = groups == 1 ? 0 : tid / nq;
  const int c0 = groups == 1 ? tid : tid % nq;
  float m = kNegInf, l = 0.f;
  for (int j0 = 0; j0 < nk; j0 += tk) {
    const int n = min(tk, nk - j0);
    const bool last = j0 + tk >= nk;
    cp_async_wait<1>();  // this tile's K (its V may be in flight)
    __syncthreads();
    // QK^T: thread i, keys 4i .. 4i + 3, each summed over Dh in order
    for (int j4 = 4 * tid; j4 < n; j4 += 4 * kCrossThreads) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
      for (int d = 0; d < dh; d += 4) {
        const float4 q4 = *reinterpret_cast<const float4*>(qs + d);
        const float qv[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float k4[4];
          load4(ks + (d + e) * ldk + j4, k4);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i] = fmaf(qv[e], k4[i], acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (j4 + i < n) p[j4 + i] = acc[i] / rs * ksc[j4 + i];
    }
    __syncthreads();
    // the next tile's K goes out while this one's softmax and PV run
    if (!last) stage_k(j0 + tk);
    cp_async_commit();
    float lmax = kNegInf;
    for (int j = tid; j < n; j += kCrossThreads) lmax = fmaxf(lmax, p[j]);
    const float mt = fmaxf(m, block_max(lmax, red));
    float lsum = 0.f;
    for (int j = tid; j < n; j += kCrossThreads) {
      const float e = expf(p[j] - mt);
      p[j] = e;
      lsum += e;
    }
    const float ts = block_sum(lsum, red);
    const float corr = expf(m - mt);
    l = j0 == 0 ? ts : l * corr + ts;
    m = mt;
    cp_async_wait<1>();  // this tile's V (the next K may be in flight)
    __syncthreads();

    // PV: thread (g, c) sums dims 4c .. 4c + 3 over keys g, g + G, ...
    if (g < groups)
      for (int c = c0; c < nq; c += kCrossThreads) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int j = g; j < n; j += groups) {
          float v4[4];
          load4(vs + j * dh + 4 * c, v4);
          const float pj = p[j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i] = fmaf(pj, v4[i], acc[i]);
        }
        *reinterpret_cast<float4*>(red + g * dh + 4 * c) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
      }
    __syncthreads();
    // the G group sums added in group order
    for (int d = tid; d < dh; d += kCrossThreads) {
      float s = 0.f;
      for (int gg = 0; gg < groups; ++gg) s += red[gg * dh + d];
      o[d] = j0 == 0 ? s : o[d] * corr + s;
    }
    if (!last) stage_v(j0 + tk);
    cp_async_commit();
  }
  // each thread reads the sums it wrote
  for (int d = tid; d < dh; d += kCrossThreads)
    store_out(out + bh * dh + d, o[d] * vsc[d] / l);
}

// opt a kernel in to the most shared memory a block may have, and the
// largest carveout, so that six blocks share an SM
template <typename K>
cudaError_t configure_cross_attn(K kernel) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxSmem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// Launch the cross attention over b x h blocks, the whole-head kernel
// where cross_whole takes the shape, else the tiled one; `pdl`:
// programmatic dependent launch (the kernel waits for q in
// grid_dependency_wait).
template <typename T, typename TQ, typename TO>
cudaError_t launch_cross_attn(const TQ* q, const void* kt, const void* v,
                              const float* kt_scale, const float* v_scale,
                              TO* out, int b, int h, int dh, int nk, bool pdl,
                              cudaStream_t s) {
  static const cudaError_t configured[2] = {
      configure_cross_attn(cross_attn_kernel<T, TQ, TO>),
      configure_cross_attn(cross_attn_tiled_kernel<T, TQ, TO>)};
  const bool whole =
      cross_whole(dh, nk, sizeof(T), kt, v, kt_scale, v_scale);
  if (configured[whole ? 0 : 1] != cudaSuccess)
    return configured[whole ? 0 : 1];
  const int tk = whole ? nk : cross_tile(dh, nk, sizeof(T));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * h);
  cfg.blockDim = dim3(kCrossThreads);
  cfg.dynamicSmemBytes = cross_smem(dh, tk, sizeof(T)).total;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = pdl ? 1 : 0;
  const T* ktt = static_cast<const T*>(kt);
  const T* vt = static_cast<const T*>(v);
  if (whole)
    return cudaLaunchKernelEx(&cfg, cross_attn_kernel<T, TQ, TO>, q, ktt, vt,
                              kt_scale, v_scale, out, dh, nk);
  return cudaLaunchKernelEx(&cfg, cross_attn_tiled_kernel<T, TQ, TO>, q, ktt,
                            vt, kt_scale, v_scale, out, dh, nk, tk);
}

}  // namespace ecap
