// Single-query decode attention, shared by the standalone attention kernels
// (decode_attention.cu: bf16 query, f32 output) and the whole-block decode
// kernels (decode_block.cu: f32 query, bf16 output): the self-attention
// over the KV cache and the cross-attention over precomputed K/V, each one
// design for both callers.
//
// Self-attention (self_attn_kernel, self_attn_tiled_kernel): one block of
// 4 warps per (row, head), computing over the live keys only, positions
// 0..pos -- a masked key's exp(-1e30 - m) is +0 in f32, so leaving it out
// changes no sum and no max. At the serving decode shape (64 rows, 12
// heads of 64, a cache of 30) a head's K and V are 7.5 KB: self_attn_kernel
// puts every load of the block in flight at once, as 16-byte cp.async
// copies into shared memory -- q, the head's [Dh, T] kc block (contiguous
// and 16-byte aligned when Dh % 8 == 0; a row of it is not when T % 8 !=
// 0) and the live vc rows -- one memory latency, where a serial walk over
// the cache pays one per step. Then warp w takes a quarter of Dh of QK^T and
// lane j key j (along T, kc's minor axis), the block adds the quarters in
// warp order and takes the f32 softmax (exact max, exp, sum), and thread
// (g, d) sums keys g, g + G, ... of output dim d (contiguous in vc), the
// G groups added in group order. Where a head's cache does not fit one
// block's shared memory (over 839 positions at Dh 64), self_attn_tiled_kernel
// streams the live keys only, in tiles of 12 KB (96 keys at Dh 64) through
// two buffers, the next tile in flight while this one is used: pass 1 the
// K tiles, their scores kept in shared memory (4 bytes a key: some 50,000
// positions at Dh 64), then the softmax over all of them, pass 2 the V
// tiles. At a cache of 1024 six blocks share an SM, so the 768 blocks of
// 64 rows x 12 heads run in one wave; smaller tiles or a deeper ring
// measured slower (PERF.md). Each byte is read once, the max is taken
// before any exp, the output normalised at the end, and every sum runs in
// the order of the whole-head kernel, so the two give the same bits. No
// sum depends on the schedule: two runs give the same bits.
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

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// self-attention over the KV cache
// ---------------------------------------------------------------------------

constexpr int kSelfThreads = 128;                 // one block per (row, head)
constexpr int kSelfKeyParts = kSelfThreads / 32;  // warps: q.k split over Dh
constexpr int kSelfTileBytes = 12288;  // a K or V tile of the tiled kernel
constexpr int kSelfStages = 2;         // its ring of tile buffers
constexpr int kSelfMaxChunks = 4;      // tiled PV: Dh / 128 dims a thread
constexpr int kSelfTiledMaxDh = kSelfThreads * kSelfMaxChunks;

// Shared memory of self_attn_kernel: the head's kc block [Dh, T], room
// for T vc rows (the live ones filled), q (room for f32), the partial and
// final scores, a reduction scratch; each part a multiple of 16 bytes long
// (Dh % 8 == 0) up to the scores
__host__ __device__ inline size_t self_attn_smem(int dh, int t) {
  return sizeof(float) * (dh + (kSelfKeyParts + 1) * static_cast<size_t>(t) +
                          kSelfThreads) +
         sizeof(__nv_bfloat16) * 2 * static_cast<size_t>(dh) * t;
}

// the whole-head kernel takes the cache
__host__ __device__ inline bool self_attn_whole(int dh, int t) {
  return self_attn_smem(dh, t) <= kMaxSmem;
}

// keys per tile of self_attn_tiled_kernel: kSelfTileBytes of K or V, a
// multiple of 8 from 8 to 128
__host__ __device__ inline int self_tile_keys(int dh) {
  const int tk = kSelfTileBytes / (2 * dh) / 8 * 8;
  return tk < 8 ? 8 : (tk > 128 ? 128 : tk);
}

// Shared memory of self_attn_tiled_kernel over n live keys, byte offsets
// of its parts: kSelfStages tile buffers, each a K tile (Dh rows of tk + 8
// keys: the 16-byte granules that hold tk keys at any offset) or a V tile
// (tk rows of Dh); q (room for f32); the partial scores of a tile; a
// reduction scratch; the scores of all n keys.
struct SelfTiledSmem {
  int tk, ldk;
  size_t buf, qs, part, red, p, total;
};
__host__ __device__ inline SelfTiledSmem self_tiled_smem(int dh, int n) {
  SelfTiledSmem s;
  s.tk = self_tile_keys(dh);
  s.ldk = s.tk + 8;
  s.buf = align16(sizeof(__nv_bfloat16) * static_cast<size_t>(dh) * s.ldk);
  s.qs = kSelfStages * s.buf;
  s.part = s.qs + align16(sizeof(float) * dh);
  s.red = s.part + sizeof(float) * kSelfKeyParts * s.tk;
  s.p = s.red + sizeof(float) * kSelfThreads;
  s.total = s.p + sizeof(float) * static_cast<size_t>(n);
  return s;
}

// The shapes the self-attention takes: Dh a multiple of 8 (16-byte
// copies of q, K and V rows), a cache of t positions whose head fits the
// whole-head kernel, or the tiled one (Dh up to kSelfTiledMaxDh, the
// scores of t keys in shared memory). `self_attention_fits` in
// kernels/decode_attention.py mirrors it.
__host__ __device__ inline bool self_attn_fits(int dh, int t) {
  return dh >= 8 && dh % 8 == 0 && t >= 1 &&
         (self_attn_whole(dh, t) ||
          (dh <= kSelfTiledMaxDh &&
           self_tiled_smem(dh, t).total <= kMaxSmem));
}

// q as TQ into shared memory: 16-byte copies
template <typename TQ>
__device__ __forceinline__ void stage_q(TQ* qs, const TQ* q, int dh) {
  constexpr int per = 16 / sizeof(TQ);
  for (int c = threadIdx.x; c < dh / per; c += kSelfThreads)
    cp_async16(qs + c * per, q + c * per, true);
}

// f(r, c) for the cells r * cols + c of a rows x cols grid that this
// thread takes, threadIdx.x + 128 i, with one division up front
template <typename F>
__device__ __forceinline__ void for_cells(int rows, int cols, F f) {
  const int step_r = kSelfThreads / cols, step_c = kSelfThreads % cols;
  int r = threadIdx.x / cols, c = threadIdx.x - r * cols;
  while (r < rows) {
    f(r, c);
    r += step_r;
    c += step_c;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

// Partial q.k of warp w over dims [w * dc, (w + 1) * dc) for keys lane,
// lane + 32, ... < n, with key j's dim d at ks[d * ldk + j], into
// part[w * ldp + j]
template <typename TQ>
__device__ __forceinline__ void self_scores_part(const TQ* qs,
                                                 const __nv_bfloat16* ks,
                                                 int ldk, int dh, int n,
                                                 float* part, int ldp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int dc = (dh + kSelfKeyParts - 1) / kSelfKeyParts;
  const int d0 = warp * dc, d1 = min(dh, d0 + dc);
  for (int j = lane; j < n; j += 32) {
    float acc = 0.f;
    for (int dd = d0; dd < d1; ++dd)
      acc = fmaf(to_float(qs[dd]), to_float(ks[dd * ldk + j]), acc);
    part[warp * ldp + j] = acc;
  }
}

// The same for the n <= 128 keys of a tile, key j's dim d at
// ks[d * ldk + koff(d) + j]: lane's keys lane + 32 i in registers, each
// summed over the dims in the same order
template <typename TQ, typename KOff>
__device__ __forceinline__ void self_tile_scores_part(
    const TQ* qs, const __nv_bfloat16* ks, int ldk, KOff koff, int dh, int n,
    float* part, int ldp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int dc = (dh + kSelfKeyParts - 1) / kSelfKeyParts;
  const int d0 = warp * dc, d1 = min(dh, d0 + dc);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int dd = d0; dd < d1; ++dd) {
    const float qd = to_float(qs[dd]);
    const __nv_bfloat16* row = ks + dd * ldk + koff(dd) + lane;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (lane + 32 * i < n) acc[i] = fmaf(qd, to_float(row[32 * i]), acc[i]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (lane + 32 * i < n) part[warp * ldp + lane + 32 * i] = acc[i];
}

// the scores of keys j < n: the warps' partial sums added in warp order,
// divided by sqrt(Dh), into p[j]
__device__ __forceinline__ void self_scores(const float* part, int ldp,
                                            int n, float rs, float* p) {
  for (int j = threadIdx.x; j < n; j += kSelfThreads) {
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kSelfKeyParts; ++w) acc += part[w * ldp + j];
    p[j] = acc / rs;
  }
}

// p[j] = exp(p[j] - max) over the n scores; returns their sum
__device__ __forceinline__ float self_softmax(float* p, int n, float* red) {
  float lmax = kNegInf;
  for (int j = threadIdx.x; j < n; j += kSelfThreads)
    lmax = fmaxf(lmax, p[j]);
  const float m = block_max(lmax, red);
  float lsum = 0.f;
  for (int j = threadIdx.x; j < n; j += kSelfThreads) {
    const float e = expf(p[j] - m);
    p[j] = e;
    lsum += e;
  }
  const float denom = block_sum(lsum, red);
  __syncthreads();
  return denom;
}

// PV's threads: thread (g, d) of G = max(1, 128 / Dh) groups sums keys g,
// g + G, ... of output dim d, in chunks of 128 dims past Dh 128
struct SelfPv {
  int groups, g, d;  // d: the dim in the first chunk
  __device__ SelfPv(int dh)
      : groups(max(1, kSelfThreads / dh)),
        g(threadIdx.x / dh),
        d(threadIdx.x % dh) {}
  __device__ bool takes(int base, int dh) const {
    return g < groups && base + d < dh;
  }
};

// the G group sums of chunk `base` (in red[g * Dh + d]) added in group
// order, divided by the denominator, stored
template <typename TO>
__device__ __forceinline__ void self_pv_out(const float* red, int dh,
                                            int base, int groups,
                                            float denom, TO* out) {
  const int tid = threadIdx.x;
  if (tid < dh && base + tid < dh) {
    float sum = 0.f;
    for (int gg = 0; gg < groups; ++gg) sum += red[gg * dh + tid];
    store_out(out + base + tid, sum / denom);
  }
}

// q [B, H, Dh] (f32 or bf16); kc [B, H, Dh, T] and vc [B, T, H, Dh] bf16,
// live at positions <= pos; out [B, H, Dh] (bf16 or f32). One block per
// (row, head); the shape as self_attn_whole takes it, q, kc, vc 16-byte
// aligned.
template <typename TQ, typename TO>
__global__ void __launch_bounds__(kSelfThreads)
self_attn_kernel(const TQ* __restrict__ q,
                 const __nv_bfloat16* __restrict__ kc,
                 const __nv_bfloat16* __restrict__ vc, TO* __restrict__ out,
                 int h, int dh, int t, int pos) {
  // each part a multiple of 16 bytes long (Dh % 8 == 0), in this order
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // dh x t
  __nv_bfloat16* vs = ks + dh * t;         // t x dh, rows <= pos used
  TQ* qs = reinterpret_cast<TQ*>(vs + dh * t);                       // dh
  float* part = reinterpret_cast<float*>(vs + dh * t) + dh;  // parts x t
  float* p = part + kSelfKeyParts * t;     // t
  float* red = p + t;                      // kSelfThreads
  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / h, hh = bh % h;
  const int live = pos + 1;
  // q, the caches and this launch's output follow the launch before in
  // the self block
  grid_dependency_wait();
  // every load of the block in flight at once: q, the whole [Dh, T] kc
  // block (contiguous: copying only the 16-byte granules that hold live
  // columns measured slower, PERF.md) and the live vc rows
  stage_q(qs, q + static_cast<size_t>(bh) * dh, dh);
  const __nv_bfloat16* kh = kc + static_cast<size_t>(bh) * dh * t;
  for (int e = 8 * tid; e < dh * t; e += 8 * kSelfThreads)
    cp_async16(ks + e, kh + e, true);
  for_cells(live, dh / 8, [&](int j, int c) {
    cp_async16(vs + j * dh + 8 * c,
               vc + ((static_cast<size_t>(b) * t + j) * h + hh) * dh + 8 * c,
               true);
  });
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  self_scores_part(qs, ks, t, dh, live, part, t);
  __syncthreads();
  self_scores(part, t, live, sqrtf(static_cast<float>(dh)), p);
  __syncthreads();
  const float denom = self_softmax(p, live, red);
  // PV: thread (g, d) sums keys g, g + G, ... of dim d
  const SelfPv pv(dh);
  for (int base = 0; base < dh; base += kSelfThreads) {
    float acc = 0.f;
    if (pv.takes(base, dh))
      for (int j = pv.g; j < live; j += pv.groups)
        acc = fmaf(p[j], to_float(vs[j * dh + base + pv.d]), acc);
    red[tid] = acc;
    __syncthreads();
    self_pv_out(red, dh, base, pv.groups, denom,
                out + static_cast<size_t>(bh) * dh);
    __syncthreads();
  }
}

// As self_attn_kernel, for caches too long for it (Dh up to
// kSelfTiledMaxDh): the live keys in tiles of tk (self_tiled_smem), the K
// tiles and then the V tiles through a ring of kSelfStages buffers, the
// next tiles' copies in flight while this one is used. A K tile is the
// 16-byte granules of each kc row that hold its keys: the granule holding
// row d's key j0 first, so key j sits at offset (d * T + j0) % 8 + j - j0
// of the row. The scores, the softmax and the PV sums are the whole-head
// kernel's, in its order.
template <typename TQ, typename TO>
__global__ void __launch_bounds__(kSelfThreads)
self_attn_tiled_kernel(const TQ* __restrict__ q,
                       const __nv_bfloat16* __restrict__ kc,
                       const __nv_bfloat16* __restrict__ vc,
                       TO* __restrict__ out, int h, int dh, int t, int pos) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int live = pos + 1;
  const SelfTiledSmem L = self_tiled_smem(dh, live);
  TQ* qs = reinterpret_cast<TQ*>(smem_raw + L.qs);
  float* part = reinterpret_cast<float*>(smem_raw + L.part);
  float* red = reinterpret_cast<float*>(smem_raw + L.red);
  float* p = reinterpret_cast<float*>(smem_raw + L.p);
  const int tid = threadIdx.x, tk = L.tk, ldk = L.ldk;
  const int bh = blockIdx.x, b = bh / h, hh = bh % h;
  const int nt = (live + tk - 1) / tk;  // tiles of K, then as many of V
  const __nv_bfloat16* kh = kc + static_cast<size_t>(bh) * dh * t;
  const auto buf = [&](int i) {
    return reinterpret_cast<__nv_bfloat16*>(smem_raw +
                                            (i % kSelfStages) * L.buf);
  };
  // the copies of tile i into buffer i % kSelfStages
  const auto issue = [&](int i) {
    if (i >= 2 * nt) return;
    __nv_bfloat16* dst = buf(i);
    const int j0 = (i % nt) * tk, j1 = min(j0 + tk, live);
    if (i < nt) {
      // granule gi of row d from the one holding key j0
      for_cells(dh, ldk / 8, [&](int d, int gi) {
        const int e = ((d * t + j0) & ~7) + 8 * gi;
        if (e < d * t + j1) cp_async16(dst + d * ldk + 8 * gi, kh + e, true);
      });
    } else {
      for_cells(j1 - j0, dh / 8, [&](int r, int c) {
        cp_async16(dst + r * dh + 8 * c,
                   vc + ((static_cast<size_t>(b) * t + j0 + r) * h + hh) *
                            dh + 8 * c,
                   true);
      });
    }
  };
  grid_dependency_wait();
  stage_q(qs, q + static_cast<size_t>(bh) * dh, dh);
#pragma unroll
  for (int i = 0; i < kSelfStages; ++i) {
    issue(i);
    cp_async_commit();
  }
  const float rs = sqrtf(static_cast<float>(dh));
  const SelfPv pv(dh);
  float acc[kSelfMaxChunks] = {};
  float denom = 0.f;
  for (int i = 0; i < 2 * nt; ++i) {
    cp_async_wait<kSelfStages - 1>();  // tile i (later ones in flight)
    __syncthreads();
    const __nv_bfloat16* tile = buf(i);
    const int j0 = (i % nt) * tk, n = min(tk, live - j0);
    if (i < nt) {
      self_tile_scores_part(qs, tile, ldk,
                            [&](int d) { return (d * t + j0) & 7; }, dh, n,
                            part, tk);
      __syncthreads();
      self_scores(part, tk, n, rs, p + j0);
    } else {
      // PV: this thread's keys of the tile, in order
      const int g0 = j0 + (pv.g - j0 % pv.groups + pv.groups) % pv.groups;
#pragma unroll
      for (int ch = 0; ch < kSelfMaxChunks; ++ch) {
        const int base = ch * kSelfThreads;
        if (base < dh && pv.takes(base, dh))
          for (int j = g0; j < j0 + n; j += pv.groups)
            acc[ch] = fmaf(p[j], to_float(tile[(j - j0) * dh + base + pv.d]),
                           acc[ch]);
      }
    }
    __syncthreads();  // every thread is done with tile i's buffer
    issue(i + kSelfStages);
    cp_async_commit();
    if (i == nt - 1) denom = self_softmax(p, live, red);
  }
#pragma unroll
  for (int ch = 0; ch < kSelfMaxChunks; ++ch) {
    const int base = ch * kSelfThreads;
    if (base < dh) {
      red[tid] = acc[ch];
      __syncthreads();
      self_pv_out(red, dh, base, pv.groups, denom,
                  out + static_cast<size_t>(bh) * dh);
      __syncthreads();
    }
  }
}

// opt a kernel in to the most shared memory a block may have, and the
// largest carveout, so that as many blocks share an SM as their shared
// memory allows
template <typename K>
cudaError_t configure_attn(K kernel) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxSmem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// Launch the self-attention over b x h blocks: the whole-head kernel where
// self_attn_whole takes the cache, else the tiled one; the shape as
// self_attn_fits takes it. `pdl`: programmatic dependent launch (the
// kernel waits for the launch before in grid_dependency_wait).
template <typename TQ, typename TO>
cudaError_t launch_self_attn(const TQ* q, const __nv_bfloat16* kc,
                             const __nv_bfloat16* vc, TO* out, int b, int h,
                             int dh, int t, int pos, bool pdl,
                             cudaStream_t s) {
  static const cudaError_t configured[2] = {
      configure_attn(self_attn_kernel<TQ, TO>),
      configure_attn(self_attn_tiled_kernel<TQ, TO>)};
  const bool whole = self_attn_whole(dh, t);
  if (configured[whole ? 0 : 1] != cudaSuccess)
    return configured[whole ? 0 : 1];
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * h);
  cfg.blockDim = dim3(kSelfThreads);
  cfg.dynamicSmemBytes =
      whole ? self_attn_smem(dh, t) : self_tiled_smem(dh, pos + 1).total;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = pdl ? 1 : 0;
  if (whole)
    return cudaLaunchKernelEx(&cfg, self_attn_kernel<TQ, TO>, q, kc, vc, out,
                              h, dh, t, pos);
  return cudaLaunchKernelEx(&cfg, self_attn_tiled_kernel<TQ, TO>, q, kc, vc,
                            out, h, dh, t, pos);
}

// ---------------------------------------------------------------------------
// cross-attention
// ---------------------------------------------------------------------------

constexpr int kCrossThreads = 128;
constexpr int kCrossBlocksPerSm = 6;  // at the serving shape (int8 K/V)
constexpr int kCrossMaxDh = 4096;     // a tile of 4 keys fits at any type

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
      configure_attn(cross_attn_kernel<T, TQ, TO>),
      configure_attn(cross_attn_tiled_kernel<T, TQ, TO>)};
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
