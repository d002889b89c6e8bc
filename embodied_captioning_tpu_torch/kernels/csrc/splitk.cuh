// Split-K product of up to 64 activation rows with a weight matrix on the
// tensor cores, shared by the decode-MLP kernels (decode_mlp.cu) and the
// self-attention block kernels (decode_block.cu).
//
// At decode shapes (a few rows, D = 768) a product is a weight stream: the
// card has to spread the weights over every SM, keep each SM's share in
// flight at once, and pay few serial latencies. A block of kWarps warps
// owns 8 kWarps output columns of one row tile of 64 and one of S slices
// of the K-long contraction (grid: column tiles x S x row tiles). It puts
// its [K/S, 8 kWarps] weight slice and its [64, K/S] activation slice in
// flight at once with 16-byte cp.async copies, then each warp multiplies
// all 64 rows by its 8 columns (mma.sync m16n8k16; A through ldmatrix,
// int8 weights converted to bf16 on the way into the B fragments, each B
// fragment built once per block). The S blocks of a column tile form one
// thread-block cluster: each leaves its unscaled f32 partial tile in its
// own shared memory, and after a cluster barrier block s sums rows s, s+S,
// ... of all S partial tiles in rank order through distributed shared
// memory -- the same bits on every run, no atomics, no round trip through
// device memory -- and hands the sums to the caller's epilogue. Rows
// beyond the last are zero-filled in shared memory and never stored.
//
// The weights are copied before `grid_dependency_wait`: under programmatic
// dependent launch they stream in while the previous launch finishes, and
// nothing that launch writes is read before the wait.
//
// A fused LayerNorm (`kLN`): the cluster spans the whole contraction, so
// its blocks hold whole rows between them. Each block sums x and x^2 of its
// slice per row, the cluster adds the S partial sums in rank order, and
// every block normalises its slice in shared memory (one-pass statistics
// with the relative variance floor, the result rounded to bf16) before the
// product: no extra launch, and x is read once. Every column tile
// normalises its slices of all rows again, so wider tiles (more warps)
// repeat that work fewer times.
#pragma once

#include <cooperative_groups.h>

#include <algorithm>

#include "mma.cuh"

namespace ecap {
namespace splitk {

namespace cg = cooperative_groups;

constexpr int kRows = 64;       // rows per block
constexpr int kMaxSplits = 8;   // the portable cluster size
constexpr int kMaxSlice = 512;  // contraction per block

// a block of kWarps warps: its threads and output columns
template <int kWarps>
__host__ __device__ constexpr int threads() {
  return 32 * kWarps;
}
template <int kWarps>
__host__ __device__ constexpr int cols() {
  return 8 * kWarps;
}

// a staged weight row: 16 bytes of padding put the rows 2t and 2t + 8 that
// the lanes of a B fragment read in different shared-memory banks
template <typename W, int kWarps>
__host__ __device__ constexpr int wrow() {
  return cols<kWarps>() + 16 / static_cast<int>(sizeof(W));
}

// the staging area, which later holds the f32 partial tile
template <typename W, int kWarps>
__host__ __device__ inline int stage_bytes(int slice) {
  constexpr int kCols = cols<kWarps>();
  const int in = kRows * (slice + 8) * 2 +
                 slice * wrow<W, kWarps>() * static_cast<int>(sizeof(W));
  return in > kRows * kCols * 4 ? in : kRows * kCols * 4;
}
// ... and after it, for a fused LayerNorm, four floats per row of
// statistics and the slice's LayerNorm weights and biases
template <typename W, int kWarps>
inline int smem_bytes(int slice, bool ln) {
  return stage_bytes<W, kWarps>(slice) +
         (ln ? (kRows * 4 + 2 * slice) * static_cast<int>(sizeof(float)) : 0);
}

inline bool valid_split(int kdim, int splits) {
  return splits >= 1 && splits <= kMaxSplits && kdim % (16 * splits) == 0 &&
         kdim / splits <= kMaxSlice;
}

// W[k][n], W[k+1][n] of a weight tile in shared memory with rows of
// kRow elements as one bf16 pair (half of a B fragment)
template <int kRow, typename W>
__device__ __forceinline__ uint32_t wpair(const W* w, int k, int n) {
  return pack_bf16(to_float(w[k * kRow + n]), to_float(w[(k + 1) * kRow + n]));
}


// One block's share of epi(a[rows, kdim] . w[kdim, n0 .. n0 + 8 kWarps));
// `ldw` is w's row stride; the slice is blockIdx.y of gridDim.y, the row tile
// blockIdx.z. With kLN, `a` is the raw input and ln_g, ln_b, eps the
// LayerNorm's. `epi(r, c, y)` gets the row r, the column c within the tile
// (a multiple of 4) and the 4 unscaled f32 sums y of columns c .. c + 3.
// `smem` holds smem_bytes<W, kWarps>(kdim / gridDim.y, kLN) bytes.
template <typename W, int kWarps, bool kLN, typename Epi>
__device__ __forceinline__ void tile(unsigned char* smem,
                                     const __nv_bfloat16* __restrict__ a,
                                     const W* __restrict__ w, int ldw, int n0,
                                     int rows, int kdim,
                                     const float* __restrict__ ln_g,
                                     const float* __restrict__ ln_b,
                                     float eps, Epi epi) {
  constexpr int kThreads = threads<kWarps>(), kCols = cols<kWarps>();
  constexpr int kRow = wrow<W, kWarps>();
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = gridDim.y, slice = kdim / splits;
  const int lda = slice + 8;  // padded: ldmatrix rows in 8 bank groups
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);
  W* ws = reinterpret_cast<W*>(as + kRows * lda);
  float* stats =
      reinterpret_cast<float*>(smem + stage_bytes<W, kWarps>(slice));
  float* lnw = stats + 4 * kRows;  // the slice's LayerNorm g, then b
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int split = blockIdx.y;
  const int r0 = blockIdx.z * kRows, k0 = split * slice;
  const int live = min(kRows, rows - r0);

  constexpr int EPC = 16 / sizeof(W);  // elements per 16-byte copy
  constexpr int CH = kCols / EPC;      // copies per weight row
  for (int c = tid; c < slice * CH; c += kThreads) {
    const int kr = c / CH, part = (c % CH) * EPC;
    cp_async16(ws + kr * kRow + part,
               w + static_cast<size_t>(k0 + kr) * ldw + n0 + part, true);
  }
  if (kLN)
    for (int c = tid; c < slice / 2; c += kThreads) {
      const int part = (c % (slice / 4)) * 4;
      cp_async16(lnw + (c < slice / 4 ? 0 : slice) + part,
                 (c < slice / 4 ? ln_g : ln_b) + k0 + part, true);
    }
  cp_async_commit();
  grid_dependency_wait();
  const int avec = slice / 8;
  for (int c = tid; c < kRows * avec; c += kThreads) {
    const int r = c / avec, col = (c % avec) * 8;
    const bool ok = r < live;
    cp_async16(as + r * lda + col,
               a + static_cast<size_t>(r0 + (ok ? r : 0)) * kdim + k0 + col,
               ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  if (kLN) {
    // kTpr neighbouring threads per row, each summing every kTpr-th
    // vector of 8, then adding by shuffles
    constexpr int kTpr = kThreads / kRows;
    static_assert(kTpr * kRows == kThreads && 32 % kTpr == 0,
                  "whole rows per warp");
    float* sums = stats;             // [kRows][2]: this slice's sums
    float* norm = stats + 2 * kRows;  // [kRows][2]: mean, 1/sqrt(var + eps)
    {
      const int r = tid / kTpr;
      float s1 = 0.f, s2 = 0.f;
#pragma unroll 4
      for (int v = tid % kTpr; v < avec; v += kTpr) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(as + r * lda + 8 * v);
        const __nv_bfloat162* p2 =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(p2[e]);
          s1 += f.x + f.y;
          s2 = fmaf(f.y, f.y, fmaf(f.x, f.x, s2));
        }
      }
#pragma unroll
      for (int o = 1; o < kTpr; o <<= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      }
      if (tid % kTpr == 0) {
        sums[2 * r] = s1;
        sums[2 * r + 1] = s2;
      }
    }
    cluster.sync();
    if (tid < kRows) {
      float2 ps[kMaxSplits];
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s)
        if (s < splits)
          ps[s] = *reinterpret_cast<const float2*>(
              cluster.map_shared_rank(sums, s) + 2 * tid);
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s)
        if (s < splits) {
          s1 += ps[s].x;
          s2 += ps[s].y;
        }
      const float m1 = s1 / kdim, mm = __fmul_rn(m1, m1);
      const float var = fmaxf(__fsub_rn(s2 / kdim, mm), __fmul_rn(mm, 3e-7f));
      norm[2 * tid] = m1;
      norm[2 * tid + 1] = 1.f / sqrtf(var + eps);
    }
    __syncthreads();
#pragma unroll 4
    for (int c = tid; c < kRows * avec; c += kThreads) {
      const int r = c / avec, col = (c % avec) * 8;
      const float m1 = norm[2 * r], rs = norm[2 * r + 1];
      uint4 raw = *reinterpret_cast<const uint4*>(as + r * lda + col);
      __nv_bfloat16* v = reinterpret_cast<__nv_bfloat16*>(&raw);
      float gv[8], bv[8];
      *reinterpret_cast<float4*>(gv) =
          *reinterpret_cast<const float4*>(lnw + col);
      *reinterpret_cast<float4*>(gv + 4) =
          *reinterpret_cast<const float4*>(lnw + col + 4);
      *reinterpret_cast<float4*>(bv) =
          *reinterpret_cast<const float4*>(lnw + slice + col);
      *reinterpret_cast<float4*>(bv + 4) =
          *reinterpret_cast<const float4*>(lnw + slice + col + 4);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = __float2bfloat16_rn(__fadd_rn(
            __fmul_rn(__fmul_rn(__fsub_rn(to_float(v[e]), m1), rs), gv[e]),
            bv[e]));
      *reinterpret_cast<uint4*>(as + r * lda + col) = raw;
    }
    __syncthreads();
  }

  // warp w: columns 8w .. 8w + 7 of the live m-tiles
  float acc[kRows / 16][4] = {};
  const int col = 8 * warp + g;
#pragma unroll 4
  for (int kk = 0; kk < slice; kk += 16) {
    const uint32_t b0 = wpair<kRow>(ws, kk + 2 * tq, col);
    const uint32_t b1 = wpair<kRow>(ws, kk + 2 * tq + 8, col);
#pragma unroll
    for (int mi = 0; mi < kRows / 16; ++mi) {
      if (16 * mi >= live) continue;
      uint32_t af[4];
      ldmatrix_x4(af, as + (16 * mi + (lane & 15)) * lda + kk +
                          (lane >> 4) * 8);
      mma_bf16(acc[mi], af, b0, b1);
    }
  }

  // this block's unscaled partial tile [64, kCols] f32, over the staging
  // area once every warp is done with it
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mi = 0; mi < kRows / 16; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(part + (16 * mi + g + 8 * r) * kCols +
                                 8 * warp + 2 * tq) =
          make_float2(acc[mi][2 * r], acc[mi][2 * r + 1]);
  cluster.sync();

  // block s of the cluster finishes rows s, s + S, ...: the S partials
  // summed in rank order
  constexpr int Q = kCols / 4;  // float4 columns per row
  const float* parts[kMaxSplits];
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s)
    parts[s] = s < splits ? cluster.map_shared_rank(part, s) : part;
  for (int e = tid;; e += kThreads) {
    const int rl = split + (e / Q) * splits;
    if (rl >= live) break;
    const int c4 = (e % Q) * 4;
    float4 p[kMaxSplits];
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < splits)
        p[s] = *reinterpret_cast<const float4*>(parts[s] + rl * kCols + c4);
    float y[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < splits) {
        y[0] += p[s].x;
        y[1] += p[s].y;
        y[2] += p[s].z;
        y[3] += p[s].w;
      }
    epi(r0 + rl, c4, y);
  }
  // the partial tiles (and the LayerNorm's sums) stay until every block of
  // the cluster has read them
  cluster.sync();
}

// out[r, oc .. oc + 3] = resid + (y * scale + bias), as bf16; out and resid
// [rows, n]
__device__ __forceinline__ void store_residual(
    const __nv_bfloat16* __restrict__ resid, __nv_bfloat16* __restrict__ out,
    const float* __restrict__ scale, const float* __restrict__ bias, int n,
    int r, int oc, const float* y) {
  const size_t o = static_cast<size_t>(r) * n + oc;
  const uint2 xr = *reinterpret_cast<const uint2*>(resid + o);
  const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&xr);
  float z[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    z[i] = __fadd_rn(to_float(xv[i]),
                     __fadd_rn(__fmul_rn(y[i], scale[oc + i]), bias[oc + i]));
  *reinterpret_cast<uint2*>(out + o) =
      make_uint2(pack_bf16(z[0], z[1]), pack_bf16(z[2], z[3]));
}

// Launch `kKernel`, a kernel of kWarps-warp tiles, over n / (8 kWarps) x
// splits x ceil(rows / 64) blocks in clusters of (1, splits, 1); `pdl` lets
// it start before the previous launch on the stream has finished
// (programmatic dependent launch: the kernel waits in
// grid_dependency_wait). `smem_max` bytes of dynamic shared memory are
// opted in once per kernel.
template <auto kKernel, int kWarps, typename... Args>
cudaError_t launch(int n, int splits, int rows, int smem, int smem_max,
                   bool pdl, cudaStream_t s, Args... args) {
  static const cudaError_t configured = cudaFuncSetAttribute(
      kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
  if (configured != cudaSuccess) return configured;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n / cols<kWarps>(), splits, (rows + kRows - 1) / kRows);
  cfg.blockDim = dim3(threads<kWarps>());
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 2 : 1;
  return cudaLaunchKernelEx(&cfg, kKernel, args...);
}

}  // namespace splitk
}  // namespace ecap
