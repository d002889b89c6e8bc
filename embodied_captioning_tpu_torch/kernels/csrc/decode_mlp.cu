// Fused decode MLP for one token per row: out = x + proj(gelu(fc(ln(x)))).
//
// Replaces: embodied_captioning_tpu/ops/pallas/decode_attention.py
//   decode_mlp (_mlp_kernel)
//
// Numerics as the TPU kernel: one-pass bf16-input LayerNorm with the
// relative variance floor, LN output rounded to bf16, bf16 x bf16 products
// with f32 accumulation (int8 weights convert to bf16 exactly), the
// per-output-channel weight scale applied AFTER the whole dot, then the
// bias, tanh GELU in f32, a bf16 round of h before the second product, its
// scale and bias, the residual in f32, bf16 out. Weights int8 or bf16.
//
// Bound on an H100 SXM (3.35 TB/s): at the serving decode shape (64 rows,
// D=768, F=3072, int8 weights) the two weight matrices are 4.7 MB, ~1.4 us;
// 2*2*64*768*3072 = 0.6 GFLOP is far below the compute roof. So the kernel
// has to spread the weights over every SM, keep each SM's share in flight
// at once, and pay few serial latencies: a block that walks the whole
// 3072-long contraction in dependent chunks is latency-bound.
//
// Design: three launches, because both products need whole rows of their
// input (LayerNorm statistics, all F columns of h) -- grid-wide
// dependencies.
//  1. mlp_ln_kernel: one warp per row computes the LayerNorm and writes
//     the bf16 rows xn [B, D]. (Folding it into the fc launch costs more:
//     every column tile would normalise its slice of all rows again.)
//  2. mlp_gemm_kernel<fc>: h = gelu(xn wfc * sfc + bfc), h [B, F] bf16.
//  3. mlp_gemm_kernel<proj>: out = x + h wpj * spj + bpj.
// The product kernel, split along the contraction (split-K): grid (N/32
// column tiles, S splits of the K-long contraction, row tiles of 64), 4
// warps. A block puts its [64, K/S] slice of the activations and its
// [K/S, 32] weight slice in flight at once with 16-byte cp.async copies,
// then each warp multiplies all 64 rows by its 8 columns on the tensor
// cores (mma.sync m16n8k16; A through ldmatrix, int8 weights converted to
// bf16 on the way into the B fragments, each B fragment built once per
// block). The S blocks of a column tile form one thread-block cluster:
// each leaves its unscaled f32 partial tile in its own shared memory, and
// after a cluster barrier block s sums rows s, s+S, ... of all S partial
// tiles in rank order through distributed shared memory -- the same bits
// on every run, no atomics, no round trip through device memory -- and
// applies the epilogue. S = 2 for fc and 8 for proj at the serving shape:
// 192 blocks each. `mlp_plan` in kernels/decode_attention.py picks S.
// Rows beyond B are zero-filled in shared memory and never stored.
#include <cooperative_groups.h>

#include <algorithm>

#include "mma.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;  // 4 warps, 8 output columns each
constexpr int kRows = 64;      // rows per block
constexpr int kCols = 32;      // output columns per block
constexpr int kMaxSplits = 8;  // the portable cluster size
constexpr int kMaxSlice = 512;  // contraction per block
constexpr int kMaxD = 1024;     // mlp_ln_kernel holds a row in registers

__device__ __forceinline__ float gelu_tanh(float y) {
  const float inner = 0.7978845608028654f * (y + 0.044715f * (y * y * y));
  return y * (0.5f * (1.f + tanhf(inner)));
}

// W[k][n], W[k+1][n] of a [k][kCols] weight tile in shared memory as one
// bf16 pair (half of a B fragment)
template <typename W>
__device__ __forceinline__ uint32_t wpair(const W* w, int k, int n) {
  return ecap::pack_bf16(ecap::to_float(w[k * kCols + n]),
                         ecap::to_float(w[(k + 1) * kCols + n]));
}

// x [B, D] -> xn [B, D] bf16, one warp per row
__global__ void __launch_bounds__(kThreads)
mlp_ln_kernel(const __nv_bfloat16* __restrict__ x,
              const float* __restrict__ ln_g, const float* __restrict__ ln_b,
              __nv_bfloat16* __restrict__ xn, int rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (r >= rows) return;
  const __nv_bfloat16* xr = x + static_cast<size_t>(r) * d;
  uint4 raw[kMaxD / 256];  // 8-element vectors, at most 4 per lane
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxD / 256; ++i) {
    const int c = (lane + 32 * i) * 8;
    if (c >= d) break;
    raw[i] = *reinterpret_cast<const uint4*>(xr + c);
    const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw[i]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 v = __bfloat1622float2(p2[e]);
      s1 += v.x + v.y;
      s2 += v.x * v.x + v.y * v.y;
    }
  }
  s1 = ecap::warp_sum(s1);
  s2 = ecap::warp_sum(s2);
  const float m1 = s1 / d;
  const float var = fmaxf(s2 / d - m1 * m1, m1 * m1 * 3e-7f);
  const float rs = 1.f / sqrtf(var + eps);
#pragma unroll
  for (int i = 0; i < kMaxD / 256; ++i) {
    const int c = (lane + 32 * i) * 8;
    if (c >= d) break;
    __nv_bfloat16* vals = reinterpret_cast<__nv_bfloat16*>(&raw[i]);
    float gv[8], bv[8];
    *reinterpret_cast<float4*>(gv) = *reinterpret_cast<const float4*>(ln_g + c);
    *reinterpret_cast<float4*>(gv + 4) =
        *reinterpret_cast<const float4*>(ln_g + c + 4);
    *reinterpret_cast<float4*>(bv) = *reinterpret_cast<const float4*>(ln_b + c);
    *reinterpret_cast<float4*>(bv + 4) =
        *reinterpret_cast<const float4*>(ln_b + c + 4);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      vals[e] = __float2bfloat16_rn(__fadd_rn(
          __fmul_rn(__fmul_rn(__fsub_rn(ecap::to_float(vals[e]), m1), rs),
                    gv[e]),
          bv[e]));
    *reinterpret_cast<uint4*>(xn + static_cast<size_t>(r) * d + c) = raw[i];
  }
}

// kFc: out = gelu(a w * scale + bias) as bf16, a = xn; otherwise
// out = resid + (a w * scale + bias) as bf16, a = h. Launched in clusters
// of (1, S, 1) blocks, S = gridDim.y.
template <typename W, bool kFc>
__global__ void __launch_bounds__(kThreads)
mlp_gemm_kernel(const __nv_bfloat16* __restrict__ a,
                const W* __restrict__ w, const float* __restrict__ scale,
                const float* __restrict__ bias,
                const __nv_bfloat16* __restrict__ resid,
                __nv_bfloat16* __restrict__ out, int rows, int kdim, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = gridDim.y, slice = kdim / splits;
  const int lda = slice + 8;  // padded: ldmatrix rows in 8 bank groups
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  W* ws = reinterpret_cast<W*>(as + kRows * lda);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int n0 = blockIdx.x * kCols, split = blockIdx.y;
  const int r0 = blockIdx.z * kRows, k0 = split * slice;
  const int live = min(kRows, rows - r0);

  const int avec = slice / 8;
  for (int c = tid; c < kRows * avec; c += kThreads) {
    const int r = c / avec, col = (c % avec) * 8;
    const bool ok = r < live;
    ecap::cp_async16(
        as + r * lda + col,
        a + static_cast<size_t>(r0 + (ok ? r : 0)) * kdim + k0 + col, ok);
  }
  constexpr int EPC = 16 / sizeof(W);  // elements per 16-byte copy
  constexpr int CH = kCols / EPC;      // copies per weight row
  for (int c = tid; c < slice * CH; c += kThreads) {
    const int kr = c / CH, part = (c % CH) * EPC;
    ecap::cp_async16(ws + kr * kCols + part,
                     w + static_cast<size_t>(k0 + kr) * n + n0 + part, true);
  }
  ecap::cp_async_commit();
  ecap::cp_async_wait<0>();
  __syncthreads();

  // warp w: columns 8w .. 8w + 7 of the live m-tiles
  float acc[kRows / 16][4] = {};
  const int col = 8 * warp + g;
#pragma unroll 4
  for (int kk = 0; kk < slice; kk += 16) {
    const uint32_t b0 = wpair(ws, kk + 2 * tq, col);
    const uint32_t b1 = wpair(ws, kk + 2 * tq + 8, col);
#pragma unroll
    for (int mi = 0; mi < kRows / 16; ++mi) {
      if (16 * mi >= live) continue;
      uint32_t af[4];
      ecap::ldmatrix_x4(af, as + (16 * mi + (lane & 15)) * lda + kk +
                                (lane >> 4) * 8);
      ecap::mma_bf16(acc[mi], af, b0, b1);
    }
  }

  // this block's unscaled partial tile [64, kCols] f32, over the staging
  // area once every warp is done with it
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem_raw);
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
    const int oc = n0 + c4;
    const size_t o = static_cast<size_t>(r0 + rl) * n + oc;
    float z[4];
    if (kFc) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        z[i] = gelu_tanh(__fadd_rn(__fmul_rn(y[i], scale[oc + i]), bias[oc + i]));
    } else {
      const uint2 xr = *reinterpret_cast<const uint2*>(resid + o);
      const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&xr);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        z[i] = __fadd_rn(
            ecap::to_float(xv[i]),
            __fadd_rn(__fmul_rn(y[i], scale[oc + i]), bias[oc + i]));
    }
    *reinterpret_cast<uint2*>(out + o) =
        make_uint2(ecap::pack_bf16(z[0], z[1]), ecap::pack_bf16(z[2], z[3]));
  }
  // the partial tiles stay until every block of the cluster has read them
  cluster.sync();
}

// the staging area, which later holds the f32 partial tile
template <typename W>
int gemm_smem(int slice) {
  return std::max(
      kRows * (slice + 8) * 2 + slice * kCols * static_cast<int>(sizeof(W)),
      kRows * kCols * 4);
}

template <typename W, bool kFc>
cudaError_t gemm(const __nv_bfloat16* a, const W* w, const float* scale,
                 const float* bias, const __nv_bfloat16* resid,
                 __nv_bfloat16* out, int rows, int kdim, int n, int splits,
                 cudaStream_t s) {
  static const cudaError_t configured = cudaFuncSetAttribute(
      mlp_gemm_kernel<W, kFc>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      gemm_smem<W>(kMaxSlice));
  if (configured != cudaSuccess) return configured;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n / kCols, splits, (rows + kRows - 1) / kRows);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = gemm_smem<W>(kdim / splits);
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = splits;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, mlp_gemm_kernel<W, kFc>, a, w, scale, bias,
                            resid, out, rows, kdim, n);
}

template <typename W>
cudaError_t run(const __nv_bfloat16* x, const float* g, const float* bln,
                const W* wfc, const float* sfc, const float* bfc,
                const W* wpj, const float* spj, const float* bpj,
                __nv_bfloat16* h, __nv_bfloat16* xn, __nv_bfloat16* out,
                int b, int d, int f, float eps, int s_fc, int s_pj,
                cudaStream_t s) {
  mlp_ln_kernel<<<(b + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0,
                  s>>>(x, g, bln, xn, b, d, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = gemm<W, true>(xn, wfc, sfc, bfc, nullptr, h, b, d, f, s_fc, s);
  if (err != cudaSuccess) return err;
  return gemm<W, false>(h, wpj, spj, bpj, x, out, b, f, d, s_pj, s);
}

bool valid_split(int kdim, int splits) {
  return splits >= 1 && splits <= kMaxSplits && kdim % (16 * splits) == 0 &&
         kdim / splits <= kMaxSlice;
}

}  // namespace

// x [B,D] bf16; LN g,b [D] f32; wfc [D,F], wpj [F,D] (int8 if `int8`, else
// bf16); sfc,bfc [F], spj,bpj [D] f32; h [B,F] and xn [B,D] bf16 scratch;
// out [B,D] bf16. s_fc and s_pj split the D- and F-long contractions.
// Takes D and F multiples of 32, D <= 1024, splits as `mlp_plan` gives
// them (at most 8, slices of a multiple of 16 and at most 512); returns
// cudaErrorInvalidValue otherwise.
extern "C" int ecap_decode_mlp(const void* x, const void* g, const void* bln,
                               const void* wfc, const void* sfc,
                               const void* bfc, const void* wpj,
                               const void* spj, const void* bpj, void* h,
                               void* xn, void* out, int b, int d, int f,
                               float eps, int int8, int s_fc, int s_pj,
                               void* stream) {
  if (b < 1 || d % kCols || f % kCols || d > kMaxD || !valid_split(d, s_fc) ||
      !valid_split(f, s_pj))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* gf = static_cast<const float*>(g);
  const auto* bl = static_cast<const float*>(bln);
  const auto* s1 = static_cast<const float*>(sfc);
  const auto* b1 = static_cast<const float*>(bfc);
  const auto* s2 = static_cast<const float*>(spj);
  const auto* b2 = static_cast<const float*>(bpj);
  auto* hb = static_cast<__nv_bfloat16*>(h);
  auto* xnb = static_cast<__nv_bfloat16*>(xn);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if (int8)
    return run(xb, gf, bl, static_cast<const int8_t*>(wfc), s1, b1,
               static_cast<const int8_t*>(wpj), s2, b2, hb, xnb, ob, b, d, f,
               eps, s_fc, s_pj, s);
  return run(xb, gf, bl, static_cast<const __nv_bfloat16*>(wfc), s1, b1,
             static_cast<const __nv_bfloat16*>(wpj), s2, b2, hb, xnb, ob, b,
             d, f, eps, s_fc, s_pj, s);
}
