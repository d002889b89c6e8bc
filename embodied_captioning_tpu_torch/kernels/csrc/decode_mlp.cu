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
// The two products are the split-K kernel of splitk.cuh (S blocks of a
// column tile in one cluster, partial sums added in rank order through
// distributed shared memory): S = 2 for fc and 8 for proj at the serving
// shape, 192 blocks each. `mlp_plan` in kernels/decode_attention.py picks S.
#include "splitk.cuh"

namespace {

constexpr int kWarps = 4;  // per block of the products: 32 output columns
constexpr int kCols = ecap::splitk::cols<kWarps>();
constexpr int kThreads = ecap::splitk::threads<kWarps>();
constexpr int kMaxD = 1024;  // mlp_ln_kernel holds a row in registers

__device__ __forceinline__ float gelu_tanh(float y) {
  const float inner = 0.7978845608028654f * (y + 0.044715f * (y * y * y));
  return y * (0.5f * (1.f + tanhf(inner)));
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
  const int n0 = blockIdx.x * kCols;
  ecap::splitk::tile<W, kWarps, false>(
      smem_raw, a, w, n, n0, rows, kdim, nullptr, nullptr, 0.f,
      [&](int r, int c4, const float* y) {
        const int oc = n0 + c4;
        if (kFc) {
          float z[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            z[i] = gelu_tanh(
                __fadd_rn(__fmul_rn(y[i], scale[oc + i]), bias[oc + i]));
          *reinterpret_cast<uint2*>(out + static_cast<size_t>(r) * n + oc) =
              make_uint2(ecap::pack_bf16(z[0], z[1]),
                         ecap::pack_bf16(z[2], z[3]));
        } else {
          ecap::splitk::store_residual(resid, out, scale, bias, n, r, oc, y);
        }
      });
}

template <typename W, bool kFc>
cudaError_t gemm(const __nv_bfloat16* a, const W* w, const float* scale,
                 const float* bias, const __nv_bfloat16* resid,
                 __nv_bfloat16* out, int rows, int kdim, int n, int splits,
                 cudaStream_t s) {
  using namespace ecap::splitk;
  return launch<mlp_gemm_kernel<W, kFc>, kWarps>(
      n, splits, rows, smem_bytes<W, kWarps>(kdim / splits, false),
      smem_bytes<W, kWarps>(kMaxSlice, false), false, s, a, w, scale, bias,
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
  using ecap::splitk::valid_split;
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
