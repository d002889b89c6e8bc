// Row LayerNorm over the last axis with float32 statistics.
//
// Replaces: embodied_captioning_tpu/ops/pallas/layernorm.py
//   layernorm_2d and layernorm_3d (_ln_kernel). A contiguous [B, T, D]
//   tensor is [B*T, D] without a copy here, so one kernel serves both.
//
// Two statistics modes:
//   two-pass            var = mean((x - m)^2): the TPU kernel, and the JAX
//                       package's default path for float32 input;
//   one-pass with floor var = max(E[x^2] - m^2, m^2 * 3e-7): the JAX
//                       package's default path for bf16 input.
//
// Bound on an H100 SXM (3.35 TB/s): memory. Each row is read once and
// written once, with ~8 operations per element in between.
//
// Design: one warp per row, eight rows per block. A lane walks the row
// with stride 32, so a warp's loads are contiguous; the statistics are
// warp-shuffle sums in float32. The row is read again for the second
// statistic (two-pass mode) and for the normalisation; those reads hit
// the L1/L2 caches, since a row is a few KB. The normalisation rounds
// after every operation (no fused multiply-add), as the plain version.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ float load(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kWarps * 32)
layernorm_kernel(const Tin* __restrict__ x, const float* __restrict__ g,
                 const float* __restrict__ b, Tout* __restrict__ out, int rows,
                 int d, float eps, int two_pass) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const size_t base = static_cast<size_t>(row) * d;
  const float inv_d = 1.f / static_cast<float>(d);
  float s1 = 0.f, s2 = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float v = load(x, base + i);
    s1 += v;
    s2 += v * v;
  }
  const float mean = ecap::warp_sum(s1) * inv_d;
  float var;
  if (two_pass) {
    float sq = 0.f;
    for (int i = lane; i < d; i += 32) {
      const float c = load(x, base + i) - mean;
      sq += c * c;
    }
    var = ecap::warp_sum(sq) * inv_d;
  } else {
    const float mm = __fmul_rn(mean, mean);
    var = fmaxf(__fsub_rn(ecap::warp_sum(s2) * inv_d, mm),
                __fmul_rn(mm, 3e-7f));
  }
  const float r = rsqrtf(var + eps);
  for (int i = lane; i < d; i += 32) {
    const float c = load(x, base + i) - mean;
    const float y = __fadd_rn(__fmul_rn(__fmul_rn(c, r), g[i]), b[i]);
    store(out, base + i, y);
  }
}

template <typename Tin, typename Tout>
int launch(const void* x, const void* g, const void* b, void* out, int rows,
           int d, float eps, int two_pass, cudaStream_t stream) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  layernorm_kernel<Tin, Tout><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const Tin*>(x), static_cast<const float*>(g),
      static_cast<const float*>(b), static_cast<Tout*>(out), rows, d, eps,
      two_pass);
  return cudaGetLastError();
}

}  // namespace

// x [rows, d] bf16 or f32; g, b [d] f32; out [rows, d] bf16 or f32.
extern "C" int ecap_layernorm(const void* x, const void* g, const void* b,
                              void* out, int rows, int d, float eps,
                              int two_pass, int in_bf16, int out_bf16,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0) return 0;
  if (in_bf16 && out_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, g, b, out, rows, d, eps,
                                                two_pass, s);
  if (in_bf16)
    return launch<__nv_bfloat16, float>(x, g, b, out, rows, d, eps, two_pass, s);
  if (out_bf16)
    return launch<float, __nv_bfloat16>(x, g, b, out, rows, d, eps, two_pass, s);
  return launch<float, float>(x, g, b, out, rows, d, eps, two_pass, s);
}
