// Fused decode MLP for one token per row: out = x + proj(gelu(fc(ln(x)))).
//
// Replaces: embodied_captioning_tpu/ops/pallas/decode_attention.py
//   decode_mlp (_mlp_kernel)
//
// Numerics as the TPU kernel: one-pass bf16-input LayerNorm with the
// relative variance floor, LN output rounded to bf16, product with f32
// accumulation, per-output-channel weight scale applied AFTER the dot, then
// bias, tanh GELU in f32, a bf16 round before the second product, scale,
// bias, residual in f32, bf16 out. Weights are int8 (with scales) or bf16.
//
// Bound on an H100 SXM (3.35 TB/s): at the serving decode shape (64 rows,
// D=768, F=3072, int8 weights) the two weight matrices are 4.7 MB, ~1.4 us;
// 2*2*64*768*3072 = 0.6 GFLOP is far below the compute roof.
//
// Design: two launches, because every output column of the second product
// needs all F columns of the first -- a grid-wide dependency that one
// launch could only meet with a cooperative grid sync. Both launches are
// one tiled kernel: a block owns 32 output columns (one per lane) and 16
// rows (2 per warp), walks the contraction in chunks of 32 staged in shared
// memory as f32, and keeps 2 f32 accumulators per thread. The first launch
// computes the row LayerNorm statistics in its prologue and normalises the
// activations as it stages them; its epilogue applies scale, bias and GELU
// and writes h [B, F] bf16 to a scratch buffer. The second launch reads h
// and finishes with scale, bias and the residual. No cuBLAS.
#include "common.cuh"

namespace {

constexpr int kTN = 32;      // output columns per block (= lanes)
constexpr int kRB = 16;      // rows per block
constexpr int kWarps = 8;
constexpr int kRows = kRB / kWarps;  // rows per warp
constexpr int kKC = 32;      // contraction chunk

template <typename W, bool kFc>
__global__ void __launch_bounds__(kWarps * 32)
mlp_kernel(const __nv_bfloat16* __restrict__ a,   // fc: x [B,K]; proj: h [B,K]
           const float* __restrict__ ln_g, const float* __restrict__ ln_b,
           const W* __restrict__ w,                // [K, N]
           const float* __restrict__ scale, const float* __restrict__ bias,
           const __nv_bfloat16* __restrict__ resid,  // proj: x [B,N]
           __nv_bfloat16* __restrict__ out,          // fc: h [B,N]; proj: [B,N]
           int rows, int kdim, int n, float eps) {
  __shared__ float as[kRB][kKC + 1];
  __shared__ float ws[kKC][kTN];
  __shared__ float mean[kRB], rstd[kRB];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.y * kRB;
  const int n0 = blockIdx.x * kTN;

  if (kFc) {
    for (int i = 0; i < kRows; ++i) {
      const int rl = warp * kRows + i;
      const int r = r0 + rl;
      float s1 = 0.f, s2 = 0.f;
      if (r < rows) {
        for (int c = lane; c < kdim; c += 32) {
          const float xv = ecap::to_float(a[static_cast<size_t>(r) * kdim + c]);
          s1 += xv;
          s2 += xv * xv;
        }
      }
      s1 = ecap::warp_sum(s1);
      s2 = ecap::warp_sum(s2);
      if (lane == 0) {
        const float m1 = s1 / kdim;
        const float var = fmaxf(s2 / kdim - m1 * m1, m1 * m1 * 3e-7f);
        mean[rl] = m1;
        rstd[rl] = 1.f / sqrtf(var + eps);
      }
    }
    __syncthreads();
  }

  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < kdim; k0 += kKC) {
    __syncthreads();
    for (int e = threadIdx.x; e < kRB * kKC; e += kWarps * 32) {
      const int rl = e / kKC, kk = e % kKC;
      const int r = r0 + rl, k = k0 + kk;
      float val = 0.f;
      if (r < rows && k < kdim) {
        val = ecap::to_float(a[static_cast<size_t>(r) * kdim + k]);
        if (kFc) {
          val = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(val, mean[rl]), rstd[rl]),
                                    ln_g[k]),
                          ln_b[k]);
          val = ecap::round_bf16(val);
        }
      }
      as[rl][kk] = val;
    }
    for (int e = threadIdx.x; e < kKC * kTN; e += kWarps * 32) {
      const int kk = e / kTN, c = e % kTN;
      const int k = k0 + kk, col = n0 + c;
      ws[kk][c] = (k < kdim && col < n)
                      ? ecap::to_float(w[static_cast<size_t>(k) * n + col])
                      : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kKC; ++kk) {
      const float wv = ws[kk][lane];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        acc[i] = fmaf(as[warp * kRows + i][kk], wv, acc[i]);
    }
  }

  const int col = n0 + lane;
  if (col >= n) return;
  const float sc = scale[col], bi = bias[col];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = r0 + warp * kRows + i;
    if (r >= rows) continue;
    const float y = acc[i] * sc + bi;
    const size_t o = static_cast<size_t>(r) * n + col;
    if (kFc) {
      const float inner = 0.7978845608028654f * (y + 0.044715f * (y * y * y));
      out[o] = __float2bfloat16_rn(y * (0.5f * (1.f + tanhf(inner))));
    } else {
      out[o] = __float2bfloat16_rn(ecap::to_float(resid[o]) + y);
    }
  }
}

template <typename W>
cudaError_t run(const void* x, const float* g, const float* bln, const void* wfc,
                const float* sfc, const float* bfc, const void* wpj,
                const float* spj, const float* bpj, void* h, void* out, int b,
                int d, int f, float eps, cudaStream_t s) {
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* hb = static_cast<__nv_bfloat16*>(h);
  const int rb = (b + kRB - 1) / kRB;
  mlp_kernel<W, true><<<dim3((f + kTN - 1) / kTN, rb), kWarps * 32, 0, s>>>(
      xb, g, bln, static_cast<const W*>(wfc), sfc, bfc, nullptr, hb, b, d, f,
      eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlp_kernel<W, false><<<dim3((d + kTN - 1) / kTN, rb), kWarps * 32, 0, s>>>(
      hb, nullptr, nullptr, static_cast<const W*>(wpj), spj, bpj, xb,
      static_cast<__nv_bfloat16*>(out), b, f, d, eps);
  return cudaGetLastError();
}

}  // namespace

// x [B,D] bf16; LN g,b [D] f32; wfc [D,F], wpj [F,D] (int8 if `int8`, else
// bf16); sfc,bfc [F], spj,bpj [D] f32; h: scratch [B,F] bf16; out [B,D]
// bf16.
extern "C" int ecap_decode_mlp(const void* x, const void* g, const void* bln,
                               const void* wfc, const void* sfc,
                               const void* bfc, const void* wpj,
                               const void* spj, const void* bpj, void* h,
                               void* out, int b, int d, int f, float eps,
                               int int8, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* bl = static_cast<const float*>(bln);
  const float* s1 = static_cast<const float*>(sfc);
  const float* b1 = static_cast<const float*>(bfc);
  const float* s2 = static_cast<const float*>(spj);
  const float* b2 = static_cast<const float*>(bpj);
  if (int8)
    return run<int8_t>(x, gf, bl, wfc, s1, b1, wpj, s2, b2, h, out, b, d, f,
                       eps, s);
  return run<__nv_bfloat16>(x, gf, bl, wfc, s1, b1, wpj, s2, b2, h, out, b, d,
                            f, eps, s);
}
