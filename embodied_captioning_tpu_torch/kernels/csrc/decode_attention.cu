// Single-query decode attention: one new token per row attends over the
// self-attention KV cache, or over precomputed cross-attention K/V.
//
// Replaces: embodied_captioning_tpu/ops/pallas/decode_attention.py
//   decode_self_attention  (_self_attn_kernel)
//   decode_cross_attention (_cross_attn_kernel)
//
// Bound on an H100 SXM (3.35 TB/s): both are memory-bound -- one query
// against the whole cache, ~2 flops per byte. At the serving decode shape
// (64 rows, 12 heads, Dh 64) the self cache (kt + v, bf16, T=30) is 5.9 MB
// per launch, ~1.8 us; the int8 cross K/V (K=256) are 25.2 MB plus 0.8 MB
// of scales, ~7.8 us.
//
// Design: one block per (batch row, head). The block stages q in shared
// memory, gives each thread a key (the q.k reduction runs over Dh with the
// key index as the fastest-moving address, so a warp's loads of the
// time-minor kt layout are contiguous), masks, takes the f32 softmax with
// block reductions (probabilities stay f32, as in the TPU kernel), then
// splits the PV sum over Dh lanes x groups of keys and reduces the groups
// in shared memory. K and V are read once, straight from device memory.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// out[d] = scale_d * sum_j p[j] * V(j, d) / denom, with V(j, d) read at
// v[j * vstride + d]. `red` holds kThreads floats.
template <typename T>
__device__ void pv_sum(const float* p, const T* __restrict__ v, int n,
                       int vstride, int dh, float denom,
                       const float* __restrict__ vscale, float* red,
                       float* __restrict__ out) {
  const int groups = max(1, kThreads / dh);
  for (int base = 0; base < dh; base += kThreads) {
    const int idx = threadIdx.x;
    const int g = idx / dh;
    const int d = base + idx % dh;
    float acc = 0.f;
    if (g < groups && d < dh) {
      for (int j = g; j < n; j += groups)
        acc = fmaf(p[j], ecap::to_float(v[static_cast<size_t>(j) * vstride + d]),
                   acc);
    }
    __syncthreads();
    red[idx] = acc;
    __syncthreads();
    if (idx < dh && base + idx < dh) {
      float s = 0.f;
      for (int gg = 0; gg < groups; ++gg) s += red[gg * dh + idx];
      const int dd = base + idx;
      if (vscale != nullptr) s *= vscale[dd];
      out[dd] = s / denom;
    }
  }
}

// q [B,H,Dh] bf16; kt [B,H,Dh,T] bf16; v [B,T,H,Dh] bf16; out [B,H,Dh] f32.
// Keys at positions > pos are masked.
__global__ void __launch_bounds__(kThreads)
decode_self_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ kt,
                   const __nv_bfloat16* __restrict__ v,
                   float* __restrict__ out, int h, int dh, int t, int pos) {
  extern __shared__ float sm[];
  float* qs = sm;            // dh
  float* p = qs + dh;        // t
  float* red = p + t;        // kThreads
  const int bh = blockIdx.x;
  const int b = bh / h, hh = bh % h;
  for (int d = threadIdx.x; d < dh; d += kThreads)
    qs[d] = ecap::to_float(q[static_cast<size_t>(bh) * dh + d]);
  __syncthreads();
  const __nv_bfloat16* kp = kt + static_cast<size_t>(bh) * dh * t;
  const float rs = sqrtf(static_cast<float>(dh));
  float lmax = ecap::kNegInf;
  for (int j = threadIdx.x; j < t; j += kThreads) {
    float acc = 0.f;
    for (int d = 0; d < dh; ++d)
      acc = fmaf(qs[d], ecap::to_float(kp[static_cast<size_t>(d) * t + j]), acc);
    const float s = j <= pos ? acc / rs : ecap::kNegInf;
    p[j] = s;
    lmax = fmaxf(lmax, s);
  }
  const float m = ecap::block_max(lmax, red);
  float lsum = 0.f;
  for (int j = threadIdx.x; j < t; j += kThreads) {
    const float e = expf(p[j] - m);
    p[j] = e;
    lsum += e;
  }
  const float denom = ecap::block_sum(lsum, red);
  __syncthreads();
  // V(j, d) = v[((b * T + j) * H + hh) * Dh + d]
  pv_sum(p, v + (static_cast<size_t>(b) * t * h + hh) * dh, t, h * dh, dh,
         denom, nullptr, red, out + static_cast<size_t>(bh) * dh);
}

// q [B,H,Dh] bf16; kt [B,H,Dh,K] and v [B,H,K,Dh] (int8 or bf16); scales
// kt_scale [B,H,K], v_scale [B,H,Dh] f32 or null (= 1); out [B,H,Dh] f32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_cross_kernel(const __nv_bfloat16* __restrict__ q,
                    const T* __restrict__ kt, const T* __restrict__ v,
                    const float* __restrict__ kt_scale,
                    const float* __restrict__ v_scale,
                    float* __restrict__ out, int dh, int nk) {
  extern __shared__ float sm[];
  float* qs = sm;            // dh
  float* p = qs + dh;        // nk
  float* red = p + nk;       // kThreads
  const int bh = blockIdx.x;
  for (int d = threadIdx.x; d < dh; d += kThreads)
    qs[d] = ecap::to_float(q[static_cast<size_t>(bh) * dh + d]);
  __syncthreads();
  const T* kp = kt + static_cast<size_t>(bh) * dh * nk;
  const float rs = sqrtf(static_cast<float>(dh));
  float lmax = ecap::kNegInf;
  for (int j = threadIdx.x; j < nk; j += kThreads) {
    float acc = 0.f;
    for (int d = 0; d < dh; ++d)
      acc = fmaf(qs[d], ecap::to_float(kp[static_cast<size_t>(d) * nk + j]), acc);
    float s = acc / rs;
    if (kt_scale != nullptr) s *= kt_scale[static_cast<size_t>(bh) * nk + j];
    p[j] = s;
    lmax = fmaxf(lmax, s);
  }
  const float m = ecap::block_max(lmax, red);
  float lsum = 0.f;
  for (int j = threadIdx.x; j < nk; j += kThreads) {
    const float e = expf(p[j] - m);
    p[j] = e;
    lsum += e;
  }
  const float denom = ecap::block_sum(lsum, red);
  __syncthreads();
  pv_sum(p, v + static_cast<size_t>(bh) * nk * dh, nk, dh, dh, denom,
         v_scale == nullptr ? nullptr : v_scale + static_cast<size_t>(bh) * dh,
         red, out + static_cast<size_t>(bh) * dh);
}

size_t smem_bytes(int dh, int n) {
  return sizeof(float) * (static_cast<size_t>(dh) + n + kThreads);
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" int ecap_decode_self_attention(const void* q, const void* kt,
                                          const void* v, void* out, int b,
                                          int h, int dh, int t, int pos,
                                          void* stream) {
  const size_t bytes = smem_bytes(dh, t);
  cudaError_t err = set_smem(decode_self_kernel, bytes);
  if (err != cudaSuccess) return err;
  decode_self_kernel<<<b * h, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kt),
      static_cast<const __nv_bfloat16*>(v), static_cast<float*>(out), h, dh, t,
      pos);
  return cudaGetLastError();
}

extern "C" int ecap_decode_cross_attention(const void* q, const void* kt,
                                           const void* v, const void* kt_scale,
                                           const void* v_scale, void* out,
                                           int b, int h, int dh, int nk,
                                           int int8, void* stream) {
  const size_t bytes = smem_bytes(dh, nk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(kt_scale);
  const float* vs = static_cast<const float*>(v_scale);
  cudaError_t err;
  if (int8) {
    err = set_smem(decode_cross_kernel<int8_t>, bytes);
    if (err != cudaSuccess) return err;
    decode_cross_kernel<int8_t><<<b * h, kThreads, bytes, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(kt),
        static_cast<const int8_t*>(v), ks, vs, static_cast<float*>(out), dh, nk);
  } else {
    err = set_smem(decode_cross_kernel<__nv_bfloat16>, bytes);
    if (err != cudaSuccess) return err;
    decode_cross_kernel<__nv_bfloat16><<<b * h, kThreads, bytes, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(kt),
        static_cast<const __nv_bfloat16*>(v), ks, vs, static_cast<float*>(out),
        dh, nk);
  }
  return cudaGetLastError();
}
