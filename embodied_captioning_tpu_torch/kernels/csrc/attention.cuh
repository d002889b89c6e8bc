// Single-query decode attention, shared by the standalone attention kernels
// (decode_attention.cu: bf16 query, f32 output) and the whole-block decode
// kernels (decode_block.cu: f32 query, bf16 output).
//
// Design: one block per (batch row, head). The block stages q in shared
// memory, gives each thread a key (the q.k reduction runs over Dh with the
// key index as the fastest-moving address, so a warp's loads of the
// time-minor kt layout are contiguous), masks, takes the f32 softmax with
// block reductions (probabilities stay f32, as in the TPU kernels), then
// splits the PV sum over Dh lanes x groups of keys and reduces the groups
// in shared memory. K and V are read once, straight from device memory.
#pragma once

#include "common.cuh"

namespace ecap {

constexpr int kAttnThreads = 256;

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// out[d] = scale_d * sum_j p[j] * V(j, d) / denom, with V(j, d) read at
// v[j * vstride + d]. `red` holds kAttnThreads floats.
template <typename T, typename TO>
__device__ void pv_sum(const float* p, const T* __restrict__ v, int n,
                       int vstride, int dh, float denom,
                       const float* __restrict__ vscale, float* red,
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
      const int dd = base + idx;
      if (vscale != nullptr) s *= vscale[dd];
      store_out(out + dd, s / denom);
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
         denom, static_cast<const float*>(nullptr), red,
         out + static_cast<size_t>(bh) * dh);
}

// q [B,H,Dh]; kt [B,H,Dh,K] and v [B,H,K,Dh] (int8 or bf16); scales
// kt_scale [B,H,K], v_scale [B,H,Dh] f32 or null (= 1); out [B,H,Dh].
template <typename T, typename TQ, typename TO>
__global__ void __launch_bounds__(kAttnThreads)
decode_cross_kernel(const TQ* __restrict__ q, const T* __restrict__ kt,
                    const T* __restrict__ v,
                    const float* __restrict__ kt_scale,
                    const float* __restrict__ v_scale, TO* __restrict__ out,
                    int dh, int nk) {
  extern __shared__ float sm[];
  float* qs = sm;            // dh
  float* p = qs + dh;        // nk
  float* red = p + nk;       // kAttnThreads
  const int bh = blockIdx.x;
  for (int d = threadIdx.x; d < dh; d += kAttnThreads)
    qs[d] = to_float(q[static_cast<size_t>(bh) * dh + d]);
  __syncthreads();
  const T* kp = kt + static_cast<size_t>(bh) * dh * nk;
  const float rs = sqrtf(static_cast<float>(dh));
  float lmax = kNegInf;
  for (int j = threadIdx.x; j < nk; j += kAttnThreads) {
    float acc = 0.f;
    for (int d = 0; d < dh; ++d)
      acc = fmaf(qs[d], to_float(kp[static_cast<size_t>(d) * nk + j]), acc);
    float s = acc / rs;
    if (kt_scale != nullptr) s *= kt_scale[static_cast<size_t>(bh) * nk + j];
    p[j] = s;
    lmax = fmaxf(lmax, s);
  }
  const float m = block_max(lmax, red);
  float lsum = 0.f;
  for (int j = threadIdx.x; j < nk; j += kAttnThreads) {
    const float e = expf(p[j] - m);
    p[j] = e;
    lsum += e;
  }
  const float denom = block_sum(lsum, red);
  __syncthreads();
  pv_sum(p, v + static_cast<size_t>(bh) * nk * dh, nk, dh, dh, denom,
         v_scale == nullptr ? nullptr : v_scale + static_cast<size_t>(bh) * dh,
         red, out + static_cast<size_t>(bh) * dh);
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

template <typename T, typename TQ, typename TO>
cudaError_t launch_decode_cross(const TQ* q, const void* kt, const void* v,
                                const float* kt_scale, const float* v_scale,
                                TO* out, int b, int h, int dh, int nk,
                                cudaStream_t s) {
  const size_t bytes = attn_smem_bytes(dh, nk);
  cudaError_t err = attn_set_smem(decode_cross_kernel<T, TQ, TO>, bytes);
  if (err != cudaSuccess) return err;
  decode_cross_kernel<T, TQ, TO><<<b * h, kAttnThreads, bytes, s>>>(
      q, static_cast<const T*>(kt), static_cast<const T*>(v), kt_scale,
      v_scale, out, dh, nk);
  return cudaGetLastError();
}

}  // namespace ecap
