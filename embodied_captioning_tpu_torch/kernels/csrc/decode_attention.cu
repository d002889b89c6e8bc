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
// The device code (one block per (batch row, head); see attention.cuh) is
// shared with the whole-block decode kernels; here the query is bf16 and
// the output f32. The cross-attention kernel takes Dh a multiple of 8 up to
// 4096 and any number of keys (`cross_attention_fits` in
// kernels/decode_attention.py); the entry returns cudaErrorInvalidValue
// for anything else.
#include "attention.cuh"

extern "C" int ecap_decode_self_attention(const void* q, const void* kt,
                                          const void* v, void* out, int b,
                                          int h, int dh, int t, int pos,
                                          void* stream) {
  return ecap::launch_decode_self(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kt),
      static_cast<const __nv_bfloat16*>(v), static_cast<float*>(out), b, h,
      dh, t, pos, static_cast<cudaStream_t>(stream));
}

extern "C" int ecap_decode_cross_attention(const void* q, const void* kt,
                                           const void* v, const void* kt_scale,
                                           const void* v_scale, void* out,
                                           int b, int h, int dh, int nk,
                                           int int8, void* stream) {
  if (b < 1 || h < 1 || !ecap::cross_attn_fits(dh, nk, int8 ? 1 : 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(q);
  const float* ks = static_cast<const float*>(kt_scale);
  const float* vs = static_cast<const float*>(v_scale);
  float* o = static_cast<float*>(out);
  if (int8)
    return ecap::launch_cross_attn<int8_t>(qb, kt, v, ks, vs, o, b, h, dh, nk,
                                           false, s);
  return ecap::launch_cross_attn<__nv_bfloat16>(qb, kt, v, ks, vs, o, b, h,
                                                dh, nk, false, s);
}
