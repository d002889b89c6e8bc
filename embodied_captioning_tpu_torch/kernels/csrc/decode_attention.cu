// Single-query decode attention: one new token per row attends over the
// self-attention KV cache, or over precomputed cross-attention K/V.
//
// Replaces: embodied_captioning_tpu/ops/pallas/decode_attention.py
//   decode_self_attention  (_self_attn_kernel)
//   decode_cross_attention (_cross_attn_kernel)
//
// Bound on an H100 SXM (3.35 TB/s): both are memory-bound -- one query
// against the cache, ~2 flops per byte. At the serving decode shape (64
// rows, 12 heads, Dh 64) the self-attention reads the live keys only: at
// the last position of a cache of 30, q, kc, vc and the output are 6.2 MB
// per launch, ~1.85 us (3.2 MB, ~0.97 us, at position 14; 201.6 MB, ~60
// us, at the last position of a cache of 1024); the int8 cross K/V
// (K=256) are 25.2 MB plus 0.8 MB of scales, ~7.8 us.
//
// The device code is attention.cuh's, shared with the whole-block decode
// kernels (decode_block.cu: f32 query, bf16 output); here the query is
// bf16 and the output f32. The self-attention takes Dh a multiple of 8
// and caches whose head fits one block's shared memory (self_attn_kernel)
// or whose scores do (self_attn_tiled_kernel: Dh up to 512), with q, kc
// and vc 16-byte aligned (`self_attention_fits` in
// kernels/decode_attention.py mirrors the shapes); the cross-attention
// takes Dh a multiple of 8 up to 4096 and any number of keys
// (`cross_attention_fits`). Each entry returns cudaErrorInvalidValue for
// anything else.
#include "attention.cuh"

namespace {

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" int ecap_decode_self_attention(const void* q, const void* kt,
                                          const void* v, void* out, int b,
                                          int h, int dh, int t, int pos,
                                          void* stream) {
  if (b < 1 || h < 1 || pos < 0 || pos >= t ||
      !ecap::self_attn_fits(dh, t) || !aligned16(q) || !aligned16(kt) ||
      !aligned16(v))
    return static_cast<int>(cudaErrorInvalidValue);
  return ecap::launch_self_attn(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kt),
      static_cast<const __nv_bfloat16*>(v), static_cast<float*>(out), b, h,
      dh, t, pos, false, static_cast<cudaStream_t>(stream));
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
