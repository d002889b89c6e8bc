// Fused image preprocess: uint8 crops -> normalised ViT patch tokens.
//
// Replaces: embodied_captioning_tpu/ops/pallas/preprocess.py
//   fused_preprocess (_preprocess_kernel)
//
//   [N, H, W, 3] uint8 -> half-pixel bilinear resize to out x out (vertical
//   lerp, then horizontal) -> (v / 255 - mean) / std -> [N, T, p*p*3] f32,
//   a token holding its patch's rows, then columns, then channels.
//
// The TPU kernel takes one image and is mapped over a batch; here the batch
// is a leading axis of one launch. The source rows, columns and fractions
// come precomputed from the wrapper (as the TPU kernel's do), so the kernel
// and its plain version share them. Every product and sum is rounded
// separately (no fused multiply-add) and the divisions are IEEE, so the
// result equals the plain version's bit for bit.
//
// Bound on an H100 SXM (3.35 TB/s): memory. 64 crops of 224^2: 9.6 MB read,
// 38.5 MB written, ~14 us. One thread per output element, consecutive
// threads on consecutive output addresses; the four source bytes of a
// thread lie within a few bytes of its neighbours' and hit in L1.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
preprocess_kernel(const uint8_t* __restrict__ img, const int* __restrict__ y0,
                  const int* __restrict__ y1, const float* __restrict__ fy,
                  const int* __restrict__ x0, const int* __restrict__ x1,
                  const float* __restrict__ fx, float* __restrict__ out,
                  long long total, int h, int w, int out_size, int patch,
                  float m0, float m1, float m2, float s0, float s1, float s2) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int pd = patch * patch * 3;
  const int gw = out_size / patch;
  const long long tok = idx / pd;
  const int rem = static_cast<int>(idx % pd);
  const int c = rem % 3;
  const int lx = (rem / 3) % patch;
  const int ly = rem / (3 * patch);
  const int tokens = gw * gw;
  const long long n = tok / tokens;
  const int ti = static_cast<int>(tok % tokens);
  const int oy = (ti / gw) * patch + ly;
  const int ox = (ti % gw) * patch + lx;

  const uint8_t* base = img + n * h * w * 3 + c;
  const size_t ra = static_cast<size_t>(y0[oy]) * w, rb =
      static_cast<size_t>(y1[oy]) * w;
  const int xa = x0[ox], xb = x1[ox];
  const float wy = fy[oy], wx = fx[ox];
  const float a = base[(ra + xa) * 3], b = base[(ra + xb) * 3];
  const float cc = base[(rb + xa) * 3], d = base[(rb + xb) * 3];
  const float wy0 = __fsub_rn(1.f, wy), wx0 = __fsub_rn(1.f, wx);
  const float left = __fadd_rn(__fmul_rn(a, wy0), __fmul_rn(cc, wy));
  const float right = __fadd_rn(__fmul_rn(b, wy0), __fmul_rn(d, wy));
  const float v = __fadd_rn(__fmul_rn(left, wx0), __fmul_rn(right, wx));
  const float mean = c == 0 ? m0 : (c == 1 ? m1 : m2);
  const float std = c == 0 ? s0 : (c == 1 ? s1 : s2);
  out[idx] = __fdiv_rn(__fsub_rn(__fdiv_rn(v, 255.f), mean), std);
}

}  // namespace

// img [N,H,W,3] uint8; y0,y1 [out] int32 and fy [out] f32: source rows and
// the lower row's weight; x0,x1,fx likewise for columns; out
// [N, (out/patch)^2, patch*patch*3] f32.
extern "C" int ecap_fused_preprocess(const void* img, const void* y0,
                                     const void* y1, const void* fy,
                                     const void* x0, const void* x1,
                                     const void* fx, void* out, int n, int h,
                                     int w, int out_size, int patch, float m0,
                                     float m1, float m2, float s0, float s1,
                                     float s2, void* stream) {
  const long long total = static_cast<long long>(n) * out_size * out_size * 3;
  if (total == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  preprocess_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), static_cast<const int*>(y0),
      static_cast<const int*>(y1), static_cast<const float*>(fy),
      static_cast<const int*>(x0), static_cast<const int*>(x1),
      static_cast<const float*>(fx), static_cast<float*>(out), total, h, w,
      out_size, patch, m0, m1, m2, s0, s1, s2);
  return cudaGetLastError();
}
