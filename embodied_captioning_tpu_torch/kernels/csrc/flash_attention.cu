// Flash attention forward: softmax(Q K^T * scale) V for one (batch, head)
// per grid row, any sequence length, optional causal mask and key-length
// mask (`valid_len`).
//
// Replaces: embodied_captioning_tpu/ops/pallas/flash_attention.py
//   flash_attention (single-block _attn_single_block_kernel, T <= 512, and
//   the blocked _flash_kernel for longer T) -- one kernel for every T here.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): at the ViT-L encode
// shape q,k,v,o = [64,16,257,64] bf16 the four tensors are 4 x 33.7 MB, so
// memory bounds it at ~40 us; its 4*B*H*T*T*D = 17.3 GFLOP take ~17.5 us at
// the tensor-core peak.
//
// Design (simple first): one block of 64 threads takes 64 queries of one
// (b, h); each thread owns one query row, keeps q and the output
// accumulator in registers (f32), and walks the keys in shared-memory tiles
// of 64 (K and V as bf16, 16-byte loads; tile reads are shared-memory
// broadcasts). Two passes over the keys: the first takes the row max and
// softmax denominator online in f32; the second recomputes the scores and
// rounds the NORMALISED probabilities to bf16 before the PV product, as the
// TPU single-block kernel does -- so the kernel differs from that function
// only by summation order. The extra QK pass costs half again the flops.
// Products run on the FP32 pipes (no tensor cores yet).
#include "common.cuh"

namespace {

constexpr int kBQ = 64;  // queries per block (one per thread)
constexpr int kBK = 64;  // keys per shared-memory tile
constexpr int kCH = 16;  // keys per online-softmax chunk

template <int D>
__global__ void __launch_bounds__(kBQ)
flash_fwd(const __nv_bfloat16* __restrict__ q,
          const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v,
          __nv_bfloat16* __restrict__ o, int t, int causal, int valid_len,
          float sm_scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[kBK * D];
  __shared__ __align__(16) __nv_bfloat16 vs[kBK * D];
  const size_t base = static_cast<size_t>(blockIdx.y) * t * D;
  const int q0 = blockIdx.x * kBQ;
  const int row = q0 + threadIdx.x;
  const bool active = row < t;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = active ? ecap::to_float(q[base + static_cast<size_t>(row) * D + d])
                   : 0.f;
    acc[d] = 0.f;
  }
  float m = ecap::kNegInf;
  float l = 0.f;

  int kend = min(t, valid_len);
  if (causal) kend = min(kend, q0 + kBQ);

  // pass 0: row max m and denominator l; pass 1: normalised bf16
  // probabilities times V
  for (int pass = 0; pass < 2; ++pass) {
    const float l_safe = fmaxf(l, 1e-30f);
    for (int k0 = 0; k0 < kend; k0 += kBK) {
      __syncthreads();
      constexpr int kVec = D / 8;  // 16-byte vectors per row
      for (int i = threadIdx.x; i < kBK * kVec; i += kBQ) {
        const int r = i / kVec;
        const int c = (i % kVec) * 8;
        uint4 kk = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
        if (k0 + r < t) {
          const size_t off = base + static_cast<size_t>(k0 + r) * D + c;
          kk = *reinterpret_cast<const uint4*>(k + off);
          if (pass) vv = *reinterpret_cast<const uint4*>(v + off);
        }
        *reinterpret_cast<uint4*>(ks + r * D + c) = kk;
        if (pass) *reinterpret_cast<uint4*>(vs + r * D + c) = vv;
      }
      __syncthreads();
      if (!active) continue;
      for (int c0 = 0; c0 < kBK && k0 + c0 < kend; c0 += kCH) {
        float s[kCH];
        float cmax = ecap::kNegInf;
#pragma unroll
        for (int j = 0; j < kCH; ++j) {
          const int key = k0 + c0 + j;
          const bool live = key < kend && (!causal || key <= row);
          float dot = 0.f;
          const uint4* kr = reinterpret_cast<const uint4*>(ks + (c0 + j) * D);
#pragma unroll
          for (int d8 = 0; d8 < D / 8; ++d8) {
            const uint4 w = kr[d8];
            const __nv_bfloat162* p2 =
                reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = __bfloat1622float2(p2[e]);
              dot = fmaf(qr[d8 * 8 + 2 * e], f.x, dot);
              dot = fmaf(qr[d8 * 8 + 2 * e + 1], f.y, dot);
            }
          }
          s[j] = live ? dot * sm_scale : ecap::kNegInf;
          cmax = fmaxf(cmax, s[j]);
        }
        if (pass == 0) {
          const float m_new = fmaxf(m, cmax);
          float add = 0.f;
#pragma unroll
          for (int j = 0; j < kCH; ++j)
            add += s[j] > 0.5f * ecap::kNegInf ? expf(s[j] - m_new) : 0.f;
          l = l * expf(m - m_new) + add;
          m = m_new;
          continue;
        }
#pragma unroll
        for (int j = 0; j < kCH; ++j) {
          const float p = s[j] > 0.5f * ecap::kNegInf ? expf(s[j] - m) : 0.f;
          const float pb = ecap::round_bf16(p / l_safe);
          const uint4* vr = reinterpret_cast<const uint4*>(vs + (c0 + j) * D);
#pragma unroll
          for (int d8 = 0; d8 < D / 8; ++d8) {
            const uint4 w = vr[d8];
            const __nv_bfloat162* p2 =
                reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = __bfloat1622float2(p2[e]);
              acc[d8 * 8 + 2 * e] = fmaf(pb, f.x, acc[d8 * 8 + 2 * e]);
              acc[d8 * 8 + 2 * e + 1] = fmaf(pb, f.y, acc[d8 * 8 + 2 * e + 1]);
            }
          }
        }
      }
    }
  }
  if (!active) return;
  __nv_bfloat16* orow = o + base + static_cast<size_t>(row) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) orow[d] = __float2bfloat16_rn(acc[d]);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int t, int causal, int valid_len, float scale,
                   cudaStream_t stream) {
  const dim3 grid((t + kBQ - 1) / kBQ, bh);
  flash_fwd<D><<<grid, kBQ, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), t,
      causal, valid_len, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: contiguous bf16 [bh, t, d]; keys at index >= valid_len are
// masked. Returns the launch's cudaError_t.
extern "C" int ecap_flash_attention(const void* q, const void* k,
                                    const void* v, void* o, int bh, int t,
                                    int d, int causal, int valid_len,
                                    float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch<32>(q, k, v, o, bh, t, causal, valid_len, sm_scale, s);
    case 64: return launch<64>(q, k, v, o, bh, t, causal, valid_len, sm_scale, s);
    case 128: return launch<128>(q, k, v, o, bh, t, causal, valid_len, sm_scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
