// Whole-sublayer decode kernels for one token per row: the cached
// self-attention sublayer and the cross-attention sublayer of a decoder
// block, each one call.
//
// Replaces: embodied_captioning_tpu/ops/pallas/decode_attention.py
//   decode_self_block  (_self_block_kernel)
//   decode_cross_block (_cross_block_kernel)
//
//   self:  x + o(attn(q(ln(x)), cache[< pos] + current k/v)), and the
//          current token's k, v written into the caches at `pos`
//   cross: x + o(attn(q(ln(x)), precomputed cross K/V))
//
// Numerics as the TPU kernels: one-pass bf16-input LayerNorm with the
// relative variance floor, its result rounded to bf16; every projection a
// bf16 x bf16 product with f32 accumulation, then `* scale + bias` in f32
// (int8 weights are converted to bf16 unscaled, the per-output-channel scale
// comes after the dot); q stays f32; the current k and v are rounded to the
// cache type and attention reads the rounded values; f32 probabilities; the
// attention output rounded to bf16 before the out projection; the residual
// added in f32 and the sum rounded to bf16.
//
// Bound on an H100 SXM (3.35 TB/s): memory. At the serving decode shape
// (64 rows, D=768, 12 heads of 64) the self sublayer moves 2.4 MB of int8
// weights and 5.9 MB of caches (T=30), ~2.5 us; the cross sublayer 1.2 MB of
// weights and 25.2 MB of int8 K/V (K=256), ~7.9 us. 4 x 2*64*768*768 =
// 0.3 GFLOP is far below the compute roof.
//
// Design: three launches per call, because attention needs the whole q, k
// and v rows of a head, and the out projection every head of a row: two
// grid-wide dependencies.
//   1. proj_kernel<ln>: LayerNorm and the q (and k, v) projections. A block
//      owns 64 rows x 32 output columns of one projection (grid.z picks the
//      projection), recomputes the rows' LayerNorm statistics, and walks
//      the contraction in chunks of 128: activations are normalised and
//      weights converted to bf16 as they are staged in shared memory with
//      16-byte loads, and 8 warps multiply 16x16x16 tiles on the tensor
//      cores (mma.sync through nvcuda::wmma, f32 accumulators). The
//      epilogue writes q as f32 to a scratch buffer, and k and v straight
//      into the caches at `pos` -- the strided store that the TPU compiler
//      refuses and the TPU caller does outside its kernel.
//   2. the single-query attention kernel of attention.cuh with an f32 query
//      and a bf16 output: the current token is position `pos` of the cache
//      by now, so it is one more key of the same softmax.
//   3. proj_kernel<no ln>: the out projection, scale, bias and residual.
#include <mma.h>

#include "attention.cuh"

namespace {

using namespace nvcuda;

constexpr int kMB = 64;        // rows per block
constexpr int kNB = 32;        // output columns per block
constexpr int kKC = 128;       // contraction chunk
constexpr int kThreads = 256;  // 8 warps: 4 row tiles x 2 column tiles
constexpr int kLdA = kKC + 8;  // bf16 elements; rows stay 16-byte aligned
constexpr int kLdB = kNB + 8;
constexpr int kLdC = kNB + 4;  // f32 elements

enum Kind { kQ = 0, kKCache = 1, kVCache = 2, kResid = 3 };

struct Job {
  const void* w;       // [D, D] int8 or bf16
  const float* scale;  // [D]
  const float* bias;   // [D]
  int kind;
};
struct Jobs {
  Job j[3];
};

// 16 weights of one row -> bf16 in shared memory.
__device__ __forceinline__ void stage_weights(const int8_t* src,
                                              __nv_bfloat16* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
  __align__(16) __nv_bfloat16 tmp[16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    tmp[i] = __float2bfloat16_rn(static_cast<float>(b[i]));
  reinterpret_cast<uint4*>(dst)[0] = reinterpret_cast<const uint4*>(tmp)[0];
  reinterpret_cast<uint4*>(dst)[1] = reinterpret_cast<const uint4*>(tmp)[1];
}
__device__ __forceinline__ void stage_weights(const __nv_bfloat16* src,
                                              __nv_bfloat16* dst) {
  reinterpret_cast<uint4*>(dst)[0] = reinterpret_cast<const uint4*>(src)[0];
  reinterpret_cast<uint4*>(dst)[1] = reinterpret_cast<const uint4*>(src)[1];
}

// a [rows, d] bf16 (x when kLN, else the attention output); every weight
// [d, d]; d % 32 == 0.
template <typename W, bool kLN>
__global__ void __launch_bounds__(kThreads)
proj_kernel(const __nv_bfloat16* __restrict__ a,
            const float* __restrict__ ln_g, const float* __restrict__ ln_b,
            Jobs jobs, const __nv_bfloat16* __restrict__ resid,
            float* __restrict__ q_out, __nv_bfloat16* __restrict__ kc,
            __nv_bfloat16* __restrict__ vc, __nv_bfloat16* __restrict__ out,
            int rows, int d, int heads, int t, int pos, float eps) {
  __shared__ __align__(32) __nv_bfloat16 as[kMB * kLdA];
  __shared__ __align__(32) __nv_bfloat16 bs[kKC * kLdB];
  __shared__ __align__(32) float cs[kMB * kLdC];
  __shared__ float mean[kMB], rstd[kMB];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kNB;
  const int r0 = blockIdx.y * kMB;
  const Job job = blockIdx.z == 0 ? jobs.j[0]
                                  : (blockIdx.z == 1 ? jobs.j[1] : jobs.j[2]);
  const W* __restrict__ w = static_cast<const W*>(job.w);

  if (kLN) {
    for (int rl = warp; rl < kMB; rl += kThreads / 32) {
      const int r = r0 + rl;
      float s1 = 0.f, s2 = 0.f;
      if (r < rows) {
        for (int c = lane; c < d; c += 32) {
          const float xv = ecap::to_float(a[static_cast<size_t>(r) * d + c]);
          s1 += xv;
          s2 += xv * xv;
        }
      }
      s1 = ecap::warp_sum(s1);
      s2 = ecap::warp_sum(s2);
      if (lane == 0) {
        const float m1 = s1 / d;
        const float var = fmaxf(s2 / d - m1 * m1, m1 * m1 * 3e-7f);
        mean[rl] = m1;
        rstd[rl] = 1.f / sqrtf(var + eps);
      }
    }
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.f);
  const int wr = warp & 3, wc = warp >> 2;

  for (int k0 = 0; k0 < d; k0 += kKC) {
    __syncthreads();
    // activations: kMB x kKC in vectors of 8
    for (int v = threadIdx.x; v < kMB * kKC / 8; v += kThreads) {
      const int rl = v / (kKC / 8), kk = (v % (kKC / 8)) * 8;
      const int r = r0 + rl, k = k0 + kk;
      __align__(16) __nv_bfloat16 vals[8];
      if (r < rows && k < d) {
        *reinterpret_cast<uint4*>(vals) = *reinterpret_cast<const uint4*>(
            a + static_cast<size_t>(r) * d + k);
        if (kLN) {
          const float m1 = mean[rl], rs = rstd[rl];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float xn = __fadd_rn(
                __fmul_rn(__fmul_rn(__fsub_rn(ecap::to_float(vals[i]), m1), rs),
                          ln_g[k + i]),
                ln_b[k + i]);
            vals[i] = __float2bfloat16_rn(xn);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) vals[i] = __float2bfloat16_rn(0.f);
      }
      *reinterpret_cast<uint4*>(as + rl * kLdA + kk) =
          *reinterpret_cast<const uint4*>(vals);
    }
    // weights: kKC x kNB in vectors of 16
    for (int v = threadIdx.x; v < kKC * kNB / 16; v += kThreads) {
      const int kk = v / (kNB / 16), c = (v % (kNB / 16)) * 16;
      const int k = k0 + kk;
      if (k < d)
        stage_weights(w + static_cast<size_t>(k) * d + n0 + c,
                      bs + kk * kLdB + c);
    }
    __syncthreads();
    const int kmax = min(kKC, d - k0);
    for (int kk = 0; kk < kmax; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb;
      wmma::load_matrix_sync(fa, as + wr * 16 * kLdA + kk, kLdA);
      wmma::load_matrix_sync(fb, bs + kk * kLdB + wc * 16, kLdB);
      wmma::mma_sync(acc, fa, fb, acc);
    }
  }

  wmma::store_matrix_sync(cs + wr * 16 * kLdC + wc * 16, acc, kLdC,
                          wmma::mem_row_major);
  __syncthreads();
  const int dh = d / heads;
  for (int e = threadIdx.x; e < kMB * kNB; e += kThreads) {
    const int rl = e / kNB, c = e % kNB;
    const int r = r0 + rl, col = n0 + c;
    if (r >= rows) continue;
    const float y = __fadd_rn(__fmul_rn(cs[rl * kLdC + c], job.scale[col]),
                              job.bias[col]);
    const size_t o = static_cast<size_t>(r) * d + col;
    if (job.kind == kQ) {
      q_out[o] = y;
    } else if (job.kind == kKCache) {
      // kc [B, H, Dh, T]
      const int hh = col / dh, dd = col % dh;
      kc[((static_cast<size_t>(r) * heads + hh) * dh + dd) * t + pos] =
          __float2bfloat16_rn(y);
    } else if (job.kind == kVCache) {
      // vc [B, T, H, Dh]
      vc[(static_cast<size_t>(r) * t + pos) * d + col] = __float2bfloat16_rn(y);
    } else {
      out[o] = __float2bfloat16_rn(__fadd_rn(ecap::to_float(resid[o]), y));
    }
  }
}

struct Common {
  const __nv_bfloat16* x;
  const float* g;
  const float* b;
  float* q;              // scratch [rows, d] f32
  __nv_bfloat16* attn;   // scratch [rows, d] bf16
  __nv_bfloat16* out;    // [rows, d] bf16
  int rows, d, heads;
  float eps;
  cudaStream_t s;
};

template <typename W>
cudaError_t project_in(const Common& c, const Jobs& jobs, int njobs,
                       __nv_bfloat16* kc, __nv_bfloat16* vc, int t, int pos) {
  const dim3 grid(c.d / kNB, (c.rows + kMB - 1) / kMB, njobs);
  proj_kernel<W, true><<<grid, kThreads, 0, c.s>>>(
      c.x, c.g, c.b, jobs, nullptr, c.q, kc, vc, nullptr, c.rows, c.d,
      c.heads, t, pos, c.eps);
  return cudaGetLastError();
}

template <typename W>
cudaError_t project_out(const Common& c, const Job& o) {
  Jobs jobs;
  jobs.j[0] = jobs.j[1] = jobs.j[2] = o;
  const dim3 grid(c.d / kNB, (c.rows + kMB - 1) / kMB, 1);
  proj_kernel<W, false><<<grid, kThreads, 0, c.s>>>(
      c.attn, nullptr, nullptr, jobs, c.x, nullptr, nullptr, nullptr, c.out,
      c.rows, c.d, c.heads, 0, 0, c.eps);
  return cudaGetLastError();
}

template <typename W>
cudaError_t self_block(const Common& c, const Jobs& qkv, const Job& o,
                       __nv_bfloat16* kc, __nv_bfloat16* vc, int t, int pos) {
  cudaError_t err = project_in<W>(c, qkv, 3, kc, vc, t, pos);
  if (err != cudaSuccess) return err;
  err = ecap::launch_decode_self(static_cast<const float*>(c.q),
                                 static_cast<const __nv_bfloat16*>(kc),
                                 static_cast<const __nv_bfloat16*>(vc), c.attn,
                                 c.rows, c.heads, c.d / c.heads, t, pos, c.s);
  if (err != cudaSuccess) return err;
  return project_out<W>(c, o);
}

template <typename W, typename KV>
cudaError_t cross_block(const Common& c, const Job& q, const Job& o,
                        const void* kt, const void* v, const float* ks,
                        const float* vs, int nk) {
  Jobs jobs;
  jobs.j[0] = jobs.j[1] = jobs.j[2] = q;
  cudaError_t err = project_in<W>(c, jobs, 1, nullptr, nullptr, 0, 0);
  if (err != cudaSuccess) return err;
  err = ecap::launch_decode_cross<KV>(static_cast<const float*>(c.q), kt, v,
                                      ks, vs, c.attn, c.rows, c.heads,
                                      c.d / c.heads, nk, c.s);
  if (err != cudaSuccess) return err;
  return project_out<W>(c, o);
}

Job make_job(const void* w, const void* scale, const void* bias, int kind) {
  Job j;
  j.w = w;
  j.scale = static_cast<const float*>(scale);
  j.bias = static_cast<const float*>(bias);
  j.kind = kind;
  return j;
}

}  // namespace

// x [B,D] bf16; LN g,b [D] f32; wq,wk,wv,wo [D,D] (int8 if `int8`, else
// bf16) with f32 [D] scales and biases; kc [B,H,Dh,T], vc [B,T,H,Dh] bf16,
// read at positions < pos and written at pos; q: scratch [B,D] f32; attn:
// scratch [B,D] bf16; out [B,D] bf16. D % 32 == 0.
extern "C" int ecap_decode_self_block(
    const void* x, const void* g, const void* b, const void* wq,
    const void* sq, const void* bq, const void* wk, const void* sk,
    const void* bk, const void* wv, const void* sv, const void* bv,
    const void* wo, const void* so, const void* bo, void* kc, void* vc,
    void* q, void* attn, void* out, int rows, int d, int heads, int t, int pos,
    float eps, int int8, void* stream) {
  Common c{static_cast<const __nv_bfloat16*>(x),
           static_cast<const float*>(g),
           static_cast<const float*>(b),
           static_cast<float*>(q),
           static_cast<__nv_bfloat16*>(attn),
           static_cast<__nv_bfloat16*>(out),
           rows, d, heads, eps, static_cast<cudaStream_t>(stream)};
  Jobs qkv;
  qkv.j[0] = make_job(wq, sq, bq, kQ);
  qkv.j[1] = make_job(wk, sk, bk, kKCache);
  qkv.j[2] = make_job(wv, sv, bv, kVCache);
  const Job o = make_job(wo, so, bo, kResid);
  __nv_bfloat16* kcb = static_cast<__nv_bfloat16*>(kc);
  __nv_bfloat16* vcb = static_cast<__nv_bfloat16*>(vc);
  if (int8) return self_block<int8_t>(c, qkv, o, kcb, vcb, t, pos);
  return self_block<__nv_bfloat16>(c, qkv, o, kcb, vcb, t, pos);
}

// As above for the cross-attention sublayer: kt [B,H,Dh,K], v [B,H,K,Dh]
// (int8 if `kv_int8`, else bf16); kt_scale [B,H,K], v_scale [B,H,Dh] f32 or
// null (= 1).
extern "C" int ecap_decode_cross_block(
    const void* x, const void* g, const void* b, const void* wq,
    const void* sq, const void* bq, const void* wo, const void* so,
    const void* bo, const void* kt, const void* v, const void* kt_scale,
    const void* v_scale, void* q, void* attn, void* out, int rows, int d,
    int heads, int nk, float eps, int int8, int kv_int8, void* stream) {
  Common c{static_cast<const __nv_bfloat16*>(x),
           static_cast<const float*>(g),
           static_cast<const float*>(b),
           static_cast<float*>(q),
           static_cast<__nv_bfloat16*>(attn),
           static_cast<__nv_bfloat16*>(out),
           rows, d, heads, eps, static_cast<cudaStream_t>(stream)};
  const Job jq = make_job(wq, sq, bq, kQ);
  const Job jo = make_job(wo, so, bo, kResid);
  const float* ks = static_cast<const float*>(kt_scale);
  const float* vs = static_cast<const float*>(v_scale);
  if (int8) {
    if (kv_int8)
      return cross_block<int8_t, int8_t>(c, jq, jo, kt, v, ks, vs, nk);
    return cross_block<int8_t, __nv_bfloat16>(c, jq, jo, kt, v, ks, vs, nk);
  }
  if (kv_int8)
    return cross_block<__nv_bfloat16, int8_t>(c, jq, jo, kt, v, ks, vs, nk);
  return cross_block<__nv_bfloat16, __nv_bfloat16>(c, jq, jo, kt, v, ks, vs,
                                                   nk);
}
