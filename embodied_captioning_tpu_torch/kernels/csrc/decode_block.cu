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
// 0.3 GFLOP is far below the compute roof. Each sublayer has two grid-wide
// dependencies (attention needs whole q, k and v rows of a head, the out
// projection every head of a row), so each is three launches, and each
// launch has to spread its work over the whole card.
//
// The self sublayer:
//   1. self_qkv_kernel: the q/k/v products as one split-K product of
//      splitk.cuh over 3D columns (8-warp blocks of 64 columns: 3D/64
//      column tiles x S splits, 144 blocks at D=768, S=4), the LayerNorm
//      fused in (each cluster adds its blocks' partial row sums; x is read
//      once). Epilogue: q as f32 into a
//      scratch buffer, k and v rounded to bf16 straight into the caches at
//      `pos` -- k at a stride of T elements, the store that the TPU
//      compiler refuses and the TPU caller does outside its kernel.
//   2. self_attn_kernel of attention.cuh (f32 q, bf16 out), the design
//      `decode_self_attention` launches too: a block of 4 warps per (row,
//      head) copies q, the head's [Dh, T] kc block and the vc rows at
//      positions <= pos into shared memory in one cp.async round, takes
//      QK^T over positions <= pos split over warps
//      and keys, the f32 softmax and PV split over dims and groups of
//      keys. The current token is position `pos` of the cache by now, one
//      more key of the same softmax. The self block takes caches whose
//      head fits that kernel's shared memory (`self_block_plan`).
//   3. block_out_kernel: the out product (split-K, S=8 at D=768: 192
//      blocks), scale, bias and the residual.
//   Launches 2 and 3 use programmatic dependent launch: each is scheduled
//   while the previous one finishes, launch 3 streams its weights in
//   before it waits, and neither reads anything the previous launch
//   writes (q, the caches, the attention output) before its
//   grid_dependency_wait. `self_block_plan` in kernels/decode_attention.py
//   picks both splits.
//
// The cross sublayer, on the same machinery:
//   1. cross_q_kernel: LayerNorm and the q product as one split-K product
//      of splitk.cuh (4-warp blocks of 32 columns: D/32 column tiles x S
//      splits, 192 blocks at D=768, S=8), the LayerNorm fused in as in
//      self_qkv_kernel; q as f32 into a scratch buffer.
//   2. cross_attn_kernel of attention.cuh (f32 q, bf16 out): one block per
//      (row, head) copies the head's K/V and scales into shared memory
//      before its grid_dependency_wait (they are inputs of the step), then
//      waits for q; K/V too long for one block's shared memory go through
//      in tiles of keys.
//   3. block_out_kernel, as in the self sublayer.
//   Launches 2 and 3 use programmatic dependent launch. Letting launch 1's
//   blocks start launch 2 at once (griddepcontrol.launch_dependents), so
//   that its K/V copies overlap the q product, measured no faster and is
//   not in. `cross_block_plan` in kernels/decode_attention.py picks both
//   splits.
#include "attention.cuh"
#include "splitk.cuh"

namespace {

namespace split_k = ecap::splitk;

// warps per block of the q/k/v product (64 output columns: each column
// tile normalises its slices of all rows, so fewer, wider tiles do less
// of that) and of the out product (32 columns: enough tiles to fill the
// card)
constexpr int kQkvWarps = 8;
constexpr int kOutWarps = 4;

// ---------------------------------------------------------------------------
// the self sublayer
// ---------------------------------------------------------------------------

struct Job {
  const void* w;       // [D, D] int8 or bf16
  const float* scale;  // [D]
  const float* bias;   // [D]
};
struct Jobs {
  Job j[3];
};

// x [rows, d] bf16 -> q [rows, d] f32, and the current k and v into
// kc [B, H, Dh, T] and vc [B, T, H, Dh] at `pos`. Column tile n of the 3d
// outputs belongs to q, k or v by n / (d / 64).
template <typename W>
__global__ void __launch_bounds__(split_k::threads<kQkvWarps>())
self_qkv_kernel(const __nv_bfloat16* __restrict__ x,
                const float* __restrict__ ln_g, const float* __restrict__ ln_b,
                Jobs jobs, float* __restrict__ q_out,
                __nv_bfloat16* __restrict__ kc, __nv_bfloat16* __restrict__ vc,
                int rows, int d, int heads, int t, int pos, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kCols = split_k::cols<kQkvWarps>();
  const int tiles = d / kCols;
  const int which = blockIdx.x / tiles;  // 0 q, 1 k, 2 v
  const int n0 = (blockIdx.x % tiles) * kCols;
  const Job job = which == 0 ? jobs.j[0] : (which == 1 ? jobs.j[1] : jobs.j[2]);
  const int dh = d / heads;
  split_k::tile<W, kQkvWarps, true>(
      smem_raw, x, static_cast<const W*>(job.w), d, n0, rows, d, ln_g, ln_b,
      eps, [&](int r, int c4, const float* y) {
        const int col = n0 + c4;
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[i] = __fadd_rn(__fmul_rn(y[i], job.scale[col + i]),
                           job.bias[col + i]);
        if (which == 0) {
          *reinterpret_cast<float4*>(q_out + static_cast<size_t>(r) * d +
                                     col) = make_float4(v[0], v[1], v[2], v[3]);
        } else if (which == 1) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int hh = (col + i) / dh, dd = (col + i) % dh;
            kc[((static_cast<size_t>(r) * heads + hh) * dh + dd) * t + pos] =
                __float2bfloat16_rn(v[i]);
          }
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            vc[(static_cast<size_t>(r) * t + pos) * d + col + i] =
                __float2bfloat16_rn(v[i]);
        }
      });
}

// out = x + (attn wo * so + bo), all [rows, d]: the out product of both
// sublayers (a profile tells them apart by the launch before)
template <typename W>
__global__ void __launch_bounds__(split_k::threads<kOutWarps>())
block_out_kernel(const __nv_bfloat16* __restrict__ attn,
                 const W* __restrict__ wo, const float* __restrict__ so,
                 const float* __restrict__ bo,
                 const __nv_bfloat16* __restrict__ x,
                 __nv_bfloat16* __restrict__ out, int rows, int d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n0 = blockIdx.x * split_k::cols<kOutWarps>();
  split_k::tile<W, kOutWarps, false>(
      smem_raw, attn, wo, d, n0, rows, d, nullptr, nullptr, 0.f,
      [&](int r, int c4, const float* y) {
        split_k::store_residual(x, out, so, bo, d, r, n0 + c4, y);
      });
}

struct SelfArgs {
  const __nv_bfloat16* x;
  const float* g;
  const float* b;
  Jobs qkv;
  Job o;
  __nv_bfloat16* kc;
  __nv_bfloat16* vc;
  float* q;              // scratch [rows, d] f32
  __nv_bfloat16* attn;   // scratch [rows, d] bf16
  __nv_bfloat16* out;    // [rows, d] bf16
  int rows, d, heads, t, pos;
  float eps;
  cudaStream_t s;
};

template <typename W>
cudaError_t self_block(const SelfArgs& a, int s_qkv, int s_out) {
  cudaError_t err = split_k::launch<self_qkv_kernel<W>, kQkvWarps>(
      3 * a.d, s_qkv, a.rows,
      split_k::smem_bytes<W, kQkvWarps>(a.d / s_qkv, true),
      split_k::smem_bytes<W, kQkvWarps>(split_k::kMaxSlice, true), false,
      a.s, a.x, a.g, a.b, a.qkv, a.q, a.kc, a.vc, a.rows, a.d, a.heads, a.t,
      a.pos, a.eps);
  if (err != cudaSuccess) return err;

  err = ecap::launch_self_attn(static_cast<const float*>(a.q), a.kc, a.vc,
                               a.attn, a.rows, a.heads, a.d / a.heads, a.t,
                               a.pos, true, a.s);
  if (err != cudaSuccess) return err;

  return split_k::launch<block_out_kernel<W>, kOutWarps>(
      a.d, s_out, a.rows,
      split_k::smem_bytes<W, kOutWarps>(a.d / s_out, false),
      split_k::smem_bytes<W, kOutWarps>(split_k::kMaxSlice, false), true, a.s,
      static_cast<const __nv_bfloat16*>(a.attn), static_cast<const W*>(a.o.w),
      a.o.scale, a.o.bias, a.x, a.out, a.rows, a.d);
}

Job make_job(const void* w, const void* scale, const void* bias) {
  Job j;
  j.w = w;
  j.scale = static_cast<const float*>(scale);
  j.bias = static_cast<const float*>(bias);
  return j;
}

// ---------------------------------------------------------------------------
// the cross sublayer
// ---------------------------------------------------------------------------

// x [rows, d] bf16 -> q = ln(x) wq * sq + bq, f32 [rows, d]
template <typename W>
__global__ void __launch_bounds__(split_k::threads<kOutWarps>())
cross_q_kernel(const __nv_bfloat16* __restrict__ x,
               const float* __restrict__ ln_g, const float* __restrict__ ln_b,
               Job job, float* __restrict__ q_out, int rows, int d,
               float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n0 = blockIdx.x * split_k::cols<kOutWarps>();
  split_k::tile<W, kOutWarps, true>(
      smem_raw, x, static_cast<const W*>(job.w), d, n0, rows, d, ln_g, ln_b,
      eps, [&](int r, int c4, const float* y) {
        const int col = n0 + c4;
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[i] = __fadd_rn(__fmul_rn(y[i], job.scale[col + i]),
                           job.bias[col + i]);
        *reinterpret_cast<float4*>(q_out + static_cast<size_t>(r) * d + col) =
            make_float4(v[0], v[1], v[2], v[3]);
      });
}

struct CrossArgs {
  const __nv_bfloat16* x;
  const float* g;
  const float* b;
  Job q, o;
  const void* kt;        // [B, H, Dh, K]
  const void* v;         // [B, H, K, Dh]
  const float* ks;       // [B, H, K] or null
  const float* vs;       // [B, H, Dh] or null
  float* qbuf;           // scratch [rows, d] f32
  __nv_bfloat16* attn;   // scratch [rows, d] bf16
  __nv_bfloat16* out;    // [rows, d] bf16
  int rows, d, heads, nk;
  float eps;
  cudaStream_t s;
};

template <typename W, typename KV>
cudaError_t cross_block(const CrossArgs& a, int s_q, int s_out) {
  cudaError_t err = split_k::launch<cross_q_kernel<W>, kOutWarps>(
      a.d, s_q, a.rows, split_k::smem_bytes<W, kOutWarps>(a.d / s_q, true),
      split_k::smem_bytes<W, kOutWarps>(split_k::kMaxSlice, true), false, a.s,
      a.x, a.g, a.b, a.q, a.qbuf, a.rows, a.d, a.eps);
  if (err != cudaSuccess) return err;
  err = ecap::launch_cross_attn<KV>(static_cast<const float*>(a.qbuf), a.kt,
                                    a.v, a.ks, a.vs, a.attn, a.rows, a.heads,
                                    a.d / a.heads, a.nk, true, a.s);
  if (err != cudaSuccess) return err;
  return split_k::launch<block_out_kernel<W>, kOutWarps>(
      a.d, s_out, a.rows,
      split_k::smem_bytes<W, kOutWarps>(a.d / s_out, false),
      split_k::smem_bytes<W, kOutWarps>(split_k::kMaxSlice, false), true, a.s,
      static_cast<const __nv_bfloat16*>(a.attn), static_cast<const W*>(a.o.w),
      a.o.scale, a.o.bias, a.x, a.out, a.rows, a.d);
}

}  // namespace

// x [B,D] bf16; LN g,b [D] f32; wq,wk,wv,wo [D,D] (int8 if `int8`, else
// bf16) with f32 [D] scales and biases; kc [B,H,Dh,T], vc [B,T,H,Dh] bf16,
// read at positions < pos and written at pos; q: scratch [B,D] f32; attn:
// scratch [B,D] bf16; out [B,D] bf16. s_qkv and s_out split the two
// products' D-long contractions. Takes D a multiple of 32 and of H, splits
// as `self_block_plan` gives them (at most 8, slices of a multiple of 16
// and at most 512), 0 <= pos < T; returns cudaErrorInvalidValue otherwise.
extern "C" int ecap_decode_self_block(
    const void* x, const void* g, const void* b, const void* wq,
    const void* sq, const void* bq, const void* wk, const void* sk,
    const void* bk, const void* wv, const void* sv, const void* bv,
    const void* wo, const void* so, const void* bo, void* kc, void* vc,
    void* q, void* attn, void* out, int rows, int d, int heads, int t, int pos,
    float eps, int int8, int s_qkv, int s_out, void* stream) {
  if (rows < 1 || heads < 1 || d % split_k::cols<kQkvWarps>() || d % heads ||
      (d / heads) % 8 || !ecap::self_attn_whole(d / heads, t) ||
      reinterpret_cast<uintptr_t>(kc) % 16 ||
      reinterpret_cast<uintptr_t>(vc) % 16 || pos < 0 ||
      pos >= t || !split_k::valid_split(d, s_qkv) ||
      !split_k::valid_split(d, s_out))
    return static_cast<int>(cudaErrorInvalidValue);
  SelfArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.g = static_cast<const float*>(g);
  a.b = static_cast<const float*>(b);
  a.qkv.j[0] = make_job(wq, sq, bq);
  a.qkv.j[1] = make_job(wk, sk, bk);
  a.qkv.j[2] = make_job(wv, sv, bv);
  a.o = make_job(wo, so, bo);
  a.kc = static_cast<__nv_bfloat16*>(kc);
  a.vc = static_cast<__nv_bfloat16*>(vc);
  a.q = static_cast<float*>(q);
  a.attn = static_cast<__nv_bfloat16*>(attn);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.rows = rows;
  a.d = d;
  a.heads = heads;
  a.t = t;
  a.pos = pos;
  a.eps = eps;
  a.s = static_cast<cudaStream_t>(stream);
  if (int8) return self_block<int8_t>(a, s_qkv, s_out);
  return self_block<__nv_bfloat16>(a, s_qkv, s_out);
}

// As above for the cross-attention sublayer: wq, wo [D,D]; kt [B,H,Dh,K],
// v [B,H,K,Dh] (int8 if `kv_int8`, else bf16); kt_scale [B,H,K], v_scale
// [B,H,Dh] f32 or null (= 1); q: scratch [B,D] f32; attn: scratch [B,D]
// bf16; out [B,D] bf16. s_q and s_out split the two products' D-long
// contractions. Takes D a multiple of 32 and of H, heads as
// cross_attn_fits (attention.cuh) takes them (a multiple of 8 wide, any
// number of keys) and splits as `cross_block_plan` gives them; returns
// cudaErrorInvalidValue otherwise.
extern "C" int ecap_decode_cross_block(
    const void* x, const void* g, const void* b, const void* wq,
    const void* sq, const void* bq, const void* wo, const void* so,
    const void* bo, const void* kt, const void* v, const void* kt_scale,
    const void* v_scale, void* q, void* attn, void* out, int rows, int d,
    int heads, int nk, float eps, int int8, int kv_int8, int s_q, int s_out,
    void* stream) {
  if (rows < 1 || heads < 1 || d % split_k::cols<kOutWarps>() || d % heads ||
      !ecap::cross_attn_fits(d / heads, nk, kv_int8 ? 1 : 2) ||
      !split_k::valid_split(d, s_q) || !split_k::valid_split(d, s_out))
    return static_cast<int>(cudaErrorInvalidValue);
  CrossArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.g = static_cast<const float*>(g);
  a.b = static_cast<const float*>(b);
  a.q = make_job(wq, sq, bq);
  a.o = make_job(wo, so, bo);
  a.kt = kt;
  a.v = v;
  a.ks = static_cast<const float*>(kt_scale);
  a.vs = static_cast<const float*>(v_scale);
  a.qbuf = static_cast<float*>(q);
  a.attn = static_cast<__nv_bfloat16*>(attn);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.rows = rows;
  a.d = d;
  a.heads = heads;
  a.nk = nk;
  a.eps = eps;
  a.s = static_cast<cudaStream_t>(stream);
  if (int8)
    return kv_int8 ? cross_block<int8_t, int8_t>(a, s_q, s_out)
                   : cross_block<int8_t, __nv_bfloat16>(a, s_q, s_out);
  return kv_int8 ? cross_block<__nv_bfloat16, int8_t>(a, s_q, s_out)
                 : cross_block<__nv_bfloat16, __nv_bfloat16>(a, s_q, s_out);
}
