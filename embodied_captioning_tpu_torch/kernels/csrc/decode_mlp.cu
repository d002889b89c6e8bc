// Fused decode MLP for one token per row: out = x + proj(gelu(fc(ln(x)))).
//
// Replaces: embodied_captioning_tpu/ops/pallas/decode_attention.py
//   decode_mlp (_mlp_kernel)
//
// Numerics as the TPU kernel: one-pass bf16-input LayerNorm with the
// relative variance floor, LN output rounded to bf16, bf16 x bf16 products
// with f32 accumulation (int8 weights convert to bf16 exactly), the
// per-output-channel weight scale applied AFTER the whole dot, then the
// bias, tanh GELU in f32, a bf16 round of h before the second product, its
// scale and bias, the residual in f32, bf16 out. Weights int8 or bf16.
// Partial sums are added in a fixed order, so two runs give equal bits.
// The `// mark N:` lines are where scripts/trace_decode_mlp.py times the
// kernel's phases.
//
// Bound on an H100 SXM (3.35 TB/s): at the serving decode shape (64 rows,
// D=768, F=3072, int8 weights) the two weight matrices are 4.7 MB, ~1.4 us;
// 2*2*64*768*3072 = 0.6 GFLOP is far below the compute roof. So the kernel
// has to spread the weights over every SM, keep each SM's share in flight
// at once, and pay few serial latencies.
//
// Design: two launches, fc (with the LayerNorm) and proj, each a split-K
// product of 64 rows by 128 (fc) or 64 (proj) output columns a block on
// the tensor cores (wgmma m64n64k16 a 64-column half), blocks of two
// warpgroups:
//  - Every copy is TMA: the block's whole weight slice ([K/S, 64] as 64-row
//    chunks) and its activation slice ([64 rows, K/S] as 64-column chunks,
//    rows past the last zero-filled by the hardware) are put in flight at
//    once by one thread, each chunk completing on its own mbarrier.
//  - The weights, the scales and biases and fc's LayerNorm weights are
//    read, and int8 chunks widened to bf16 into 128-byte-swizzled tiles
//    (a byte permute and a subtraction each, one conversion a pair), before
//    `griddepcontrol.wait`: under programmatic dependent launch that work
//    overlaps the previous launch (fc first puts its activation copy in
//    flight). fc lets proj launch at once
//    (`griddepcontrol.launch_dependents`); an fc block and a proj block
//    fit an SM (the carveout is all shared memory), so proj's weights are
//    in place when fc ends, and proj waits only for h.
//  - The products: the activations (K-major) as A, the weight chunk read
//    transposed (MN-major) as B, on the first warpgroup; both warpgroups
//    do the LayerNorm, the widening and the epilogue.
//  - The S blocks of a column tile form one thread-block cluster. fc's
//    cluster spans the whole D-long contraction, so it holds whole rows:
//    each block sums x and x^2 of its slice per row, the cluster adds the
//    S sums in rank order through distributed shared memory, and each
//    block normalises its slice in place before its products (no
//    LayerNorm launch, x read once). After the products each block leaves
//    its f32 partial tile in shared memory; block s of the cluster sums
//    rows s, s + S, ... of the S tiles in rank order (all of a thread's
//    remote loads in flight at once), releases the cluster and applies the
//    epilogue: fc writes h = gelu(y * scale + bias) in bf16, proj
//    out = x + y * scale + bias (x read while the products run).
// Every fc block normalises its slice of x for its own column tile, so
// wider fc tiles repeat that work fewer times. `mlp_plan` in
// kernels/decode_attention.py picks S: 4 for fc (96 blocks, one an SM)
// and 8 for proj (96 blocks) at the serving shape.
//
// Measured (H100 80GB HBM3, 700 W; `chip_smoke.py --rows . decode_mlp`):
// 15.9 us a call at [64, 768] int8 beside 12.9 us for two library matmuls
// on bf16 weights. What holds it back is a chain of dependent steps of about a
// microsecond each (`scripts/trace_decode_mlp.py` reads them): in fc the
// TMA round trip, the LayerNorm (~2.9 us: sums, cluster barrier,
// statistics, normalisation), the products, the partial tiles' barrier,
// the remote sums and the epilogue; then the dependent launch's wait and
// the same tail in proj.
// Tried and dropped (the same card): the first version of this design
// (one warpgroup a block, each int8 chunk widened just before its
// products, the LayerNorm weights read from device memory, shared-memory
// addresses aligned through an integer so the compiler lost their state
// space and issued generic loads) took 20.4 us; the split's remote loads
// summed one by one as they came (ptxas reused one register, so each
// waited for the last) cost about a microsecond a launch; fc in 64-column
// tiles (192 blocks, two an SM) 16.4 us; with 128-column tiles, fc at 8
// or 2 splits, fc unsplit, row statistics read by every block from device
// memory in place of the cluster's sums (L2 traffic of 18 MB), and the
// remote sums ordered rank by rank were all slower (marks-on readings of
// the trace script, 1-3 us each). Before this design: three launches (a
// LayerNorm, then each product on mma.sync with cp.async staging, 32
// columns a block, 192 blocks each), 22.0 us a call, 24.5 in the decode
// loop, against 12.5 us for two library matmuls on bf16 weights; each
// launch ~7 us, load, math and reduction serial inside every block.
#include <cooperative_groups.h>

#include "hopper.cuh"
#include "mma.cuh"

namespace {

namespace cg = cooperative_groups;
namespace hw = ecap::hopper;

constexpr int kRows = 64;        // rows a block: the wgmma M
constexpr int kHalf = 64;        // columns a wgmma (its N) and a TMA box
constexpr int kChunk = 64;       // contraction a TMA chunk
constexpr int kThreads = 256;    // two warpgroups; the first multiplies
constexpr int kMaxSplits = 8;    // the portable cluster size
constexpr int kMaxChunks = 8;    // contraction a block: 512
constexpr int kMaxD = 1024;
constexpr int kTileBytes = kRows * kChunk * 2;  // a bf16 64 x 64 tile

// output columns a block: 128 in fc, whose blocks each normalise their
// slice of x again (twice the columns, half the repeats), 64 in proj, so
// that a proj block fits on an SM beside an fc block
template <bool kFc>
__host__ __device__ constexpr int cols() {
  return kFc ? 2 * kHalf : kHalf;
}
// the longest slice of the contraction a block takes: fc's 128 columns
// of int8 weights need 32 KB of shared memory a 64-deep chunk
template <bool kFc>
__host__ __device__ constexpr int max_slice() {
  return kFc ? 6 * kChunk : kMaxChunks * kChunk;
}
// the f32 partial tile's row stride
template <bool kFc>
__host__ __device__ constexpr int part_ld() {
  return cols<kFc>() + 4;
}
template <typename W, bool kFc>
__host__ __device__ constexpr int raw_bytes() {
  return kChunk * cols<kFc>() * static_cast<int>(sizeof(W));
}
// the activation chunks, later the f32 partial tile (and proj's raw int8
// weights before its activations arrive)
template <bool kFc>
__host__ __device__ constexpr int a_bytes(int chunks) {
  return chunks * kTileBytes > kRows * part_ld<kFc>() * 4
             ? chunks * kTileBytes
             : kRows * part_ld<kFc>() * 4;
}
// where a block's raw weight chunks go: proj stages int8 in the activation
// area, fc int8 and all bf16 weights in their own
template <typename W, bool kFc>
__host__ __device__ constexpr int wraw_bytes(int chunks) {
  return sizeof(W) == 1 && !kFc ? 0 : chunks * raw_bytes<W, kFc>();
}
// widened int8 chunks
template <typename W, bool kFc>
__host__ __device__ constexpr int wide_bytes(int chunks) {
  return sizeof(W) == 2 ? 0 : chunks * (cols<kFc>() / kHalf) * kTileBytes;
}
// 1024 bytes of alignment, the activations, raw and widened weights, fc's
// LayerNorm weights and row statistics, the tile's scales and biases, the
// barriers. An fc block and a proj block fit an SM together at the serving
// shape (112,256 + 99,968 bytes and 1 KB reserved each, of 233,472): proj
// starts while fc runs.
template <typename W, bool kFc>
__host__ __device__ constexpr int smem_bytes(int chunks) {
  return 1024 + a_bytes<kFc>(chunks) + wraw_bytes<W, kFc>(chunks) +
         wide_bytes<W, kFc>(chunks) +
         (kFc ? 2 * chunks * kChunk * 4 + 4 * kRows * 4 : 0) +
         2 * cols<kFc>() * 4 + 2 * kMaxChunks * 8;
}

struct Args {
  const float* scale;
  const float* bias;
  const float* ln_g;
  const float* ln_b;
  const __nv_bfloat16* resid;  // x, for proj's residual
  __nv_bfloat16* out;          // h [rows, n] (fc) or out [rows, n] (proj)
  int rows, kdim, n;
  float eps;
};

__device__ __forceinline__ float gelu_tanh(float y) {
  const float inner = 0.7978845608028654f * (y + 0.044715f * (y * y * y));
  return y * (0.5f * (1.f + tanhf(inner)));
}

// a 16-byte vector v (8 bf16, columns 8 v ..) of row r of a swizzled tile
__device__ __forceinline__ uint4* vec(unsigned char* tile, int r, int v) {
  return reinterpret_cast<uint4*>(tile + r * 128 + ((v ^ (r & 7)) << 4));
}

// four int8 in a word -> two bf16 pairs (exact): each byte, offset by
// 128, placed in the mantissa of 2^23 by one byte permute, then
// 2^23 + 128 subtracted; one conversion a pair
__device__ __forceinline__ void widen4(uint32_t q, uint32_t& lo,
                                       uint32_t& hi) {
  const uint32_t u = q ^ 0x80808080u;  // v + 128, as unsigned bytes
  float f[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7650 | e)) -
           8388736.f;
  lo = ecap::pack_bf16(f[0], f[1]);
  hi = ecap::pack_bf16(f[2], f[3]);
}

// int8 chunk [64 k][64 n] (rows of 64 bytes) -> bf16 swizzled [64 k][64 n]:
// one row's 16 weights a thread
__device__ __forceinline__ void widen(const int8_t* raw, unsigned char* dst) {
  const int k = threadIdx.x >> 2, v = threadIdx.x & 3;  // columns 16 v ..
  const uint4 q = *reinterpret_cast<const uint4*>(raw + k * kHalf + 16 * v);
  uint32_t h[8];
  widen4(q.x, h[0], h[1]);
  widen4(q.y, h[2], h[3]);
  widen4(q.z, h[4], h[5]);
  widen4(q.w, h[6], h[7]);
  *vec(dst, k, 2 * v) = make_uint4(h[0], h[1], h[2], h[3]);
  *vec(dst, k, 2 * v + 1) = make_uint4(h[4], h[5], h[6], h[7]);
}

// the two bf16 of a word as floats (low half first)
__device__ __forceinline__ float2 unpack_bf16(uint32_t w) {
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// fc's LayerNorm of the block's [64, slice] activations in place; the
// cluster's blocks hold the rest of each row. lnw: the slice's g, then b;
// stats: 4 floats a row. Four threads a row, each every fourth 16-byte
// vector of it, partial sums in a fixed order.
__device__ __forceinline__ void layer_norm(cg::cluster_group& cluster,
                                           unsigned char* as, float* stats,
                                           const float* lnw, int slice,
                                           const Args& a) {
  const int r = threadIdx.x >> 2, quarter = threadIdx.x & 3;
  const int nv = slice / 8;
  auto at = [&](int j) { return vec(as + (j >> 3) * kTileBytes, r, j & 7); };
  float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll 4
  for (int j = quarter; j < nv; j += 4) {
    const uint4 raw = *at(j);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    const int i = (j >> 2) & 1;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = unpack_bf16(w[e]);
      s1[i] += f.x + f.y;
      s2[i] = fmaf(f.y, f.y, fmaf(f.x, f.x, s2[i]));
    }
  }
  float t1 = s1[0] + s1[1], t2 = s2[0] + s2[1];
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    t1 += __shfl_xor_sync(0xffffffffu, t1, o);
    t2 += __shfl_xor_sync(0xffffffffu, t2, o);
  }
  float* sums = stats;               // [64][2]: this slice's sums
  float* norm = stats + 2 * kRows;   // [64][2]: mean, 1/sqrt(var + eps)
  if (quarter == 0) {
    sums[2 * r] = t1;
    sums[2 * r + 1] = t2;
  }
  cluster.sync();
  if (threadIdx.x < kRows) {
    float2 ps[kMaxSplits];  // every rank's sums in flight, then added
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < static_cast<int>(gridDim.y))
        ps[s] = *reinterpret_cast<const float2*>(
            cluster.map_shared_rank(sums, s) + 2 * threadIdx.x);
    float u1 = 0.f, u2 = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < static_cast<int>(gridDim.y)) {
        u1 += ps[s].x;
        u2 += ps[s].y;
      }
    const float m1 = u1 / a.kdim, mm = __fmul_rn(m1, m1);
    const float var = fmaxf(__fsub_rn(u2 / a.kdim, mm), __fmul_rn(mm, 3e-7f));
    norm[2 * threadIdx.x] = m1;
    norm[2 * threadIdx.x + 1] = 1.f / sqrtf(var + a.eps);
  }
  __syncthreads();
  const float m1 = norm[2 * r], rs = norm[2 * r + 1];
#pragma unroll 4
  for (int j = quarter; j < nv; j += 4) {
    const int col = 8 * j;
    uint4* p = at(j);
    const uint4 raw = *p;
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    const float4 g0 = *reinterpret_cast<const float4*>(lnw + col);
    const float4 g1 = *reinterpret_cast<const float4*>(lnw + col + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(lnw + slice + col);
    const float4 b1 = *reinterpret_cast<const float4*>(lnw + slice + col + 4);
    const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = unpack_bf16(w[e]);
      o[e] = ecap::pack_bf16(
          __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f.x, m1), rs), gv[2 * e]),
                    bv[2 * e]),
          __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f.y, m1), rs),
                              gv[2 * e + 1]),
                    bv[2 * e + 1]));
    }
    *p = make_uint4(o[0], o[1], o[2], o[3]);
  }
  // the normalised tile is read by wgmma (the async proxy)
  hw::fence_async_shared();
  __syncthreads();
}

// One block: rows blockIdx.z * 64 .., output columns blockIdx.x * kN ..,
// contraction slice blockIdx.y of gridDim.y. kFc: A = x (normalised here),
// epilogue gelu -> h; otherwise A = h, epilogue + bias + residual.
template <typename W, bool kFc>
__global__ void __launch_bounds__(kThreads)
mlp_wg_kernel(const __grid_constant__ CUtensorMap ta,
              const __grid_constant__ CUtensorMap tw, const Args a) {
  constexpr bool kInt8 = sizeof(W) == 1;
  constexpr int kRaw = raw_bytes<W, kFc>(), kN = cols<kFc>();
  constexpr int kHalves = kN / kHalf, kLd = part_ld<kFc>();
  constexpr int kBox = kHalf * kChunk * static_cast<int>(sizeof(W));
  // mark 0: start
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* as = hw::align1024(smem_raw);
  const int splits = gridDim.y, slice = a.kdim / splits;
  const int nch = (slice + kChunk - 1) / kChunk;
  // proj's int8 chunks wait in the activation area until widened
  unsigned char* wraw =
      wraw_bytes<W, kFc>(nch) ? as + a_bytes<kFc>(nch) : as;
  unsigned char* wide = as + a_bytes<kFc>(nch) + wraw_bytes<W, kFc>(nch);
  float* lnw = reinterpret_cast<float*>(wide + wide_bytes<W, kFc>(nch));
  float* stats = lnw + 2 * nch * kChunk;  // fc only, as lnw
  // the tile's scales, then biases: apart from fc's row sums, which the
  // cluster's other blocks read while this one goes on
  float* sb = kFc ? stats + 4 * kRows : lnw;
  uint64_t* wfull = reinterpret_cast<uint64_t*>(sb + 2 * kN);
  uint64_t* afull = wfull + kMaxChunks;
  float* part = reinterpret_cast<float*>(as);  // once the products are done
  const int tid = threadIdx.x;
  // the warpgroup, shuffled from lane 0 so the compiler knows it uniform
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int split = blockIdx.y, n0 = blockIdx.x * kN;
  const int k0 = split * slice, r0 = blockIdx.z * kRows;
  const int live = min(kRows, a.rows - r0);

  if (tid == 0) {
    for (int ch = 0; ch < nch; ++ch) {
      hw::mbar_init(wfull + ch, 1);
      hw::mbar_init(afull + ch, 1);
    }
    hw::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int ch = 0; ch < nch; ++ch) {
      hw::mbar_expect_tx(wfull + ch, kRaw);
      for (int h = 0; h < kHalves; ++h)
        hw::tma_load_2d(wraw + ch * kRaw + h * kBox, &tw, wfull + ch,
                        n0 + kHalf * h, k0 + kChunk * ch);
    }
  // the tile's scales, then biases, into shared memory
  auto load_sb = [&] {
    if (tid < 2 * kN / 4) {
      const int c = 4 * (tid % (kN / 4));
      const float* src = tid < kN / 4 ? a.scale : a.bias;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n0 + c < a.n) v = *reinterpret_cast<const float4*>(src + n0 + c);
      reinterpret_cast<float4*>(sb)[tid] = v;
    }
  };
  auto load_activations = [&] {
    if (tid == 0)
      for (int ch = 0; ch < nch; ++ch) {
        hw::mbar_expect_tx(afull + ch, kTileBytes);
        hw::tma_load_2d(as + ch * kTileBytes, &ta, afull + ch,
                        k0 + kChunk * ch, r0);
      }
  };
  auto widen_all = [&] {
    for (int ch = 0; ch < nch; ++ch) {
      hw::mbar_wait(wfull + ch, 0);
      for (int h = 0; h < kHalves; ++h)
        widen(reinterpret_cast<const int8_t*>(wraw + ch * kRaw + h * kBox),
              wide + (ch * kHalves + h) * kTileBytes);
    }
    // the widened tiles are read by wgmma, and proj's raw chunks before
    // TMA writes the activations over them
    hw::fence_async_shared();
    __syncthreads();
  };
  if constexpr (kFc) {
    // x comes from the previous launch: its copy first, then what waits
    // for no launch (the LayerNorm weights, scales and biases, widening)
    // while it flies
    // mark 1: before the wait for the previous launch
    ecap::grid_dependency_wait();
    // mark 2: previous launch done
    hw::launch_dependents();
    load_activations();
    load_sb();
    for (int i = tid; i < slice / 4; i += kThreads) {
      reinterpret_cast<float4*>(lnw)[i] =
          reinterpret_cast<const float4*>(a.ln_g + k0)[i];
      reinterpret_cast<float4*>(lnw + slice)[i] =
          reinterpret_cast<const float4*>(a.ln_b + k0)[i];
    }
    if constexpr (kInt8) widen_all();
  } else {
    // proj's blocks start while fc runs: its scales, biases and widened
    // weights are ready before h is
    load_sb();
    if constexpr (kInt8) widen_all();
    // mark 1: before the wait for the previous launch
    ecap::grid_dependency_wait();
    // mark 2: previous launch done
    load_activations();
  }
  // this block's epilogue items: rows split, split + S, ... of the tile,
  // four columns each; proj's residuals read now, while the products run
  constexpr int Q = kN / 4;  // float4 columns a row
  constexpr int kItems = kRows * Q / kThreads;
  uint2 xres[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int e = tid + it * kThreads;
    const int rl = split + (e / Q) * splits, oc = n0 + (e % Q) * 4;
    xres[it] = make_uint2(0u, 0u);
    if (!kFc && rl < live && oc < a.n)
      xres[it] = *reinterpret_cast<const uint2*>(
          a.resid + static_cast<size_t>(r0 + rl) * a.n + oc);
  }
  if constexpr (kFc) {
    for (int ch = 0; ch < nch; ++ch) hw::mbar_wait(afull + ch, 0);
    // mark 3: activations arrived (fc)
    layer_norm(cluster, as, stats, lnw, slice, a);
  }

  // mark 4: LayerNorm done / proj ready
  // the products, on the first warpgroup: one m64n64k16 a 64-column half
  float acc[kHalves * 32];
  if (wg == 0) {
    for (int ch = 0; ch < nch; ++ch) {
      if constexpr (!kInt8) hw::mbar_wait(wfull + ch, 0);
      if constexpr (!kFc) hw::mbar_wait(afull + ch, 0);
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        if (kChunk * ch + 16 * kk >= slice) break;
#pragma unroll
        for (int h = 0; h < kHalves; ++h) {
          const unsigned char* wt =
              kInt8 ? wide + (ch * kHalves + h) * kTileBytes
                    : wraw + ch * kRaw + h * kBox;
          hw::wgmma_ss_n64<1>(acc + 32 * h,
                              hw::desc_sw128(as + ch * kTileBytes + kk * 32),
                              hw::desc_sw128(wt + kk * 2048), ch + kk);
        }
      }
      hw::wgmma_commit();
    }
    // mark 5: products issued
    hw::wgmma_wait<0>();
    hw::fence_regs<kHalves * 32>(acc);
  }
  __syncthreads();  // the products have read the activations
  // mark 6: products done

  // the first warpgroup's unscaled partial tile [64, kN] f32, over the
  // activations
  if (wg == 0) {
    const int warp = tid >> 5, g = (tid & 31) >> 2, tq = tid & 3;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(part + (16 * warp + g + 8 * i) * kLd +
                                   8 * j + 2 * tq) =
            make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  }
  cluster.sync();
  // mark 7: partial tile shared

  // block s of the cluster finishes rows s, s + S, ...: the S partials
  // summed in rank order, all of a thread's reads before any epilogue, so
  // the cluster's last barrier can open while the epilogues run
  const float* parts[kMaxSplits];
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s)
    parts[s] = s < splits ? cluster.map_shared_rank(part, s) : part;
  float y[kItems][4];
  bool use[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int e = tid + it * kThreads;
    const int rl = split + (e / Q) * splits, c4 = (e % Q) * 4;
    use[it] = rl < live && n0 + c4 < a.n;
#pragma unroll
    for (int i = 0; i < 4; ++i) y[it][i] = 0.f;
    if (!use[it]) continue;
    float4 p[kMaxSplits];  // every rank's loads in flight, then the sum
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < splits)
        p[s] = *reinterpret_cast<const float4*>(parts[s] + rl * kLd + c4);
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < splits) {
        y[it][0] += p[s].x;
        y[it][1] += p[s].y;
        y[it][2] += p[s].z;
        y[it][3] += p[s].w;
      }
  }
  // mark 8: partials summed
  cluster_arrive();  // this block's reads of the cluster's tiles are done
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    if (!use[it]) continue;
    const int e = tid + it * kThreads;
    const int rl = split + (e / Q) * splits, c = (e % Q) * 4;
    const size_t o = static_cast<size_t>(r0 + rl) * a.n + n0 + c;
    const float2 x01 = unpack_bf16(xres[it].x), x23 = unpack_bf16(xres[it].y);
    const float xv[4] = {x01.x, x01.y, x23.x, x23.y};
    float z[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = __fadd_rn(__fmul_rn(y[it][i], sb[c + i]),
                                sb[kN + c + i]);
      z[i] = kFc ? gelu_tanh(v) : __fadd_rn(xv[i], v);
    }
    *reinterpret_cast<uint2*>(a.out + o) =
        make_uint2(ecap::pack_bf16(z[0], z[1]), ecap::pack_bf16(z[2], z[3]));
  }
  // the partial tiles stay until every block of the cluster has read them
  // mark 9: epilogue stored
  cluster_wait();
  // mark 10: cluster released
}

inline bool valid_split(int kdim, int splits, int max_slice) {
  return splits >= 1 && splits <= kMaxSplits && kdim % (16 * splits) == 0 &&
         kdim / splits <= max_slice;
}

// a [rows, cols] bf16 activation map, or a [k, n] weight map, in 64 x 64
// boxes (128-byte swizzle for bf16, plain rows of bytes for int8)
template <typename T>
cudaError_t map2d(CUtensorMap* m, const void* base, int inner, int outer) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const uint64_t dims[2] = {static_cast<uint64_t>(inner),
                            static_cast<uint64_t>(outer)};
  const uint64_t strides[1] = {static_cast<uint64_t>(inner) * sizeof(T)};
  const uint32_t box[2] = {64, 64};
  return hw::make_map(m, kBf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                               : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                      2, base, dims, strides, box, kBf16);
}

template <typename W, bool kFc>
cudaError_t product(const CUtensorMap& ta, const CUtensorMap& tw,
                    const Args& a, int splits, cudaStream_t s) {
  auto kernel = mlp_wg_kernel<W, kFc>;
  // the whole carveout as shared memory, so that proj's blocks fit on an
  // SM beside two of fc's and start while fc runs
  static const cudaError_t configured = [&] {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes<W, kFc>(max_slice<kFc>() / kChunk));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
  }();
  if (configured != cudaSuccess) return configured;
  const int nch = (a.kdim / splits + kChunk - 1) / kChunk;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.n + cols<kFc>() - 1) / cols<kFc>(), splits,
                     (a.rows + kRows - 1) / kRows);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes<W, kFc>(nch);
  cfg.stream = s;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, kernel, ta, tw, a);
}

template <typename W>
cudaError_t run(const __nv_bfloat16* x, const float* g, const float* bln,
                const W* wfc, const float* sfc, const float* bfc,
                const W* wpj, const float* spj, const float* bpj,
                __nv_bfloat16* h, __nv_bfloat16* out, int b, int d, int f,
                float eps, int s_fc, int s_pj, cudaStream_t s) {
  CUtensorMap mx, mwfc, mh, mwpj;
  cudaError_t e = map2d<__nv_bfloat16>(&mx, x, d, b);
  if (e == cudaSuccess) e = map2d<W>(&mwfc, wfc, f, d);
  if (e == cudaSuccess) e = map2d<__nv_bfloat16>(&mh, h, f, b);
  if (e == cudaSuccess) e = map2d<W>(&mwpj, wpj, d, f);
  if (e != cudaSuccess) return e;
  const Args fc{sfc, bfc, g, bln, nullptr, h, b, d, f, eps};
  e = product<W, true>(mx, mwfc, fc, s_fc, s);
  if (e != cudaSuccess) return e;
  const Args pj{spj, bpj, nullptr, nullptr, x, out, b, f, d, eps};
  return product<W, false>(mh, mwpj, pj, s_pj, s);
}

}  // namespace

// x [B,D] bf16; LN g,b [D] f32; wfc [D,F], wpj [F,D] (int8 if `int8`, else
// bf16); sfc,bfc [F], spj,bpj [D] f32; h [B,F] bf16 scratch; out [B,D]
// bf16; all 16-byte aligned. s_fc and s_pj split the D- and F-long
// contractions. Takes D and F multiples of 32, D <= 1024, splits as
// `mlp_plan` gives them (at most 8, slices of a multiple of 16, at most 384
// in fc and 512 in proj); returns cudaErrorInvalidValue otherwise.
extern "C" int ecap_decode_mlp(const void* x, const void* g, const void* bln,
                               const void* wfc, const void* sfc,
                               const void* bfc, const void* wpj,
                               const void* spj, const void* bpj, void* h,
                               void* out, int b, int d, int f, float eps,
                               int int8, int s_fc, int s_pj, void* stream) {
  if (b < 1 || d % 32 || f % 32 || d > kMaxD ||
      !valid_split(d, s_fc, max_slice<true>()) ||
      !valid_split(f, s_pj, max_slice<false>()))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* gf = static_cast<const float*>(g);
  const auto* bl = static_cast<const float*>(bln);
  const auto* s1 = static_cast<const float*>(sfc);
  const auto* b1 = static_cast<const float*>(bfc);
  const auto* s2 = static_cast<const float*>(spj);
  const auto* b2 = static_cast<const float*>(bpj);
  auto* hb = static_cast<__nv_bfloat16*>(h);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if (int8)
    return run(xb, gf, bl, static_cast<const int8_t*>(wfc), s1, b1,
               static_cast<const int8_t*>(wpj), s2, b2, hb, ob, b, d, f, eps,
               s_fc, s_pj, s);
  return run(xb, gf, bl, static_cast<const __nv_bfloat16*>(wfc), s1, b1,
             static_cast<const __nv_bfloat16*>(wpj), s2, b2, hb, ob, b, d, f,
             eps, s_fc, s_pj, s);
}
