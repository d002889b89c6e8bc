// Row LayerNorm over the last axis with float32 statistics.
//
// Replaces: embodied_captioning_tpu/ops/pallas/layernorm.py
//   layernorm_2d and layernorm_3d (_ln_kernel). A contiguous [B, T, D]
//   tensor is [B*T, D] without a copy here, so one kernel serves both.
//
// Two statistics modes:
//   two-pass            var = mean((x - m)^2): the TPU kernel, and the JAX
//                       package's default path for float32 input;
//   one-pass with floor var = max(E[x^2] - m^2, m^2 * 3e-7): the JAX
//                       package's default path for bf16 input.
//
// Bound on an H100 SXM (3.35 TB/s): memory. Each row is read once and
// written once, with ~8 operations per element in between.
//
// Design (vector path): one warp per row. Each lane loads its share of the
// row as 16-byte vectors (8 bf16 or 4 f32), all issued before any
// arithmetic, and keeps them in registers for the statistics (one-pass or
// two-pass) and the normalisation, so device memory is read once and
// written once, with 16-byte stores. The row width in vectors per lane is
// a template argument (rows of up to 1024 elements: 4 vectors per lane of
// bf16, 8 of f32). Warps walk the rows with a grid stride, the grid sized
// to what the SMs hold at once; each warp loads g and b once and keeps
// them in registers (at most 32 floats each per lane), and loads its next
// row while it normalises the current one. At few rows a block is one or
// two warps, so the rows spread over the SMs. Rows whose byte length is
// not a multiple of 16, pointers that are not 16-byte aligned, and wider
// rows take the scalar path: one warp per row, eight rows per block, lanes
// walking the row with stride 32.
// Both paths take f32 statistics in a fixed order (no atomics: two runs
// give the same bits) and round the normalisation after every operation
// (no fused multiply-add), as the plain version does.
#include <cooperative_groups.h>

#include "common.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kScalarWarps = 8;
constexpr int kMaxRow = 1024;  // elements of the widest vector-path row
constexpr int kVecThreads = 256;  // the most warps a vector block holds

__device__ __forceinline__ float load(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float normalise(float v, float mean, float r,
                                           float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mean), r), g), b);
}

__device__ __forceinline__ float variance_one_pass(float s2, float mean,
                                                   float inv_d) {
  const float mm = __fmul_rn(mean, mean);
  return fmaxf(__fsub_rn(s2 * inv_d, mm), __fmul_rn(mm, 3e-7f));
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kScalarWarps * 32)
layernorm_kernel(const Tin* __restrict__ x, const float* __restrict__ g,
                 const float* __restrict__ b, Tout* __restrict__ out, int rows,
                 int d, float eps, int two_pass) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kScalarWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const size_t base = static_cast<size_t>(row) * d;
  const float inv_d = 1.f / static_cast<float>(d);
  float s1 = 0.f, s2 = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float v = load(x, base + i);
    s1 += v;
    s2 += v * v;
  }
  const float mean = ecap::warp_sum(s1) * inv_d;
  float var;
  if (two_pass) {
    float sq = 0.f;
    for (int i = lane; i < d; i += 32) {
      const float c = load(x, base + i) - mean;
      sq += c * c;
    }
    var = ecap::warp_sum(sq) * inv_d;
  } else {
    var = variance_one_pass(ecap::warp_sum(s2), mean, inv_d);
  }
  const float r = rsqrtf(var + eps);
  for (int i = lane; i < d; i += 32)
    store(out, base + i, normalise(load(x, base + i), mean, r, g[i], b[i]));
}

// ---- the vector path ------------------------------------------------------

// Elements of one 16-byte vector of T.
template <typename T>
__host__ __device__ constexpr int elems() {
  return 16 / static_cast<int>(sizeof(T));
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

// Store n = 4 or 8 floats at p as Tout: 16 bytes (8 bf16, 4 f32), 8 bytes
// (4 bf16) or 32 (8 f32).
template <int N>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* y) {
  uint32_t w[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  if constexpr (N == 8)
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  else
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}
template <int N>
__device__ __forceinline__ void store_vec(float* p, const float* y) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
    reinterpret_cast<float4*>(p)[i] =
        make_float4(y[4 * i], y[4 * i + 1], y[4 * i + 2], y[4 * i + 3]);
}

template <int N>
__device__ __forceinline__ void load_floats(const float* p, float* f) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 t = reinterpret_cast<const float4*>(p)[i];
    f[4 * i] = t.x;
    f[4 * i + 1] = t.y;
    f[4 * i + 2] = t.z;
    f[4 * i + 3] = t.w;
  }
}

// Row r's vectors l, l + 32, ... (those below nvec) into u.
template <int V, typename T>
__device__ __forceinline__ void load_row(uint4 (&u)[V], const T* x, int r,
                                         int d, int lane, int nvec) {
  const uint4* src = reinterpret_cast<const uint4*>(
      x + static_cast<size_t>(r) * d);
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (lane + 32 * i < nvec) u[i] = src[lane + 32 * i];
}

// V vectors per lane: lane l holds vectors l, l + 32, ..., of the row's
// d / E (those below it), and the g and b they meet.
template <typename Tin, typename Tout, int V>
__global__ void __launch_bounds__(kVecThreads)
layernorm_vec_kernel(const Tin* __restrict__ x, const float* __restrict__ g,
                     const float* __restrict__ b, Tout* __restrict__ out,
                     int rows, int d, float eps, int two_pass) {
  constexpr int E = elems<Tin>();
  const int lane = threadIdx.x & 31;
  const int nvec = d / E;
  const int warps = gridDim.x * (blockDim.x >> 5);
  int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const float inv_d = 1.f / static_cast<float>(d);

  float gr[V][E], br[V][E];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
      load_floats<E>(g + c * E, gr[i]);
      load_floats<E>(b + c * E, br[i]);
    }
  }

  uint4 cur[V];
  load_row(cur, x, row, d, lane, nvec);
  while (row < rows) {
    const int next = row + warps;
    uint4 nxt[V];
    if (next < rows) load_row(nxt, x, next, d, lane, nvec);

    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (lane + 32 * i < nvec) {
        float f[E];
        unpack(cur[i], f);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          s1 += f[e];
          s2 += f[e] * f[e];
        }
      }
    }
    const float mean = ecap::warp_sum(s1) * inv_d;
    float var;
    if (two_pass) {
      float sq = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if (lane + 32 * i < nvec) {
          float f[E];
          unpack(cur[i], f);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const float c = f[e] - mean;
            sq += c * c;
          }
        }
      }
      var = ecap::warp_sum(sq) * inv_d;
    } else {
      var = variance_one_pass(ecap::warp_sum(s2), mean, inv_d);
    }
    const float r = rsqrtf(var + eps);

    Tout* dst = out + static_cast<size_t>(row) * d;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = lane + 32 * i;
      if (c < nvec) {
        float f[E], y[E];
        unpack(cur[i], f);
#pragma unroll
        for (int e = 0; e < E; ++e)
          y[e] = normalise(f[e], mean, r, gr[i][e], br[i][e]);
        store_vec<E>(dst + c * E, y);
      }
    }
    row = next;
    if (row < rows) {
#pragma unroll
      for (int i = 0; i < V; ++i) cur[i] = nxt[i];
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

template <typename Tin, typename Tout, int V>
int launch_vec(const Tin* x, const float* g, const float* b, Tout* out,
               int rows, int d, float eps, int two_pass, cudaStream_t stream) {
  auto kernel = layernorm_vec_kernel<Tin, Tout, V>;
  const int sms = sm_count();
  // a warp per block below 2 rows per SM, two below 8, else eight
  const int warps = rows >= 8 * sms ? 8 : (rows >= 2 * sms ? 2 : 1);
  static int resident[9] = {};  // blocks an SM holds, by warps per block
  if (resident[warps] == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident[warps], kernel,
                                                  warps * 32, 0);
    if (resident[warps] < 1) resident[warps] = 1;
  }
  const int wanted = (rows + warps - 1) / warps;
  const int blocks = wanted < sms * resident[warps] ? wanted
                                                    : sms * resident[warps];
  kernel<<<blocks, warps * 32, 0, stream>>>(x, g, b, out, rows, d, eps,
                                            two_pass);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename Tin, typename Tout>
int launch(const void* xv, const void* gv, const void* bv, void* outv,
           int rows, int d, float eps, int two_pass, cudaStream_t stream) {
  const Tin* x = static_cast<const Tin*>(xv);
  const float* g = static_cast<const float*>(gv);
  const float* b = static_cast<const float*>(bv);
  Tout* out = static_cast<Tout*>(outv);
  constexpr int E = elems<Tin>();
  const int v = (d / E + 31) / 32;
  if (d % E == 0 && d <= kMaxRow && aligned16(x) && aligned16(g) &&
      aligned16(b) && aligned16(out)) {
#define ECAP_LN_VEC(V)                                                     \
  case V:                                                                  \
    if constexpr (V * E * 32 <= kMaxRow)                                   \
      return launch_vec<Tin, Tout, V>(x, g, b, out, rows, d, eps, two_pass, \
                                      stream);                             \
    break;
    switch (v) {
      ECAP_LN_VEC(1) ECAP_LN_VEC(2) ECAP_LN_VEC(3) ECAP_LN_VEC(4)
      ECAP_LN_VEC(5) ECAP_LN_VEC(6) ECAP_LN_VEC(7) ECAP_LN_VEC(8)
      default: break;
    }
#undef ECAP_LN_VEC
  }
  const int blocks = (rows + kScalarWarps - 1) / kScalarWarps;
  layernorm_kernel<Tin, Tout><<<blocks, kScalarWarps * 32, 0, stream>>>(
      x, g, b, out, rows, d, eps, two_pass);
  return cudaGetLastError();
}

// ---- the backward ----------------------------------------------------------
//
// Replaces: embodied_captioning_tpu/models/common.py _ln_pallas_bwd (the
//   custom VJP of the Pallas LayerNorm; not a pallas_call of its own):
//     dx = inv * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)),
//     dxhat = dy * g, xhat = (x - mean) * inv,
//     dg = sum over rows of dy * xhat, db = sum over rows of dy.
//   The row statistics are recomputed from x in the forward's own mode
//   (one-pass with the floor, or two-pass), so the forward stays as it is.
//
// Bound on an H100 SXM (3.35 TB/s): memory. x and dy are read and dx is
// written once per element, with ~16 operations per element in between;
// g, dg and db are a row each.
//
// The register path (layernorm_bwd_regs; rows of d % 8 == 0, at most 1024
// wide and 192 bytes of x and dy a lane, 16-byte aligned pointers) takes
// the place of the first, simple kernel, which (1) walked each row three times
// from L1/L2, (2) read-modify-wrote dg and db in shared memory for every
// element and (3) cut the rows into up to 256 groups of a few rows, each
// writing a float32 row of partials that a second launch summed. Here:
//   (1) a warp holds its row of x and dy in registers, 8 columns a chunk,
//       lane l the chunks l, l + 32, ...: the statistics (one-pass or
//       two-pass), both means and dx all come from those registers, so
//       each element is read once from memory and dx is written once. A
//       warp takes a contiguous run of rows (the grid's warps split the
//       rows evenly) and keeps the next three rows in flight: 16-byte
//       cp.async copies into its ring of shared-memory stages, each lane
//       copying and later reading only its own chunks (no barrier). g is
//       loaded once per lane for the whole kernel.
//   (2) a lane owns the same columns on every row it takes, so it adds
//       dy * xhat and dy into float32 registers, with no shared memory per
//       element. At the end the block sums its warps in warp order
//       through shared memory, once.
//   (3) the grid is persistent, sized by the wrapper's plan
//       (kernels/layernorm.bwd_plan) from the clusters the SMs hold at once
//       and the row count: few rows take one row a warp in full blocks of
//       8 warps; at most 64 rows take one cluster of up to 16 blocks of 4
//       warps, one an SM (kSpreadSmem), so that their arithmetic spreads
//       over twice the SMs, where the card launches a cluster that wide
//       (ecap_layernorm_bwd_slots asks).
//       Blocks form thread-block clusters: each block pushes slice r of its
//       sums into block r's shared memory (16-byte stores to distributed
//       shared memory), one cluster barrier, and block r sums slice r over
//       the cluster's blocks in rank order. One cluster writes dg and db
//       there (one launch); with more, each writes its slice of a float32
//       partial row, and a second launch (layernorm_bwd_sum, a thread a
//       column) sums them in cluster order. It may start while the first
//       runs (programmatic dependent launch) and waits for that grid's end.
//   No atomics: two runs give the same bits.
// The generic path (layernorm_bwd_rows + layernorm_bwd_cols, the first
// kernel, unchanged) takes other rows: narrow or unaligned ones, rows wider
// than 1024, and float32 x and dy past 768. Its rows are cut into `parts`
// contiguous groups, one block per group, each warp taking every W-th row
// of the group and walking it three times (statistics, the two means,
// dx), adding dy * xhat and dy into its own float32 columns in shared
// memory; the block sums its warps in order into its partial row of dg
// and db, which layernorm_bwd_cols sums over the groups in a fixed order.

template <int N>
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, float (&f)[N]) {
  if constexpr (N == 8) {
    unpack(*reinterpret_cast<const uint4*>(p), f);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = __bfloat162float(p[i]);
  }
}
template <int N>
__device__ __forceinline__ void load_chunk(const float* p, float (&f)[N]) {
  if constexpr (N % 4 == 0) {
    load_floats<N>(p, f);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = p[i];
  }
}
template <int N>
__device__ __forceinline__ void store_chunk(__nv_bfloat16* p, const float (&f)[N]) {
  if constexpr (N == 8) {
    store_vec<8>(p, f);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = __float2bfloat16_rn(f[i]);
  }
}
template <int N>
__device__ __forceinline__ void store_chunk(float* p, const float (&f)[N]) {
  if constexpr (N % 4 == 0) {
    store_vec<N>(p, f);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = f[i];
  }
}

constexpr int kBwdMaxWarps = 8;
constexpr size_t kBwdStaticSmem = 48 * 1024;

template <typename Tx, typename Tdy, int N>
__global__ void __launch_bounds__(kBwdMaxWarps * 32)
layernorm_bwd_rows(const Tx* __restrict__ x, const float* __restrict__ g,
                   const Tdy* __restrict__ dy, Tx* __restrict__ dx,
                   float* __restrict__ dg_part, float* __restrict__ db_part,
                   int rows, int d, int rows_per_part, float eps,
                   int two_pass) {
  extern __shared__ float acc[];  // [W][2][d]: per warp, dg then db
  const int nw = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* my_dg = acc + static_cast<size_t>(warp) * 2 * d;
  float* my_db = my_dg + d;
  for (int i = threadIdx.x; i < nw * 2 * d; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  const int nch = d / N;
  const float inv_d = 1.f / static_cast<float>(d);
  const int r0 = blockIdx.x * rows_per_part;
  const int r1 = min(rows, r0 + rows_per_part);
  for (int row = r0 + warp; row < r1; row += nw) {
    const Tx* xr = x + static_cast<size_t>(row) * d;
    const Tdy* dyr = dy + static_cast<size_t>(row) * d;
    Tx* dxr = dx + static_cast<size_t>(row) * d;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < nch; c += 32) {
      float f[N];
      load_chunk<N>(xr + c * N, f);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        s1 += f[e];
        s2 += f[e] * f[e];
      }
    }
    const float mean = ecap::warp_sum(s1) * inv_d;
    float var;
    if (two_pass) {
      float sq = 0.f;
      for (int c = lane; c < nch; c += 32) {
        float f[N];
        load_chunk<N>(xr + c * N, f);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float t = f[e] - mean;
          sq += t * t;
        }
      }
      var = ecap::warp_sum(sq) * inv_d;
    } else {
      var = variance_one_pass(ecap::warp_sum(s2), mean, inv_d);
    }
    const float inv = rsqrtf(var + eps);

    float a1 = 0.f, a2 = 0.f;
    for (int c = lane; c < nch; c += 32) {
      float f[N], dd[N], gg[N];
      load_chunk<N>(xr + c * N, f);
      load_chunk<N>(dyr + c * N, dd);
      load_chunk<N>(g + c * N, gg);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float xhat = (f[e] - mean) * inv;
        const float dxh = dd[e] * gg[e];
        a1 += dxh;
        a2 += dxh * xhat;
      }
    }
    const float m1 = ecap::warp_sum(a1) * inv_d;
    const float m2 = ecap::warp_sum(a2) * inv_d;

    for (int c = lane; c < nch; c += 32) {
      float f[N], dd[N], gg[N], out[N];
      load_chunk<N>(xr + c * N, f);
      load_chunk<N>(dyr + c * N, dd);
      load_chunk<N>(g + c * N, gg);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float xhat = (f[e] - mean) * inv;
        out[e] = inv * (dd[e] * gg[e] - m1 - xhat * m2);
        my_dg[c * N + e] += dd[e] * xhat;
        my_db[c * N + e] += dd[e];
      }
      store_chunk<N>(dxr + c * N, out);
    }
  }
  __syncthreads();
  float* pg = dg_part + static_cast<size_t>(blockIdx.x) * d;
  float* pb = db_part + static_cast<size_t>(blockIdx.x) * d;
  for (int col = threadIdx.x; col < d; col += blockDim.x) {
    float sg = 0.f, sb = 0.f;
    for (int w = 0; w < nw; ++w) {
      sg += acc[static_cast<size_t>(w) * 2 * d + col];
      sb += acc[static_cast<size_t>(w) * 2 * d + d + col];
    }
    pg[col] = sg;
    pb[col] = sb;
  }
}

constexpr int kColTile = 32, kColGroups = 8;

__global__ void __launch_bounds__(kColTile * kColGroups)
layernorm_bwd_cols(const float* __restrict__ dg_part,
                   const float* __restrict__ db_part, float* __restrict__ dg,
                   float* __restrict__ db, int parts, int d) {
  __shared__ float sg[kColGroups][kColTile + 1], sb[kColGroups][kColTile + 1];
  const int col = blockIdx.x * kColTile + threadIdx.x;
  float a = 0.f, b = 0.f;
  if (col < d) {
    for (int p = threadIdx.y; p < parts; p += kColGroups) {
      a += dg_part[static_cast<size_t>(p) * d + col];
      b += db_part[static_cast<size_t>(p) * d + col];
    }
  }
  sg[threadIdx.y][threadIdx.x] = a;
  sb[threadIdx.y][threadIdx.x] = b;
  __syncthreads();
  if (threadIdx.y == 0 && col < d) {
    float ta = 0.f, tb = 0.f;
    for (int i = 0; i < kColGroups; ++i) {
      ta += sg[i][threadIdx.x];
      tb += sb[i][threadIdx.x];
    }
    dg[col] = ta;
    db[col] = tb;
  }
}

template <typename Tx, typename Tdy, int N>
int launch_bwd(const void* x, const void* g, const void* dy, void* dx,
               float* dg, float* db, float* part, int rows, int d, int parts,
               float eps, int two_pass, cudaStream_t stream) {
  auto kernel = layernorm_bwd_rows<Tx, Tdy, N>;
  // as many warps as fit 48 KB of accumulators, 1 to 8; past that (rows
  // over 6144 wide) one warp with the dynamic shared memory raised
  int warps = static_cast<int>(kBwdStaticSmem / (8 * static_cast<size_t>(d)));
  warps = warps < 1 ? 1 : (warps > kBwdMaxWarps ? kBwdMaxWarps : warps);
  const size_t smem = static_cast<size_t>(warps) * 2 * d * sizeof(float);
  if (smem > ecap::kMaxSmem) return cudaErrorInvalidValue;
  if (smem > kBwdStaticSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int rows_per_part = (rows + parts - 1) / parts;
  float* dg_part = part;
  float* db_part = part + static_cast<size_t>(parts) * d;
  kernel<<<parts, warps * 32, smem, stream>>>(
      static_cast<const Tx*>(x), static_cast<const float*>(g),
      static_cast<const Tdy*>(dy), static_cast<Tx*>(dx), dg_part, db_part,
      rows, d, rows_per_part, eps, two_pass);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  layernorm_bwd_cols<<<(d + kColTile - 1) / kColTile,
                       dim3(kColTile, kColGroups), 0, stream>>>(
      dg_part, db_part, dg, db, parts, d);
  return cudaGetLastError();
}

// ---- the backward's register path ----------------------------------------

constexpr int kRegWarps = 8;  // the most warps of a register-path block
constexpr int kFewWarps = 4;  // warps of a few-row block (BWD_FEW_WARPS)
// shared memory that leaves room for one block an SM: a grid of a few
// 4-warp blocks asks for it, so that its blocks spread over the SMs
constexpr size_t kSpreadSmem = 117 * 1024;
// bytes of x and dy a lane may hold for one row (V chunks of 8 columns)
constexpr int kRegRowBytes = 192;
// rows of x and dy a warp has in flight: its ring of shared-memory stages
constexpr int kStages = 4;

template <typename Tx, typename Tdy>
__host__ __device__ constexpr int max_chunks() {
  return kRegRowBytes / (8 * static_cast<int>(sizeof(Tx) + sizeof(Tdy)));
}

// 8 consecutive elements of a row: one 16-byte vector of bf16, two of f32
template <typename T>
struct Chunk;
template <>
struct Chunk<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void get(float (&f)[8]) const { unpack(u, f); }
  __device__ __forceinline__ void zero() { u = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ void set(const float (&f)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    u = make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ __forceinline__ void store(__nv_bfloat16* p) const {
    *reinterpret_cast<uint4*>(p) = u;
  }
};
template <>
struct Chunk<float> {
  uint4 u[2];
  __device__ __forceinline__ void load(const float* p) {
    u[0] = reinterpret_cast<const uint4*>(p)[0];
    u[1] = reinterpret_cast<const uint4*>(p)[1];
  }
  __device__ __forceinline__ void get(float (&f)[8]) const {
    f[0] = __uint_as_float(u[0].x);
    f[1] = __uint_as_float(u[0].y);
    f[2] = __uint_as_float(u[0].z);
    f[3] = __uint_as_float(u[0].w);
    f[4] = __uint_as_float(u[1].x);
    f[5] = __uint_as_float(u[1].y);
    f[6] = __uint_as_float(u[1].z);
    f[7] = __uint_as_float(u[1].w);
  }
  __device__ __forceinline__ void zero() {
    u[0] = make_uint4(0, 0, 0, 0);
    u[1] = u[0];
  }
  __device__ __forceinline__ void set(const float (&f)[8]) {
    u[0] = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
    u[1] = make_uint4(__float_as_uint(f[4]), __float_as_uint(f[5]),
                      __float_as_uint(f[6]), __float_as_uint(f[7]));
  }
  __device__ __forceinline__ void store(float* p) const {
    reinterpret_cast<uint4*>(p)[0] = u[0];
    reinterpret_cast<uint4*>(p)[1] = u[1];
  }
};

// One chunk from device memory into shared memory: 16-byte cp.async copies.
template <typename T>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src) {
#pragma unroll
  for (int k = 0; k < static_cast<int>(sizeof(T)) / 2; ++k)
    ecap::cp_async16(reinterpret_cast<char*>(dst) + 16 * k,
                     reinterpret_cast<const char*>(src) + 16 * k, true);
}

// The cluster barrier in two halves (barrier.cluster): arrive early, wait
// where the other blocks' shared memory is first needed.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Column sums of n rows of values, in row order, for the columns lo + t,
// lo + t + blockDim.x, ... below hi (t this thread), two columns at a time:
// all of a batch's loads are issued before its adds. load(k, col) is row
// k's value; store(col, sum).
template <int kBatch, typename Load, typename Store>
__device__ __forceinline__ void ordered_column_sums(int lo, int hi, int n,
                                                    Load load, Store store) {
  for (int c0 = lo + threadIdx.x; c0 < hi; c0 += 2 * blockDim.x) {
    const int c1 = c0 + blockDim.x;
    float s0 = 0.f, s1 = 0.f;
    for (int k0 = 0; k0 < n; k0 += kBatch) {
      float v0[kBatch], v1[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        v0[j] = k0 + j < n ? load(k0 + j, c0) : 0.f;
        v1[j] = k0 + j < n && c1 < hi ? load(k0 + j, c1) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        s0 += v0[j];
        s1 += v1[j];
      }
    }
    store(c0, s0);
    if (c1 < hi) store(c1, s1);
  }
}

// a and b summed over the warp, their shuffles interleaved
__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

// a cluster rank's slice of the 2 d columns of dg then db, a multiple of 4
__host__ __device__ constexpr int slice_cols(int d, int nc) {
  return (2 * d + 4 * nc - 1) / (4 * nc) * 4;
}
// the register path's shared memory: each warp's ring, then `recv`, a
// slice row from every block of the cluster
template <typename Tx, typename Tdy>
__host__ __device__ constexpr size_t ring_bytes(int d, int warps) {
  return warps * kStages * static_cast<size_t>(d) *
         (sizeof(Tx) + sizeof(Tdy));
}
template <typename Tx, typename Tdy>
constexpr size_t regs_smem(int d, int warps) {
  // nc slices of slice_cols(d, nc) <= 2 d / nc + 4 columns
  const size_t need = ring_bytes<Tx, Tdy>(d, warps) +
                      (2 * static_cast<size_t>(d) + 32) * sizeof(float);
  return warps < kRegWarps && need < kSpreadSmem ? kSpreadSmem : need;
}

template <typename Tx, typename Tdy, int V>
__global__ void __launch_bounds__(kRegWarps * 32, 1)
layernorm_bwd_regs(const Tx* __restrict__ x, const float* __restrict__ g,
                   const Tdy* __restrict__ dy, Tx* __restrict__ dx,
                   float* __restrict__ dg, float* __restrict__ db,
                   float* __restrict__ part, int rows, int d, float eps,
                   int two_pass) {
  constexpr int S = kStages;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();  // waited for before the first push
  // the launch that sums the clusters' partials may start now: it waits
  // for this grid's end before it reads them
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nch = d >> 3;
  const float inv_d = 1.f / static_cast<float>(d);
  const size_t row_bytes = static_cast<size_t>(d) * (sizeof(Tx) + sizeof(Tdy));
  char* ring = reinterpret_cast<char*>(smem) + warp * S * row_bytes;

  // the grid's warps split the rows into contiguous runs, evenly (in 32
  // bits where the products fit)
  const int nw = blockDim.x >> 5;
  const unsigned warps = gridDim.x * nw;
  const unsigned gw = blockIdx.x * nw + warp;
  int first, n;
  if (static_cast<unsigned long long>(rows) * warps < (1ull << 32)) {
    first = static_cast<int>(gw * rows / warps);
    n = static_cast<int>((gw + 1) * rows / warps) - first;
  } else {
    first = static_cast<int>(static_cast<unsigned long long>(gw) * rows /
                             warps);
    n = static_cast<int>(static_cast<unsigned long long>(gw + 1) * rows /
                         warps) - first;
  }
  // row first + k into stage k % S, one commit group a row (empty past the
  // warp's rows, so that the groups count rows)
  auto issue = [&](int k) {
    if (k < n) {
      Tx* sx = reinterpret_cast<Tx*>(ring + (k % S) * row_bytes);
      Tdy* sdy = reinterpret_cast<Tdy*>(sx + d);
      const size_t base = static_cast<size_t>(first + k) * d;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int c = lane + 32 * i;
        if (c < nch) {
          copy_chunk(sx + 8 * c, x + base + 8 * c);
          copy_chunk(sdy + 8 * c, dy + base + 8 * c);
        }
      }
    }
    ecap::cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < S - 1; ++k) issue(k);

  // a lane's chunks past the row's end hold zeros: they add nothing to
  // the sums, and nothing of them is stored
  float gr[V][8], sg[V][8], sb[V][8];
#pragma unroll
  for (int i = 0; i < V; ++i) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      gr[i][e] = 0.f;
      sg[i][e] = 0.f;
      sb[i][e] = 0.f;
    }
    if (lane + 32 * i < nch) load_floats<8>(g + 8 * (lane + 32 * i), gr[i]);
  }

  // dx of the row; the last row's is stored past the cluster barrier,
  // which would wait for the stores before it
  Chunk<Tx> out[V];
  for (int k = 0; k < n; ++k) {
    // the stage this issue fills was read on the row before
    issue(k + S - 1);
    ecap::cp_async_wait<S - 1>();  // row k's copies (this lane's own)
    const Tx* sx = reinterpret_cast<const Tx*>(ring + (k % S) * row_bytes);
    const Tdy* sdy = reinterpret_cast<const Tdy*>(sx + d);
    float xf[V][8];
    Chunk<Tdy> dc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = lane + 32 * i;
      if (c < nch) {
        Chunk<Tx> xc;
        xc.load(sx + 8 * c);
        xc.get(xf[i]);
        dc[i].load(sdy + 8 * c);
      } else {
        dc[i].zero();
#pragma unroll
        for (int e = 0; e < 8; ++e) xf[i][e] = 0.f;
      }
    }

    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s1 += xf[i][e];
        s2 += xf[i][e] * xf[i][e];
      }
    }
    float mean, var;
    if (two_pass) {
      mean = ecap::warp_sum(s1) * inv_d;
      float sq = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const bool live = lane + 32 * i < nch;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float t = live ? xf[i][e] - mean : 0.f;
          sq += t * t;
        }
      }
      var = ecap::warp_sum(sq) * inv_d;
    } else {
      warp_sum2(s1, s2);
      mean = s1 * inv_d;
      var = variance_one_pass(s2, mean, inv_d);
    }
    const float inv = rsqrtf(var + eps);

    float a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float dd[8];
      dc[i].get(dd);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float xhat = (xf[i][e] - mean) * inv;
        const float dxh = dd[e] * gr[i][e];
        a1 += dxh;
        a2 += dxh * xhat;
        sg[i][e] += dd[e] * xhat;
        sb[i][e] += dd[e];
        xf[i][e] = xhat;  // for dx below
      }
    }
    warp_sum2(a1, a2);
    // dx = inv dxhat - inv m1 - inv m2 xhat, two fused multiply-adds
    const float c1 = -(a1 * inv_d) * inv, c2 = -(a2 * inv_d) * inv;

    Tx* dxr = dx + static_cast<size_t>(first + k) * d;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float dd[8], o[8];
      dc[i].get(dd);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        o[e] = fmaf(dd[e] * gr[i][e], inv, fmaf(xf[i][e], c2, c1));
      out[i].set(o);
      const int c = lane + 32 * i;
      if (k + 1 < n && c < nch) out[i].store(dxr + 8 * c);
    }
  }
  ecap::cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring

  // the block's dg and db: its warps' sums, added in warp order, four
  // columns at a time, each four pushed (16 bytes) to the block of the
  // cluster that owns their slice (slice_cols a rank), into that block's
  // row `rank` of `recv` (past the rings, so that no push meets a ring in
  // use)
  float* red = smem;
  float* mine = red + static_cast<size_t>(warp) * 2 * d;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = lane + 32 * i;
    if (c < nch) {
      store_vec<8>(mine + 8 * c, sg[i]);
      store_vec<8>(mine + d + 8 * c, sb[i]);
    }
  }
  const int nc = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int per = slice_cols(d, nc);
  float* recv = smem + ring_bytes<Tx, Tdy>(d, nw) / sizeof(float);
  __syncthreads();
  cluster_wait();  // every block of the cluster has started
  for (int c4 = threadIdx.x; c4 < d / 2; c4 += blockDim.x) {
    float4 v[kRegWarps];
#pragma unroll
    for (int w = 0; w < kRegWarps; ++w)
      v[w] = w < nw ? reinterpret_cast<const float4*>(
                          red + static_cast<size_t>(w) * 2 * d)[c4]
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kRegWarps; ++w) {
      t.x += v[w].x;
      t.y += v[w].y;
      t.z += v[w].z;
      t.w += v[w].w;
    }
    const int col = 4 * c4, q = col / per;
    *reinterpret_cast<float4*>(cluster.map_shared_rank(recv, q) + rank * per +
                               col - q * per) = t;
  }
  cluster.sync();  // every push has landed
  // the last row's dx, past the barrier that would have waited for it
  if (n > 0) {
    Tx* dxr = dx + static_cast<size_t>(first + n - 1) * d;
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (lane + 32 * i < nch) out[i].store(dxr + 8 * (lane + 32 * i));
  }

  // slice `rank` of the cluster's sum, over its blocks in rank order (the
  // blocks of a cluster are consecutive in blockIdx.x)
  const int clusters = gridDim.x / nc, ci = blockIdx.x / nc;
  const int lo = rank * per, hi = min(2 * d, lo + per);
  auto write = [&](int col, float s) {
    if (col < d)
      dg[col] = s;
    else
      db[col - d] = s;
  };
  ordered_column_sums<8>(
      lo, hi, nc, [&](int q, int col) { return recv[q * per + col - lo]; },
      [&](int col, float s) {
        if (clusters > 1)
          part[static_cast<size_t>(ci) * 2 * d + col] = s;
        else
          write(col, s);
      });
}

// The second launch of a call with more than one cluster: each column of
// dg and db summed over the clusters' partial rows in cluster order. It
// may start while the first runs (programmatic dependent launch) and waits
// for that grid's end and its stores before it reads them.
__global__ void __launch_bounds__(256)
layernorm_bwd_sum(const float* __restrict__ part, float* __restrict__ dg,
                  float* __restrict__ db, int parts, int d) {
  ecap::grid_dependency_wait();
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= 2 * d) return;
  constexpr int kBatch = 32;  // loads in flight before their adds
  float s = 0.f;
  for (int k0 = 0; k0 < parts; k0 += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      v[j] = k0 + j < parts ? part[static_cast<size_t>(k0 + j) * 2 * d + col]
                            : 0.f;
#pragma unroll
    for (int j = 0; j < kBatch; ++j) s += v[j];
  }
  if (col < d)
    dg[col] = s;
  else
    db[col - d] = s;
}

template <typename Tx, typename Tdy, int V>
cudaError_t prepare_regs() {
  static cudaError_t done = [] {
    auto kernel = layernorm_bwd_regs<Tx, Tdy, V>;
    const size_t most = regs_smem<Tx, Tdy>(V * 256, kRegWarps);
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(most > kSpreadSmem ? most : kSpreadSmem));
    if (e != cudaSuccess) return e;
    // one cluster of up to 16 blocks for a few rows
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  return done;
}

cudaLaunchConfig_t regs_config(int blocks, int cluster, int warps,
                               size_t smem, cudaStream_t stream,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(warps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename Tx, typename Tdy, int V>
int launch_bwd_regs(const void* x, const void* g, const void* dy, void* dx,
                    float* dg, float* db, float* scratch, int rows, int d,
                    int blocks, int cluster, int warps, float eps,
                    int two_pass, cudaStream_t stream) {
  cudaError_t e = prepare_regs<Tx, Tdy, V>();
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      regs_config(blocks, cluster, warps, regs_smem<Tx, Tdy>(d, warps),
                  stream, &attr);
  e = cudaLaunchKernelEx(
      &cfg, layernorm_bwd_regs<Tx, Tdy, V>, static_cast<const Tx*>(x),
      static_cast<const float*>(g), static_cast<const Tdy*>(dy),
      static_cast<Tx*>(dx), dg, db, scratch, rows, d, eps, two_pass);
  if (e != cudaSuccess || blocks == cluster) return e;
  cudaLaunchConfig_t sum = {};
  sum.gridDim = dim3((2 * d + 255) / 256);
  sum.blockDim = dim3(256);
  sum.stream = stream;
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  sum.attrs = &pdl;
  sum.numAttrs = 1;
  return cudaLaunchKernelEx(&sum, layernorm_bwd_sum,
                            static_cast<const float*>(scratch), dg, db,
                            blocks / cluster, d);
}

template <typename Tx, typename Tdy>
int dispatch_regs(const void* x, const void* g, const void* dy, void* dx,
                  float* dg, float* db, float* scratch, int rows, int d,
                  int vectors, int blocks, int cluster, int warps, float eps,
                  int two_pass, cudaStream_t stream) {
  // the plan's chunks a lane holds must be this row's, within the
  // instances built; the grid whole clusters, of at most 16 blocks (more
  // than 8 only of 4 warps)
  if (d % 8 || d > kMaxRow || vectors != (d / 8 + 31) / 32 ||
      vectors > max_chunks<Tx, Tdy>() || !aligned16(x) || !aligned16(g) ||
      !aligned16(dy) || !aligned16(dx) || cluster < 1 || cluster > 16 ||
      (cluster > 8 && warps != kFewWarps) || blocks < cluster ||
      blocks % cluster || warps < 1 || warps > kRegWarps)
    return cudaErrorInvalidValue;
#define ECAP_LN_BWD_REGS(V)                                               \
  case V:                                                                 \
    if constexpr (V <= max_chunks<Tx, Tdy>())                             \
      return launch_bwd_regs<Tx, Tdy, V>(x, g, dy, dx, dg, db, scratch,   \
                                         rows, d, blocks, cluster, warps, \
                                         eps, two_pass, stream);          \
    break;
  switch (vectors) {
    ECAP_LN_BWD_REGS(1) ECAP_LN_BWD_REGS(2) ECAP_LN_BWD_REGS(3)
    ECAP_LN_BWD_REGS(4)
    default: break;
  }
#undef ECAP_LN_BWD_REGS
  return cudaErrorInvalidValue;
}

template <typename Tx, typename Tdy>
int dispatch_bwd(const void* x, const void* g, const void* dy, void* dx,
                 float* dg, float* db, float* part, int rows, int d,
                 int parts, float eps, int two_pass, cudaStream_t stream) {
  if (d % 8 == 0 && aligned16(x) && aligned16(g) && aligned16(dy) &&
      aligned16(dx))
    return launch_bwd<Tx, Tdy, 8>(x, g, dy, dx, dg, db, part, rows, d, parts,
                                  eps, two_pass, stream);
  return launch_bwd<Tx, Tdy, 1>(x, g, dy, dx, dg, db, part, rows, d, parts,
                                eps, two_pass, stream);
}

}  // namespace

// x [rows, d] bf16 or f32; g, b [d] f32; out [rows, d] bf16 or f32.
extern "C" int ecap_layernorm(const void* x, const void* g, const void* b,
                              void* out, int rows, int d, float eps,
                              int two_pass, int in_bf16, int out_bf16,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0) return 0;
  if (in_bf16 && out_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, g, b, out, rows, d, eps,
                                                two_pass, s);
  if (in_bf16)
    return launch<__nv_bfloat16, float>(x, g, b, out, rows, d, eps, two_pass, s);
  if (out_bf16)
    return launch<float, __nv_bfloat16>(x, g, b, out, rows, d, eps, two_pass, s);
  return launch<float, float>(x, g, b, out, rows, d, eps, two_pass, s);
}

// The LayerNorm backward. x, dx [rows, d] bf16 or f32 (x's type); dy
// [rows, d] bf16 or f32 (the forward output's type); g [d] f32; dg, db [d]
// f32; scratch: float32 partials. The plan (kernels/layernorm.bwd_plan):
// vectors > 0 takes the register path with that many chunks of 8 columns
// a lane, `blocks` blocks of `warps` warps in clusters of `cluster` (the
// warps split the rows evenly into contiguous runs) and, past one cluster, a
// second launch over blocks / cluster x 2 x d floats of partials; vectors
// == 0 the generic path with `blocks` row groups (1..rows) and 2 x blocks
// x d floats of partials. Returns cudaErrorInvalidValue for a plan the
// rows do not take.
extern "C" int ecap_layernorm_bwd(const void* x, const void* g, const void* dy,
                                  void* dx, void* dg, void* db, void* scratch,
                                  int rows, int d, float eps, int two_pass,
                                  int x_bf16, int dy_bf16, int vectors,
                                  int blocks, int cluster, int warps,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0) return cudaErrorInvalidValue;
  float* fg = static_cast<float*>(dg);
  float* fb = static_cast<float*>(db);
  float* fs = static_cast<float*>(scratch);
  if (vectors > 0) {
    if (x_bf16 && dy_bf16)
      return dispatch_regs<__nv_bfloat16, __nv_bfloat16>(
          x, g, dy, dx, fg, fb, fs, rows, d, vectors, blocks, cluster, warps,
          eps, two_pass, s);
    if (x_bf16)
      return dispatch_regs<__nv_bfloat16, float>(
          x, g, dy, dx, fg, fb, fs, rows, d, vectors, blocks, cluster, warps,
          eps, two_pass, s);
    if (dy_bf16)
      return dispatch_regs<float, __nv_bfloat16>(
          x, g, dy, dx, fg, fb, fs, rows, d, vectors, blocks, cluster, warps,
          eps, two_pass, s);
    return dispatch_regs<float, float>(x, g, dy, dx, fg, fb, fs, rows, d,
                                       vectors, blocks, cluster, warps, eps,
                                       two_pass, s);
  }
  const int parts = blocks;
  if (parts < 1 || parts > rows) return cudaErrorInvalidValue;
  float* fp = fs;
  if (x_bf16 && dy_bf16)
    return dispatch_bwd<__nv_bfloat16, __nv_bfloat16>(
        x, g, dy, dx, fg, fb, fp, rows, d, parts, eps, two_pass, s);
  if (x_bf16)
    return dispatch_bwd<__nv_bfloat16, float>(x, g, dy, dx, fg, fb, fp, rows,
                                              d, parts, eps, two_pass, s);
  if (dy_bf16)
    return dispatch_bwd<float, __nv_bfloat16>(x, g, dy, dx, fg, fb, fp, rows,
                                              d, parts, eps, two_pass, s);
  return dispatch_bwd<float, float>(x, g, dy, dx, fg, fb, fp, rows, d, parts,
                                    eps, two_pass, s);
}

// How many clusters of `cluster` register-path blocks the current device
// holds at once (its widest instance, one block an SM), into *slots; the
// most blocks of kFewWarps warps (kSpreadSmem each, one an SM) it launches
// as one cluster, 16 at most, into *widest (fewer on a card or partition
// with fewer free SMs to a GPC).
extern "C" int ecap_layernorm_bwd_slots(int cluster, int* slots, int* widest,
                                        void* stream) {
  auto kernel = layernorm_bwd_regs<__nv_bfloat16, __nv_bfloat16, 4>;
  cudaError_t e = prepare_regs<__nv_bfloat16, __nv_bfloat16, 4>();
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = regs_config(
      cluster, cluster, kRegWarps,
      regs_smem<__nv_bfloat16, __nv_bfloat16>(kMaxRow, kRegWarps), s, &attr);
  e = cudaOccupancyMaxActiveClusters(slots, kernel, &cfg);
  if (e != cudaSuccess) return e;
  for (*widest = 16; *widest > 1; --*widest) {
    int n = 0;
    cfg = regs_config(*widest, *widest, kFewWarps,
                      regs_smem<__nv_bfloat16, __nv_bfloat16>(kMaxRow,
                                                              kFewWarps),
                      s, &attr);
    // a cluster too wide for the card is refused, or fits no time
    if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess)
      cudaGetLastError();
    else if (n >= 1)
      break;
  }
  return cudaSuccess;
}
