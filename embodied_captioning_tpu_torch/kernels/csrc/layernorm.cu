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
#include "common.cuh"

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
// written once per element, with ~15 operations per element in between;
// the float32 partials of dg and db add 2 x parts x d floats each way.
//
// Design (a simple kernel that is right; making it fast is later work):
//   layernorm_bwd_rows: the rows are cut into `parts` contiguous groups,
//     one block per group; each warp of the block takes every W-th row of
//     the group. A row is walked three times by the warp's lanes (the
//     statistics, the two means, then dx), in chunks of 8 elements read as
//     16-byte vectors where the row and the pointers allow it, else one
//     element at a time; the second and third walks hit L1/L2. Each lane
//     adds dy * xhat and dy into its own columns of its warp's float32
//     accumulators in shared memory (a column belongs to one lane, so no
//     atomics); at the end the block sums its warps in order into its
//     partial row of dg and db.
//   layernorm_bwd_cols: each column's partials are summed over the groups
//     in a fixed order (eight strided sums, then those eight in order).
//   No atomics anywhere: two runs give the same bits.

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
// f32; part: float32 scratch of 2 x parts x d (parts in 1..rows).
extern "C" int ecap_layernorm_bwd(const void* x, const void* g, const void* dy,
                                  void* dx, void* dg, void* db, void* part,
                                  int rows, int d, int parts, float eps,
                                  int two_pass, int x_bf16, int dy_bf16,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0 || parts < 1 || parts > rows)
    return cudaErrorInvalidValue;
  float* fg = static_cast<float*>(dg);
  float* fb = static_cast<float*>(db);
  float* fp = static_cast<float*>(part);
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
