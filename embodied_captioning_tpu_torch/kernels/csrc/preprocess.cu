// Fused image preprocess: uint8 crops -> normalised ViT patch tokens.
//
// Replaces: embodied_captioning_tpu/ops/pallas/preprocess.py
//   fused_preprocess (_preprocess_kernel)
//
//   [N, H, W, 3] uint8 -> v / 255 -> half-pixel bilinear resize to out x
//   out (the vertical two-tap sum, then the horizontal one) -> (v - mean) /
//   std -> [N, T, p*p*3] f32, a token holding its patch's rows, then
//   columns, then channels.
//
// The TPU kernel takes one image and is mapped over a batch; here the batch
// is a leading axis of one launch. The source rows, columns and fractions
// come precomputed from the wrapper (as the TPU kernel's do), so the kernel
// and its plain version share them. The arithmetic is the order of the JAX
// package's default path (`ops/image.preprocess_for_vit` as XLA on the CPU
// computes it): an IEEE v / 255 per source byte (a product with the
// rounded reciprocal, corrected by its residual), each two-tap sum as two
// rounded products and their rounded sum, and an IEEE division by std;
// every operation is spelled with its rounding, so the result equals the
// plain version's bit for bit. (XLA on the CPU rounds some output sizes'
// tap sums as one FMA instead: kernels/preprocess.py says by how much.)
//
// Bound on an H100 SXM (3.35 TB/s): memory. 64 crops of 224^2: 9.6 MB read,
// 38.5 MB written, ~14 us. A thread per output element with 64-bit index
// arithmetic (divisions by runtime sizes) spent its time on integer
// instructions, not on memory; the IEEE division by std per element
// remains the largest cost that the numerics fix.
//
// Design: one block per (crop, patch row, group of tokens), each group up
// to 1024 output pixels (4 tokens of 14^2 at the serving shape: 4,096
// blocks of 128 threads). A block's output is one contiguous run of
// tokens. It reads the taps of its p output rows and its output columns
// once into shared memory, and stages the source pixels they need, a pixel
// per 4-byte word: the rows from the first output row's upper tap to the
// last one's lower tap, the columns from the first output column's left tap
// to the last one's right tap (up to 16 rows of 65 pixels at the serving
// shape), with aligned 4-byte loads where a source row is a multiple of 4
// pixels and bytes otherwise. A resize to less than half the size uses few
// of the pixels between its taps, and reads its taps from device memory
// instead. A thread then computes whole output pixels, so each channel's
// mean and std are known where they are used, into a tile in shared
// memory, which the block writes out with coalesced 16-byte stores. All
// index arithmetic is 32-bit within a crop; the patch size is a template
// argument for the presets' sizes (8, 14, 16), so divisions by p and p*p
// are multiplies and shifts, and one instance takes any other patch at run
// time.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTilePixels = 1024;  // output pixels a block holds at once

struct Args {
  const uint8_t* img;
  const int* y0;
  const int* y1;
  const float* fy;
  const int* x0;
  const int* x1;
  const float* fx;
  float* out;
  int h, w, out_size, patch;
  float mean[3], stdv[3];
  int group;        // tokens a block writes (of one patch row)
  int groups;       // blocks per patch row
  int staged_rows;  // source rows a block stages (0: none)
  int staged_cols;  // source pixels of a staged row
};

// A staged row holds a pixel per 4-byte word. Its stride in words is the
// least at or above `cols` that leaves p banks between rows: a warp's 32
// pixels lie on two or three output rows of one patch, p columns each, so
// at the identity size their words fall on distinct banks.
__host__ __device__ inline int row_words(int cols, int p) {
  return cols + ((p - cols) % 32 + 32) % 32;
}
// shared memory, in words: the block's column taps (3 * group * p), the p
// output rows' weights and source rows (3 p), then the output tile and the
// staged rows
__host__ __device__ inline int taps_words(int group, int p) {
  return (3 * group * p + 3 * p + 3) / 4 * 4;
}
__host__ __device__ inline int tile_pixels(int group, int p) {
  return group * p * p < kTilePixels ? group * p * p : kTilePixels;
}

// v / 255 rounded as an IEEE division, for an integer v in [0, 255]: the
// product with the rounded reciprocal, corrected by its residual (exact for
// every byte; the product alone misses 126 of the 256)
__device__ __forceinline__ float div255(float v) {
  const float r = 1.f / 255.f;
  const float q = __fmul_rn(v, r);
  return __fmaf_rn(__fmaf_rn(-q, 255.f, v), r, q);
}
// channel c of a staged pixel word / 255: the byte placed in the mantissa
// of 2^23 (one byte permute), 2^23 subtracted, then div255
__device__ __forceinline__ float channel(uint32_t word, int c) {
  return div255(__fsub_rn(
      __uint_as_float(__byte_perm(word, 0x4bu, 0x4550 | c)), 8388608.f));
}
__device__ __forceinline__ float u8_to_float(uint8_t v) {
  return div255(__fsub_rn(__uint_as_float(0x4b000000u | v), 8388608.f));
}
// (1 - w) * lo + w * hi: two rounded products and their rounded sum
__device__ __forceinline__ float two_taps(float lo, float hi, float w0,
                                          float w) {
  return __fadd_rn(__fmul_rn(lo, w0), __fmul_rn(hi, w));
}

// The block's output, a tile of pixels at a time: a thread computes whole
// pixels (three channels, so each channel's mean and std are known where
// they are used) into the tile, which the block then writes out with
// coalesced 16-byte stores. The source pixels come from the staged rows
// (s_ra, s_rb: word offsets of rows; s_x0, s_x1: columns in a row) or from
// the crop in device memory (row and column indices).
template <int P, bool kStaged>
__device__ __forceinline__ void write_tiles(
    const Args& a, int p, int tokens, const uint32_t* rows,
    const uint8_t* img, const int* s_x0, const int* s_x1, const float* s_fx,
    const float* s_fy, const int* s_ra, const int* s_rb, float* tile,
    float* dst) {
  const int pp = p * p;
  const int pixels = tokens * pp;
  const bool vec = pp % 4 == 0;  // p even: dst is 16-byte aligned
  for (int start = 0; start < pixels; start += kTilePixels) {
    const int count = min(kTilePixels, pixels - start);
    for (int i = threadIdx.x; i < count; i += kThreads) {
      const int pix = start + i;
      const int t = pix / pp, r = pix - t * pp;
      const int ly = r / p, ox = t * p + (r - ly * p);
      const int xa = s_x0[ox], xb = s_x1[ox];
      const float wy = s_fy[ly], wx = s_fx[ox];
      const float wy0 = __fsub_rn(1.f, wy), wx0 = __fsub_rn(1.f, wx);
      float v[4][3];  // texels / 255 (upper left, upper right, lower left,
                      // lower right) by channel
      if constexpr (kStaged) {
        const uint32_t* ra = rows + s_ra[ly];
        const uint32_t* rb = rows + s_rb[ly];
        const uint32_t w[4] = {ra[xa], ra[xb], rb[xa], rb[xb]};
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int c = 0; c < 3; ++c) v[k][c] = channel(w[k], c);
      } else {
        const size_t row_bytes = 3 * static_cast<size_t>(a.w);
        const uint8_t* ra = img + s_ra[ly] * row_bytes;
        const uint8_t* rb = img + s_rb[ly] * row_bytes;
        const uint8_t* q[4] = {ra + 3 * xa, ra + 3 * xb, rb + 3 * xa,
                               rb + 3 * xb};
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int c = 0; c < 3; ++c) v[k][c] = u8_to_float(q[k][c]);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float left = two_taps(v[0][c], v[2][c], wy0, wy);
        const float right = two_taps(v[1][c], v[3][c], wy0, wy);
        const float y = two_taps(left, right, wx0, wx);
        tile[3 * i + c] = __fdiv_rn(__fsub_rn(y, a.mean[c]), a.stdv[c]);
      }
    }
    __syncthreads();
    const int nf = 3 * count;
    float* d = dst + 3 * start;
    int done = 0;
    if (vec) {
      done = nf / 4 * 4;
      for (int k = threadIdx.x; k < nf / 4; k += kThreads)
        reinterpret_cast<float4*>(d)[k] =
            reinterpret_cast<const float4*>(tile)[k];
    }
    for (int k = done + threadIdx.x; k < nf; k += kThreads) d[k] = tile[k];
    __syncthreads();
  }
}

template <int P>
__global__ void __launch_bounds__(kThreads)
preprocess_kernel(Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int p = P > 0 ? P : a.patch;
  const int gw = a.out_size / p;
  // the block's crop, patch row and first token
  const int per_crop = gw * a.groups;
  const int n = blockIdx.x / per_crop, b = blockIdx.x - n * per_crop;
  const int gy = b / a.groups, tx0 = (b - gy * a.groups) * a.group;
  const int tokens = min(a.group, gw - tx0);
  const int cols = tokens * p, ox0 = tx0 * p;
  const int row_bytes = 3 * a.w;
  const uint8_t* img =
      a.img + static_cast<size_t>(n) * a.h * static_cast<size_t>(row_bytes);

  int* s_x0 = reinterpret_cast<int*>(smem);
  int* s_x1 = s_x0 + a.group * p;
  float* s_fx = reinterpret_cast<float*>(s_x1 + a.group * p);
  float* s_fy = s_fx + a.group * p;
  int* s_ra = reinterpret_cast<int*>(s_fy + p);
  int* s_rb = s_ra + p;
  float* tile = reinterpret_cast<float*>(smem) + taps_words(a.group, p);
  uint32_t* rows =
      reinterpret_cast<uint32_t*>(tile + 3 * tile_pixels(a.group, p));

  // the staged source pixels: the rows from the first output row's upper
  // tap to the last one's lower tap, the columns from the first output
  // column's left tap to the last one's right tap (from a multiple of 4
  // where whole words are loaded), where they fit; else none (the pixels
  // are read from device memory)
  const int oy0 = gy * p;
  const int lo = a.y0[oy0], hi = a.y1[oy0 + p - 1];
  const bool words =
      a.w % 4 == 0 && reinterpret_cast<uintptr_t>(a.img) % 4 == 0;
  const int c_lo = words ? a.x0[ox0] & ~3 : a.x0[ox0];
  int ncols = a.x1[ox0 + cols - 1] - c_lo + 1;
  if (words) ncols = (ncols + 3) & ~3;
  const bool staged =
      hi - lo + 1 <= a.staged_rows && ncols <= a.staged_cols;
  const int stride = row_words(a.staged_cols, p);
  for (int i = threadIdx.x; i < cols; i += kThreads) {
    s_x0[i] = a.x0[ox0 + i] - (staged ? c_lo : 0);
    s_x1[i] = a.x1[ox0 + i] - (staged ? c_lo : 0);
    s_fx[i] = a.fx[ox0 + i];
  }
  for (int i = threadIdx.x; i < p; i += kThreads) {
    const int ya = a.y0[oy0 + i], yb = a.y1[oy0 + i];
    s_fy[i] = a.fy[oy0 + i];
    s_ra[i] = staged ? (ya - lo) * stride : ya;
    s_rb[i] = staged ? (yb - lo) * stride : yb;
  }
  if (staged) {
    const int count = hi - lo + 1;
    // the first staged pixel of staged row s
    auto source = [&](int s) {
      return img + static_cast<size_t>(lo + s) * row_bytes + 3 * c_lo;
    };
    if (words) {
      // four pixels from three aligned words
      const int quads = ncols / 4;
      for (int i = threadIdx.x; i < count * quads; i += kThreads) {
        const int s = i / quads, k = i - s * quads;
        const uint32_t* g =
            reinterpret_cast<const uint32_t*>(source(s)) + 3 * k;
        const uint32_t w0 = g[0], w1 = g[1], w2 = g[2];
        uint32_t* d = rows + s * stride + 4 * k;
        d[0] = w0;
        d[1] = __byte_perm(w0, w1, 0x0543);
        d[2] = __byte_perm(w1, w2, 0x0432);
        d[3] = w2 >> 8;
      }
    } else {
      for (int i = threadIdx.x; i < count * ncols; i += kThreads) {
        const int s = i / ncols, x = i - s * ncols;
        const uint8_t* q = source(s) + 3 * x;
        rows[s * stride + x] = q[0] | (q[1] << 8) | (q[2] << 16);
      }
    }
  }
  __syncthreads();
  float* dst = a.out + ((static_cast<size_t>(n) * gw + gy) * gw + tx0) *
                           static_cast<size_t>(3 * p * p);
  if (staged)
    write_tiles<P, true>(a, p, tokens, rows, img, s_x0, s_x1, s_fx, s_fy,
                         s_ra, s_rb, tile, dst);
  else
    write_tiles<P, false>(a, p, tokens, rows, img, s_x0, s_x1, s_fx, s_fy,
                          s_ra, s_rb, tile, dst);
}

template <int P>
int launch(Args a, int n, cudaStream_t stream) {
  const int p = P > 0 ? P : a.patch;
  const int gw = a.out_size / p;
  // a block writes up to a tile of pixels of one patch row: `group` tokens
  const int per_row = (gw * p * p + kTilePixels - 1) / kTilePixels;
  a.group = (gw + per_row - 1) / per_row;
  a.groups = (gw + a.group - 1) / a.group;
  const long long blocks = static_cast<long long>(n) * gw * a.groups;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  // the source rows of p output rows span at most (p - 1) h / out + 2 rows
  // (one more for rounding), the columns of `group` tokens likewise (plus 6
  // for word alignment). A block stages them where the rows are at most 2p,
  // a resize to half the size or larger; a smaller resize uses few of the
  // pixels between its taps, and reads its taps from device memory.
  const long long span =
      (static_cast<long long>(p - 1) * a.h + a.out_size - 1) / a.out_size + 3;
  const long long col_span =
      (static_cast<long long>(a.group * p - 1) * a.w + a.out_size - 1) /
          a.out_size + 9;
  a.staged_cols = static_cast<int>(col_span < (a.w + 3) / 4 * 4
                                       ? col_span : (a.w + 3) / 4 * 4);
  const size_t row = 4 * static_cast<size_t>(row_words(a.staged_cols, p));
  a.staged_rows = static_cast<int>(span <= 2 * p ? span : 0);
  const size_t fixed =
      4 * static_cast<size_t>(taps_words(a.group, p) +
                              3 * tile_pixels(a.group, p));
  size_t bytes = fixed + a.staged_rows * row;
  if (bytes > ecap::kMaxSmem) {
    a.staged_rows = 0;
    bytes = fixed;
  }
  if (bytes > ecap::kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = preprocess_kernel<P>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// img [N,H,W,3] uint8; y0,y1 [out] int32 and fy [out] f32: source rows and
// the lower row's weight, nondecreasing as `source_taps` gives them (a
// block stages the source rows between its first and last taps); x0,x1,fx
// likewise for columns; out
// [N, (out/patch)^2, patch*patch*3] f32, 16-byte aligned. Returns
// cudaErrorInvalidValue for a shape it does not take.
extern "C" int ecap_fused_preprocess(const void* img, const void* y0,
                                     const void* y1, const void* fy,
                                     const void* x0, const void* x1,
                                     const void* fx, void* out, int n, int h,
                                     int w, int out_size, int patch, float m0,
                                     float m1, float m2, float s0, float s1,
                                     float s2, void* stream) {
  if (n == 0 || out_size == 0) return 0;
  if (patch < 1 || out_size % patch || h < 1 || w < 1 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const uint8_t*>(img), static_cast<const int*>(y0),
         static_cast<const int*>(y1), static_cast<const float*>(fy),
         static_cast<const int*>(x0), static_cast<const int*>(x1),
         static_cast<const float*>(fx), static_cast<float*>(out), h, w,
         out_size, patch, {m0, m1, m2}, {s0, s1, s2}, 0, 0, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (patch) {
    case 8: return launch<8>(a, n, s);
    case 14: return launch<14>(a, n, s);
    case 16: return launch<16>(a, n, s);
    default: return launch<0>(a, n, s);
  }
}
