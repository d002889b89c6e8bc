// Ray-AABB visibility: for every pixel's ray, the nearest box hit and its
// index, folded in box order.
//
// Replaces: embodied_captioning_tpu/ops/pallas/raycast.py
//   raycast_minargmin (_raycast_kernel), vmapped over envs by the render.
//
// Bound on an H100 SXM: per ray the function reads 12 bytes of reciprocal
// direction and writes 8 (t_best f32, best i32). Per box, as compiled
// (sm_90a), the loop does 22 FP32 operations (6 FMUL, 11 FMNMX, 4 FSETP,
// 1 FSEL: 88 of the 125 instructions that take 4 boxes) and 9 others.
// None of them is a fused multiply-add, and each takes a lane for at least
// one clock, so the card does at most 67 / 2 = 33.5 T of them a second
// (its 67 TFLOP/s counts an FMA as two; min/max may issue at a lower rate
// still, which would only raise the bound): at 16 envs x 1280^2 rays x 96
// boxes at least 1.65 ms. With 96 boxes that is ~105 operations per byte,
// above the card's balance for them (33.5 T/s over 3.35 TB/s = 10), so
// the box loop bounds it, not the memory. There is no matrix product in
// it, so the tensor cores do not apply. chip_smoke.py counts the loop's
// instructions in the built library (cuobjdump -sass) and takes its bound
// from that count.
//
// Design: one thread per ray, one grid row per env. A block first stages
// the env's seven box tables (min xyz, max xyz, valid) in shared memory;
// in the loop every thread of a warp reads the same table entry, which
// shared memory broadcasts. The running (t_best, best) pair lives in
// registers, so no [H, W, boxes] tensor exists anywhere.
//
// Exactness: the slab test has only multiplies, min and max (nothing for
// the compiler to contract into a fused multiply-add), in the expression
// tree of the TPU kernel, and the update is strict (tb < t_best) in box
// order, which is argmin's first-lowest-index rule. Boxes arrive already
// translated by -origin, as in the TPU kernel. No operand can be NaN: the
// reciprocals are clamped to +-1e8 upstream and the boxes are finite.
#include "common.cuh"

#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBoxes = 1024;

// a_min, a_max [E, nb, 3]; validf [E, nb] (> 0 = valid); inv [E, npix, 3];
// t_best [E, npix] f32 (inf on a miss); best [E, npix] i32 (0 on a miss).
__global__ void __launch_bounds__(kThreads)
raycast_kernel(const float* __restrict__ a_min, const float* __restrict__ a_max,
               const float* __restrict__ validf, const float* __restrict__ inv,
               float* __restrict__ t_best_out, int* __restrict__ best_out,
               int nb, int npix) {
  __shared__ float tab[7][kMaxBoxes];
  const int env = blockIdx.y;
  const float* mn = a_min + static_cast<size_t>(env) * nb * 3;
  const float* mx = a_max + static_cast<size_t>(env) * nb * 3;
  for (int i = threadIdx.x; i < nb; i += kThreads) {
    tab[0][i] = mn[i * 3 + 0];
    tab[1][i] = mn[i * 3 + 1];
    tab[2][i] = mn[i * 3 + 2];
    tab[3][i] = mx[i * 3 + 0];
    tab[4][i] = mx[i * 3 + 1];
    tab[5][i] = mx[i * 3 + 2];
    tab[6][i] = validf[static_cast<size_t>(env) * nb + i];
  }
  __syncthreads();
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= npix) return;
  const size_t ray = static_cast<size_t>(env) * npix + pix;
  const float invx = inv[ray * 3 + 0];
  const float invy = inv[ray * 3 + 1];
  const float invz = inv[ray * 3 + 2];
  float t_best = CUDART_INF_F;
  int best = 0;
  for (int b = 0; b < nb; ++b) {
    float t0 = tab[0][b] * invx;
    float t1 = tab[3][b] * invx;
    float t_near = fminf(t0, t1);
    float t_far = fmaxf(t0, t1);
    t0 = tab[1][b] * invy;
    t1 = tab[4][b] * invy;
    t_near = fmaxf(t_near, fminf(t0, t1));
    t_far = fminf(t_far, fmaxf(t0, t1));
    t0 = tab[2][b] * invz;
    t1 = tab[5][b] * invz;
    t_near = fmaxf(t_near, fminf(t0, t1));
    t_far = fminf(t_far, fmaxf(t0, t1));
    const bool hit = (t_near <= t_far) && (t_far > 1e-4f) && (tab[6][b] > 0.f);
    const float tb = hit ? fmaxf(t_near, 1e-4f) : CUDART_INF_F;
    if (tb < t_best) {
      t_best = tb;
      best = b;
    }
  }
  t_best_out[ray] = t_best;
  best_out[ray] = best;
}

}  // namespace

extern "C" int ecap_raycast_minargmin(const void* a_min, const void* a_max,
                                      const void* validf, const void* inv,
                                      void* t_best, void* best, int envs,
                                      int nb, int npix, void* stream) {
  if (nb > kMaxBoxes) return cudaErrorInvalidValue;
  const dim3 grid((npix + kThreads - 1) / kThreads, envs);
  raycast_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a_min), static_cast<const float*>(a_max),
      static_cast<const float*>(validf), static_cast<const float*>(inv),
      static_cast<float*>(t_best), static_cast<int*>(best), nb, npix);
  return cudaGetLastError();
}
