// One-query attention of one beam over its cache slots, as device code
// shared by the two step-attention kernels over separate K and V planes:
// K5 (step_attention_fused.cu) and K8 (step_attention.cu). K2 and K4,
// over K|V-merged rows, run the staged core in attend_staged.cuh.
//
// The math is the reference's: per head h, scores over the Mc cache slots
// plus position t's own key, softmax over the Mc + 1 positions in f32 with
// the max subtracted, weighted V sum. Where the reference rounds to the
// dot dtype (RB = true: bf16 caches), every k*q product and every
// probability * v product is rounded to bf16 before its f32 sum; with
// RB = false everything stays f32. Rows with per-(slot, head)
// power-of-2 exponents (SCALED = true) scale the slot's score by the K
// exponent and its probability by the V exponent.
// Two switches serve K8, whose position t is already in the cache: with
// NEW = false there is no separate position-t term (the softmax runs over
// the Mc slots alone), and RP = true rounds the probabilities (only them)
// to bf16; RP defaults to RB.
//
// The caller stages in shared memory qs[F] (q, already rounded to the dot
// dtype) and, with NEW, kvs[2F] (position t's K|V as floats), and hands
// over the scratch sc[(Mc+1)*H], pe[Mc*H], pn[H]. Rows are read through an
// accessor (the Rows template argument) with k(m, f), v(m, f) and, when
// SCALED, ek(m, h) / ev(m, h).
//
// Schedule (one block per beam): one warp per (slot, head) pair forms a
// score with a shuffle reduction, consecutive lanes on consecutive
// columns; one warp per head runs the softmax; then each thread owns
// output columns and walks the slots, so V reads are coalesced across the
// block. Simple and right first: no tensor cores, each row is read twice
// (scores, then V), the second time mostly from L2.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "row_codec.cuh"

namespace ripor {

// Floats of shared memory the core needs beyond qs and kvs.
__host__ __device__ constexpr size_t attend_scratch_floats(int Mc, int H) {
  return static_cast<size_t>(2 * Mc + 2) * H;
}

// Attention of one beam; writes out[0, F) in OutT. Every thread of the
// block must call it (it holds block-wide barriers).
template <bool RB, bool SCALED, typename OutT, class Rows, bool NEW = true,
          bool RP = RB>
__device__ void attend_beam(const Rows& rows, const float* qs,
                            const float* kvs, const float* bias_hist,
                            const float* bias_new, int Mc, int F, int H,
                            float* sc, float* pe, float* pn, OutT* out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int D = F / H;
  const int P = NEW ? Mc + 1 : Mc;  // positions in the softmax

  // scores: pair p = (slot m, head h); m == Mc is position t's own key
  for (int p = warp; p < P * H; p += nwarps) {
    const int m = p / H, h = p - m * H;
    float acc = 0.f;
    if (m < Mc) {
      for (int d = lane; d < D; d += 32) {
        const int f = h * D + d;
        acc += rd<RB>(rows.k(m, f) * qs[f]);
      }
      acc = warp_sum(acc);
      if (SCALED) acc *= pow2i(rows.ek(m, h));
      acc += bias_hist[m * H + h];
    } else {
      for (int d = lane; d < D; d += 32) {
        const int f = h * D + d;
        acc += rd<RB>(rd<RB>(kvs[f]) * qs[f]);
      }
      acc = warp_sum(acc) + bias_new[h];
    }
    if (lane == 0) sc[m * H + h] = acc;
  }
  __syncthreads();

  // softmax over the P positions, one warp per head
  for (int h = warp; h < H; h += nwarps) {
    float mx = -INFINITY;
    for (int m = lane; m < P; m += 32) mx = fmaxf(mx, sc[m * H + h]);
    mx = warp_max(mx);
    float s = 0.f;
    for (int m = lane; m < P; m += 32) {
      const float e = expf(sc[m * H + h] - mx);
      sc[m * H + h] = e;
      s += e;
    }
    s = warp_sum(s);
    for (int m = lane; m < P; m += 32) sc[m * H + h] = sc[m * H + h] / s;
  }
  __syncthreads();

  for (int p = tid; p < Mc * H; p += nthreads) {
    float w = sc[p];
    if (SCALED) {
      const int m = p / H, h = p - m * H;
      w *= pow2i(rows.ev(m, h));
    }
    pe[p] = rd<RB || RP>(w);
  }
  if (NEW)
    for (int h = tid; h < H; h += nthreads)
      pn[h] = rd<RB || RP>(sc[Mc * H + h]);
  __syncthreads();

  // weighted V sum: each thread owns columns f, walks the slots
  for (int f = tid; f < F; f += nthreads) {
    const int h = f / D;
    float acc = 0.f;
    for (int m = 0; m < Mc; ++m)
      acc += rd<RB>(pe[m * H + h] * rows.v(m, f));
    if (NEW) acc += pn[h] * kvs[F + f];
    out[f] = from_f<OutT>(acc);
  }
}

// one beam's K and V planes of one layer, [Mc, F] each, in T (exact
// rows; K5 and K8)
template <typename T>
struct PlaneRows {
  const T* kp;
  const T* vp;
  int F;
  __device__ __forceinline__ float k(int m, int f) const {
    return to_f(kp[static_cast<long long>(m) * F + f]);
  }
  __device__ __forceinline__ float v(int m, int f) const {
    return to_f(vp[static_cast<long long>(m) * F + f]);
  }
  __device__ __forceinline__ int ek(int, int) const { return 0; }
  __device__ __forceinline__ int ev(int, int) const { return 0; }
};

}  // namespace ripor
