// One-query attention of one beam over its cache slots, as device code
// shared by the four step-attention kernels: K2 (step_attention_seq.cu),
// K4 (step_attend_reorder.cu), K5 (step_attention_fused.cu) and K8
// (step_attention.cu).
//
// The math is the reference's: per head h, scores over the Mc cache slots
// plus position t's own key, softmax over the Mc + 1 positions in f32 with
// the max subtracted, weighted V sum. Where the reference rounds to the
// dot dtype (RB = true: bf16 for quantized rows and bf16 caches), every
// k*q product and every (probability * V scale) * v product is rounded to
// bf16 before its f32 sum; with RB = false everything stays f32. Quantized
// rows carry per-(slot, head) power-of-2 exponents (SCALED = true): the
// K exponent scales the slot's score, the V exponent its probability.
// Two switches serve K8, whose position t is already in the cache: with
// NEW = false there is no separate position-t term (the softmax runs over
// the Mc slots alone), and RP = true rounds the probabilities (only them)
// to bf16; RP defaults to RB.
//
// The caller stages in shared memory qs[F] (q, already rounded to the dot
// dtype) and, with NEW, kvs[2F] (position t's K|V as floats), and hands
// over the scratch sc[(Mc+1)*H], pe[Mc*H], pn[H]. Rows are read through an
// accessor (the Rows template argument) with k(m, f), v(m, f) and, when
// SCALED, ek(m, h) / ev(m, h): that is where the kernels differ (merged
// K|V rows, separate K and V planes, a slot taken from elsewhere).
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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// round to the dot dtype (bf16) or keep f32
template <bool RB>
__device__ __forceinline__ float rd(float x) {
  return RB ? bf16_round(x) : x;
}

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

// Rows of the K|V-merged caches (megarow [.., Mc, RW] and the per-layer
// merged cache): KIND 0 exact rows of T (RW = 2F: K then V), 1 int8 rows
// (RW = 2F + SCALE_COLS), 2 packed int4 rows (RW = F + SCALE_COLS, K in
// the low nibble, V in the high). Slot ``ovr`` (or none, when it is -1)
// is read elsewhere: with OVR_EXACT from ovr_f, exact K|V floats [2F]
// rounded to bf16, with exponent 0 (scale 1); otherwise from ovr_row, a
// row in the cache's own layout.
template <typename T, int KIND, bool OVR_EXACT>
struct MergedRows {
  const char* base;
  long long row_bytes;
  int F, H;
  int ovr;
  const char* ovr_row;
  const float* ovr_f;

  __device__ __forceinline__ const char* row(int m) const {
    return (!OVR_EXACT && m == ovr) ? ovr_row : base + m * row_bytes;
  }
  __device__ __forceinline__ int ecol() const {
    return KIND == 1 ? 2 * F : F;
  }
  __device__ __forceinline__ float k(int m, int f) const {
    if (OVR_EXACT && m == ovr) return bf16_round(ovr_f[f]);
    const char* r = row(m);
    if (KIND == 0) return to_f(reinterpret_cast<const T*>(r)[f]);
    if (KIND == 1)
      return static_cast<float>(reinterpret_cast<const int8_t*>(r)[f]);
    float lo, hi;
    unpack_int4(reinterpret_cast<const int8_t*>(r)[f], lo, hi);
    return lo;
  }
  __device__ __forceinline__ float v(int m, int f) const {
    if (OVR_EXACT && m == ovr) return bf16_round(ovr_f[F + f]);
    const char* r = row(m);
    if (KIND == 0) return to_f(reinterpret_cast<const T*>(r)[F + f]);
    if (KIND == 1)
      return static_cast<float>(reinterpret_cast<const int8_t*>(r)[F + f]);
    float lo, hi;
    unpack_int4(reinterpret_cast<const int8_t*>(r)[f], lo, hi);
    return hi;
  }
  __device__ __forceinline__ int ek(int m, int h) const {
    if (OVR_EXACT && m == ovr) return 0;
    return reinterpret_cast<const int8_t*>(row(m))[ecol() + h];
  }
  __device__ __forceinline__ int ev(int m, int h) const {
    if (OVR_EXACT && m == ovr) return 0;
    return reinterpret_cast<const int8_t*>(row(m))[ecol() + H + h];
  }
};

}  // namespace ripor
