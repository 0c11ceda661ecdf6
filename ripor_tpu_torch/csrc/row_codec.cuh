// Cache-row codec of the quantized megarow KV cache, as device functions.
//
// Replaces the codec the TPU kernels share: _quantize_rows,
// _quantize_rows_int4 and _unpack_int4 in ripor_tpu/ops/attend_reorder.py
// (used in-kernel by ripor_tpu/ops/megarow.py _emit_quant_rows). Plain
// PyTorch version: ripor_tpu_torch/ops/attend_reorder.py, which this file
// matches bit for bit:
//
//   int8: per head group (D values), e = ceil(log2(max(absmax,1e-30)/127)),
//         clipped to [-100, 100]; q = rint(x * 2^-e)  (round half to even).
//   int4: e = ceil(log2(max(absmax,1e-30)/7)); q = clip(rint(x*2^-e),-8,7);
//         byte j = (qk_j + 8) | ((qv_j + 8) << 4)  (K low nibble, V high).
//   tail: SCALE_COLS bytes after the payload; the first 2H hold the
//         exponents (K heads then V heads), the rest are zero.
//
// Build without --use_fast_math: the division, log2f and rintf must stay
// IEEE so the kernel and the plain version agree. 2^e is assembled from
// its exponent bits, so scaling by it is exact.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ripor {

constexpr int SCALE_COLS = 128;
constexpr int INT4_OFFSET = 8;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

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

// exact 2^e for integral e in [-126, 127]
__device__ __forceinline__ float pow2i(int e) {
  return __int_as_float((e + 127) << 23);
}

__device__ __forceinline__ int quant_exponent(float absmax, float qmax) {
  float e = ceilf(log2f(fmaxf(absmax, 1e-30f) / qmax));
  e = fminf(fmaxf(e, -100.f), 100.f);
  return static_cast<int>(e);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// packed int4 byte -> (k, v) integer values in [-8, 7]
__device__ __forceinline__ void unpack_int4(int8_t b, float& k, float& v) {
  const int r = static_cast<int>(b);
  k = static_cast<float>((r & 15) - INT4_OFFSET);
  v = static_cast<float>(((r >> 4) & 15) - INT4_OFFSET);
}

// One warp quantizes the D-wide group x[0, D) to int8 out[0, D); returns
// the group's exponent (identical in every lane).
template <typename T>
__device__ __forceinline__ int warp_quant_group_int8(const T* x, int D,
                                                     int8_t* out, int lane) {
  float am = 0.f;
  for (int d = lane; d < D; d += 32) am = fmaxf(am, fabsf(to_f(x[d])));
  const int e = quant_exponent(warp_max(am), 127.f);
  const float s = pow2i(-e);
  for (int d = lane; d < D; d += 32)
    out[d] = static_cast<int8_t>(static_cast<int>(rintf(to_f(x[d]) * s)));
  return e;
}

// One warp quantizes head h's K group xk[0, D) and V group xv[0, D) into
// D packed int4 bytes; returns both exponents.
template <typename T>
__device__ __forceinline__ void warp_quant_head_int4(const T* xk, const T* xv,
                                                     int D, int8_t* out,
                                                     int lane, int& ek,
                                                     int& ev) {
  float ak = 0.f, av = 0.f;
  for (int d = lane; d < D; d += 32) {
    ak = fmaxf(ak, fabsf(to_f(xk[d])));
    av = fmaxf(av, fabsf(to_f(xv[d])));
  }
  ek = quant_exponent(warp_max(ak), 7.f);
  ev = quant_exponent(warp_max(av), 7.f);
  const float sk = pow2i(-ek), sv = pow2i(-ev);
  for (int d = lane; d < D; d += 32) {
    const int qk =
        static_cast<int>(fminf(fmaxf(rintf(to_f(xk[d]) * sk), -8.f), 7.f));
    const int qv =
        static_cast<int>(fminf(fmaxf(rintf(to_f(xv[d]) * sv), -8.f), 7.f));
    const unsigned byte = static_cast<unsigned>(qk + INT4_OFFSET) |
                          (static_cast<unsigned>(qv + INT4_OFFSET) << 4);
    out[d] = static_cast<int8_t>(static_cast<uint8_t>(byte));
  }
}

// Threads [0, nthreads) (whole warps, thread ``rank``) quantize one K|V
// row kv[0, 2F) (float or bf16, any memory space) into the cache row
// out[0, RW) (global or shared): kind 1 = int8 (RW = 2F + SCALE_COLS),
// kind 2 = int4 (RW = F + SCALE_COLS).
template <typename T>
__device__ inline void quant_row(const T* kv, int F, int H, int kind,
                                 int8_t* out, int rank, int nthreads) {
  const int lane = rank & 31, warp = rank >> 5;
  const int nwarps = nthreads >> 5;
  const int D = F / H;
  int8_t* tail = out + (kind == 1 ? 2 * F : F);
  if (kind == 1) {
    for (int g = warp; g < 2 * H; g += nwarps) {
      const int e = warp_quant_group_int8(kv + g * D, D, out + g * D, lane);
      if (lane == 0) tail[g] = static_cast<int8_t>(e);
    }
  } else {
    for (int h = warp; h < H; h += nwarps) {
      int ek, ev;
      warp_quant_head_int4(kv + h * D, kv + F + h * D, D, out + h * D, lane,
                           ek, ev);
      if (lane == 0) {
        tail[h] = static_cast<int8_t>(ek);
        tail[H + h] = static_cast<int8_t>(ev);
      }
    }
  }
  for (int c = 2 * H + rank; c < SCALE_COLS; c += nthreads) tail[c] = 0;
}

}  // namespace ripor
