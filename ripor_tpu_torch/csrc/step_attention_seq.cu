// K2: one-position self-attention over the reordered megarow cache.
//
// Replaces: ripor_tpu/ops/megarow.py::step_attention_seq (Pallas
// _seq_kernel, math _seq_math / _seq_math_quant, QFUSE _emit_quant_rows).
// Plain version: ripor_tpu_torch/ops/megarow.py::step_attention_seq_plain.
//
// For beam (b, n) and layer l: scores over the Mc cache slots of
// cache[b, n, l] plus position t's own key, per head; softmax over the
// Mc + 1 positions in f32 with the max subtracted; weighted V sum in q's
// dtype. int8/int4 rows are dequantized by per-(slot, head) power-of-2
// exponents from the row's scale tail. With emit, the block also writes
// kv_new in cache-row layout (row_codec.cuh) for the next step's K1.
// Rounding points follow the reference math: k*q products and
// (probability * V scale) * v products are rounded to the dot dtype (bf16
// for quantized caches, else the cache dtype) before f32 sums.
//
// Bound on the H100: bytes. Per layer call it reads B*N*Mc*RW cache bytes
// plus q, kv_new and writes attn (+ kvq); the math is ~4 flops per cache
// element, far under the ~300 flop/byte ridge. At t5-base, B=8, N=1000,
// Mc=32, int4 rows that is ~0.29 GB, ~85 us at 3.35 TB/s.
//
// Design: one block (256 threads) per beam — B*N = 8000 blocks at the
// main-path shape keep all 132 SMs busy without a cross-block reduction.
// q and kv_new are staged once in shared memory as floats; one warp per
// (slot, head) pair forms a score with a shuffle reduction (consecutive
// lanes read consecutive row bytes); one warp per head runs the softmax;
// then each thread owns output columns and walks the Mc slots, so V reads
// are coalesced across the block. Simple and right first: no tensor
// cores, no TMA, each row read twice (scores, then V) from L2.
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "row_codec.cuh"

using namespace ripor;

namespace {

constexpr int kThreads = 256;

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

// KIND: 0 exact rows (dtype T, RW = 2F), 1 int8 rows, 2 packed int4 rows
template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads)
step_attention_seq_kernel(const T* __restrict__ q,
                          const T* __restrict__ kv_new,
                          const void* __restrict__ cache,
                          const float* __restrict__ bias_hist,
                          const float* __restrict__ bias_new,
                          T* __restrict__ attn, int8_t* __restrict__ kvq,
                          int L, int Mc, int F, int H, int RW, int layer,
                          int emit) {
  constexpr bool RB = KIND != 0 || std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ float sm[];
  const int D = F / H;
  float* qs = sm;                     // [F]   q in the dot dtype
  float* kvs = qs + F;                // [2F]  kv_new as float
  float* sc = kvs + 2 * F;            // [(Mc+1)*H] scores, then probs
  float* pe = sc + (Mc + 1) * H;      // [Mc*H] prob (* V scale), dot dtype
  float* pn = pe + Mc * H;            // [H]   new-position prob, dot dtype

  const long long beam = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = kThreads / 32;
  const long long row_bytes =
      KIND == 0 ? static_cast<long long>(RW) * sizeof(T) : RW;
  const char* rows = static_cast<const char*>(cache) +
                     (beam * L + layer) * static_cast<long long>(Mc) *
                         row_bytes;
  const int ecol = KIND == 1 ? 2 * F : F;  // first scale-tail byte

  for (int i = tid; i < F; i += kThreads)
    qs[i] = rd<RB>(to_f(q[beam * F + i]));
  for (int i = tid; i < 2 * F; i += kThreads)
    kvs[i] = to_f(kv_new[beam * 2 * F + i]);
  __syncthreads();

  // scores: pair p = (slot m, head h); m == Mc is position t's own key
  for (int p = warp; p < (Mc + 1) * H; p += nwarps) {
    const int m = p / H, h = p - m * H;
    float acc = 0.f;
    if (m < Mc) {
      const char* row = rows + m * row_bytes;
      for (int d = lane; d < D; d += 32) {
        const int f = h * D + d;
        float k;
        if (KIND == 0) {
          k = to_f(reinterpret_cast<const T*>(row)[f]);
        } else if (KIND == 1) {
          k = static_cast<float>(reinterpret_cast<const int8_t*>(row)[f]);
        } else {
          float v_unused;
          unpack_int4(reinterpret_cast<const int8_t*>(row)[f], k, v_unused);
        }
        acc += rd<RB>(k * qs[f]);
      }
      acc = warp_sum(acc);
      if (KIND != 0)
        acc *= pow2i(reinterpret_cast<const int8_t*>(row)[ecol + h]);
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

  // softmax over the Mc + 1 positions, one warp per head
  for (int h = warp; h < H; h += nwarps) {
    float mx = -INFINITY;
    for (int m = lane; m <= Mc; m += 32) mx = fmaxf(mx, sc[m * H + h]);
    mx = warp_max(mx);
    float s = 0.f;
    for (int m = lane; m <= Mc; m += 32) {
      const float e = expf(sc[m * H + h] - mx);
      sc[m * H + h] = e;
      s += e;
    }
    s = warp_sum(s);
    for (int m = lane; m <= Mc; m += 32) sc[m * H + h] = sc[m * H + h] / s;
  }
  __syncthreads();

  for (int p = tid; p < Mc * H; p += kThreads) {
    float w = sc[p];
    if (KIND != 0) {
      const int m = p / H, h = p - m * H;
      w *= pow2i(reinterpret_cast<const int8_t*>(rows + m * row_bytes)
                     [ecol + H + h]);
    }
    pe[p] = rd<RB>(w);
  }
  for (int h = tid; h < H; h += kThreads) pn[h] = rd<RB>(sc[Mc * H + h]);
  __syncthreads();

  // weighted V sum: each thread owns columns f, walks the slots
  for (int f = tid; f < F; f += kThreads) {
    const int h = f / D;
    float acc = 0.f;
    for (int m = 0; m < Mc; ++m) {
      const char* row = rows + m * row_bytes;
      float v;
      if (KIND == 0) {
        v = to_f(reinterpret_cast<const T*>(row)[F + f]);
      } else if (KIND == 1) {
        v = static_cast<float>(reinterpret_cast<const int8_t*>(row)[F + f]);
      } else {
        float k_unused;
        unpack_int4(reinterpret_cast<const int8_t*>(row)[f], k_unused, v);
      }
      acc += rd<RB>(pe[m * H + h] * v);
    }
    acc += pn[h] * kvs[F + f];
    attn[beam * F + f] = from_f<T>(acc);
  }

  if (KIND != 0 && emit) block_quant_row(kvs, F, H, KIND, kvq + beam * RW);
}

template <typename T, int KIND>
cudaError_t launch(const void* q, const void* kv_new, const void* cache,
                   const void* bias_hist, const void* bias_new, void* attn,
                   void* kvq, long long BN, int L, int Mc, int F, int H,
                   int RW, int layer, int emit, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (3 * static_cast<size_t>(F) + (2 * Mc + 2) * H);
  auto kernel = step_attention_seq_kernel<T, KIND>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(BN), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv_new), cache,
      static_cast<const float*>(bias_hist),
      static_cast<const float*>(bias_new), static_cast<T*>(attn),
      static_cast<int8_t*>(kvq), L, Mc, F, H, RW, layer, emit);
  return cudaGetLastError();
}

}  // namespace

// kind: 0 exact, 1 int8, 2 int4; is_f32: q/kv_new/attn (and exact rows)
// are float32, else bfloat16. kvq may be null when emit == 0.
extern "C" int step_attention_seq(const void* q, const void* kv_new,
                                  const void* cache, const void* bias_hist,
                                  const void* bias_new, void* attn, void* kvq,
                                  long long BN, long long L, long long Mc,
                                  long long F, long long H, long long RW,
                                  long long layer, long long kind,
                                  long long is_f32, long long emit,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (BN == 0) return cudaSuccess;
#define RIPOR_LAUNCH(T, K)                                                 \
  err = launch<T, K>(q, kv_new, cache, bias_hist, bias_new, attn, kvq, BN, \
                     int(L), int(Mc), int(F), int(H), int(RW), int(layer), \
                     int(emit), s)
  if (is_f32) {
    if (kind == 0) RIPOR_LAUNCH(float, 0);
    else if (kind == 1) RIPOR_LAUNCH(float, 1);
    else if (kind == 2) RIPOR_LAUNCH(float, 2);
  } else {
    if (kind == 0) RIPOR_LAUNCH(__nv_bfloat16, 0);
    else if (kind == 1) RIPOR_LAUNCH(__nv_bfloat16, 1);
    else if (kind == 2) RIPOR_LAUNCH(__nv_bfloat16, 2);
  }
#undef RIPOR_LAUNCH
  return static_cast<int>(err);
}
