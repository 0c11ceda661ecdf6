// K4: per-layer beam reorder of the K|V-merged cache with the slot t-1
// insert, fused with one-position self-attention (the deferred decode).
//
// Replaces: ripor_tpu/ops/attend_reorder.py::step_attend_reorder (Pallas
// _kernel, math _attn_math / _attn_math_q8 / _attn_math_q4). Plain
// version: ripor_tpu_torch/ops/attend_reorder.py::step_attend_reorder_plain.
//
// For layer l and beam (b, n), with p = src[b, n] and s = t - 1:
//   cache_dst[l, b, n] = cache_src[l, b, p], slot s := step t-1's row
//     (kvg's layer-l row; quantized here for int8/int4 caches fed exact
//     rows, verbatim for exact caches and pre-quantized int8 rows);
//   attn[b, n] = attention over slots [0, t) of those rows plus position
//     t's own k/v, where slot s is read from kvg: exactly (bf16-rounded,
//     scale 1) in the in-kernel quantize mode, as the inserted row
//     otherwise. Nothing is inserted at t = 0, and with write_back = 0
//     (the final step) nothing is written to cache_dst.
// The attention is attend_core.cuh's attend_beam, with the reference's
// rounding points (bf16 products for bf16 and quantized caches, f32 for
// f32 caches).
//
// Bound on the H100: bytes. Per layer call it reads the source slabs
// (B*N*Mc*RW cache bytes at most) and writes as many, plus q, kv_new,
// kvg's layer slice and attn; ~4 flops per cache element is far under the
// ~300 flop/byte ridge. At t5-base, B=8, N=1000, Mc=32 that is ~1.6 GB
// (bf16 rows), ~0.85 GB (int8), ~0.46 GB (int4): 0.47 / 0.25 / 0.14 ms
// at 3.35 TB/s.
//
// Design: one block (256 threads) per beam, B*N = 8000 blocks at the main
// path's shape. 64-bit offsets throughout (the bf16 cache at that shape
// holds 4.7e9 elements). The block first copies its source slab to the
// destination with 16-byte vectors, consecutive threads on consecutive
// addresses, taking the insert span from kvg in the same pass (or
// skipping it for the codec, row_codec.cuh, to write after); then it runs
// the attention over the source slab, streaming slots from L2 without
// staging them (one beam's rows of one layer are up to 98 KB), so only
// q, kv_new and kvg's row sit in shared memory (< 48 KB at t5-base).
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "attend_core.cuh"
#include "row_codec.cuh"

using namespace ripor;

namespace {

constexpr int kThreads = 256;

// to[0, slab) = from[0, slab), except bytes [ins_lo, ins_lo + ins_bytes),
// which come from ins — or are left alone when ins is null.
__device__ __forceinline__ void copy_slab(const char* __restrict__ from,
                                          char* __restrict__ to,
                                          long long slab,
                                          const char* __restrict__ ins,
                                          long long ins_lo,
                                          long long ins_bytes, bool vec) {
  if (vec) {
    const long long n16 = slab / 16, lo16 = ins_lo / 16;
    const long long hi16 = lo16 + ins_bytes / 16;
    const uint4* f4 = reinterpret_cast<const uint4*>(from);
    const uint4* i4 = reinterpret_cast<const uint4*>(ins);
    uint4* t4 = reinterpret_cast<uint4*>(to);
    for (long long i = threadIdx.x; i < n16; i += blockDim.x) {
      if (i < lo16 || i >= hi16) t4[i] = f4[i];
      else if (ins) t4[i] = i4[i - lo16];
    }
  } else {
    const long long hi = ins_lo + ins_bytes;
    for (long long i = threadIdx.x; i < slab; i += blockDim.x) {
      if (i < ins_lo || i >= hi) to[i] = from[i];
      else if (ins) to[i] = ins[i - ins_lo];
    }
  }
}

// KIND: 0 exact rows (dtype T, RW = 2F), 1 int8 rows, 2 packed int4 rows.
// KVG_Q8: kvg holds int8 cache rows [L*RW] (KIND 1 only), else exact
// rows [L*2F] of T.
template <typename T, int KIND, bool KVG_Q8>
__global__ void __launch_bounds__(kThreads)
step_attend_reorder_kernel(const T* __restrict__ q,
                           const T* __restrict__ kv_new,
                           const char* __restrict__ kvg,
                           const char* __restrict__ cache_src,
                           char* __restrict__ cache_dst,
                           const int* __restrict__ src,
                           const float* __restrict__ bias_hist,
                           const float* __restrict__ bias_new,
                           T* __restrict__ attn, int N, long long BN, int L,
                           int Mc, int F, int H, int RW, int layer, int t,
                           int write_back, int vec) {
  constexpr bool RB = KIND != 0 || std::is_same<T, __nv_bfloat16>::value;
  // in-kernel quantize mode: exact kvg rows into a quantized cache
  constexpr bool OVR_EXACT = KIND != 0 && !KVG_Q8;
  extern __shared__ float sm[];
  float* qs = sm;                             // [F]   q in the dot dtype
  float* kvs = qs + F;                        // [2F]  kv_new as float
  float* kg = kvs + 2 * F;                    // [2F]  kvg's row (OVR_EXACT)
  float* sc = kg + (OVR_EXACT ? 2 * F : 0);   // [(Mc+1)*H]
  float* pe = sc + (Mc + 1) * H;              // [Mc*H]
  float* pn = pe + Mc * H;                    // [H]

  const long long beam = blockIdx.x;          // b * N + n
  const long long b = beam / N;
  const int tid = threadIdx.x;
  const long long row_bytes =
      KIND == 0 ? static_cast<long long>(RW) * sizeof(T) : RW;
  const long long slab = static_cast<long long>(Mc) * row_bytes;
  const long long lbn = static_cast<long long>(layer) * BN;
  const char* from = cache_src + (lbn + b * N + src[beam]) * slab;
  char* to = cache_dst + (lbn + beam) * slab;
  // step t-1's layer-l row: exact rows share the exact cache's row layout,
  // int8 kvg rows are int8 cache rows
  const long long kvg_row_bytes =
      KVG_Q8 ? static_cast<long long>(RW)
             : 2LL * F * static_cast<long long>(sizeof(T));
  const char* ins = kvg + (beam * L + layer) * kvg_row_bytes;
  const int slot = t - 1;                     // -1 at t == 0: no insert

  for (int i = tid; i < F; i += kThreads)
    qs[i] = rd<RB>(to_f(q[beam * F + i]));
  for (int i = tid; i < 2 * F; i += kThreads)
    kvs[i] = to_f(kv_new[beam * 2 * F + i]);
  if (OVR_EXACT)
    for (int i = tid; i < 2 * F; i += kThreads)
      kg[i] = to_f(reinterpret_cast<const T*>(ins)[i]);
  __syncthreads();

  if (write_back) {
    const long long ins_bytes = slot >= 0 ? row_bytes : 0;
    copy_slab(from, to, slab, OVR_EXACT ? nullptr : ins, slot * row_bytes,
              ins_bytes, vec);
    if (OVR_EXACT && slot >= 0)
      block_quant_row(kg, F, H, KIND,
                      reinterpret_cast<int8_t*>(to + slot * row_bytes));
  }

  const MergedRows<T, KIND, OVR_EXACT> view{from, row_bytes, F, H, slot,
                                            ins, kg};
  attend_beam<RB, KIND != 0>(view, qs, kvs, bias_hist, bias_new, Mc, F, H,
                             sc, pe, pn, attn + beam * F);
}

template <typename T, int KIND, bool KVG_Q8>
cudaError_t launch(const void* q, const void* kv_new, const void* kvg,
                   const void* cache_src, void* cache_dst, const void* src,
                   const void* bias_hist, const void* bias_new, void* attn,
                   long long B, long long N, int L, int Mc, int F, int H,
                   int RW, int layer, int t, int write_back,
                   cudaStream_t stream) {
  constexpr bool OVR_EXACT = KIND != 0 && !KVG_Q8;
  const size_t smem =
      sizeof(float) * ((OVR_EXACT ? 5 : 3) * static_cast<size_t>(F) +
                       attend_scratch_floats(Mc, H));
  auto kernel = step_attend_reorder_kernel<T, KIND, KVG_Q8>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long row_bytes =
      KIND == 0 ? static_cast<long long>(RW) * sizeof(T) : RW;
  const uintptr_t align = reinterpret_cast<uintptr_t>(kvg) |
                          reinterpret_cast<uintptr_t>(cache_src) |
                          reinterpret_cast<uintptr_t>(cache_dst);
  const int vec = (row_bytes % 16 == 0) && (align % 16 == 0);
  kernel<<<static_cast<unsigned>(B * N), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv_new),
      static_cast<const char*>(kvg), static_cast<const char*>(cache_src),
      static_cast<char*>(cache_dst), static_cast<const int*>(src),
      static_cast<const float*>(bias_hist),
      static_cast<const float*>(bias_new), static_cast<T*>(attn), int(N),
      B * N, L, Mc, F, H, RW, layer, t, write_back, vec);
  return cudaGetLastError();
}

}  // namespace

// kind: 0 exact, 1 int8, 2 int4; kvg_q8: kvg holds int8 cache rows (kind
// 1 only); is_f32: q/kv_new/attn (and exact rows and exact kvg) are
// float32, else bfloat16. cache_dst must not alias cache_src.
extern "C" int step_attend_reorder(
    const void* q, const void* kv_new, const void* kvg, const void* cache_src,
    void* cache_dst, const void* src, const void* bias_hist,
    const void* bias_new, void* attn, long long B, long long N, long long L,
    long long Mc, long long F, long long H, long long RW, long long layer,
    long long t, long long write_back, long long kind, long long kvg_q8,
    long long is_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (B * N == 0) return cudaSuccess;
#define RIPOR_LAUNCH(T, K, Q)                                               \
  err = launch<T, K, Q>(q, kv_new, kvg, cache_src, cache_dst, src,          \
                        bias_hist, bias_new, attn, B, N, int(L), int(Mc),   \
                        int(F), int(H), int(RW), int(layer), int(t),        \
                        int(write_back), s)
  if (is_f32) {
    if (kind == 0) RIPOR_LAUNCH(float, 0, false);
    else if (kind == 1 && kvg_q8) RIPOR_LAUNCH(float, 1, true);
    else if (kind == 1) RIPOR_LAUNCH(float, 1, false);
    else if (kind == 2) RIPOR_LAUNCH(float, 2, false);
  } else {
    if (kind == 0) RIPOR_LAUNCH(__nv_bfloat16, 0, false);
    else if (kind == 1 && kvg_q8) RIPOR_LAUNCH(__nv_bfloat16, 1, true);
    else if (kind == 1) RIPOR_LAUNCH(__nv_bfloat16, 1, false);
    else if (kind == 2) RIPOR_LAUNCH(__nv_bfloat16, 2, false);
  }
#undef RIPOR_LAUNCH
  return static_cast<int>(err);
}
