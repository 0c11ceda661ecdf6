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
// q and kv_new are staged once in shared memory as floats; the attention
// is attend_core.cuh's attend_beam (shared with K4 and K5): one warp per
// (slot, head) score, one warp per head softmax, one thread per output
// column for the V sum. Simple and right first: no tensor cores, no TMA,
// each row read twice (scores, then V) from L2.
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "attend_core.cuh"
#include "row_codec.cuh"

using namespace ripor;

namespace {

constexpr int kThreads = 256;

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
  float* qs = sm;                     // [F]   q in the dot dtype
  float* kvs = qs + F;                // [2F]  kv_new as float
  float* sc = kvs + 2 * F;            // [(Mc+1)*H] scores, then probs
  float* pe = sc + (Mc + 1) * H;      // [Mc*H] prob (* V scale), dot dtype
  float* pn = pe + Mc * H;            // [H]   new-position prob, dot dtype

  const long long beam = blockIdx.x;
  const int tid = threadIdx.x;
  const long long row_bytes =
      KIND == 0 ? static_cast<long long>(RW) * sizeof(T) : RW;
  const char* rows = static_cast<const char*>(cache) +
                     (beam * L + layer) * static_cast<long long>(Mc) *
                         row_bytes;

  for (int i = tid; i < F; i += kThreads)
    qs[i] = rd<RB>(to_f(q[beam * F + i]));
  for (int i = tid; i < 2 * F; i += kThreads)
    kvs[i] = to_f(kv_new[beam * 2 * F + i]);
  __syncthreads();

  const MergedRows<T, KIND, false> view{rows, row_bytes, F, H, -1, nullptr,
                                        nullptr};
  attend_beam<RB, KIND != 0>(view, qs, kvs, bias_hist, bias_new, Mc, F, H,
                             sc, pe, pn, attn + beam * F);

  if (KIND != 0 && emit) block_quant_row(kvs, F, H, KIND, kvq + beam * RW);
}

template <typename T, int KIND>
cudaError_t launch(const void* q, const void* kv_new, const void* cache,
                   const void* bias_hist, const void* bias_new, void* attn,
                   void* kvq, long long BN, int L, int Mc, int F, int H,
                   int RW, int layer, int emit, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * static_cast<size_t>(F) +
                                       attend_scratch_floats(Mc, H));
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
