// K8: one-position self-attention over separate K and V caches whose slot
// t already holds position t's k/v (the write-then-attend decode).
//
// Replaces: ripor_tpu/ops/step_attention.py::step_attention (Pallas
// _kernel). Plain version:
// ripor_tpu_torch/ops/step_attention.py::step_attention_plain.
//
// For beam (b, n) and head h: scores of q against cache_k[b, n] over the Mc
// slots plus bias[:, h] (relpos, slots > t masked), softmax over the Mc
// slots in f32, probabilities rounded to q's dtype (the reference's
// probs.astype(q.dtype)), then the weighted sum of cache_v[b, n] in f32,
// cast to q's dtype. The k*q products are f32 products, exact for bf16
// inputs as on the reference's matrix unit; nothing else is rounded.
//
// Bound on the H100: bytes. A call reads both caches (2*B*N*Mc*F elements)
// and q and writes the output; ~4 flops per cache element is far under the
// ~295 flop/byte ridge. At t5-base, B=8, N=1000, Mc=32, bf16: ~0.81 GB,
// ~0.242 ms at 3.35 TB/s.
//
// Design: attend_staged.cuh (attend_planes, exact products, no position-t
// term, probabilities rounded for bf16 caches). Persistent blocks stage
// each beam's K and V rows (two bulk async copies) and q into a ring of
// stages; planes larger than one stage (t5-large in f32, t5-3b in bf16)
// stream in slot chunks.
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "attend_staged.cuh"

using namespace ripor;
using namespace ripor::staged;

namespace {

// K5's argument list (launch_planes launches both); K8 has no k_new, v_new
// or bias_new
template <typename T, bool CHUNKED>
__global__ void __launch_bounds__(kThreads, CHUNKED ? 1 : kMinBlocks)
step_attention_kernel(const T* __restrict__ q, const T* __restrict__ unused_k,
                      const T* __restrict__ unused_v,
                      const char* __restrict__ cache_k,
                      const char* __restrict__ cache_v,
                      const float* __restrict__ bias,
                      const float* __restrict__ unused_bias,
                      T* __restrict__ out, long long BN, int Mc, int F, int H,
                      int mcs, Layout lay, int stages, int vec, int bulk) {
  constexpr bool kRoundProbs = std::is_same<T, __nv_bfloat16>::value;
  attend_planes<T, false, kRoundProbs, CHUNKED>(
      q, nullptr, nullptr, cache_k, cache_v, bias, nullptr, out, BN, Mc, F, H,
      mcs, lay, stages, vec, bulk);
}

}  // namespace

// is_f32: q, the caches and out are float32, else bfloat16; bias is f32.
// mcs (slots a stage holds), stages and smem: the launch plan of
// ripor_tpu_torch/ops/staging.py.
extern "C" int step_attention(const void* q, const void* cache_k,
                              const void* cache_v, const void* bias,
                              void* out, long long BN, long long Mc,
                              long long F, long long H, long long is_f32,
                              long long mcs, long long stages, long long smem,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BN == 0) return cudaSuccess;
  const char* k = static_cast<const char*>(cache_k);
  const char* v = static_cast<const char*>(cache_v);
  cudaError_t err =
      is_f32 ? launch_planes<float>(step_attention_kernel<float, false>,
                                    step_attention_kernel<float, true>, q,
                                    nullptr, nullptr, k, v, bias, nullptr,
                                    out, BN, int(Mc), int(F), int(H), mcs,
                                    stages, smem, false, s)
             : launch_planes<__nv_bfloat16>(
                   step_attention_kernel<__nv_bfloat16, false>,
                   step_attention_kernel<__nv_bfloat16, true>, q, nullptr,
                   nullptr, k, v, bias, nullptr, out, BN, int(Mc), int(F),
                   int(H), mcs, stages, smem, false, s);
  return static_cast<int>(err);
}
