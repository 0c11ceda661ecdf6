// K5: one-position self-attention for one layer over the stacked
// [L, 2, B, N, Mc, F] cache, with position t's own k/v folded in (the
// non-deferred decode).
//
// Replaces: ripor_tpu/ops/step_attention.py::step_attention_fused (Pallas
// _fused_kernel). Plain version:
// ripor_tpu_torch/ops/step_attention.py::step_attention_fused_plain.
//
// For beam (b, n): scores of q against the K plane cache[l, 0, b, n] over
// the Mc slots (slots >= t are masked by bias_hist) and against k_new;
// softmax over the Mc + 1 positions; weighted sum of the V plane
// cache[l, 1, b, n] and v_new. All math is f32, whatever the input dtype
// (the reference's kernel computes in f32 throughout): the k*q products of
// bf16 values are exact f32 products, nothing is rounded to bf16 but the
// output, which is in q's dtype.
//
// Bound on the H100: bytes. Per layer call it reads the layer's K and V
// planes (2*B*N*Mc*F elements) plus q, k_new, v_new and writes attn; ~4
// flops per cache element is far under the ~295 flop/byte ridge. At
// t5-base, B=8, N=1000, Mc=32, bf16: ~0.84 GB, ~0.249 ms at 3.35 TB/s.
//
// Design: attend_staged.cuh (attend_planes, exact products, NEW). The
// layer's K and V planes are [B*N, Mc, F] each, B*N*Mc*F elements apart
// (offsets are 64-bit: the bf16 cache at t5-base holds 4.7e9 elements);
// persistent blocks stage each beam's two planes with two bulk async
// copies, plus q, k_new and v_new, into a ring of stages; planes larger
// than one stage (t5-large in f32, t5-3b in bf16) stream in slot chunks.
#include <cuda_bf16.h>
#include <stdint.h>

#include "attend_staged.cuh"

using namespace ripor;
using namespace ripor::staged;

namespace {

template <typename T, bool CHUNKED>
__global__ void __launch_bounds__(kThreads, CHUNKED ? 1 : kMinBlocks)
step_attention_fused_kernel(const T* __restrict__ q,
                            const T* __restrict__ k_new,
                            const T* __restrict__ v_new,
                            const char* __restrict__ kplanes,
                            const char* __restrict__ vplanes,
                            const float* __restrict__ bias_hist,
                            const float* __restrict__ bias_new,
                            T* __restrict__ attn, long long BN, int Mc, int F,
                            int H, int mcs, Layout lay, int stages, int vec,
                            int bulk) {
  attend_planes<T, true, false, CHUNKED>(q, k_new, v_new, kplanes, vplanes,
                                         bias_hist, bias_new, attn, BN, Mc, F,
                                         H, mcs, lay, stages, vec, bulk);
}

template <typename T>
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   const void* cache, const void* bias_hist,
                   const void* bias_new, void* attn, long long BN, int Mc,
                   int F, int H, int layer, long long mcs, long long stages,
                   long long smem, cudaStream_t stream) {
  // layer l's K planes [l, 0] and V planes [l, 1], B*N planes each
  const long long planes = BN * Mc * static_cast<long long>(F) * sizeof(T);
  const char* k = static_cast<const char*>(cache) + 2LL * layer * planes;
  return launch_planes<T>(step_attention_fused_kernel<T, false>,
                          step_attention_fused_kernel<T, true>, q, k_new,
                          v_new, k, k + planes, bias_hist, bias_new, attn, BN,
                          Mc, F, H, mcs, stages, smem, true, stream);
}

}  // namespace

// is_f32: every tensor but the biases is float32, else bfloat16. mcs (slots
// a stage holds), stages and smem: the launch plan of
// ripor_tpu_torch/ops/staging.py.
extern "C" int step_attention_fused(const void* q, const void* k_new,
                                    const void* v_new, const void* cache,
                                    const void* bias_hist,
                                    const void* bias_new, void* attn,
                                    long long BN, long long Mc, long long F,
                                    long long H, long long layer,
                                    long long is_f32, long long mcs,
                                    long long stages, long long smem,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BN == 0) return cudaSuccess;
  cudaError_t err =
      is_f32 ? launch<float>(q, k_new, v_new, cache, bias_hist, bias_new,
                             attn, BN, int(Mc), int(F), int(H), int(layer),
                             mcs, stages, smem, s)
             : launch<__nv_bfloat16>(q, k_new, v_new, cache, bias_hist,
                                     bias_new, attn, BN, int(Mc), int(F),
                                     int(H), int(layer), mcs, stages, smem,
                                     s);
  return static_cast<int>(err);
}
