// K8: one-position self-attention over separate K and V caches whose slot
// t already holds position t's k/v (the write-then-attend decode).
//
// Replaces: ripor_tpu/ops/step_attention.py::step_attention (Pallas
// _kernel). Plain version:
// ripor_tpu_torch/ops/step_attention.py::step_attention_plain.
//
// For beam (b, n) and head h: scores of q against cache_k[b, n] over the
// Mc slots plus bias[:, h] (relpos, slots > t masked), softmax over the Mc
// slots in f32, probabilities rounded to q's dtype (the reference's
// probs.astype(q.dtype)), then the weighted sum of cache_v[b, n] in f32,
// cast to q's dtype. The k*q products are plain f32 products, exact for
// bf16 inputs as on the reference's matrix unit; nothing else is rounded.
//
// Bound on the H100: bytes. A call reads both caches (2*B*N*Mc*F elements)
// and q and writes the output; ~4 flops per cache element is far under the
// ~300 flop/byte ridge. At t5-base, B=8, N=1000, Mc=32, bf16: ~0.81 GB,
// ~0.24 ms at 3.35 TB/s.
//
// Design: one block (256 threads) per beam, running attend_core.cuh's
// attend_beam with no position-t term (NEW = false) and the probabilities
// rounded to bf16 for bf16 caches (RP), over a K-plane / V-plane accessor:
// one warp per (slot, head) score, consecutive lanes on consecutive
// columns of the K row; one thread per output column for the V sum,
// coalesced across the block. Offsets are 64-bit. q sits in shared memory
// as floats.
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "attend_core.cuh"

using namespace ripor;

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
step_attention_kernel(const T* __restrict__ q, const T* __restrict__ cache_k,
                      const T* __restrict__ cache_v,
                      const float* __restrict__ bias, T* __restrict__ out,
                      int Mc, int F, int H) {
  extern __shared__ float sm[];
  float* qs = sm;                     // [F]
  float* sc = qs + F;                 // [(Mc+1)*H], slot Mc unused
  float* pe = sc + (Mc + 1) * H;      // [Mc*H]
  float* pn = pe + Mc * H;            // [H], unused

  const long long beam = blockIdx.x;
  for (int i = threadIdx.x; i < F; i += kThreads) qs[i] = to_f(q[beam * F + i]);
  __syncthreads();

  const long long plane = static_cast<long long>(Mc) * F;
  const PlaneRows<T> view{cache_k + beam * plane, cache_v + beam * plane, F};
  constexpr bool kRoundProbs = std::is_same<T, __nv_bfloat16>::value;
  attend_beam<false, false, T, PlaneRows<T>, false, kRoundProbs>(
      view, qs, nullptr, bias, nullptr, Mc, F, H, sc, pe, pn,
      out + beam * F);
}

template <typename T>
cudaError_t launch(const void* q, const void* cache_k, const void* cache_v,
                   const void* bias, void* out, long long BN, int Mc, int F,
                   int H, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(F) + attend_scratch_floats(Mc, H));
  auto kernel = step_attention_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(BN), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(cache_k),
      static_cast<const T*>(cache_v), static_cast<const float*>(bias),
      static_cast<T*>(out), Mc, F, H);
  return cudaGetLastError();
}

}  // namespace

// is_f32: q, the caches and out are float32, else bfloat16; bias is f32.
extern "C" int step_attention(const void* q, const void* cache_k,
                              const void* cache_v, const void* bias,
                              void* out, long long BN, long long Mc,
                              long long F, long long H, long long is_f32,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BN == 0) return cudaSuccess;
  cudaError_t err =
      is_f32 ? launch<float>(q, cache_k, cache_v, bias, out, BN, int(Mc),
                             int(F), int(H), s)
             : launch<__nv_bfloat16>(q, cache_k, cache_v, bias, out, BN,
                                     int(Mc), int(F), int(H), s);
  return static_cast<int>(err);
}
