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
// (the reference's kernel computes in f32 throughout); the output is in
// q's dtype.
//
// Bound on the H100: bytes. Per layer call it reads the layer's K and V
// planes (2*B*N*Mc*F elements) plus q, k_new, v_new and writes attn; ~4
// flops per cache element is far under the ~300 flop/byte ridge. At
// t5-base, B=8, N=1000, Mc=32, bf16: ~0.79 GB, ~0.235 ms at 3.35 TB/s.
//
// Design: one block (256 threads) per beam, running attend_core.cuh's
// attend_beam with RB = false over a K-plane / V-plane accessor: one warp
// per (slot, head) score, consecutive lanes on consecutive columns of the
// K row; one thread per output column for the V sum, coalesced across the
// block. Offsets are 64-bit (the bf16 cache at that shape holds 4.7e9
// elements). q, k_new and v_new sit in shared memory as floats.
#include <cuda_bf16.h>
#include <stdint.h>

#include "attend_core.cuh"

using namespace ripor;

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
step_attention_fused_kernel(const T* __restrict__ q,
                            const T* __restrict__ k_new,
                            const T* __restrict__ v_new,
                            const T* __restrict__ cache,
                            const float* __restrict__ bias_hist,
                            const float* __restrict__ bias_new,
                            T* __restrict__ attn, long long BN, int Mc,
                            int F, int H, int layer) {
  extern __shared__ float sm[];
  float* qs = sm;                     // [F]
  float* kvs = qs + F;                // [2F]  k_new then v_new
  float* sc = kvs + 2 * F;            // [(Mc+1)*H]
  float* pe = sc + (Mc + 1) * H;      // [Mc*H]
  float* pn = pe + Mc * H;            // [H]

  const long long beam = blockIdx.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < F; i += kThreads) {
    qs[i] = to_f(q[beam * F + i]);
    kvs[i] = to_f(k_new[beam * F + i]);
    kvs[F + i] = to_f(v_new[beam * F + i]);
  }
  __syncthreads();

  const long long plane = static_cast<long long>(Mc) * F;
  const long long kplane = 2LL * layer * BN + beam;   // [l, 0, b, n]
  const PlaneRows<T> view{cache + kplane * plane,
                          cache + (kplane + BN) * plane, F};
  attend_beam<false, false>(view, qs, kvs, bias_hist, bias_new, Mc, F, H,
                            sc, pe, pn, attn + beam * F);
}

template <typename T>
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   const void* cache, const void* bias_hist,
                   const void* bias_new, void* attn, long long BN, int Mc,
                   int F, int H, int layer, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * static_cast<size_t>(F) +
                                       attend_scratch_floats(Mc, H));
  auto kernel = step_attention_fused_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(BN), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<const T*>(cache),
      static_cast<const float*>(bias_hist),
      static_cast<const float*>(bias_new), static_cast<T*>(attn), BN, Mc, F,
      H, layer);
  return cudaGetLastError();
}

}  // namespace

// is_f32: every tensor but the biases is float32, else bfloat16.
extern "C" int step_attention_fused(const void* q, const void* k_new,
                                    const void* v_new, const void* cache,
                                    const void* bias_hist,
                                    const void* bias_new, void* attn,
                                    long long BN, long long Mc, long long F,
                                    long long H, long long layer,
                                    long long is_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BN == 0) return cudaSuccess;
  cudaError_t err =
      is_f32 ? launch<float>(q, k_new, v_new, cache, bias_hist, bias_new,
                             attn, BN, int(Mc), int(F), int(H), int(layer), s)
             : launch<__nv_bfloat16>(q, k_new, v_new, cache, bias_hist,
                                     bias_new, attn, BN, int(Mc), int(F),
                                     int(H), int(layer), s);
  return static_cast<int>(err);
}
