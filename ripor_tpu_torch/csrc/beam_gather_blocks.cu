// K7: beam reorder over blocks, out[g, n] = cache[g, src[g, n]], where
// each (g, n) holds an [R, C] block of any dtype.
//
// Replaces: ripor_tpu/ops/beam_gather.py::beam_gather_blocks (Pallas
// _kernel over [G, N, R, C]). Plain version:
// ripor_tpu_torch/ops/beam_gather.py::beam_gather_blocks_plain.
//
// Bound on the H100: bytes, a pure copy. Each output block is written once
// and its source block read once (fewer reads where several beams share a
// source). On the write-then-attend decode G = L*2*B, R = Mc, C = F: at
// t5-base, B=8, N=1000, Mc=32, bf16 that is up to 2 * 9.4 GB per step,
// ~5.6 ms at 3.35 TB/s.
//
// Design: K6 (beam_gather_update.cu) without the insert. One block per
// output block (G*N = 192,000 blocks at that shape), consecutive threads
// on consecutive vectors. The vector is the widest of 16, 8, 4, 2 and 1
// bytes that divides the block's bytes and both base addresses, so a
// narrow or ragged block stays in the kernel. Offsets are 64-bit (9.4e9
// bytes per cache). The output is a distinct buffer the caller owns (the
// decode swaps two by reference).
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// V: the copy vector; slab: one block's size in V units
template <typename V>
__global__ void __launch_bounds__(kThreads)
beam_gather_blocks_kernel(const V* __restrict__ cache,
                          const int* __restrict__ src, V* __restrict__ out,
                          int N, long long slab) {
  const long long gn = blockIdx.x;  // g * N + n
  const long long g = gn / N;
  const V* from = cache + (g * N + src[gn]) * slab;
  V* to = out + gn * slab;
#pragma unroll 4
  for (long long i = threadIdx.x; i < slab; i += kThreads) to[i] = from[i];
}

template <typename V>
cudaError_t launch(const void* cache, const void* src, void* out,
                   long long G, long long N, long long slab_bytes,
                   cudaStream_t stream) {
  beam_gather_blocks_kernel<V><<<static_cast<unsigned>(G * N), kThreads, 0,
                                 stream>>>(
      static_cast<const V*>(cache), static_cast<const int*>(src),
      static_cast<V*>(out), int(N),
      slab_bytes / static_cast<long long>(sizeof(V)));
  return cudaGetLastError();
}

}  // namespace

// slab_bytes: bytes of one [R, C] block.
extern "C" int beam_gather_blocks(const void* cache, const void* src,
                                  void* out, long long G, long long N,
                                  long long slab_bytes, void* stream) {
  if (G * N == 0 || slab_bytes == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(cache) |
                          reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(slab_bytes);
  cudaError_t err;
  if (align % 16 == 0)
    err = launch<uint4>(cache, src, out, G, N, slab_bytes, s);
  else if (align % 8 == 0)
    err = launch<uint2>(cache, src, out, G, N, slab_bytes, s);
  else if (align % 4 == 0)
    err = launch<unsigned int>(cache, src, out, G, N, slab_bytes, s);
  else if (align % 2 == 0)
    err = launch<unsigned short>(cache, src, out, G, N, slab_bytes, s);
  else
    err = launch<unsigned char>(cache, src, out, G, N, slab_bytes, s);
  return static_cast<int>(err);
}
