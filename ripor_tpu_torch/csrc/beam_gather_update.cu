// K6: beam reorder of the stacked cache with the position-t insert,
// out[g, n] = cache[g, src[g, n]] with slot t := kv_gathered[g, n].
//
// Replaces: ripor_tpu/ops/beam_gather.py::beam_gather_update (Pallas
// _gather_update_kernel and its aliased twin). Plain version:
// ripor_tpu_torch/ops/beam_gather.py::beam_gather_update_plain.
//
// Bound on the H100: bytes — a pure copy. Each output block of R*C
// elements is written once and its source block read once (fewer reads
// where several beams share a source), plus the small kv_gathered read.
// On the non-deferred decode G = L*2*B: at t5-base, B=8, N=1000, Mc=32,
// bf16 that is up to 2 * 9.4 GB per step, ~5.6 ms at 3.35 TB/s.
//
// Design: one block per output block (G*N = 192,000 blocks at that
// shape), 16-byte vector copies with consecutive threads on consecutive
// addresses; the 16-byte spans of slot t are read from kv_gathered in the
// same pass, so the insert costs no extra pass. Offsets are 64-bit (9.4e9
// bytes per cache). A row width that is not a multiple of 16 bytes, or an
// unaligned base, takes the byte loop inside the kernel. The output is a
// distinct buffer the caller owns (the decode swaps two by reference).
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
beam_gather_update_kernel(const char* __restrict__ cache,
                          const char* __restrict__ kvg,
                          const int* __restrict__ src, char* __restrict__ out,
                          int N, long long R, long long row_bytes, int t,
                          int vec) {
  const long long gn = blockIdx.x;  // g * N + n
  const long long g = gn / N;
  const long long slab = R * row_bytes;
  const char* from = cache + (g * N + src[gn]) * slab;
  char* to = out + gn * slab;
  const char* ins = kvg + gn * row_bytes;
  const long long ins_lo = static_cast<long long>(t) * row_bytes;
  if (vec) {
    const long long n16 = slab / 16, lo16 = ins_lo / 16;
    const long long hi16 = lo16 + row_bytes / 16;
    const uint4* f4 = reinterpret_cast<const uint4*>(from);
    const uint4* i4 = reinterpret_cast<const uint4*>(ins);
    uint4* t4 = reinterpret_cast<uint4*>(to);
    for (long long i = threadIdx.x; i < n16; i += kThreads)
      t4[i] = (i >= lo16 && i < hi16) ? i4[i - lo16] : f4[i];
  } else {
    const long long hi = ins_lo + row_bytes;
    for (long long i = threadIdx.x; i < slab; i += kThreads)
      to[i] = (i >= ins_lo && i < hi) ? ins[i - ins_lo] : from[i];
  }
}

}  // namespace

extern "C" int beam_gather_update(const void* cache, const void* kvg,
                                  const void* src, void* out, long long G,
                                  long long N, long long R,
                                  long long row_bytes, long long t,
                                  void* stream) {
  if (G * N == 0) return 0;
  const uintptr_t align = reinterpret_cast<uintptr_t>(cache) |
                          reinterpret_cast<uintptr_t>(kvg) |
                          reinterpret_cast<uintptr_t>(out);
  const int vec = (row_bytes % 16 == 0) && (align % 16 == 0);
  beam_gather_update_kernel<<<static_cast<unsigned>(G * N), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(cache), static_cast<const char*>(kvg),
      static_cast<const int*>(src), static_cast<char*>(out), int(N), R,
      row_bytes, int(t), vec);
  return static_cast<int>(cudaGetLastError());
}
