// K3: beam row gather, out[g, n] = x[g, src[g, n]].
//
// Replaces: ripor_tpu/ops/beam_gather.py::beam_gather_rows (Pallas
// _kernel, one HBM->HBM DMA per row). Plain version:
// ripor_tpu_torch/ops/beam_gather.py::beam_gather_rows_plain.
//
// Bound on the H100: bytes — 2*G*N*row_bytes (each row read once and
// written once). On the main path it permutes each step's QFUSE rows
// [B, N, L*RW]: at t5-base, B=8, N=1000, int4 rows (12*896 bytes) that is
// ~0.17 GB, ~51 us at 3.35 TB/s.
//
// Design: one block per output row (G*N = 8000 blocks on the main path);
// 16-byte vector copies with consecutive threads on consecutive
// addresses. A row width that is not a multiple of 16 bytes, or an
// unaligned base, takes the byte loop inside the kernel.
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
beam_gather_rows_kernel(const char* __restrict__ x,
                        const int* __restrict__ src, char* __restrict__ out,
                        int N, long long row_bytes, int vec) {
  const long long gn = blockIdx.x;  // g * N + n
  const long long g = gn / N;
  const char* from = x + (g * N + src[gn]) * row_bytes;
  char* to = out + gn * row_bytes;
  if (vec) {
    const uint4* f4 = reinterpret_cast<const uint4*>(from);
    uint4* t4 = reinterpret_cast<uint4*>(to);
    for (long long i = threadIdx.x; i < row_bytes / 16; i += kThreads)
      t4[i] = f4[i];
  } else {
    for (long long i = threadIdx.x; i < row_bytes; i += kThreads)
      to[i] = from[i];
  }
}

}  // namespace

extern "C" int beam_gather_rows(const void* x, const void* src, void* out,
                                long long G, long long N, long long row_bytes,
                                void* stream) {
  if (G * N == 0) return 0;
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out);
  const int vec = (row_bytes % 16 == 0) && (align % 16 == 0);
  beam_gather_rows_kernel<<<static_cast<unsigned>(G * N), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(x), static_cast<const int*>(src),
      static_cast<char*>(out), int(N), row_bytes, vec);
  return static_cast<int>(cudaGetLastError());
}
