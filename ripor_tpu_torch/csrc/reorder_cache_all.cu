// K1: all-layers beam reorder of the megarow KV cache, with the slot
// insert of step t-1's rows.
//
// Replaces: ripor_tpu/ops/megarow.py::reorder_cache_all (Pallas
// _reorder_kernel), on its verbatim-insert (QFUSE / exact-row) branch.
// Plain version: ripor_tpu_torch/ops/megarow.py::reorder_cache_all_plain.
//
//   cache_dst[b, n, l] = cache_src[b, src[b, n], l]        (all Mc slots)
//   cache_dst[b, n, l, slot] = kvg[b, n, l*RW : (l+1)*RW]  (slot = max(t-1, 0))
//
// Bound on the H100: bytes — a pure copy, 2*B*N*L*Mc*RW bytes per step
// (each cache byte read once and written once) plus the small kvg read.
// At t5-base, B=8, N=1000, Mc=32, int4 rows: ~5.5 GB, ~1.6 ms at
// 3.35 TB/s.
//
// Design: one block per (beam, layer): its [Mc, RW] slab is contiguous in
// both source and destination (the beam-major layout exists for this),
// and B*N*L = 96,000 blocks at the main-path shape fill the card. Each
// thread moves 16-byte vectors with consecutive threads on consecutive
// addresses; the 16-byte span that falls in the inserted slot is read
// from kvg instead, so the insert costs no extra pass. Row widths on the
// main path (1664 / 896 / 3072 bytes) are multiples of 16; any other
// width, or an unaligned base, takes the byte loop (the ragged case is
// handled inside the kernel, not by padding).
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
reorder_cache_all_kernel(const char* __restrict__ kvg,
                         const char* __restrict__ cache_src,
                         char* __restrict__ cache_dst,
                         const int* __restrict__ src, int N, int L, int Mc,
                         long long row_bytes, int slot, int vec) {
  const long long bn = blockIdx.x;  // b * N + n
  const int l = blockIdx.y;
  const long long b = bn / N;
  const long long from_bn = b * N + src[bn];
  const long long slab = static_cast<long long>(Mc) * row_bytes;
  const char* from = cache_src + (from_bn * L + l) * slab;
  char* to = cache_dst + (bn * L + l) * slab;
  const char* ins = kvg + (bn * L + l) * row_bytes;
  const long long ins_lo = static_cast<long long>(slot) * row_bytes;
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

extern "C" int reorder_cache_all(const void* kvg, const void* cache_src,
                                 void* cache_dst, const void* src,
                                 long long B, long long N, long long L,
                                 long long Mc, long long row_bytes,
                                 long long slot, void* stream) {
  if (B * N == 0 || L == 0) return 0;
  const uintptr_t align = reinterpret_cast<uintptr_t>(kvg) |
                          reinterpret_cast<uintptr_t>(cache_src) |
                          reinterpret_cast<uintptr_t>(cache_dst);
  const int vec = (row_bytes % 16 == 0) && (align % 16 == 0);
  dim3 grid(static_cast<unsigned>(B * N), static_cast<unsigned>(L));
  reorder_cache_all_kernel<<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(kvg), static_cast<const char*>(cache_src),
      static_cast<char*>(cache_dst), static_cast<const int*>(src), int(N),
      int(L), int(Mc), row_bytes, int(slot), vec);
  return static_cast<int>(cudaGetLastError());
}
