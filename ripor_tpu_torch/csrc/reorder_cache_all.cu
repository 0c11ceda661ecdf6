// K1: all-layers beam reorder of the megarow KV cache, with the slot
// insert of step t-1's rows, in three bodies.
//
// Replaces: ripor_tpu/ops/megarow.py::reorder_cache_all (Pallas
// _reorder_kernel): its verbatim insert (QFUSE int8 rows, or exact rows
// into an exact cache; K1), its quantize-on-insert body (make_ins, exact
// rows into an int8 cache with QFUSE off; K1') and its fused-kvg body
// (kvg read through src; K1'').
// Plain version: ripor_tpu_torch/ops/megarow.py::reorder_cache_all_plain.
//
//   cache_dst[b, n, l] = cache_src[b, src[b, n], l]          (all Mc slots)
//   cache_dst[b, n, l, slot] = ins(kvg[b, r, l*krow : (l+1)*krow])
//     slot = max(t-1, 0); r = src[b, n] (fused) or n; ins = the row as
//     it is (verbatim) or quantized to an int8/int4 cache row
//     (row_codec.cuh quant_row, the codec K2 emits QFUSE rows with, so
//     K1' inserts the bytes QFUSE would have carried).
//
// Bound on the H100: bytes — a copy, 2*B*N*L*Mc*RW bytes per step (each
// cache byte read once and written once) plus the kvg read: at t5-base,
// B=8, N=1000, Mc=32, int4 rows ~5.5 GB, ~1.6 ms at 3.35 TB/s; K1' reads
// exact kvg rows, B*N*L*2F*2 bytes (0.29 GB) more.
//
// Design: one block per (beam, layer): its [Mc, RW] slab is contiguous in
// both source and destination (the beam-major layout exists for this),
// and B*N*L = 96,000 blocks at the main-path shape fill the card. Each
// thread moves 16-byte vectors with consecutive threads on consecutive
// addresses. In the verbatim bodies the 16-byte span that falls in the
// inserted slot is read from kvg instead, so the insert costs no extra
// pass. In the quantizing bodies the copy skips the slot, and the block's
// eight warps quantize its one kvg row (a warp per head group) and write
// it there. Row widths on the main path (1664 / 896 / 3072 bytes) are
// multiples of 16; any other width, or an unaligned base, takes the byte
// loop (the ragged case is handled inside the kernel, not by padding).
#include <cuda_bf16.h>
#include <stdint.h>

#include "row_codec.cuh"

namespace {

constexpr int kThreads = 256;

// KIND: 0 verbatim insert, 1 quantize to int8, 2 quantize to int4 (T: the
// exact kvg rows' type); FUSED: kvg is un-permuted, row src[b, n] is read.
template <int KIND, typename T, bool FUSED>
__global__ void __launch_bounds__(kThreads)
reorder_cache_all_kernel(const char* __restrict__ kvg,
                         const char* __restrict__ cache_src,
                         char* __restrict__ cache_dst,
                         const int* __restrict__ src, int N, int L, int Mc,
                         long long row_bytes, int slot, int vec, int F,
                         int H) {
  const long long bn = blockIdx.x;  // b * N + n
  const int l = blockIdx.y;
  const long long b = bn / N;
  const long long from_bn = b * N + src[bn];
  const long long slab = static_cast<long long>(Mc) * row_bytes;
  const char* from = cache_src + (from_bn * L + l) * slab;
  char* to = cache_dst + (bn * L + l) * slab;
  // one kvg row: the cache row (verbatim) or 2F exact values of T
  const long long krow_bytes =
      KIND == 0 ? row_bytes : 2LL * F * static_cast<long long>(sizeof(T));
  const char* ins = kvg + ((FUSED ? from_bn : bn) * L + l) * krow_bytes;
  const long long ins_lo = static_cast<long long>(slot) * row_bytes;
  if (vec) {
    const long long n16 = slab / 16, lo16 = ins_lo / 16;
    const long long hi16 = lo16 + row_bytes / 16;
    const uint4* f4 = reinterpret_cast<const uint4*>(from);
    const uint4* i4 = reinterpret_cast<const uint4*>(ins);
    uint4* t4 = reinterpret_cast<uint4*>(to);
    for (long long i = threadIdx.x; i < n16; i += kThreads) {
      const bool at = i >= lo16 && i < hi16;
      if constexpr (KIND == 0)
        t4[i] = at ? i4[i - lo16] : f4[i];
      else if (!at)
        t4[i] = f4[i];
    }
  } else {
    const long long hi = ins_lo + row_bytes;
    for (long long i = threadIdx.x; i < slab; i += kThreads) {
      const bool at = i >= ins_lo && i < hi;
      if constexpr (KIND == 0)
        to[i] = at ? ins[i - ins_lo] : from[i];
      else if (!at)
        to[i] = from[i];
    }
  }
  if constexpr (KIND != 0)
    ripor::quant_row(reinterpret_cast<const T*>(ins), F, H, KIND,
                     reinterpret_cast<int8_t*>(to + ins_lo), threadIdx.x,
                     kThreads);
}

template <int KIND, typename T, bool FUSED>
void launch(dim3 grid, cudaStream_t stream, const void* kvg,
            const void* cache_src, void* cache_dst, const void* src, int N,
            int L, int Mc, long long row_bytes, int slot, int vec, int F,
            int H) {
  reorder_cache_all_kernel<KIND, T, FUSED><<<grid, kThreads, 0, stream>>>(
      static_cast<const char*>(kvg), static_cast<const char*>(cache_src),
      static_cast<char*>(cache_dst), static_cast<const int*>(src), N, L, Mc,
      row_bytes, slot, vec, F, H);
}

}  // namespace

// kind: 0 verbatim (kvg rows in cache-row layout, row_bytes each), 1 and
// 2 quantize exact kvg rows of 2F values (float32 if is_f32, else bf16)
// into int8 / int4 cache rows with H heads; fused: kvg is un-permuted.
extern "C" int reorder_cache_all(const void* kvg, const void* cache_src,
                                 void* cache_dst, const void* src,
                                 long long B, long long N, long long L,
                                 long long Mc, long long row_bytes,
                                 long long slot, long long kind,
                                 long long is_f32, long long fused,
                                 long long F, long long H, void* stream) {
  if (B * N == 0 || L == 0) return 0;
  if (kind < 0 || kind > 2 || (kind != 0 && (H < 1 || F % H != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t align = reinterpret_cast<uintptr_t>(cache_src) |
                          reinterpret_cast<uintptr_t>(cache_dst) |
                          (kind == 0 ? reinterpret_cast<uintptr_t>(kvg) : 0);
  const int vec = (row_bytes % 16 == 0) && (align % 16 == 0);
  dim3 grid(static_cast<unsigned>(B * N), static_cast<unsigned>(L));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RIPOR_K1(K, T, FU)                                                 \
  launch<K, T, FU>(grid, s, kvg, cache_src, cache_dst, src, int(N), int(L), \
                   int(Mc), row_bytes, int(slot), vec, int(F), int(H))
#define RIPOR_K1_T(K, FU)                        \
  if (is_f32) RIPOR_K1(K, float, FU);            \
  else RIPOR_K1(K, __nv_bfloat16, FU)
#define RIPOR_K1_KIND(FU)                        \
  if (kind == 0) RIPOR_K1(0, char, FU);          \
  else if (kind == 1) { RIPOR_K1_T(1, FU); }     \
  else { RIPOR_K1_T(2, FU); }
  if (fused) {
    RIPOR_K1_KIND(true)
  } else {
    RIPOR_K1_KIND(false)
  }
#undef RIPOR_K1_KIND
#undef RIPOR_K1_T
#undef RIPOR_K1
  return static_cast<int>(cudaGetLastError());
}
