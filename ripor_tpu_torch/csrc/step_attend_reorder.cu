// K4: per-layer beam reorder of the K|V-merged cache with the slot t-1
// insert, fused with one-position self-attention (the deferred decode).
//
// Replaces: ripor_tpu/ops/attend_reorder.py::step_attend_reorder (Pallas
// _kernel, math _attn_math / _attn_math_q8 / _attn_math_q4). Plain
// version: ripor_tpu_torch/ops/attend_reorder.py::step_attend_reorder_plain.
//
// For layer l and beam (b, n), with p = src[b, n] and s = t - 1:
//   cache_dst[l, b, n] = cache_src[l, b, p], slot s := step t-1's row
//     (kvg's layer-l row; quantized here for int8/int4 caches fed exact
//     rows, verbatim for exact caches and pre-quantized int8 rows);
//   attn[b, n] = attention over slots [0, t) of those rows plus position
//     t's own k/v, where slot s is read from kvg: exactly (bf16-rounded,
//     scale 1) in the in-kernel quantize mode, as the inserted row
//     otherwise. Nothing is inserted at t = 0, and with write_back = 0
//     (the final step) nothing is written to cache_dst.
//
// Bound on the H100: bytes. Per layer call it reads the source slabs
// (B*N*Mc*RW cache bytes at most) and writes as many, plus q, kv_new,
// kvg's layer slice and attn; ~4 flops per cache element. At t5-base,
// B=8, N=1000, Mc=32 that is ~1.6 GB (bf16 rows), ~0.85 GB (int8), ~0.46
// GB (int4): 0.47 / 0.25 / 0.14 ms at 3.35 TB/s.
//
// Design: attend_staged.cuh. The producer warp stages the source slab
// cache_src[l, b, src[b, n]] with bulk async copies; a verbatim insert is
// a third bulk copy, of kvg's row straight into slot s, between the two
// halves of the slab. In the quantize mode kvg's row is staged beside the
// slab and the consumers quantize it into slot s (quant_row) while the
// scores run, then fence it for the async proxy. One bulk store writes
// the patched slab to cache_dst (early when nothing is patched by
// threads), and the stage is released only after the store has read it.
// Every cache byte is read from HBM once and written once. A slab larger
// than one stage streams through the ring in slot chunks, twice: the score
// pass stores each chunk (slot s patched in the chunk that holds it), the V
// pass reads the chunks again and stores nothing.
#include <cuda_bf16.h>
#include <stdint.h>

#include "attend_staged.cuh"
#include "row_codec.cuh"

using namespace ripor;
using namespace ripor::staged;

namespace {

// KIND: 0 exact rows (dtype T, RW = 2F), 1 int8 rows, 2 packed int4 rows.
// KVG_Q8: kvg holds int8 cache rows [L*RW] (KIND 1 only), else exact
// rows [L*2F] of T. CHUNKED: the slab streams in slot chunks of mcs slots.
template <typename T, int KIND, bool KVG_Q8, bool CHUNKED>
__global__ void __launch_bounds__(kThreads, CHUNKED ? 1 : kMinBlocks)
step_attend_reorder_kernel(const T* __restrict__ q,
                           const T* __restrict__ kv_new,
                           const char* __restrict__ kvg,
                           const char* __restrict__ cache_src,
                           char* __restrict__ cache_dst,
                           const int* __restrict__ src,
                           const float* __restrict__ bias_hist,
                           const float* __restrict__ bias_new,
                           T* __restrict__ attn, int N, long long BN, int L,
                           int Mc, int F, int H, int RW, int layer, int t,
                           int write_back, int mcs, Layout lay, int stages,
                           int vec, int bulk) {
  // in-kernel quantize mode: exact kvg rows into a quantized cache
  constexpr bool OVR_EXACT = KIND != 0 && !KVG_Q8;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  const int tid = threadIdx.x, lane = tid & 31;
  const long long row_bytes =
      KIND == 0 ? static_cast<long long>(RW) * sizeof(T) : RW;
  const long long slab = Mc * row_bytes;
  const long long lbn = static_cast<long long>(layer) * BN;
  // step t-1's layer-l row: exact rows share the exact cache's row layout,
  // int8 kvg rows are int8 cache rows
  const long long kvg_row_bytes =
      KVG_Q8 ? static_cast<long long>(RW)
             : 2LL * F * static_cast<long long>(sizeof(T));
  const int slot = t - 1;                     // -1 at t == 0: no insert
  const bool patch = OVR_EXACT && slot >= 0;  // slot s written by threads
  const Chunks<CHUNKED> ch(Mc, mcs);

  init_barriers(full, empty, stages);
  stage_biases(reinterpret_cast<float*>(smem + lay.bias), bias_hist, bias_new,
               Mc, H);
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp
    int i = 0;
    for (long long beam = blockIdx.x; beam < BN; beam += gridDim.x) {
      const char* from = cache_src + (lbn + beam / N * N + src[beam]) * slab;
      const char* ins = kvg + (beam * L + layer) * kvg_row_bytes;
      for (int j = 0; j < ch.loads(); ++j, ++i) {
        const int s = i % stages;
        if (i >= stages) mbar_wait(&empty[s], ((i / stages) - 1) & 1);
        unsigned char* st = smem + lay.stage0 + s * lay.stage_bytes;
        const long long qb = static_cast<long long>(F) * sizeof(T);
        const int m0 = ch.m0(j), m1 = ch.m1(j);
        const long long cb = (m1 - m0) * row_bytes;
        const char* at = from + m0 * row_bytes;
        if (bulk && lane == 0)
          mbar_arrive_tx(&full[s], static_cast<uint32_t>(
                                       cb + 3 * qb + (patch ? 2 * qb : 0)));
        if (!OVR_EXACT && slot >= m0 && slot < m1) {
          // verbatim insert into slot s
          const long long lo = (slot - m0) * row_bytes;
          stage_in(st + lay.slab, at, lo, &full[s], bulk, lane);
          stage_in(st + lay.slab + lo, ins, row_bytes, &full[s], bulk, lane);
          stage_in(st + lay.slab + lo + row_bytes, at + lo + row_bytes,
                   cb - lo - row_bytes, &full[s], bulk, lane);
        } else {
          stage_in(st + lay.slab, at, cb, &full[s], bulk, lane);
        }
        if (patch) stage_in(st + lay.kg, ins, 2 * qb, &full[s], bulk, lane);
        stage_in(st + lay.q, q + beam * F, qb, &full[s], bulk, lane);
        stage_in(st + lay.kvn, kv_new + beam * 2 * F, 2 * qb, &full[s], bulk,
                 lane);
        stage_done(&full[s], bulk, lane);
      }
    }
    return;
  }

  const Core<T, KIND> core{lay, smem, Dims{Mc, F, H, F / H, row_bytes,
                                           vec != 0}};
  int i = 0;
  for (long long beam = blockIdx.x; beam < BN; beam += gridDim.x) {
    for (int j = 0; j < ch.loads(); ++j, ++i) {
      const int s = i % stages;
      mbar_wait(&full[s], (i / stages) & 1);
      unsigned char* st = smem + lay.stage0 + s * lay.stage_bytes;
      char* stage_slab = reinterpret_cast<char*>(st + lay.slab);
      const int m0 = ch.m0(j), m1 = ch.m1(j);
      const Beam<T> b{stage_slab, stage_slab,
                      reinterpret_cast<const T*>(st + lay.q),
                      reinterpret_cast<const T*>(st + lay.kvn),
                      patch ? reinterpret_cast<const T*>(st + lay.kg)
                            : nullptr,
                      patch ? slot : -1, m0};
      // the score pass stores its rows (the V pass stores nothing); the
      // chunk holding slot s is patched first in the quantize mode
      const bool store = write_back && ch.scores(j);
      const bool patch_here = patch && slot >= m0 && slot < m1;
      auto store_rows = [&]() {
        char* to = cache_dst + (lbn + beam) * slab + m0 * row_bytes;
        const uint32_t cb = static_cast<uint32_t>((m1 - m0) * row_bytes);
        if (bulk) {
          bulk_store(to, stage_slab, cb);
        } else {
          for (long long k = tid; k < cb; k += kConsumers)
            to[k] = stage_slab[k];
        }
      };
      if (store && bulk && !patch_here && tid == 0) {
        // the rows as loaded are the destination's: store them at once
        fence_proxy_async();
        store_rows();
      }
      if (ch.scores(j)) {
        if (ch.first(j)) core.prologue(b, tid);
        core.score_rows(b, tid, m1, ch.last(j), b.kg,
                        store && patch_here
                            ? reinterpret_cast<int8_t*>(
                                  stage_slab + (slot - m0) * row_bytes)
                            : nullptr);
        // slot s is patched and fenced (score_rows ends on a consumer
        // barrier)
        if (store && ((patch_here && bulk && tid == 0) || !bulk)) store_rows();
        if (ch.last(j)) core.softmax(tid);
      }
      if (ch.values(j))
        core.values(b, tid, m1, ch.first(j), ch.last(j), attn + beam * F);
      if (store && bulk && tid == 0) bulk_wait_read();
      release(&empty[s], lane);
    }
  }
}

template <typename T, int KIND, bool KVG_Q8>
cudaError_t launch(const void* q, const void* kv_new, const void* kvg,
                   const void* cache_src, void* cache_dst, const void* src,
                   const void* bias_hist, const void* bias_new, void* attn,
                   long long B, long long N, int L, int Mc, int F, int H,
                   int RW, int layer, int t, int write_back, long long mcs,
                   long long stages, long long smem, cudaStream_t stream) {
  constexpr bool OVR_EXACT = KIND != 0 && !KVG_Q8;
  const long long row_bytes =
      KIND == 0 ? static_cast<long long>(RW) * sizeof(T) : RW;
  const bool vec = (F / H) % 16 == 0;
  if (mcs < 1 || mcs > Mc) return cudaErrorInvalidValue;
  const Layout lay = make_layout(Mc, static_cast<int>(mcs), F, H, row_bytes,
                                 false, sizeof(T), true, OVR_EXACT, vec,
                                 chunk_cols<T, KIND>());
  cudaError_t err = check_plan(lay, stages, smem);
  if (err != cudaSuccess) return err;
  // bulk copies: 16-byte sizes (the slot insert and the chunks cut the
  // slab at row boundaries) and addresses
  const int bulk = row_bytes % 16 == 0 &&
                   (static_cast<long long>(F) * sizeof(T)) % 16 == 0 &&
                   aligned16(q) && aligned16(kv_new) && aligned16(kvg) &&
                   aligned16(cache_src) && aligned16(cache_dst);
  auto kernel = mcs < Mc ? step_attend_reorder_kernel<T, KIND, KVG_Q8, true>
                         : step_attend_reorder_kernel<T, KIND, KVG_Q8, false>;
  int resident;
  err = resident_blocks(reinterpret_cast<const void*>(kernel),
                        static_cast<int>(smem), &resident);
  if (err != cudaSuccess) return err;
  const long long BN = B * N;
  const long long grid = BN < resident ? BN : resident;
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv_new),
      static_cast<const char*>(kvg), static_cast<const char*>(cache_src),
      static_cast<char*>(cache_dst), static_cast<const int*>(src),
      static_cast<const float*>(bias_hist),
      static_cast<const float*>(bias_new), static_cast<T*>(attn), int(N), BN,
      L, Mc, F, H, RW, layer, t, write_back, static_cast<int>(mcs), lay,
      static_cast<int>(stages), vec, bulk);
  return cudaGetLastError();
}

}  // namespace

// kind: 0 exact, 1 int8, 2 int4; kvg_q8: kvg holds int8 cache rows (kind
// 1 only); is_f32: q/kv_new/attn (and exact rows and exact kvg) are
// float32, else bfloat16. cache_dst must not alias cache_src. mcs (slots a
// stage holds), stages and smem: the launch plan of
// ripor_tpu_torch/ops/staging.py.
extern "C" int step_attend_reorder(
    const void* q, const void* kv_new, const void* kvg, const void* cache_src,
    void* cache_dst, const void* src, const void* bias_hist,
    const void* bias_new, void* attn, long long B, long long N, long long L,
    long long Mc, long long F, long long H, long long RW, long long layer,
    long long t, long long write_back, long long kind, long long kvg_q8,
    long long is_f32, long long mcs, long long stages, long long smem,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (B * N == 0) return cudaSuccess;
#define RIPOR_LAUNCH(T, K, Q)                                               \
  err = launch<T, K, Q>(q, kv_new, kvg, cache_src, cache_dst, src,          \
                        bias_hist, bias_new, attn, B, N, int(L), int(Mc),   \
                        int(F), int(H), int(RW), int(layer), int(t),        \
                        int(write_back), mcs, stages, smem, s)
  if (is_f32) {
    if (kind == 0) RIPOR_LAUNCH(float, 0, false);
    else if (kind == 1 && kvg_q8) RIPOR_LAUNCH(float, 1, true);
    else if (kind == 1) RIPOR_LAUNCH(float, 1, false);
    else if (kind == 2) RIPOR_LAUNCH(float, 2, false);
  } else {
    if (kind == 0) RIPOR_LAUNCH(__nv_bfloat16, 0, false);
    else if (kind == 1 && kvg_q8) RIPOR_LAUNCH(__nv_bfloat16, 1, true);
    else if (kind == 1) RIPOR_LAUNCH(__nv_bfloat16, 1, false);
    else if (kind == 2) RIPOR_LAUNCH(__nv_bfloat16, 2, false);
  }
#undef RIPOR_LAUNCH
  return static_cast<int>(err);
}
