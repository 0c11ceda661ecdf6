// K2: one-position self-attention over the reordered megarow cache.
//
// Replaces: ripor_tpu/ops/megarow.py::step_attention_seq (Pallas
// _seq_kernel and _seq_kernel_stream, math _seq_math / _seq_math_quant,
// QFUSE _emit_quant_rows), and with mxu (K2') its RIPOR_MR_MXU math
// _seq_math_quant_mxu on int8/int4 rows: the same products for the
// scores, exact f32 p*v products (attend_staged.cuh, XPV).
// Plain version: ripor_tpu_torch/ops/megarow.py::step_attention_seq_plain.
//
// For beam (b, n) and layer l: scores over the Mc cache slots of
// cache[b, n, l] plus position t's own key, per head; softmax over the
// Mc + 1 positions in f32 with the max subtracted; weighted V sum in q's
// dtype. int8/int4 rows are dequantized by per-(slot, head) power-of-2
// exponents from the row's scale tail. With emit, the consumers also
// write kv_new in cache-row layout (row_codec.cuh quant_row) for the next
// step's K1.
//
// Bound on the H100: bytes. Per layer call it reads B*N*Mc*RW cache bytes
// plus q, kv_new and writes attn (+ kvq); the math is ~4 flops per cache
// element. At t5-base, B=8, N=1000, Mc=32, int4 rows that is ~0.29 GB,
// ~85 us at 3.35 TB/s.
//
// Design: attend_staged.cuh. Persistent blocks; the producer warp stages
// each beam's layer slab cache[b, n, l] (Mc*RW contiguous bytes), q and
// kv_new with bulk async copies into a ring of stages; eight consumer
// warps run the attention from shared memory. A slab larger than one stage
// (t5-3b widths in bf16 or int8 rows, t5-large in f32) streams through the
// ring in slot chunks, twice: once for the scores, once for the V sums.
#include <cuda_bf16.h>
#include <stdint.h>

#include "attend_staged.cuh"
#include "row_codec.cuh"

using namespace ripor;
using namespace ripor::staged;

namespace {

// KIND: 0 exact rows (dtype T, RW = 2F), 1 int8 rows, 2 packed int4 rows;
// CHUNKED: the slab streams in slot chunks of mcs slots; XPV: K2', exact
// p*v products (quantized rows)
template <typename T, int KIND, bool CHUNKED, bool XPV>
__global__ void __launch_bounds__(kThreads, CHUNKED ? 1 : kMinBlocks)
step_attention_seq_kernel(const T* __restrict__ q,
                          const T* __restrict__ kv_new,
                          const char* __restrict__ cache,
                          const float* __restrict__ bias_hist,
                          const float* __restrict__ bias_new,
                          T* __restrict__ attn, int8_t* __restrict__ kvq,
                          long long BN, int L, int Mc, int F, int H, int RW,
                          int layer, int emit, int mcs, Layout lay,
                          int stages, int vec, int bulk) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  const int tid = threadIdx.x, lane = tid & 31;
  const long long row_bytes =
      KIND == 0 ? static_cast<long long>(RW) * sizeof(T) : RW;
  const long long slab = Mc * row_bytes;
  const Chunks<CHUNKED> ch(Mc, mcs);

  init_barriers(full, empty, stages);
  stage_biases(reinterpret_cast<float*>(smem + lay.bias), bias_hist, bias_new,
               Mc, H);
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp
    int i = 0;
    for (long long beam = blockIdx.x; beam < BN; beam += gridDim.x) {
      for (int j = 0; j < ch.loads(); ++j, ++i) {
        const int s = i % stages;
        if (i >= stages) mbar_wait(&empty[s], ((i / stages) - 1) & 1);
        unsigned char* st = smem + lay.stage0 + s * lay.stage_bytes;
        const long long qb = static_cast<long long>(F) * sizeof(T);
        const long long m0 = ch.m0(j), cb = (ch.m1(j) - m0) * row_bytes;
        if (bulk && lane == 0)
          mbar_arrive_tx(&full[s], static_cast<uint32_t>(cb + 3 * qb));
        stage_in(st + lay.slab,
                 cache + (beam * L + layer) * slab + m0 * row_bytes, cb,
                 &full[s], bulk, lane);
        stage_in(st + lay.q, q + beam * F, qb, &full[s], bulk, lane);
        stage_in(st + lay.kvn, kv_new + beam * 2 * F, 2 * qb, &full[s], bulk,
                 lane);
        stage_done(&full[s], bulk, lane);
      }
    }
    return;
  }

  const Core<T, KIND, true, false, XPV> core{
      lay, smem, Dims{Mc, F, H, F / H, row_bytes, vec != 0}};
  int i = 0;
  for (long long beam = blockIdx.x; beam < BN; beam += gridDim.x) {
    for (int j = 0; j < ch.loads(); ++j, ++i) {
      const int s = i % stages;
      mbar_wait(&full[s], (i / stages) & 1);
      const unsigned char* st = smem + lay.stage0 + s * lay.stage_bytes;
      const char* rows = reinterpret_cast<const char*>(st + lay.slab);
      const Beam<T> b{rows, rows, reinterpret_cast<const T*>(st + lay.q),
                      reinterpret_cast<const T*>(st + lay.kvn), nullptr, -1,
                      ch.m0(j)};
      core.run(b, ch, j, tid, b.kvn,
               KIND != 0 && emit ? kvq + beam * RW : nullptr, attn + beam * F);
      release(&empty[s], lane);
    }
  }
}

// Products of one 16-byte row chunk, as the kernel forms them: for rows
// [R, RW] (kind 0 bf16, 1 int8, 2 int4), q [F] and one probability per
// row pe [R] (bf16), kq[r, f] = k[r, f] * q[f] and pv[r, f] = pe[r] *
// v[r, f] as bf16. Lets a test hold the packed multiplies against the
// plain version's products bit for bit.
template <int KIND>
__global__ void staged_products_kernel(const uint16_t* __restrict__ q,
                                       const char* __restrict__ rows,
                                       const uint16_t* __restrict__ pe,
                                       uint16_t* __restrict__ kq,
                                       uint16_t* __restrict__ pv, int R,
                                       int F, int RW) {
  using C = Chunk<KIND>;
  constexpr int CPC = chunk_cols<__nv_bfloat16, KIND>();
  const long long row_bytes = KIND == 0 ? 2LL * RW : RW;
  const int ncv = F / CPC;
  const long long item = blockIdx.x * static_cast<long long>(blockDim.x) +
                         threadIdx.x;
  if (item >= static_cast<long long>(R) * ncv) return;
  const int r = static_cast<int>(item / ncv);
  const int f0 = static_cast<int>(item % ncv) * CPC;
  const char* row = rows + r * row_bytes;
  __align__(16) uint32_t qw[C::WORDS];
#pragma unroll
  for (int j = 0; j < C::WORDS; ++j)
    qw[j] = q[f0 + C::col(j, 0)] |
            (static_cast<uint32_t>(q[f0 + C::col(j, 1)]) << 16);
  uint32_t p[C::WORDS];
  C::kq(row + k_off<__nv_bfloat16, KIND>(f0), qw, p);
#pragma unroll
  for (int j = 0; j < C::WORDS; ++j) {
    kq[static_cast<long long>(r) * F + f0 + C::col(j, 0)] = p[j] & 0xffffu;
    kq[static_cast<long long>(r) * F + f0 + C::col(j, 1)] = p[j] >> 16;
  }
  C::pv(row + v_off<__nv_bfloat16, KIND>(f0, F), pe[r] * 0x10001u, p);
#pragma unroll
  for (int j = 0; j < C::WORDS; ++j) {
    pv[static_cast<long long>(r) * F + f0 + C::col(j, 0)] = p[j] & 0xffffu;
    pv[static_cast<long long>(r) * F + f0 + C::col(j, 1)] = p[j] >> 16;
  }
}

template <typename T, int KIND, bool XPV>
cudaError_t launch(const void* q, const void* kv_new, const void* cache,
                   const void* bias_hist, const void* bias_new, void* attn,
                   void* kvq, long long BN, int L, int Mc, int F, int H,
                   int RW, int layer, int emit, long long mcs,
                   long long stages, long long smem, cudaStream_t stream) {
  const long long row_bytes =
      KIND == 0 ? static_cast<long long>(RW) * sizeof(T) : RW;
  const bool vec = (F / H) % 16 == 0;
  if (mcs < 1 || mcs > Mc) return cudaErrorInvalidValue;
  const Layout lay = make_layout(Mc, static_cast<int>(mcs), F, H, row_bytes,
                                 false, sizeof(T), true, false, vec,
                                 chunk_cols<T, KIND>());
  cudaError_t err = check_plan(lay, stages, smem);
  if (err != cudaSuccess) return err;
  // bulk copies: 16-byte sizes (a whole slab, or rows that chunks cut at)
  // and addresses
  const int bulk = (mcs < Mc ? row_bytes : Mc * row_bytes) % 16 == 0 &&
                   (static_cast<long long>(F) * sizeof(T)) % 16 == 0 &&
                   aligned16(q) && aligned16(kv_new) && aligned16(cache);
  auto kernel = mcs < Mc ? step_attention_seq_kernel<T, KIND, true, XPV>
                         : step_attention_seq_kernel<T, KIND, false, XPV>;
  int resident;
  err = resident_blocks(reinterpret_cast<const void*>(kernel),
                        static_cast<int>(smem), &resident);
  if (err != cudaSuccess) return err;
  const long long grid = BN < resident ? BN : resident;
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv_new),
      static_cast<const char*>(cache), static_cast<const float*>(bias_hist),
      static_cast<const float*>(bias_new), static_cast<T*>(attn),
      static_cast<int8_t*>(kvq), BN, L, Mc, F, H, RW, layer, emit,
      static_cast<int>(mcs), lay, static_cast<int>(stages), vec, bulk);
  return cudaGetLastError();
}

}  // namespace

// kind: 0 exact, 1 int8, 2 int4; is_f32: q/kv_new/attn (and exact rows)
// are float32, else bfloat16. kvq may be null when emit == 0. mcs (slots
// a stage holds), stages and smem: the launch plan of
// ripor_tpu_torch/ops/staging.py. mxu: K2' (kinds 1 and 2 only).
extern "C" int step_attention_seq(const void* q, const void* kv_new,
                                  const void* cache, const void* bias_hist,
                                  const void* bias_new, void* attn, void* kvq,
                                  long long BN, long long L, long long Mc,
                                  long long F, long long H, long long RW,
                                  long long layer, long long kind,
                                  long long is_f32, long long emit,
                                  long long mcs, long long stages,
                                  long long smem, long long mxu,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (BN == 0) return cudaSuccess;
  if (mxu && kind == 0) return cudaErrorInvalidValue;
#define RIPOR_LAUNCH(T, K, X)                                              \
  err = launch<T, K, X>(q, kv_new, cache, bias_hist, bias_new, attn, kvq,  \
                        BN, int(L), int(Mc), int(F), int(H), int(RW),      \
                        int(layer), int(emit), mcs, stages, smem, s)
#define RIPOR_LAUNCH_Q(T, K)        \
  if (mxu) RIPOR_LAUNCH(T, K, true); \
  else RIPOR_LAUNCH(T, K, false)
  if (is_f32) {
    if (kind == 0) RIPOR_LAUNCH(float, 0, false);
    else if (kind == 1) { RIPOR_LAUNCH_Q(float, 1); }
    else if (kind == 2) { RIPOR_LAUNCH_Q(float, 2); }
  } else {
    if (kind == 0) RIPOR_LAUNCH(__nv_bfloat16, 0, false);
    else if (kind == 1) { RIPOR_LAUNCH_Q(__nv_bfloat16, 1); }
    else if (kind == 2) { RIPOR_LAUNCH_Q(__nv_bfloat16, 2); }
  }
#undef RIPOR_LAUNCH_Q
#undef RIPOR_LAUNCH
  return static_cast<int>(err);
}

// The products probe (staged_products_kernel); F a multiple of 16.
extern "C" int staged_products(const void* q, const void* rows,
                               const void* pe, void* kq, void* pv,
                               long long R, long long F, long long RW,
                               long long kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cpc = kind == 0 ? 8 : 16;
  const long long items = R * (F / cpc);
  if (items == 0) return cudaSuccess;
  const unsigned grid = static_cast<unsigned>((items + 255) / 256);
#define RIPOR_PROBE(K)                                                       \
  staged_products_kernel<K><<<grid, 256, 0, s>>>(                            \
      static_cast<const uint16_t*>(q), static_cast<const char*>(rows),       \
      static_cast<const uint16_t*>(pe), static_cast<uint16_t*>(kq),          \
      static_cast<uint16_t*>(pv), int(R), int(F), int(RW))
  if (kind == 0) RIPOR_PROBE(0);
  else if (kind == 1) RIPOR_PROBE(1);
  else if (kind == 2) RIPOR_PROBE(2);
  else return cudaErrorInvalidValue;
#undef RIPOR_PROBE
  return static_cast<int>(cudaGetLastError());
}
