// One-query attention over cache rows staged in shared memory: the core of
// K2 (step_attention_seq.cu) and K4 (step_attend_reorder.cu), over K|V-merged
// rows, and of K5 (step_attention_fused.cu) and K8 (step_attention.cu), over
// separate K and V planes.
//
// The math is each reference's (ripor_tpu/ops/megarow.py _seq_math /
// _seq_math_quant, ripor_tpu/ops/attend_reorder.py _attn_math /
// _attn_math_q8 / _attn_math_q4, ripor_tpu/ops/step_attention.py _kernel /
// _fused_kernel): per head h, scores over the Mc cache slots plus (NEW)
// position t's own key, softmax in f32 with the max subtracted, weighted V
// sum. Three rounding modes:
//   RB (K2, K4 on bf16 and quantized rows): every k*q product and every
//     (probability * 2^ev, rounded to bf16) * v product is rounded to bf16
//     before its f32 sum; the position-t term pn * v_new is an unrounded f32
//     product; with XPV (K2' on quantized rows, the reference's
//     _seq_math_quant_mxu) the k*q products are rounded as with RB, the
//     probabilities too, but each p*v product is the exact f32 product;
//   exact products (K5, K8, and K2, K4 on f32 rows): k*q and p*v are f32
//     products of the stored values (for bf16 storage the k*q products are
//     exact), f32 sums; K8 rounds only the probabilities to bf16 (RPROB,
//     the reference's probs.astype(q.dtype)), K5 nothing.
// Quantized rows scale a slot's score by 2^ek and its probability by 2^ev
// (pow2i: exact).
//
// Rows: KIND 0 exact rows of T (RW = 2F: K then V), 1 int8 rows (RW = 2F +
// SCALE_COLS), 2 packed int4 rows (RW = F + SCALE_COLS, K in the low
// nibble, V in the high), the exponents in the tail (row_codec.cuh); 3
// planes of T: one beam's K plane [Mc, F] and V plane [Mc, F], each
// contiguous.
//
// Schedule. A persistent block (kThreads) walks beams blockIdx.x,
// += gridDim.x. Its last warp is the producer: one lane copies each
// beam's slab (its Mc rows, or both planes) and its q and kv_new rows into
// a ring of ``stages`` shared-memory stages with cp.async.bulk, completing
// on the stage's full mbarrier; the copies of the next beams are in flight
// while the eight consumer warps work on this one. Consumers release a
// stage on its empty mbarrier (one arrival per warp).
//
// Slot chunks. Where a beam's slab does not fit one stage, ops/staging.py
// plans chunks of ``mcs`` slots, and each beam takes two passes over its
// chunks: the score pass (every slot's score into sc, then the softmax) and
// the V pass. Merged rows are staged whole in both passes, so the V pass
// reads them again; planes stage the K chunk in the score pass and the V
// chunk in the V pass, so every cache byte still crosses HBM once. Every
// load carries the beam's q and kv_new rows (and K4's kvg row). The
// probabilities are rounded where the reference rounds them, after the
// softmax over all slots: there is no online softmax. A slab that fits is
// staged whole, once, and both passes read that one stage.
//
// Per beam the consumers run four phases, each closed by one named
// barrier over the consumer warps:
//   1. q in the dot dtype, as floats (qs) and, with RB, bf16 pairs (qp),
//      and the products of position t's key (and of slot t-1's exact key in
//      K4's quantize mode), column-parallel;
//   2. scores, one thread per (slot, head) pair, no shuffles: 16-byte
//      shared loads (a lane's first chunk rotated by its lane so a quarter
//      warp hits distinct banks), int4 unpacked eight nibbles a word with
//      the 0x4300 exponent trick and one bf16x2 subtract; with RB the
//      products are packed bf16x2 multiplies (one rounding of the exact
//      product: equal to the f32 product rounded, since bf16*bf16 and
//      int*bf16 products are exact in f32), else f32 FMAs of the unpacked
//      values; f32 sums;
//   3. softmax, one warp per head;
//   4. V sums, one thread per (16-byte column chunk, slot group), partial
//      sums over slot groups in shared memory (carried from chunk to chunk
//      by the thread that owns them); then one thread per column adds the
//      groups and position t's term and writes attn.
// Where D is not a multiple of 16 the same phases run on scalar reads.
//
// Bound on the H100: bytes (~4 flops per cache element, far under the ~295
// flop/byte ridge; no tensor cores: latency, not issue, limits these
// kernels, and with RB their f32 accumulation would not round each
// product to bf16 as the reference does).
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "row_codec.cuh"

namespace ripor {
namespace staged {

constexpr int kConsumers = 256;
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kMaxStages = 3;  // barrier slots; ops/staging.py picks <= 2
constexpr int kSmemLimit = 232448;         // per block on the H100

// Blocks an SM must hold (__launch_bounds__), which caps a thread at 72
// registers. The chunked instances ask for one: a chunked slab fills a
// block's shared memory, so one block runs an SM whatever its registers.
constexpr int kMinBlocks = 3;

__host__ __device__ constexpr long long a16(long long n) {
  return (n + 15) / 16 * 16;
}

// columns of one 16-byte chunk of a row: quantized rows hold one byte per
// K (and V) column, exact rows and planes sizeof(T)
template <typename T, int KIND>
__host__ __device__ constexpr int chunk_cols() {
  return KIND == 1 || KIND == 2 ? 16 : 16 / static_cast<int>(sizeof(T));
}

// Byte offsets of the dynamic shared memory (ops/staging.py mirrors this
// and passes the total): barriers, per-block scratch, then the stages.
struct Layout {
  int bias, sc, pe, pn, qs, qp, pk, part, stage0;  // block offsets
  int slab, vslab, q, kvn, kg, stage_bytes;        // offsets within a stage
  int G;  // V slot groups (vector path, or one for chunked scalar sums)
};

// Mc slots, staged mcs at a time (mcs < Mc: slot chunks); rows of
// row_bytes (for planes: F elements, one plane's row); kvn: position t's
// K|V rows are staged; kg: K4's exact kvg row is staged.
inline Layout make_layout(int Mc, int mcs, int F, int H, long long row_bytes,
                          bool planes, int q_esz, bool kvn, bool kg, bool vec,
                          int cpc) {
  const bool chunked = mcs < Mc;
  Layout l{};
  long long off = a16(2 * kMaxStages * 8);
  l.bias = int(off); off += a16((Mc + 1LL) * H * 4);
  l.sc = int(off);   off += a16((Mc + 1LL) * H * 4);
  l.pe = int(off);   off += a16(1LL * Mc * H * 4);
  l.pn = int(off);   off += a16(4LL * H);
  l.qs = int(off);   off += a16(4LL * F);
  l.qp = int(off);   off += a16(2LL * F);
  l.pk = int(off);   off += a16(4LL * F * (kg ? 2 : 1));
  const int ncv = F / cpc;
  l.G = vec ? (ncv >= kConsumers ? 1 : kConsumers / ncv) : (chunked ? 1 : 0);
  l.part = int(off); off += a16(4LL * l.G * F);
  l.stage0 = int(off);
  long long s = 0;
  l.slab = int(s);  s += a16(mcs * row_bytes);
  l.vslab = l.slab;  // merged rows; a chunk of planes holds one plane
  if (planes && !chunked) {
    l.vslab = int(s); s += a16(mcs * row_bytes);
  }
  l.q = int(s);     s += a16(1LL * F * q_esz);
  l.kvn = int(s);   s += kvn ? a16(2LL * F * q_esz) : 0;
  l.kg = int(s);    s += kg ? a16(2LL * F * q_esz) : 0;
  l.stage_bytes = int(s);
  return l;
}

// The plan ops/staging.py made must be this layout's.
inline cudaError_t check_plan(const Layout& lay, long long stages,
                              long long smem) {
  if (stages < 1 || stages > kMaxStages || smem > kSmemLimit ||
      lay.stage0 + stages * lay.stage_bytes != smem)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Blocks of ``fn`` resident on the whole card at ``smem`` bytes, queried
// once per (kernel, shared-memory size, device) and cached; raises the
// kernel's dynamic shared-memory limit on first use.
inline cudaError_t resident_blocks(const void* fn, int smem, int* blocks) {
  struct Entry {
    const void* fn;
    int smem, dev, blocks;
  };
  static Entry cache[64];
  static int n = 0;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < n; ++i)
    if (cache[i].fn == fn && cache[i].smem == smem && cache[i].dev == dev) {
      *blocks = cache[i].blocks;
      return cudaSuccess;
    }
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemLimit);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  if (n < 64) cache[n++] = Entry{fn, smem, dev, *blocks};
  return cudaSuccess;
}

// The loads of one beam: its whole slab once (CHUNKED false), or its nch
// chunks of mcs slots in the score pass and again in the V pass. Load j
// stages chunk j % nch; loads j < nch serve the score pass, j >= nch the V
// pass. The kernels have an instance for each, so a slab that fits one
// stage runs code with no chunk logic in it.
template <bool CHUNKED>
struct Chunks {
  int Mc, mcs, nch;
  __host__ __device__ Chunks(int Mc_, int mcs_)
      : Mc(Mc_),
        mcs(CHUNKED ? mcs_ : Mc_),
        nch(CHUNKED ? (Mc_ + mcs_ - 1) / mcs_ : 1) {}
  __device__ int loads() const { return CHUNKED ? 2 * nch : 1; }
  __device__ int m0(int j) const { return CHUNKED ? (j % nch) * mcs : 0; }
  __device__ int m1(int j) const {
    if (!CHUNKED) return Mc;
    const int e = m0(j) + mcs;
    return e < Mc ? e : Mc;
  }
  __device__ bool first(int j) const { return !CHUNKED || j % nch == 0; }
  __device__ bool last(int j) const {
    return !CHUNKED || j % nch == nch - 1;
  }
  __device__ bool scores(int j) const { return !CHUNKED || j < nch; }
  __device__ bool values(int j) const { return !CHUNKED || j >= nch; }
};

// ---------------------------------------------------------------------------
// barriers and bulk copies (PTX)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// wait for the completion of the barrier's phase with this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// global -> shared, completing ``bytes`` on ``bar`` (16-byte multiples and
// addresses)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// shared -> global as one bulk group of the issuing thread
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// the issuing thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
// this thread's shared-memory writes become visible to the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// The producer warp's copy of ``bytes`` from global to shared: one bulk
// copy issued by lane 0 (``bulk``), or the warp's plain loads and stores.
__device__ __forceinline__ void stage_in(void* dst, const void* src,
                                         long long bytes, uint64_t* bar,
                                         bool bulk, int lane) {
  if (bytes <= 0) return;
  if (bulk) {
    if (lane == 0) bulk_load(dst, src, static_cast<uint32_t>(bytes), bar);
  } else {
    const char* s = static_cast<const char*>(src);
    char* d = static_cast<char*>(dst);
    for (long long i = lane; i < bytes; i += 32) d[i] = s[i];
  }
}

// The producer warp has issued a stage's copies: with bulk copies they
// complete on the barrier themselves; plain copies arrive once done.
__device__ __forceinline__ void stage_done(uint64_t* full, bool bulk,
                                           int lane) {
  if (bulk) return;
  __threadfence_block();
  __syncwarp();
  if (lane == 0) mbar_arrive(full);
}

// ---------------------------------------------------------------------------
// bf16x2 arithmetic and row chunks
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t bmul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t bsub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ float lo_f(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_f(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  return bf16_bits(a) | (bf16_bits(b) << 16);
}
// nibbles 0 and 16 of x (values n in [0, 15]) -> bf16x2 (n - 8): 0x4300|n
// is 128 + n in bf16, and 128 + 8 is subtracted exactly
__device__ __forceinline__ uint32_t nib2(uint32_t x) {
  return bsub((x & 0x000f000fu) | 0x43004300u, 0x43084308u);
}
// signed bytes j and j+1 of x -> bf16x2 integer values, exactly (2^23 + u
// in f32 for the unsigned offset u = b + 128)
__device__ __forceinline__ uint32_t i8pair(uint32_t xu, int j) {
  const float a = __uint_as_float(__byte_perm(xu, 0x4B000000u, 0x7440 + j)) -
                  8388736.f;
  const float b =
      __uint_as_float(__byte_perm(xu, 0x4B000000u, 0x7440 + j + 1)) -
      8388736.f;
  return pack2(a, b);
}

// Products of one 16-byte chunk of bf16-product rows: KIND 2 int4, 1 int8,
// 0 exact bf16. ``kq`` forms WORDS k*q pairs from the chunk's K bytes and
// the matching q pairs; ``pv`` the p*v pairs from its V bytes and the
// broadcast probability pair; col(j, half) is the chunk column of word j's
// low (0) or high (1) half. For int4, q pairs follow the nibble order
// (columns 0, 2 | 1, 3 of each group of four).
template <int KIND>
struct Chunk;

template <>
struct Chunk<2> {
  static constexpr int WORDS = 8;
  __host__ __device__ static constexpr int col(int j, int half) {
    return 4 * (j >> 1) + (j & 1) + 2 * half;
  }
  __device__ static void kq(const char* k, const uint32_t* q, uint32_t* p) {
    const uint4 w = *reinterpret_cast<const uint4*>(k);
    const uint32_t x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[2 * i] = bmul(nib2(x[i]), q[2 * i]);
      p[2 * i + 1] = bmul(nib2(x[i] >> 8), q[2 * i + 1]);
    }
  }
  // the chunk's V values as bf16x2 pairs (exact integers)
  __device__ static void vals(const char* v, uint32_t* p) {
    const uint4 w = *reinterpret_cast<const uint4*>(v);
    const uint32_t x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[2 * i] = nib2(x[i] >> 4);
      p[2 * i + 1] = nib2(x[i] >> 12);
    }
  }
  __device__ static void pv(const char* v, uint32_t pe, uint32_t* p) {
    vals(v, p);
#pragma unroll
    for (int j = 0; j < WORDS; ++j) p[j] = bmul(p[j], pe);
  }
};

template <>
struct Chunk<1> {
  static constexpr int WORDS = 8;
  __host__ __device__ static constexpr int col(int j, int half) {
    return 2 * j + half;
  }
  __device__ static void kq(const char* k, const uint32_t* q, uint32_t* p) {
    const uint4 w = *reinterpret_cast<const uint4*>(k);
    const uint32_t x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t xu = x[i] ^ 0x80808080u;
      p[2 * i] = bmul(i8pair(xu, 0), q[2 * i]);
      p[2 * i + 1] = bmul(i8pair(xu, 2), q[2 * i + 1]);
    }
  }
  __device__ static void vals(const char* v, uint32_t* p) {
    const uint4 w = *reinterpret_cast<const uint4*>(v);
    const uint32_t x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t xu = x[i] ^ 0x80808080u;
      p[2 * i] = i8pair(xu, 0);
      p[2 * i + 1] = i8pair(xu, 2);
    }
  }
  __device__ static void pv(const char* v, uint32_t pe, uint32_t* p) {
    vals(v, p);
#pragma unroll
    for (int j = 0; j < WORDS; ++j) p[j] = bmul(p[j], pe);
  }
};

template <>
struct Chunk<0> {
  static constexpr int WORDS = 4;
  __host__ __device__ static constexpr int col(int j, int half) {
    return 2 * j + half;
  }
  __device__ static void kq(const char* k, const uint32_t* q, uint32_t* p) {
    const uint4 w = *reinterpret_cast<const uint4*>(k);
    const uint4 qw = *reinterpret_cast<const uint4*>(q);
    p[0] = bmul(w.x, qw.x);
    p[1] = bmul(w.y, qw.y);
    p[2] = bmul(w.z, qw.z);
    p[3] = bmul(w.w, qw.w);
  }
  __device__ static void pv(const char* v, uint32_t pe, uint32_t* p) {
    const uint4 w = *reinterpret_cast<const uint4*>(v);
    p[0] = bmul(w.x, pe);
    p[1] = bmul(w.y, pe);
    p[2] = bmul(w.z, pe);
    p[3] = bmul(w.w, pe);
  }
};

// byte offset of column f's K value in a row, and of its V value from the
// row's V base (the row itself for merged rows, the V plane's row for
// planes)
template <typename T, int KIND>
__device__ __forceinline__ long long k_off(int f) {
  return KIND == 1 || KIND == 2 ? f : static_cast<long long>(f) * sizeof(T);
}
template <typename T, int KIND>
__device__ __forceinline__ long long v_off(int f, int F) {
  return KIND == 0   ? static_cast<long long>(F + f) * sizeof(T)
         : KIND == 1 ? F + f
         : KIND == 2 ? f
                     : static_cast<long long>(f) * sizeof(T);
}

// one element of a row (the scalar path and the special slots)
template <typename T, int KIND>
__device__ __forceinline__ float row_k(const char* r, int f) {
  if (KIND == 0 || KIND == 3) return to_f(reinterpret_cast<const T*>(r)[f]);
  const int b = reinterpret_cast<const int8_t*>(r)[f];
  if (KIND == 1) return static_cast<float>(b);
  return static_cast<float>((b & 15) - INT4_OFFSET);
}
template <typename T, int KIND>
__device__ __forceinline__ float row_v(const char* r, int f, int F) {
  if (KIND == 0) return to_f(reinterpret_cast<const T*>(r)[F + f]);
  if (KIND == 3) return to_f(reinterpret_cast<const T*>(r)[f]);
  const int b = reinterpret_cast<const int8_t*>(r)[KIND == 1 ? F + f : f];
  if (KIND == 1) return static_cast<float>(b);
  return static_cast<float>(((b >> 4) & 15) - INT4_OFFSET);
}

// ---------------------------------------------------------------------------
// the consumers' attention of one beam
// ---------------------------------------------------------------------------

// One staged load of a beam: the rows of slots [m0, m0 + staged) (slab: K
// or whole rows; vslab: their V rows, the slab itself for merged rows).
// Slot ``ovr`` (or none, -1) is read exactly from kg (position t-1's K|V in
// T, bf16-rounded, scale 1): K4's in-kernel quantize mode, whose slab slot
// holds other bytes until it is patched.
template <typename T>
struct Beam {
  const char* slab;
  const char* vslab;
  const T* q;
  const T* kvn;
  const T* kg;
  int ovr;
  int m0;
};

struct Dims {
  int Mc, F, H, D;
  long long row_bytes;
  bool vec;
};

// NEW: position t's own k/v join the softmax (all but K8); RPROB: round the
// probabilities to bf16 (K8 on bf16 caches); XPV: exact p*v products on
// quantized rows (K2').
template <typename T, int KIND, bool NEW = true, bool RPROB = false,
          bool XPV = false>
struct Core {
  static constexpr bool RB =
      KIND == 1 || KIND == 2 ||
      (KIND == 0 && std::is_same<T, __nv_bfloat16>::value);
  static constexpr bool RP = RB || RPROB;
  static constexpr bool SCALED = KIND == 1 || KIND == 2;
  static_assert(!XPV || SCALED, "XPV is a mode of quantized rows");
  // p*v products rounded to bf16
  static constexpr bool RV = RB && !XPV;
  static constexpr int CPC = chunk_cols<T, KIND>();

  Layout lay;
  unsigned char* smem;
  Dims d;

  template <typename P>
  __device__ P* at(int off) const {
    return reinterpret_cast<P*>(smem + off);
  }
  __device__ float* bias() const { return at<float>(lay.bias); }
  __device__ float* sc() const { return at<float>(lay.sc); }
  __device__ uint32_t* pe() const { return at<uint32_t>(lay.pe); }
  // the V exponents of quantized rows, from the score pass (where the rows
  // are staged) to the softmax, in pe's place
  __device__ int* evs() const { return at<int>(lay.pe); }
  __device__ float* pn() const { return at<float>(lay.pn); }
  __device__ float* qs() const { return at<float>(lay.qs); }
  __device__ uint16_t* qp() const { return at<uint16_t>(lay.qp); }
  __device__ float* pk() const { return at<float>(lay.pk); }
  __device__ float* part() const { return at<float>(lay.part); }

  __device__ int ecol() const { return KIND == 1 ? 2 * d.F : d.F; }
  __device__ const char* row(const Beam<T>& b, int m) const {
    return b.slab + (m - b.m0) * d.row_bytes;
  }
  __device__ const char* vrow(const Beam<T>& b, int m) const {
    return b.vslab + (m - b.m0) * d.row_bytes;
  }
  // probability (times the V scale) of pair p as a float
  __device__ float pe_f(int p) const {
    const uint32_t w = pe()[p];
    return RB ? lo_f(w) : __uint_as_float(w);
  }

  // sum of x[0, D) (16-byte aligned when D % 4 == 0)
  __device__ static float head_sum(const float* x, int D) {
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    if (D % 4 == 0) {
      for (int c = 0; c < D; c += 4) {
        const float4 v = *reinterpret_cast<const float4*>(x + c);
        a[0] += v.x;
        a[1] += v.y;
        a[2] += v.z;
        a[3] += v.w;
      }
    } else {
      for (int c = 0; c < D; ++c) a[0] += x[c];
    }
    return (a[0] + a[1]) + (a[2] + a[3]);
  }

  // score of slot m (< Mc) for head h over the vector path
  __device__ float dot_vec(const char* r, int h, int rot) const {
    const int nch = d.D / CPC;
    float a0 = 0.f, a1 = 0.f;
    for (int j = 0; j < nch; ++j) {
      int jj = j + rot;
      if (jj >= nch) jj -= nch;
      const int f0 = h * d.D + jj * CPC;
      const char* k = r + k_off<T, KIND>(f0);
      if constexpr (RB) {
        uint32_t p[Chunk<KIND>::WORDS];
        const uint32_t* q2 = reinterpret_cast<const uint32_t*>(qp() + f0);
        Chunk<KIND>::kq(k, q2, p);
#pragma unroll
        for (int i = 0; i < Chunk<KIND>::WORDS; ++i) {
          a0 += lo_f(p[i]);
          a1 += hi_f(p[i]);
        }
      } else if constexpr (sizeof(T) == 4) {
        const float4 kv = *reinterpret_cast<const float4*>(k);
        const float4 qv = *reinterpret_cast<const float4*>(qs() + f0);
        a0 += __fmul_rn(kv.x, qv.x);
        a1 += __fmul_rn(kv.y, qv.y);
        a0 += __fmul_rn(kv.z, qv.z);
        a1 += __fmul_rn(kv.w, qv.w);
      } else {
        // bf16 storage, exact products: each product of two bf16 values is
        // exact in f32, so the FMA rounds only the sum
        const uint4 w = *reinterpret_cast<const uint4*>(k);
        const float4 qa = *reinterpret_cast<const float4*>(qs() + f0);
        const float4 qb = *reinterpret_cast<const float4*>(qs() + f0 + 4);
        a0 = __fmaf_rn(lo_f(w.x), qa.x, a0);
        a1 = __fmaf_rn(hi_f(w.x), qa.y, a1);
        a0 = __fmaf_rn(lo_f(w.y), qa.z, a0);
        a1 = __fmaf_rn(hi_f(w.y), qa.w, a1);
        a0 = __fmaf_rn(lo_f(w.z), qb.x, a0);
        a1 = __fmaf_rn(hi_f(w.z), qb.y, a1);
        a0 = __fmaf_rn(lo_f(w.w), qb.z, a0);
        a1 = __fmaf_rn(hi_f(w.w), qb.w, a1);
      }
    }
    return a0 + a1;
  }

  // Phase 1, on a beam's first load: q in the dot dtype and the products of
  // position t's key (and slot ovr's exact key), column-parallel, summed
  // per head in phase 2. Ends on a consumer barrier.
  __device__ void prologue(const Beam<T>& b, int tid) const {
    const int F = d.F;
    float* q_s = qs();
    float* p_k = pk();
    for (int i = tid; i < F; i += kConsumers) {
      const float x = rd<RB>(to_f(b.q[i]));
      q_s[i] = x;
      if (RB && d.vec) {
        const int pos =
            KIND == 2 ? ((i & ~3) | ((i & 1) << 1) | ((i >> 1) & 1)) : i;
        qp()[pos] = static_cast<uint16_t>(bf16_bits(x));
      }
      if (NEW) p_k[i] = rd<RB>(rd<RB>(to_f(b.kvn[i])) * x);
      if (b.ovr >= 0) p_k[F + i] = rd<RB>(bf16_round(to_f(b.kg[i])) * x);
    }
    consumer_sync();
  }

  // Phase 2 on one load of the score pass: the scores of the staged slots
  // [b.m0, m1) and, on the last chunk, of position t. With quant_dst, the
  // consumers also quantize quant_src (a K|V row of T) into that cache row
  // (global or shared; shared writes are fenced for a bulk store that
  // follows). Ends on a consumer barrier.
  __device__ void score_rows(const Beam<T>& b, int tid, int m1, bool last,
                             const T* quant_src, int8_t* quant_dst) const {
    const int F = d.F, H = d.H, D = d.D, Mc = d.Mc;
    const int rot = ((tid & 7) * (D / CPC)) >> 3;
    const int end = (last && NEW ? Mc + 1 : m1) * H;
    float* s = sc();
    const float* bi = bias();
    const float* q_s = qs();
    for (int p = b.m0 * H + tid; p < end; p += kConsumers) {
      const int m = p / H, h = p - m * H;
      float acc = 0.f;
      if (m == Mc || m == b.ovr) {
        acc = head_sum(pk() + (m == Mc ? 0 : F) + h * D, D);
        if (SCALED && m != Mc) evs()[p] = 0;
      } else {
        const char* r = row(b, m);
        if (d.vec) {
          acc = dot_vec(r, h, rot);
        } else {
          for (int c = 0; c < D; ++c) {
            const int f = h * D + c;
            acc += rd<RB>(row_k<T, KIND>(r, f) * q_s[f]);
          }
        }
        if (SCALED) {
          const int8_t* e = reinterpret_cast<const int8_t*>(r) + ecol();
          acc *= pow2i(e[h]);
          evs()[p] = e[H + h];
        }
      }
      s[p] = acc + bi[p];
    }
    if (SCALED && quant_dst != nullptr) {
      // last warps first: the first warps hold the second round of pairs
      quant_row(quant_src, F, H, KIND, quant_dst, tid ^ (kConsumers - 32),
                kConsumers);
      fence_proxy_async();
    }
    consumer_sync();
  }

  // Phase 3, after the score pass: the softmax over the Mc (+1) positions,
  // one warp per head. Ends on a consumer barrier.
  __device__ void softmax(int tid) const {
    const int lane = tid & 31, warp = tid >> 5;
    const int H = d.H, Mc = d.Mc, P = NEW ? Mc + 1 : Mc;
    float* s = sc();
    for (int h = warp; h < H; h += kConsumerWarps) {
      float mx = -INFINITY;
      for (int m = lane; m < P; m += 32) mx = fmaxf(mx, s[m * H + h]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int m = lane; m < P; m += 32) {
        const float e = expf(s[m * H + h] - mx);
        s[m * H + h] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int m = lane; m < P; m += 32) {
        float w = s[m * H + h] / sum;
        if (NEW && m == Mc) {
          pn()[h] = rd<RP>(w);
          continue;
        }
        if (SCALED) w *= pow2i(evs()[m * H + h]);
        w = rd<RP>(w);
        pe()[m * H + h] =
            RB ? bf16_bits(w) * 0x10001u : __float_as_uint(w);
      }
    }
    consumer_sync();
  }

  // Phase 4 on one load of the V pass: the weighted V sums of the staged
  // slots [b.m0, m1), started on the first chunk and carried in ``part``
  // by the thread that owns them; on the last chunk, plus position t's
  // term, written to out[0, F) in T. Ends without a barrier.
  __device__ void values(const Beam<T>& b, int tid, int m1, bool first,
                         bool last, T* out) const {
    const int F = d.F, H = d.H, D = d.D;
    float* pt = part();
    if (!d.vec) {
      for (int f = tid; f < F; f += kConsumers) {
        const int h = f / D;
        float acc = first ? 0.f : pt[f];
        for (int m = b.m0; m < m1; ++m) {
          const float v = m == b.ovr ? bf16_round(to_f(b.kg[F + f]))
                                     : row_v<T, KIND>(vrow(b, m), f, F);
          acc += rd<RV>(pe_f(m * H + h) * v);
        }
        if (!last) {
          pt[f] = acc;
          continue;
        }
        if (NEW) acc += pn()[h] * to_f(b.kvn[F + f]);
        out[f] = from_f<T>(acc);
      }
      return;
    }
    const int ncv = F / CPC, G = lay.G;
    for (int item = tid; item < ncv * G; item += kConsumers) {
      const int c = item % ncv, g = item / ncv;
      const int f0 = c * CPC, h = f0 / D;
      float4* dst = reinterpret_cast<float4*>(pt + g * F + f0);
      float acc[CPC];
#pragma unroll
      for (int i = 0; i < CPC / 4; ++i) {
        const float4 a = first ? make_float4(0.f, 0.f, 0.f, 0.f) : dst[i];
        acc[4 * i] = a.x;
        acc[4 * i + 1] = a.y;
        acc[4 * i + 2] = a.z;
        acc[4 * i + 3] = a.w;
      }
      // slots m = g (mod G) of this chunk, in order
      for (int m = b.m0 + (g - b.m0 % G + G) % G; m < m1; m += G) {
        if (m == b.ovr) {
          const float w = pe_f(m * H + h);
#pragma unroll
          for (int i = 0; i < CPC; ++i)
            acc[i] += rd<RV>(w * bf16_round(to_f(b.kg[F + f0 + i])));
          continue;
        }
        const char* v = vrow(b, m) + v_off<T, KIND>(f0, F);
        if constexpr (XPV) {
          const float w = pe_f(m * H + h);
          uint32_t p[Chunk<KIND>::WORDS];
          Chunk<KIND>::vals(v, p);
#pragma unroll
          for (int j = 0; j < Chunk<KIND>::WORDS; ++j) {
            acc[Chunk<KIND>::col(j, 0)] += __fmul_rn(w, lo_f(p[j]));
            acc[Chunk<KIND>::col(j, 1)] += __fmul_rn(w, hi_f(p[j]));
          }
        } else if constexpr (RB) {
          uint32_t p[Chunk<KIND>::WORDS];
          Chunk<KIND>::pv(v, pe()[m * H + h], p);
#pragma unroll
          for (int j = 0; j < Chunk<KIND>::WORDS; ++j) {
            acc[Chunk<KIND>::col(j, 0)] += lo_f(p[j]);
            acc[Chunk<KIND>::col(j, 1)] += hi_f(p[j]);
          }
        } else if constexpr (sizeof(T) == 4) {
          const float w = pe_f(m * H + h);
          const float4 vv = *reinterpret_cast<const float4*>(v);
          acc[0] += __fmul_rn(w, vv.x);
          acc[1] += __fmul_rn(w, vv.y);
          acc[2] += __fmul_rn(w, vv.z);
          acc[3] += __fmul_rn(w, vv.w);
        } else {
          const float w = pe_f(m * H + h);
          const uint4 vv = *reinterpret_cast<const uint4*>(v);
          const uint32_t x[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[2 * j] += __fmul_rn(w, lo_f(x[j]));
            acc[2 * j + 1] += __fmul_rn(w, hi_f(x[j]));
          }
        }
      }
#pragma unroll
      for (int i = 0; i < CPC / 4; ++i)
        dst[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                             acc[4 * i + 3]);
    }
    if (!last) return;
    consumer_sync();
    for (int f = tid; f < F; f += kConsumers) {
      const int h = f / D;
      float acc = 0.f;
      for (int g = 0; g < G; ++g) acc += pt[g * F + f];
      if (NEW) acc += pn()[h] * to_f(b.kvn[F + f]);
      out[f] = from_f<T>(acc);
    }
  }

  // The consumers' work on load j of a beam (K2, K5, K8; K4 interleaves
  // its stores): with quant_dst, K2's emitted row on the first load.
  template <class Ch>
  __device__ void run(const Beam<T>& b, const Ch& ch, int j, int tid,
                      const T* quant_src, int8_t* quant_dst, T* out) const {
    const int m1 = ch.m1(j);
    if (ch.scores(j)) {
      if (ch.first(j)) prologue(b, tid);
      score_rows(b, tid, m1, ch.last(j), quant_src,
                 ch.first(j) ? quant_dst : nullptr);
      if (ch.last(j)) softmax(tid);
    }
    if (ch.values(j)) values(b, tid, m1, ch.first(j), ch.last(j), out);
  }
};

// The consumers stage the biases once per block: bias_hist [Mc, H], then
// bias_new [H] (pair index m * H + h, m = Mc for position t) where there is
// one.
__device__ __forceinline__ void stage_biases(float* dst, const float* hist,
                                             const float* fresh, int Mc,
                                             int H) {
  const int n = (fresh != nullptr ? Mc + 1 : Mc) * H;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    dst[i] = i < Mc * H ? hist[i] : fresh[i - Mc * H];
}

__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty,
                                              int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init_fence();
  }
}

// a consumer warp is done with a stage
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

// ---------------------------------------------------------------------------
// K5 and K8: attention over one layer's K and V planes
// ---------------------------------------------------------------------------

// kplanes, vplanes: beam-major [BN, Mc, F] planes of T (beam i's planes at
// i * Mc * F elements); q and out [BN, F]; with NEW, k_new and v_new [BN,
// F] and bias_new [H] (K5), else none (K8). The producer stages both planes
// of a beam with two bulk copies (or, in slot chunks, the K chunk in the
// score pass and the V chunk in the V pass), then q (and k_new | v_new).
template <typename T, bool NEW, bool RPROB, bool CHUNKED>
__device__ __forceinline__ void attend_planes(
    const T* q, const T* k_new, const T* v_new, const char* kplanes,
    const char* vplanes, const float* bias_hist, const float* bias_new,
    T* out, long long BN, int Mc, int F, int H, int mcs, const Layout& lay,
    int stages, int vec, int bulk) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  const int tid = threadIdx.x, lane = tid & 31;
  const long long row_bytes = static_cast<long long>(F) * sizeof(T);
  const long long plane = Mc * row_bytes;
  const Chunks<CHUNKED> ch(Mc, mcs);

  init_barriers(full, empty, stages);
  stage_biases(reinterpret_cast<float*>(smem + lay.bias), bias_hist,
               NEW ? bias_new : nullptr, Mc, H);
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp
    int i = 0;
    for (long long beam = blockIdx.x; beam < BN; beam += gridDim.x) {
      for (int j = 0; j < ch.loads(); ++j, ++i) {
        const int s = i % stages;
        if (i >= stages) mbar_wait(&empty[s], ((i / stages) - 1) & 1);
        unsigned char* st = smem + lay.stage0 + s * lay.stage_bytes;
        const long long m0 = ch.m0(j), rows = ch.m1(j) - m0;
        const long long qb = row_bytes;
        // a whole slab: both planes; a chunk: one plane's rows
        const long long cb = rows * row_bytes;
        if (bulk && lane == 0)
          mbar_arrive_tx(&full[s], static_cast<uint32_t>(
                                       (CHUNKED ? cb : 2 * cb) +
                                       (NEW ? 3 : 1) * qb));
        const long long at = beam * plane + m0 * row_bytes;
        if (ch.scores(j))
          stage_in(st + lay.slab, kplanes + at, cb, &full[s], bulk, lane);
        if (!CHUNKED || !ch.scores(j))
          stage_in(st + lay.vslab, vplanes + at, cb, &full[s], bulk, lane);
        stage_in(st + lay.q, q + beam * F, qb, &full[s], bulk, lane);
        if (NEW) {
          stage_in(st + lay.kvn, k_new + beam * F, qb, &full[s], bulk, lane);
          stage_in(st + lay.kvn + qb, v_new + beam * F, qb, &full[s], bulk,
                   lane);
        }
        stage_done(&full[s], bulk, lane);
      }
    }
    return;
  }

  const Core<T, 3, NEW, RPROB> core{
      lay, smem, Dims{Mc, F, H, F / H, row_bytes, vec != 0}};
  int i = 0;
  for (long long beam = blockIdx.x; beam < BN; beam += gridDim.x) {
    for (int j = 0; j < ch.loads(); ++j, ++i) {
      const int s = i % stages;
      mbar_wait(&full[s], (i / stages) & 1);
      const unsigned char* st = smem + lay.stage0 + s * lay.stage_bytes;
      const Beam<T> b{reinterpret_cast<const char*>(st + lay.slab),
                      reinterpret_cast<const char*>(st + lay.vslab),
                      reinterpret_cast<const T*>(st + lay.q),
                      NEW ? reinterpret_cast<const T*>(st + lay.kvn) : nullptr,
                      nullptr, -1, ch.m0(j)};
      core.run(b, ch, j, tid, nullptr, nullptr, out + beam * F);
      release(&empty[s], lane);
    }
  }
}

// The host side of a K5 or K8 launch: layout, plan check, bulk-copy
// choice, the instance (whole slabs or slot chunks), grid. kplanes and
// vplanes as in attend_planes.
template <typename T, typename Kernel>
cudaError_t launch_planes(Kernel whole, Kernel chunked, const void* q,
                          const void* k_new,
                          const void* v_new, const char* kplanes,
                          const char* vplanes, const void* bias_hist,
                          const void* bias_new, void* out, long long BN,
                          int Mc, int F, int H, long long mcs,
                          long long stages, long long smem, bool fresh,
                          cudaStream_t stream) {
  const long long row_bytes = static_cast<long long>(F) * sizeof(T);
  const bool vec = (F / H) % 16 == 0;
  if (mcs < 1 || mcs > Mc) return cudaErrorInvalidValue;
  const Layout lay = make_layout(Mc, static_cast<int>(mcs), F, H, row_bytes,
                                 true, sizeof(T), fresh, false, vec,
                                 chunk_cols<T, 3>());
  cudaError_t err = check_plan(lay, stages, smem);
  if (err != cudaSuccess) return err;
  // bulk copies: 16-byte rows (so every chunk and plane) and addresses
  const int bulk = row_bytes % 16 == 0 && aligned16(q) && aligned16(kplanes) &&
                   aligned16(vplanes) &&
                   (!fresh || (aligned16(k_new) && aligned16(v_new)));
  const Kernel kernel = mcs < Mc ? chunked : whole;
  int resident;
  err = resident_blocks(reinterpret_cast<const void*>(kernel),
                        static_cast<int>(smem), &resident);
  if (err != cudaSuccess) return err;
  const long long grid = BN < resident ? BN : resident;
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), kplanes, vplanes,
      static_cast<const float*>(bias_hist),
      static_cast<const float*>(bias_new), static_cast<T*>(out), BN, Mc, F,
      H, static_cast<int>(mcs), lay, static_cast<int>(stages), vec, bulk);
  return cudaGetLastError();
}

}  // namespace staged
}  // namespace ripor
