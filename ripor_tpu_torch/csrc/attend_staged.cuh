// One-query attention over K|V-merged cache rows, staged in shared memory:
// the core of K2 (step_attention_seq.cu) and K4 (step_attend_reorder.cu).
//
// The math is the reference's (ripor_tpu/ops/megarow.py _seq_math /
// _seq_math_quant, ripor_tpu/ops/attend_reorder.py _attn_math /
// _attn_math_q8 / _attn_math_q4): per head h, scores over the Mc cache
// slots plus position t's own key, softmax over the Mc + 1 positions in f32
// with the max subtracted, weighted V sum. With RB (bf16 and quantized
// caches) every k*q product and every (probability * 2^ev, rounded to
// bf16) * v product is rounded to bf16 before its f32 sum; the position-t
// term pn * v_new is an unrounded f32 product; f32 caches keep everything
// in f32. Quantized rows scale a slot's score by 2^ek and its probability
// by 2^ev (pow2i: exact).
//
// Rows: KIND 0 exact rows of T (RW = 2F: K then V), 1 int8 rows (RW = 2F +
// SCALE_COLS), 2 packed int4 rows (RW = F + SCALE_COLS, K in the low
// nibble, V in the high); the exponents sit in the tail (row_codec.cuh).
//
// Schedule. A persistent block (kThreads) walks beams blockIdx.x,
// += gridDim.x. Its last warp is the producer: one lane copies each
// beam's slab (Mc rows, contiguous) and its q and kv_new rows into a ring
// of ``stages`` shared-memory stages with cp.async.bulk, completing on the
// stage's full mbarrier; the copies of the next beams are in flight while
// the eight consumer warps work on this one. Consumers release a stage on
// its empty mbarrier (one arrival per warp). Every cache byte crosses HBM
// once; scores and V sums both read the staged slab.
//
// Per beam the consumers run four phases, each closed by one named
// barrier over the consumer warps:
//   1. q in the dot dtype, as floats (qs) and bf16 pairs (qp), and the
//      products of position t's key (and of slot t-1's exact key in K4's
//      quantize mode), column-parallel;
//   2. scores, one thread per (slot, head) pair, no shuffles: 16-byte
//      shared loads (a lane's first chunk rotated by its lane so a quarter
//      warp hits distinct banks), int4 unpacked eight nibbles a word with
//      the 0x4300 exponent trick and one bf16x2 subtract, products as
//      packed bf16x2 multiplies (one rounding of the exact product: equal to
//      the f32 product rounded, since bf16*bf16 and int*bf16 products are
//      exact in f32), f32 sums;
//   3. softmax, one warp per head;
//   4. V sums, one thread per (16-byte column chunk, slot group), partial
//      sums over slot groups in shared memory; then one thread per column
//      adds the groups and position t's term and writes attn.
// Where D is not a multiple of 16 the same phases run on scalar reads.
//
// Bound on the H100: bytes (~4 flops per cache byte, far under the ~295
// flop/byte ridge; no tensor cores: their f32 accumulation does not round
// each product to bf16 as the reference does).
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

__host__ __device__ constexpr long long a16(long long n) {
  return (n + 15) / 16 * 16;
}

// columns of one 16-byte chunk of a row: quantized rows hold one byte per
// K (and V) column, exact rows sizeof(T)
template <typename T, int KIND>
__host__ __device__ constexpr int chunk_cols() {
  return KIND != 0 ? 16 : 16 / static_cast<int>(sizeof(T));
}

// Byte offsets of the dynamic shared memory (ops/staging.py mirrors this
// and passes the total): barriers, per-block scratch, then the stages.
struct Layout {
  int bias, sc, pe, pn, qs, qp, pk, part, stage0;  // block offsets
  int slab, q, kvn, kg, stage_bytes;           // offsets within a stage
  int G;                                       // V slot groups (vector path)
};

inline Layout make_layout(int Mc, int F, int H, long long row_bytes,
                          int q_esz, bool kg, bool vec, int cpc) {
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
  l.G = vec ? (ncv >= kConsumers ? 1 : kConsumers / ncv) : 0;
  l.part = int(off); off += a16(4LL * l.G * F);
  l.stage0 = int(off);
  long long s = 0;
  l.slab = int(s); s += a16(Mc * row_bytes);
  l.q = int(s);    s += a16(1LL * F * q_esz);
  l.kvn = int(s);  s += a16(2LL * F * q_esz);
  l.kg = int(s);   s += kg ? a16(2LL * F * q_esz) : 0;
  l.stage_bytes = int(s);
  return l;
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
  __device__ static void pv(const char* v, uint32_t pe, uint32_t* p) {
    const uint4 w = *reinterpret_cast<const uint4*>(v);
    const uint32_t x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[2 * i] = bmul(nib2(x[i] >> 4), pe);
      p[2 * i + 1] = bmul(nib2(x[i] >> 12), pe);
    }
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
  __device__ static void pv(const char* v, uint32_t pe, uint32_t* p) {
    const uint4 w = *reinterpret_cast<const uint4*>(v);
    const uint32_t x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t xu = x[i] ^ 0x80808080u;
      p[2 * i] = bmul(i8pair(xu, 0), pe);
      p[2 * i + 1] = bmul(i8pair(xu, 2), pe);
    }
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

// byte offsets in a row of column f's K and V values
template <typename T, int KIND>
__device__ __forceinline__ long long k_off(int f) {
  return KIND == 0 ? static_cast<long long>(f) * sizeof(T) : f;
}
template <typename T, int KIND>
__device__ __forceinline__ long long v_off(int f, int F) {
  return KIND == 0   ? static_cast<long long>(F + f) * sizeof(T)
         : KIND == 1 ? F + f
                     : f;
}

// one element of a row (the scalar path and the special slots)
template <typename T, int KIND>
__device__ __forceinline__ float row_k(const char* r, int f) {
  if (KIND == 0) return to_f(reinterpret_cast<const T*>(r)[f]);
  const int b = reinterpret_cast<const int8_t*>(r)[f];
  if (KIND == 1) return static_cast<float>(b);
  return static_cast<float>((b & 15) - INT4_OFFSET);
}
template <typename T, int KIND>
__device__ __forceinline__ float row_v(const char* r, int f, int F) {
  if (KIND == 0) return to_f(reinterpret_cast<const T*>(r)[F + f]);
  const int b = reinterpret_cast<const int8_t*>(r)[KIND == 1 ? F + f : f];
  if (KIND == 1) return static_cast<float>(b);
  return static_cast<float>(((b >> 4) & 15) - INT4_OFFSET);
}

// ---------------------------------------------------------------------------
// the consumers' attention of one beam
// ---------------------------------------------------------------------------

// One beam's staged inputs. Slot ``ovr`` (or none, -1) is read exactly
// from kg (position t-1's K|V in T, bf16-rounded, scale 1): K4's in-kernel
// quantize mode, whose slab slot holds other bytes until it is patched.
template <typename T>
struct Beam {
  const char* slab;
  const T* q;
  const T* kvn;
  const T* kg;
  int ovr;
};

struct Dims {
  int Mc, F, H, D;
  long long row_bytes;
  bool vec;
};

template <typename T, int KIND>
struct Core {
  static constexpr bool RB =
      KIND != 0 || std::is_same<T, __nv_bfloat16>::value;
  static constexpr bool SCALED = KIND != 0;
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
  __device__ float* pn() const { return at<float>(lay.pn); }
  __device__ float* qs() const { return at<float>(lay.qs); }
  __device__ uint16_t* qp() const { return at<uint16_t>(lay.qp); }
  __device__ float* pk() const { return at<float>(lay.pk); }
  __device__ float* part() const { return at<float>(lay.part); }
  __device__ int ev(const Beam<T>& b, int m, int h) const {
    return reinterpret_cast<const int8_t*>(row(b, m))[ecol() + d.H + h];
  }

  __device__ int ecol() const { return KIND == 1 ? 2 * d.F : d.F; }
  __device__ const char* row(const Beam<T>& b, int m) const {
    return b.slab + m * d.row_bytes;
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
      } else {
        const float4 kv = *reinterpret_cast<const float4*>(k);
        const float4 qv = *reinterpret_cast<const float4*>(qs() + f0);
        a0 += __fmul_rn(kv.x, qv.x);
        a1 += __fmul_rn(kv.y, qv.y);
        a0 += __fmul_rn(kv.z, qv.z);
        a1 += __fmul_rn(kv.w, qv.w);
      }
    }
    return a0 + a1;
  }

  // Phases 1-3: q, scores, softmax. With quant_dst, the consumers also
  // quantize quant_src (a K|V row of T) into that cache row (global or
  // shared; shared writes are fenced for a bulk store that follows). Ends
  // on a consumer barrier.
  __device__ void scores(const Beam<T>& b, int tid, const T* quant_src,
                         int8_t* quant_dst) const {
    const int lane = tid & 31, warp = tid >> 5;
    const int F = d.F, H = d.H, D = d.D, Mc = d.Mc, P = Mc + 1;
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
      // the products of position t's key (and slot ovr's exact key),
      // formed column-parallel here and summed per head below
      p_k[i] = rd<RB>(rd<RB>(to_f(b.kvn[i])) * x);
      if (b.ovr >= 0) p_k[F + i] = rd<RB>(bf16_round(to_f(b.kg[i])) * x);
    }
    consumer_sync();

    const int rot = ((tid & 7) * (D / CPC)) >> 3;
    float* s = sc();
    const float* bi = bias();
    for (int p = tid; p < P * H; p += kConsumers) {
      const int m = p / H, h = p - m * H;
      float acc = 0.f;
      if (m == Mc || m == b.ovr) {
        acc = head_sum(p_k + (m == Mc ? 0 : F) + h * D, D);
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
        if (SCALED)
          acc *= pow2i(reinterpret_cast<const int8_t*>(r)[ecol() + h]);
      }
      s[p] = acc + bi[p];
    }
    if (KIND != 0 && quant_dst != nullptr) {
      // last warps first: the first warps hold the second round of pairs
      quant_row(quant_src, F, H, KIND, quant_dst, tid ^ (kConsumers - 32),
                kConsumers);
      fence_proxy_async();
    }
    consumer_sync();

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
        if (m == Mc) {
          pn()[h] = rd<RB>(w);
          continue;
        }
        if (SCALED && m != b.ovr) w *= pow2i(ev(b, m, h));
        w = rd<RB>(w);
        pe()[m * H + h] =
            RB ? bf16_bits(w) * 0x10001u : __float_as_uint(w);
      }
    }
    consumer_sync();
  }

  // Phase 4: the weighted V sum plus position t's term, written to
  // out[0, F) in T. Reads the stage; ends without a barrier.
  __device__ void values(const Beam<T>& b, int tid, T* out) const {
    const int F = d.F, H = d.H, D = d.D, Mc = d.Mc;
    if (!d.vec) {
      for (int f = tid; f < F; f += kConsumers) {
        const int h = f / D;
        float acc = 0.f;
        for (int m = 0; m < Mc; ++m) {
          const float v = m == b.ovr ? bf16_round(to_f(b.kg[F + f]))
                                     : row_v<T, KIND>(row(b, m), f, F);
          acc += rd<RB>(pe_f(m * H + h) * v);
        }
        acc += pn()[h] * to_f(b.kvn[F + f]);
        out[f] = from_f<T>(acc);
      }
      return;
    }
    const int ncv = F / CPC, G = lay.G;
    float* pt = part();
    for (int item = tid; item < ncv * G; item += kConsumers) {
      const int c = item % ncv, g = item / ncv;
      const int f0 = c * CPC, h = f0 / D;
      float acc[CPC];
#pragma unroll
      for (int i = 0; i < CPC; ++i) acc[i] = 0.f;
      for (int m = g; m < Mc; m += G) {
        if (m == b.ovr) {
          const float w = pe_f(m * H + h);
#pragma unroll
          for (int i = 0; i < CPC; ++i)
            acc[i] += rd<RB>(w * bf16_round(to_f(b.kg[F + f0 + i])));
          continue;
        }
        const char* v = row(b, m) + v_off<T, KIND>(f0, F);
        if constexpr (RB) {
          uint32_t p[Chunk<KIND>::WORDS];
          Chunk<KIND>::pv(v, pe()[m * H + h], p);
#pragma unroll
          for (int j = 0; j < Chunk<KIND>::WORDS; ++j) {
            acc[Chunk<KIND>::col(j, 0)] += lo_f(p[j]);
            acc[Chunk<KIND>::col(j, 1)] += hi_f(p[j]);
          }
        } else {
          const float w = pe_f(m * H + h);
          const float4 vv = *reinterpret_cast<const float4*>(v);
          acc[0] += __fmul_rn(w, vv.x);
          acc[1] += __fmul_rn(w, vv.y);
          acc[2] += __fmul_rn(w, vv.z);
          acc[3] += __fmul_rn(w, vv.w);
        }
      }
      float4* dst = reinterpret_cast<float4*>(pt + g * F + f0);
#pragma unroll
      for (int i = 0; i < CPC / 4; ++i)
        dst[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                             acc[4 * i + 3]);
    }
    consumer_sync();
    for (int f = tid; f < F; f += kConsumers) {
      const int h = f / D;
      float acc = 0.f;
      for (int g = 0; g < G; ++g) acc += pt[g * F + f];
      acc += pn()[h] * to_f(b.kvn[F + f]);
      out[f] = from_f<T>(acc);
    }
  }
};

// The consumers stage the biases once per block: bias_hist [Mc, H], then
// bias_new [H] (pair index m * H + h, m = Mc for position t).
__device__ __forceinline__ void stage_biases(float* dst, const float* hist,
                                             const float* fresh, int Mc,
                                             int H) {
  for (int i = threadIdx.x; i < (Mc + 1) * H; i += blockDim.x)
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

}  // namespace staged
}  // namespace ripor
