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
// Two consumer schedules, one kernel launch a call either way; the wrapper
// (ops/megarow.py seq_schedule) picks one from the shapes and dtypes alone:
//
// The per-head schedule (step_attention_seq_kernel_heads): int8 or packed
// int4 rows, bf16 q, D a multiple of 16 up to 128, a slab one stage holds
// (ops/staging.py heads_plan): the megarow path's quantized caches and
// K2'. One warp owns a (beam, head) from its scores to its output columns
// and its part of the emitted row, so a beam needs no block-wide barrier:
// a warp arrives on the stage's empty barrier once its heads are done, and
// the warps of a block drift over the beams the ring holds. Rows are
// staged one bulk copy a row at a stride of an odd number of 16-byte chunks
// (eight rows, eight bank groups). The per-block scratch is a word a slot
// and the head's q pairs for each warp, so three blocks an SM (48
// registers a thread) hold two or more stages each at t5-base. What bounds
// it is issue: a (beam, head) is a chain of dependent steps (dots, a
// softmax, V sums, the emitted row's quantization) with ~4 instructions a
// cached value, so the design keeps instructions few: one LOP3 a nibble
// pair (the 0x4300 pair in a register), four columns a lane in the V sums
// with one halving across slot groups, the position-t dot, the slots' max
// and the emitted row's absmax in one pass of butterflies, and the emitted
// row's exponents from the absmax's bits.
//
// The staged core (attend_staged.cuh's Core, step_attention_seq_kernel):
// exact bf16 or f32 rows, f32 q, head widths of no 16-byte multiple and
// slabs no stage holds. Persistent blocks; the producer warp stages each
// beam's layer slab cache[b, n, l] (Mc*RW contiguous bytes), q and kv_new
// with bulk async copies into a ring of stages; eight consumer warps run
// the attention from shared memory in four phases a beam. A slab larger
// than one stage (t5-3b widths in bf16 or int8 rows, t5-large in f32)
// streams through the ring in slot chunks, twice: once for the scores,
// once for the V sums. An exact bf16 slab is 3.4x a packed int4 one, and
// this schedule keeps such a slab near its byte bound (PERF.md, section 6).
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

// ---------------------------------------------------------------------------
// The per-head schedule: int8 or packed int4 rows, bf16 q, whole slabs
// ---------------------------------------------------------------------------

constexpr int kHeadsMaxWarps = 12;  // consumer warps of a block, at most
constexpr int kHeadsThreads = 32 * (kHeadsMaxWarps + 1);
constexpr int kHeadsMaxStages = 8;  // barrier slots
// Blocks an SM must hold (__launch_bounds__): three, at most 48 registers a
// thread; ops/staging.py heads_plan sizes the ring for three
constexpr int kHeadsMinBlocks = 3;

// Consumer warps for H heads: one a head up to kHeadsMaxWarps, else the
// fewest rounds of heads with the warps spread evenly over them.
inline int heads_warps(int H) {
  const int rounds = (H + kHeadsMaxWarps - 1) / kHeadsMaxWarps;
  return (H + rounds - 1) / rounds;
}

// A staged row's stride: RW rounded up to an odd number of 16-byte chunks,
// so that eight consecutive rows start in eight different bank groups
inline int heads_row_stride(int RW) { return RW / 16 % 2 ? RW : RW + 16; }

// Byte offsets of the per-head schedule's dynamic shared memory
// (ops/staging.py heads_plan mirrors this and passes the total): the
// barriers, the biases head-major ([H][Mc + 1], position t last), each
// consumer warp's scratch (a word a slot: its score, then its probability;
// the head's q pairs), then the stages (the rows at ``stride`` bytes, q,
// kv_new).
struct HeadsLayout {
  int bias, scratch, scratch_bytes, qw, stage0;  // qw: within a scratch
  int stride, q, kvn, stage_bytes;               // within a stage
};

inline HeadsLayout make_heads_layout(int Mc, int F, int H, int RW,
                                     int warps) {
  HeadsLayout l{};
  long long off = a16(2LL * kHeadsMaxStages * 8);
  l.bias = int(off);     off += a16((Mc + 1LL) * H * 4);
  l.qw = int(a16(4LL * Mc));
  l.scratch_bytes = int(l.qw + a16(2LL * (F / H)));
  l.scratch = int(off);  off += 1LL * warps * l.scratch_bytes;
  l.stage0 = int(off);
  l.stride = heads_row_stride(RW);
  long long s = a16(1LL * Mc * l.stride);
  l.q = int(s);          s += a16(2LL * F);
  l.kvn = int(s);        s += a16(4LL * F);
  l.stage_bytes = int(s);
  return l;
}

// nib2 with the mask and the 0x4300 pair in one LOP3: two immediates do not
// fit one, so the pair comes in a register (``magic``, from heads_magic)
__device__ __forceinline__ uint32_t nib2r(uint32_t x, uint32_t magic) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;"
      : "=r"(d)
      : "r"(x), "r"(0x000f000fu), "r"(magic));
  return bsub(d, 0x43084308u);
}
// 0x43004300 in a register the compiler keeps (it would rebuild a known
// constant at every use)
__device__ __forceinline__ uint32_t heads_magic() {
  uint32_t m;
  asm("mov.b32 %0, 0x43004300;" : "=r"(m));
  return m;
}

// K*q products of one 16-byte chunk of a row's K bytes, as Chunk<KIND>::kq
template <int KIND>
__device__ __forceinline__ void heads_kq(const char* k, const uint32_t* q,
                                         uint32_t* p, uint32_t magic) {
  if constexpr (KIND == 2) {
    const uint4 w = *reinterpret_cast<const uint4*>(k);
    const uint32_t x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[2 * i] = bmul(nib2r(x[i], magic), q[2 * i]);
      p[2 * i + 1] = bmul(nib2r(x[i] >> 8, magic), q[2 * i + 1]);
    }
  } else {
    Chunk<1>::kq(k, q, p);
  }
}

// The V values of one 32-bit row word (its columns 0-3) as two bf16x2
// pairs; half hf of pair j is column vcol(j, hf)
template <int KIND>
__device__ __forceinline__ void heads_vals(uint32_t x, uint32_t* v,
                                           uint32_t magic) {
  if constexpr (KIND == 2) {  // V in each byte's high nibble
    v[0] = nib2r(x >> 4, magic);
    v[1] = nib2r(x >> 12, magic);
  } else {
    const uint32_t xu = x ^ 0x80808080u;
    v[0] = i8pair(xu, 0);
    v[1] = i8pair(xu, 2);
  }
}
template <int KIND>
__host__ __device__ constexpr int vcol(int j, int hf) {
  return KIND == 2 ? j + 2 * hf : 2 * j + hf;
}

// One level of the V sums' reduction across slot groups: this lane and the
// lane ``off`` away in the group that differs in ``bit`` each keep one half
// of acc[0, 2 HALF), the lower where this group's bit is clear, and add the
// other's copy of it; HALF 0: both add their one sum. Lanes of no group
// (act false) exchange with themselves.
template <int HALF>
__device__ __forceinline__ void halve(float* acc, int lane, int g, bool act,
                                      int bit, int off, int& base) {
  const bool up = g & bit;
  const int src = act ? (up ? lane - off : lane + off) : lane;
  if constexpr (HALF == 0) {
    acc[0] += __shfl_sync(0xffffffffu, acc[0], src);
  } else {
#pragma unroll
    for (int k = 0; k < HALF; ++k) {
      const float send = up ? acc[k] : acc[k + HALF];
      const float keep = up ? acc[k + HALF] : acc[k];
      acc[k] = keep + __shfl_sync(0xffffffffu, send, src);
    }
    base += up ? HALF : 0;
  }
}

// A lane's NN column sums plus position t's term pn * v_new, written to
// attn in bf16 (pairs as one 32-bit store)
template <int NN>
__device__ __forceinline__ void put_cols(const float* acc, float pn,
                                         const __nv_bfloat16* vn,
                                         __nv_bfloat16* out) {
  if constexpr (NN == 1) {
    out[0] = __float2bfloat16_rn(acc[0] + pn * to_f(vn[0]));
  } else {
#pragma unroll
    for (int k = 0; k < NN; k += 2) {
      const uint32_t v = *reinterpret_cast<const uint32_t*>(vn + k);
      *reinterpret_cast<uint32_t*>(out + k) =
          pack2(acc[k] + pn * lo_f(v), acc[k + 1] + pn * hi_f(v));
    }
  }
}

// row_codec.cuh quant_exponent for a bf16 group's absmax ``a`` at qmax 7
// (int4) or 127 (int8), from a's exponent and mantissa bits:
// ceil(log2(max(a, 1e-30) / qmax)) is k - 2 (k - 6) for a in [2^k, 2^k
// 1.75] ([2^k, 2^k 1.984375]) and one more above; log2f of the quotient
// gives the same for every bf16 a (its quotient's mantissa is 1 or at least
// 1 + 1/256: no rounding at a power of two), clipped to [-100, 100].
template <int KIND>
__device__ __forceinline__ int bf16_quant_exponent(float a) {
  const uint32_t b = __float_as_uint(fmaxf(a, 1e-30f));
  const int k = static_cast<int>(b >> 23) - 127;
  const int e = KIND == 2 ? k - 2 + ((b & 0x7fffffu) > 0x600000u)
                          : k - 6 + ((b & 0x7fffffu) > 0x7e0000u);
  return min(max(e, -100), 100);
}

// One warp writes head h of position t's K|V row (kvn, bf16, K then V) into
// the cache row ``row`` (global): the values of row_codec.cuh quant_row at
// the exponents ek and ev (bf16_quant_exponent of the head's K and V
// absmax), each lane taking column pairs 2 lane + 64 i (one 16-bit store a
// pair and a plane).
template <int KIND>
__device__ __forceinline__ void emit_head(const __nv_bfloat16* kvn, int F,
                                          int H, int D, int h, int ek, int ev,
                                          int8_t* row, int lane) {
  const __nv_bfloat16* k = kvn + h * D;
  const __nv_bfloat16* v = kvn + F + h * D;
  const float sk = pow2i(-ek), sv = pow2i(-ev);
  int8_t* tail = row + (KIND == 2 ? F : 2 * F);
  for (int d = 2 * lane; d < D; d += 64) {
    const uint32_t kw = *reinterpret_cast<const uint32_t*>(k + d);
    const uint32_t vw = *reinterpret_cast<const uint32_t*>(v + d);
    if constexpr (KIND == 2) {
      uint32_t b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float x = i ? hi_f(kw) : lo_f(kw), y = i ? hi_f(vw) : lo_f(vw);
        const int qk =
            static_cast<int>(fminf(fmaxf(rintf(x * sk), -8.f), 7.f));
        const int qv =
            static_cast<int>(fminf(fmaxf(rintf(y * sv), -8.f), 7.f));
        b[i] = static_cast<uint32_t>(qk + INT4_OFFSET) |
               (static_cast<uint32_t>(qv + INT4_OFFSET) << 4);
      }
      *reinterpret_cast<uint16_t*>(row + h * D + d) =
          static_cast<uint16_t>(b[0] | (b[1] << 8));
    } else {
      const auto q8 = [](float x, float s) {
        return static_cast<uint32_t>(static_cast<uint8_t>(
            static_cast<int8_t>(static_cast<int>(rintf(x * s)))));
      };
      *reinterpret_cast<uint16_t*>(row + h * D + d) = static_cast<uint16_t>(
          q8(lo_f(kw), sk) | (q8(hi_f(kw), sk) << 8));
      *reinterpret_cast<uint16_t*>(row + F + h * D + d) =
          static_cast<uint16_t>(q8(lo_f(vw), sv) | (q8(hi_f(vw), sv) << 8));
    }
  }
  if (lane == 0) {
    tail[h] = static_cast<int8_t>(ek);
    tail[H + h] = static_cast<int8_t>(ev);
  }
  // the tail's unused bytes, spread over the heads
  for (int i = 2 * H + h + H * lane; i < SCALE_COLS; i += 32 * H) tail[i] = 0;
}

// K2 (K2' with XPV) on int8 (KIND 1) or packed int4 (KIND 2) rows and bf16
// q, each beam's slab staged whole; DK: the head width where an instance
// has it built in (64), else 0. The producer warp (the last) stages a
// beam's rows one bulk copy a row at the padded stride, q and kv_new; each
// consumer warp takes heads h = warp, warp + warps, ... of every beam and
// runs a head's chain alone:
//   position t's score (bf16x2 products of its own key), the slots' scores
//   (S lanes a slot, 16-byte chunks), the softmax in registers and warp
//   shuffles with each probability times 2^ev rounded to bf16 into the
//   warp's scratch, the V sums (a lane a 32-bit row word, four columns,
//   over its slot group's slots; the groups' sums halved across lanes),
//   position t's term, attn, and with emit that head's part of the cache
//   row.
// A warp arrives on the stage's empty barrier once it has done its heads of
// the beam; no barrier spans the block after the start.
template <int KIND, bool XPV, int DK>
__global__ void __launch_bounds__(kHeadsThreads, kHeadsMinBlocks)
step_attention_seq_kernel_heads(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ kv_new,
                                const char* __restrict__ cache,
                                const float* __restrict__ bias_hist,
                                const float* __restrict__ bias_new,
                                __nv_bfloat16* __restrict__ attn,
                                int8_t* __restrict__ kvq, long long BN, int L,
                                int Mc, int F, int H, int RW, int layer,
                                int emit, HeadsLayout lay, int stages,
                                int warps, int bulk) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kHeadsMaxStages;
  float* bias = reinterpret_cast<float*>(smem + lay.bias);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = lay.stride;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], warps);
    }
    mbar_init_fence();
  }
  for (int k = tid; k < (Mc + 1) * H; k += blockDim.x) {
    const int h = k / (Mc + 1), m = k - h * (Mc + 1);
    bias[k] = m < Mc ? bias_hist[m * H + h] : bias_new[h];
  }
  __syncthreads();

  if (warp == warps) {  // the producer warp
    const long long slab = static_cast<long long>(Mc) * RW, qb = 2LL * F;
    int s = 0, phase = 0;  // the ring's stage and the phase it waits for
    bool wrapped = false;
    for (long long beam = blockIdx.x; beam < BN; beam += gridDim.x) {
      if (wrapped) mbar_wait(&empty[s], phase ^ 1);
      unsigned char* st = smem + lay.stage0 + s * lay.stage_bytes;
      const char* src = cache + (beam * L + layer) * slab;
      if (bulk) {
        if (lane == 0)
          mbar_arrive_tx(&full[s], static_cast<uint32_t>(slab + 3 * qb));
        __syncwarp();
        for (int m = lane; m < Mc; m += 32)
          bulk_load(st + m * P, src + static_cast<long long>(m) * RW,
                    static_cast<uint32_t>(RW), &full[s]);
      } else {
        for (int m = 0; m < Mc; ++m)
          stage_in(st + m * P, src + static_cast<long long>(m) * RW, RW,
                   &full[s], false, lane);
      }
      stage_in(st + lay.q, q + beam * F, qb, &full[s], bulk, lane);
      stage_in(st + lay.kvn, kv_new + beam * 2 * F, 2 * qb, &full[s], bulk,
               lane);
      stage_done(&full[s], bulk, lane);
      if (++s == stages) {
        s = 0;
        phase ^= 1;
        wrapped = true;
      }
    }
    return;
  }

  const int D = DK > 0 ? DK : F / H, nch = D / 16;
  // scores: S lanes a slot, S a power of two that divides nch, as many as
  // keep Mc * S within the warp's 32 lanes (one where Mc >= 32)
  int S = 1;
  while (nch % (2 * S) == 0 && 2 * S * Mc <= 32) S *= 2;
  const int logS = 31 - __clz(S);
  // V sums: RL = D / 4 lanes a row, lane c + RL g taking the row word c;
  // VG slot groups (a power of two; lanes past RL VG add nothing), group g
  // the slots blk (VG j + g) + i, i < blk: with blk 4, groups read rows
  // four apart, 64 bytes apart in the banks at the padded stride; fewer
  // slots than 4 VG spread over all groups
  const int RL = D / 4, VG = 1 << (31 - __clz(32 / RL));
  const int c = lane % RL, g = lane / RL;
  const bool act = g < VG;
  const int blk = Mc >= 4 * VG ? 4 : (Mc + VG - 1) / VG;
  const int ecol = KIND == 1 ? 2 * F : F;
  const uint32_t magic = heads_magic();
  unsigned char* ws = smem + lay.scratch + warp * lay.scratch_bytes;
  float* sw = reinterpret_cast<float*>(ws);
  uint32_t* pw = reinterpret_cast<uint32_t*>(ws);
  uint32_t* qw = reinterpret_cast<uint32_t*>(ws + lay.qw);
  int s = 0, phase = 0;
  for (long long beam = blockIdx.x; beam < BN; beam += gridDim.x) {
    mbar_wait(&full[s], phase);
    const unsigned char* st = smem + lay.stage0 + s * lay.stage_bytes;
    const char* rows = reinterpret_cast<const char*>(st);
    const __nv_bfloat16* qs =
        reinterpret_cast<const __nv_bfloat16*>(st + lay.q);
    const __nv_bfloat16* kvn =
        reinterpret_cast<const __nv_bfloat16*>(st + lay.kvn);
    for (int h = warp; h < H; h += warps) {
      const __nv_bfloat16* qh = qs + h * D;
      const float* bh = bias + h * (Mc + 1);
      // q's bf16 pairs as heads_kq takes them (int4: the nibble order,
      // columns 0, 2 | 1, 3 of each four)
      const uint32_t* q2 = reinterpret_cast<const uint32_t*>(qh);
      if (KIND == 2) {
        for (int k = lane; k < D / 4; k += 32) {
          const uint2 w = *reinterpret_cast<const uint2*>(qh + 4 * k);
          qw[2 * k] = __byte_perm(w.x, w.y, 0x5410);
          qw[2 * k + 1] = __byte_perm(w.x, w.y, 0x7632);
        }
        q2 = qw;
      }
      // position t's partial dot (its own key's rounded products,
      // pairwise), and the partial absmax of the head's K (high half) and
      // V (low half) for the emitted row, as bf16 bits: a bf16 magnitude
      // orders as its bits do
      float a = 0.f;
      uint32_t kvmax = 0;
      for (int d = 2 * lane; d < D; d += 64) {
        const uint32_t kw =
            *reinterpret_cast<const uint32_t*>(kvn + h * D + d);
        const uint32_t vw =
            *reinterpret_cast<const uint32_t*>(kvn + F + h * D + d);
        const uint32_t pr =
            bmul(kw, *reinterpret_cast<const uint32_t*>(qh + d));
        a += lo_f(pr);
        a += hi_f(pr);
        const uint32_t ka = kw & 0x7fff7fffu, va = vw & 0x7fff7fffu;
        kvmax = __vmaxu2(kvmax, __vmaxu2(__byte_perm(va, ka, 0x7632),
                                         __byte_perm(va, ka, 0x5410)));
      }
      __syncwarp();

      // the slots' scores: lane p (+ 32, ...) takes slot p / S and its
      // chunks j = p mod S (+ S, ...); the partial dots are summed over the
      // slot's lanes
      float mx = -INFINITY;
#pragma unroll 1
      for (int p0 = 0; p0 < Mc * S; p0 += 32) {
        const int m = (p0 + lane) >> logS, j0 = lane & (S - 1);
        const char* r = rows + m * P + h * D;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        // chunk j's products into acc
        const auto chunk = [&](int j) {
          const uint4 qa = *reinterpret_cast<const uint4*>(q2 + 8 * j);
          const uint4 qb = *reinterpret_cast<const uint4*>(q2 + 8 * j + 4);
          const uint32_t qv[8] = {qa.x, qa.y, qa.z, qa.w,
                                  qb.x, qb.y, qb.z, qb.w};
          uint32_t pr[8];
          heads_kq<KIND>(r + 16 * j, qv, pr, magic);
#pragma unroll
          for (int w = 0; w < 8; w += 2) {
            acc[0] += lo_f(pr[w]);
            acc[1] += hi_f(pr[w]);
            acc[2] += lo_f(pr[w + 1]);
            acc[3] += hi_f(pr[w + 1]);
          }
        };
#pragma unroll 1
        for (int j = j0; m < Mc && j < nch; j += S) chunk(j);
        float dot = (acc[0] + acc[1]) + (acc[2] + acc[3]);
        for (int o = 1; o < S; o <<= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        if (m < Mc && j0 == 0) {
          const int8_t* e =
              reinterpret_cast<const int8_t*>(rows + m * P) + ecol;
          const float sc = dot * pow2i(e[h]) + bh[m];
          sw[m] = sc;
          mx = fmaxf(mx, sc);
        }
      }
      // three butterflies in step: position t's dot, the slots' max, the K
      // and V absmax
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, o);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        kvmax = __vmaxu2(kvmax, __shfl_xor_sync(0xffffffffu, kvmax, o));
      }
      const float s_new = a + bh[Mc];
      mx = fmaxf(mx, s_new);
      __syncwarp();  // slot m's score, from lane S m, to lane m

      // softmax over the Mc + 1 positions; each slot's probability times
      // 2^ev, rounded to bf16, as a bf16x2 pair for the V sums
      float sum = 0.f;
#pragma unroll 1
      for (int m = lane; m < Mc; m += 32) {
        const float e = expf(sw[m] - mx);
        sw[m] = e;
        sum += e;
      }
      const float en = expf(s_new - mx);
      sum = warp_sum(sum) + en;
#pragma unroll 1
      for (int m = lane; m < Mc; m += 32) {
        const int8_t* e = reinterpret_cast<const int8_t*>(rows + m * P) + ecol;
        pw[m] = bf16_bits(sw[m] / sum * pow2i(e[H + h])) * 0x10001u;
      }
      const float pn = bf16_round(en / sum);
      __syncwarp();

      // V sums of row word c over group g's slots
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      // slot m's products (its row word at vr, its probability pair pe)
      const auto vslot = [&](const char* vr, uint32_t pe) {
        uint32_t v[2];
        heads_vals<KIND>(*reinterpret_cast<const uint32_t*>(vr), v, magic);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if constexpr (XPV) {
            const float w = lo_f(pe);
            acc[vcol<KIND>(j, 0)] += __fmul_rn(w, lo_f(v[j]));
            acc[vcol<KIND>(j, 1)] += __fmul_rn(w, hi_f(v[j]));
          } else {
            const uint32_t pr = bmul(v[j], pe);
            acc[vcol<KIND>(j, 0)] += lo_f(pr);
            acc[vcol<KIND>(j, 1)] += hi_f(pr);
          }
        }
      };
      if (act) {
        const char* vb = rows + (KIND == 1 ? F : 0) + h * D + 4 * c;
#pragma unroll 1
        for (int m0 = blk * g; m0 < Mc; m0 += blk * VG) {
          const char* vr = vb + m0 * P;
          if (blk == 4 && m0 + 4 <= Mc) {  // four slots, 16-byte aligned in pw
            const uint4 pe = *reinterpret_cast<const uint4*>(pw + m0);
            vslot(vr, pe.x);
            vslot(vr + P, pe.y);
            vslot(vr + 2 * P, pe.z);
            vslot(vr + 3 * P, pe.w);
          } else {
#pragma unroll 1
            for (int k = 0; k < blk && m0 + k < Mc; ++k)
              vslot(vr + k * P, pw[m0 + k]);
          }
        }
      }
      // across the groups: each lane keeps 4 / VG of its word's columns
      // from ``base`` (one where VG = 8: groups 4-7 hold copies)
      int base = 0;
      if (VG > 1) halve<2>(acc, lane, g, act, 1, RL, base);
      if (VG > 2) halve<1>(acc, lane, g, act, 2, 2 * RL, base);
      if (VG > 4) halve<0>(acc, lane, g, act, 4, 4 * RL, base);
      if (act && g < 4) {
        const int f0 = h * D + 4 * c + base;
        __nv_bfloat16* out = attn + beam * F + f0;
        const __nv_bfloat16* vn = kvn + F + f0;
        if (VG == 1) put_cols<4>(acc, pn, vn, out);
        else if (VG == 2) put_cols<2>(acc, pn, vn, out);
        else put_cols<1>(acc, pn, vn, out);
      }

      if (emit)
        emit_head<KIND>(kvn, F, H, D, h,
                        bf16_quant_exponent<KIND>(hi_f(kvmax)),
                        bf16_quant_exponent<KIND>(lo_f(kvmax)),
                        kvq + beam * RW, lane);
      __syncwarp();  // the scratch is the next head's
    }
    release(&empty[s], lane);
    if (++s == stages) {
      s = 0;
      phase ^= 1;
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

template <int KIND, bool XPV>
cudaError_t launch_heads(const void* q, const void* kv_new, const void* cache,
                         const void* bias_hist, const void* bias_new,
                         void* attn, void* kvq, long long BN, int L, int Mc,
                         int F, int H, int RW, int layer, int emit,
                         long long warps, long long stages, long long smem,
                         cudaStream_t stream) {
  if (H < 1 || F % H != 0 || (F / H) % 16 != 0 || F / H > 128 ||
      2 * H > SCALE_COLS || RW != (KIND == 1 ? 2 * F : F) + SCALE_COLS ||
      warps != heads_warps(H) || stages < 1 || stages > kHeadsMaxStages)
    return cudaErrorInvalidValue;
  const HeadsLayout lay = make_heads_layout(Mc, F, H, RW, int(warps));
  if (smem > kSmemLimit || lay.stage0 + stages * lay.stage_bytes != smem)
    return cudaErrorInvalidValue;
  // bulk copies: 16-byte rows (F is a multiple of 16) and addresses
  const int bulk = aligned16(q) && aligned16(kv_new) && aligned16(cache);
  auto kernel = F / H == 64 ? step_attention_seq_kernel_heads<KIND, XPV, 64>
                            : step_attention_seq_kernel_heads<KIND, XPV, 0>;
  const int threads = 32 * (static_cast<int>(warps) + 1);
  int resident;
  cudaError_t err = resident_blocks(reinterpret_cast<const void*>(kernel),
                                    static_cast<int>(smem), &resident,
                                    threads);
  if (err != cudaSuccess) return err;
  const long long grid = BN < resident ? BN : resident;
  kernel<<<static_cast<unsigned>(grid), threads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kv_new),
      static_cast<const char*>(cache), static_cast<const float*>(bias_hist),
      static_cast<const float*>(bias_new), static_cast<__nv_bfloat16*>(attn),
      static_cast<int8_t*>(kvq), BN, L, Mc, F, H, RW, layer, emit, lay,
      static_cast<int>(stages), static_cast<int>(warps), bulk);
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

// The per-head schedule of K2 (mxu: K2'): kind 1 int8, 2 int4 rows, q,
// kv_new and attn bfloat16, each beam's slab in one stage. kvq may be null
// when emit == 0. warps, stages and smem: the launch plan of
// ripor_tpu_torch/ops/staging.py heads_plan.
extern "C" int step_attention_seq_heads(const void* q, const void* kv_new,
                                        const void* cache,
                                        const void* bias_hist,
                                        const void* bias_new, void* attn,
                                        void* kvq, long long BN, long long L,
                                        long long Mc, long long F,
                                        long long H, long long RW,
                                        long long layer, long long kind,
                                        long long emit, long long warps,
                                        long long stages, long long smem,
                                        long long mxu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (BN == 0) return cudaSuccess;
#define RIPOR_HEADS(K, X)                                                  \
  err = launch_heads<K, X>(q, kv_new, cache, bias_hist, bias_new, attn,    \
                           kvq, BN, int(L), int(Mc), int(F), int(H),       \
                           int(RW), int(layer), int(emit), warps, stages,  \
                           smem, s)
  if (kind == 1) {
    if (mxu) RIPOR_HEADS(1, true);
    else RIPOR_HEADS(1, false);
  } else if (kind == 2) {
    if (mxu) RIPOR_HEADS(2, true);
    else RIPOR_HEADS(2, false);
  }
#undef RIPOR_HEADS
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
