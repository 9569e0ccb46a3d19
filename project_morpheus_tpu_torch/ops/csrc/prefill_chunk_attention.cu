// Chunk-prefill attention over the slot KV cache, for Hopper (sm_90a).
//
// Replaces the JAX package's _chunk_streaming_attn
// (project_morpheus_tpu/model/llama.py:643), which XLA fuses into the jitted
// chunk-prefill programs and vmaps over the J jobs of a round.  It is not a
// Pallas kernel; the port writes it by hand so that a prefill round is a few
// launches a layer and captures as a CUDA graph.  It computes what that
// function computes, for each job j, kv head h and query row (c, g):
//   q = bf16(q * HD^-0.5); s_p = q.k_p (bf16 operands, fp32 sums) [* kscale_p]
//   over positions p <= offsets[j] + c (and p < hist); online softmax in
//   fp32; P.V with p [* vscale_p] rounded to bf16, fp32 sums; out = acc / l.
// int8 history is exact in bf16 (|x| <= 127), so both layouts run the same
// bf16 tensor-core products:
//   int8, position-major: k, v (B, S, KV*HD), scales (B, S, 2*KV), k first;
//   bf16, head-major:     k, v (B, KV, S, HD).
//
// Bound: at the serving shapes (a 1024-token chunk over up to 8192 positions
// of history, 24 query heads of 128) the causal products are ~2 x 4 x HD
// flop for every (query, key) pair, ~100 GFLOP a layer and job, against
// ~34 MB of K/V read: operations bound it (~0.1 ms at 989 TFLOP/s).  The
// design (the measurements behind it: tools/kernel_ablation.py prefill and
// PERF.md):
//
// - A block is one warpgroup that copies and kCons = 2 consumer warpgroups
//   of 64 (position, head) rows each, position-major, of one kv head: the G
//   query heads of a kv head share every K/V tile, and any G works.  Each
//   consumer runs both products on wgmma (bf16, fp32 accumulators): S = Q.K^T
//   with Q (loaded once, scaled, rounded, 128-byte swizzled) and the K tile
//   as K-major shared operands; O += P.V with P in registers and the V tile
//   as the MN-major shared operand (wgmma's transpose).  setmaxnreg gives the
//   copying warpgroup 24 (bf16) or 64 (int8) registers a thread and the
//   consumers the rest (240 or 224); the roles branch on a warp index taken
//   through a shuffle, so ptxas sees them warp-uniform.  Q stays in shared
//   memory: with Q in registers as well ptxas serialised the wgmmas.
// - Thread 0 streams 64-key tiles with TMA (cp.async.bulk.tensor, 3-D
//   tensor maps passed as __grid_constant__ arguments, so a launch captures
//   into a CUDA graph) into a ring of stages guarded by mbarriers; the slot
//   and the chunk's offset come from device memory as coordinates, so one
//   launch serves any offsets and slots.  bf16 tiles land 128-byte
//   swizzled, as wgmma's descriptors read them (6 stages).  int8 tiles land
//   as they are, with one box of the tile's scale rows (3 stages); the four
//   warps of the copying warpgroup convert each to the swizzled bf16 layout
//   (exact: a byte-permute and bit operations, as int8_gemv.cu does) in a
//   second ring (3 stages), with this head's k and v scales in the order
//   the consumers read them, while the consumers work on the tiles before.
// - Each consumer overlaps its softmax with the tensor cores: it issues
//   S(t) and then P(t-1).V(t-1), and computes tile t's softmax while the
//   second product runs.  The softmax works in base 2 (ex2.approx; log2 e
//   folded into the int8 k scales); the causal mask runs only on tiles that
//   cross one of the warpgroup's frontiers; the output is rescaled only when
//   a row's maximum rose; a warpgroup past its last key stops.
// - Heaviest first: blockIdx.z counts row tiles down from the last (the rows
//   with the most keys), and is the slowest grid dimension, so the blocks
//   with the most work start in the first wave.  (The row tile as the
//   fastest dimension shares each K/V tile in L2 between more blocks: it
//   ran faster at 8192 positions of history, slower at the main path's
//   1024-position rounds, whose heaviest blocks then start late.)
// - The reference takes each 256-key block's maxima before it rounds p *
//   v-scale to bf16; a 64-key running maximum rounds some p at another
//   scale, and a short row with cancelling terms then drifts past the
//   bound chip_smoke.check_close sets.  So the maxima of keys 0..255 (the
//   block that holds a row's largest score most often, and all of a short
//   row's keys) are taken first, in a pass of S alone over those tiles.
// - What limits it: the tile loads and, for int8, the conversion beside
//   the consumers (tools/kernel_ablation.py prefill: loads_only,
//   no_convert, no_tma).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_bf16.cuh"  // cvt2

namespace mp {
namespace {

constexpr int kCons = 2;                     // consumer warpgroups a block
constexpr int kThreads = 128 * (kCons + 1);  // and one warpgroup that copies
constexpr int kRows = 64 * kCons;            // (position, head) rows a block
constexpr int kKeysBf = 64;                  // keys a tile, bf16 cache
constexpr int kKeysI8 = 64;                  // keys a tile, int8 cache (two rings must fit)
constexpr int kStages = 6;                   // bf16 ring
constexpr int kRawStages = 3;                // int8 ring as copied (2 where 3 do not fit)
constexpr int kCvtStages = 4;                // int8 ring as converted to bf16
constexpr int kFirstBlock = 256;             // keys of the reference's first softmax block
constexpr int kConvThreads = 128;            // the copying warpgroup converts int8 tiles
// Registers a thread after setmaxnreg.  The block starts with the 168 a
// thread that __launch_bounds__(384, 1) allows: a pool of 64,512.  The
// copying warpgroup keeps what it needs (one thread's TMA issue for bf16;
// the int8 conversion) and the consumers take the rest; asking for more
// than the pool holds would block their setmaxnreg.inc for ever.
constexpr int kPool = kThreads * (65536 / kThreads / 8 * 8);
constexpr int consumer_regs(int producer) {
  return (kPool - 128 * producer) / (128 * kCons) / 8 * 8 < 240
             ? (kPool - 128 * producer) / (128 * kCons) / 8 * 8
             : 240;
}
constexpr int kProducerRegs[2] = {24, 56};  // bf16, int8
constexpr int kConsumerRegs[2] = {consumer_regs(kProducerRegs[0]),
                                 consumer_regs(kProducerRegs[1])};
static_assert(consumer_regs(24) == 240 && consumer_regs(56) == 224, "register split");
constexpr int kSmemLimit = 227 * 1024 - 1024;  // less 1 KB for the static barriers
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const __nv_bfloat16* q;  // (J, C, H, HD)
  const int* slots;        // (J,) cache lanes
  const int* offsets;      // (J,) chunk start positions
  __nv_bfloat16* out;      // (J, C, H, HD)
  int C, H, KV, G, hist;
  int raw_stage;           // int8: bytes of one copied stage (K, V, scale rows)
  int raw_stages;          // int8: stages of the copied ring
  float sm_scale;
};

constexpr int align1k(int x) { return (x + 1023) / 1024 * 1024; }

template <typename T, int HD>
struct Geom {
  static constexpr bool kQuant = sizeof(T) == 1;
  static constexpr int kBK = kQuant ? kKeysI8 : kKeysBf;
  static constexpr int kTileBf = kBK * HD * 2;   // a bf16 K or V tile
  static constexpr int kColBlock = kBK * 128;    // its 64-dim (128-byte) column blocks
  static constexpr int kStageBf = 2 * kTileBf;   // bf16 ring stage: K, V
  static constexpr int kQ = 64 * HD * 2;         // a consumer warpgroup's Q
  static constexpr int kTileRaw = kBK * HD;      // an int8 K or V tile
  // converted stage: K, V, this head's k scales, v scales
  static constexpr int kCvt = align1k(2 * kTileBf + 2 * kBK * 4);
  static int raw_stage(int KV) { return align1k(2 * kTileRaw + kBK * 2 * KV * 4); }
  // dynamic shared memory: Q, then the rings; 1 KB more to align the base
  // to the swizzle's 1 KB
  static int smem(int KV, int raw_stages) {
    return 1024 + kCons * kQ +
           (kQuant ? raw_stages * raw_stage(KV) + kCvtStages * kCvt : kStages * kStageBf);
  }
  // the first block's tiles stay in the ring while the consumers take
  // their maximum
  static_assert((kQuant ? kCvtStages : kStages) >= kFirstBlock / kBK, "ring too short");
  static_assert(HD % 64 == 0, "rows are whole 128-byte column blocks");
};

// ------------------------------------------------------------ primitives

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// 3-D tensor copy of one box into this block's shared memory
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                          int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// shared-memory writes of this thread visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// wgmma descriptor of a 128-byte-swizzled shared operand starting at addr
// (atoms of 8 rows x 128 bytes, 1 KB-aligned); offsets in bytes
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of these registers across
// a wgmma wait (the hardware writes them asynchronously)
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// D (64 x N, fp32, N/2 a thread) (+)= A (64 x 16 bf16, registers: the
// mma.sync A fragment of each warp's 16 rows) x B (16 x N bf16, shared,
// N-major, by descriptor: wgmma transposes it); scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_pv_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_pv_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x N, fp32) (+)= A (64 x 16 bf16) x B (16 x N bf16), both K-major
// in shared memory, by descriptor; scale_d 0 overwrites D
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  if constexpr (N == 64) {
    wgmma_ss_n64(d, desc_a, desc_b, scale_d);
  } else {
    static_assert(N == 128, "wgmma widths 64 and 128");
    wgmma_ss_n128(d, desc_a, desc_b, scale_d);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc,
                                         int scale_d) {
  if constexpr (N == 64) {
    wgmma_pv_n64(d, a, desc, scale_d);
  } else {
    static_assert(N == 128, "wgmma widths 64 and 128");
    wgmma_pv_n128(d, a, desc, scale_d);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&x);
}

// Where key kk of a tile's scales is kept: the keys a consumer thread (tg =
// lane & 3) reads, 8n + 2tg + e, next to each other, so it reads its
// scales of a tile in 16-byte words.
template <int kBK>
__device__ __forceinline__ int scale_slot(int kk) {
  return ((kk & 7) >> 1) * (kBK / 4) + (kk >> 3) * 2 + (kk & 1);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two query values times sm_scale, rounded to bf16 as the JAX function
// rounds q before its dots
__device__ __forceinline__ uint32_t q_scaled(uint32_t pair, float scale) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pair));
  return pack_bf16(f.x * scale, f.y * scale);
}

// ------------------------------------------------------------ the kernel

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
    prefill_chunk_attn(const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap smap, const Args a) {
  using Ge = Geom<T, HD>;
  constexpr bool kQuant = Ge::kQuant;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  constexpr int kBK = Ge::kBK;
  __shared__ __align__(8) uint64_t full[kStages > kRawStages ? kStages : kRawStages];
  __shared__ __align__(8) uint64_t empty[kStages > kRawStages ? kStages : kRawStages];
  const int n_raw = a.raw_stages;
  __shared__ __align__(8) uint64_t cfull[kCvtStages], cempty[kCvtStages];
  const uint32_t raw_u32 = smem_u32(smem_raw);
  const uint32_t base = (raw_u32 + 1023) & ~1023u;
  unsigned char* const sbase = smem_raw + (base - raw_u32);

  const int tid = threadIdx.x, lane = tid & 31;
  // the warp index through a shuffle: ptxas then knows the role branch below
  // is warp-uniform, and gives each role the registers setmaxnreg sets
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int rt = gridDim.z - 1 - blockIdx.z;  // heaviest row tiles first
  const int h = blockIdx.x, j = blockIdx.y;
  const int G = a.G, C = a.C, CG = C * G;
  const int f0 = rt * kRows;
  const int b = a.slots[j], off = a.offsets[j];
  // the block's keys: through its last real row's position, inside hist
  const int c_last = min((f0 + kRows - 1) / G, C - 1);
  const int n_keys = min(off + c_last, a.hist - 1) + 1;
  const int n_tiles = (n_keys + kBK - 1) / kBK;
  // Q of each consumer warpgroup, then (bf16) the ring, or (int8) the ring
  // as copied and the ring as converted
  const uint32_t ring = base + kCons * Ge::kQ;
  const uint32_t cvt = ring + n_raw * a.raw_stage;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < (kQuant ? n_raw : kStages); ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kQuant ? kConvThreads : 4 * kCons);
    }
    if constexpr (kQuant) {
#pragma unroll
      for (int s = 0; s < kCvtStages; ++s) {
        mbar_init(smem_u32(&cfull[s]), kConvThreads);
        mbar_init(smem_u32(&cempty[s]), 4 * kCons);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // ---------------------------------------------- the copying warpgroup
    regs_dec<kProducerRegs[kQuant]>();
    // tile t's copies into its stage of the ring (bf16), or of the ring as
    // copied (int8), completing on that stage's full barrier
    auto issue = [&](int t) {
      const int s = t % (kQuant ? n_raw : kStages);
      const uint32_t bar = smem_u32(&full[s]);
      if constexpr (kQuant) {
        const uint32_t st = ring + s * a.raw_stage;
        const uint32_t bytes = 2 * Ge::kTileRaw + kBK * 2 * a.KV * 4;
        mbar_expect_tx(bar, bytes);
        tma_load3(st, &kmap, h * HD, t * kBK, b, bar);
        tma_load3(st + Ge::kTileRaw, &vmap, h * HD, t * kBK, b, bar);
        tma_load3(st + 2 * Ge::kTileRaw, &smap, 0, t * kBK, b, bar);
      } else {
        const uint32_t st = ring + s * Ge::kStageBf;
        const uint32_t bytes = Ge::kStageBf;
        mbar_expect_tx(bar, bytes);
#pragma unroll
        for (int cb = 0; cb < HD / 64; ++cb) {
          tma_load3(st + cb * Ge::kColBlock, &kmap, cb * 64, t * kBK, b * a.KV + h, bar);
          tma_load3(st + Ge::kTileBf + cb * Ge::kColBlock, &vmap, cb * 64, t * kBK,
                    b * a.KV + h, bar);
        }
      }
    };
    if constexpr (!kQuant) {
      if (tid != 0) return;
      for (int t = 0; t < n_tiles; ++t) {
        if (t >= kStages) mbar_wait(smem_u32(&empty[t % kStages]), (t / kStages + 1) & 1);
        issue(t);
      }
    } else {
      // All four warps turn each landed int8 tile into the swizzled bf16 K
      // and V of a converted stage, with this head's scales beside them;
      // thread 0 also keeps the next n_raw - 1 tiles in flight.
      constexpr int kPieces = HD / 16;  // 16 int8 values a piece
      if (tid == 0) {
        for (int t = 0; t < min(n_raw - 1, n_tiles); ++t) issue(t);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int u = t + n_raw - 1;  // into the stage that held tile t - 1
        if (tid == 0 && u < n_tiles) {
          if (u >= n_raw) {
            mbar_wait(smem_u32(&empty[u % n_raw]), (u / n_raw + 1) & 1);
          }
          issue(u);
        }
        const int s = t % n_raw, s2 = t % kCvtStages;
        mbar_wait(smem_u32(&full[s]), (t / n_raw) & 1);
        if (t >= kCvtStages) mbar_wait(smem_u32(&cempty[s2]), (t / kCvtStages + 1) & 1);
        const unsigned char* raw = sbase + (ring - base) + s * a.raw_stage;
        unsigned char* dst = sbase + (cvt - base) + s2 * Ge::kCvt;
#pragma unroll
        for (int k = 0; k < 2 * kBK * kPieces / kConvThreads; ++k) {
          const int i = tid + k * kConvThreads;
          const int which = i / (kBK * kPieces), rem = i % (kBK * kPieces);
          const int r = rem / kPieces, pc = rem % kPieces;
          const uint4 x =
              *reinterpret_cast<const uint4*>(raw + which * Ge::kTileRaw + r * HD + pc * 16);
          const uint32_t w[4] = {x.x, x.y, x.z, x.w};
          uint32_t o[8];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t pr = __byte_perm(w[e], 0, 0x3120);  // bytes 0, 2, 1, 3
            o[2 * e] = cvt2(pr);
            o[2 * e + 1] = cvt2(pr >> 8);
          }
          // dims 16 pc .. 16 pc + 15: 16-byte chunks 2 pc, 2 pc + 1 of the row
          unsigned char* row = dst + which * Ge::kTileBf + (pc >> 2) * Ge::kColBlock + r * 128;
          const int c0 = (2 * pc) & 7;
          *reinterpret_cast<uint4*>(row + ((c0 ^ (r & 7)) << 4)) =
              make_uint4(o[0], o[1], o[2], o[3]);
          *reinterpret_cast<uint4*>(row + (((c0 + 1) ^ (r & 7)) << 4)) =
              make_uint4(o[4], o[5], o[6], o[7]);
        }
        // scales in the order the consumers read them (scale_slot), the k
        // scales times log2 e (the softmax works in base 2)
        const float* sc = reinterpret_cast<const float*>(raw + 2 * Ge::kTileRaw);
        float* dsc = reinterpret_cast<float*>(dst + 2 * Ge::kTileBf);
        for (int i = tid; i < 2 * kBK; i += kConvThreads) {
          const int which = i / kBK, r = i % kBK;  // k scales, then v scales
          const float f = sc[r * 2 * a.KV + which * a.KV + h];
          dsc[which * kBK + scale_slot<kBK>(r)] = which ? f : f * kLog2e;
        }
        fence_async_smem();
        mbar_arrive(smem_u32(&empty[s]));
        mbar_arrive(smem_u32(&cfull[s2]));
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroups
  regs_inc<kConsumerRegs[kQuant]>();
  const int w = warp / 4 - 1;  // this consumer warpgroup
  const int wq = warp & 3;     // warp in it: 16 of its 64 rows
  const int gid = lane >> 2, tg = lane & 3;
  const int wf0 = f0 + 64 * w;
  // this thread's two rows: gid and gid + 8 of the warp's 16
  const int f_lo = wf0 + 16 * wq + gid, f_hi = f_lo + 8;
  const bool ok_lo = f_lo < CG, ok_hi = f_hi < CG;
  const int c_lo = min(f_lo / G, C - 1), c_hi = min(f_hi / G, C - 1);
  const int lim_lo = min(off + c_lo, a.hist - 1), lim_hi = min(off + c_hi, a.hist - 1);
  // the warpgroup's tiles, and the first that crosses one of its frontiers
  int nt_w = 0, t_mask = 0;
  if (wf0 < CG) {
    const int first = min(off + wf0 / G, a.hist - 1);
    const int last = min(off + min((wf0 + 63) / G, C - 1), a.hist - 1);
    nt_w = last / kBK + 1;
    t_mask = (first + 1) / kBK;
  }
  const long long row_lo = ((long long)j * C + c_lo) * a.H + h * G + f_lo % G;
  const long long row_hi = ((long long)j * C + c_hi) * a.H + h * G + f_hi % G;

  // the warpgroup's 64 Q rows, scaled and rounded, into its 128-byte
  // swizzled tile (64-dim column blocks of 64 rows x 128 bytes); zeros past
  // the chunk
  const uint32_t qs = base + w * Ge::kQ;
  {
    constexpr int kPer = 64 * (HD / 8) / 128;  // 16-byte pieces a thread
    uint4 y[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {  // all loads in flight at once
      const int i = (tid & 127) + 128 * k, r = i / (HD / 8), ch = i % (HD / 8), f = wf0 + r;
      y[k] = f < CG ? *reinterpret_cast<const uint4*>(
                          a.q + (((long long)j * C + f / G) * a.H + h * G + f % G) * HD + ch * 8)
                    : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = (tid & 127) + 128 * k, r = i / (HD / 8), ch = i % (HD / 8);
      const uint4 x = make_uint4(q_scaled(y[k].x, a.sm_scale), q_scaled(y[k].y, a.sm_scale),
                                 q_scaled(y[k].z, a.sm_scale), q_scaled(y[k].w, a.sm_scale));
      *reinterpret_cast<uint4*>(sbase + (qs - base) + (ch >> 3) * 8192 + r * 128 +
                                (((ch & 7) ^ (r & 7)) << 4)) = x;
    }
    fence_async_smem();
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");  // the warpgroup's Q is in
  }

  auto stage = [&](int t) -> uint32_t {  // tile t's K (V follows at kTileBf)
    return kQuant ? cvt + (t % kCvtStages) * Ge::kCvt : ring + (t % kStages) * Ge::kStageBf;
  };
  auto wait_tile = [&](int t) {
    if constexpr (kQuant) {
      mbar_wait(smem_u32(&cfull[t % kCvtStages]), (t / kCvtStages) & 1);
    } else {
      mbar_wait(smem_u32(&full[t % kStages]), (t / kStages) & 1);
    }
  };
  auto release = [&](int t) {
    if (lane == 0) {
      mbar_arrive(kQuant ? smem_u32(&cempty[t % kCvtStages]) : smem_u32(&empty[t % kStages]));
    }
  };

  float sacc[kBK / 2];  // scores, then probabilities, of one tile
  float o[HD / 2];      // the output accumulator
  uint32_t pf[kBK / 16][4];  // P as A fragments, one per 16 keys
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m_lo = -1e30f, m_hi = -1e30f, l_lo = 0.f, l_hi = 0.f;

  auto issue_s = [&](int t) {  // S = Q.K^T over HD, 16 dims a step
    const uint32_t kb = stage(t);
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      const uint64_t dk = sw128_desc(kb + (ks >> 2) * Ge::kColBlock + (ks & 3) * 32, 16, 1024);
      const uint64_t dq = sw128_desc(qs + (ks >> 2) * 8192 + (ks & 3) * 32, 16, 1024);
      wgmma_ss<kBK>(sacc, dq, dk, ks > 0);
    }
  };
  auto issue_pv = [&](int t) {  // O += P.V over the tile's keys, 16 a step
    const uint32_t vb = stage(t) + Ge::kTileBf;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t d = sw128_desc(vb + kk * 16 * 128, Ge::kColBlock, 1024);
      wgmma_pv<HD>(o, pf[kk], d, 1);
    }
  };
  // this thread's scales of tile t (int8): k scales times log2 e, then v
  // scales, in the order scale_slot put them
  auto scales = [&](int t) {
    return reinterpret_cast<const float*>(sbase + (stage(t) - base) + 2 * Ge::kTileBf) +
           tg * (kBK / 4);
  };
  // tile t's scores in base 2 (times log2 e, folded into the int8 k
  // scales), k scale applied and masked, in place; the rows' maxima
  auto score_max = [&](int t, float& mx_lo, float& mx_hi) {
    float kf[kBK / 4];
    if constexpr (kQuant) {
#pragma unroll
      for (int i = 0; i < kBK / 16; ++i) {
        *reinterpret_cast<float4*>(&kf[4 * i]) = reinterpret_cast<const float4*>(scales(t))[i];
      }
    }
    const bool mask = t >= t_mask;
    const int key0 = t * kBK;
    mx_lo = mx_hi = -1e30f;
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kk = n * 8 + 2 * tg + e;
        const float f = kQuant ? kf[2 * n + e] : kLog2e;  // k scale on the score
        float s_lo = sacc[4 * n + e] * f, s_hi = sacc[4 * n + 2 + e] * f;
        if (mask) {
          s_lo = key0 + kk <= lim_lo ? s_lo : -1e30f;
          s_hi = key0 + kk <= lim_hi ? s_hi : -1e30f;
        }
        sacc[4 * n + e] = s_lo;
        sacc[4 * n + 2 + e] = s_hi;
        mx_lo = fmaxf(mx_lo, s_lo);
        mx_hi = fmaxf(mx_hi, s_hi);
      }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, x));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, x));
    }
  };
  // tile t's scores -> probabilities (v scales applied) in sacc; returns
  // the factors that rescale the rows' earlier sums
  auto softmax = [&](int t, float& al_lo, float& al_hi) {
    float mx_lo, mx_hi, vf[kBK / 4];
    score_max(t, mx_lo, mx_hi);
    if constexpr (kQuant) {
#pragma unroll
      for (int i = 0; i < kBK / 16; ++i) {
        *reinterpret_cast<float4*>(&vf[4 * i]) =
            reinterpret_cast<const float4*>(scales(t) + kBK)[i];
      }
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    al_lo = ex2(m_lo - mn_lo);
    al_hi = ex2(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float ls_lo = 0.f, ls_hi = 0.f;
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p_lo = ex2(sacc[4 * n + e] - mn_lo);
        const float p_hi = ex2(sacc[4 * n + 2 + e] - mn_hi);
        ls_lo += p_lo;
        ls_hi += p_hi;
        const float f = kQuant ? vf[2 * n + e] : 1.f;  // v scale on the prob
        sacc[4 * n + e] = p_lo * f;
        sacc[4 * n + 2 + e] = p_hi * f;
      }
    l_lo = l_lo * al_lo + ls_lo;  // this thread's columns; the quad sums at the end
    l_hi = l_hi * al_hi + ls_hi;
  };
  // probabilities of n-tiles 2kk, 2kk+1 -> the A fragment of keys 16kk..
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      pf[kk][0] = pack_bf16(sacc[8 * kk + 0], sacc[8 * kk + 1]);
      pf[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
      pf[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
      pf[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
    }
  };

  // The rows' maxima over keys 0..255 first, as the reference's first block
  // takes them (see the header): those keys' p then round at its scale.
  // Later blocks keep a running maximum a tile at a time.
  for (int t = 0; t < min(nt_w, kFirstBlock / kBK); ++t) {
    float mx_lo, mx_hi;
    wait_tile(t);
    wgmma_fence();
    issue_s(t);
    wgmma_commit();
    wgmma_wait<0>();
    keep(sacc);
    score_max(t, mx_lo, mx_hi);
    m_lo = fmaxf(m_lo, mx_lo);
    m_hi = fmaxf(m_hi, mx_hi);
  }
  if (nt_w > 0) {
    float al_lo, al_hi;
    wait_tile(0);
    wgmma_fence();
    issue_s(0);
    wgmma_commit();
    wgmma_wait<0>();
    keep(sacc);
    softmax(0, al_lo, al_hi);  // the output is still 0: nothing to rescale
    pack_p();
    for (int t = 1; t < nt_w; ++t) {
      wait_tile(t);
        wgmma_fence();
      issue_s(t);
      wgmma_commit();
      issue_pv(t - 1);
      wgmma_commit();
        wgmma_wait<1>();  // S(t) is in; P(t-1).V(t-1) runs under the softmax
      keep(sacc);
      softmax(t, al_lo, al_hi);
      wgmma_wait<0>();
      keep(o);
      keep(pf);
      release(t - 1);
      // rescale only where a row's maximum rose (a factor of exactly 1
      // changes nothing): past the first tiles it rarely does
      if (__any_sync(0xffffffffu, al_lo != 1.f || al_hi != 1.f)) {
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) o[i] *= (i & 2) ? al_hi : al_lo;
      }
      pack_p();
    }
    wgmma_fence();
    issue_pv(nt_w - 1);
    wgmma_commit();
    wgmma_wait<0>();
    keep(o);
    release(nt_w - 1);
  }
  for (int t = nt_w; t < n_tiles; ++t) {  // tiles past this warpgroup's rows
    wait_tile(t);
    release(t);
  }
  if (nt_w == 0) return;

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, x);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, x);
  }
  const float d_lo = fmaxf(l_lo, 1e-30f), d_hi = fmaxf(l_hi, 1e-30f);
  __nv_bfloat16* o_lo = a.out + row_lo * HD + 2 * tg;
  __nv_bfloat16* o_hi = a.out + row_hi * HD + 2 * tg;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    if (ok_lo)
      *reinterpret_cast<__nv_bfloat162*>(o_lo + n * 8) =
          __floats2bfloat162_rn(o[4 * n] / d_lo, o[4 * n + 1] / d_lo);
    if (ok_hi)
      *reinterpret_cast<__nv_bfloat162*>(o_hi + n * 8) =
          __floats2bfloat162_rn(o[4 * n + 2] / d_hi, o[4 * n + 3] / d_hi);
  }
}

// ------------------------------------------------------------ host side

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links without -lcuda.
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

constexpr int kBadHeadDim = -1, kBadShape = -2, kEncodeFailed = -3, kOddKv = -4;

EncodeFn encoder() {
  static EncodeFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeFn>(p);
    }
  }
  return fn;
}

// a 3-D map (innermost first) of `elem`-byte values: dims, byte strides of
// dims 1 and 2, a box; zeros past the edges
bool encode3(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, long long d0,
             long long d1, long long d2, long long s1, long long s2, int b0, int b1,
             CUtensorMapSwizzle swizzle) {
  const EncodeFn fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0), static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(s1), static_cast<cuuint64_t>(s2)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(b0), static_cast<cuuint32_t>(b1), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int HD>
int launch(const void* k, const void* v, const void* scale, Args a, int J, int B, int S,
           cudaStream_t stream) {
  using Ge = Geom<T, HD>;
  const int KV = a.KV;
  CUtensorMap km, vm, sm;
  bool ok;
  if constexpr (Ge::kQuant) {
    // (KV*HD, S, B) int8, boxes of one kv head's HD bytes x the tile's positions;
    // scales (2KV, S, B) fp32, boxes of whole rows x the tile's positions
    if (KV % 2 != 0) return kOddKv;  // a scale row must be a multiple of 16 bytes
    const long long row = (long long)KV * HD;
    ok = encode3(&km, k, CU_TENSOR_MAP_DATA_TYPE_UINT8, row, a.hist, B, row, row * S, HD,
                 Ge::kBK, CU_TENSOR_MAP_SWIZZLE_NONE) &&
         encode3(&vm, v, CU_TENSOR_MAP_DATA_TYPE_UINT8, row, a.hist, B, row, row * S, HD,
                 Ge::kBK, CU_TENSOR_MAP_SWIZZLE_NONE) &&
         encode3(&sm, scale, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2 * KV, a.hist, B, 2 * KV * 4,
                 2LL * KV * 4 * S, 2 * KV, Ge::kBK, CU_TENSOR_MAP_SWIZZLE_NONE);
    a.raw_stage = Ge::raw_stage(KV);
    a.raw_stages = Ge::smem(KV, kRawStages) <= kSmemLimit ? kRawStages : 2;
  } else {
    // (HD, S, B*KV) bf16, boxes of 64 dims x the tile's positions, 128-byte swizzled
    ok = encode3(&km, k, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, HD, a.hist, (long long)B * KV, HD * 2,
                 2LL * HD * S, 64, Ge::kBK, CU_TENSOR_MAP_SWIZZLE_128B) &&
         encode3(&vm, v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, HD, a.hist, (long long)B * KV, HD * 2,
                 2LL * HD * S, 64, Ge::kBK, CU_TENSOR_MAP_SWIZZLE_128B);
    sm = km;  // unused
    a.raw_stage = a.raw_stages = 0;
  }
  if (!ok) return kEncodeFailed;
  const int smem = Ge::smem(KV, a.raw_stages);
  if (smem > kSmemLimit) return kBadShape;
  static int sized = 0;  // raised at the first (eager) call of a size, before any capture
  if (smem > sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        prefill_chunk_attn<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = smem;
  }
  const dim3 grid(KV, J, (a.C * a.G + kRows - 1) / kRows);
  prefill_chunk_attn<T, HD><<<grid, kThreads, smem, stream>>>(km, vm, sm, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mp

// Status 0, -1 for a head_dim with no instantiation (64 and 128 exist), -2
// for a shape out of range, -3 when a tensor map cannot be encoded, -4 for
// an int8 cache with an odd number of kv heads, else the launch's
// cudaGetLastError().
extern "C" int mp_prefill_chunk_attention(
    const void* q,        // (J, C, H, HD) bf16
    const void* k,        // one layer: int8 (B, S, KV*HD) or bf16 (B, KV, S, HD)
    const void* v,
    const void* scale,    // int8: (B, S, 2*KV) fp32; bf16: null
    const void* slots,    // (J,) int32
    const void* offsets,  // (J,) int32
    void* out,            // (J, C, H, HD) bf16
    int B, int J, int C, int H, int KV, int HD, int S, int hist, int quant, float sm_scale,
    void* stream) {
  if (B <= 0 || J <= 0 || C <= 0 || KV <= 0 || H % KV != 0 || hist <= 0 || hist > S ||
      J > 65535 || (C * (H / KV) + mp::kRows - 1) / mp::kRows > 65535)
    return mp::kBadShape;
  mp::Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.slots = static_cast<const int*>(slots);
  a.offsets = static_cast<const int*>(offsets);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.C = C;
  a.H = H;
  a.KV = KV;
  a.G = H / KV;
  a.hist = hist;
  a.raw_stage = a.raw_stages = 0;
  a.sm_scale = sm_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (HD == 128) {
    return quant ? mp::launch<int8_t, 128>(k, v, scale, a, J, B, S, st)
                 : mp::launch<__nv_bfloat16, 128>(k, v, scale, a, J, B, S, st);
  }
  if (HD == 64) {
    return quant ? mp::launch<int8_t, 64>(k, v, scale, a, J, B, S, st)
                 : mp::launch<__nv_bfloat16, 64>(k, v, scale, a, J, B, S, st);
  }
  return mp::kBadHeadDim;
}

extern "C" const char* mp_error_string(int status) {
  switch (status) {
    case mp::kBadHeadDim:
      return "no kernel instantiated for this head_dim (64 and 128 exist)";
    case mp::kBadShape:
      return "shape out of range (J, C, heads, hist <= S, shared memory)";
    case mp::kEncodeFailed:
      return "cuTensorMapEncodeTiled failed for the cache's tensor maps";
    case mp::kOddKv:
      return "an int8 cache needs an even number of kv heads (TMA scale rows)";
    default:
      break;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
