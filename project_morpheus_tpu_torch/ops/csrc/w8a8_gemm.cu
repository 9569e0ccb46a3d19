// The w8a8 projections of the chunk prefill, for Hopper (sm_90a): a per-token
// int8 quantize and an int8 x int8 GEMM with both scales in its epilogue.
//
// Replaces what XLA compiles for the JAX package's matmul_w8a8
// (project_morpheus_tpu/model/quant.py:84-95: the per-token quantization and
// an int8 dot_general with int32 accumulation; not a Pallas kernel).  For an
// activation h (M, K) and a weight leaf q (K, N) int8 with fp32 column
// scales, stored here as its K-major copy qt (N, K):
//   peak = max_k |h[m, k]| (fp32)     hsc = max(peak, 1e-8) / 127 (IEEE)
//   h8   = int8(clamp(rint(h / hsc), -127, 127))   (IEEE division, half to even)
//   y    = out_t((float(sum_k h8 * q) * hsc[m]) * scale[n])
// Every step is exact or correctly rounded, so both kernels equal their
// plain versions (ops/w8a8_gemm.py) bit for bit.
//
// Bound: at the prefill's rows (M >= 512) the GEMM is bound by operations,
// 2MNK at 1,979 dense int8 TOP/s; at M <= 128 by the weight's bytes (K N at
// 3.35 TB/s).  The quantize is bound by bytes (h read, h8 written).  Design:
//
// - wgmma.m64nNk32.s32.s8.s8 with both operands K-major in shared memory,
//   128-byte swizzled: a 128-byte K tile is 128 int8 values, one swizzle atom
//   wide, four k32 steps.  8-bit wgmma has no transpose, so the weight is
//   read from its K-major copy (model/quant.py: add_k_major_copies).
// - A block is one copying warpgroup and one or two consumer warpgroups of
//   64 rows: a BM x BN output tile, BM 64 or 128, BN 96, 128 or 256, chosen
//   by the wrapper (ops/w8a8_gemm.py: gemm_plan) from the grid it gives on
//   this card's SMs.  Thread 0 streams A and B tiles by TMA (UINT8 tensor
//   maps: int8 has no type of its own, the bits are the same) into a ring of
//   stages guarded by mbarriers.  Each consumer keeps one wgmma group in
//   flight and hands a stage back when the group before it has finished.
//   With two consumers setmaxnreg gives the copying warpgroup 40 registers a
//   thread and the consumers 232.
// - Any N >= 1 and any K a multiple of 16 (TMA's 16-byte row stride): rows
//   past M, weight rows past N and K past the last full 128-byte tile come
//   from TMA's zero fill, whose int8 zeros leave the int32 sums exact; the
//   epilogue reads scales and stores only columns < N.
// - Short rounds (M <= 128): the weight's bytes bound the call, so the grid
//   has to cover the SMs, and 128 x 128 tiles gave 24-40 blocks on 132 at
//   the 3B weights.  M <= 64 takes a 64-row tile (one consumer: half the A
//   bytes and the idle MMA rows), and K is split across a thread-block
//   cluster of 2, 4 or 8 blocks (blockIdx.x = row tile x splits + rank):
//   each block multiplies its share of the K tiles; once all have left their
//   rings, each stores its int32 fragments of every column group into the
//   ring of the block that finishes that group (distributed shared memory:
//   stores, which leave at once, not loads, which wait one by one), and
//   after a second cluster barrier each block sums its slice of the tile's
//   groups and runs the epilogue for it.  Integer addition is exact in any
//   order, so the output stays equal to the plain version.
// - A programmatic dependent launch (short calls; the wrapper decides): the
//   quantize before the GEMM lets it launch at once, and the copying thread
//   issues the first `prefetch` weight tiles (which no kernel before
//   writes) before griddepcontrol.wait and the activation tiles after it;
//   the consumers wait as well before they read the row scales and write
//   the output.  A stage's full barrier takes two arrivals, one with the
//   weight tile's bytes and one with the activation tile's.
// - The epilogue works from the accumulator fragments (or, split, from the
//   summed ones): __int2float_rn, the row scale, then the column scale
//   (__fmul_rn each), rounded once to the output type.  The consumers load
//   the tile's column scales before their first product (weights: no
//   kernel before writes them) and share them through shared memory after
//   the last, so neither a product nor a store waits on a scale load.  Blocks along M are
//   the fastest grid dimension, so the blocks that run together share their
//   weight tile in L2.
// - The quantize is one block a row whose threads keep the row's 16-value
//   pieces in registers: h is read from device memory once, the |max| taken
//   by a block reduction, then the codes (a multiplication by 1 / hsc, the
//   IEEE division where that could round otherwise).  The block has as many
//   threads (32-256, a warp multiple) as the row has pieces, or a half, a
//   quarter or an eighth of that, so no thread idles for a second step (a
//   warp a row, four rows a block, measured 2-2.5x slower).  It
//   first runs griddepcontrol.launch_dependents, so the GEMM after it
//   launches and streams weights while the rows are quantized.  Rows of more
//   than 32,768 values take a kernel that reads each row twice.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"  // mbarriers, TMA, setmaxnreg, wgmma descriptors, encoder

namespace mp {
namespace {

__device__ __forceinline__ void grid_dep_wait() {  // the grid before this one is done
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void launch_dependents() {  // the grid after may launch
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
}

// ------------------------------------------------------------ quantize

constexpr int kQThreads = 128;     // the two-pass kernel for long rows
constexpr int kQMaxThreads = 256;  // the register kernel
constexpr int kQMaxPieces = 8;     // 16-value pieces a thread keeps in registers

__device__ __forceinline__ void unpack(const uint4 (&v)[2], float (&f)[16]) {  // 16 bf16
  const uint32_t w[8] = {v[0].x, v[0].y, v[0].z, v[0].w, v[1].x, v[1].y, v[1].z, v[1].w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ void unpack(const uint4 (&v)[4], float (&f)[16]) {  // 16 fp32
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[4 * i] = __uint_as_float(v[i].x);
    f[4 * i + 1] = __uint_as_float(v[i].y);
    f[4 * i + 2] = __uint_as_float(v[i].z);
    f[4 * i + 3] = __uint_as_float(v[i].w);
  }
}

// 16 values of h at p into floats
template <typename T>
__device__ __forceinline__ void load16(const T* p, float (&f)[16]) {
  uint4 v[sizeof(T)];
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(T)); ++i) v[i] = reinterpret_cast<const uint4*>(p)[i];
  unpack(v, f);
}

// clamp(rint(x / s), -127, 127) with x / s the IEEE quotient, from r =
// 1 / s (rounded): |x / s| <= 127, so x * r lies within 2^-16 of the rounded
// quotient and rounds to the same integer unless it is within 2^-14 of a
// half-integer (2^-14 of 0.5 from the integer it rounds to), where the
// quotient itself is taken (about 2 values in 10^4).
__device__ __forceinline__ float code_of(float x, float s, float r) {
  const float q = __fmul_rn(x, r);
  float c = rintf(q);
  if (fabsf(q - c) >= 0.5f - 0x1p-14f) c = rintf(__fdiv_rn(x, s));
  return fminf(fmaxf(c, -127.f), 127.f);
}

// 16 int8 codes of f / s (r = 1 / s), four to a word
__device__ __forceinline__ uint4 codes16(const float (&f)[16], float s, float r) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float q = code_of(f[4 * i + e], s, r);
      word |= (static_cast<uint32_t>(static_cast<int>(q)) & 0xFFu) << (8 * e);
    }
    w[i] = word;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// the block's largest mx (blockDim.x a multiple of 32, at most kQMaxThreads)
__device__ __forceinline__ float block_max(float mx) {
  __shared__ float part[kQMaxThreads / 32];
#pragma unroll
  for (int x = 16; x >= 1; x >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = mx;
  __syncthreads();
  float peak = part[0];
  for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) peak = fmaxf(peak, part[w]);
  return peak;
}

// Row blockIdx.x of h (M, K): with peak_out, only its |max| into
// peak_out[m]; else from peak_in[m] (or its own |max| when peak_in is null)
// the scale into hsc[m] and the int8 row into h8.  Piece p (16 values) of
// the row is thread p % blockDim.x's (p / blockDim.x)-th, kP at most, kept
// in registers from the one read.
template <typename T, int kP>
__global__ void __launch_bounds__(kQMaxThreads)
    w8a8_quantize(const T* __restrict__ h, int K, const float* __restrict__ peak_in,
                  float* __restrict__ peak_out, int8_t* __restrict__ h8,
                  float* __restrict__ hsc) {
  launch_dependents();  // the GEMM waits for this grid before it reads h8 or hsc
  constexpr int kV = sizeof(T);  // 16-byte words a piece: 2 of bf16, 4 of fp32
  const int m = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int pieces = K / 16;
  const T* row = h + static_cast<long long>(m) * K;
  uint4 x[kP][kV];
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    const int p = i * nt + tid;
    if (p < pieces) {
#pragma unroll
      for (int v = 0; v < kV; ++v) x[i][v] = reinterpret_cast<const uint4*>(row + 16 * p)[v];
    }
  }
  float peak;
  if (peak_in != nullptr) {
    peak = peak_in[m];
  } else {
    float mx = 0.f;
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      if (i * nt + tid < pieces) {
        float f[16];
        unpack(x[i], f);
#pragma unroll
        for (int e = 0; e < 16; ++e) mx = fmaxf(mx, fabsf(f[e]));
      }
    }
    peak = block_max(mx);
    if (peak_out != nullptr) {
      if (tid == 0) peak_out[m] = peak;
      return;
    }
  }
  const float s = __fdiv_rn(fmaxf(peak, 1e-8f), 127.f), r = __frcp_rn(s);
  if (tid == 0) hsc[m] = s;
  int8_t* out = h8 + static_cast<long long>(m) * K;
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    const int p = i * nt + tid;
    if (p < pieces) {
      float f[16];
      unpack(x[i], f);
      *reinterpret_cast<uint4*>(out + 16 * p) = codes16(f, s, r);
    }
  }
}

// The same for rows of more than kQMaxThreads x kQMaxPieces pieces: the
// |max| in one pass, the codes in a second that reads the row again.
template <typename T>
__global__ void __launch_bounds__(kQThreads)
    w8a8_quantize_long(const T* __restrict__ h, int K, const float* __restrict__ peak_in,
                       float* __restrict__ peak_out, int8_t* __restrict__ h8,
                       float* __restrict__ hsc) {
  launch_dependents();
  const int m = blockIdx.x, tid = threadIdx.x;
  const T* row = h + static_cast<long long>(m) * K;
  const int pieces = K / 16;
  float peak;
  if (peak_in != nullptr) {
    peak = peak_in[m];
  } else {
    float mx = 0.f;
    for (int p = tid; p < pieces; p += kQThreads) {
      float f[16];
      load16(row + 16 * p, f);
#pragma unroll
      for (int e = 0; e < 16; ++e) mx = fmaxf(mx, fabsf(f[e]));
    }
    peak = block_max(mx);
    if (peak_out != nullptr) {
      if (tid == 0) peak_out[m] = peak;
      return;
    }
  }
  const float s = __fdiv_rn(fmaxf(peak, 1e-8f), 127.f), r = __frcp_rn(s);
  if (tid == 0) hsc[m] = s;
  int8_t* out = h8 + static_cast<long long>(m) * K;
  for (int p = tid; p < pieces; p += kQThreads) {
    float f[16];
    load16(row + 16 * p, f);
    *reinterpret_cast<uint4*>(out + 16 * p) = codes16(f, s, r);
  }
}

// ------------------------------------------------------------ GEMM

constexpr int kBK = 128;  // K a stage: one 128-byte swizzle atom of int8
constexpr int kMaxSplits = 8;
constexpr int kSmemLimit = 227 * 1024 - 1024;  // less 1 KB for the static barriers
// Registers a thread after setmaxnreg with two consumers, from the 168 a
// thread that __launch_bounds__(384, 1) allows: a pool of 64,512.  Asking
// for more than the pool holds would block the consumers' setmaxnreg.inc for
// ever.
constexpr int kPool = 384 * (65536 / 384 / 8 * 8);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = (kPool - 128 * kProducerRegs) / 256 / 8 * 8;
static_assert(kConsumerRegs == 232 && 128 * kProducerRegs + 256 * kConsumerRegs <= kPool,
              "register split");

template <int BM, int BN>
struct GemmGeom {
  static constexpr int kCons = BM / 64;               // consumer warpgroups
  static constexpr int kThreads = 128 * (kCons + 1);  // and the copying one
  static constexpr int kA = BM * kBK;                 // an A tile: BM rows of 128 bytes
  static constexpr int kB = BN * kBK;                 // a B tile: BN rows of 128 bytes
  static constexpr int kStage = kA + kB;
  // stages: about 192 KB of ring at every tile (160 KB at 64 x 96)
  static constexpr int kStages = BM == 128 ? (BN == 256 ? 4 : BN == 128 ? 6 : 7) : 8;
  static constexpr int kSmem = 1024 + kStages * kStage;  // 1 KB to align the base
  static_assert(BM == 64 || BM == 128, "one or two consumer warpgroups");
  static_assert(kSmem <= kSmemLimit, "the ring fits in shared memory");
  static_assert(kStage % 1024 == 0, "stages keep the swizzle's 1 KB alignment");
  static_assert(BM * BN * 4 <= kStages * kStage, "a tile's partial sums fit in the ring");
};

__device__ __forceinline__ void wgmma_s8_n96(int32_t (&d)[48], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_n128(int32_t (&d)[64], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_n256(int32_t (&d)[128], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x BN, s32) (+)= A (64 x 32 s8) x B (32 x BN s8), both K-major in
// shared memory, by descriptor; scale_d 0 overwrites D
template <int BN>
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[BN / 2], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  if constexpr (BN == 96) {
    wgmma_s8_n96(d, desc_a, desc_b, scale_d);
  } else if constexpr (BN == 128) {
    wgmma_s8_n128(d, desc_a, desc_b, scale_d);
  } else {
    static_assert(BN == 256, "wgmma widths 96, 128 and 256");
    wgmma_s8_n256(d, desc_a, desc_b, scale_d);
  }
}

template <int N>
__device__ __forceinline__ void keep(int32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) { *p = __float2bfloat16_rn(a); }

__device__ __forceinline__ void store1(float* p, float a) { *p = a; }

__device__ __forceinline__ float scaled(int32_t acc, float row, float col) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), row), col);
}

// One accumulator group of a thread: rows r_lo and r_hi (scales s_lo,
// s_hi), columns n0 + cl and n0 + cl + 1 (a0, a1 of r_lo; a2, a3 of r_hi),
// their scales at col_scale[cl] (the tile's, in shared memory); nothing
// past M or N.  `pairs` (N even) stores two columns at once.
template <typename OutT>
__device__ __forceinline__ void emit(OutT* __restrict__ out, const float* col_scale, int M,
                                     int N, bool pairs, int r_lo, float s_lo, int r_hi,
                                     float s_hi, int n0, int cl, int32_t a0, int32_t a1,
                                     int32_t a2, int32_t a3) {
  const int c = n0 + cl;
  if (c >= N) return;
  OutT* o_lo = out + static_cast<long long>(r_lo) * N + c;
  OutT* o_hi = out + static_cast<long long>(r_hi) * N + c;
  if (pairs) {  // c even and N even: c + 1 < N, both addresses aligned
    const float2 sc = *reinterpret_cast<const float2*>(col_scale + cl);
    if (r_lo < M) store2(o_lo, scaled(a0, s_lo, sc.x), scaled(a1, s_lo, sc.y));
    if (r_hi < M) store2(o_hi, scaled(a2, s_hi, sc.x), scaled(a3, s_hi, sc.y));
  } else {
    const bool two = c + 1 < N;
    const float c0 = col_scale[cl], c1 = col_scale[cl + 1];
    if (r_lo < M) {
      store1(o_lo, scaled(a0, s_lo, c0));
      if (two) store1(o_lo + 1, scaled(a1, s_lo, c1));
    }
    if (r_hi < M) {
      store1(o_hi, scaled(a2, s_hi, c0));
      if (two) store1(o_hi + 1, scaled(a3, s_hi, c1));
    }
  }
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int kCount>
__device__ __forceinline__ void consumer_sync() {  // the consumer warpgroups only
  asm volatile("bar.sync 1, %0;\n" ::"n"(kCount) : "memory");
}

// 16 bytes to this shared address in the block of cluster rank `rank`
__device__ __forceinline__ void st_cluster16(uint32_t addr, int rank, int32_t a, int32_t b,
                                             int32_t c, int32_t d) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("st.shared::cluster.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(remote), "r"(a),
               "r"(b), "r"(c), "r"(d)
               : "memory");
}

__device__ __forceinline__ uint4 ld_shared16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// out (M, N) = (A (M, K) . B (N, K)^T) * hsc[m] * scale[n].  Block
// (blockIdx.x, blockIdx.y) writes rows BM (x / splits), columns BN y, from
// the K tiles of its rank x % splits in a cluster of `splits` blocks along x.
template <int BM, int BN, typename OutT>
__global__ void __launch_bounds__(GemmGeom<BM, BN>::kThreads, 1)
    w8a8_gemm(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
              const float* __restrict__ hsc, const float* __restrict__ scale,
              OutT* __restrict__ out, int M, int N, int K, int splits, int prefetch,
              int dependent) {
  using Ge = GemmGeom<BM, BN>;
  constexpr int kStages = Ge::kStages;
  constexpr int kCT = 128 * Ge::kCons;  // consumer threads
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ __align__(16) float col_scale[BN];  // the tile's column scales
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int tid = threadIdx.x, lane = tid & 31;
  // the warp index through a shuffle: ptxas then knows the role branch below
  // is warp-uniform, and gives each role the registers setmaxnreg sets
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int rank = blockIdx.x % splits;
  const int m0 = blockIdx.x / splits * BM, n0 = blockIdx.y * BN;
  const int k_tiles = (K + kBK - 1) / kBK;
  const int kt0 = rank * k_tiles / splits;
  const int mine = (rank + 1) * k_tiles / splits - kt0;  // this block's K tiles

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 2);  // the weight tile's arrival, the activation tile's
      mbar_init(smem_u32(&empty[s]), 4 * Ge::kCons);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // ------------------------------------------------ the copying warpgroup
    if constexpr (Ge::kCons == 2) regs_dec<kProducerRegs>();
    if (tid == 0) {
      auto load_b = [&](int j) {
        const int s = j % kStages;
        const uint32_t bar = smem_u32(&full[s]);
        mbar_expect_tx(bar, Ge::kB);
        tma_load2(base + s * Ge::kStage + Ge::kA, &bmap, (kt0 + j) * kBK, n0, bar);
      };
      // the weight's first `prefetch` tiles before the kernel ahead ends
      // (none writes them), the activations after it; then each stage's A
      // and B in turn (an A queued behind a whole ring of weight tiles
      // would hold the first product back by the ring's copy time)
      const int first = min(mine, min(prefetch, kStages));
      for (int j = 0; j < first; ++j) load_b(j);
      if (dependent) grid_dep_wait();
      for (int j = 0; j < mine; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(smem_u32(&empty[s]), (j / kStages + 1) & 1);
        const uint32_t bar = smem_u32(&full[s]);
        mbar_expect_tx(bar, Ge::kA);
        tma_load2(base + s * Ge::kStage, &amap, (kt0 + j) * kBK, m0, bar);
        if (j >= first) load_b(j);
      }
    }
    if (splits > 1) {  // the consumers' two cluster barriers
      __syncwarp();
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // -------------------------------------------------- consumer warpgroups
  if constexpr (Ge::kCons == 2) regs_inc<kConsumerRegs>();
  const int w = warp / 4 - 1;  // this consumer's 64 rows of the tile
  const int ct = tid - 128;    // this consumer thread
  // the column scales are weights too: each consumer thread loads one now
  // (not one group at a time behind the epilogue's stores) and leaves it in
  // shared memory after the main loop, so no product waits for the load
  static_assert(BN <= kCT, "a column scale a consumer thread");
  const float my_scale = ct < BN && n0 + ct < N ? scale[n0 + ct] : 0.f;
  // this thread's two rows (gid and gid + 8 of its warp's 16) and, for each
  // 8 columns n, columns 8 n + 2 tg and 8 n + 2 tg + 1
  const int gid = lane >> 2, tg = lane & 3;
  const int r_lo = m0 + 64 * w + 16 * (warp & 3) + gid, r_hi = r_lo + 8;
  float s_lo = 0.f, s_hi = 0.f;
  // The row scales are the kernel ahead's output, and the output may lie in
  // memory that kernel still reads: both wait for it.  The first activation
  // tile is copied after that kernel has finished, so the scales are read
  // when it lands, under the remaining tiles.
  auto row_scales = [&]() {
    if (dependent) grid_dep_wait();
    if (r_lo < M) s_lo = hsc[r_lo];
    if (r_hi < M) s_hi = hsc[r_hi];
  };
  if (mine == 0) row_scales();
  int32_t acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;  // no register read unset; a split may get no tile
  for (int j = 0; j < mine; ++j) {
    const int s = j % kStages;
    mbar_wait(smem_u32(&full[s]), (j / kStages) & 1);
    if (j == 0) row_scales();
    const uint32_t a = base + s * Ge::kStage + w * 64 * kBK, b = base + s * Ge::kStage + Ge::kA;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      wgmma_s8<BN>(acc, sw128_desc(a + 32 * ks, 16, 1024), sw128_desc(b + 32 * ks, 16, 1024),
                   j > 0 || ks > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // tile j - 1's products are done: its stage goes back
    if (j > 0 && lane == 0) mbar_arrive(smem_u32(&empty[(j - 1) % kStages]));
  }
  wgmma_wait<0>();
  keep(acc);
  if (ct < BN) col_scale[ct] = my_scale;
  consumer_sync<kCT>();  // col_scale is whole
  const bool pairs = (N & 1) == 0;
  if (splits == 1) {
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      emit(out, col_scale, M, N, pairs, r_lo, s_lo, r_hi, s_hi, n0, 8 * n + 2 * tg, acc[4 * n],
           acc[4 * n + 1], acc[4 * n + 2], acc[4 * n + 3]);
    }
    return;
  }

  // Split K: rank r finishes column groups [r per, r per + per).  Once every
  // block of the cluster has left its ring, each consumer thread stores its
  // fragments of group n into the ring of the group's rank, at slot (this
  // rank, n - owner per): stores do not wait for an answer, so they all
  // leave at once.  After the second barrier each block sums its groups'
  // slots in its own ring, rank by rank, and writes them.
  const int per = BN / 8 / splits;
  cluster_sync();
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) {
    const int owner = n / per;
    st_cluster16(base + 16 * ((rank * per + n - owner * per) * kCT + ct), owner, acc[4 * n],
                 acc[4 * n + 1], acc[4 * n + 2], acc[4 * n + 3]);
  }
  cluster_sync();
  for (int g = 0; g < per; ++g) {
    int32_t sum[4] = {0, 0, 0, 0};
    for (int q = 0; q < splits; ++q) {
      const uint4 v = ld_shared16(base + 16 * ((q * per + g) * kCT + ct));
      sum[0] += static_cast<int32_t>(v.x);
      sum[1] += static_cast<int32_t>(v.y);
      sum[2] += static_cast<int32_t>(v.z);
      sum[3] += static_cast<int32_t>(v.w);
    }
    emit(out, col_scale, M, N, pairs, r_lo, s_lo, r_hi, s_hi, n0, 8 * (rank * per + g) + 2 * tg,
         sum[0], sum[1], sum[2], sum[3]);
  }
}

// ------------------------------------------------------------ host side

constexpr int kBadShape = -1, kEncodeFailed = -2, kBadTile = -3, kBadType = -4;

// a 2-D int8 map (K innermost, then rows) with 128 x `rows` boxes, 128-byte
// swizzled; zeros past the edges
bool encode2(CUtensorMap* map, const void* ptr, long long K, long long rows, int box_rows) {
  const EncodeFn fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Raise the kernel's dynamic shared memory limit once: at the first (eager)
// call, before any capture.
template <int BM, int BN, typename OutT>
cudaError_t size_gemm() {
  static bool sized = false;
  if (sized) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      w8a8_gemm<BM, BN, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      GemmGeom<BM, BN>::kSmem);
  sized = err == cudaSuccess;
  return err;
}

// Clusters of `splits` blocks of this tile that the card holds at once (or
// a negative status).
template <int BM, int BN, typename OutT>
int max_clusters(int splits) {
  const cudaError_t err = size_gemm<BM, BN, OutT>();
  if (err != cudaSuccess) return -static_cast<int>(err) - 100;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits * 64, 1);
  cfg.blockDim = dim3(GemmGeom<BM, BN>::kThreads);
  cfg.dynamicSmemBytes = GemmGeom<BM, BN>::kSmem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  const cudaError_t occ = cudaOccupancyMaxActiveClusters(&n, w8a8_gemm<BM, BN, OutT>, &cfg);
  return occ == cudaSuccess ? n : -static_cast<int>(occ) - 100;
}

template <int BM, int BN, typename OutT>
int launch_gemm(const void* a, const void* b, const float* hsc, const float* scale, void* out,
                int M, int N, int K, int splits, int prefetch, int dependent,
                cudaStream_t stream) {
  using Ge = GemmGeom<BM, BN>;
  if (splits < 1 || splits > kMaxSplits || (BN / 8) % splits != 0) return kBadTile;
  if ((N + BN - 1) / BN > 65535) return kBadShape;
  CUtensorMap am, bm;
  if (!encode2(&am, a, K, M, BM) || !encode2(&bm, b, K, N, BN)) return kEncodeFailed;
  const cudaError_t sized = size_gemm<BM, BN, OutT>();
  if (sized != cudaSuccess) return static_cast<int>(sized);
  cudaLaunchAttribute attr[2];
  int n_attr = 0;
  if (dependent) {
    attr[n_attr].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[n_attr].val.programmaticStreamSerializationAllowed = 1;
    ++n_attr;
  }
  if (splits > 1) {
    attr[n_attr].id = cudaLaunchAttributeClusterDimension;
    attr[n_attr].val.clusterDim.x = splits;
    attr[n_attr].val.clusterDim.y = 1;
    attr[n_attr].val.clusterDim.z = 1;
    ++n_attr;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + BM - 1) / BM * splits, (N + BN - 1) / BN);
  cfg.blockDim = dim3(Ge::kThreads);
  cfg.dynamicSmemBytes = Ge::kSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = n_attr;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, w8a8_gemm<BM, BN, OutT>, am, bm, hsc, scale,
                                             static_cast<OutT*>(out), M, N, K, splits,
                                             prefetch, dependent);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

struct Launch {  // one GEMM launch, for by_tile
  const void *a, *b;
  const float *hsc, *scale;
  void* out;
  int M, N, K, splits, prefetch, dependent, out_f32;
  cudaStream_t stream;
  template <int BM, int BN>
  int run() const {
    return out_f32 ? launch_gemm<BM, BN, float>(a, b, hsc, scale, out, M, N, K, splits,
                                                prefetch, dependent, stream)
                   : launch_gemm<BM, BN, __nv_bfloat16>(a, b, hsc, scale, out, M, N, K, splits,
                                                        prefetch, dependent, stream);
  }
};

struct Occupancy {  // the clusters of `splits` blocks the card holds, for by_tile
  int splits;
  template <int BM, int BN>
  int run() const {
    return max_clusters<BM, BN, __nv_bfloat16>(splits);
  }
};

// fn.run<BM, BN>() for the instantiated tile tile_m x tile_n
template <typename Fn>
int by_tile(int tile_m, int tile_n, const Fn& fn) {
  if (tile_m == 128 && tile_n == 256) return fn.template run<128, 256>();
  if (tile_m == 128 && tile_n == 128) return fn.template run<128, 128>();
  if (tile_m == 128 && tile_n == 96) return fn.template run<128, 96>();
  if (tile_m == 64 && tile_n == 128) return fn.template run<64, 128>();
  if (tile_m == 64 && tile_n == 96) return fn.template run<64, 96>();
  return kBadTile;
}

template <typename T>
int launch_quantize(const T* h, int M, int K, const float* peak_in, float* peak_out, int8_t* h8,
                    float* hsc, cudaStream_t st) {
  const int pieces = K / 16;
  int per = 1;  // pieces a thread: the fewest that need no more than kQMaxThreads threads
  while (per < kQMaxPieces && (pieces + per - 1) / per > kQMaxThreads) per *= 2;
  const int need = (pieces + per - 1) / per;
  const int threads = (need + 31) / 32 * 32;
  if (need > kQMaxThreads) {
    w8a8_quantize_long<T><<<M, kQThreads, 0, st>>>(h, K, peak_in, peak_out, h8, hsc);
  } else if (per == 1) {
    w8a8_quantize<T, 1><<<M, threads, 0, st>>>(h, K, peak_in, peak_out, h8, hsc);
  } else if (per == 2) {
    w8a8_quantize<T, 2><<<M, threads, 0, st>>>(h, K, peak_in, peak_out, h8, hsc);
  } else if (per == 4) {
    w8a8_quantize<T, 4><<<M, threads, 0, st>>>(h, K, peak_in, peak_out, h8, hsc);
  } else {
    w8a8_quantize<T, 8><<<M, threads, 0, st>>>(h, K, peak_in, peak_out, h8, hsc);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mp

// Status 0, -1 for a shape out of range (K not a multiple of 16, a grid
// past its limits), -2 when a tensor map cannot be encoded, -3 for a tile
// (tile_m x tile_n: 128 x 256, 128 x 128, 128 x 96, 64 x 128, 64 x 96) or a
// split (1-8 blocks, dividing tile_n / 8) not built, -4 for an output type
// other than bf16 (0) and fp32 (1), else the launch's cudaGetLastError().
// `dependent` launches the GEMM as a programmatic dependent of the kernel
// before it on the stream, and `prefetch` weight tiles are requested before
// that kernel has finished (at most the ring's stages).
extern "C" int mp_w8a8_gemm(const void* h8,     // (M, K) int8
                            const void* qt,     // (N, K) int8, the weight K-major
                            const void* hsc,    // (M,) fp32 row scales
                            const void* scale,  // (N,) fp32 column scales
                            void* out,          // (M, N) bf16 or fp32
                            int M, int N, int K, int tile_m, int tile_n, int splits,
                            int prefetch, int dependent, int out_f32, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0) return mp::kBadShape;
  const float* hs = static_cast<const float*>(hsc);
  const float* sc = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_f32 != 0 && out_f32 != 1) return mp::kBadType;
  const mp::Launch launch{h8, qt, hs, sc, out, M, N, K, splits, prefetch, dependent, out_f32, st};
  return mp::by_tile(tile_m, tile_n, launch);
}

// Clusters of `splits` blocks of the tile_m x tile_n GEMM (bf16 output) the
// card holds at once; a status <= -3 otherwise.
extern "C" int mp_w8a8_gemm_max_clusters(int tile_m, int tile_n, int splits) {
  if (splits < 1 || splits > mp::kMaxSplits) return mp::kBadTile;
  return mp::by_tile(tile_m, tile_n, mp::Occupancy{splits});
}

// Status 0, -1 for a shape out of range (M <= 0, K not a multiple of 16),
// -4 for an input type other than bf16 (0) and fp32 (1), else the launch's
// cudaGetLastError().  peak_out set: only the rows' |max| (M,); else the
// rows' scales into hsc (M,) and the int8 rows into h8 (M, K), from peak_in
// (M,) when it is set.
extern "C" int mp_w8a8_quantize(const void* h, int M, int K, int in_f32, const void* peak_in,
                                void* peak_out, void* h8, void* hsc, void* stream) {
  if (M <= 0 || K <= 0 || K % 16 != 0) return mp::kBadShape;
  const float* pin = static_cast<const float*>(peak_in);
  float* pout = static_cast<float*>(peak_out);
  int8_t* q = static_cast<int8_t*>(h8);
  float* s = static_cast<float*>(hsc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_f32 == 1) return mp::launch_quantize(static_cast<const float*>(h), M, K, pin, pout, q, s, st);
  if (in_f32 == 0) {
    return mp::launch_quantize(static_cast<const __nv_bfloat16*>(h), M, K, pin, pout, q, s, st);
  }
  return mp::kBadType;
}

extern "C" const char* mp_error_string(int status) {
  switch (status) {
    case mp::kBadShape:
      return "shape out of range (K a multiple of 16; the grid within its limits)";
    case mp::kEncodeFailed:
      return "cuTensorMapEncodeTiled failed for the operands' tensor maps";
    case mp::kBadTile:
      return "no kernel for this tile (128 x 256, 128 x 128, 128 x 96, 64 x 128, 64 x 96) or "
             "split (1-8 blocks, dividing tile_n / 8)";
    case mp::kBadType:
      return "dtype must be bf16 or fp32";
    default:
      break;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
