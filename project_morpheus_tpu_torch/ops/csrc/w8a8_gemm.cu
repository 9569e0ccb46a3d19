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
// - A block is one copying warpgroup and two consumer warpgroups of 64 rows
//   (a 128 x BN output tile, BN 128 or 256, chosen by the wrapper from the
//   grid it gives on this card's SMs).  Thread 0 streams A and B tiles by
//   TMA (UINT8 tensor maps: int8 has no type of its own, the bits are the
//   same) into a ring of stages guarded by mbarriers; rows past M come from
//   TMA's zero fill.  Each consumer keeps one wgmma group in flight and
//   hands a stage back when the group before it has finished.  setmaxnreg
//   gives the copying warpgroup 40 registers a thread and the consumers 232.
// - The epilogue works from the accumulator fragments: __int2float_rn, the
//   row scale, then the column scale (__fmul_rn each), rounded once to the
//   output type; rows past M are not stored.  The output is written once.
//   Blocks along M are the fastest grid dimension, so the blocks that run
//   together share their weight tile in L2.
// - The quantize is one block a row: the |max| by a block reduction, then
//   16 values a thread a step, read again (from L1) and stored as 16 bytes.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"  // mbarriers, TMA, setmaxnreg, wgmma descriptors, encoder

namespace mp {
namespace {

// ------------------------------------------------------------ quantize

constexpr int kQThreads = 128;

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&f)[16]) {
  const uint4 a = reinterpret_cast<const uint4*>(p)[0], b = reinterpret_cast<const uint4*>(p)[1];
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ void load16(const float* p, float (&f)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 x = reinterpret_cast<const float4*>(p)[i];
    f[4 * i] = x.x;
    f[4 * i + 1] = x.y;
    f[4 * i + 2] = x.z;
    f[4 * i + 3] = x.w;
  }
}

// Row blockIdx.x of h (M, K): with peak_out, only its |max| into
// peak_out[m]; else from peak_in[m] (or its own |max| when peak_in is null)
// the scale into hsc[m] and the int8 row into h8.
template <typename T>
__global__ void __launch_bounds__(kQThreads)
    w8a8_quantize(const T* __restrict__ h, int K, const float* __restrict__ peak_in,
                  float* __restrict__ peak_out, int8_t* __restrict__ h8,
                  float* __restrict__ hsc) {
  const int m = blockIdx.x, tid = threadIdx.x;
  const T* row = h + static_cast<long long>(m) * K;
  const int pieces = K / 16;
  float peak;
  if (peak_in != nullptr) {
    peak = peak_in[m];
  } else {
    __shared__ float part[kQThreads / 32];
    float mx = 0.f;
    for (int p = tid; p < pieces; p += kQThreads) {
      float f[16];
      load16(row + 16 * p, f);
#pragma unroll
      for (int e = 0; e < 16; ++e) mx = fmaxf(mx, fabsf(f[e]));
    }
#pragma unroll
    for (int x = 16; x >= 1; x >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
    if ((tid & 31) == 0) part[tid >> 5] = mx;
    __syncthreads();
    peak = part[0];
#pragma unroll
    for (int w = 1; w < kQThreads / 32; ++w) peak = fmaxf(peak, part[w]);
    if (peak_out != nullptr) {
      if (tid == 0) peak_out[m] = peak;
      return;
    }
  }
  const float s = __fdiv_rn(fmaxf(peak, 1e-8f), 127.f);
  if (tid == 0) hsc[m] = s;
  int8_t* out = h8 + static_cast<long long>(m) * K;
  for (int p = tid; p < pieces; p += kQThreads) {
    float f[16];
    load16(row + 16 * p, f);
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t word = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float q = fminf(fmaxf(rintf(__fdiv_rn(f[4 * i + e], s)), -127.f), 127.f);
        word |= (static_cast<uint32_t>(static_cast<int>(q)) & 0xFFu) << (8 * e);
      }
      w[i] = word;
    }
    *reinterpret_cast<uint4*>(out + 16 * p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// ------------------------------------------------------------ GEMM

constexpr int kBM = 128;  // rows a block: two consumer warpgroups of 64
constexpr int kBK = 128;  // K a stage: one 128-byte swizzle atom of int8
constexpr int kGemmThreads = 384;
// Registers a thread after setmaxnreg, from the 168 a thread that
// __launch_bounds__(384, 1) allows: a pool of 64,512.  Asking for more than
// the pool holds would block the consumers' setmaxnreg.inc for ever.
constexpr int kPool = kGemmThreads * (65536 / kGemmThreads / 8 * 8);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = (kPool - 128 * kProducerRegs) / 256 / 8 * 8;
static_assert(kConsumerRegs == 232 && 128 * kProducerRegs + 256 * kConsumerRegs <= kPool,
              "register split");
constexpr int kSmemLimit = 227 * 1024 - 1024;  // less 1 KB for the static barriers

template <int BN>
struct GemmGeom {
  static constexpr int kA = kBM * kBK;  // an A tile: 128 rows of 128 bytes
  static constexpr int kB = BN * kBK;   // a B tile: BN rows of 128 bytes
  static constexpr int kStage = kA + kB;
  static constexpr int kStages = BN == 256 ? 4 : 6;
  static constexpr int kSmem = 1024 + kStages * kStage;  // 1 KB to align the base
  static_assert(kSmem <= kSmemLimit, "the ring fits in shared memory");
  static_assert(kStage % 1024 == 0, "stages keep the swizzle's 1 KB alignment");
};

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
  if constexpr (BN == 128) {
    wgmma_s8_n128(d, desc_a, desc_b, scale_d);
  } else {
    static_assert(BN == 256, "wgmma widths 128 and 256");
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

__device__ __forceinline__ float scaled(int32_t acc, float row, float col) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), row), col);
}

// out (M, N) = (A (M, K) . B (N, K)^T) * hsc[m] * scale[n]; block
// (blockIdx.x, blockIdx.y) writes rows 128 x, columns BN y
template <int BN, typename OutT>
__global__ void __launch_bounds__(kGemmThreads, 1)
    w8a8_gemm(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
              const float* __restrict__ hsc, const float* __restrict__ scale,
              OutT* __restrict__ out, int M, int N, int K) {
  using Ge = GemmGeom<BN>;
  constexpr int kStages = Ge::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int tid = threadIdx.x, lane = tid & 31;
  // the warp index through a shuffle: ptxas then knows the role branch below
  // is warp-uniform, and gives each role the registers setmaxnreg sets
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;
  const int n_tiles = K / kBK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // ------------------------------------------------ the copying warpgroup
    regs_dec<kProducerRegs>();
    if (tid == 0) {
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(smem_u32(&empty[s]), (t / kStages + 1) & 1);
        const uint32_t st = base + s * Ge::kStage, bar = smem_u32(&full[s]);
        mbar_expect_tx(bar, Ge::kStage);
        tma_load2(st, &amap, t * kBK, m0, bar);
        tma_load2(st + Ge::kA, &bmap, t * kBK, n0, bar);
      }
    }
    return;
  }

  // -------------------------------------------------- consumer warpgroups
  regs_inc<kConsumerRegs>();
  const int w = warp / 4 - 1;  // this consumer's 64 rows of the tile
  int32_t acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;  // no register read unset; scale_d 0 first
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    mbar_wait(smem_u32(&full[s]), (t / kStages) & 1);
    const uint32_t a = base + s * Ge::kStage + w * 64 * kBK, b = base + s * Ge::kStage + Ge::kA;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      wgmma_s8<BN>(acc, sw128_desc(a + 32 * ks, 16, 1024), sw128_desc(b + 32 * ks, 16, 1024),
                   t > 0 || ks > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // tile t - 1's products are done: its stage goes back
    if (t > 0 && lane == 0) mbar_arrive(smem_u32(&empty[(t - 1) % kStages]));
  }
  wgmma_wait<0>();
  keep(acc);

  // this thread's two rows (gid and gid + 8 of its warp's 16) and, for each
  // 8 columns n, columns 8 n + 2 tg and 8 n + 2 tg + 1
  const int gid = lane >> 2, tg = lane & 3;
  const int r_lo = m0 + 64 * w + 16 * (warp & 3) + gid, r_hi = r_lo + 8;
  const bool ok_lo = r_lo < M, ok_hi = r_hi < M;
  const float s_lo = ok_lo ? hsc[r_lo] : 0.f, s_hi = ok_hi ? hsc[r_hi] : 0.f;
  OutT* o_lo = out + static_cast<long long>(r_lo) * N + n0 + 2 * tg;
  OutT* o_hi = out + static_cast<long long>(r_hi) * N + n0 + 2 * tg;
  const float* sc = scale + n0 + 2 * tg;
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) {
    const float2 c = *reinterpret_cast<const float2*>(sc + 8 * n);
    if (ok_lo) {
      store2(o_lo + 8 * n, scaled(acc[4 * n], s_lo, c.x), scaled(acc[4 * n + 1], s_lo, c.y));
    }
    if (ok_hi) {
      store2(o_hi + 8 * n, scaled(acc[4 * n + 2], s_hi, c.x), scaled(acc[4 * n + 3], s_hi, c.y));
    }
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

template <int BN, typename OutT>
int launch_gemm(const void* a, const void* b, const float* hsc, const float* scale, void* out,
                int M, int N, int K, cudaStream_t stream) {
  using Ge = GemmGeom<BN>;
  if (N % BN != 0) return kBadTile;
  CUtensorMap am, bm;
  if (!encode2(&am, a, K, M, kBM) || !encode2(&bm, b, K, N, BN)) return kEncodeFailed;
  static bool sized = false;  // raised at the first (eager) call, before any capture
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        w8a8_gemm<BN, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, Ge::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const dim3 grid((M + kBM - 1) / kBM, N / BN);
  w8a8_gemm<BN, OutT><<<grid, kGemmThreads, Ge::kSmem, stream>>>(
      am, bm, hsc, scale, static_cast<OutT*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mp

// Status 0, -1 for a shape out of range (K not a multiple of 128, N of
// 128, M or N past the grid), -2 when a tensor map cannot be encoded, -3 for
// a tile width other than 128 and 256 or one that does not divide N, -4 for
// an output type other than bf16 (0) and fp32 (1), else the launch's
// cudaGetLastError().
extern "C" int mp_w8a8_gemm(const void* h8,     // (M, K) int8
                            const void* qt,     // (N, K) int8, the weight K-major
                            const void* hsc,    // (M,) fp32 row scales
                            const void* scale,  // (N,) fp32 column scales
                            void* out,          // (M, N) bf16 or fp32
                            int M, int N, int K, int block_n, int out_f32, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % mp::kBK != 0 || N % 128 != 0 || N / 128 > 65535)
    return mp::kBadShape;
  const float* hs = static_cast<const float*>(hsc);
  const float* sc = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_f32 != 0 && out_f32 != 1) return mp::kBadType;
  if (block_n == 256) {
    return out_f32 ? mp::launch_gemm<256, float>(h8, qt, hs, sc, out, M, N, K, st)
                   : mp::launch_gemm<256, __nv_bfloat16>(h8, qt, hs, sc, out, M, N, K, st);
  }
  if (block_n == 128) {
    return out_f32 ? mp::launch_gemm<128, float>(h8, qt, hs, sc, out, M, N, K, st)
                   : mp::launch_gemm<128, __nv_bfloat16>(h8, qt, hs, sc, out, M, N, K, st);
  }
  return mp::kBadTile;
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
  if (in_f32 == 1) {
    mp::w8a8_quantize<float><<<M, mp::kQThreads, 0, st>>>(static_cast<const float*>(h), K, pin,
                                                          pout, q, s);
  } else if (in_f32 == 0) {
    mp::w8a8_quantize<__nv_bfloat16><<<M, mp::kQThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(h), K, pin, pout, q, s);
  } else {
    return mp::kBadType;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mp_error_string(int status) {
  switch (status) {
    case mp::kBadShape:
      return "shape out of range (K a multiple of 128, N of 128; the quantize K of 16)";
    case mp::kEncodeFailed:
      return "cuTensorMapEncodeTiled failed for the operands' tensor maps";
    case mp::kBadTile:
      return "tile width must be 128 or 256 and divide N";
    case mp::kBadType:
      return "dtype must be bf16 or fp32";
    default:
      break;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
