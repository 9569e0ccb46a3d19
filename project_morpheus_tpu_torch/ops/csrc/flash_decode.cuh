// Split-S flash decode attention for Hopper (sm_90a), one template shared by
// the two decode-attention kernels of project_morpheus_tpu_torch/ops.
//
// Replaces the Pallas TPU kernels of project_morpheus_tpu/ops/
// decode_attention.py: _slot_attn_kernel (:355), _decode_attn_kernel_layered
// (:149) and _decode_attn_kernel (:63).  It computes what they compute: q.k
// in fp32 over the exact cache values, times sm_scale, times the per-position
// k scale on the SCORE; an online softmax over positions < min(lengths[b], S);
// the v scale folded into the PROB; out = acc / max(l, 1e-30), so zeros for a
// slot of length 0.  Only the strides differ between the layouts.
//
// Bound: every live K/V position of the layer is read once, about 2 flop a
// byte, so device-memory bytes bound it (8 slots x 8192 live positions of the
// 3B int8 cache: 65,536 x 2,112 B = 138 MB, 41 us at 3.35 TB/s).  The design
// keeps the instruction count well under that byte time:
//
// - Grid (kv head, split, slot), kv head fastest: each block streams up to
//   split_len positions of one slot for the G query rows of one kv head.
//   Blocks at or past the live length exit at once: bytes follow live
//   lengths.  But each still costs a launch, so the grid is capped at a
//   few blocks an SM (launch_split), and past the cap a block strides over
//   several live splits of its slot: at S = 8,192 the SmolLM2 chat shape
//   otherwise launched 8,192 blocks for ~600 live splits.  The KV blocks
//   of one (split, slot) run side by side, so in the flat layout they read
//   each 1 KB position row and its 64 B scale row together.
// - A kStages-deep shared-memory ring of kTile-position tiles (K, V, scales),
//   filled with 16-byte cp.async copies that overlap the arithmetic.  Rows
//   past the live frontier are zero-filled, never read: no read leaves
//   [0, min(lengths[b], S)) of the slot.
// - Scores on tensor cores: each warp runs mma.sync.m16n8k16 with 16
//   positions on M, the G <= 4 query rows padded to N = 8 and HD on K.  The
//   head dims are permuted identically for K and q so that one 16-byte shared
//   load feeds a lane's A fragments for 4 (int8) or 2 (bf16) k-steps.  int8
//   K becomes fp16 exactly with a byte-permute / magic-number conversion
//   (1024 + (x + 128) is exact in fp16; two values per PRMT and HSUB2), not
//   one I2F per element.  The unscaled q goes in as fp16 for int8 caches:
//   bf16 -> fp16 is exact for |q| in [2^-14, 65504] (bf16's 8-bit mantissa
//   fits fp16's 11 bits; below 2^-14 low bits round off, above 65504 fp16
//   overflows), and a query of a real model lies well inside.  bf16 caches
//   use a bf16 product, exact as is.  sm_scale and the k scale multiply the
//   fp32 accumulator.
// - Softmax once per 16-position warp tile: a 3-step shuffle max per column,
//   exp2 per score; l is summed per lane and reduced once at the end.
// - P.V on CUDA cores in fp32, exact as the Pallas kernel's f32 dot: the warp
//   writes its 16 probabilities per query row (v scale folded in) to shared
//   memory, then each lane owns HD/32 head dims and streams the V rows,
//   converting int8 with a PRMT + FADD magic number per element.  Rounding P
//   to 16 bits for a tensor-core P.V would trade exactness for time the
//   bound does not need.
// - Each warp keeps its own (m, l, acc); the block merges its warps in shared
//   memory.  A slot with one live split writes its output at once; else each
//   block writes one partial per (slot, head, split) and a second kernel, a
//   block per query row, merges the live splits with all of a row's loads
//   in flight at once (on the H100 a merge reading one split at a time took
//   6-9 us a call, 14-17% of the device time), launched as a programmatic
//   dependent of the split grid so that its launch overlaps that grid's tail.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace mp {
// Internal linkage: every source that includes this header builds into a
// library of its own, and none of these symbols leaves it.
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 16 * kWarps;  // positions per ring stage: 16 per warp
constexpr int kStages = 3;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kThreads == 2 * kTile, "one thread copies one scale per stage");

struct Args {
  const __nv_bfloat16* q;  // (B, H, HD)
  const void* k;           // payload of the chosen layer
  const void* v;
  const float* ksc;        // per-position scales (int8 caches) or null
  const float* vsc;
  const int* lengths;      // (B,) live positions per slot
  float* m_part;           // (B, H, n_splits), log2 domain
  float* l_part;           // (B, H, n_splits)
  float* acc_part;         // (B, H, n_splits, HD)
  __nv_bfloat16* out;      // (B, H, HD)
  long long kv_b, kv_h, kv_p;  // payload element strides: slot, kv head, position
  long long sc_b, sc_h, sc_p;  // scale element strides
  int S, H, KV, n_splits, split_len;
  float sm_scale;
};

// Shared-memory geometry of one instantiation.
template <typename T, int HD, bool QUANT>
struct Geom {
  static constexpr int kRow = HD * (int)sizeof(T);     // bytes of one K or V row
  static constexpr int kChunks = kRow / 16;            // 16-byte chunks a row
  static constexpr int kVals = 16 / (int)sizeof(T);    // values in a chunk
  static constexpr int kStepsPerChunk = kVals / 4;     // mma k-steps a chunk feeds
  static constexpr int kSteps = HD / 16;               // mma k-steps over HD
  static constexpr int kLoads = kChunks / 4;           // 16-byte K loads a lane, a row
  static constexpr int kEpl = HD / 32;                 // head dims a lane owns in P.V
  static constexpr int kStage = 2 * kTile * kRow + (QUANT ? 2 * kTile * 4 : 0);
  static constexpr int kPbuf = kWarps * 16 * 4 * 4;    // probs, 16 rows x 4 query rows
  static constexpr int kAbuf = kWarps * 4 * 4;         // rescale factors
  static constexpr int kSmem = kStages * kStage + kPbuf + kAbuf;
  static_assert(kChunks % 4 == 0, "a row is a whole number of 64-byte lane groups");
  static_assert(kSteps == kLoads * kStepsPerChunk, "K loads cover HD");
  static_assert(kStage % 16 == 0, "stages stay 16-byte aligned");
};

// XOR swizzle of the 16-byte chunk index of K row r.  The A-fragment loads
// of one quarter-warp read rows 2m and 2m+1 at the same chunks; rows of 128
// bytes or more would put both on the same banks, so odd rows flip bit 2.
template <int kChunks>
__device__ __forceinline__ int swz(int r) {
  return kChunks >= 8 ? (r & 1) << 2 : 0;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; a row past the frontier zero-fills without a read.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Bytes 2i, 2i+1 of w (int8, pre-flipped by ^0x80808080) -> exact fp16x2:
// 0x64uu is 1024 + u in fp16, and u = x + 128, so subtracting 1152 gives x.
template <int kSel>
__device__ __forceinline__ uint32_t i8x2_to_f16x2(uint32_t flipped) {
  const uint32_t h = __byte_perm(flipped, 0x64646464u, kSel);
  uint32_t out;
  asm("sub.f16x2 %0, %1, %2;\n" : "=r"(out) : "r"(h), "r"(0x64806480u));
  return out;
}

// Byte i of w (int8, pre-flipped) -> exact fp32: 0x4B0000uu is 2^23 + u.
template <int kByte>
__device__ __forceinline__ float i8_to_f32(uint32_t flipped) {
  const uint32_t f = __byte_perm(flipped, 0x4B000000u, 0x7440 | kByte);
  return __uint_as_float(f) - 8388736.f;
}

template <bool kBf16>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  if constexpr (kBf16) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// The EPL head dims a lane owns of one V row in shared memory -> fp32.
template <typename T, int EPL>
__device__ __forceinline__ void load_v(const unsigned char* p, float (&out)[EPL]) {
  if constexpr (sizeof(T) == 1) {
    static_assert(EPL == 4 || EPL == 2, "int8 V: 4 or 2 dims a lane");
    uint32_t w;
    if constexpr (EPL == 4) w = *reinterpret_cast<const uint32_t*>(p);
    else w = *reinterpret_cast<const uint16_t*>(p);
    w ^= 0x80808080u;
    out[0] = i8_to_f32<0>(w);
    out[1] = i8_to_f32<1>(w);
    if constexpr (EPL == 4) {
      out[2] = i8_to_f32<2>(w);
      out[3] = i8_to_f32<3>(w);
    }
  } else {
    static_assert(EPL % 2 == 0, "bf16 V: pairs of dims");
#pragma unroll
    for (int e = 0; e < EPL / 2; ++e) {
      const uint32_t w = reinterpret_cast<const uint32_t*>(p)[e];
      out[2 * e] = __uint_as_float(w << 16);
      out[2 * e + 1] = __uint_as_float(w & 0xffff0000u);
    }
  }
}

// One split of one (kv head h, slot b): positions [split * split_len, end)
// of the slot's len live ones, for the G query rows of the kv head.
template <typename T, int HD, int G, bool QUANT>
__device__ __forceinline__ void attend_split(const Args& a, int h, int split, int b, int len) {
  using Ge = Geom<T, HD, QUANT>;
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int EPL = Ge::kEpl;
  extern __shared__ __align__(16) unsigned char smem[];

  const int start = split * a.split_len;
  const int end = min(start + a.split_len, len);
  const int n_tiles = (end - start + kTile - 1) / kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tg = lane & 3;  // mma fragment row group, column pair

  const long long row_bytes = a.kv_p * (long long)sizeof(T);
  const unsigned char* kg = static_cast<const unsigned char*>(a.k) +
                            (b * a.kv_b + h * a.kv_h) * (long long)sizeof(T);
  const unsigned char* vg = static_cast<const unsigned char*>(a.v) +
                            (b * a.kv_b + h * a.kv_h) * (long long)sizeof(T);
  const float* ksg = QUANT ? a.ksc + b * a.sc_b + h * a.sc_h : nullptr;
  const float* vsg = QUANT ? a.vsc + b * a.sc_b + h * a.sc_h : nullptr;
  float* pbuf = reinterpret_cast<float*>(smem + kStages * Ge::kStage) + warp * 64;
  float* abuf = reinterpret_cast<float*>(smem + kStages * Ge::kStage + Ge::kPbuf) + warp * 4;

  // stage s: K rows [0, kTile) swizzled, V rows, k scales, v scales
  auto load_tile = [&](int s, int t) {
    unsigned char* ks = smem + s * Ge::kStage;
    unsigned char* vs = ks + kTile * Ge::kRow;
    const int p0 = start + t * kTile;
#pragma unroll
    for (int i = tid; i < kTile * Ge::kChunks; i += kThreads) {
      const int r = i / Ge::kChunks, c = i % Ge::kChunks;
      const int p = p0 + r;
      const bool ok = p < end;
      const long long off = ok ? p * row_bytes + c * 16 : 0;
      cp_async16(smem_addr(ks + r * Ge::kRow + ((c ^ swz<Ge::kChunks>(r)) << 4)), kg + off, ok);
      cp_async16(smem_addr(vs + r * Ge::kRow + (c << 4)), vg + off, ok);
    }
    if constexpr (QUANT) {
      float* ss = reinterpret_cast<float*>(vs + kTile * Ge::kRow);
      const int r = tid % kTile, p = p0 + r;
      const bool ok = p < end;
      const float* src = (tid < kTile ? ksg : vsg) + (ok ? p * a.sc_p : 0);
      cp_async4(smem_addr(ss + tid), src, ok);
    }
  };

  // q as the mma B fragment (column gid = query row), head dims permuted as
  // the K loads deliver them: k-step ks, lane tg, value e (0..3) reads dim
  // (ks / SPC) * 4 * VALS + tg * VALS + 4 * (ks % SPC) + e
  uint32_t qf[Ge::kSteps][2];
  {
    const __nv_bfloat16* qr = a.q + ((long long)b * a.H + (long long)h * G + gid) * HD;
#pragma unroll
    for (int ks = 0; ks < Ge::kSteps; ++ks)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int d = (ks / Ge::kStepsPerChunk) * 4 * Ge::kVals + tg * Ge::kVals +
                      4 * (ks % Ge::kStepsPerChunk) + 2 * half;
        uint32_t bits = 0;
        if (gid < G) {
          const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(qr + d);
          if constexpr (kBf16) {
            bits = *reinterpret_cast<const uint32_t*>(&x);
          } else {
            const __half2 y = __floats2half2_rn(__low2float(x), __high2float(x));
            bits = *reinterpret_cast<const uint32_t*>(&y);
          }
        }
        qf[ks][half] = bits;
      }
  }

  const float qk_scale = a.sm_scale * kLog2e;  // scores in the log2 domain
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};  // columns 2tg, 2tg+1
  float acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_tile(s, s);
    cp_async_commit();
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t landed for all; stage (t-1) % kStages is free
    if (t + kStages - 1 < n_tiles) load_tile((t + kStages - 1) % kStages, t + kStages - 1);
    cp_async_commit();

    const unsigned char* ks = smem + (t % kStages) * Ge::kStage;
    const unsigned char* vs = ks + kTile * Ge::kRow;
    const float* ss = reinterpret_cast<const float*>(vs + kTile * Ge::kRow);
    const int r0 = warp * 16 + gid, r1 = r0 + 8;

    // scores: (16 positions) x (8 padded query rows) over HD
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < Ge::kLoads; ++j) {
      const int ch = 4 * j + tg;
      const uint4 x0 = *reinterpret_cast<const uint4*>(
          ks + r0 * Ge::kRow + ((ch ^ swz<Ge::kChunks>(r0)) << 4));
      const uint4 x1 = *reinterpret_cast<const uint4*>(
          ks + r1 * Ge::kRow + ((ch ^ swz<Ge::kChunks>(r1)) << 4));
      const uint32_t w0[4] = {x0.x, x0.y, x0.z, x0.w};
      const uint32_t w1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int s = 0; s < Ge::kStepsPerChunk; ++s) {
        uint32_t af[4];
        if constexpr (kBf16) {
          af[0] = w0[2 * s];
          af[1] = w1[2 * s];
          af[2] = w0[2 * s + 1];
          af[3] = w1[2 * s + 1];
        } else {
          const uint32_t u0 = w0[s] ^ 0x80808080u, u1 = w1[s] ^ 0x80808080u;
          af[0] = i8x2_to_f16x2<0x4140>(u0);
          af[1] = i8x2_to_f16x2<0x4140>(u1);
          af[2] = i8x2_to_f16x2<0x4342>(u0);
          af[3] = i8x2_to_f16x2<0x4342>(u1);
        }
        mma16816<kBf16>(c, af, qf[j * Ge::kStepsPerChunk + s]);
      }
    }

    // online softmax over this warp's 16 positions, once per query row
    const int p0 = start + t * kTile;
    const bool v0 = p0 + r0 < end, v1 = p0 + r1 < end;
    const float f0 = qk_scale * (QUANT ? ss[r0] : 1.f);  // k scale on the score
    const float f1 = qk_scale * (QUANT ? ss[r1] : 1.f);
    const float sc[4] = {v0 ? c[0] * f0 : -1e30f, v0 ? c[1] * f0 : -1e30f,
                         v1 ? c[2] * f1 : -1e30f, v1 ? c[3] * f1 : -1e30f};
    float pr[4], alpha[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float mx = fmaxf(sc[e], sc[2 + e]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      const float mn = fmaxf(m[e], mx);
      alpha[e] = exp2f(m[e] - mn);
      pr[e] = v0 ? exp2f(sc[e] - mn) : 0.f;
      pr[2 + e] = v1 ? exp2f(sc[2 + e] - mn) : 0.f;
      l[e] = l[e] * alpha[e] + pr[e] + pr[2 + e];
      m[e] = mn;
    }
    if (tg < 2) {  // query rows 2tg, 2tg+1 of the 4 kept
      const float w0 = QUANT ? ss[kTile + r0] : 1.f;  // v scale folded into the prob
      const float w1 = QUANT ? ss[kTile + r1] : 1.f;
      *reinterpret_cast<float2*>(pbuf + gid * 4 + 2 * tg) = make_float2(pr[0] * w0, pr[1] * w0);
      *reinterpret_cast<float2*>(pbuf + (gid + 8) * 4 + 2 * tg) =
          make_float2(pr[2] * w1, pr[3] * w1);
      if (gid == 0) *reinterpret_cast<float2*>(abuf + 2 * tg) = make_float2(alpha[0], alpha[1]);
    }
    __syncwarp();

    // P.V: lane owns head dims [lane * EPL, lane * EPL + EPL)
    const float4 al = *reinterpret_cast<const float4*>(abuf);
    const float alv[4] = {al.x, al.y, al.z, al.w};
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= alv[g];
    const unsigned char* vrow = vs + (warp * 16) * Ge::kRow + lane * EPL * (int)sizeof(T);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float4 pp = *reinterpret_cast<const float4*>(pbuf + r * 4);
      const float pv[4] = {pp.x, pp.y, pp.z, pp.w};
      float vf[EPL];
      load_v<T, EPL>(vrow + r * Ge::kRow, vf);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(pv[g], vf[e], acc[g][e]);
    }
    __syncwarp();
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it to merge the warps

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 4);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 8);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 16);
  }
  float* sm_m = reinterpret_cast<float*>(smem);  // [kWarps][4]
  float* sm_l = sm_m + kWarps * 4;                // [kWarps][4]
  float* sm_acc = sm_l + kWarps * 4;              // [kWarps][G][HD]
  if (gid == 0 && tg < 2) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sm_m[warp * 4 + 2 * tg + e] = m[e];
      sm_l[warp * 4 + 2 * tg + e] = l[e];
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[(warp * G + g) * HD + lane * EPL + e] = acc[g][e];
  __syncthreads();
  const int live = (len + a.split_len - 1) / a.split_len;  // <= n_splits: len <= S
  for (int idx = tid; idx < G * HD; idx += kThreads) {
    const int g = idx / HD, d = idx % HD;
    float mx = sm_m[g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * 4 + g]);
    float lsum = 0.f, asum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(sm_m[w * 4 + g] - mx);
      lsum += sm_l[w * 4 + g] * f;
      asum += sm_acc[(w * G + g) * HD + d] * f;
    }
    const long long row = (long long)b * a.H + (long long)h * G + g;
    if (live == 1) {  // the slot's only split: no partial, no merge
      a.out[row * HD + d] = __float2bfloat16(asum / fmaxf(lsum, 1e-30f));
      continue;
    }
    const long long part = row * a.n_splits + split;
    a.acc_part[part * HD + d] = asum;
    if (d == 0) {
      a.m_part[part] = mx;
      a.l_part[part] = lsum;
    }
  }
}

// Block (kv head, y, slot) attends the slot's live splits y, y + gridDim.y,
// ...; gridDim.y is set by the launch (launch_split).  A block past the live
// frontier exits after one multiply and compare: on the H100 a division on
// that path cost ~0.9 us a call where one block fits an SM.
template <typename T, int HD, int G, bool QUANT>
__global__ void __launch_bounds__(kThreads)
flash_decode_split(const Args a) {
  static_assert(G >= 1 && G <= 4, "query rows share one padded N = 8 column group");
  const int h = blockIdx.x, b = blockIdx.z;
  // let the merge grid be scheduled now; it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  const int len = min(a.lengths[b], a.S);  // never past the slot's capacity
  int split = blockIdx.y;
  if (split * a.split_len >= len) {  // past the live frontier: no bytes read
    if (len == 0 && split == 0) {  // a slot of length 0 attends nothing: zeros
      for (int i = threadIdx.x; i < G * HD; i += kThreads)
        a.out[((long long)b * a.H + (long long)h * G) * HD + i] = __float2bfloat16(0.f);
    }
    return;
  }
  for (; split * a.split_len < len; split += gridDim.y) {
    attend_split<T, HD, G, QUANT>(a, h, split, b, len);
    __syncthreads();  // the next split's ring overwrites the warps' merge
  }
}

// Merge the live splits of one query row: block (b * H + head).  A slot
// with one live split wrote its output from the split kernel, and a slot of
// length 0 its zeros; their blocks exit.  Splits past the live frontier
// (clamped to the capacity as the split kernel clamps) were never written
// and are never read.  Each thread owns 4 head dims and every kGroups-th
// split, with 8 splits' loads in flight at once, so the merge costs about
// one round trip to L2, not one per split; the groups then combine in
// shared memory.
template <int HD>
__global__ void __launch_bounds__(kThreads) flash_decode_merge(const Args a) {
  constexpr int kV = HD / 4, kGroups = kThreads / kV;
  __shared__ float4 sm_acc[kGroups][kV];
  __shared__ float sm_m[kGroups], sm_l[kGroups];
  const int row = blockIdx.x, b = row / a.H;
  const int len = min(a.lengths[b], a.S);
  const int live = (len + a.split_len - 1) / a.split_len;
  if (live <= 1) return;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the split grid is done
  const int d4 = threadIdx.x % kV, sg = threadIdx.x / kV;
  const long long base = (long long)row * a.n_splits;
  const float4* ap = reinterpret_cast<const float4*>(a.acc_part) + base * kV + d4;
  float m = -1e30f, l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = sg; s0 < live; s0 += 8 * kGroups) {
    float ms[8], ls[8];
    float4 x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int s = s0 + i * kGroups;
      const bool ok = s < live;
      ms[i] = ok ? a.m_part[base + s] : -1e30f;
      ls[i] = ok ? a.l_part[base + s] : 0.f;
      x[i] = ok ? ap[(long long)s * kV] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float mn = m;
#pragma unroll
    for (int i = 0; i < 8; ++i) mn = fmaxf(mn, ms[i]);
    const float r = exp2f(m - mn);
    l *= r;
    acc.x *= r; acc.y *= r; acc.z *= r; acc.w *= r;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float w = exp2f(ms[i] - mn);  // 0 for a split past the frontier
      l = fmaf(w, ls[i], l);
      acc.x = fmaf(w, x[i].x, acc.x);
      acc.y = fmaf(w, x[i].y, acc.y);
      acc.z = fmaf(w, x[i].z, acc.z);
      acc.w = fmaf(w, x[i].w, acc.w);
    }
    m = mn;
  }
  sm_acc[sg][d4] = acc;
  if (d4 == 0) {
    sm_m[sg] = m;
    sm_l[sg] = l;
  }
  __syncthreads();
  if (sg != 0) return;
  float mx = sm_m[0];
#pragma unroll
  for (int g = 1; g < kGroups; ++g) mx = fmaxf(mx, sm_m[g]);
  float lsum = 0.f;
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const float w = exp2f(sm_m[g] - mx);  // 0 for a group that held no split
    lsum = fmaf(w, sm_l[g], lsum);
    sum.x = fmaf(w, sm_acc[g][d4].x, sum.x);
    sum.y = fmaf(w, sm_acc[g][d4].y, sum.y);
    sum.z = fmaf(w, sm_acc[g][d4].z, sum.z);
    sum.w = fmaf(w, sm_acc[g][d4].w, sum.w);
  }
  const float il = 1.f / fmaxf(lsum, 1e-30f);
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(a.out + (long long)row * HD + 4 * d4);
  o[0] = __floats2bfloat162_rn(sum.x * il, sum.y * il);
  o[1] = __floats2bfloat162_rn(sum.z * il, sum.w * il);
}

template <typename T, int HD, int G, bool QUANT>
int launch_split(const Args& a, int B, int blocks_per_sm, cudaStream_t stream) {
  constexpr int smem = Geom<T, HD, QUANT>::kSmem;
  const auto kernel = flash_decode_split<T, HD, G, QUANT>;
  static int sms = 0;  // set once, before any graph capture may run
  if (sms == 0) {
    int dev = 0, n = 0;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    sms = n;
  }
  // A block per split of the capacity, as long as the grid stays within
  // blocks_per_sm blocks an SM: every block costs a launch, also one past
  // its slot's live length that exits at once.  Past that, each (kv head,
  // slot) gets fewer blocks, each striding over the slot's live splits.
  const int pairs = B * a.KV;
  const int ys = std::max(1, std::min(a.n_splits, (blocks_per_sm * sms + pairs - 1) / pairs));
  kernel<<<dim3(a.KV, ys, B), kThreads, smem, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // programmatic dependent launch: the merge's blocks are resident, waiting,
  // when the split grid's last block ends (1 us of 30-60 us on the H100)
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * a.H);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t merr = cudaLaunchKernelEx(&cfg, flash_decode_merge<HD>, a);
  if (merr != cudaSuccess) return static_cast<int>(merr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD, bool QUANT>
int launch_group(const Args& a, int B, int G, int blocks_per_sm, cudaStream_t stream) {
  switch (G) {
    case 1: return launch_split<T, HD, 1, QUANT>(a, B, blocks_per_sm, stream);
    case 2: return launch_split<T, HD, 2, QUANT>(a, B, blocks_per_sm, stream);
    case 3: return launch_split<T, HD, 3, QUANT>(a, B, blocks_per_sm, stream);
    case 4: return launch_split<T, HD, 4, QUANT>(a, B, blocks_per_sm, stream);
    default: return -1;
  }
}

// Instantiated for every head dim of 64 or 128 and every GQA group of 1 to
// 4 query heads a kv head (ops/decode_attention.py: flash_decode_supported;
// Orpheus-3B is (128, 3), Orpheus-1B (64, 4), Mistral-7B (128, 4),
// SmolLM2-1.7B (64, 1)).  Returns -1 for any other shape, -2 for a split
// length that is not a whole number of tiles, else the cudaGetLastError()
// of the two launches.
template <typename T, bool QUANT>
int launch_flash_decode(const Args& a, int B, int HD, int blocks_per_sm,
                        cudaStream_t stream) {
  const int G = a.H / a.KV;
  if (a.split_len <= 0 || a.split_len % kTile != 0) return -2;
  if (HD == 64) return launch_group<T, 64, QUANT>(a, B, G, blocks_per_sm, stream);
  if (HD == 128) return launch_group<T, 128, QUANT>(a, B, G, blocks_per_sm, stream);
  return -1;
}

}  // namespace
}  // namespace mp

// Message for a status returned by the entry points.
extern "C" const char* mp_error_string(int status) {
  if (status == -1) return "no kernel instantiated for this (head_dim, group) shape";
  if (status == -2) return "split_len must be a positive multiple of the 128-position tile";
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
