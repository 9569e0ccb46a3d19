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
// ~34 MB of K/V read: operations bound it (~0.1 ms at 989 TFLOP/s).  This
// first design keeps to mma.sync:
//
// - Grid (row tile, kv head, job).  A block's 128 rows are (position, head)
//   pairs, position-major, of one kv head: the G query heads of a kv head
//   share every K/V tile, and a block reads its job's slot and offset from
//   device memory, so one launch serves any offsets and slots.
// - 64-key tiles in a ring of kStages stages in shared memory, filled by
//   16-byte cp.async copies (keys past the block's last attended position
//   zero-filled, never read).  bf16 tiles land in the XOR-swizzled layout ldmatrix reads
//   without bank conflicts; int8 tiles land as they are and are converted to
//   that bf16 layout in shared memory (exact: a byte-permute builds 2^23 + u
//   in fp32).
// - Each of the 8 warps owns 16 rows: Q.K^T and P.V on mma.sync.m16n8k16
//   (bf16, fp32 accumulators), K as the B operand by ldmatrix, V by
//   ldmatrix.trans, P moved from the score accumulators into A fragments in
//   registers.  Online softmax once per tile per row (a quad shuffle); a
//   warp whose rows all precede a tile skips it.
// wgmma, TMA and a tuned tile shape are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mp {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // (position, head) rows a block
constexpr int kBK = 64;             // keys a tile
constexpr int kStages = 2;          // tiles in flight: kStages - 1 loading ahead
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const __nv_bfloat16* q;  // (J, C, H, HD)
  const void* k;           // one layer's payload
  const void* v;
  const float* ksc;        // int8 caches: (B, S, 2*KV), k scales first; else null
  const int* slots;        // (J,) cache lanes
  const int* offsets;      // (J,) chunk start positions
  __nv_bfloat16* out;      // (J, C, H, HD)
  long long kv_b, kv_h, kv_p;  // payload element strides: slot, kv head, position
  long long sc_b, sc_p;        // scale element strides: slot, position
  int C, H, KV, G, hist;
  float sm_scale;
};

template <typename T, int HD>
struct Geom {
  static constexpr bool kQuant = sizeof(T) == 1;
  static constexpr int kRowBf = HD * 2;                  // bytes of a bf16 row
  static constexpr int kTileBf = kBK * kRowBf;           // bytes of a bf16 tile
  static constexpr int kRowRaw = HD * (int)sizeof(T);    // bytes of a cache row
  static constexpr int kTileRaw = kBK * kRowRaw;
  static constexpr int kRawChunks = kRowRaw / 16;        // 16-byte copies a row
  // one stage: K, V as they lie in the cache [, k scales, v scales]
  static constexpr int kStage = 2 * kTileRaw + (kQuant ? 2 * kBK * 4 : 0);
  // the stages [, the bf16 K and V that int8 tiles convert to]
  static constexpr int kSmem = kStages * kStage + (kQuant ? 2 * kTileBf : 0);
  static_assert(HD % 64 == 0, "swizzle needs 8 or more 16-byte chunks a row");
  static_assert(kStage % 16 == 0, "stages stay 16-byte aligned");
};

// byte offset of 16-byte chunk c of bf16 row r: chunks XOR-swizzled by the
// row's low 3 bits, so the 8 rows of one ldmatrix read hit distinct banks
template <int HD>
__device__ __forceinline__ int swz(int r, int c) {
  return r * HD * 2 + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&x);
}

// Byte i of w (int8, pre-flipped by ^0x80808080) -> exact fp32: 0x4B0000uu
// is 2^23 + u, and u = x + 128.
template <int kByte>
__device__ __forceinline__ float i8_to_f32(uint32_t flipped) {
  const uint32_t f = __byte_perm(flipped, 0x4B000000u, 0x7440 | kByte);
  return __uint_as_float(f) - 8388736.f;
}

// 16 bytes of one query row at head dims [d, d+1], times sm_scale, rounded
// to bf16 as the JAX function rounds q before its dots; zeros past the chunk.
__device__ __forceinline__ uint32_t q_pair(const __nv_bfloat16* row, int d, bool valid,
                                           float scale) {
  if (!valid) return 0u;
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + d));
  return pack_bf16(f.x * scale, f.y * scale);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1) prefill_chunk_attn(const Args a) {
  using Ge = Geom<T, HD>;
  constexpr bool kQuant = Ge::kQuant;
  constexpr int kNt = kBK / 8;   // score n-tiles a tile
  constexpr int kKs = HD / 16;   // k-steps over HD
  constexpr int kOt = HD / 8;    // output n-tiles
  extern __shared__ __align__(16) unsigned char smem[];

  const int f0 = blockIdx.x * kRows, h = blockIdx.y, j = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tg = lane & 3;
  const int G = a.G, C = a.C;
  const int b = a.slots[j], off = a.offsets[j];

  // the block's keys: through its last real row's position, inside hist
  const int c_last = min((f0 + kRows - 1) / G, C - 1);
  const int n_keys = min(off + c_last, a.hist - 1) + 1;
  const int n_tiles = (n_keys + kBK - 1) / kBK;
  const int warp_last = off + min((f0 + warp * 16 + 15) / G, C - 1);

  const long long row_bytes = a.kv_p * (long long)sizeof(T);
  const unsigned char* kg = static_cast<const unsigned char*>(a.k) +
                            (b * a.kv_b + h * a.kv_h) * (long long)sizeof(T);
  const unsigned char* vg = static_cast<const unsigned char*>(a.v) +
                            (b * a.kv_b + h * a.kv_h) * (long long)sizeof(T);
  const float* ksg = kQuant ? a.ksc + b * a.sc_b + h : nullptr;
  const float* vsg = kQuant ? ksg + a.KV : nullptr;

  auto load_tile = [&](int s, int t) {
    unsigned char* st = smem + s * Ge::kStage;
    const int p0 = t * kBK;
    for (int i = tid; i < kBK * Ge::kRawChunks; i += kThreads) {
      const int r = i / Ge::kRawChunks, c = i % Ge::kRawChunks;
      const int p = p0 + r;
      const bool ok = p < n_keys;
      const long long src = ok ? p * row_bytes + c * 16 : 0;
      const int dst = kQuant ? r * Ge::kRowRaw + c * 16 : swz<HD>(r, c);
      cp_async16(smem_addr(st + dst), kg + src, ok);
      cp_async16(smem_addr(st + Ge::kTileRaw + dst), vg + src, ok);
    }
    if constexpr (kQuant) {
      float* ss = reinterpret_cast<float*>(st + 2 * Ge::kTileRaw);
      if (tid < 2 * kBK) {
        const int p = p0 + tid % kBK;
        const bool ok = p < n_keys;
        cp_async4(smem_addr(ss + tid), (tid < kBK ? ksg : vsg) + (ok ? p * a.sc_p : 0), ok);
      }
    }
  };

  // int8 tile of stage s -> the swizzled bf16 K and V buffers
  auto convert = [&](int s) {
    const unsigned char* st = smem + s * Ge::kStage;
    unsigned char* bf = smem + kStages * Ge::kStage;
    constexpr int kPieces = HD / 16;  // 16 int8 values a piece
    for (int i = tid; i < 2 * kBK * kPieces; i += kThreads) {
      const int which = i / (kBK * kPieces), rem = i % (kBK * kPieces);
      const int r = rem / kPieces, pc = rem % kPieces;
      const uint4 x = *reinterpret_cast<const uint4*>(
          st + which * Ge::kTileRaw + r * Ge::kRowRaw + pc * 16);
      const uint32_t w[4] = {x.x ^ 0x80808080u, x.y ^ 0x80808080u, x.z ^ 0x80808080u,
                             x.w ^ 0x80808080u};
      uint32_t o[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[2 * e] = pack_bf16(i8_to_f32<0>(w[e]), i8_to_f32<1>(w[e]));
        o[2 * e + 1] = pack_bf16(i8_to_f32<2>(w[e]), i8_to_f32<3>(w[e]));
      }
      unsigned char* dst = bf + which * Ge::kTileBf;
      *reinterpret_cast<uint4*>(dst + swz<HD>(r, 2 * pc)) = make_uint4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<uint4*>(dst + swz<HD>(r, 2 * pc + 1)) =
          make_uint4(o[4], o[5], o[6], o[7]);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_tile(s, s);
    cp_async_commit();
  }

  // this thread's two rows: gid and gid + 8 of the warp's 16
  const int r_lo = f0 + warp * 16 + gid, r_hi = r_lo + 8;
  const int c_lo = r_lo / G, c_hi = r_hi / G;
  const bool ok_lo = c_lo < C, ok_hi = c_hi < C;
  const long long row_lo = ((long long)j * C + c_lo) * a.H + h * G + r_lo % G;
  const long long row_hi = ((long long)j * C + c_hi) * a.H + h * G + r_hi % G;
  const int pos_lo = off + c_lo, pos_hi = off + c_hi;

  uint32_t qf[kKs][4];  // A fragments: rows (lo, hi), head dims of k-step ks
  {
    const __nv_bfloat16* q_lo = a.q + row_lo * HD;
    const __nv_bfloat16* q_hi = a.q + row_hi * HD;
#pragma unroll
    for (int ks = 0; ks < kKs; ++ks) {
      const int d = ks * 16 + 2 * tg;
      qf[ks][0] = q_pair(q_lo, d, ok_lo, a.sm_scale);
      qf[ks][1] = q_pair(q_hi, d, ok_hi, a.sm_scale);
      qf[ks][2] = q_pair(q_lo, d + 8, ok_lo, a.sm_scale);
      qf[ks][3] = q_pair(q_hi, d + 8, ok_hi, a.sm_scale);
    }
  }

  float m_lo = -1e30f, m_hi = -1e30f, l_lo = 0.f, l_hi = 0.f;
  float acc[kOt][4];
#pragma unroll
  for (int n = 0; n < kOt; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    // the stage tile t - 1 used: every warp left it at the last barrier
    if (t + kStages - 1 < n_tiles) load_tile((t + kStages - 1) % kStages, t + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();  // tile t landed for all
    const unsigned char* st = smem + (t % kStages) * Ge::kStage;
    const unsigned char* kt = st;
    const unsigned char* vt = st + Ge::kTileRaw;
    if constexpr (kQuant) {
      convert(t % kStages);
      __syncthreads();
      kt = smem + kStages * Ge::kStage;
      vt = kt + Ge::kTileBf;
    }
    const float* ss = reinterpret_cast<const float*>(st + 2 * Ge::kTileRaw);
    const int key0 = t * kBK;

    if (key0 <= warp_last) {  // warp-uniform: some row of the warp sees this tile
      float s[kNt][4];
#pragma unroll
      for (int n = 0; n < kNt; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const uint32_t kbase = smem_addr(kt);
#pragma unroll
      for (int ks = 0; ks < kKs; ks += 2) {
#pragma unroll
        for (int n = 0; n < kNt; ++n) {
          const int row = n * 8 + (lane & 7);
          uint32_t r[4];
          ldsm_x4(r, kbase + swz<HD>(row, 2 * ks + (lane >> 3)));
          mma_bf16(s[n], qf[ks], r[0], r[1]);
          mma_bf16(s[n], qf[ks + 1], r[2], r[3]);
        }
      }

      // k scale on the score, the causal mask, the row maxima
      float mx_lo = -1e30f, mx_hi = -1e30f;
#pragma unroll
      for (int n = 0; n < kNt; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kk = n * 8 + 2 * tg + e, key = key0 + kk;
          const float f = kQuant ? ss[kk] : 1.f;
          const bool in = key < n_keys;
          s[n][e] = (in && key <= pos_lo) ? s[n][e] * f : -1e30f;
          s[n][2 + e] = (in && key <= pos_hi) ? s[n][2 + e] * f : -1e30f;
          mx_lo = fmaxf(mx_lo, s[n][e]);
          mx_hi = fmaxf(mx_hi, s[n][2 + e]);
        }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, x));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, x));
      }
      const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
      const float al_lo = exp2f((m_lo - mn_lo) * kLog2e);
      const float al_hi = exp2f((m_hi - mn_hi) * kLog2e);
      m_lo = mn_lo;
      m_hi = mn_hi;
      float ls_lo = 0.f, ls_hi = 0.f;
#pragma unroll
      for (int n = 0; n < kNt; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kk = n * 8 + 2 * tg + e;
          const float f = kQuant ? ss[kBK + kk] : 1.f;  // v scale on the prob
          const float p_lo = exp2f((s[n][e] - mn_lo) * kLog2e);
          const float p_hi = exp2f((s[n][2 + e] - mn_hi) * kLog2e);
          ls_lo += p_lo;
          ls_hi += p_hi;
          s[n][e] = p_lo * f;
          s[n][2 + e] = p_hi * f;
        }
      l_lo = l_lo * al_lo + ls_lo;  // this thread's columns; the quad sums at the end
      l_hi = l_hi * al_hi + ls_hi;
#pragma unroll
      for (int n = 0; n < kOt; ++n) {
        acc[n][0] *= al_lo;
        acc[n][1] *= al_lo;
        acc[n][2] *= al_hi;
        acc[n][3] *= al_hi;
      }

      // P.V: the score accumulators of n-tiles 2kk, 2kk+1 are the A fragment
      const uint32_t vbase = smem_addr(vt);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const int mi = lane >> 3;
        const int row = kk * 16 + (lane & 7) + 8 * (mi & 1);
#pragma unroll
        for (int np = 0; np < HD / 16; ++np) {
          uint32_t r[4];
          ldsm_x4_t(r, vbase + swz<HD>(row, 2 * np + (mi >> 1)));
          mma_bf16(acc[2 * np], pa, r[0], r[1]);
          mma_bf16(acc[2 * np + 1], pa, r[2], r[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage (and the bf16 buffers)
  }
  cp_async_wait<0>();

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, x);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, x);
  }
  const float d_lo = fmaxf(l_lo, 1e-30f), d_hi = fmaxf(l_hi, 1e-30f);
  __nv_bfloat16* o_lo = a.out + row_lo * HD + 2 * tg;
  __nv_bfloat16* o_hi = a.out + row_hi * HD + 2 * tg;
#pragma unroll
  for (int n = 0; n < kOt; ++n) {
    if (ok_lo)
      *reinterpret_cast<__nv_bfloat162*>(o_lo + n * 8) =
          __floats2bfloat162_rn(acc[n][0] / d_lo, acc[n][1] / d_lo);
    if (ok_hi)
      *reinterpret_cast<__nv_bfloat162*>(o_hi + n * 8) =
          __floats2bfloat162_rn(acc[n][2] / d_hi, acc[n][3] / d_hi);
  }
}

template <typename T, int HD>
int launch(const Args& a, int J, cudaStream_t stream) {
  constexpr int smem = Geom<T, HD>::kSmem;
  static bool sized = false;  // set once, at the first (eager) call, before any capture
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        prefill_chunk_attn<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const dim3 grid((a.C * a.G + kRows - 1) / kRows, a.KV, J);
  prefill_chunk_attn<T, HD><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mp

// Status 0, -1 for a head_dim with no instantiation (64 and 128 exist), -2
// for a shape out of range, else the launch's cudaGetLastError().
extern "C" int mp_prefill_chunk_attention(
    const void* q,        // (J, C, H, HD) bf16
    const void* k,        // one layer: int8 (B, S, KV*HD) or bf16 (B, KV, S, HD)
    const void* v,
    const void* scale,    // int8: (B, S, 2*KV) fp32; bf16: null
    const void* slots,    // (J,) int32
    const void* offsets,  // (J,) int32
    void* out,            // (J, C, H, HD) bf16
    int J, int C, int H, int KV, int HD, int S, int hist, int quant, float sm_scale,
    void* stream) {
  if (J <= 0 || C <= 0 || KV <= 0 || H % KV != 0 || hist <= 0 || hist > S || J > 65535)
    return -2;
  mp::Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = k;
  a.v = v;
  a.ksc = static_cast<const float*>(scale);
  a.slots = static_cast<const int*>(slots);
  a.offsets = static_cast<const int*>(offsets);
  a.out = static_cast<__nv_bfloat16*>(out);
  if (quant) {
    a.kv_b = (long long)S * KV * HD;
    a.kv_h = HD;
    a.kv_p = (long long)KV * HD;
    a.sc_b = (long long)S * 2 * KV;
    a.sc_p = 2 * KV;
  } else {
    a.kv_b = (long long)KV * S * HD;
    a.kv_h = (long long)S * HD;
    a.kv_p = HD;
    a.sc_b = a.sc_p = 0;
  }
  a.C = C;
  a.H = H;
  a.KV = KV;
  a.G = H / KV;
  a.hist = hist;
  a.sm_scale = sm_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (HD == 128) {
    return quant ? mp::launch<int8_t, 128>(a, J, st) : mp::launch<__nv_bfloat16, 128>(a, J, st);
  }
  if (HD == 64) {
    return quant ? mp::launch<int8_t, 64>(a, J, st) : mp::launch<__nv_bfloat16, 64>(a, J, st);
  }
  return -1;
}

extern "C" const char* mp_error_string(int status) {
  if (status == -1) return "no kernel instantiated for this head_dim (64 and 128 exist)";
  if (status == -2) return "shape out of range (J, C, heads, hist <= S)";
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
