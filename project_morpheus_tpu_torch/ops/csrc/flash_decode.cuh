// Split-S flash decode attention for Hopper (sm_90a), shared by the two
// decode-attention kernels of project_morpheus_tpu_torch/ops.
//
// Replaces the Pallas TPU kernels of project_morpheus_tpu/ops/
// decode_attention.py (_slot_attn_kernel, _decode_attn_kernel_layered,
// _decode_attn_kernel).  Those run one grid program per slot and walk the
// live positions in order; on a GPU that would leave most of the 132 SMs
// idle at 8 slots.  Here the work is cut three ways instead:
//
//   grid (split, kv_head, slot): each block covers the G query rows that
//   share one kv head, over `split_len` positions of one slot.  Blocks
//   whose first position is at or past lengths[slot] exit at once, so the
//   bytes read follow each slot's live length, never the cache capacity.
//
// Inside a block, 4 warps take positions in groups of kUnroll; a lane
// holds HD/32 elements of each row, so a row is one coalesced warp load
// (128 B for an int8 row of 128, 256 B for bf16).  Int8 payloads are
// dequantised in registers: exactly as the Pallas kernel, the per-position
// k scale multiplies the SCORE and the v scale the PROB, and no dequantised
// copy of the cache is ever written.  Each warp keeps its own online
// softmax (m, l, acc); the block merges its warps in shared memory and
// writes one partial (m, l, acc) per (slot, head, split).  A second small
// kernel merges the live splits: out = acc / max(l, 1e-30), which is 0 for
// a slot of length 0, as the Pallas kernels give.
//
// Bound: decode attention reads each live K/V position once, so it is
// bound by device-memory bytes (at 8 slots x 8192 live positions of the
// 3B int8 cache, 65,536 x (2 x 1024 + 64) B = 138 MB a layer, 41 us at
// the data sheet's 3.35 TB/s).  Score/prob arithmetic is ~2 flop a byte.
// This first version uses CUDA cores only (no wgmma/TMA): the query block
// is G=3 rows, far below a tensor-core tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mp {
// Internal linkage: every source that includes this header builds into a
// library of its own, and none of these symbols leaves it.
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;

struct Args {
  const __nv_bfloat16* q;  // (B, H, HD)
  const void* k;           // payload of the chosen layer
  const void* v;
  const float* ksc;        // per-position scales (int8 caches) or null
  const float* vsc;
  const int* lengths;      // (B,) live positions per slot
  float* m_part;           // (B, H, n_splits)
  float* l_part;           // (B, H, n_splits)
  float* acc_part;         // (B, H, n_splits, HD)
  __nv_bfloat16* out;      // (B, H, HD)
  long long kv_b, kv_h, kv_p;  // payload element strides: slot, kv head, position
  long long sc_b, sc_h, sc_p;  // scale element strides
  int H, KV, n_splits, split_len;
  float sm_scale;
};

// EPL consecutive elements of a row -> fp32 registers, one vector load.
template <typename T, int EPL>
__device__ __forceinline__ void load_row(const T* p, float* out) {
  if constexpr (sizeof(T) == 1) {
    if constexpr (EPL == 4) {
      const char4 c = *reinterpret_cast<const char4*>(p);
      out[0] = c.x; out[1] = c.y; out[2] = c.z; out[3] = c.w;
    } else if constexpr (EPL == 2) {
      const char2 c = *reinterpret_cast<const char2*>(p);
      out[0] = c.x; out[1] = c.y;
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) out[e] = static_cast<float>(p[e]);
    }
  } else {
    const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
#pragma unroll
    for (int e = 0; e < EPL / 2; ++e) {
      const float2 f = __bfloat1622float2(p2[e]);
      out[2 * e] = f.x;
      out[2 * e + 1] = f.y;
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int HD, int G, bool QUANT>
__global__ void __launch_bounds__(kThreads)
flash_decode_split(const Args a) {
  constexpr int EPL = HD / 32;
  static_assert(HD % 64 == 0, "a lane holds an even number of elements");
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int len = a.lengths[b];
  const int start = split * a.split_len;
  if (start >= len) return;  // past the live frontier: no bytes read
  const int end = min(start + a.split_len, len);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float qr[G][EPL];
  const __nv_bfloat16* qp = a.q + ((long long)b * a.H + (long long)h * G) * HD + lane * EPL;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      qr[g][e] = __bfloat162float(qp[g * HD + e]) * a.sm_scale;

  const T* kb = static_cast<const T*>(a.k) + b * a.kv_b + h * a.kv_h + lane * EPL;
  const T* vb = static_cast<const T*>(a.v) + b * a.kv_b + h * a.kv_h + lane * EPL;
  const float* ksb = QUANT ? a.ksc + b * a.sc_b + h * a.sc_h : nullptr;
  const float* vsb = QUANT ? a.vsc + b * a.sc_b + h * a.sc_h : nullptr;

  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -1e30f;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  for (int p0 = start + warp * kUnroll; p0 < end; p0 += kWarps * kUnroll) {
    float kf[kUnroll][EPL], vf[kUnroll][EPL], ks[kUnroll], vs[kUnroll];
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + u;
      valid[u] = p < end;
      ks[u] = vs[u] = 1.f;
      if (valid[u]) {
        load_row<T, EPL>(kb + p * a.kv_p, kf[u]);
        load_row<T, EPL>(vb + p * a.kv_p, vf[u]);
        if constexpr (QUANT) {
          ks[u] = ksb[p * a.sc_p];
          vs[u] = vsb[p * a.sc_p];
        }
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kf[u][e] = vf[u][e] = 0.f;
      }
    }
    float s[kUnroll][G];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) part += qr[g][e] * kf[u][e];
        s[u][g] = warp_sum(part) * ks[u];  // k dequant applied to the score
      }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (valid[u]) mx = fmaxf(mx, s[u][g]);
      const float alpha = expf(m[g] - mx);
      float psum = 0.f, pw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float p = valid[u] ? expf(s[u][g] - mx) : 0.f;
        psum += p;
        pw[u] = p * vs[u];  // v dequant folded into the prob
      }
      l[g] = l[g] * alpha + psum;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        float x = acc[g][e] * alpha;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) x += pw[u] * vf[u][e];
        acc[g][e] = x;
      }
      m[g] = mx;
    }
  }

  // merge the block's warps, write one partial per (slot, head, split)
  __shared__ float sm_m[kWarps][G], sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][HD];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][g][lane * EPL + e] = acc[g][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * HD; idx += kThreads) {
    const int g = idx / HD, d = idx % HD;
    float mx = sm_m[0][g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, asum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w][g] - mx);
      lsum += sm_l[w][g] * f;
      asum += sm_acc[w][g][d] * f;
    }
    const long long row = (long long)b * a.H + (long long)h * G + g;
    const long long part = row * a.n_splits + split;
    a.acc_part[part * HD + d] = asum;
    if (d == 0) {
      a.m_part[part] = mx;
      a.l_part[part] = lsum;
    }
  }
}

// One block per (slot, query head), one thread per head-dim element: merge
// the live splits' partials.  Splits past the live frontier were never
// written and are never read.
__global__ void flash_decode_merge(const Args a) {
  const int row = blockIdx.x;
  const int b = row / a.H;
  const int d = threadIdx.x;
  const int HD = blockDim.x;
  const int len = a.lengths[b];
  const int live = len > 0 ? min((len + a.split_len - 1) / a.split_len, a.n_splits) : 0;
  const long long base = (long long)row * a.n_splits;
  float mx = -1e30f;
  for (int s = 0; s < live; ++s) mx = fmaxf(mx, a.m_part[base + s]);
  float lsum = 0.f, asum = 0.f;
  for (int s = 0; s < live; ++s) {
    const float f = expf(a.m_part[base + s] - mx);
    lsum += a.l_part[base + s] * f;
    asum += a.acc_part[(base + s) * HD + d] * f;
  }
  a.out[(long long)row * HD + d] = __float2bfloat16(asum / fmaxf(lsum, 1e-30f));
}

// Shapes instantiated: (HD, G) = (128, 3) is Orpheus-3B (H=24, KV=8),
// (64, 4) Orpheus-1B (H=32, KV=8).  Returns -1 for any other shape, else
// the cudaGetLastError() of the two launches.
template <typename T, bool QUANT>
int launch_flash_decode(const Args& a, int B, int HD, cudaStream_t stream) {
  const int G = a.H / a.KV;
  const dim3 grid(a.n_splits, a.KV, B);
  if (HD == 128 && G == 3) {
    flash_decode_split<T, 128, 3, QUANT><<<grid, kThreads, 0, stream>>>(a);
  } else if (HD == 64 && G == 4) {
    flash_decode_split<T, 64, 4, QUANT><<<grid, kThreads, 0, stream>>>(a);
  } else {
    return -1;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode_merge<<<B * a.H, HD, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mp

// Message for a status returned by the entry points (-1: shape not built).
extern "C" const char* mp_error_string(int status) {
  if (status == -1) return "no kernel instantiated for this (head_dim, group) shape";
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
