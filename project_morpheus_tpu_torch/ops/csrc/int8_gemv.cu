// Int8 weight-only GEMV for the decode step on Hopper (sm_90a).
//
//   y[m, n] = (sum_k h[m, k] * q[k, n]) * scale[n]      h bf16 (M, K), M <= 16
//
// Not a Pallas kernel: it replaces XLA's fused dequant-dot of the JAX
// package's matmul_maybe_quant (project_morpheus_tpu/model/quant.py:61-66)
// and tied_lm_head_logits (:170-175), where XLA folds the int8 -> bf16 cast
// into the dot.  The eager port wrote a bf16 copy of every weight on every
// call instead (1 + 2 + 2 bytes moved per weight byte).  Two layouts, both
// read in place:
//   (K, N), N contiguous: wqkv, wo, wgu, wd (one layer of the stacked
//                         (L, in, out) weights), bf16 output;
//   (N, K), K contiguous: the tied embedding (157,184 x 3072) as lm_head,
//                         fp32 output (the logits).
//
// Bound: device-memory bytes.  Each weight byte is read once and feeds M
// multiply-adds, far below the ~295 operations a byte at which the tensor
// cores would limit.  At the Orpheus-3B shapes, M = 8, 3.35 TB/s:
//   weight    bytes      bound
//   wqkv      15.7 MB    4.7 us
//   wo         9.4 MB    2.8 us
//   wgu       50.3 MB   15.0 us
//   wd        25.2 MB    7.5 us
//   lm_head  482.9 MB    144 us
//   one decode step (28 layers + lm_head): 3.30 GB, 0.99 ms
//
// Design against that bound:
// - Every weight byte is loaded once with 16-byte loads, neighbouring lanes
//   on neighbouring bytes, and converted int8 -> fp32 -> bf16 in registers
//   (byte permute into 0x4B0000uu, one float subtract; exact for |x| <= 127).
// - The products run on tensor cores, mma.sync m16n8k16 bf16 -> fp32.  The
//   reduction order and the output column order inside a warp are free, so
//   each lane feeds the mma the bytes it loaded, without a shuffle:
//   (K, N): the weights are A (16 output columns on M) and the h rows B (8
//     rows on N; two n8 tiles for M > 8).  A lane loads 16 consecutive
//     columns of the 4 weight rows of its k slots; bytes t and t + 8 of its
//     chunk are its two A rows of mma tile t, so a warp covers 128 columns
//     with 8 tiles a k16 step and no product is spent on padding rows.
//   (N, K): the h rows are A (padded to 16) and the weights B.  A lane loads
//     16 consecutive k of one weight row; they feed 4 k16 steps, h read in
//     the same k order.  Each warp takes 8-row tiles of the table in turn
//     over a grid sized to the card (small units, so no partial last wave).
// - Loads of several k steps are issued before their products (4 steps for
//   M <= 8), so each SM keeps ~64 KB of weights in flight.
// - (K, N): K is split over the 8 warps of a block and over blockIdx.y, the
//   grid sized to about one block per SM (two fit; more splits only add
//   partials to reduce).  The warps reduce in shared memory in a fixed
//   order; each block stores its partial, and the last block of a column
//   tile to finish (an atomic ticket) sums the partials in split order,
//   four splits' loads in flight at a time, and writes the output.  Fixed
//   orders throughout: a replayed graph gives the same bits as an eager
//   call.
// - fp32 accumulation; the output is rounded once (the plain twin rounds
//   the product, the scale and the scaled output to bf16: up to about two
//   bf16 ulps apart).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 128;       // (K, N): columns of a block, 8 lane groups x 16 bytes
constexpr int kMaxTiles = 8192;  // (K, N): column tiles with a ticket counter

// Tickets of the (K, N) split reduction, one per column tile; the last
// block of a tile sets its counter back to 0.
__device__ unsigned int g_tickets[kMaxTiles];

__device__ __forceinline__ float i8_to_f32(uint32_t flipped, int sel) {
  // byte `sel` of a word pre-flipped by ^0x80808080 -> exact fp32:
  // 0x4B0000uu is 2^23 + u, u = x + 128
  return __uint_as_float(__byte_perm(flipped, 0x4B000000u, 0x7440 | sel)) - 8388736.f;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// bytes `sel` of two flipped words (k and k + 1) -> bf16x2, k in the low half
__device__ __forceinline__ uint32_t pair(uint32_t lo, uint32_t hi, int sel) {
  return pack_bf16(i8_to_f32(lo, sel), i8_to_f32(hi, sel));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint4 load16(const void* p, bool ok) {
  if (!ok) return make_uint4(0, 0, 0, 0);
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ uint32_t load4(const void* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const uint32_t*>(p)) : 0u;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint4 flip(uint4 v) {
  return make_uint4(v.x ^ 0x80808080u, v.y ^ 0x80808080u, v.z ^ 0x80808080u,
                    v.w ^ 0x80808080u);
}

__device__ __forceinline__ void store(void* out, long long i, float v, bool f32) {
  if (f32) static_cast<float*>(out)[i] = v;
  else static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
}

// ------------------------------------------------------------ (K, N)

// Grid (ceil(N / 128), n_ksplit).  Warp w of block (x, y) runs the k16 steps
// y * 8 + w, then every 8 * n_ksplit steps on, kU steps' loads at a time.
// kRows = 8 or 16: the h rows, as one or two n8 tiles.
template <int kRows, int kU>
__global__ void __launch_bounds__(kThreads, 2)
gemv_kn(const __nv_bfloat16* __restrict__ h, const int8_t* __restrict__ q,
        const float* __restrict__ scale, void* __restrict__ out, float* __restrict__ part,
        int M, int K, int N, int n_ksplit, bool out_f32) {
  constexpr int kN8 = kRows / 8;
  extern __shared__ float red[];  // (kWarps, kRows, kCols)
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tid4 = lane & 3;
  const int n_blk = blockIdx.x * kCols;
  const int col = n_blk + gid * 16;
  const bool col_ok = col < N;
  const int steps = K / 16;
  const int stride = n_ksplit * kWarps;
  const uint32_t* h32 = reinterpret_cast<const uint32_t*>(h);

  float acc[kN8][8][4];
#pragma unroll
  for (int r = 0; r < kN8; ++r)
#pragma unroll
    for (int t = 0; t < 8; ++t) acc[r][t][0] = acc[r][t][1] = acc[r][t][2] = acc[r][t][3] = 0.f;

  for (int s = blockIdx.y * kWarps + warp; s < steps; s += kU * stride) {
    uint4 w[kU][4];
    uint32_t b[kU][kN8][2];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int ss = s + u * stride;
      const bool ok = ss < steps;
      const int k0 = ss * 16 + tid4 * 2;
      const int8_t* base = q + (long long)k0 * N + col;
      w[u][0] = load16(base, ok && col_ok);
      w[u][1] = load16(base + N, ok && col_ok);
      w[u][2] = load16(base + 8LL * N, ok && col_ok);
      w[u][3] = load16(base + 9LL * N, ok && col_ok);
#pragma unroll
      for (int r = 0; r < kN8; ++r) {
        const int row = gid + 8 * r;
        const long long at = ((long long)row * K + k0) / 2;
        b[u][r][0] = load4(h32 + at, ok && row < M);
        b[u][r][1] = load4(h32 + at + 4, ok && row < M);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const uint4 r0 = flip(w[u][0]), r1 = flip(w[u][1]), r8 = flip(w[u][2]), r9 = flip(w[u][3]);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int wi = t >> 2, bi = t & 3;  // byte t, and byte t + 8 two words on
        const uint32_t a0 = pair(word(r0, wi), word(r1, wi), bi);
        const uint32_t a1 = pair(word(r0, wi + 2), word(r1, wi + 2), bi);
        const uint32_t a2 = pair(word(r8, wi), word(r9, wi), bi);
        const uint32_t a3 = pair(word(r8, wi + 2), word(r9, wi + 2), bi);
#pragma unroll
        for (int r = 0; r < kN8; ++r) mma_bf16(acc[r][t], a0, a1, a2, a3, b[u][r][0], b[u][r][1]);
      }
    }
  }

  // tile t: mma row g -> column g * 16 + t, row g + 8 -> column g * 16 + t + 8;
  // mma column c of n8 tile r -> h row 8 r + c
  float* mine = red + warp * kRows * kCols;
#pragma unroll
  for (int r = 0; r < kN8; ++r)
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int m = 8 * r + tid4 * 2, c = gid * 16 + t;
      mine[m * kCols + c] = acc[r][t][0];
      mine[(m + 1) * kCols + c] = acc[r][t][1];
      mine[m * kCols + c + 8] = acc[r][t][2];
      mine[(m + 1) * kCols + c + 8] = acc[r][t][3];
    }
  __syncthreads();
  const long long MN = (long long)M * N;
  for (int i = threadIdx.x; i < M * kCols; i += kThreads) {
    const int r = i / kCols, c = i % kCols, n = n_blk + c;
    if (n >= N) continue;
    float sum = 0.f;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) sum += red[(wp * kRows + r) * kCols + c];
    if (n_ksplit == 1) store(out, (long long)r * N + n, sum * scale[n], out_f32);
    else part[blockIdx.y * MN + (long long)r * N + n] = sum;
  }
  if (n_ksplit == 1) return;
  __threadfence();  // this block's partial is visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&g_tickets[blockIdx.x], 1u) == (unsigned)n_ksplit - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // each thread sums its kOut outputs over the splits in split order, with
  // the loads of kBatch splits of all its outputs in flight at once
  constexpr int kOut = kRows * kCols / kThreads, kBatch = 4;
  float sum[kOut];
#pragma unroll
  for (int o = 0; o < kOut; ++o) sum[o] = 0.f;
  for (int sp0 = 0; sp0 < n_ksplit; sp0 += kBatch) {
    float v[kOut][kBatch];
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
      const int i = threadIdx.x + o * kThreads, r = i / kCols, n = n_blk + i % kCols;
      const float* p = part + (long long)r * N + n;
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        v[o][j] = (r < M && n < N && sp0 + j < n_ksplit) ? __ldcg(p + (sp0 + j) * MN) : 0.f;
    }
#pragma unroll
    for (int o = 0; o < kOut; ++o)
#pragma unroll
      for (int j = 0; j < kBatch; ++j) sum[o] += v[o][j];
  }
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    const int i = threadIdx.x + o * kThreads, r = i / kCols, n = n_blk + i % kCols;
    if (r < M && n < N) store(out, (long long)r * N + n, sum[o] * scale[n], out_f32);
  }
  if (threadIdx.x == 0) g_tickets[blockIdx.x] = 0;
}

// ------------------------------------------------------------ (N, K)

// Warp-sized units: global warp w takes 8-row tiles w, w + warps, ... of the
// table, the whole of K for each, 64 k a trip (kU trips' loads at a time).
// Lane (gid, tid4) reads k [tid4 * 16, +16) of a trip's 64-wide slab of row
// tile * 8 + gid; mma step s takes bytes 4s..4s+3, and A the same k of h.
template <int kRows, int kU>
__global__ void __launch_bounds__(kThreads)
gemv_nk(const __nv_bfloat16* __restrict__ h, const int8_t* __restrict__ q,
        const float* __restrict__ scale, void* __restrict__ out, int M, int K, int N,
        bool out_f32) {
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, tid4 = lane & 3;
  const int warps = gridDim.x * kWarps;
  const int tiles = (N + 7) / 8, trips = K / 64;
  const bool row0 = gid < M, row1 = kRows > 8 && gid + 8 < M;
  const __nv_bfloat16* h0 = h + (long long)gid * K + tid4 * 16;
  const __nv_bfloat16* h1 = h + (long long)(gid + 8) * K + tid4 * 16;

  for (int tile = blockIdx.x * kWarps + (threadIdx.x >> 5); tile < tiles; tile += warps) {
    const int n = tile * 8 + gid;
    const int8_t* wrow = q + (long long)n * K + tid4 * 16;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int it = 0; it < trips; it += kU) {
      uint4 w[kU], x0[kU][2], x1[kU][2];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const bool ok = it + u < trips;
        const int k = (it + u) * 64;
        w[u] = load16(wrow + k, ok && n < N);
        x0[u][0] = load16(h0 + k, ok && row0);
        x0[u][1] = load16(h0 + k + 8, ok && row0);
        x1[u][0] = load16(h1 + k, ok && row1);
        x1[u][1] = load16(h1 + k + 8, ok && row1);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const uint4 f = flip(w[u]);
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          // h words 2s, 2s + 1 of the lane's 16 k: elements 4s..4s+1, 4s+2..4s+3
          const uint32_t a0 = word(x0[u][s >> 1], (2 * s) & 3);
          const uint32_t a2 = word(x0[u][s >> 1], (2 * s + 1) & 3);
          const uint32_t a1 = word(x1[u][s >> 1], (2 * s) & 3);
          const uint32_t a3 = word(x1[u][s >> 1], (2 * s + 1) & 3);
          const uint32_t fw = word(f, s);
          const uint32_t b0 = pack_bf16(i8_to_f32(fw, 0), i8_to_f32(fw, 1));
          const uint32_t b1 = pack_bf16(i8_to_f32(fw, 2), i8_to_f32(fw, 3));
          mma_bf16(acc, a0, a1, a2, a3, b0, b1);
        }
      }
    }
    const int c = tile * 8 + tid4 * 2;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (c + e >= N) continue;
      const float sc = scale[c + e];
      if (row0) store(out, (long long)gid * N + c + e, acc[e] * sc, out_f32);
      if (row1) store(out, (long long)(gid + 8) * N + c + e, acc[2 + e] * sc, out_f32);
    }
  }
}

template <int kRows, int kU>
int launch_kn(const void* h, const void* q, const void* scale, void* out, void* part, int M,
              int K, int N, int n_ksplit, bool out_f32, cudaStream_t stream) {
  constexpr int smem = kWarps * kRows * kCols * (int)sizeof(float);
  static bool sized = false;  // set on the first (eager) call, before any capture
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemv_kn<kRows, kU>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const dim3 grid((N + kCols - 1) / kCols, n_ksplit);
  if (n_ksplit > 1 && (int)grid.x > kMaxTiles) return -1;
  gemv_kn<kRows, kU><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(h), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), out, static_cast<float*>(part), M, K, N, n_ksplit,
      out_f32);
  return static_cast<int>(cudaGetLastError());
}

template <int kRows, int kU>
int launch_nk(const void* h, const void* q, const void* scale, void* out, int M, int K, int N,
              bool out_f32, cudaStream_t stream) {
  static int resident = 0;  // blocks the card holds at once, set on the first (eager) call
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gemv_nk<kRows, kU>, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident = sms * per_sm;
  }
  const int tiles = (N + 7) / 8;
  const int grid = min(resident, (tiles + kWarps - 1) / kWarps);
  gemv_nk<kRows, kU><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(h), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), out, M, K, N, out_f32);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Status: 0, a cudaError_t, or -1 for a shape the kernel does not take.
extern "C" int mp_int8_gemv_kn(const void* h, const void* q, const void* scale, void* out,
                               void* part, int M, int K, int N, int n_ksplit, int out_f32,
                               void* stream) {
  if (M < 1 || M > 16 || K % 16 != 0 || N % 16 != 0 || n_ksplit < 1) return -1;
  if (n_ksplit > 1 && part == nullptr) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 8) return launch_kn<8, 4>(h, q, scale, out, part, M, K, N, n_ksplit, out_f32 != 0, st);
  return launch_kn<16, 2>(h, q, scale, out, part, M, K, N, n_ksplit, out_f32 != 0, st);
}

extern "C" int mp_int8_gemv_nk(const void* h, const void* q, const void* scale, void* out,
                               int M, int K, int N, int out_f32, void* stream) {
  if (M < 1 || M > 16 || K % 64 != 0 || N < 1) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 8) return launch_nk<8, 4>(h, q, scale, out, M, K, N, out_f32 != 0, st);
  return launch_nk<16, 4>(h, q, scale, out, M, K, N, out_f32 != 0, st);
}

extern "C" const char* mp_error_string(int status) {
  if (status == -1) return "shape not taken: M in [1, 16], K % 16 == 0 and N % 16 == 0 "
                           "((K, N) layout, at most 8192 column tiles when K is split), "
                           "K % 64 == 0 ((N, K) layout)";
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
