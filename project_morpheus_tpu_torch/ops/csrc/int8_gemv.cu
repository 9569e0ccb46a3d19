// Int8 weight-only GEMV for the decode step on Hopper (sm_90a).
//
//   y[m, n] = (sum_k h[m, k] * q[k, n]) * scale[n]      h bf16 (M, K), M <= 16
//
// Not a Pallas kernel: it replaces XLA's fused dequant-dot of the JAX
// package's matmul_maybe_quant (project_morpheus_tpu/model/quant.py:61-66)
// and tied_lm_head_logits (:170-175), where XLA folds the int8 -> bf16 cast
// into the dot.  Two layouts, both read in place (no bf16 copy of a weight
// is ever written):
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
// What held the earlier design back (per-lane 16-byte loads into registers,
// split-K partials in global memory summed by the last block of a column
// tile, found by an atomic ticket), measured by skipping parts of it
// (tools/kernel_ablation.py gemv, NVIDIA H100 80GB HBM3 at 700 W): at wo,
// 11.7 us a call = 1.2 us for an empty grid, 4.6 us more for the loads
// alone, 3.2 us more for the arithmetic, which a warp ran only after its
// loads landed, and 2.8 us for the ticket's tail; at lm_head the
// arithmetic added 90 us to 169 us of loads.  This design answers each:
//
// - Weights stream through a shared-memory ring by TMA.  One producer
//   thread issues 2-D tensor copies (cp.async.bulk.tensor) of weight tiles
//   into a ring of stages, each completing on an mbarrier with its byte
//   count; eight consumer warps convert and multiply the stages that have
//   landed and hand each stage back (a second mbarrier) once its bytes
//   have reached the tensor cores.  Loads no longer wait for arithmetic:
//   the ring keeps 72-80 KB of every block in flight for the whole call.
//   Tiles are 128 bytes wide and copied with the 128-byte swizzle, so the
//   consumers' 16-byte shared loads hit all 32 banks.
// - Weight copies start before the previous kernel has finished.  The
//   kernel is launched as a programmatic dependent launch; the producer
//   fills the ring with weights (which do not depend on that kernel), then
//   runs griddepcontrol.wait, and only then copies the activations h into
//   the same stages.  The launch and the first weight bytes overlap the
//   previous kernel's tail.  Captured into a CUDA graph, the launch keeps
//   its programmatic edge.  The scales are read at the start, too.  So
//   the kernel just before a call must not write that call's weights.
// - (K, N): split-K is reduced inside a thread-block cluster.  A column
//   tile of 128 outputs is one cluster of 1, 2, 4 or 8 blocks along y;
//   each block takes every cs-th stage of 128 k rows.  Warps sum in
//   shared memory in warp order; each block stores each sum into the
//   shared memory of the block that finishes that output (distributed
//   shared memory), at its own rank; after one cluster barrier each block
//   sums its share of the tile's outputs in rank order, scales them and
//   writes them row by row.  No global partials, no ticket, no second
//   pass, and a fixed summation order: a replayed graph gives the same
//   bits as an eager call.  The wrapper (ops/int8_gemv.py, k_splits) takes
//   the largest cluster whose grid has at most one block a SM: at the 3B
//   shapes every block is resident at once, each on an SM of its own.
//   (Clusters of 3, 5 or 6 blocks, which would use more of the SMs, were
//   measured slower: they run as if they had 4 or 8.)
// - (N, K): a persistent grid of one block a SM; h (all of K) is copied
//   into shared memory once, and the ring streams 64-row tiles of the
//   table, every row of a tile over all of K in one warp, so no reduction
//   is needed; two accumulators take the even and odd mma steps, and the
//   scales of a tile are read when it starts.
// - Products on tensor cores, mma.sync m16n8k16 bf16 -> fp32, after an
//   exact int8 -> bf16 conversion in integer operations (cvt2).  The
//   reduction order and the output order inside a warp are free, so each
//   lane feeds the mma the bytes it loaded, without a shuffle.  fp32
//   accumulation; the output is rounded once (the plain twin rounds the
//   product, the scale and the scaled output to bf16: up to about two
//   bf16 ulps apart).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_bf16.cuh"  // cvt2

namespace {

constexpr int kCons = 8;                    // consumer warps
constexpr int kThreads = (kCons + 1) * 32;  // and one producer warp
constexpr int kAlign = 1024;                // the 128-byte swizzle repeats every 1 KB

// (K, N): a stage is 128 k rows of a 128-column tile, plus h at those k
constexpr int kCols = 128;
constexpr int kStageK = 128;
// (N, K): a stage is 128 k bytes of a 64-row tile; h stays whole
constexpr int kTileRows = kCons * 8;
constexpr int kStageNK = 128;
constexpr int kStagesNK = 8;

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
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// 2-D tensor copy of one box into this block's shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wait_previous_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void consumer_sync() {  // the consumer warps only
  asm volatile("bar.sync 1, %0;\n" ::"n"(kCons * 32) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// store v at this shared address in the block of cluster rank `rank`
__device__ __forceinline__ void st_cluster(uint32_t addr, uint32_t rank, float v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote), "f"(v) : "memory");
}

__device__ __forceinline__ uint4 lds16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ uint32_t lds4(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// byte offset of 16-byte chunk `chunk` of 128-byte row `row` of a tile
// copied with the 128-byte swizzle (chunk index XOR row mod 8)
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// byte `sa` of `a` (low half) and byte `sb` of `b` (high half) -> bf16x2
__device__ __forceinline__ uint32_t bf16x2_of(uint32_t a, int sa, uint32_t b, int sb) {
  return cvt2(__byte_perm(a, b, sa | (sa << 4) | ((sb + 4) << 8) | ((sb + 4) << 12)));
}

// byte `sel` of two words (k and k + 1) -> bf16x2, k in the low half
__device__ __forceinline__ uint32_t pair(uint32_t lo, uint32_t hi, int sel) {
  return bf16x2_of(lo, sel, hi, sel);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// ------------------------------------------------------------ (K, N)

// Shared memory: the ring (kStages stages: the weight box, kStageK rows x
// 128 bytes, then h as two boxes of 64 k, kRows rows x 128 bytes each, all
// 1 KB aligned), the inbox where the cluster's blocks leave this block's
// share of their partial sums, and the tile's 128 scales: under half the
// SM's, so two blocks could share one.
template <int kRows>
struct KN {
  static constexpr int kStages = 4;
  static constexpr int kW = kStageK * kCols;
  static constexpr int kH = kRows * 128;
  static constexpr int kStage = kW + 2 * kH;
  static constexpr int kSlots = (kRows / 8) * 8 * 4;  // accumulator floats a lane
  static constexpr int kSums = kSlots * 32;           // of a tile
  static constexpr int kInbox = kStages * kStage;
  static constexpr int kScale = kInbox + (kSums + 8) * 4;
  static constexpr int kSmem = kScale + kCols * 4 + kAlign;
  static_assert(kCons * kSums * 4 <= kStages * kStage, "warp sums fit in the ring");
};

// Grid (ceil(N / 128), cs), clusters (1, cs, 1), cs 1, 2, 4 or 8: cluster x
// is column tile x; its block of rank r takes the stages r, r + cs, ... of
// ceil(K / 128).  Consumer warp c takes k rows [16c, 16c + 16) of a stage.
template <int kRows>
__global__ void __launch_bounds__(kThreads, 2)
gemv_kn(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap hmap,
        const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int M, int K, int N) {
  using G = KN<kRows>;
  constexpr int kN8 = kRows / 8;
  constexpr int kStages = G::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  const uint32_t base = (smem_u32(smem_raw) + kAlign - 1) & ~uint32_t(kAlign - 1);
  uint8_t* const smem = smem_raw + (base - smem_u32(smem_raw));
  float* const inbox = reinterpret_cast<float*>(smem + G::kInbox);
  float* const scale_s = reinterpret_cast<float*>(smem + G::kScale);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cs = gridDim.y;
  const int rank = static_cast<int>(cluster_rank());
  const int n_blk = blockIdx.x * kCols;
  const int stages = (K + kStageK - 1) / kStageK;
  const int mine = rank < stages ? (stages - rank + cs - 1) / cs : 0;
  const int per = (M * kCols + cs - 1) / cs;  // outputs of a tile each block finishes

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kCons);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kCons) {
    // producer: weights of the first stages before the previous kernel
    // ends, h after it
    if (lane == 0) {
      const int first = min(mine, kStages);
      for (int j = 0; j < first; ++j) {
        const uint32_t st = base + j * G::kStage;
        mbar_expect_tx(smem_u32(&full[j]), G::kStage);
        tma_load(st, &wmap, n_blk, (rank + j * cs) * kStageK, smem_u32(&full[j]));
      }
      wait_previous_grid();
      for (int j = 0; j < mine; ++j) {
        const int slot = j % kStages;
        const uint32_t st = base + slot * G::kStage, bar = smem_u32(&full[slot]);
        const int k0 = (rank + j * cs) * kStageK;
        if (j >= kStages) {
          mbar_wait(smem_u32(&empty[slot]), ((j / kStages) - 1) & 1);
          mbar_expect_tx(bar, G::kStage);
          tma_load(st, &wmap, n_blk, k0, bar);
        }
        tma_load(st + G::kW, &hmap, k0, 0, bar);
        tma_load(st + G::kW + G::kH, &hmap, k0 + 64, 0, bar);
      }
    }
    __syncwarp();
  } else {
    // the scales are weights too: read them now, not after the last stage
    if (threadIdx.x < kCols)
      scale_s[threadIdx.x] = n_blk + threadIdx.x < N ? scale[n_blk + threadIdx.x] : 0.f;
    const int gid = lane >> 2, tid4 = lane & 3;
    float acc[kN8][8][4];
#pragma unroll
    for (int r = 0; r < kN8; ++r)
#pragma unroll
      for (int t = 0; t < 8; ++t) acc[r][t][0] = acc[r][t][1] = acc[r][t][2] = acc[r][t][3] = 0.f;

    // this warp's rows of a stage: 16 warp + 2 tid4 + {0, 1, 8, 9}; its h:
    // box warp / 4, chunk 2 (warp % 4) (+1 for k + 8), word tid4
    const int row0 = 16 * warp + 2 * tid4;
    const int hbox = (warp >> 2) * G::kH, hchunk = 2 * (warp & 3);
    for (int j = 0; j < mine; ++j) {
      const int slot = j % kStages;
      const uint32_t st = base + slot * G::kStage;
      mbar_wait(smem_u32(&full[slot]), (j / kStages) & 1);
      const uint4 r0 = lds16(st + swz(row0, gid));
      const uint4 r1 = lds16(st + swz(row0 + 1, gid));
      const uint4 r8 = lds16(st + swz(row0 + 8, gid));
      const uint4 r9 = lds16(st + swz(row0 + 9, gid));
      uint32_t b[kN8][2];
#pragma unroll
      for (int r = 0; r < kN8; ++r) {
        const uint32_t hrow = st + G::kW + hbox + (gid + 8 * r) * 128 + 4 * tid4;
        b[r][0] = lds4(hrow + ((hchunk ^ gid) << 4));
        b[r][1] = lds4(hrow + (((hchunk + 1) ^ gid) << 4));
      }
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        // A rows: columns gid * 16 + t (bytes t) and + 8 (bytes t + 8)
        const int wi = t >> 2, bi = t & 3;
        const uint32_t a0 = pair(word(r0, wi), word(r1, wi), bi);
        const uint32_t a1 = pair(word(r0, wi + 2), word(r1, wi + 2), bi);
        const uint32_t a2 = pair(word(r8, wi), word(r9, wi), bi);
        const uint32_t a3 = pair(word(r8, wi + 2), word(r9, wi + 2), bi);
#pragma unroll
        for (int r = 0; r < kN8; ++r) mma_bf16(acc[r][t], a0, a1, a2, a3, b[r][0], b[r][1]);
      }
      // the stage goes back once its bytes have reached the tensor cores
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(&empty[slot]));
    }

    // warp sums, fragment by fragment (sum (r * 8 + t) * 4 + e of lane), in
    // the ring, which every stage has left; each sum over the warps in
    // order goes to the inbox of the block that finishes it, at this
    // block's rank
    float* red = reinterpret_cast<float*>(smem);
    consumer_sync();
#pragma unroll
    for (int r = 0; r < kN8; ++r)
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[(warp * G::kSlots + (r * 8 + t) * 4 + e) * 32 + lane] = acc[r][t][e];
    consumer_sync();
    for (int i = threadIdx.x; i < G::kSums; i += kCons * 32) {
      // sum (r * 8 + t) * 4 + e of lane (gid, tid4): h row 8 r + 2 tid4 +
      // (e & 1), column gid * 16 + t + 8 (e >> 1); output m * 128 + column
      const int ln = i & 31, slot = i >> 5;
      const int e = slot & 3, t = (slot >> 2) & 7, r = slot >> 5;
      const int m = 8 * r + 2 * (ln & 3) + (e & 1);
      if (m >= M) continue;
      const int o = m * kCols + (ln >> 2) * 16 + t + 8 * (e >> 1);
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kCons; ++w) s += red[w * G::kSums + i];
      const int owner = o / per;
      st_cluster(smem_u32(inbox + rank * per + o - owner * per), owner, s);
    }
  }

  // every block's sums are in their inboxes: each block finishes its slice
  // of the tile's outputs (row by row, so the stores coalesce), the ranks
  // summed in order
  cluster_sync();
  if (warp < kCons) {
    for (int j = threadIdx.x; j < per && rank * per + j < M * kCols; j += kCons * 32) {
      float s = 0.f;
      for (int q = 0; q < cs; ++q) s += inbox[q * per + j];
      const int o = rank * per + j, m = o / kCols, c = o % kCols;
      if (n_blk + c < N) out[(long long)m * N + n_blk + c] = __float2bfloat16_rn(s * scale_s[c]);
    }
  }
}

// ------------------------------------------------------------ (N, K)

// Shared memory: h as two boxes of 64 k (kRows rows x 128 bytes each) for
// each 128 k (zeros past K), then the ring of kStagesNK boxes of 64 rows x
// 128 k bytes.
template <int kRows>
struct NK {
  static constexpr int kW = kTileRows * kStageNK;
  static constexpr int kHBox = kRows * 128;
  __host__ __device__ static int h_boxes(int K) { return 2 * ((K + kStageNK - 1) / kStageNK); }
  static int smem(int K) { return h_boxes(K) * kHBox + kStagesNK * kW + kAlign; }
};

// After the previous kernel: all of h on one barrier.
template <int kRows>
__device__ __forceinline__ void load_h_nk(const CUtensorMap* hmap, uint32_t hs, int K,
                                          uint32_t bar) {
  wait_previous_grid();
  const int boxes = NK<kRows>::h_boxes(K);
  mbar_expect_tx(bar, boxes * NK<kRows>::kHBox);
  for (int b = 0; b < boxes; ++b) tma_load(hs + b * NK<kRows>::kHBox, hmap, b * 64, 0, bar);
}

// Persistent grid: block b takes the 64-row tiles b, b + gridDim.x, ...;
// consumer warp c takes rows [8c, 8c + 8) of a tile over all of K.
template <int kRows>
__global__ void __launch_bounds__(kThreads, 1)
gemv_nk(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap hmap,
        const float* __restrict__ scale, float* __restrict__ out, int M, int K, int N) {
  using G = NK<kRows>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStagesNK], empty[kStagesNK], hbar;
  const uint32_t base = (smem_u32(smem_raw) + kAlign - 1) & ~uint32_t(kAlign - 1);
  const uint32_t hs = base, ring = base + G::h_boxes(K) * G::kHBox;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (N + kTileRows - 1) / kTileRows;
  const int ksteps = (K + kStageNK - 1) / kStageNK;
  const int my_tiles = blockIdx.x < tiles ? (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  const int total = my_tiles * ksteps;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStagesNK; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kCons);
    }
    mbar_init(smem_u32(&hbar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kCons) {
    // producer: the ring's first weight tiles before the previous kernel
    // ends, then h, then the rest of the stream
    if (lane == 0) {
      const int first = min(total, kStagesNK);
      for (int g = 0; g < total; ++g) {
        const int slot = g % kStagesNK;
        const uint32_t bar = smem_u32(&full[slot]);
        if (g == first) load_h_nk<kRows>(&hmap, hs, K, smem_u32(&hbar));
        if (g >= kStagesNK) mbar_wait(smem_u32(&empty[slot]), ((g / kStagesNK) - 1) & 1);
        mbar_expect_tx(bar, G::kW);
        const int tile = blockIdx.x + (g / ksteps) * gridDim.x;
        tma_load(ring + slot * G::kW, &wmap, (g % ksteps) * kStageNK, tile * kTileRows, bar);
      }
      if (first == total) load_h_nk<kRows>(&hmap, hs, K, smem_u32(&hbar));
    }
    __syncwarp();
    return;
  }

  const int gid = lane >> 2, tid4 = lane & 3;
  const int wrow = 8 * warp + gid;  // this lane's row of a tile
  mbar_wait(smem_u32(&hbar), 0);
  int g = 0;
  for (int it = 0; it < my_tiles; ++it) {
    const int tile = blockIdx.x + it * gridDim.x;
    // C: h row gid (+ 8), table rows n, n + 1; their scales are read now,
    // so no load waits at the tile's end
    const int n = tile * kTileRows + 8 * warp + 2 * tid4;
    const float sc[2] = {n < N ? scale[n] : 0.f, n + 1 < N ? scale[n + 1] : 0.f};
    // two accumulators, even and odd mma steps, so that each mma waits on
    // the one before the last, not the last
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int ks = 0; ks < ksteps; ++ks, ++g) {
      const int slot = g % kStagesNK;
      const uint32_t st = ring + slot * G::kW;
      mbar_wait(smem_u32(&full[slot]), (g / kStagesNK) & 1);
      // k bytes [32 tid4, +32) of the stage: chunks 2 tid4 and 2 tid4 + 1
      const uint4 w0 = lds16(st + swz(wrow, 2 * tid4));
      const uint4 w1 = lds16(st + swz(wrow, 2 * tid4 + 1));
      // h at the same k: box 2 ks + tid4 / 2, chunks 4 (tid4 & 1) + 0..3
      const uint32_t hb = hs + (2 * ks + (tid4 >> 1)) * G::kHBox;
      uint4 x0[4], x1[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        x0[c] = lds16(hb + swz(gid, 4 * (tid4 & 1) + c));
        x1[c] = kRows > 8 ? lds16(hb + swz(gid + 8, 4 * (tid4 & 1) + c)) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        // mma step s: k bytes 4s..4s+3 of the lane's 32
        const uint32_t fw = word(s < 4 ? w0 : w1, s & 3);
        const uint32_t b0 = bf16x2_of(fw, 0, fw, 1);
        const uint32_t b1 = bf16x2_of(fw, 2, fw, 3);
        const uint32_t a0 = word(x0[s >> 1], 2 * (s & 1));
        const uint32_t a2 = word(x0[s >> 1], 2 * (s & 1) + 1);
        const uint32_t a1 = word(x1[s >> 1], 2 * (s & 1));
        const uint32_t a3 = word(x1[s >> 1], 2 * (s & 1) + 1);
        mma_bf16(acc[s & 1], a0, a1, a2, a3, b0, b1);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(&empty[slot]));
    }
    float sum[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[e] = acc[0][e] + acc[1][e];
#pragma unroll
    for (int half = 0; half < kRows / 8; ++half) {
      const int m = gid + 8 * half;
      if (m >= M) continue;
      float* row = out + (long long)m * N + n;
      const float y0 = sum[2 * half] * sc[0], y1 = sum[2 * half + 1] * sc[1];
      if (n + 1 < N && (N & 1) == 0) {
        *reinterpret_cast<float2*>(row) = make_float2(y0, y1);  // 4 lanes: one 32-byte sector
      } else {
        if (n < N) row[0] = y0;
        if (n + 1 < N) row[1] = y1;
      }
    }
  }
}

// ------------------------------------------------------------ host side

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links without -lcuda.
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

constexpr int kNoEncoder = -2, kEncodeFailed = -3;

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
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeFn>(p);
  }
  return fn;
}

// a row-major (rows, cols) matrix of `elem`-byte values, boxes of
// (box_rows, box_cols) copied with the 128-byte swizzle, zeros past the edge
int encode(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int elem, int rows,
           int cols, int box_rows, int box_cols) {
  const EncodeFn fn = encoder();
  if (fn == nullptr) return kNoEncoder;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed;
}

// Dynamic shared memory a block may use: the card's 227 KB, less 1 KB for
// the kernels' static barriers.
constexpr int kSmemLimit = 227 * 1024 - 1024;

// Raise a kernel's dynamic shared memory limit to `bytes` where `sized`
// (what it was raised to) is lower: on the first (eager) call of a shape,
// before any capture.
template <typename Kernel>
cudaError_t size_smem(Kernel kernel, int& sized, int bytes) {
  if (bytes <= sized) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) sized = bytes;
  return err;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int cluster_y, int smem, cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = 1;
  attr[1].val.clusterDim.y = cluster_y;
  attr[1].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int kRows>
int launch_kn(const void* h, const void* q, const void* scale, void* out, int M, int K, int N,
              int cs, cudaStream_t stream) {
  using G = KN<kRows>;
  static int sized = 0;
  cudaError_t err = size_smem(gemv_kn<kRows>, sized, G::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap wmap, hmap;
  int st = encode(&wmap, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, N, kStageK, kCols);
  if (st == 0) st = encode(&hmap, h, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, kRows, 64);
  if (st != 0) return st;
  return launch(gemv_kn<kRows>, dim3((N + kCols - 1) / kCols, cs), cs, G::kSmem, stream, wmap,
                hmap, static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), M, K,
                N);
}

template <int kRows>
int launch_nk(const void* h, const void* q, const void* scale, void* out, int M, int K, int N,
              int blocks, cudaStream_t stream) {
  using G = NK<kRows>;
  const int smem = G::smem(K);
  if (smem > kSmemLimit) return -1;
  static int sized = 0;
  cudaError_t err = size_smem(gemv_nk<kRows>, sized, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap wmap, hmap;
  int st = encode(&wmap, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N, K, kTileRows, kStageNK);
  if (st == 0) st = encode(&hmap, h, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, kRows, 64);
  if (st != 0) return st;
  return launch(gemv_nk<kRows>, dim3(blocks), 1, smem, stream, wmap, hmap,
                static_cast<const float*>(scale), static_cast<float*>(out), M, K, N);
}

}  // namespace

// Status: 0, a cudaError_t, or a negative code of mp_error_string.
// (K, N): `cs` blocks a cluster (1, 2, 4 or 8) split K; bf16 output.
extern "C" int mp_int8_gemv_kn(const void* h, const void* q, const void* scale, void* out, int M,
                               int K, int N, int cs, void* stream) {
  if (M < 1 || M > 16 || K % 16 != 0 || N % 16 != 0 || cs < 1 || cs > 8 || (cs & (cs - 1)))
    return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 8) return launch_kn<8>(h, q, scale, out, M, K, N, cs, st);
  return launch_kn<16>(h, q, scale, out, M, K, N, cs, st);
}

// (N, K): `blocks` persistent blocks (one a SM); fp32 output.
extern "C" int mp_int8_gemv_nk(const void* h, const void* q, const void* scale, void* out, int M,
                               int K, int N, int blocks, void* stream) {
  if (M < 1 || M > 16 || K % 16 != 0 || N < 1 || blocks < 1) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 8) return launch_nk<8>(h, q, scale, out, M, K, N, blocks, st);
  return launch_nk<16>(h, q, scale, out, M, K, N, blocks, st);
}

extern "C" const char* mp_error_string(int status) {
  if (status == -1) return "shape not taken: M in [1, 16], K % 16 == 0, and N % 16 == 0 with a "
                           "cluster of 1, 2, 4 or 8 blocks ((K, N) layout), or h and the ring "
                           "within 226 KB of shared memory ((N, K) layout)";
  if (status == kNoEncoder) return "cuTensorMapEncodeTiled not found through the driver entry point";
  if (status == kEncodeFailed) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
