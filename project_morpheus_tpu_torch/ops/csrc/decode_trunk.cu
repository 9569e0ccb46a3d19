// The decode step's elementwise chain between its int8 GEMV calls, as three
// kernels (ops/decode_trunk.py, model/llama.py: llama_decode_step):
//
//   add_rmsnorm    x <- bf16(x + d) in place; h = bf16(bf16(x * rsqrt(mean(x^2) + eps)) * w)
//   rope_kv_write  the fused wqkv output (B, (H + 2KV) HD): rotated q out (B, H, HD),
//                  rotated k and plain v into the head-major bf16 cache at
//                  [layer, b, kv head, lengths[b], :]
//   swiglu         act = bf16(bf16(silu(g)) * u) of the fused wgu output (B, 2F)
//
// Not a Pallas kernel: the JAX package leaves this chain to XLA, which fuses
// it into the jitted decode step.  In PyTorch it was ~46 kernels a layer and
// step (casts, squares, a mean, products, sums, concatenations, two indexed
// writes, a copy), each touching at most 16 x 4,096 bf16 values.  Bound:
// device-memory bytes, a few hundred KB a call, well under a microsecond at
// 3.35 TB/s; what the call costs is its launch and a round trip or two to
// memory.  So each kernel reads its inputs once with 16-byte loads, keeps
// them in registers, and writes each output once: add_rmsnorm is one block
// a row (its sum of squares a block reduction in a fixed order, so a graph
// replay gives an eager call's bits), the other two one thread per eight
// values.
//
// Each takes part in a programmatic dependent launch.  It is launched to
// start before the kernel ahead of it ends and runs griddepcontrol.wait
// before it reads or writes anything; it first runs
// griddepcontrol.launch_dependents, so the int8 GEMV after it launches at
// once and streams its weights while this kernel runs (the GEMV waits for
// this grid before it reads the activations).  None of them writes weights.
//
// Rounding follows the plain PyTorch ops they replace (each of which rounds
// its fp32 result): the products, sums and differences are __fmul_rn /
// __fadd_rn / __fsub_rn, never contracted into an fma; the angle is
// float(position) * inv_freq; cosf and sinf, not the fast intrinsics;
// rsqrtf of mean + eps, the mean as the sum times 1 / D; silu as x / (1 +
// expf(-x)).  Only the order of the sum of squares differs from PyTorch's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kMaxRows = 16;
constexpr int kPieceThreads = 128;  // rope_kv_write and swiglu

__device__ __forceinline__ void wait_previous_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
}

// A 16-byte word holds eight bf16, element 2k in the low half of word k.
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = bf16_bits(f[2 * k]) | (bf16_bits(f[2 * k + 1]) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float round_bf16(float v) { return __uint_as_float(bf16_bits(v) << 16); }

// One block a row, one 8-value piece a thread (D / 8 threads, rounded up to
// a warp).  d may be null: then x is read and not written.
__global__ void add_rmsnorm_kernel(bf16* __restrict__ x, const bf16* __restrict__ d,
                                   const bf16* __restrict__ w, bf16* __restrict__ h, int D,
                                   float eps) {
  launch_dependents();
  __shared__ float warp_sums[32];
  const int row = blockIdx.x, i = threadIdx.x, pieces = D / 8;
  const bool mine = i < pieces;
  uint4* xr = reinterpret_cast<uint4*>(x + (long long)row * D);
  wait_previous_grid();
  float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float ss = 0.f;
  if (mine) {
    unpack(xr[i], v);
    if (d != nullptr) {
      float dv[8];
      unpack(reinterpret_cast<const uint4*>(d + (long long)row * D)[i], dv);
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = round_bf16(__fadd_rn(v[k], dv[k]));
      xr[i] = pack(v);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) ss = __fadd_rn(ss, __fmul_rn(v[k], v[k]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (i % 32 == 0) warp_sums[i / 32] = ss;
  __syncthreads();
  float total = 0.f;
  for (int k = 0; k < (int)(blockDim.x / 32); ++k) total += warp_sums[k];  // fixed order
  const float r = rsqrtf(__fadd_rn(__fmul_rn(total, 1.f / (float)D), eps));
  if (!mine) return;
  float wv[8], o[8];
  unpack(reinterpret_cast<const uint4*>(w)[i], wv);
#pragma unroll
  for (int k = 0; k < 8; ++k) o[k] = __fmul_rn(round_bf16(__fmul_rn(v[k], r)), wv[k]);
  reinterpret_cast<uint4*>(h + (long long)row * D)[i] = pack(o);
}

// Thread (blockIdx.x, threadIdx.x) of row blockIdx.y takes eight values of
// the first half of one head and the eight they rotate with in the second:
// heads [0, H) are q, [H, H + KV) k, [H + KV, H + 2KV) v (copied as they are).
__global__ void __launch_bounds__(kPieceThreads)
    rope_kv_write_kernel(const bf16* __restrict__ qkv, const int* __restrict__ lengths,
                         const float* __restrict__ inv_freqs, bf16* __restrict__ q_out,
                         bf16* __restrict__ cache_k, bf16* __restrict__ cache_v, int H, int KV,
                         int HD, int S) {
  launch_dependents();
  const int b = blockIdx.y, per_head = HD / 16, heads = H + 2 * KV;
  const int t = blockIdx.x * kPieceThreads + threadIdx.x;
  if (t >= heads * per_head) return;
  const int head = t / per_head, j = (t % per_head) * 8, half = HD / 2;
  const bf16* src = qkv + ((long long)b * heads + head) * HD;
  wait_previous_grid();
  const int pos = lengths[b];
  uint4 lo = *reinterpret_cast<const uint4*>(src + j);
  uint4 hi = *reinterpret_cast<const uint4*>(src + half + j);
  if (head < H + KV) {  // q or k: rotate by the position's angles
    float x1[8], x2[8];
    unpack(lo, x1);
    unpack(hi, x2);
    const float fpos = (float)pos;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float a = __fmul_rn(fpos, inv_freqs[j + k]);
      const float c = cosf(a), s = sinf(a);
      const float r1 = __fsub_rn(__fmul_rn(x1[k], c), __fmul_rn(x2[k], s));
      const float r2 = __fadd_rn(__fmul_rn(x2[k], c), __fmul_rn(x1[k], s));
      x1[k] = r1;
      x2[k] = r2;
    }
    lo = pack(x1);
    hi = pack(x2);
  }
  bf16* dst;
  if (head < H) {
    dst = q_out + ((long long)b * H + head) * HD;
  } else {
    if (pos < 0 || pos >= S) return;  // past the capacity: nothing to write
    const bool is_k = head < H + KV;
    const int kvh = is_k ? head - H : head - H - KV;
    dst = (is_k ? cache_k : cache_v) + (((long long)b * KV + kvh) * S + pos) * HD;
  }
  *reinterpret_cast<uint4*>(dst + j) = lo;
  *reinterpret_cast<uint4*>(dst + half + j) = hi;
}

// Thread t of the grid takes eight values of one row of act.
__global__ void __launch_bounds__(kPieceThreads)
    swiglu_kernel(const bf16* __restrict__ gu, bf16* __restrict__ act, int F, int rows) {
  launch_dependents();
  const int pieces = F / 8;
  const int t = blockIdx.x * kPieceThreads + threadIdx.x;
  if (t >= rows * pieces) return;
  const int r = t / pieces, j = (t % pieces) * 8;
  const bf16* g_row = gu + (long long)r * 2 * F;
  wait_previous_grid();
  float g[8], u[8], o[8];
  unpack(*reinterpret_cast<const uint4*>(g_row + j), g);
  unpack(*reinterpret_cast<const uint4*>(g_row + F + j), u);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float silu = round_bf16(g[k] / (1.0f + expf(-g[k])));
    o[k] = __fmul_rn(silu, u[k]);
  }
  *reinterpret_cast<uint4*>(act + (long long)r * F + j) = pack(o);
}

// Launch with the programmatic-serialization attribute: the kernel may
// start before the one ahead of it on the stream has ended.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), dim3 grid, dim3 block, void* stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Status of every entry: 0, -1 for a shape not taken, or a cudaError_t.
// Pointers are 16-byte aligned and rows contiguous (the wrappers check).

// x, d (or null), h: (rows, D) bf16; w: (D,) bf16.  D % 8 == 0, D <= 8192.
extern "C" int mp_add_rmsnorm(void* x, const void* d, const void* w, void* h, int rows, int D,
                              float eps, void* stream) {
  if (rows < 1 || rows > kMaxRows || D < 8 || D % 8 != 0 || D / 8 > 1024) return -1;
  const int threads = (D / 8 + 31) / 32 * 32;
  return launch(add_rmsnorm_kernel, dim3(rows), dim3(threads), stream, static_cast<bf16*>(x),
                static_cast<const bf16*>(d), static_cast<const bf16*>(w), static_cast<bf16*>(h),
                D, eps);
}

// qkv: (B, (H + 2KV) HD) bf16; lengths: (B,) int32; inv_freqs: (HD / 2,)
// fp32; q_out: (B, H, HD) bf16; cache_k, cache_v: one layer's (B, KV, S, HD)
// bf16.  HD % 16 == 0.
extern "C" int mp_rope_kv_write(const void* qkv, const void* lengths, const void* inv_freqs,
                                void* q_out, void* cache_k, void* cache_v, int B, int H, int KV,
                                int HD, int S, void* stream) {
  if (B < 1 || B > kMaxRows || H < 1 || KV < 1 || HD < 16 || HD % 16 != 0 || S < 1) return -1;
  const int threads = (H + 2 * KV) * (HD / 16);
  return launch(rope_kv_write_kernel, dim3((threads + kPieceThreads - 1) / kPieceThreads, B),
                dim3(kPieceThreads), stream, static_cast<const bf16*>(qkv),
                static_cast<const int*>(lengths), static_cast<const float*>(inv_freqs),
                static_cast<bf16*>(q_out), static_cast<bf16*>(cache_k),
                static_cast<bf16*>(cache_v), H, KV, HD, S);
}

// gu: (rows, 2F) bf16, g then u; act: (rows, F) bf16.  F % 8 == 0.
extern "C" int mp_swiglu(const void* gu, void* act, int rows, int F, void* stream) {
  if (rows < 1 || rows > kMaxRows || F < 8 || F % 8 != 0) return -1;
  const int threads = rows * (F / 8);
  return launch(swiglu_kernel, dim3((threads + kPieceThreads - 1) / kPieceThreads),
                dim3(kPieceThreads), stream, static_cast<const bf16*>(gu),
                static_cast<bf16*>(act), F, rows);
}

extern "C" const char* mp_error_string(int status) {
  if (status == -1) return "shape not taken: 1 to 16 rows; D % 8 == 0 and D <= 8192 (add_rmsnorm), "
                           "HD % 16 == 0 (rope_kv_write), F % 8 == 0 (swiglu)";
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
