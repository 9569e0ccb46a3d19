// Head-major flash decode over one layer of the stacked cache.
//
// Replaces the Pallas TPU kernels _decode_attn_kernel_layered /
// decode_attention_layered (pallas_call at
// project_morpheus_tpu/ops/decode_attention.py:348) and _decode_attn_kernel
// / decode_attention (:701), which is the same computation with one layer.
// Cache layout, byte-identical to the JAX engine's bf16 cache:
//   k, v   (L, B, KV, S, HD) bf16, or int8 with
//   scales (L, B, KV, S) fp32 each (`quant`)
//
// Bound: device-memory bytes, 2 x KV*HD values per live position (4 KB in
// bf16 at the 3B shapes; 26,980 live positions: 110 MB, 33 us at
// 3.35 TB/s).  Design against it (flash_decode.cuh, the slot kernel's
// template with head-major strides): each block streams its head's
// contiguous rows through a cp.async ring, scores on tensor cores
// (bf16 mma.sync m16n8k16, positions on M), P.V in fp32 on CUDA cores.
#include "flash_decode.cuh"

extern "C" int mp_decode_attention_layered(
    const void* q,        // (B, H, HD) bf16
    const void* k,        // layer slice (B, KV, S, HD), bf16 or int8
    const void* v,
    const void* k_scale,  // layer slice (B, KV, S) fp32, or null
    const void* v_scale,
    const void* lengths,  // (B,) int32
    void* out,            // (B, H, HD) bf16
    void* m_part, void* l_part, void* acc_part,
    int B, int S, int KV, int H, int HD, int quant, int n_splits,
    int split_len, int blocks_per_sm, float sm_scale, void* stream) {
  mp::Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = k;
  a.v = v;
  a.ksc = static_cast<const float*>(k_scale);
  a.vsc = static_cast<const float*>(v_scale);
  a.lengths = static_cast<const int*>(lengths);
  a.m_part = static_cast<float*>(m_part);
  a.l_part = static_cast<float*>(l_part);
  a.acc_part = static_cast<float*>(acc_part);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.kv_b = (long long)KV * S * HD;
  a.kv_h = (long long)S * HD;
  a.kv_p = HD;
  a.sc_b = (long long)KV * S;
  a.sc_h = S;
  a.sc_p = 1;
  a.S = S;
  a.H = H;
  a.KV = KV;
  a.n_splits = n_splits;
  a.split_len = split_len;
  a.sm_scale = sm_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (quant) return mp::launch_flash_decode<int8_t, true>(a, B, HD, blocks_per_sm, st);
  return mp::launch_flash_decode<__nv_bfloat16, false>(a, B, HD, blocks_per_sm, st);
}
