// Slot-wise int8 flash decode over the flat position-major cache.
//
// Replaces the Pallas TPU kernel _slot_attn_kernel /
// decode_attention_int8_slots (project_morpheus_tpu/ops/decode_attention.py,
// pallas_call at :628/:648), the production decode attention for int8 KV
// caches.  Cache layout, byte-identical to the JAX engine's:
//   k, v   (L, B, S, KV*HD) int8, position-major with a flat head axis
//   scale  (L, B, S, 2*KV)  fp32: k scales in [:KV], v scales in [KV:]
// The kernel reads the scales in place; the TPU kernel's scale-major
// (L, B, 2KV, S) copy and its aliasing of the cache through the call were
// Mosaic/XLA workarounds with no counterpart here.  Design and bound: see
// flash_decode.cuh.
#include "flash_decode.cuh"

extern "C" int mp_decode_attention_int8_slots(
    const void* q,        // (B, H, HD) bf16
    const void* k,        // layer slice (B, S, KV*HD) int8
    const void* v,
    const void* scale,    // layer slice (B, S, 2*KV) fp32
    const void* lengths,  // (B,) int32
    void* out,            // (B, H, HD) bf16
    void* m_part, void* l_part, void* acc_part,
    int B, int S, int KV, int H, int HD, int n_splits, int split_len,
    float sm_scale, void* stream) {
  mp::Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = k;
  a.v = v;
  a.ksc = static_cast<const float*>(scale);
  a.vsc = static_cast<const float*>(scale) + KV;
  a.lengths = static_cast<const int*>(lengths);
  a.m_part = static_cast<float*>(m_part);
  a.l_part = static_cast<float*>(l_part);
  a.acc_part = static_cast<float*>(acc_part);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.kv_b = (long long)S * KV * HD;
  a.kv_h = HD;
  a.kv_p = (long long)KV * HD;
  a.sc_b = (long long)S * 2 * KV;
  a.sc_h = 1;
  a.sc_p = 2 * KV;
  a.H = H;
  a.KV = KV;
  a.n_splits = n_splits;
  a.split_len = split_len;
  a.sm_scale = sm_scale;
  return mp::launch_flash_decode<int8_t, true>(
      a, B, HD, static_cast<cudaStream_t>(stream));
}
