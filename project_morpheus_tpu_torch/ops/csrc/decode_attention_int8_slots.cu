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
// Mosaic/XLA workarounds with no counterpart here.
//
// Bound: device-memory bytes, 2 x KV*HD + 2 x KV x 4 bytes per live position
// (2,112 B at the 3B shapes; 8 slots x 8192 live: 138 MB, 41 us at
// 3.35 TB/s).  Design against it (flash_decode.cuh): kv-head blocks of one
// position range run side by side and stream the 1 KB rows through a
// cp.async ring; int8 scores on tensor cores (mma.sync m16n8k16, positions
// on M) after a PRMT/HSUB2 int8 -> fp16 conversion, so neither the score
// reductions nor the conversions cost more than the bytes do.
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
    int blocks_per_sm, float sm_scale, void* stream) {
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
  a.S = S;
  a.H = H;
  a.KV = KV;
  a.n_splits = n_splits;
  a.split_len = split_len;
  a.sm_scale = sm_scale;
  return mp::launch_flash_decode<int8_t, true>(
      a, B, HD, blocks_per_sm, static_cast<cudaStream_t>(stream));
}
