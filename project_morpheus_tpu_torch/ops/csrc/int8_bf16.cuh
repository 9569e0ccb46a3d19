// Exact int8 -> bf16 conversion shared by int8_gemv.cu and
// prefill_chunk_attention.cu: the int8 payloads of the weights and of the KV
// cache reach the bf16 tensor cores through it.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// Two int8 values, in bytes 0 and 2 of `w`, -> exact bf16x2 (byte 0 in
// the low half).  With s the sign bit and l the low 7 bits of x,
// x = (128 + l) - 128 (1 + s): both terms are bf16 bit patterns (0x4300 | l
// and 0x4300 | s << 7), and their difference is exact.  Three integer
// operations and one bf16x2 subtract, no float conversion.
__device__ __forceinline__ uint32_t cvt2(uint32_t w) {
  const uint32_t mag = (w & 0x007F007Fu) | 0x43004300u;
  const uint32_t off = (w & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&mag),
                                   *reinterpret_cast<const __nv_bfloat162*>(&off));
  return *reinterpret_cast<const uint32_t*>(&d);
}

}  // namespace
