// Shared pieces of the separable resize kernels (resize_mxu.cu,
// resize_phase.cu, resize_banded.cu): the element type per input kind, the
// reference's JS rounding, and pixel-wide shared-memory loads and global
// stores.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int SMEM_MAX = 232448;   // dynamic shared memory a block may ask for

template <bool U8> struct Elem { using type = float; };
template <> struct Elem<true> { using type = uint8_t; };

__device__ inline uint8_t round_u8(float v) {
  // JS rounding of the reference: +0.5, truncate, clamp
  int i = (int)(v + 0.5f);
  return (uint8_t)min(max(i, 0), 255);
}

// C consecutive floats of shared memory into registers (one 16- or 8-byte
// load where C allows it: rows and pixel offsets are multiples of C floats)
template <int C>
__device__ inline void load_px(const float* p, float (&v)[C]) {
  if constexpr (C == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (C == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) v[ch] = p[ch];
  }
}

template <int C, bool U8>
__device__ inline void store_px(typename Elem<U8>::type* out, size_t o, const float (&acc)[C]) {
  if constexpr (U8 && C == 4) {
    const uint32_t word = (uint32_t)round_u8(acc[0]) | ((uint32_t)round_u8(acc[1]) << 8) |
                          ((uint32_t)round_u8(acc[2]) << 16) | ((uint32_t)round_u8(acc[3]) << 24);
    *reinterpret_cast<uint32_t*>(out + o) = word;
  } else if constexpr (U8) {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) out[o + ch] = round_u8(acc[ch]);
  } else {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) out[o + ch] = acc[ch];
  }
}

}  // namespace
