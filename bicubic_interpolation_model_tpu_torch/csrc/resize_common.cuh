// Shared pieces of the separable resize kernels (resize_mxu.cu,
// resize_phase.cu, resize_banded.cu): the element type per input kind,
// cp.async copies, the reference's JS rounding without float-to-int
// conversions, the staging of an input window
// through shared memory, and pixel-wide shared-memory loads and global
// stores.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int SMEM_MAX = 232448;   // dynamic shared memory a block may ask for

template <bool U8> struct Elem { using type = float; };
template <> struct Elem<true> { using type = uint8_t; };

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// 16 bytes, of which the first `bytes` are read from src and the rest zero
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// clip(trunc(v), 0, 255) in the low byte (v = the sum + 0.5: the u8
// accumulators start at 0.5)
__device__ __forceinline__ uint32_t round_bits(float v) {
  const float y = fminf(fmaxf(v, 0.f), 255.f);
  return __float_as_uint(__fadd_rd(y, 8388608.f));
}

// the byte of round_bits alone
__device__ __forceinline__ uint32_t byte_bits(float v) { return round_bits(v) & 0xffu; }

__device__ __forceinline__ uint32_t pack4(const float (&v)[4]) {
  const uint32_t lo = __byte_perm(round_bits(v[0]), round_bits(v[1]), 0x1140);
  const uint32_t hi = __byte_perm(round_bits(v[2]), round_bits(v[3]), 0x1140);
  return __byte_perm(lo, hi, 0x5410);
}

// Bytes of one raw window row in shared memory: its bytes, up to 15 before
// them (a row starts at the aligned 16-byte chunk that holds its first
// byte), whole 16-byte units.
__host__ __device__ inline int raw_row_bytes(int win_c, int c, int esize) {
  return (win_c * c * esize + 15 + 15) & ~15;
}

// Window of one frame: image rows row0 .. row0 + win_r - 1 and pixels
// col0 .. col0 + win_c - 1 (either may start before the image). The part
// inside the image is [cb, ce) along a row.
struct Window {
  int row0, col0, win_r, win_c, cb, ce;
};

__device__ inline Window window(int w, int row0, int col0, int win_r, int win_c) {
  return Window{row0, col0, win_r, win_c, max(col0, 0), min(col0 + win_c, w)};
}

// Start the async copies of a window's rows that lie in the image into
// `raw` ([win_r][stride] bytes): whole aligned 16-byte chunks from the one
// that holds the row's first byte inside the image, cut at its last byte;
// rows outside the image are zero-filled. The caller commits.
template <typename T>
__device__ void issue_window(const T* img, int h, int w, int c, const Window& win, uint8_t* raw,
                             int stride) {
  const int valid = max(0, win.ce - win.cb) * c * (int)sizeof(T);
  const int nchunk = stride / 16;
  for (int e = threadIdx.x; e < win.win_r * nchunk; e += THREADS) {
    const int rr = e / nchunk, k = e - rr * nchunk;
    const int gr = win.row0 + rr;
    const void* src = img;
    int bytes = 0;
    if (gr >= 0 && gr < h && valid > 0) {
      const char* s = reinterpret_cast<const char*>(img + ((size_t)gr * w + win.cb) * c);
      const int lead = (int)(reinterpret_cast<uintptr_t>(s) & 15);
      const int left = lead + valid - 16 * k;   // bytes of the row from this chunk on
      if (left > 0) {
        bytes = left < 16 ? left : 16;
        src = s - lead + 16 * k;
      }
    }
    cp_async16_zfill(raw + (size_t)rr * stride + 16 * k, src, bytes);
  }
}

// Widen the window that issue_window copied into f32 rows of `dst_stride`
// floats (16-byte aligned; dst_len a multiple of 4), a warp per row and
// four elements per lane: element e of a row is window pixel e / c,
// channel e % c; zero outside the image and for e >= win_c * c.
template <typename T>
__device__ void widen_window(const T* img, int h, int w, int c, const Window& win,
                             const uint8_t* raw, int stride, float* dst, int dst_stride,
                             int dst_len) {
  const int zp = (win.cb - win.col0) * c;              // zero elements before the image
  const int n = max(0, win.ce - win.cb) * c;          // elements inside it
  for (int rr = threadIdx.x / 32; rr < win.win_r; rr += THREADS / 32) {
    const int gr = win.row0 + rr;
    const bool ok = gr >= 0 && gr < h;
    const T* row = reinterpret_cast<const T*>(raw + (size_t)rr * stride);
    if (ok)
      row = reinterpret_cast<const T*>(reinterpret_cast<const uint8_t*>(row) +
          (reinterpret_cast<uintptr_t>(img + ((size_t)gr * w + win.cb) * c) & 15));
    for (int e = 4 * (threadIdx.x % 32); e < dst_len; e += 128) {
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = e + q - zp;
        v[q] = ok && k >= 0 && k < n ? (float)row[k] : 0.f;
      }
      *reinterpret_cast<float4*>(dst + (size_t)rr * dst_stride + e) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
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

// n <= 16 bytes (words v, little-endian) to global memory at dst, by the
// widest stores the address and n allow
__device__ inline void store_bytes(uint8_t* dst, const uint32_t (&v)[4], int n) {
  const unsigned a = (unsigned)reinterpret_cast<uintptr_t>(dst);
  if (n == 16 && (a & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
  } else if ((a & 7) == 0 && (n & 7) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (8 * i < n) *reinterpret_cast<uint2*>(dst + 8 * i) = make_uint2(v[2 * i], v[2 * i + 1]);
  } else if ((a & 3) == 0 && (n & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (4 * i < n) *reinterpret_cast<uint32_t*>(dst + 4 * i) = v[i];
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (k < n) dst[k] = (uint8_t)(v[k >> 2] >> (8 * (k & 3)));
  }
}

// n <= 16 floats to global memory at dst, by the widest stores the address
// and n allow
__device__ inline void store_floats(float* dst, const float (&v)[16], int n) {
  const unsigned a = (unsigned)reinterpret_cast<uintptr_t>(dst);
  if ((a & 15) == 0 && (n & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (4 * i < n)
        *reinterpret_cast<float4*>(dst + 4 * i) =
            make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else if ((a & 7) == 0 && (n & 1) == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (2 * i < n) *reinterpret_cast<float2*>(dst + 2 * i) = make_float2(v[2 * i], v[2 * i + 1]);
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (k < n) dst[k] = v[k];
  }
}

}  // namespace
