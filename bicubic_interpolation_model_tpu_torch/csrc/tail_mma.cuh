// Tensor-core core of the packed learned tail (kernels A and G), sm_90a.
//
// conv_out of the packed tail is an implicit GEMM per output phase (p, q):
// M = LR pixels (16 per mma tile, one row per pixel), K = taps x map lanes
// (9 x 16 gated up-lanes in kernel A, 9 x 32 map lanes in kernel G), N = the
// 16 predicted weights (two n8 tiles). Kernel A's upsample is one more such
// GEMM ([pixels x 32 features] x [32 x 16 lanes] per phase block). Both
// kernels gather the A operand from shared memory at per-row addresses
// (pixel and phase block of each tap) and contract it here in chunks of
// K = 16 against B fragments built once per block.
//
// Precision routes (mma.sync; wgmma with N = 16 is further work):
//   f32   3xTF32 on mma.sync.m16n8k8: x = hi + lo with hi = x truncated to
//         TF32 (its low 13 bits cleared) and lo = x - hi truncated the same
//         way, so hi + lo keeps 21 of x's 24 bits; big += hi*hi, and the two
//         cross terms hi*lo + lo*hi go to a separate accumulator (small)
//         that is added to big once, after the last chunk, so no cross term
//         is added into a large running sum. The split is two bit masks and
//         a subtraction on the full-rate pipes (cvt.rna.tf32 costs more
//         there, and its rounding buys nothing the u8 output can see). One
//         TF32 pass is not enough for the f32 contract (<= 1 u8 LSB with a
//         share < 1e-3 against the f32 graph).
//   bf16  one pass of mma.sync.m16n8k16 on bf16 operands with f32
//         accumulation: the operands already are bf16 values, so the
//         products are exact, as on the TPU's MXU.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32 and mma.m16n8k16 .bf16),
// lane = 4 g + t: A rows g and g + 8; the accumulator holds columns 2t and
// 2t + 1 of each n8 tile for rows g and g + 8, so the 4 lanes of a quad hold
// a pixel's 16 weights (apply_store reduces over the quad).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace tail_mma {

// B fragments of one K = 16 chunk and both n8 tiles, as uint4 "parts" kept
// in shared memory as [part][lane] (a warp reads 512 contiguous bytes per
// part): f32 parts hi(k 0-7), hi(k 8-15), lo(k 0-7), lo(k 8-15), each
// (b0 n-tile 0, b1 n-tile 0, b0 n-tile 1, b1 n-tile 1), split once per
// block; bf16 one part of packed pairs.
template <bool BF16>
struct BParts {
  static constexpr int N = BF16 ? 1 : 4;
};

// accumulators of one m16 x n16 tile: big[n-tile][c0..c3], small the
// 3xTF32 cross terms (unused on the bf16 route)
struct Acc {
  float big[2][4];
  float small[2][4];
};

constexpr uint32_t TF32_MASK = 0xffffe000u;   // sign, exponent, 10 bits

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & TF32_MASK;
  lo = __float_as_uint(x - __uint_as_float(hi)) & TF32_MASK;
}

// round to the nearest bf16, ties to even (finite values), as f32
__device__ __forceinline__ float round_bf16(float v) {
  const uint32_t u = __float_as_uint(v);
  return __uint_as_float((u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u);
}

// two bf16-valued floats as a bf16 pair, lower K in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo_k, float hi_k) {
  return __byte_perm(__float_as_uint(lo_k), __float_as_uint(hi_k), 0x7632);
}

// tanh from one exp2 and one reciprocal: absolute error ~1e-7, far below
// what the u8 output can see
__device__ __forceinline__ float fast_tanh(float x) {
  return 1.f - __fdividef(2.f, __expf(2.f * x) + 1.f);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The lane's B fragments of the K = 16 chunk k[0..15][0..15] of a
// row-major matrix (row stride ldn floats; bf16-valued floats on the bf16
// route, which pack exactly), one uint4 per part.
template <bool BF16>
__device__ __forceinline__ void make_b(const float* k, int ldn, int lane,
                                       uint4 (&b)[BParts<BF16>::N]) {
  const int g = lane >> 2, t = lane & 3;
  if constexpr (BF16) {
    uint32_t v[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int n = nt * 8 + g;
      v[nt][0] = pack_bf16(__ldg(k + (2 * t) * ldn + n),
                           __ldg(k + (2 * t + 1) * ldn + n));
      v[nt][1] = pack_bf16(__ldg(k + (2 * t + 8) * ldn + n),
                           __ldg(k + (2 * t + 9) * ldn + n));
    }
    b[0] = make_uint4(v[0][0], v[0][1], v[1][0], v[1][1]);
  } else {
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const float* r0 = k + (ks * 8 + t) * ldn + g;
      const float* r1 = r0 + 4 * ldn;
      uint32_t hi[4], lo[4];
      split_tf32(__ldg(r0), hi[0], lo[0]);
      split_tf32(__ldg(r1), hi[1], lo[1]);
      split_tf32(__ldg(r0 + 8), hi[2], lo[2]);
      split_tf32(__ldg(r1 + 8), hi[3], lo[3]);
      b[ks] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      b[2 + ks] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  }
}

// make_b for `lane`, written to parts[part * 32 + lane]
template <bool BF16>
__device__ __forceinline__ void store_b(const float* k, int ldn, int lane,
                                        uint4* parts) {
  uint4 b[BParts<BF16>::N];
  make_b<BF16>(k, ldn, lane, b);
#pragma unroll
  for (int p = 0; p < BParts<BF16>::N; ++p) parts[p * 32 + lane] = b[p];
}

// acc += A chunk . B chunk. p0 / p1: the lane's A rows g and g + 8 at the
// chunk's first K element, in 32-bit words of shared memory (16 f32 values
// or 8 bf16 pairs, lower K in the low half). b: the lane's B parts.
template <bool BF16>
__device__ __forceinline__ void mma_chunk(Acc& acc, const uint32_t* p0,
                                          const uint32_t* p1,
                                          const uint4 (&b)[BParts<BF16>::N],
                                          int lane) {
  const int t = lane & 3;
  if constexpr (BF16) {
    const uint32_t a[4] = {p0[t], p1[t], p0[t + 4], p1[t + 4]};
    mma_bf16(acc.big[0], a, b[0].x, b[0].y);
    mma_bf16(acc.big[1], a, b[0].z, b[0].w);
  } else {
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t hi[4], lo[4];
      split_tf32(__uint_as_float(p0[ks * 8 + t]), hi[0], lo[0]);
      split_tf32(__uint_as_float(p1[ks * 8 + t]), hi[1], lo[1]);
      split_tf32(__uint_as_float(p0[ks * 8 + t + 4]), hi[2], lo[2]);
      split_tf32(__uint_as_float(p1[ks * 8 + t + 4]), hi[3], lo[3]);
      const uint32_t bh[4] = {b[ks].x, b[ks].y, b[ks].z, b[ks].w};
      const uint32_t bl[4] = {b[2 + ks].x, b[2 + ks].y, b[2 + ks].z,
                              b[2 + ks].w};
      // the cross terms first, into their own accumulator
      mma_tf32(acc.small[0], lo, bh[0], bh[1]);
      mma_tf32(acc.small[0], hi, bl[0], bl[1]);
      mma_tf32(acc.small[1], lo, bh[2], bh[3]);
      mma_tf32(acc.small[1], hi, bl[2], bl[3]);
      mma_tf32(acc.big[0], hi, bh[0], bh[1]);
      mma_tf32(acc.big[1], hi, bh[2], bh[3]);
    }
  }
}

// the lane's B parts of a chunk from shared memory ([part][lane])
template <bool BF16>
__device__ __forceinline__ void load_b(const uint4* parts, int lane,
                                       uint4 (&b)[BParts<BF16>::N]) {
#pragma unroll
  for (int p = 0; p < BParts<BF16>::N; ++p) b[p] = parts[p * 32 + lane];
}

// the accumulator's value: big + small (the cross terms added once)
__device__ __forceinline__ float acc_value(const Acc& acc, int nt, int r) {
  return acc.big[nt][r] + acc.small[nt][r];
}

// conv_out's tail for the lane's two pixels (rows g and g + 8 of the
// m tile, two pixels 8 columns apart in one LR row): tanh, the 16-tap
// apply over the 4x4 LR window, round half to even, clip and pack. Lane
// 4g + t holds weights o = nt * 8 + 2t + j, window taps (row 2 nt + t / 2,
// column 2 (t % 2) + j): a partial sum over those 4 taps per channel,
// summed over the quad by two xor shuffles. The window of pixel g + 8 px,
// tap (row r, column k) is lr[rowoff[r] + c * clamp(col0 + 8 px + k,
// col_lo, col_hi) + channel]: rowoff the offsets (in floats) of the 4
// window rows, clamped by the caller. Lane t = 0 stores pixel g, lane t = 1
// pixel g + 8, where store0 / store1 allow. All lanes of the warp must call
// it (shuffles). NCH < 4 (kernel G's apply probe) sums and packs channels
// below NCH only.
template <int NCH = 4>
__device__ __forceinline__ void apply_store(
    const Acc& acc, const float* lr, const int (&rowoff)[4], int col0,
    int col_lo, int col_hi, int c, int n_ch, bool store0, bool store1,
    uint32_t* out0, uint32_t* out1, int lane) {
  const int t = lane & 3;
  float wt[2][4];
  int idx[2][4];
#pragma unroll
  for (int px = 0; px < 2; ++px) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int nt = k >> 1, j = k & 1;
      wt[px][k] = fast_tanh(acc_value(acc, nt, 2 * px + j));
      const int row = (t >> 1) ? rowoff[2 * nt + 1] : rowoff[2 * nt];
      const int col =
          min(max(col0 + 8 * px + 2 * (t & 1) + j, col_lo), col_hi);
      idx[px][k] = row + col * c;
    }
  }
  // all channels' loads issued together (c <= 4), then the quad sums
  float s[2][4];
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int px = 0; px < 2; ++px) {
      float v = 0.f;
      if (ch < n_ch) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v = fmaf(wt[px][k], lr[idx[px][k] + ch], v);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) v += wt[px][k];
      }
      s[px][ch] = v;
    }
  uint32_t word[2] = {0u, 0u};
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int px = 0; px < 2; ++px) {
      float v = s[px][ch];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (ch >= n_ch) v *= 255.f;
      const int iv = min(max(__float2int_rn(v), 0), 255);
      if (ch < c) word[px] |= (uint32_t)iv << (8 * ch);
    }
  if (t == 0 && store0) *out0 = word[0];
  if (t == 1 && store1) *out1 = word[1];
}

// Kernel G's stage probes: the sum of a pixel's 16 conv_out values (TANH:
// after tanh) for the lane's two pixels, over the quad by two xor shuffles,
// stored as f32 bits where apply_store stores the pixel's word. All lanes
// of the warp must call it (shuffles).
template <bool TANH>
__device__ __forceinline__ void stage_sum_store(const Acc& acc, bool store0,
                                                bool store1, uint32_t* out0,
                                                uint32_t* out1, int lane) {
  const int t = lane & 3;
  float v[2];
#pragma unroll
  for (int px = 0; px < 2; ++px) {
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float x = acc_value(acc, k >> 1, 2 * px + (k & 1));
      sum += TANH ? fast_tanh(x) : x;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    v[px] = sum;
  }
  if (t == 0 && store0) *out0 = __float_as_uint(v[0]);
  if (t == 1 && store1) *out1 = __float_as_uint(v[1]);
}

// 16 bytes global -> shared without registers; src_ok = false fills zeros
// (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool src_ok) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  const int n = src_ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace tail_mma
