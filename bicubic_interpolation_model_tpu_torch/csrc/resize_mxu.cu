// Separable plan-driven resize at any scale >= 1, for Hopper (sm_90a).
//
// Replaces: bicubic_interpolation_model_tpu/ops/pallas_mxu.py
//           _mxu_kernel, the Pallas TPU kernel behind resize_mxu.
//
// Computes, from the two axis plans (idx int32 [n_out, K], w f32 [n_out, K];
// clamped taps are already folded in: duplicate indices simply add),
//   tmp[r][j][ch] = sum_k wy[r][k] * in[iy[r][k]][j][ch]      (row pass first)
//   out[r][x][ch] = sum_t wx[x][t] * tmp[r][ix[x][t]][ch]
// in f32; u8 input is stored as clip(trunc(v + 0.5), 0, 255), float input as
// the f32 value. Output is interleaved HWC [b][ho][wo][c] for any c in 1..4.
//
// What bounds it on the H100: bytes. A 1080x1920 RGBA frame at 4x reads
// 8.3 MB and writes 132.7 MB (~0.042 ms at 3.35 TB/s) against 1.33 GFLOP of
// f32 multiply-adds (~0.020 ms at 67 TFLOP/s). The TPU form turns both
// passes into banded matrix products with bf16 hi/lo splits because its
// matrix unit is where the rate is; here the taps are few and the card is
// bound by the store, so the kernel runs the taps as f32 FMAs and spends its
// design on the traffic: one block owns 32 x 128 output pixels, stages the
// input rows and columns its taps reach in shared memory as f32 (the window
// comes from the plan per tile, row_lo/col_lo, never from the scale, so
// rational scales and nearest's rounding index need nothing special), keeps
// the row pass's result in a shared f32 tile, and stores each RGBA pixel as
// one 32-bit word with a warp covering consecutive output bytes. What is
// left after the traffic is instruction issue, so the row pass works on
// float4s and the column pass gives a thread one output column of 8 rows:
// a tap's weight and offset are read once for 8 pixels. Offsets are 64-bit:
// a batch of 4320x7680x4 frames passes 2^31 bytes.

#include "resize_common.cuh"

namespace {

constexpr int TILE_R = 32;    // output rows per block
constexpr int TILE_X = 128;   // output pixels per block row
constexpr int ROWS = 8;       // output rows per thread in the column pass

template <int C, bool U8>
__global__ void __launch_bounds__(THREADS)
resize_plan_kernel(const typename Elem<U8>::type* __restrict__ in,
                   const int* __restrict__ iy, const float* __restrict__ wy,
                   const int* __restrict__ ix, const float* __restrict__ wx,
                   const int* __restrict__ row_lo, const int* __restrict__ col_lo,
                   typename Elem<U8>::type* __restrict__ out,
                   int h, int w, int ho, int wo, int ky, int kx, int win_r, int win_c) {
  using T = typename Elem<U8>::type;
  extern __shared__ uint4 smem_raw[];
  const int wcc = win_c * C;          // window row length, elements
  const int wcc4 = (wcc + 3) & ~3;    // padded to whole float4s
  float* s_in = reinterpret_cast<float*>(smem_raw);
  float* s_tmp = s_in + (size_t)win_r * wcc4;
  float* s_wy = s_tmp + (size_t)TILE_R * wcc4;
  float* s_wx = s_wy + TILE_R * ky;
  int* s_iy = reinterpret_cast<int*>(s_wx + kx * TILE_X);
  int* s_ix = s_iy + TILE_R * ky;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int x0 = blockIdx.x * TILE_X;
  const int r0 = blockIdx.y * TILE_R;
  const size_t b = blockIdx.z;
  const int rlo = row_lo[blockIdx.y];
  const int clo = col_lo[blockIdx.x];

  // 1. stage the input window this tile's taps reach as f32 (a warp per
  // window row; zero beyond the image), and the tile's plans with their
  // indices turned into shared-memory offsets
  const T* img = in + b * (size_t)h * w * C;
  for (int rr = warp; rr < win_r; rr += THREADS / 32) {
    const int gr = rlo + rr;
    const T* src = img + ((size_t)gr * w + clo) * C;
    const int valid = gr < h ? min(wcc, (w - clo) * C) : 0;
    for (int jc = lane; jc < wcc4; jc += 32)
      s_in[rr * wcc4 + jc] = jc < valid ? (float)src[jc] : 0.f;
  }
  for (int e = tid; e < TILE_R * ky; e += THREADS) {
    const bool ok = r0 + e / ky < ho;
    s_wy[e] = ok ? wy[(size_t)r0 * ky + e] : 0.f;
    s_iy[e] = ok ? (iy[(size_t)r0 * ky + e] - rlo) * wcc4 : 0;
  }
  // column plan transposed to [t][x]: a warp's reads in the column pass
  // then fall on consecutive banks
  for (int e = tid; e < kx * TILE_X; e += THREADS) {
    const int t = e / TILE_X, xl = e - t * TILE_X;
    const int x = x0 + xl;
    const bool ok = x < wo;
    s_wx[e] = ok ? wx[(size_t)x * kx + t] : 0.f;
    s_ix[e] = ok ? (ix[(size_t)x * kx + t] - clo) * C : 0;
  }
  __syncthreads();

  // 2. row pass over the window's columns, four elements per thread
  const int n4 = wcc4 >> 2;
  for (int e = tid; e < TILE_R * n4; e += THREADS) {
    const int tr = e / n4, j4 = (e - tr * n4) << 2;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < ky; ++k) {
      const float wv = s_wy[tr * ky + k];
      const float4 v = *reinterpret_cast<const float4*>(s_in + s_iy[tr * ky + k] + j4);
      acc.x = fmaf(wv, v.x, acc.x);
      acc.y = fmaf(wv, v.y, acc.y);
      acc.z = fmaf(wv, v.z, acc.z);
      acc.w = fmaf(wv, v.w, acc.w);
    }
    *reinterpret_cast<float4*>(s_tmp + tr * wcc4 + j4) = acc;
  }
  __syncthreads();

  // 3. column pass and store: a thread owns one output column of ROWS
  // consecutive rows, so each tap's weight and offset are read once for
  // ROWS pixels and the sums stay in registers
  for (int e = tid; e < TILE_X * (TILE_R / ROWS); e += THREADS) {
    const int xl = e % TILE_X, g = e / TILE_X;
    const int x = x0 + xl;
    if (x >= wo) continue;
    float acc[ROWS][C];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int ch = 0; ch < C; ++ch) acc[r][ch] = 0.f;
    const float* tbase = s_tmp + (size_t)g * ROWS * wcc4;
    for (int t = 0; t < kx; ++t) {
      const float wv = s_wx[t * TILE_X + xl];
      const float* px = tbase + s_ix[t * TILE_X + xl];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float v[C];
        load_px<C>(px + r * wcc4, v);
#pragma unroll
        for (int ch = 0; ch < C; ++ch) acc[r][ch] = fmaf(wv, v[ch], acc[r][ch]);
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int row = r0 + g * ROWS + r;
      if (row < ho) store_px<C, U8>(out, ((b * ho + row) * (size_t)wo + x) * C, acc[r]);
    }
  }
}

size_t smem_bytes(int c, int ky, int kx, int win_r, int win_c) {
  const size_t wcc4 = ((size_t)win_c * c + 3) & ~(size_t)3;
  return sizeof(float) * ((size_t)win_r + TILE_R) * wcc4 +
         (sizeof(float) + sizeof(int)) * ((size_t)TILE_R * ky + (size_t)kx * TILE_X);
}

template <int C, bool U8>
int launch(const void* in, const int* iy, const float* wy, const int* ix, const float* wx,
           const int* row_lo, const int* col_lo, void* out, int b, int h, int w, int ho, int wo,
           int ky, int kx, int win_r, int win_c, cudaStream_t st) {
  using T = typename Elem<U8>::type;
  const size_t smem = smem_bytes(C, ky, kx, win_r, win_c);
  if (smem > SMEM_MAX) return -1;
  auto kern = resize_plan_kernel<C, U8>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((wo + TILE_X - 1) / TILE_X, (ho + TILE_R - 1) / TILE_R, b);
  kern<<<grid, THREADS, smem, st>>>(static_cast<const T*>(in), iy, wy, ix, wx, row_lo, col_lo,
                                    static_cast<T*>(out), h, w, ho, wo, ky, kx, win_r, win_c);
  return (int)cudaGetLastError();
}

}  // namespace

// in:      [b, h, w, c] u8 (in_u8 != 0) or f32, contiguous, 1 <= c <= 4
// iy, wy:  [ho, ky] row plan (int32 indices in [0, h), f32 weights)
// ix, wx:  [wo, kx] column plan
// row_lo:  [ceil(ho / 32)] least input row any tap of the tile's rows reads;
//          win_r >= every tile's (greatest - least + 1)
// col_lo:  [ceil(wo / 128)], win_c: the same along x
// out:     [b, ho, wo, c], the input's kind (u8 -> u8, f32 -> f32), 4-byte
//          aligned
// Returns cudaGetLastError() after the launch, or -1 when the block's shared
// memory would exceed the card's 227 KB (nothing is launched).
extern "C" int bim_resize_mxu(const void* in, int in_u8, const int* iy, const float* wy,
                              const int* ix, const float* wx, const int* row_lo,
                              const int* col_lo, void* out, int b, int h, int w, int c, int ho,
                              int wo, int ky, int kx, int win_r, int win_c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BIM_CASE(CH)                                                                            \
  case CH:                                                                                      \
    return in_u8 ? launch<CH, true>(in, iy, wy, ix, wx, row_lo, col_lo, out, b, h, w, ho, wo,   \
                                    ky, kx, win_r, win_c, st)                                   \
                 : launch<CH, false>(in, iy, wy, ix, wx, row_lo, col_lo, out, b, h, w, ho, wo,  \
                                     ky, kx, win_r, win_c, st);
  switch (c) {
    BIM_CASE(1)
    BIM_CASE(2)
    BIM_CASE(3)
    BIM_CASE(4)
  }
#undef BIM_CASE
  return (int)cudaErrorInvalidValue;
}
