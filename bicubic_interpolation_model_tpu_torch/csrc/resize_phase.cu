// Phase-FMA separable resize at integer scales, for Hopper (sm_90a).
//
// Replaces: bicubic_interpolation_model_tpu/ops/pallas_phase.py
//           _phase_kernel, the Pallas TPU kernel behind resize_phase_pallas.
//
// Computes, for an integer scale s and slot-scattered plan weights (clamps
// folded in, zero weight beyond the image; ops/phase._phase_plan_arrays):
//   tmp[r*s+q][j][ch]     = sum_t wrow[r*s+q][t] * in[r+t-left][j][ch]
//   out[r*s+q][X*s+p][ch] = sum_m wcol[p*T+m][X] * tmp[r*s+q][X+m-left][ch]
// reading zero outside the image; u8 input is stored as
// clip(trunc(v + 0.5), 0, 255), float input as the f32 value.
// Layouts: interleaved HWC [b][h*s][w*s][c], or column-phase planar
// [b][s][h*s][w*c].
//
// What bounds it on the H100: bytes. A 1080x1920 RGBA frame at 4x reads
// 8.3 MB and writes 132.7 MB (~0.042 ms at 3.35 TB/s) against 1.33 GFLOP of
// f32 multiply-adds (~0.020 ms at 67 TFLOP/s). The design keeps the row
// pass's intermediate out of device memory: one block owns 8 x 32 LR pixels,
// stages their zero-padded input window in shared memory as f32, runs the
// row pass into a shared f32 tile at output-row resolution (float4s), then
// the column pass from that tile with one output column of 8 rows per
// thread (a slot's weight is read once for 8 pixels; what is left after the
// traffic is instruction issue), and stores each RGBA pixel as one 32-bit
// word with a warp covering consecutive output bytes. Extents, scale and tap
// count are run-time arguments: ragged edges are masked, nothing is padded
// to a tile grid. The planar layout exists for callers of the JAX form; on
// this card the interleaved layout costs the same.

#include "resize_common.cuh"

namespace {

constexpr int TILE_R = 8;    // LR rows per block
constexpr int TILE_X = 32;   // LR columns per block
constexpr int ROWS = 8;      // output rows per thread in the column pass

template <int C, bool U8, bool PLANAR>
__global__ void __launch_bounds__(THREADS)
resize_phase_kernel(const typename Elem<U8>::type* __restrict__ in,
                    const float* __restrict__ wrow,
                    const float* __restrict__ wcol,
                    typename Elem<U8>::type* __restrict__ out,
                    int h, int w, int s, int taps, int left) {
  using T = typename Elem<U8>::type;
  extern __shared__ uint4 smem_raw[];
  const int wr = TILE_R + taps - 1;         // window rows
  const int wxc = (TILE_X + taps - 1) * C;  // window row length, elements
  const int wxc4 = (wxc + 3) & ~3;          // padded to whole float4s
  const int rows_o = TILE_R * s;            // output rows of the tile
  const int cols_o = TILE_X * s;            // output pixels per tile row
  float* s_in = reinterpret_cast<float*>(smem_raw);
  float* s_tmp = s_in + (size_t)wr * wxc4;
  float* s_wr = s_tmp + (size_t)rows_o * wxc4;
  float* s_wc = s_wr + rows_o * taps;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int j0 = blockIdx.x * TILE_X;
  const int r0 = blockIdx.y * TILE_R;
  const size_t b = blockIdx.z;
  const int ho = h * s;

  // 1. stage the input window as f32 (a warp per window row; zero outside
  // the image) and the weights
  const T* img = in + b * (size_t)h * w * C;
  const int jlo = (j0 - left) * C;          // first window element of a row
  for (int rr = warp; rr < wr; rr += THREADS / 32) {
    const int gr = r0 + rr - left;
    const bool row_ok = gr >= 0 && gr < h;
    const T* src = img + (size_t)(row_ok ? gr : 0) * w * C;
    for (int jc = lane; jc < wxc4; jc += 32) {
      const int gj = jlo + jc;
      s_in[rr * wxc4 + jc] =
          row_ok && jc < wxc && gj >= 0 && gj < w * C ? (float)src[gj] : 0.f;
    }
  }
  for (int e = tid; e < rows_o * taps; e += THREADS) {
    const int orow = r0 * s + e / taps;
    s_wr[e] = orow < ho ? wrow[(size_t)r0 * s * taps + e] : 0.f;
  }
  // column weights in the order the column pass walks the tile's pixels
  for (int e = tid; e < taps * cols_o; e += THREADS) {
    const int m = e / cols_o, xo = e - m * cols_o;
    const int xl = PLANAR ? xo % TILE_X : xo / s;
    const int p = PLANAR ? xo / TILE_X : xo % s;
    const int gx = j0 + xl;
    s_wc[e] = gx < w ? wcol[(size_t)(p * taps + m) * w + gx] : 0.f;
  }
  __syncthreads();

  // 2. row pass at output-row resolution, four elements per thread
  const int n4 = wxc4 >> 2;
  for (int e = tid; e < rows_o * n4; e += THREADS) {
    const int orow = e / n4, j4 = (e - orow * n4) << 2;
    const float* col = s_in + (orow / s) * wxc4 + j4;
    const float* wv = s_wr + orow * taps;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int t = 0; t < taps; ++t) {
      const float wt = wv[t];
      const float4 v = *reinterpret_cast<const float4*>(col + t * wxc4);
      acc.x = fmaf(wt, v.x, acc.x);
      acc.y = fmaf(wt, v.y, acc.y);
      acc.z = fmaf(wt, v.z, acc.z);
      acc.w = fmaf(wt, v.w, acc.w);
    }
    *reinterpret_cast<float4*>(s_tmp + (size_t)orow * wxc4 + j4) = acc;
  }
  __syncthreads();

  // 3. column pass and store: a thread owns one output column of ROWS
  // consecutive rows (rows_o = 8 * s is a multiple of ROWS), so each slot's
  // weight is read once for ROWS pixels and the sums stay in registers
  for (int e = tid; e < cols_o * (rows_o / ROWS); e += THREADS) {
    const int g = e / cols_o, xo = e - g * cols_o;
    const int xl = PLANAR ? xo % TILE_X : xo / s;
    const int p = PLANAR ? xo / TILE_X : xo % s;
    const int gx = j0 + xl;
    if (gx >= w) continue;
    float acc[ROWS][C];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int ch = 0; ch < C; ++ch) acc[r][ch] = 0.f;
    const float* tbase = s_tmp + (size_t)g * ROWS * wxc4 + xl * C;
    for (int m = 0; m < taps; ++m) {
      const float wv = s_wc[m * cols_o + xo];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float v[C];
        load_px<C>(tbase + r * wxc4 + m * C, v);
#pragma unroll
        for (int ch = 0; ch < C; ++ch) acc[r][ch] = fmaf(wv, v[ch], acc[r][ch]);
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int gr = r0 * s + g * ROWS + r;
      if (gr >= ho) continue;
      size_t o;
      if (PLANAR)
        o = ((b * s + p) * (size_t)ho + gr) * ((size_t)w * C) + (size_t)gx * C;
      else
        o = ((b * ho + gr) * ((size_t)w * s) + (size_t)gx * s + p) * C;
      store_px<C, U8>(out, o, acc[r]);
    }
  }
}

size_t smem_bytes(int s, int taps, int c) {
  const size_t wr = TILE_R + taps - 1;
  const size_t wxc4 = ((size_t)(TILE_X + taps - 1) * c + 3) & ~(size_t)3;
  return sizeof(float) * ((wr + (size_t)TILE_R * s) * wxc4 + (size_t)TILE_R * s * taps +
                          (size_t)taps * TILE_X * s);
}

template <int C, bool U8, bool PLANAR>
int launch(const void* in, const float* wrow, const float* wcol, void* out, int b, int h, int w,
           int s, int taps, int left, cudaStream_t st) {
  using T = typename Elem<U8>::type;
  const size_t smem = smem_bytes(s, taps, C);
  if (smem > SMEM_MAX) return -1;
  auto kern = resize_phase_kernel<C, U8, PLANAR>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((w + TILE_X - 1) / TILE_X, (h + TILE_R - 1) / TILE_R, b);
  kern<<<grid, THREADS, smem, st>>>(static_cast<const T*>(in), wrow, wcol, static_cast<T*>(out), h,
                                    w, s, taps, left);
  return (int)cudaGetLastError();
}

template <int C>
int launch_c(const void* in, bool u8, bool planar, const float* wrow, const float* wcol, void* out,
             int b, int h, int w, int s, int taps, int left, cudaStream_t st) {
  if (u8)
    return planar ? launch<C, true, true>(in, wrow, wcol, out, b, h, w, s, taps, left, st)
                  : launch<C, true, false>(in, wrow, wcol, out, b, h, w, s, taps, left, st);
  return planar ? launch<C, false, true>(in, wrow, wcol, out, b, h, w, s, taps, left, st)
                : launch<C, false, false>(in, wrow, wcol, out, b, h, w, s, taps, left, st);
}

}  // namespace

// in:   [b, h, w, c] u8 (in_u8 != 0) or f32, contiguous, 1 <= c <= 4
// wrow: [h*s, taps] f32;  wcol: [s*taps, w] f32
// out:  planar ? [b, s, h*s, w*c] : [b, h*s, w*s, c], the input's kind
//       (u8 -> u8, f32 -> f32), 4-byte aligned
// Returns cudaGetLastError() after the launch, or -1 when the block's
// shared memory would exceed the card's 227 KB (nothing is launched).
extern "C" int bim_resize_phase(const void* in, int in_u8, const float* wrow, const float* wcol,
                                void* out, int b, int h, int w, int c, int s, int taps, int left,
                                int planar, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool u8 = in_u8 != 0, pl = planar != 0;
  switch (c) {
    case 1: return launch_c<1>(in, u8, pl, wrow, wcol, out, b, h, w, s, taps, left, st);
    case 2: return launch_c<2>(in, u8, pl, wrow, wcol, out, b, h, w, s, taps, left, st);
    case 3: return launch_c<3>(in, u8, pl, wrow, wcol, out, b, h, w, s, taps, left, st);
    case 4: return launch_c<4>(in, u8, pl, wrow, wcol, out, b, h, w, s, taps, left, st);
  }
  return (int)cudaErrorInvalidValue;
}
