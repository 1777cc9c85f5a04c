// Separable plan-driven resize at any scale >= 1, for Hopper (sm_90a).
//
// Replaces: bicubic_interpolation_model_tpu/ops/pallas_mxu.py
//           _mxu_kernel, the Pallas TPU kernel behind resize_mxu.
//
// Computes, from the two axis plans read as bands (ops/mxu._bands: per
// group of 4 consecutive outputs the window [lo, lo + width) of inputs their
// taps reach and the dense weights there, clamped duplicate taps summed),
//   tmp[r][j][ch] = sum_k by[r][k] * in[lo_y(r) + k][j][ch]      (row pass first)
//   out[r][x][ch] = sum_t bx[x][t] * tmp[r][lo_x(x) + t][ch]
// in f32: each output's taps in input order, zeros between them adding
// nothing. u8 input is stored as clip(trunc(v + 0.5), 0, 255), float input
// as the f32 value. Output is interleaved HWC [b][ho][wo][c] for any c in 1..4.
//
// What bounds it on the H100: bytes. A 1080x1920 RGBA frame at 4x reads
// 8.3 MB and writes 132.7 MB (~0.042 ms at 3.35 TB/s) against 1.33 GFLOP of
// f32 multiply-adds (~0.020 ms at 67 TFLOP/s). The TPU form turns both
// passes into banded matrix products with bf16 hi/lo splits because its
// matrix unit is where the rate is; here the taps are few and the card is
// bound by the store, so the kernel runs the taps as f32 FMAs and spends its
// design on keeping the stores flowing:
// - Persistent blocks (as many as fit on the SMs) walk the 32 x 128-pixel
//   output tiles. The next tile's input window (raw bytes, whole 4-byte
//   words, by cp.async; zero-filled past the image) and its bands arrive in
//   shared memory while the current tile computes and stores: for u8 input
//   as soon as the window has been widened to f32, for f32 input once the
//   row pass has read it.
// - The bands make each thread's work a small dense product: the row pass
//   gives a thread 4 output rows x 4 elements from `width` window rows, the
//   column pass 4 output columns x 2 rows from `width` tmp pixels. A tmp
//   pixel is read from shared memory once per 4 outputs instead of once per
//   tap, which was the shared-memory traffic that bounded the first design.
// - Three blocks of 256 threads per SM (at most 85 registers a thread):
//   the phases of one block wait at its barriers while the others run. Two
//   blocks with 4 rows per item (115-123 registers) took 7% longer.
// - The 4 RGBA pixels a thread owns in a row are one 16-byte word: they
//   leave registers as one vector store (a warp writes 512 consecutive
//   bytes) and drain while the block goes on. Rounding: the u8 sums start
//   at 0.5, then a clamp and a round-down add of 2^23 give the byte without
//   float-to-int conversions, which issue at a quarter of the FMA rate.
// Windows come from the plan per tile (row_lo/col_lo), never from the scale,
// so rational scales and nearest's rounding index need nothing special.
// Offsets are 64-bit: a batch of 4320x7680x4 frames passes 2^31 bytes.

#include "resize_common.cuh"

namespace {

constexpr int TILE_R = 32;            // output rows per tile
constexpr int TILE_X = 128;           // output pixels per tile row
constexpr int GROUP = 4;              // outputs per band group, both axes
constexpr int GY = TILE_R / GROUP;    // row groups per tile
constexpr int GX = TILE_X / GROUP;    // column groups per tile
constexpr int ROWS = 2;               // output rows per item, column pass

// shared memory of one block, in bytes; every part starts 16-byte aligned
struct Layout {
  int raw_stride;    // bytes of a raw window row: its bytes + up to 3 before
  int wcc4;          // floats of a widened window row and of a tmp row
  int stage_floats;  // one set of bands: by, bx, lo_y, lo_x
  size_t in, tmp, stage, total;
};

__host__ __device__ inline Layout layout(int c, int esize, bool u8, int ky, int kx, int win_r,
                                         int win_c) {
  Layout L;
  L.raw_stride = (win_c * c * esize + 3 + 15) & ~15;
  L.wcc4 = (win_c * c + 3) & ~3;
  L.stage_floats = GROUP * (GY * ky + GX * kx) + GY + GX;
  L.in = (size_t)win_r * L.raw_stride;
  L.tmp = L.in + (u8 ? sizeof(float) * win_r * L.wcc4 : 0);
  L.stage = L.tmp + sizeof(float) * TILE_R * L.wcc4;
  L.total = L.stage + 2 * sizeof(float) * L.stage_floats;
  return L;
}

struct Geometry {
  int b, h, w, ho, wo, ky, kx, win_r, win_c, tiles_x, tiles_y;
};

// Start the async copies of tile `tile`: its input window (rows row_lo..,
// pixels col_lo.., zero past the image) into `raw` and its bands into
// `stage`. Each raw row holds whole aligned 4-byte words from the one that
// holds the row's first byte, so a u8 row starts (address & 3) bytes in.
template <int C, typename T>
__device__ void issue_tile(int tile, const Geometry& g, const T* in, const float* band_y,
                           const int* lo_y, const int* row_lo, const float* band_x,
                           const int* lo_x, const int* col_lo, uint8_t* raw, float* stage,
                           const Layout& L) {
  const int tid = threadIdx.x;
  const int tx = tile % g.tiles_x, ty = (tile / g.tiles_x) % g.tiles_y;
  const size_t b = tile / g.tiles_x / g.tiles_y;
  const int rlo = row_lo[ty], clo = col_lo[tx];
  const T* img = in + b * (size_t)g.h * g.w * C;
  const long long valid = (long long)max(0, min(g.win_c, g.w - clo)) * C * sizeof(T);
  const int nchunk = L.raw_stride / 4;
  for (int e = tid; e < g.win_r * nchunk; e += THREADS) {
    const int rr = e / nchunk, k = e - rr * nchunk;
    const int gr = rlo + rr;
    const void* src = in;
    int bytes = 0;
    if (gr < g.h) {
      const char* s = reinterpret_cast<const char*>(img + ((size_t)gr * g.w + clo) * C);
      const char* word = reinterpret_cast<const char*>(reinterpret_cast<uintptr_t>(s) & ~(uintptr_t)3) + 4 * k;
      const long long left = (s + valid) - word;
      if (left > 0) {
        bytes = left < 4 ? (int)left : 4;
        src = word;
      }
    }
    cp_async4(raw + (size_t)rr * L.raw_stride + 4 * k, src, bytes);
  }
  // bands, tap-major per tile: by [ky][GY][4], bx [kx][GX][4]
  float* s_by = stage;
  float* s_bx = s_by + GROUP * GY * g.ky;
  int* s_loy = reinterpret_cast<int*>(s_bx + GROUP * GX * g.kx);
  int* s_lox = s_loy + GY;
  const float* gby = band_y + (size_t)ty * GROUP * GY * g.ky;
  const float* gbx = band_x + (size_t)tx * GROUP * GX * g.kx;
  for (int e = tid; e < GY * g.ky + GX * g.kx; e += THREADS) {
    if (e < GY * g.ky)
      cp_async16(s_by + 4 * e, gby + 4 * e);
    else
      cp_async16(s_bx + 4 * (e - GY * g.ky), gbx + 4 * (e - GY * g.ky));
  }
  if (tid < GY / 4) cp_async16(s_loy + 4 * tid, lo_y + (size_t)ty * GY + 4 * tid);
  else if (tid < GY / 4 + GX / 4)
    cp_async16(s_lox + 4 * (tid - GY / 4), lo_x + (size_t)tx * GX + 4 * (tid - GY / 4));
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int C, bool U8>
__global__ void __launch_bounds__(THREADS, 3)
resize_plan_kernel(const typename Elem<U8>::type* __restrict__ in,
                   const float* __restrict__ band_y, const int* __restrict__ lo_y,
                   const int* __restrict__ row_lo, const float* __restrict__ band_x,
                   const int* __restrict__ lo_x, const int* __restrict__ col_lo,
                   typename Elem<U8>::type* __restrict__ out, Geometry g) {
  using T = typename Elem<U8>::type;
  extern __shared__ uint4 smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem_raw);
  const Layout L = layout(C, sizeof(T), U8, g.ky, g.kx, g.win_r, g.win_c);
  uint8_t* raw = smem;                                   // [win_r][raw_stride] bytes
  float* s_in = reinterpret_cast<float*>(smem + L.in);   // u8: [win_r][wcc4] widened
  float* s_tmp = reinterpret_cast<float*>(smem + L.tmp); // [TILE_R][wcc4]
  float* stages = reinterpret_cast<float*>(smem + L.stage);
  // the row pass reads the widened window (u8) or the raw f32 window itself
  const float* src = U8 ? s_in : reinterpret_cast<const float*>(raw);
  const int src_stride = U8 ? L.wcc4 : L.raw_stride / 4;

  const int tid = threadIdx.x;
  const int n_tiles = g.tiles_x * g.tiles_y * g.b;
  const int n4 = L.wcc4 >> 2;
  int tile = blockIdx.x;
  if (tile < n_tiles)
    issue_tile<C>(tile, g, in, band_y, lo_y, row_lo, band_x, lo_x, col_lo, raw, stages, L);
  for (int it = 0; tile < n_tiles; tile += gridDim.x, ++it) {
    const int next = tile + gridDim.x;
    float* st = stages + (it & 1) * L.stage_floats;
    float* st_next = stages + ((it + 1) & 1) * L.stage_floats;
    const float* s_by = st;
    const float* s_bx = s_by + GROUP * GY * g.ky;
    const int* s_loy = reinterpret_cast<const int*>(s_bx + GROUP * GX * g.kx);
    const int* s_lox = s_loy + GY;
    const int tx = tile % g.tiles_x, ty = (tile / g.tiles_x) % g.tiles_y;
    const size_t b = tile / g.tiles_x / g.tiles_y;
    const int x0 = tx * TILE_X, r0 = ty * TILE_R;
    const int rlo = row_lo[ty], clo = col_lo[tx];
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    if (U8) {
      // widen the window to f32 (zero past the image), a warp per row; the
      // raw buffer is then free for the next tile's window
      const uint8_t* img = reinterpret_cast<const uint8_t*>(in) + b * (size_t)g.h * g.w * C;
      const int valid = max(0, min(g.win_c, g.w - clo)) * C;
      for (int rr = tid / 32; rr < g.win_r; rr += THREADS / 32) {
        const int gr = rlo + rr;
        const int n = gr < g.h ? valid : 0;
        const uint8_t* row = raw + (size_t)rr * L.raw_stride +
            (gr < g.h ? (reinterpret_cast<uintptr_t>(img + ((size_t)gr * g.w + clo) * C) & 3) : 0);
        for (int j = tid % 32; j < L.wcc4; j += 32)
          s_in[(size_t)rr * L.wcc4 + j] = j < n ? (float)row[j] : 0.f;
      }
      __syncthreads();
      if (next < n_tiles)
        issue_tile<C>(next, g, in, band_y, lo_y, row_lo, band_x, lo_x, col_lo, raw, st_next, L);
    }

    // row pass: a thread takes 4 output rows (one group) x 4 window elements
    for (int e = tid; e < GY * n4; e += THREADS) {
      const int gy = e / n4, j4 = (e - gy * n4) << 2;
      const float* col = src + (size_t)(s_loy[gy] - rlo) * src_stride + j4;
      float4 acc[GROUP];
#pragma unroll
      for (int i = 0; i < GROUP; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = 0; k < g.ky; ++k) {
        const float4 wv = *reinterpret_cast<const float4*>(s_by + (k * GY + gy) * GROUP);
        const float4 v = *reinterpret_cast<const float4*>(col + (size_t)k * src_stride);
        const float wk[GROUP] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int i = 0; i < GROUP; ++i) {
          acc[i].x = fmaf(wk[i], v.x, acc[i].x);
          acc[i].y = fmaf(wk[i], v.y, acc[i].y);
          acc[i].z = fmaf(wk[i], v.z, acc[i].z);
          acc[i].w = fmaf(wk[i], v.w, acc[i].w);
        }
      }
#pragma unroll
      for (int i = 0; i < GROUP; ++i)
        *reinterpret_cast<float4*>(s_tmp + (size_t)(gy * GROUP + i) * L.wcc4 + j4) = acc[i];
    }
    __syncthreads();
    if (!U8 && next < n_tiles)
      issue_tile<C>(next, g, in, band_y, lo_y, row_lo, band_x, lo_x, col_lo, raw, st_next, L);

    // column pass: an item is 4 output columns (one group) x ROWS rows
    for (int item = tid; item < GX * (TILE_R / ROWS); item += THREADS) {
      const int gx = item % GX, rb = item / GX;
      const float* trow = s_tmp + (size_t)rb * ROWS * L.wcc4 + (s_lox[gx] - clo) * C;
      float acc[ROWS][GROUP][C];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int i = 0; i < GROUP; ++i)
#pragma unroll
          for (int ch = 0; ch < C; ++ch) acc[r][i][ch] = U8 ? 0.5f : 0.f;
      for (int k = 0; k < g.kx; ++k) {
        const float4 wv = *reinterpret_cast<const float4*>(s_bx + (k * GX + gx) * GROUP);
        const float wk[GROUP] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          float v[C];
          load_px<C>(trow + (size_t)r * L.wcc4 + k * C, v);
#pragma unroll
          for (int i = 0; i < GROUP; ++i)
#pragma unroll
            for (int ch = 0; ch < C; ++ch) acc[r][i][ch] = fmaf(wk[i], v[ch], acc[r][i][ch]);
        }
      }
      const int x = x0 + gx * GROUP;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int row = r0 + rb * ROWS + r;
        if (row >= g.ho || x >= g.wo) continue;
        const size_t o = ((b * g.ho + row) * (size_t)g.wo + x) * C;
        if constexpr (U8 && C == 4) {
          if (g.wo % GROUP == 0) {   // 16-byte aligned, and x + 3 < wo
            *reinterpret_cast<uint4*>(out + o) =
                make_uint4(pack4(acc[r][0]), pack4(acc[r][1]), pack4(acc[r][2]), pack4(acc[r][3]));
            continue;
          }
        }
#pragma unroll
        for (int i = 0; i < GROUP; ++i) {
          if (x + i >= g.wo) break;
          if constexpr (U8 && C == 4) {
            *reinterpret_cast<uint32_t*>(out + o + i * C) = pack4(acc[r][i]);
          } else if constexpr (U8) {
#pragma unroll
            for (int ch = 0; ch < C; ++ch) out[o + i * C + ch] = (uint8_t)round_bits(acc[r][i][ch]);
          } else {
#pragma unroll
            for (int ch = 0; ch < C; ++ch) out[o + i * C + ch] = acc[r][i][ch];
          }
        }
      }
    }
  }
}

template <int C, bool U8>
int launch(const void* in, const float* band_y, const int* lo_y, const int* row_lo,
           const float* band_x, const int* lo_x, const int* col_lo, void* out, Geometry g,
           cudaStream_t st) {
  using T = typename Elem<U8>::type;
  const Layout L = layout(C, sizeof(T), U8, g.ky, g.kx, g.win_r, g.win_c);
  if (L.total > SMEM_MAX) return -1;
  auto kern = resize_plan_kernel<C, U8>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, L.total)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  g.tiles_x = (g.wo + TILE_X - 1) / TILE_X;
  g.tiles_y = (g.ho + TILE_R - 1) / TILE_R;
  const long long n_tiles = (long long)g.tiles_x * g.tiles_y * g.b;
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = (int)(n_tiles < (long long)per_sm * sms ? n_tiles : (long long)per_sm * sms);
  kern<<<grid, THREADS, L.total, st>>>(static_cast<const T*>(in), band_y, lo_y, row_lo, band_x,
                                       lo_x, col_lo, static_cast<T*>(out), g);
  return (int)cudaGetLastError();
}

}  // namespace

// in:      [b, h, w, c] u8 (in_u8 != 0) or f32, contiguous, 1 <= c <= 4
// band_y:  f32 [tiles_y, ky, 8, 4]: per tile of 32 output rows, tap-major,
//          the dense weights of its 8 groups of 4 rows (ops/mxu._bands)
// lo_y:    int32 [tiles_y * 8] first input row of each group's window
// row_lo:  int32 [tiles_y] least lo_y of the tile's groups; win_r >= every
//          tile's (greatest lo_y + ky - row_lo)
// band_x, lo_x, col_lo, kx, win_c: the same along x, tiles of 128 outputs
//          (32 groups of 4)
// out:     [b, ho, wo, c], the input's kind (u8 -> u8, f32 -> f32), 16-byte
//          aligned
// Returns cudaGetLastError() after the launch, or -1 when the block's shared
// memory would exceed the card's 227 KB (nothing is launched).
extern "C" int bim_resize_mxu(const void* in, int in_u8, const float* band_y, const int* lo_y,
                              const int* row_lo, const float* band_x, const int* lo_x,
                              const int* col_lo, void* out, int b, int h, int w, int c, int ho,
                              int wo, int ky, int kx, int win_r, int win_c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geometry g{b, h, w, ho, wo, ky, kx, win_r, win_c, 0, 0};
#define BIM_CASE(CH)                                                                      \
  case CH:                                                                                \
    return in_u8 ? launch<CH, true>(in, band_y, lo_y, row_lo, band_x, lo_x, col_lo, out, g, st) \
                 : launch<CH, false>(in, band_y, lo_y, row_lo, band_x, lo_x, col_lo, out, g, st);
  switch (c) {
    BIM_CASE(1)
    BIM_CASE(2)
    BIM_CASE(3)
    BIM_CASE(4)
  }
#undef BIM_CASE
  return (int)cudaErrorInvalidValue;
}
