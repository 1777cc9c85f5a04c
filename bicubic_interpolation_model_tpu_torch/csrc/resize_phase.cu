// Phase-FMA separable resize at integer scales, for Hopper (sm_90a).
//
// Replaces: bicubic_interpolation_model_tpu/ops/pallas_phase.py
//           _phase_kernel, the Pallas TPU kernel behind resize_phase_pallas.
//
// Computes, for an integer scale s and slot-scattered plan weights (clamps
// folded in, zero weight beyond the image; ops/phase._phase_plan_arrays):
//   tmp[r*s+q][j][ch]     = sum_t wrow[r][q][t] * in[r+t-left][j][ch]
//   out[r*s+q][X*s+p][ch] = sum_m wcol[p][m][X] * tmp[r*s+q][X+m-left][ch]
// each sum in slot order, reading zero outside the image; u8 input is
// stored as clip(trunc(v + 0.5), 0, 255), float input as the f32 value.
// Layouts: interleaved HWC [b][h*s][w*s][c], or column-phase planar
// [b][s][h*s][w*c].
//
// What bounds it on the H100: bytes. A 1080x1920 RGBA frame at 4x reads
// 8.3 MB and writes 132.7 MB (~0.042 ms at 3.35 TB/s) against 1.33 GFLOP of
// f32 multiply-adds (~0.020 ms at 67 TFLOP/s). The design keeps the row
// pass's intermediate in shared memory and spends itself on keeping the
// stores flowing, as kernel C (resize_mxu.cu) does:
// - Persistent blocks (as many as fit on the SMs) walk the tiles of 16 x 32
//   LR pixels (8 x 32 at scales whose 16-row tiles would not fit in shared
//   memory) across the whole batch. The next tile's raw input window
//   (whole aligned words by cp.async, zero outside the image) and its slot
//   weights arrive in shared memory while the current tile computes and
//   stores.
// - Phase groups in both passes. The row pass gives a thread 4 output row
//   phases (q) of one LR row and 4 window elements; the column pass 4
//   column phases (p) of one LR column and 2 output rows. A window element
//   or a tmp pixel is read from shared memory once per 4 outputs, not once
//   per tap per output. The weights come restaged by the host
//   (ops/phase._kernel_weights) in the order a thread reads them:
//   rows [r][phase group][t][4 phases], columns per 32-column tile
//   [phase group][m][X][4 phases], one float4 per slot.
// - Wide stores: the 4 phases of one LR column are s*C consecutive output
//   bytes (16 for RGBA at 4x) and leave as one vector store, consecutive X
//   on consecutive lanes; planar writes one pixel per plane the same way.
//   u8 sums start at 0.5 and are rounded by round_bits/pack4, without
//   float-to-int conversions.
// Offsets are 64-bit; a pixel's value does not depend on its tile, so a
// batch equals its single frames.
//
// Probes (PROBE != FULL, u8 RGBA only, bim_resize_phase_probe): the same
// grid, staging and stores with one stage turned off or replaced, for
// dividing the kernel's time between its stages (scripts/torch_kernel_lab.py;
// the TPU labs are scripts/kernel_lab.py kernel_rowonly, kernel_null and
// kernel_vP). ROWONLY keeps the row pass and stores tmp at each LR column's
// first tap (input column X - left) for all s column phases, with no column
// FMA; NUL skips the row pass and stores each LR pixel over its s x s block
// from the widened window (nearest); CHW is the full kernel with a
// channel-planar store [b][c][h*s][w*s]. The production instances are
// PROBE = FULL, whose code the probes leave as it was.

#include "resize_common.cuh"

namespace {

constexpr int TILE_R = 16;   // LR rows per tile (TILE_R / 2 where those do not fit)
constexpr int TILE_X = 32;   // LR columns per tile
constexpr int PH = 4;        // phases per phase group, both passes
constexpr int ROWS = 2;      // output rows per item in the column pass

// probe instances (see the header); FULL is the production kernel
enum Probe { FULL = 0, ROWONLY = 1, NUL = 2, CHW = 3 };

// shared memory of one block, in bytes; every part starts 16-byte aligned
struct Layout {
  int win_r, win_c, raw_stride, wxc4, pg;
  int wr_floats, wc_floats;   // one tile's row and column weights
  size_t in, tmp, stage, total;
};

__host__ __device__ inline Layout layout(int c, int esize, int s, int taps, int tr) {
  Layout L;
  L.win_r = tr + taps - 1;
  L.win_c = TILE_X + taps - 1;
  L.raw_stride = raw_row_bytes(L.win_c, c, esize);
  L.wxc4 = (L.win_c * c + 3) & ~3;
  L.pg = (s + PH - 1) / PH;
  L.wr_floats = tr * L.pg * taps * PH;
  L.wc_floats = L.pg * taps * TILE_X * PH;
  L.in = (size_t)L.win_r * L.raw_stride;
  L.tmp = L.in + sizeof(float) * L.win_r * L.wxc4;
  L.stage = L.tmp + sizeof(float) * (size_t)tr * s * L.wxc4;
  L.total = L.stage + 2 * sizeof(float) * (size_t)(L.wr_floats + L.wc_floats);
  return L;
}

struct Geometry {
  int b, h, w, s, taps, left, tr, tiles_x, tiles_y;   // tr: LR rows per tile
};

struct Tile {
  int tx, ty;
  size_t b;
};

__device__ inline Tile tile_of(int tile, const Geometry& g) {
  return Tile{tile % g.tiles_x, (tile / g.tiles_x) % g.tiles_y,
              (size_t)(tile / g.tiles_x / g.tiles_y)};
}

__device__ inline Window tile_window(const Tile& t, const Geometry& g, const Layout& L) {
  return window(g.w, t.ty * g.tr - g.left, t.tx * TILE_X - g.left, L.win_r, L.win_c);
}

// Start the async copies of a tile: its raw window into `raw`, its row and
// column weights into `stage`.
template <int C, typename T>
__device__ void issue_tile(int tile, const Geometry& g, const Layout& L, const T* in,
                           const float* wrow, const float* wcol, uint8_t* raw, float* stage) {
  const Tile t = tile_of(tile, g);
  issue_window(in + t.b * (size_t)g.h * g.w * C, g.h, g.w, C, tile_window(t, g, L), raw,
               L.raw_stride);
  const float* gr = wrow + (size_t)t.ty * L.wr_floats;
  const float* gc = wcol + (size_t)t.tx * L.wc_floats;
  const int n_r = L.wr_floats / 4, n = n_r + L.wc_floats / 4;
  for (int e = threadIdx.x; e < n; e += THREADS) {
    if (e < n_r)
      cp_async16(stage + 4 * e, gr + 4 * e);
    else
      cp_async16(stage + 4 * e, gc + 4 * (e - n_r));
  }
  cp_async_commit();
}

template <int C, bool U8, bool PLANAR, int PROBE = FULL>
__global__ void __launch_bounds__(THREADS, 3)
resize_phase_kernel(const typename Elem<U8>::type* __restrict__ in,
                    const float* __restrict__ wrow, const float* __restrict__ wcol,
                    typename Elem<U8>::type* __restrict__ out, Geometry g) {
  using T = typename Elem<U8>::type;
  extern __shared__ uint4 smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem_raw);
  const Layout L = layout(C, sizeof(T), g.s, g.taps, g.tr);
  uint8_t* raw = smem;                                    // [win_r][raw_stride] bytes
  float* s_in = reinterpret_cast<float*>(smem + L.in);    // [win_r][wxc4]
  float* s_tmp = reinterpret_cast<float*>(smem + L.tmp);  // [tr * s][wxc4]
  float* stages = reinterpret_cast<float*>(smem + L.stage);
  const int stage_floats = L.wr_floats + L.wc_floats;

  const int tid = threadIdx.x;
  const int s = g.s, taps = g.taps, pg = L.pg, wxc4 = L.wxc4;
  const int ho = g.h * s, wo = g.w * s;
  const int n_tiles = g.tiles_x * g.tiles_y * g.b;
  const int n4 = wxc4 >> 2;
  int tile = blockIdx.x;
  if (tile < n_tiles) issue_tile<C>(tile, g, L, in, wrow, wcol, raw, stages);
  for (int it = 0; tile < n_tiles; tile += gridDim.x, ++it) {
    const int next = tile + gridDim.x;
    const float* s_wr = stages + (it & 1) * stage_floats;   // [tr][pg][taps][4]
    const float* s_wc = s_wr + L.wr_floats;                  // [pg][taps][TILE_X][4]
    const Tile t = tile_of(tile, g);
    const int j0 = t.tx * TILE_X, r0 = t.ty * g.tr;
    const T* img = in + t.b * (size_t)g.h * g.w * C;
    cp_async_wait_all();
    __syncthreads();
    widen_window(img, g.h, g.w, C, tile_window(t, g, L), raw, L.raw_stride, s_in, wxc4, wxc4);
    __syncthreads();
    // the raw buffer and the other weight stage are free for the next tile
    if (next < n_tiles)
      issue_tile<C>(next, g, L, in, wrow, wcol, raw, stages + ((it + 1) & 1) * stage_floats);

    // row pass: an item is 4 row phases of one LR row x 4 window elements
    if constexpr (PROBE != NUL) {
      for (int e = tid; e < g.tr * pg * n4; e += THREADS) {
        const int j4 = (e % n4) << 2, rest = e / n4;
        const int gq = pg == 1 ? 0 : rest % pg, r = pg == 1 ? rest : rest / pg;
        const float* col = s_in + (size_t)r * wxc4 + j4;
        const float* wv = s_wr + (size_t)(r * pg + gq) * taps * PH;
        float4 acc[PH];
#pragma unroll
        for (int i = 0; i < PH; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int k = 0; k < taps; ++k) {
          const float4 w4 = *reinterpret_cast<const float4*>(wv + k * PH);
          const float4 v = *reinterpret_cast<const float4*>(col + (size_t)k * wxc4);
          const float wk[PH] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int i = 0; i < PH; ++i) {
            acc[i].x = fmaf(wk[i], v.x, acc[i].x);
            acc[i].y = fmaf(wk[i], v.y, acc[i].y);
            acc[i].z = fmaf(wk[i], v.z, acc[i].z);
            acc[i].w = fmaf(wk[i], v.w, acc[i].w);
          }
        }
#pragma unroll
        for (int i = 0; i < PH; ++i) {
          const int q = gq * PH + i;
          if (q < s) *reinterpret_cast<float4*>(s_tmp + (size_t)(r * s + q) * wxc4 + j4) = acc[i];
        }
      }
    }
    __syncthreads();

    // column pass and store: an item is 4 column phases of one LR column x
    // ROWS output rows; consecutive LR columns on consecutive lanes
    const int n_rb = g.tr * s / ROWS;
    for (int e = tid; e < TILE_X * pg * n_rb; e += THREADS) {
      const int xl = e % TILE_X, rest = e / TILE_X;
      const int gp = pg == 1 ? 0 : rest % pg, rb = pg == 1 ? rest : rest / pg;
      const int gx = j0 + xl;
      if (gx >= g.w) continue;
      float acc[ROWS][PH][C];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int i = 0; i < PH; ++i)
#pragma unroll
          for (int ch = 0; ch < C; ++ch) acc[r][i][ch] = U8 ? 0.5f : 0.f;
      const float* tb = s_tmp + (size_t)rb * ROWS * wxc4 + xl * C;
      const float* wv = s_wc + ((size_t)gp * taps * TILE_X + xl) * PH;
      if constexpr (PROBE == ROWONLY || PROBE == NUL) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          // ROWONLY: tmp at window column xl; NUL: the LR pixel itself
          const float* src =
              PROBE == ROWONLY
                  ? tb + (size_t)r * wxc4
                  : s_in + (size_t)((rb * ROWS + r) / s + g.left) * wxc4 + (xl + g.left) * C;
          float v[C];
          load_px<C>(src, v);
#pragma unroll
          for (int i = 0; i < PH; ++i)
#pragma unroll
            for (int ch = 0; ch < C; ++ch) acc[r][i][ch] += v[ch];
        }
      } else {
        for (int m = 0; m < taps; ++m) {
          const float4 w4 = *reinterpret_cast<const float4*>(wv + (size_t)m * TILE_X * PH);
          const float wk[PH] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            float v[C];
            load_px<C>(tb + (size_t)r * wxc4 + m * C, v);
#pragma unroll
            for (int i = 0; i < PH; ++i)
#pragma unroll
              for (int ch = 0; ch < C; ++ch) acc[r][i][ch] = fmaf(wk[i], v[ch], acc[r][i][ch]);
          }
        }
      }
      const int np = min(PH, s - gp * PH);   // phases of this group in the image
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int gr = r0 * s + rb * ROWS + r;
        if (gr >= ho) continue;
        if constexpr (PROBE == CHW) {
          // the group's phases of one LR column in each channel plane: np
          // consecutive bytes per plane
#pragma unroll
          for (int ch = 0; ch < C; ++ch) {
            uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
            for (int i = 0; i < PH; ++i) word[0] |= byte_bits(acc[r][i][ch]) << (8 * i);
            store_bytes(out + ((t.b * C + ch) * ho + gr) * (size_t)wo + (size_t)gx * s + gp * PH,
                        word, np);
          }
        } else if constexpr (PLANAR) {
          // one pixel per plane p, consecutive X on consecutive lanes
#pragma unroll
          for (int i = 0; i < PH; ++i) {
            if (i >= np) break;
            const size_t o = ((t.b * s + gp * PH + i) * (size_t)ho + gr) * ((size_t)g.w * C) +
                             (size_t)gx * C;
            if constexpr (U8) {
              uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
              for (int ch = 0; ch < C; ++ch) word[0] |= byte_bits(acc[r][i][ch]) << (8 * ch);
              store_bytes(out + o, word, C);
            } else {
              float v[16];
#pragma unroll
              for (int ch = 0; ch < C; ++ch) v[ch] = acc[r][i][ch];
              store_floats(out + o, v, C);
            }
          }
        } else {
          // the group's phases of one LR column: np * C consecutive elements
          const size_t o = ((t.b * ho + gr) * (size_t)wo + (size_t)gx * s + gp * PH) * C;
          if constexpr (U8) {
            uint32_t word[4];
            if constexpr (C == 4) {
#pragma unroll
              for (int i = 0; i < PH; ++i) word[i] = pack4(acc[r][i]);
            } else {
#pragma unroll
              for (int k = 0; k < 4; ++k) word[k] = 0u;
#pragma unroll
              for (int i = 0; i < PH; ++i)
#pragma unroll
                for (int ch = 0; ch < C; ++ch)
                  word[(i * C + ch) >> 2] |= byte_bits(acc[r][i][ch]) << (8 * ((i * C + ch) & 3));
            }
            store_bytes(out + o, word, np * C);
          } else {
            float v[16];
#pragma unroll
            for (int i = 0; i < PH; ++i)
#pragma unroll
              for (int ch = 0; ch < C; ++ch) v[i * C + ch] = acc[r][i][ch];
            store_floats(out + o, v, np * C);
          }
        }
      }
    }
  }
}

template <int C, bool U8, bool PLANAR, int PROBE = FULL>
int launch(const void* in, const float* wrow, const float* wcol, void* out, Geometry g,
           cudaStream_t st) {
  using T = typename Elem<U8>::type;
  // 16-row tiles where they fit in shared memory, else 8-row ones
  g.tr = TILE_R;
  if (layout(C, sizeof(T), g.s, g.taps, g.tr).total > SMEM_MAX) g.tr = TILE_R / 2;
  const Layout L = layout(C, sizeof(T), g.s, g.taps, g.tr);
  if (L.total > SMEM_MAX) return -1;
  auto kern = resize_phase_kernel<C, U8, PLANAR, PROBE>;
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
  g.tiles_x = (g.w + TILE_X - 1) / TILE_X;
  g.tiles_y = (g.h + g.tr - 1) / g.tr;
  const long long n_tiles = (long long)g.tiles_x * g.tiles_y * g.b;
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = (int)(n_tiles < (long long)per_sm * sms ? n_tiles : (long long)per_sm * sms);
  kern<<<grid, THREADS, L.total, st>>>(static_cast<const T*>(in), wrow, wcol,
                                       static_cast<T*>(out), g);
  return (int)cudaGetLastError();
}

template <int C>
int launch_c(const void* in, bool u8, bool planar, const float* wrow, const float* wcol, void* out,
             const Geometry& g, cudaStream_t st) {
  if (u8)
    return planar ? launch<C, true, true>(in, wrow, wcol, out, g, st)
                  : launch<C, true, false>(in, wrow, wcol, out, g, st);
  return planar ? launch<C, false, true>(in, wrow, wcol, out, g, st)
                : launch<C, false, false>(in, wrow, wcol, out, g, st);
}

}  // namespace

// in:   [b, h, w, c] u8 (in_u8 != 0) or f32, contiguous, 1 <= c <= 4
// wrow: [ceil(h / 16) * 16, pg, taps, 4] f32, pg = ceil(s / 4): wrow[r][g][t][i]
//       weighs slot t for output row r*s + 4g + i (zero past h and s)
// wcol: [ceil(w / 32), pg, taps, 32, 4] f32: wcol[tx][g][m][x][i] weighs
//       slot m for output column (32 tx + x)*s + 4g + i (zero past w and s)
//       (ops/phase._kernel_weights), both 16-byte aligned
// out:  planar ? [b, s, h*s, w*c] : [b, h*s, w*s, c], the input's kind
//       (u8 -> u8, f32 -> f32)
// Returns cudaGetLastError() after the launch, or -1 when the block's
// shared memory would exceed the card's 227 KB (nothing is launched).
extern "C" int bim_resize_phase(const void* in, int in_u8, const float* wrow, const float* wcol,
                                void* out, int b, int h, int w, int c, int s, int taps, int left,
                                int planar, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool u8 = in_u8 != 0, pl = planar != 0;
  const Geometry g{b, h, w, s, taps, left, 0, 0, 0};
  switch (c) {
    case 1: return launch_c<1>(in, u8, pl, wrow, wcol, out, g, st);
    case 2: return launch_c<2>(in, u8, pl, wrow, wcol, out, g, st);
    case 3: return launch_c<3>(in, u8, pl, wrow, wcol, out, g, st);
    case 4: return launch_c<4>(in, u8, pl, wrow, wcol, out, g, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The probe instances of the header on u8 RGBA frames: in and out as
// bim_resize_phase with in_u8 = 1 and c = 4; probe 1 (ROWONLY) and 2 (NUL)
// in either layout, 3 (CHW) with planar = 0 writes u8 [b, 4, h*s, w*s].
// Returns cudaErrorInvalidValue for another c or probe, else as
// bim_resize_phase.
extern "C" int bim_resize_phase_probe(const void* in, const float* wrow, const float* wcol,
                                      void* out, int b, int h, int w, int c, int s, int taps,
                                      int left, int planar, int probe, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geometry g{b, h, w, s, taps, left, 0, 0, 0};
  if (c != 4) return (int)cudaErrorInvalidValue;
  switch (probe) {
    case ROWONLY:
      return planar ? launch<4, true, true, ROWONLY>(in, wrow, wcol, out, g, st)
                    : launch<4, true, false, ROWONLY>(in, wrow, wcol, out, g, st);
    case NUL:
      return planar ? launch<4, true, true, NUL>(in, wrow, wcol, out, g, st)
                    : launch<4, true, false, NUL>(in, wrow, wcol, out, g, st);
    case CHW:
      if (!planar) return launch<4, true, false, CHW>(in, wrow, wcol, out, g, st);
  }
  return (int)cudaErrorInvalidValue;
}
