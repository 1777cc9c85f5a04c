// Banded-matrix separable resize at integer scales, for Hopper (sm_90a).
//
// Replaces: bicubic_interpolation_model_tpu/ops/pallas_resize.py
//           _resize_kernel, the Pallas TPU kernel behind resize_pallas.
//
// Computes, per channel plane and output tile (i, j) of th x tw pixels,
//   out_tile = B_row[i] [th x kh]  @  window [kh x kw]  @  B_colT[j] [kw x tw]
// where the window is the input at rows i*step_h - left .. + kh and columns
// j*step_w - left .. + kw (zero outside the image) and the bands are dense
// slices of the two sampling matrices (ops/banded._banded: clamped duplicate
// taps accumulate on one column, padding carries zero weight). u8 input is
// stored as clip(floor(v + 0.5), 0, 255), float input as the f32 value.
// Input and output are interleaved HWC with any channel count.
//
// What bounds it on the H100: as a function, bytes (a 1080x1920 RGBA frame
// at 4x moves 141 MB, ~0.042 ms at 3.35 TB/s). The function is two small
// dense matrix products per tile, which the TPU kernel runs on its matrix
// unit; here they run on the tensor cores:
// - A block computes all channels of a tile. The row product takes the
//   interleaved channels as its N dimension (B_row[i] [th x kh] @ window
//   [kh x kw*C]). The column product runs per channel and transposed,
//   out^T = B_colT[j]^T @ tmp^T: M = 16 output columns, whose split
//   weights a warp holds in registers across its row tiles, N = 8 output
//   rows, the intermediate gathered at stride C as the B operand. A lane's
//   accumulators then hold all channels of four pixels: RGBA output leaves
//   as words, 8 lanes covering 32 contiguous bytes of a row.
// - mma.sync.m16n8k8 in TF32 (tail_mma.cuh), as 3xTF32: hi*hi in one
//   accumulator, the cross terms in another, added once at the end. One
//   TF32 pass would round the intermediate far beyond the u8 contract. The
//   split rounds to nearest (x = hi + lo, hi = x rounded to TF32, lo = the
//   rest rounded the same way; an add and a mask each), not by truncation
//   as kernels A and G do: truncation biases every term toward zero, and
//   the edge weights' exact half-way sums (renormalised weights such as
//   9/13) then round down where f32 rounds up, at 2e-3 of the bytes of
//   small frames (CPU emulation, tests/test_torch_banded.py) against the
//   1e-3 that the card tests allow. u8 windows are exact in TF32 (their lo
//   is zero), so the row product takes two passes, not three; the
//   intermediate is split once, when the row product stores it.
// - The bands are zero outside a diagonal strip. The host computes, beside
//   the bands, the first and last k8 block that holds a non-zero weight for
//   each 16-row slab of B_row[i] and each 16-column slab of B_colT[j]
//   (ops/banded._block_ranges: per 16-column slab, the M of the transposed
//   product); the kernel contracts only those blocks. A
//   skipped block adds exact zeros. At 4x bicubic this leaves about a third
//   of the dense products.
// - Persistent blocks each walk one run of tiles, row tile fastest within
//   a column of tiles: B_colT[j] is split into hi/lo fragments in shared
//   memory once per column of tiles (only the k8 blocks each slab uses).
//   The next tile's raw window (whole aligned words by cp.async, zero
//   outside the image) and its B_row[i] arrive while the current tile
//   computes and stores.
// Offsets are 64-bit; a pixel's value does not depend on its block, so a
// batch equals its single frames.

#include "resize_common.cuh"
#include "tail_mma.cuh"

namespace {

using tail_mma::mma_tf32;
using tail_mma::TF32_MASK;

// x rounded to the nearest TF32 value (ties away from zero), as f32 bits
__device__ __forceinline__ uint32_t tf32_rn(float x) {
  return (__float_as_uint(x) + 0x1000u) & TF32_MASK;
}

// x = hi + lo, each rounded to the nearest TF32 value
__device__ __forceinline__ void split_rn(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rn(x);
  lo = tf32_rn(x - __uint_as_float(hi));
}

__host__ __device__ inline size_t round16(size_t x) { return (x + 15) & ~(size_t)15; }

struct Geometry {
  int b, h, w, c, ho, wo, n_i, n_j, th, tw, kh, kw, step_h, step_w, left, kbc;
};

// shared memory of one block, in bytes
struct Layout {
  int n, ws, s2, brs, m_rows, raw_stride;
  size_t bc, tmp, win, stage, raw, total;
};

__host__ __device__ inline Layout layout(const Geometry& g, int esize) {
  Layout L;
  L.n = g.kw * g.c;                          // N of the row product
  L.ws = L.n + ((8 - L.n % 32) + 32) % 32;   // window row: = 8 (mod 32) floats
  L.s2 = L.n + ((1 - L.n % 16) + 16) % 16;   // intermediate row: = 1 (mod 16) (hi, lo) pairs
  L.brs = g.kh + 4;                          // B_row row: = 4 (mod 8) floats
  L.m_rows = (g.th + 15) & ~15;              // rows in whole m16 slabs
  L.raw_stride = raw_row_bytes(g.kw, g.c, esize);
  L.bc = 0;                                  // [tw/16][kbc][hi, lo][32 lanes] uint4
  L.tmp = L.bc + (size_t)(g.tw / 8) * g.kbc * 32 * sizeof(uint4);
  L.win = L.tmp + round16((size_t)L.m_rows * L.s2 * sizeof(uint2));
  L.stage = L.win + sizeof(float) * (size_t)g.kh * L.ws;
  L.raw = L.stage + 2 * sizeof(float) * (size_t)L.m_rows * L.brs;
  L.total = L.raw + (size_t)g.kh * L.raw_stride;
  return L;
}

struct Tile {
  int i, j;
  size_t b;
};

// tiles in order: row tile fastest, then frame, then column tile
__device__ inline Tile tile_of(int t, const Geometry& g) {
  const int u = t / g.n_i;
  return Tile{t - u * g.n_i, u / g.b, (size_t)(u % g.b)};
}

__device__ inline Window tile_window(const Tile& t, const Geometry& g) {
  return window(g.w, t.i * g.step_h - g.left, t.j * g.step_w - g.left, g.kh, g.kw);
}

// Start the async copies of a tile: its raw window and B_row[i] (rows of kh
// floats into rows of brs).
template <typename T>
__device__ void issue_tile(int tile, const Geometry& g, const Layout& L, const T* in,
                           const float* brow, uint8_t* raw, float* stage) {
  const Tile t = tile_of(tile, g);
  issue_window(in + t.b * (size_t)g.h * g.w * g.c, g.h, g.w, g.c, tile_window(t, g), raw,
               L.raw_stride);
  const float* src = brow + (size_t)t.i * g.th * g.kh;
  const int per_row = g.kh / 4;
  for (int e = threadIdx.x; e < g.th * per_row; e += THREADS) {
    const int r = e / per_row, k4 = e - r * per_row;
    cp_async16(stage + (size_t)r * L.brs + 4 * k4, src + (size_t)r * g.kh + 4 * k4);
  }
  cp_async_commit();
}

// B_colT[j]'s fragments as the A operand of the transposed column product,
// split: per 16-column slab ms and each k8 block of its range, the lane's
// hi and lo parts of W[m][k] = B_colT[j][k][16 ms + m] at (g, t), (g + 8,
// t), (g, t + 4), (g + 8, t + 4)
__device__ void stage_bcol(int j, const Geometry& g, const float* bcolt, const int2* kcol,
                           uint4* s_bc) {
  const int n_ms = g.tw / 16;
  const float* bc = bcolt + (size_t)j * g.kw * g.tw;
  for (int e = threadIdx.x; e < n_ms * g.kbc * 32; e += THREADS) {
    const int lane = e & 31, slot = e >> 5;
    const int ms = slot / g.kbc, q = slot - ms * g.kbc;
    const int2 r = kcol[(size_t)j * n_ms + ms];
    const int kb = r.x + q;
    uint4 hi = make_uint4(0u, 0u, 0u, 0u), lo = hi;
    if (kb < r.y) {
      const int gg = lane >> 2, tt = lane & 3;
      const float* p = bc + (size_t)(kb * 8 + tt) * g.tw + ms * 16 + gg;
      split_rn(__ldg(p), hi.x, lo.x);
      split_rn(__ldg(p + 8), hi.y, lo.y);
      split_rn(__ldg(p + 4 * (size_t)g.tw), hi.z, lo.z);
      split_rn(__ldg(p + 4 * (size_t)g.tw + 8), hi.w, lo.w);
    }
    s_bc[(size_t)slot * 64 + lane] = hi;
    s_bc[(size_t)slot * 64 + 32 + lane] = lo;
  }
}

// The lane's A fragments of k8 block kb of B_row's 16-row slab ms, split
__device__ __forceinline__ void load_a(const float* s_br, int brs, int ms, int kb, int gg, int tt,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float* a = s_br + (size_t)(ms * 16 + gg) * brs + kb * 8 + tt;
  split_rn(a[0], hi[0], lo[0]);
  split_rn(a[8 * brs], hi[1], lo[1]);
  split_rn(a[4], hi[2], lo[2]);
  split_rn(a[8 * brs + 4], hi[3], lo[3]);
}

// One k8 block of the row product: the window's B fragments at bw (row
// t of the block, column g of the n8 tile), 3xTF32 (2 passes for u8:
// integers 0..255 are exact in TF32, their lo part is zero)
template <bool U8>
__device__ __forceinline__ void row_step(float (&big)[4], float (&small)[4], const uint32_t (&ahi)[4],
                                         const uint32_t (&alo)[4], const float* bw, int ws) {
  if constexpr (U8) {
    const uint32_t b0 = __float_as_uint(bw[0]), b1 = __float_as_uint(bw[4 * ws]);
    mma_tf32(small, alo, b0, b1);
    mma_tf32(big, ahi, b0, b1);
  } else {
    uint32_t bh0, bl0, bh1, bl1;
    split_rn(bw[0], bh0, bl0);
    split_rn(bw[4 * ws], bh1, bl1);
    mma_tf32(small, alo, bh0, bh1);
    mma_tf32(small, ahi, bl0, bl1);
    mma_tf32(big, ahi, bh0, bh1);
  }
}

// One k8 block of the transposed column product for the channels
// c0 .. c0 + nc - 1 of a pixel: the weights' A fragments (whi, wlo), the
// intermediate's B fragments at b (row g of the n8 tile, window column t
// of the block, channel c0; (hi, lo) pairs, stride c per column). The
// channels' independent products in turn, the two cross terms of one
// channel four products apart.
__device__ __forceinline__ void col_step(float (&big)[4][4], float (&small)[4][4],
                                         const uint4& whi, const uint4& wlo, const uint2* b,
                                         int c, int nc) {
  const uint32_t ah[4] = {whi.x, whi.y, whi.z, whi.w};
  const uint32_t al[4] = {wlo.x, wlo.y, wlo.z, wlo.w};
  uint2 p0[4], p1[4];
#pragma unroll
  for (int ch = 0; ch < 4; ++ch)
    if (ch < nc) {
      p0[ch] = b[ch];
      p1[ch] = b[4 * c + ch];
    }
#pragma unroll
  for (int ch = 0; ch < 4; ++ch)
    if (ch < nc) mma_tf32(small[ch], al, p0[ch].x, p1[ch].x);
#pragma unroll
  for (int ch = 0; ch < 4; ++ch)
    if (ch < nc) mma_tf32(big[ch], ah, p0[ch].x, p1[ch].x);
#pragma unroll
  for (int ch = 0; ch < 4; ++ch)
    if (ch < nc) mma_tf32(small[ch], ah, p0[ch].y, p1[ch].y);
}

template <int CT, bool U8>
__global__ void __launch_bounds__(THREADS, 2)
resize_banded_kernel(const typename Elem<U8>::type* __restrict__ in,
                     const float* __restrict__ brow, const float* __restrict__ bcolt,
                     const int2* __restrict__ krow, const int2* __restrict__ kcol,
                     typename Elem<U8>::type* __restrict__ out, Geometry g) {
  using T = typename Elem<U8>::type;
  extern __shared__ uint4 smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem_raw);
  const Layout L = layout(g, sizeof(T));
  uint4* s_bc = reinterpret_cast<uint4*>(smem + L.bc);
  uint2* s_tmp = reinterpret_cast<uint2*>(smem + L.tmp);   // [m_rows][s2] (hi, lo)
  float* s_win = reinterpret_cast<float*>(smem + L.win);   // [kh][ws]
  float* stages = reinterpret_cast<float*>(smem + L.stage); // 2 x [m_rows][brs]
  uint8_t* raw = smem + L.raw;                             // [kh][raw_stride] bytes
  const int C = CT ? CT : g.c;
  const int stage_floats = L.m_rows * L.brs;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gg = lane >> 2, tt = lane & 3;
  const int n_ms = L.m_rows / 16, n_ntr = L.n / 8;   // row product
  const int n_msc = g.tw / 16, n_ntc = g.th / 8;       // column product
  const long long n_tiles = (long long)g.n_i * g.n_j * g.b;   // < 2^31 (launch)
  const int first = (int)(blockIdx.x * n_tiles / gridDim.x);
  const int last = (int)((blockIdx.x + 1) * n_tiles / gridDim.x);

  // B_row rows past th stay zero: the copies never write them
  for (int e = tid; e < 2 * (L.m_rows - g.th) * L.brs; e += THREADS) {
    const int half = e / ((L.m_rows - g.th) * L.brs);
    stages[half * stage_floats + g.th * L.brs + e % ((L.m_rows - g.th) * L.brs)] = 0.f;
  }
  if (first < last) issue_tile(first, g, L, in, brow, raw, stages);
  int cur_j = -1;
  for (int tile = first; tile < last; ++tile) {
    const int it = tile - first;
    const float* s_br = stages + (it & 1) * stage_floats;
    const Tile t = tile_of(tile, g);
    cp_async_wait_all();
    __syncthreads();
    if (t.j != cur_j) {
      stage_bcol(t.j, g, bcolt, kcol, s_bc);
      cur_j = t.j;
    }
    widen_window(in + t.b * (size_t)g.h * g.w * g.c, g.h, g.w, g.c, tile_window(t, g), raw,
                 L.raw_stride, s_win, L.ws, L.ws);
    __syncthreads();
    // the raw buffer and the other B_row stage are free for the next tile
    if (tile + 1 < last)
      issue_tile(tile + 1, g, L, in, brow, raw, stages + ((it + 1) & 1) * stage_floats);

    // row product: tmp = B_row[i] @ window, an m16 x n8 tile per warp step,
    // over the k8 blocks of the slab's range; a warp keeps its slab's split
    // B_row fragments of the first two blocks (all that bands of up to 8
    // taps have) across its n8 tiles; tmp is stored split
    int held = -1;
    int2 kr = make_int2(0, 0);
    uint32_t ahi[2][4], alo[2][4];
    for (int u = warp; u < n_ms * n_ntr; u += THREADS / 32) {
      const int ms = u % n_ms, nt = u / n_ms;
      if (ms != held) {
        held = ms;
        kr = krow[(size_t)t.i * n_ms + ms];
#pragma unroll
        for (int q = 0; q < 2; ++q)
          if (kr.x + q < kr.y) load_a(s_br, L.brs, ms, kr.x + q, gg, tt, ahi[q], alo[q]);
      }
      float big[4] = {0.f, 0.f, 0.f, 0.f}, small[4] = {0.f, 0.f, 0.f, 0.f};
      const float* bw = s_win + (size_t)tt * L.ws + nt * 8 + gg;
      if (kr.x < kr.y) row_step<U8>(big, small, ahi[0], alo[0], bw + (size_t)kr.x * 8 * L.ws, L.ws);
      if (kr.x + 1 < kr.y)
        row_step<U8>(big, small, ahi[1], alo[1], bw + (size_t)(kr.x + 1) * 8 * L.ws, L.ws);
      for (int kb = kr.x + 2; kb < kr.y; ++kb) {
        uint32_t h[4], l[4];
        load_a(s_br, L.brs, ms, kb, gg, tt, h, l);
        row_step<U8>(big, small, h, l, bw + (size_t)kb * 8 * L.ws, L.ws);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = ms * 16 + gg + (r >> 1) * 8, col = nt * 8 + 2 * tt + (r & 1);
        uint2 v;
        split_rn(big[r] + small[r], v.x, v.y);
        s_tmp[(size_t)row * L.s2 + col] = v;
      }
    }
    __syncthreads();

    // column product and store, transposed: per channel out^T = B_colT[j]^T
    // @ tmp^T, a warp step one m16 (output columns) x n8 (output rows) tile
    // of every channel over the k8 blocks of the column slab's range; a
    // warp keeps its slab's weight fragments of the first two blocks
    int held_c = -1;
    int2 kc = make_int2(0, 0);
    uint4 whi[2], wlo[2];
    for (int u = warp; u < n_msc * n_ntc; u += THREADS / 32) {
      const int ms = u % n_msc, nt = u / n_msc;
      const uint4* wf = s_bc + (size_t)ms * g.kbc * 64 + lane;
      if (ms != held_c) {
        held_c = ms;
        kc = kcol[(size_t)t.j * n_msc + ms];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          whi[q] = wf[q * 64];
          wlo[q] = wf[q * 64 + 32];
        }
      }
      const uint2* tb = s_tmp + (size_t)(nt * 8 + gg) * L.s2 + tt * C;
      for (int c0 = 0; c0 < C; c0 += 4) {
        const int nc = min(4, C - c0);
        float big[4][4], small[4][4];
#pragma unroll
        for (int ch = 0; ch < 4; ++ch)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            big[ch][r] = U8 ? 0.5f : 0.f;
            small[ch][r] = 0.f;
          }
        if (kc.x < kc.y) col_step(big, small, whi[0], wlo[0], tb + kc.x * 8 * C + c0, C, nc);
        if (kc.x + 1 < kc.y)
          col_step(big, small, whi[1], wlo[1], tb + (kc.x + 1) * 8 * C + c0, C, nc);
        for (int kb = kc.x + 2; kb < kc.y; ++kb)
          col_step(big, small, wf[(kb - kc.x) * 64], wf[(kb - kc.x) * 64 + 32],
                   tb + kb * 8 * C + c0, C, nc);
        // the lane's pixels: rows 2 tt and 2 tt + 1 of the n8 tile, columns
        // gg and gg + 8 of the slab
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int lr = nt * 8 + 2 * tt + (r & 1);
          const int row = t.i * g.th + lr;
          const int x = t.j * g.tw + ms * 16 + gg + 8 * (r >> 1);
          if (lr >= g.th || row >= g.ho || x >= g.wo) continue;
          const size_t o = ((t.b * g.ho + row) * (size_t)g.wo + x) * C + c0;
          float v[4];
#pragma unroll
          for (int ch = 0; ch < 4; ++ch) v[ch] = big[ch][r] + small[ch][r];
          if constexpr (U8 && CT == 4) {
            *reinterpret_cast<uint32_t*>(out + o) = pack4(v);
          } else if constexpr (CT == 4) {
            *reinterpret_cast<float4*>(out + o) = make_float4(v[0], v[1], v[2], v[3]);
          } else {
#pragma unroll
            for (int ch = 0; ch < 4; ++ch) {
              if (ch >= nc) break;
              if constexpr (U8)
                out[o + ch] = (uint8_t)byte_bits(v[ch]);
              else
                out[o + ch] = v[ch];
            }
          }
        }
      }
    }
  }
}

template <int CT, bool U8>
int launch(const void* in, const float* brow, const float* bcolt, const int2* krow,
           const int2* kcol, void* out, const Geometry& g, cudaStream_t st) {
  using T = typename Elem<U8>::type;
  const Layout L = layout(g, sizeof(T));
  if (L.total > SMEM_MAX) return -1;
  auto kern = resize_banded_kernel<CT, U8>;
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
  const long long n_tiles = (long long)g.n_i * g.n_j * g.b;
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = (int)(n_tiles < (long long)per_sm * sms ? n_tiles : (long long)per_sm * sms);
  kern<<<grid, THREADS, L.total, st>>>(static_cast<const T*>(in), brow, bcolt, krow, kcol,
                                       static_cast<T*>(out), g);
  return (int)cudaGetLastError();
}

}  // namespace

// in:    [b, h, w, c] u8 (in_u8 != 0) or f32, contiguous
// brow:  [n_i, th, kh] f32;  bcolt: [n_j, kw, tw] f32, 16-byte aligned
//        (th a multiple of 8 and of s, tw of 16 and of s, kh and kw of 8)
// krow:  int32 [n_i, ceil(th / 16), 2]: per 16-row slab of B_row[i] the
//        first k8 block with a non-zero weight and one past the last
// kcol:  int32 [n_j, tw / 16, 2]: the same per 16-column slab of B_colT[j];
//        kbc >= 1 the longest of these ranges (ops/banded._block_ranges)
// out:   [b, ho, wo, c], the input's kind (u8 -> u8, f32 -> f32)
// Returns cudaGetLastError() after the launch, -1 when the block's shared
// memory would exceed the card's 227 KB, or cudaErrorInvalidValue for tile
// sizes the kernel does not take (nothing is launched).
extern "C" int bim_resize_banded(const void* in, int in_u8, const float* brow, const float* bcolt,
                                 const int* krow, const int* kcol, void* out, int b, int h, int w,
                                 int c, int ho, int wo, int n_i, int n_j, int th, int tw, int kh,
                                 int kw, int s, int left, int kbc, void* stream) {
  if (s < 1 || c < 1 || kbc < 1 || th % 8 || th % s || tw % 16 || tw % s || kh % 8 || kw % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geometry g{b, h, w, c, ho, wo, n_i, n_j, th, tw, kh, kw, th / s, tw / s, left, kbc};
  const int2* kr = reinterpret_cast<const int2*>(krow);
  const int2* kc = reinterpret_cast<const int2*>(kcol);
  if (c == 4)
    return in_u8 ? launch<4, true>(in, brow, bcolt, kr, kc, out, g, st)
                 : launch<4, false>(in, brow, bcolt, kr, kc, out, g, st);
  return in_u8 ? launch<0, true>(in, brow, bcolt, kr, kc, out, g, st)
               : launch<0, false>(in, brow, bcolt, kr, kc, out, g, st);
}
