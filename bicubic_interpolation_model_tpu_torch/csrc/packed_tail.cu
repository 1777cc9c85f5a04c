// Fused packed tail of the WeightPredictor forward, for Hopper (sm_90a).
//
// Replaces: bicubic_interpolation_model_tpu/ops/pallas_packed_tail.py
//           _fused_kernel (with the shared body _tail_body), the Pallas TPU
//           kernel behind packed_tail_fused.
//
// Computes, per LR pixel of a frame, from the conv_in/conv_res features
// y [h, w, 32] and the LR pixels lr [h, w, c] (f32, 0..255):
//   merged map   up = y @ kup + ubias (the 16 up-lanes of each of the 16
//                output phases), att = sigmoid(up @ att_w + att_b[0]), up
//                gated by att; the 16 offset lanes of a phase are the
//                per-phase constant offs; rows/cols outside the image zero;
//   conv_out     the phase-decomposed 3x3 conv (9 taps x 32 in x 16 out per
//                output phase) + bias, tanh;
//   apply        the 16-tap sum over the edge-clamped 4x4 LR window;
//   deliver      round half to even, clip to [0, 255], channels packed
//                little-endian into one u32 (bytes >= c zero) in the planar
//                layout out[b][q][Y*4 + p][X] (column phase q planar, row
//                phase p interleaved). opaque_alpha (c = 4): alpha =
//                rint(255 * sum(w)).
//
// What bounds it on the H100: by count, the products. At the 348x510 frame
// the kernel reads ~25 MB and writes ~11 MB (~11 us at 3.35 TB/s); its
// products are 16.0 GFLOP (upsample 2.91, conv_out over the 16 gated
// up-lanes 13.09), which on the f32 route run as 3xTF32 on the tensor
// cores (3 x 16.0 GFLOP at 495 TFLOP/s, ~0.097 ms) and on the bf16 route
// as one bf16 pass (~0.016 ms at 989); attention, tanh and the apply (0.5
// GFLOP) stay on the f32 CUDA cores (~0.007 ms at 67 TFLOP/s).
//
// Design: a persistent, software-pipelined loop over tiles (tail_mma.cuh
// holds the MMA core and the epilogue it shares with kernel G; mma.sync,
// not wgmma).
// - The grid is min(tiles, SMs) blocks of 16 warps, the SM count read
//   from the device. tile_grid() alone decides it: the launch takes it, and
//   bim_packed_tail_fused_grid reports it to the wrapper's counters. The
//   tiles (6x16 LR pixels) of all frames of the batch are numbered frame
//   by frame, row by row, and block i walks tiles i, i + grid, i + 2 grid,
//   ... A tile's bytes do not depend on the block that computes it (every
//   pixel's sums run in the same order).
// - Once per block, while the first tile's inputs arrive: conv_out's
//   offset lanes folded with the per-phase constants (they are an in-image
//   flag times a per-phase constant, so their share is a 16-vector per
//   (tap, phase): offc = offs @ kout[tap][16:32], added into the
//   accumulator's initial value as valid(src) x offc), conv_out's B
//   fragments of all 9 taps (split hi/lo on the f32 route) and its bias in
//   shared memory, and each warp's upsample bias and attention vector in
//   registers. The warp's upsample B fragments are made again each tile
//   from kup, which stays in L1 (32 KB): live across conv_out they push the
//   f32 instance past its 128 registers into spills, and it ran slower.
// - Per tile: (1) wait for the tile's inputs and one barrier (the previous
//   tile's conv_out has then left the merged map); (2) upsample on the
//   tensor cores: warp = phase block (16 lanes), M = the 144 haloed pixels
//   (8x18) in 9 m tiles, K = 32 features, N = 16 (tail_mma::mma_chunk);
//   its epilogue adds ubias, takes the attention dot as a quad
//   reduction (two xor shuffles), the sigmoid once per lane pair, the gate,
//   and writes the gated up-lanes to the merged map (f32, or bf16 pairs on
//   the bf16 route), zero for pixels outside the image, with the pixel's
//   in-image flag; one barrier; (3) the features are dead, so the next
//   tile's haloed features (zeros outside the image) and its edge-clamped
//   LR window are started by cp.async into the features buffer and the
//   other of two LR windows; they land while (4) conv_out runs on the
//   tensor cores: warp = output phase (p, q), one m tile per LR tile row
//   (16 pixels), GROUP m tiles per pass (2 on the f32 route, the most that
//   fit its registers, 3 on the bf16 route) so that each tap's B fragments
//   are read once per pass, K = 9 taps x 16 gated up-lanes of the source
//   pixel's phase block (rows gathered from the map), N = 16; a
//   tile whose haloed pixels all lie in the image skips the flag loads;
//   then tanh, apply, round and pack (tail_mma::apply_store4 at c = 4: one
//   16-byte load per tap, the quad sums halved, the rounding by one
//   addition). The 1-pixel halo (1.5 m rows per output row) is recomputed:
//   cheaper than a second pass or a neighbour exchange, and a walk down
//   column strips that kept the previous tile's last two map rows ran no
//   faster.
// - Shared memory in 32-bit words (f32 route / bf16 route): the merged map
//   144 x 260 / 132 (4 mod 32, so that a fragment load of 8 rows x 4 words
//   hits 32 banks; the in-image flag in its padding) = 37,440 / 19,008;
//   the features 144 x 36 / 20 = 5,184 / 2,880; conv_out's B fragments
//   4,608 / 1,152; offc 2,304; bias 16; two LR windows 2 x 9 x 20 x 4 =
//   1,440 (pitch 20 pixels, so that a quarter warp's 16-byte loads hit
//   distinct banks). 203,968 B (f32) or 107,200 B (bf16): one block of 512
//   threads per SM. An 8x16 tile would need 247,872 B on the f32 route,
//   over the 232,448 B a block may use. One stage of prefetch is enough: a
//   whole conv_out lies between the copies' start and the wait, also on the
//   bf16 route, whose smaller layout would leave room for more.
//
// What bounds it now: the tensor-core products of the f32 route as
// mma.sync runs them. Cutting conv_out's products from the kernel saves
// 0.48 of its 1.09 ms at 540x960 (some 0.47 m16n8k8 a clock per SM, about
// half of the card's TF32 rate, which only wgmma reaches); the apply takes
// ~0.15 ms and the upsample's products ~0.15 ms, and they overlap the
// products little. Measured on an H100 80GB HBM3 at 700 W (device time a
// launch): 0.41 ms f32 and 0.25 ms bf16 features at 348x510 RGBA, 1.11 and
// 0.66 ms at 540x960 RGBA (PERF.md, section 6, row 1).
//
// bf16 mode (y in bf16): the features, kup, att_w, offs and kout arrive
// rounded to bf16 (the wrapper rounds the parameters); the kernel rounds the
// merged-map stages where the TPU kernel casts them (the pre-gate map before
// the attention dot, att before the gate, the gated map before conv_out)
// and accumulates in f32, as the MXU does.

#include "tail_mma.cuh"

namespace {

using namespace tail_mma;

constexpr int S = 4;                  // scale
constexpr int F_IN = 32;              // conv feature width
constexpr int NW = 16;                // predicted weights (up-lanes per phase)
constexpr int TWOF = 2 * NW;          // merged channels per phase
constexpr int PH = S * S;             // output phases per LR pixel
constexpr int UPN = PH * NW;          // 256 up-lanes per LR pixel
constexpr int TH = 6, TW = 16;        // LR tile (one m tile per tile row)
constexpr int HH = TH + 2, HW = TW + 2;
constexpr int NPIX = HH * HW;         // 144 haloed tile pixels
constexpr int MTILES = NPIX / 16;     // 9 m tiles, no padding rows
static_assert(NPIX % 16 == 0, "the upsample's m tiles cover the pixels");
constexpr int WARPS = 16;             // = phase blocks = output phases
constexpr int THREADS = 32 * WARPS;
constexpr int OFFC_N = 9 * PH * NW;   // folded offset lanes per (tap, phase)
constexpr int LRW = TW + 3;           // LR window columns of the tile
// LR window row pitch in pixels: at 20 (4 mod 8 16-byte units) the two
// rows of a quarter warp's 16-byte loads in apply_store4 fall on distinct
// banks
constexpr int LRS = 20;
constexpr int LR_N = (TH + 3) * LRS * 4;   // LR window, up to 4 channels

// shared-memory layout in 32-bit words
template <bool BF16>
struct Layout {
  static constexpr int MAP_W = BF16 ? UPN / 2 : UPN;   // map words per pixel
  static constexpr int MSTRIDE = MAP_W + 4;            // flag at MAP_W
  static constexpr int CHUNK_W = BF16 ? 8 : 16;        // words per 16 lanes
  static constexpr int YSTRIDE = (BF16 ? F_IN / 2 : F_IN) + 4;
  static constexpr int KF_W = 9 * BParts<BF16>::N * 32 * 4;
  static constexpr int MAP_N = NPIX * MSTRIDE;
  static constexpr int Y_N = NPIX * YSTRIDE;
  // conv_out m tiles (tile rows) a pass: the most that fit the registers
  // without spilling (3 on the f32 route spills)
  static constexpr int GROUP = BF16 ? 3 : 2;
  static_assert(TH % GROUP == 0, "conv_out passes must cover the tile rows");
  static constexpr size_t BYTES =
      (size_t)(MAP_N + Y_N + KF_W + OFFC_N + NW + 2 * LR_N) * 4;
  static_assert(BYTES <= 232448, "tile does not fit shared memory");
  static_assert(MSTRIDE % 8 == 4 && YSTRIDE % 8 == 4,
                "fragment rows must fall on distinct banks");
  static_assert(MAP_N % 4 == 0 && Y_N % 4 == 0 && KF_W % 4 == 0 &&
                    (OFFC_N + NW) % 4 == 0 && LR_N % 4 == 0,
                "16-byte stages and LR pixels");
};

template <bool BF16>
__device__ __forceinline__ float rq(float v) {
  if constexpr (BF16) {
    return round_bf16(v);
  } else {
    return v;
  }
}

// a tile's frame and LR origin; tiles are numbered frame by frame, row by
// row
struct Tile {
  int b, y0, x0;
};

__device__ __forceinline__ Tile tile_at(int tile, int per_frame,
                                        int tiles_x) {
  const int b = tile / per_frame, r = tile - b * per_frame;
  const int ty = r / tiles_x;
  return {b, ty * TH, (r - ty * tiles_x) * TW};
}

// Starts a tile's input copies as one cp.async group: the haloed features
// into ys (zeros outside the image) and the edge-clamped LR window (rows
// y0-1 .. y0+TH+1) into lrw.
template <int YSTRIDE, typename YT>
__device__ __forceinline__ void load_tile(const YT* __restrict__ y,
                                          const float* __restrict__ lr,
                                          Tile tl, int h, int w, int c,
                                          uint32_t* ys, float* lrw, int tid) {
  constexpr int PER16 = 16 / sizeof(YT);                // features per 16 B
  constexpr int CHUNKS = F_IN / PER16;
  const YT* yb = y + (size_t)tl.b * h * w * F_IN;
  for (int idx = tid; idx < NPIX * CHUNKS; idx += THREADS) {
    const int pix = idx / CHUNKS, k = idx % CHUNKS;
    const int gy = tl.y0 - 1 + pix / HW, gx = tl.x0 - 1 + pix % HW;
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
    const YT* src = in ? yb + ((size_t)gy * w + gx) * F_IN + k * PER16 : y;
    cp_async16(ys + pix * YSTRIDE + 4 * k, src, in);
  }
  const float* lb = lr + (size_t)tl.b * h * w * c;
  const int row_n = LRW * c;
  for (int idx = tid; idx < (TH + 3) * row_n; idx += THREADS) {
    const int r = idx / row_n, k = idx - r * row_n;
    const int gy = min(max(tl.y0 - 1 + r, 0), h - 1);
    const int gx = min(max(tl.x0 - 1 + k / c, 0), w - 1);
    cp_async4(lrw + r * LRS * c + k, lb + ((size_t)gy * w + gx) * c + k % c);
  }
  cp_async_commit();
}

template <bool BF16, typename YT>
__global__ void __launch_bounds__(THREADS, 1)
packed_tail_fused_kernel(const YT* __restrict__ y, const float* __restrict__ lr,
                         const float* __restrict__ kout,
                         const float* __restrict__ bout,
                         const float* __restrict__ kup,
                         const float* __restrict__ ubias,
                         const float* __restrict__ offs,
                         const float* __restrict__ att_w,
                         const float* __restrict__ att_b,
                         uint32_t* __restrict__ out, int batch, int h, int w,
                         int c, int opaque_alpha) {
  using L = Layout<BF16>;
  constexpr int BP = BParts<BF16>::N;
  extern __shared__ uint4 smem4[];
  uint32_t* map = reinterpret_cast<uint32_t*>(smem4);   // [NPIX][MSTRIDE]
  uint32_t* ys = map + L::MAP_N;                         // [NPIX][YSTRIDE]
  uint4* kf = reinterpret_cast<uint4*>(ys + L::Y_N);     // [9][BP][32]
  float* offc = reinterpret_cast<float*>(ys + L::Y_N + L::KF_W);
  float* bs = offc + OFFC_N;                             // [NW]
  float* lrs = bs + NW;                  // [2][TH+3][LRS][c], edge-clamped

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tiles_x = (w + TW - 1) / TW;
  const int per_frame = tiles_x * ((h + TH - 1) / TH);
  const int tiles = batch * per_frame;
  int tile = blockIdx.x;

  // 1. the first tile's inputs in flight while the block builds what every
  //    tile shares: the offset lanes folded with the per-phase constants
  //    (offc[tap][ph] = offs[ph] @ kout[tap][16:32]), conv_out's bias and
  //    B fragments (its up-lane rows kout[tap][0:16]) in shared memory, and
  //    this warp's upsample B fragments (kup[0:32][warp*16 : +16], two
  //    K = 16 chunks), bias and attention vector in registers
  load_tile<L::YSTRIDE>(y, lr, tile_at(tile, per_frame, tiles_x), h, w, c,
                        ys, lrs, tid);
  for (int idx = tid; idx < OFFC_N; idx += THREADS) {
    const int tap = idx / (PH * NW), ph = (idx / NW) % PH, o = idx % NW;
    const float* kr = kout + (tap * TWOF + NW) * NW + o;
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < NW; ++i)
      v = fmaf(__ldg(offs + ph * NW + i), __ldg(kr + i * NW), v);
    offc[idx] = v;
  }
  if (tid < NW) bs[tid] = __ldg(bout + tid);
  for (int idx = tid; idx < 9 * 32; idx += THREADS) {
    const int tap = idx / 32, l = idx % 32;
    store_b<BF16>(kout + tap * TWOF * NW, NW, l, kf + tap * BP * 32);
  }
  float ub[2][2], aw[2][2];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      ub[nt][j] = __ldg(ubias + nt * 8 + 2 * t + j);
      aw[nt][j] = __ldg(att_w + nt * 8 + 2 * t + j);
    }
  const float ab = __ldg(att_b);
  const int blk = warp;                  // the upsample's phase block
  const int pp = warp >> 2, q = warp & 3;   // conv_out's output phase
  const int n_ch = (opaque_alpha && c == 4) ? 3 : c;

  for (int k = 0; tile < tiles; tile += gridDim.x, ++k) {
    const Tile tl = tile_at(tile, per_frame, tiles_x);
    const float* lrc = lrs + (k & 1) * LR_N;
    // 2. this tile's inputs have landed (started a whole conv_out ago), and
    //    the previous tile's conv_out has left the map
    cp_async_wait_all();
    __syncthreads();

    // 3. upsample + attention + gate on the tensor cores, phase block `blk`;
    //    its B fragments from the L1-resident kup (live across conv_out
    //    they would spill)
    uint4 bu[2][BP];
#pragma unroll
    for (int kc = 0; kc < 2; ++kc)
      make_b<BF16>(kup + kc * 16 * UPN + blk * NW, UPN, lane, bu[kc]);
    for (int mt = 0; mt < MTILES; ++mt) {
      Acc acc = {};
      const uint32_t* y0p = ys + (mt * 16 + g) * L::YSTRIDE;
#pragma unroll
      for (int kc = 0; kc < 2; ++kc)
        mma_chunk<BF16>(acc, y0p + kc * L::CHUNK_W,
                        y0p + 8 * L::YSTRIDE + kc * L::CHUNK_W, bu[kc], lane);
      float u[2][2][2], a[2];
#pragma unroll
      for (int px = 0; px < 2; ++px) {
        a[px] = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            u[px][nt][j] = acc_value(acc, nt, 2 * px + j) + ub[nt][j];
            a[px] = fmaf(rq<BF16>(u[px][nt][j]), aw[nt][j], a[px]);
          }
        a[px] += __shfl_xor_sync(0xffffffffu, a[px], 1);
        a[px] += __shfl_xor_sync(0xffffffffu, a[px], 2);
      }
      // the quad holds both pixels' sums: lanes t = 0, 2 take pixel g's
      // gate, lanes t = 1, 3 pixel g + 8's, and swap them
      const float mine =
          rq<BF16>(1.f / (1.f + expf(-((t & 1 ? a[1] : a[0]) + ab))));
      const float att2[2] = {__shfl_sync(0xffffffffu, mine, lane & ~1),
                             __shfl_sync(0xffffffffu, mine, lane | 1)};
#pragma unroll
      for (int px = 0; px < 2; ++px) {
        const float att = att2[px];
        const int pix = mt * 16 + g + 8 * px;
        const int gy = tl.y0 - 1 + pix / HW, gx = tl.x0 - 1 + pix % HW;
        const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
        uint32_t* mp = map + pix * L::MSTRIDE;
        if (blk == 0 && t == 0)
          mp[L::MAP_W] = __float_as_uint(in ? 1.f : 0.f);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float v0 = in ? rq<BF16>(u[px][nt][0] * att) : 0.f;
          const float v1 = in ? rq<BF16>(u[px][nt][1] * att) : 0.f;
          const int lane_o = blk * NW + nt * 8 + 2 * t;   // even up-lane
          if constexpr (BF16) {
            mp[lane_o / 2] = pack_bf16(v0, v1);
          } else {
            mp[lane_o] = __float_as_uint(v0);
            mp[lane_o + 1] = __float_as_uint(v1);
          }
        }
      }
    }
    __syncthreads();

    // 4. the features are dead: the next tile's features and LR window
    //    load while this tile's conv_out and apply run
    const int next = tile + gridDim.x;
    if (next < tiles)
      load_tile<L::YSTRIDE>(y, lr, tile_at(next, per_frame, tiles_x), h, w,
                            c, ys, lrs + ((k + 1) & 1) * LR_N, tid);

    // 5. conv_out + tanh + 16-tap apply, output phase (pp, q) = warp, one
    //    tile row (16 pixels) per m tile, GROUP m tiles per pass so that
    //    each tap's B fragments are read from shared memory once per pass
    uint32_t* outb = out + (size_t)tl.b * S * (h * S) * w;
    // every haloed pixel in the image: each in-image flag is 1
    const bool inner = tl.y0 >= 1 && tl.y0 + TH < h && tl.x0 >= 1 &&
                       tl.x0 + TW < w;
    constexpr int GROUP = L::GROUP;
    for (int ty0 = 0; ty0 < TH && tl.y0 + ty0 < h; ty0 += GROUP) {
      Acc acc[GROUP];
#pragma unroll
      for (int i = 0; i < GROUP; ++i)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            acc[i].big[nt][r] = bs[nt * 8 + 2 * t + (r & 1)];
            acc[i].small[nt][r] = 0.f;
          }
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy) {
        const int pr = pp + dy;
        const int p2 = (pr + S) % S, sy = pr < 0 ? -1 : (pr >= S ? 1 : 0);
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
          const int qc = q + dx;
          const int q2 = (qc + S) % S, sx = qc < 0 ? -1 : (qc >= S ? 1 : 0);
          const int tap = (dy + 1) * 3 + dx + 1;
          uint4 b[BP];
          load_b<BF16>(kf + tap * BP * 32, lane, b);
          // the offset lanes: zero outside the image, else the folded
          // constant
          const float* oc = offc + (tap * PH + p2 * S + q2) * NW + 2 * t;
          const float o[2][2] = {{oc[0], oc[1]}, {oc[8], oc[9]}};
          const int off = (p2 * S + q2) * L::CHUNK_W;
#pragma unroll
          for (int i = 0; i < GROUP; ++i) {
            const int pix0 = (ty0 + i + 1 + sy) * HW + (g + 1 + sx);
            const uint32_t* m0 = map + pix0 * L::MSTRIDE;
            const uint32_t* m1 = m0 + 8 * L::MSTRIDE;
            float v0 = 1.f, v1 = 1.f;
            if (!inner) {
              v0 = __uint_as_float(m0[L::MAP_W]);
              v1 = __uint_as_float(m1[L::MAP_W]);
            }
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                acc[i].big[nt][j] = fmaf(v0, o[nt][j], acc[i].big[nt][j]);
                acc[i].big[nt][2 + j] =
                    fmaf(v1, o[nt][j], acc[i].big[nt][2 + j]);
              }
            mma_chunk<BF16>(acc[i], m0 + off, m1 + off, b, lane);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < GROUP; ++i) {
        const int gy = tl.y0 + ty0 + i;
        if (gy >= h) break;
        int rowoff[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) rowoff[r] = (ty0 + i + r) * LRS * c;
        const int gx0 = tl.x0 + g;
        uint32_t* orow =
            outb + ((size_t)q * (h * S) + (size_t)gy * S + pp) * w;
        if (c == 4)
          apply_store4(acc[i], lrc, rowoff, g, n_ch, gx0 < w, gx0 + 8 < w,
                       orow + gx0, orow + gx0 + 8, lane);
        else
          apply_store(acc[i], lrc, rowoff, g, 0, LRW - 1, c, n_ch, gx0 < w,
                      gx0 + 8 < w, orow + gx0, orow + gx0 + 8, lane);
      }
    }
  }
}

// the launch's grid on the current device: the batch's tiles and the
// persistent blocks that walk them, one per SM, or one per tile where there
// are fewer
cudaError_t tile_grid(int batch, int h, int w, long long* tiles, int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *tiles = (long long)batch * ((h + TH - 1) / TH) * ((w + TW - 1) / TW);
  *blocks = (int)(*tiles < sms ? *tiles : sms);
  return cudaSuccess;
}

template <bool BF16, typename YT>
int launch(const void* y, const float* lr, const float* kout, const float* bout,
           const float* kup, const float* ubias, const float* offs,
           const float* att_w, const float* att_b, uint32_t* out, int batch,
           int h, int w, int c, int opaque_alpha, cudaStream_t stream) {
  auto kern = packed_tail_fused_kernel<BF16, YT>;
  constexpr size_t bytes = Layout<BF16>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  long long tiles = 0;
  int blocks = 0;
  err = tile_grid(batch, h, w, &tiles, &blocks);
  if (err != cudaSuccess) return (int)err;
  kern<<<blocks, THREADS, bytes, stream>>>(
      static_cast<const YT*>(y), lr, kout, bout, kup, ubias, offs, att_w, att_b,
      out, batch, h, w, c, opaque_alpha);
  return (int)cudaGetLastError();
}

}  // namespace

// y: [batch, h, w, 32] f32 (y_bf16 = 0) or bf16 (y_bf16 = 1), contiguous,
// 16-byte aligned. lr: [batch, h, w, c] f32. kout: [3, 3, 32, 16]. bout:
// [16]. kup: [32, 256] upsample kernel, lane = phase * 16 + o. ubias: [16].
// offs: [16, 16] per-phase offset constants. att_w: [16]. att_b: [1]
// (all f32; bf16-rounded values where y is bf16). out: [batch, 4, 4h, w]
// u32. Returns cudaGetLastError() after the launch.
extern "C" int bim_packed_tail_fused(const void* y, int y_bf16, const float* lr,
                                     const float* kout, const float* bout,
                                     const float* kup, const float* ubias,
                                     const float* offs, const float* att_w,
                                     const float* att_b, uint32_t* out,
                                     int batch, int h, int w, int c,
                                     int opaque_alpha, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (y_bf16)
    return launch<true, __nv_bfloat16>(y, lr, kout, bout, kup, ubias, offs,
                                       att_w, att_b, out, batch, h, w, c,
                                       opaque_alpha, st);
  return launch<false, float>(y, lr, kout, bout, kup, ubias, offs, att_w,
                              att_b, out, batch, h, w, c, opaque_alpha, st);
}

// The grid a bim_packed_tail_fused call of this batch and frame size
// launches on the current device: the batch's tiles and the blocks. Returns
// a cudaError_t (0 on success).
extern "C" int bim_packed_tail_fused_grid(int batch, int h, int w,
                                          long long* tiles, int* blocks) {
  return (int)tile_grid(batch, h, w, tiles, blocks);
}
