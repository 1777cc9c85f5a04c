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
// GFLOP) stay on the f32 CUDA cores (~0.007 ms at 67 TFLOP/s). As
// measured, the kernel takes ~5x that bound, and with bf16 features (a
// sixth of the tensor-core time) ~70% of its f32 time: what holds it now
// is the latency of its phases, which one block per SM runs in series
// (feature load, upsample epilogue, B build, conv_out, apply).
//
// Design (tail_mma.cuh holds the MMA core and the epilogue it shares with
// kernel G; mma.sync, not wgmma):
// - One block of 16 warps per 8x16 LR tile; the haloed features (10x18
//   pixels x 32) arrive by cp.async (zeros outside the image) while the
//   block folds conv_out's offset lanes (offc, below), stages the tile's
//   edge-clamped LR window and each warp loads its upsample B fragments
//   into registers.
// - Upsample on the tensor cores: warp = phase block (16 lanes), M = the 180
//   haloed pixels in 12 m tiles, K = 32 features, N = 16. Its epilogue adds
//   ubias, takes the attention dot as a quad reduction (two xor shuffles),
//   applies sigmoid and the gate and writes the gated up-lanes to the
//   shared merged map (f32, or bf16 pairs on the bf16 route), zero for
//   pixels outside the image. The 1-pixel halo (180 pixels for 128) is
//   recomputed: 0.46 GFLOP more upsample at the 348x510 frame, cheaper than
//   a second pass or a neighbour exchange.
// - conv_out on the tensor cores: warp = output phase (p, q), one m tile per
//   LR tile row (16 pixels), 4 m tiles per pass so that each tap's B
//   fragments are read once per pass, K = 9 taps x 16 gated up-lanes of the
//   source pixel's phase block (gathered per row from shared memory), N =
//   16. The offset lanes are an in-image flag times a per-phase constant,
//   so their share is a 16-vector per (tap, phase) (offc = offs @
//   kout[tap][16:32]), added into the accumulator's initial value as
//   valid(src) x offc. Then tanh, apply, round and pack
//   (tail_mma::apply_store).
// - Shared memory: the merged map at 260 (f32) or 132 (bf16) words per
//   pixel, 4 mod 32 so that a fragment load (8 rows x 4 words) hits 32
//   banks, with the pixel's in-image flag in its padding; features at 36 /
//   20 words per pixel, then conv_out's B fragments in the same place;
//   offc; the LR window. 225,744 B (f32) or 122,064 B (bf16): one block of
//   512 threads per SM.
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
constexpr int TH = 8, TW = 16;        // LR tile (one m tile per tile row)
constexpr int HH = TH + 2, HW = TW + 2;
constexpr int NPIX = HH * HW;         // 180 haloed tile pixels
constexpr int MTILES = (NPIX + 15) / 16;
constexpr int WARPS = 16;             // = phase blocks = output phases
constexpr int THREADS = 32 * WARPS;
constexpr int OFFC_N = 9 * PH * NW;   // folded offset lanes per (tap, phase)
constexpr int LRW = TW + 3;           // LR window columns of the tile
constexpr int LR_N = (TH + 3) * LRW * 4;   // LR window, up to 4 channels

// shared-memory layout in 32-bit words
template <bool BF16>
struct Layout {
  static constexpr int MAP_W = BF16 ? UPN / 2 : UPN;   // map words per pixel
  static constexpr int MSTRIDE = MAP_W + 4;            // flag at MAP_W
  static constexpr int CHUNK_W = BF16 ? 8 : 16;        // words per 16 lanes
  static constexpr int YSTRIDE = (BF16 ? F_IN / 2 : F_IN) + 4;
  static constexpr int KF_W = 9 * BParts<BF16>::N * 32 * 4;
  static constexpr int U_W = NPIX * YSTRIDE > KF_W ? NPIX * YSTRIDE : KF_W;
  static constexpr int MAP_N = NPIX * MSTRIDE;
  static constexpr size_t BYTES =
      (size_t)(MAP_N + U_W + OFFC_N + NW + LR_N) * 4;
  static_assert(BYTES <= 232448, "tile does not fit shared memory");
  static_assert(MSTRIDE % 8 == 4 && YSTRIDE % 8 == 4,
                "fragment rows must fall on distinct banks");
  static_assert(MAP_N % 4 == 0 && U_W % 4 == 0, "16-byte stages");
};

template <bool BF16>
__device__ __forceinline__ float rq(float v) {
  if constexpr (BF16) {
    return round_bf16(v);
  } else {
    return v;
  }
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
                         uint32_t* __restrict__ out, int h, int w, int c,
                         int opaque_alpha) {
  using L = Layout<BF16>;
  extern __shared__ uint4 smem4[];
  uint32_t* map = reinterpret_cast<uint32_t*>(smem4);   // [NPIX][MSTRIDE]
  uint32_t* ys = map + L::MAP_N;                         // [NPIX][YSTRIDE]
  uint4* kf = reinterpret_cast<uint4*>(ys);              // after the upsample
  float* offc = reinterpret_cast<float*>(ys + L::U_W);   // [9][PH][NW]
  float* bs = offc + OFFC_N;                             // [NW]
  float* lrs = bs + NW;                  // [TH+3][LRW][c], edge-clamped

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  y += (size_t)b * h * w * F_IN;
  lr += (size_t)b * h * w * c;
  out += (size_t)b * S * (h * S) * w;

  // 1. features of the haloed tile by cp.async (zeros outside the image)
  constexpr int PER16 = 16 / sizeof(YT);                // features per 16 B
  constexpr int CHUNKS = F_IN / PER16;
  for (int idx = tid; idx < NPIX * CHUNKS; idx += THREADS) {
    const int pix = idx / CHUNKS, k = idx % CHUNKS;
    const int gy = y0 - 1 + pix / HW, gx = x0 - 1 + pix % HW;
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
    const YT* src = in ? y + ((size_t)gy * w + gx) * F_IN + k * PER16 : y;
    cp_async16(ys + pix * L::YSTRIDE + 4 * k, src, in);
  }
  cp_async_commit();

  // while they load: in-image flags, the offset lanes folded with the
  // per-phase constants (offc[tap][ph] = offs[ph] @ kout[tap][16:32]),
  // conv_out's bias, and this warp's upsample B fragments
  for (int pix = tid; pix < NPIX; pix += THREADS) {
    const int gy = y0 - 1 + pix / HW, gx = x0 - 1 + pix % HW;
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
    map[pix * L::MSTRIDE + L::MAP_W] = __float_as_uint(in ? 1.f : 0.f);
  }
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
  // the tile's edge-clamped LR window (rows y0-1 .. y0+TH+1)
  for (int idx = tid; idx < (TH + 3) * LRW * c; idx += THREADS) {
    const int r = idx / (LRW * c), k = idx % (LRW * c);
    const int gy = min(max(y0 - 1 + r, 0), h - 1);
    const int gx = min(max(x0 - 1 + k / c, 0), w - 1);
    lrs[idx] = __ldg(lr + ((size_t)gy * w + gx) * c + k % c);
  }
  // B of the upsample for phase block `warp` (kup[0:32][warp*16 : +16]),
  // in registers for the whole block: two K = 16 chunks
  constexpr int BP = BParts<BF16>::N;
  uint4 bu[2][BP];
#pragma unroll
  for (int kc = 0; kc < 2; ++kc)
    make_b<BF16>(kup + kc * 16 * UPN + warp * NW, UPN, lane, bu[kc]);
  float ub[2][2], aw[2][2];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      ub[nt][j] = __ldg(ubias + nt * 8 + 2 * t + j);
      aw[nt][j] = __ldg(att_w + nt * 8 + 2 * t + j);
    }
  const float ab = __ldg(att_b);
  cp_async_wait_all();
  __syncthreads();

  // 2. upsample + attention + gate on the tensor cores, phase block `warp`
  const int blk = warp;
  for (int mt = 0; mt < MTILES; ++mt) {
    const int r0 = min(mt * 16 + g, NPIX - 1);
    const int r1 = min(mt * 16 + g + 8, NPIX - 1);
    Acc acc = {};
#pragma unroll
    for (int kc = 0; kc < 2; ++kc)
      mma_chunk<BF16>(acc, ys + r0 * L::YSTRIDE + kc * L::CHUNK_W,
                      ys + r1 * L::YSTRIDE + kc * L::CHUNK_W, bu[kc], lane);
#pragma unroll
    for (int px = 0; px < 2; ++px) {
      float u[2][2];
      float a = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          u[nt][j] = acc_value(acc, nt, 2 * px + j) + ub[nt][j];
          a = fmaf(rq<BF16>(u[nt][j]), aw[nt][j], a);
        }
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      const float att = rq<BF16>(1.f / (1.f + expf(-(a + ab))));
      const int pix = mt * 16 + g + 8 * px;
      if (pix < NPIX) {
        uint32_t* mp = map + pix * L::MSTRIDE;
        const bool in = __uint_as_float(mp[L::MAP_W]) != 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float v0 = in ? rq<BF16>(u[nt][0] * att) : 0.f;
          const float v1 = in ? rq<BF16>(u[nt][1] * att) : 0.f;
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
  }
  __syncthreads();

  // 3. conv_out's B fragments (its up-lane rows kout[tap][0:16]) where the
  //    features were
  for (int idx = tid; idx < 9 * 32; idx += THREADS) {
    const int tap = idx / 32, l = idx % 32;
    store_b<BF16>(kout + tap * TWOF * NW, NW, l, kf + tap * BP * 32);
  }
  __syncthreads();

  // 4. conv_out + tanh + 16-tap apply, output phase (pp, q) = warp, one
  //    tile row (16 pixels) per m tile, GROUP m tiles per pass so that each
  //    tap's B fragments are read from shared memory once per pass
  const int pp = warp >> 2, q = warp & 3;
  const int n_ch = (opaque_alpha && c == 4) ? 3 : c;
  constexpr int GROUP = 4;
  for (int ty0 = 0; ty0 < TH && y0 + ty0 < h; ty0 += GROUP) {
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
        // the offset lanes: zero outside the image, else the folded constant
        const float* oc = offc + (tap * PH + p2 * S + q2) * NW + 2 * t;
        const float o[2][2] = {{oc[0], oc[1]}, {oc[8], oc[9]}};
        const int off = (p2 * S + q2) * L::CHUNK_W;
#pragma unroll
        for (int i = 0; i < GROUP; ++i) {
          const int pix0 = (ty0 + i + 1 + sy) * HW + (g + 1 + sx);
          const uint32_t* m0 = map + pix0 * L::MSTRIDE;
          const uint32_t* m1 = m0 + 8 * L::MSTRIDE;
          const float v0 = __uint_as_float(m0[L::MAP_W]);
          const float v1 = __uint_as_float(m1[L::MAP_W]);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              acc[i].big[nt][j] = fmaf(v0, o[nt][j], acc[i].big[nt][j]);
              acc[i].big[nt][2 + j] = fmaf(v1, o[nt][j], acc[i].big[nt][2 + j]);
            }
          mma_chunk<BF16>(acc[i], m0 + off, m1 + off, b, lane);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < GROUP; ++i) {
      const int gy = y0 + ty0 + i;
      if (gy >= h) break;
      int rowoff[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) rowoff[k] = (ty0 + i + k) * LRW * c;
      const int gx0 = x0 + g;
      uint32_t* orow = out + ((size_t)q * (h * S) + (size_t)gy * S + pp) * w;
      apply_store(acc[i], lrs, rowoff, g, 0, LRW - 1, c, n_ch, gx0 < w,
                  gx0 + 8 < w, orow + gx0, orow + gx0 + 8, lane);
    }
  }
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
  dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, batch);
  kern<<<grid, THREADS, bytes, stream>>>(
      static_cast<const YT*>(y), lr, kout, bout, kup, ubias, offs, att_w, att_b,
      out, h, w, c, opaque_alpha);
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
