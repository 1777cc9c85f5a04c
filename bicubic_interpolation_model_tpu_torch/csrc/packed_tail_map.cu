// Packed learned tail fed a precomputed merged map, for Hopper (sm_90a).
//
// Replaces: bicubic_interpolation_model_tpu/ops/pallas_packed_tail.py
//           _tail_kernel (with the shared body _tail_body), the Pallas TPU
//           kernel behind packed_tail_pallas. Its caller is the band-sharded
//           learned path (parallel/spatial.learned_resize_spatial_sharded),
//           which builds each band's merged map from real neighbour rows.
//
// Computes, per LR pixel of a frame (or band) of h x w LR pixels, from the
// phase-packed merged map m [rows, w, 4, 4, 32] (f32 or bf16; lane
// (p2 * 4 + q2) * 32 + i) and the LR pixels lr [lr_rows, w, c] (f32, 0..255):
//   conv_out     the phase-decomposed 3x3 conv over all 32 lanes of the map
//                (9 taps x 32 in x 16 out per output phase) + bias, tanh;
//   apply        the 16-tap sum over the 4x4 LR window;
//   deliver      round half to even, clip to [0, 255], channels packed
//                little-endian into one u32 (bytes >= c zero) in the planar
//                layout out[q][Y*4 + p][X] (column phase q planar, row phase
//                p interleaved), kernel A's layout. opaque_alpha (c = 4):
//                alpha = rint(255 * sum(w)).
// Edges: halo_rows = 0 ("zero", one frame): m and lr span rows [0, h); map
// rows and columns outside the frame are zero and LR taps clamp to the
// frame. halo_rows = 1 ("rows", a band): the caller's rows are real, m spans
// band rows [-1, h+1) and lr rows [-1, h+2); only columns are zero (map) or
// clamped (LR).
//
// What bounds it on the H100: at the 348x510 frame the f32 map is 363.5 MB
// and the kernel moves 377.7 MB (0.113 ms at 3.35 TB/s); conv_out is 26.17
// GFLOP of products, as 3xTF32 on the tensor cores 3 x 26.17 / 495 TFLOP/s
// = 0.159 ms (bf16 maps: one pass, 0.026 ms, against 0.057 ms of bytes),
// and the apply 0.36 GFLOP on the f32 CUDA cores. So the products and the
// map's bytes are within 1.4x of each other, and the design's point is to
// keep both busy at once. As measured, the kernel takes ~3.5x that bound,
// and with a bf16 map ~56% of its f32 time: the per-row barrier of one
// block per SM, not the products or the bytes, holds it now.
//
// Design (tail_mma.cuh holds the MMA core and the epilogue it shares with
// kernel A; mma.sync, not wgmma):
// - A block owns a strip of 16 LR columns (one m tile of pixels) and walks
//   down a segment of its rows. The launcher cuts the frame into strips x
//   segments so that the blocks fill the SMs once (348x510: 32 strips x 4
//   segments of 87 rows = 128 blocks), and a segment loads only 2 map rows
//   beyond its own.
// - A ring of 4 map rows in shared memory (18 haloed pixels x 512 lanes
//   each, 37 KB in f32): LR row y needs map rows y-1, y, y+1, and while its
//   MMAs run, row y+2 is in flight by cp.async (zeros for pixels outside
//   the frame), so the map's loads overlap the tensor-core work. One
//   barrier per LR row.
// - conv_out on the tensor cores: warp = output phase (p, q) of the 16,
//   M = the strip's 16 pixels of the LR row, K = 9 taps x 32 lanes of the
//   source pixel's phase block (rows gathered from the ring), N = 16. The
//   offset lanes are data here (zeroed outside the image by the caller), so
//   conv_out contracts all 32 lanes. conv_out's B fragments (f32: hi and lo
//   for 3xTF32) are built once per block into shared memory. Then tanh,
//   apply, round and pack (tail_mma::apply_store).
// - Shared memory: the ring at 516 (f32) or 260 (bf16) words per pixel,
//   4 mod 32 so that a fragment load (8 rows x 4 words) hits 32 banks; bf16
//   pairs are read as 32-bit words straight into the bf16 A fragments.
//   185,536 B (f32) or 84,160 B (bf16), 16 warps, one block per SM.
//
// bf16 maps: the wrapper rounds conv_out's kernel to bf16; one bf16 MMA
// pass with f32 accumulation, as the TPU kernel's matmuls run in m.dtype.

#include "tail_mma.cuh"

namespace {

using namespace tail_mma;

constexpr int S = 4;                    // scale
constexpr int NW = 16;                  // predicted weights (conv_out outputs)
constexpr int TWOF = 32;                // merged channels per phase
constexpr int LANES = S * S * TWOF;     // 512 map lanes per LR pixel
constexpr int TW = 16;                  // strip width = one m tile
constexpr int HWP = TW + 2;             // haloed pixels per map row
constexpr int NSLOT = 4;                // ring of map rows
constexpr int WARPS = 16;               // = output phases
constexpr int THREADS = 32 * WARPS;

// shared-memory layout in 32-bit words
template <bool BF16>
struct Layout {
  static constexpr int PIX_W = BF16 ? LANES / 2 : LANES;
  static constexpr int PSTRIDE = PIX_W + 4;
  static constexpr int CHUNK_W = BF16 ? 8 : 16;        // words per 16 lanes
  static constexpr int SLOT = HWP * PSTRIDE;
  static constexpr int RING_N = NSLOT * SLOT;
  static constexpr int KF_N = 9 * 2 * BParts<BF16>::N * 32;   // uint4
  static constexpr size_t BYTES = (size_t)RING_N * 4 + (size_t)KF_N * 16 +
                                  NW * 4;
  static_assert(BYTES <= 232448, "ring does not fit shared memory");
  static_assert(PSTRIDE % 8 == 4, "fragment rows must fall on distinct banks");
  static_assert(SLOT % 4 == 0, "16-byte stages");
};

template <bool BF16, typename MT>
__global__ void __launch_bounds__(THREADS, 1)
packed_tail_map_kernel(const MT* __restrict__ m, const float* __restrict__ lr,
                       const float* __restrict__ kout,
                       const float* __restrict__ bout,
                       uint32_t* __restrict__ out, int h, int w, int c,
                       int halo_rows, int opaque_alpha, int seg_rows) {
  using L = Layout<BF16>;
  extern __shared__ uint4 smem4[];
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem4);   // [4][HWP][PSTRIDE]
  uint4* kf = smem4 + L::RING_N / 4;                     // [9][2][parts][32]
  float* bs = reinterpret_cast<float*>(kf + L::KF_N);    // [NW]

  const int x0 = blockIdx.x * TW;
  const int ya = blockIdx.y * seg_rows, yb = min(ya + seg_rows, h);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;
  // band row r lies at tensor row r + off; m holds m_rows, lr lr_rows rows
  const int off = halo_rows ? 1 : 0;
  const int m_rows = halo_rows ? h + 2 : h;
  const int lr_rows = halo_rows ? h + 3 : h;

  // map row r (band row, r >= -1) of the strip's 18 haloed pixels into ring
  // slot (r + 4) % 4, by cp.async; zeros outside the tensor's rows and the
  // frame's columns
  constexpr int PER16 = 16 / sizeof(MT);          // lanes per 16 bytes
  constexpr int CHUNKS = LANES / PER16;           // 16-byte chunks per pixel
  auto load_row = [&](int r) {
    uint32_t* dst = ring + ((r + 4) & 3) * L::SLOT;
    const int tr = r + off;
    const bool row_in = tr >= 0 && tr < m_rows;
    for (int idx = tid; idx < HWP * CHUNKS; idx += THREADS) {
      const int px = idx / CHUNKS, k = idx % CHUNKS;
      const int gc = x0 - 1 + px;
      const bool in = row_in && gc >= 0 && gc < w;
      const MT* src = in ? m + ((size_t)tr * w + gc) * LANES + k * PER16 : m;
      cp_async16(dst + px * L::PSTRIDE + 4 * k, src, in);
    }
  };
  load_row(ya - 1);
  load_row(ya);
  load_row(ya + 1);
  cp_async_commit();

  // conv_out's B fragments and bias while the first rows load
  constexpr int BP = BParts<BF16>::N;
  for (int idx = tid; idx < 9 * 2 * 32; idx += THREADS) {
    const int tk = idx / 32, l = idx % 32;        // tk = tap * 2 + K chunk
    store_b<BF16>(kout + tk * 16 * NW, NW, l, kf + tk * BP * 32);
  }
  if (tid < NW) bs[tid] = __ldg(bout + tid);

  const int pp = warp >> 2, q = warp & 3;
  const int n_ch = (opaque_alpha && c == 4) ? 3 : c;
  const int t = lane & 3;
  for (int yy = ya; yy < yb; ++yy) {
    // rows yy-1..yy+1 have landed, and every warp is done with row yy-2,
    // whose slot now takes row yy+2 while this row's MMAs run
    cp_async_wait_all();
    __syncthreads();
    if (yy + 2 <= yb) load_row(yy + 2);
    cp_async_commit();

    Acc acc;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc.big[nt][r] = bs[nt * 8 + 2 * t + (r & 1)];
        acc.small[nt][r] = 0.f;
      }
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
      const int pr = pp + dy;
      const int p2 = (pr + S) % S, sy = pr < 0 ? -1 : (pr >= S ? 1 : 0);
      const uint32_t* slot = ring + ((yy + sy + 4) & 3) * L::SLOT;
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        const int qc = q + dx;
        const int q2 = (qc + S) % S, sx = qc < 0 ? -1 : (qc >= S ? 1 : 0);
        const int tap = (dy + 1) * 3 + dx + 1;
        const uint32_t* p0 = slot + (g + 1 + sx) * L::PSTRIDE +
                             (p2 * S + q2) * 2 * L::CHUNK_W;
        const uint32_t* p1 = p0 + 8 * L::PSTRIDE;
#pragma unroll
        for (int kc = 0; kc < 2; ++kc) {
          uint4 b[BP];
          load_b<BF16>(kf + (tap * 2 + kc) * BP * 32, lane, b);
          mma_chunk<BF16>(acc, p0 + kc * L::CHUNK_W, p1 + kc * L::CHUNK_W, b,
                          lane);
        }
      }
    }
    int rowoff[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      rowoff[k] = min(max(yy - 1 + k + off, 0), lr_rows - 1) * w * c;
    const int gx0 = x0 + g;
    uint32_t* orow = out + ((size_t)q * (h * S) + (size_t)yy * S + pp) * w;
    apply_store(acc, lr, rowoff, gx0 - 1, 0, w - 1, c, n_ch, gx0 < w,
                gx0 + 8 < w, orow + gx0, orow + gx0 + 8, lane);
  }
}

template <bool BF16, typename MT>
int launch(const void* m, const float* lr, const float* kout,
           const float* bout, uint32_t* out, int h, int w, int c,
           int halo_rows, int opaque_alpha, cudaStream_t stream) {
  auto kern = packed_tail_map_kernel<BF16, MT>;
  constexpr size_t bytes = Layout<BF16>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // strips x segments: as many segments as fill the SMs once (at least one)
  const int strips = (w + TW - 1) / TW;
  const int want = max(1, min(h, n_sm / strips));
  const int seg = (h + want - 1) / want;
  dim3 grid(strips, (h + seg - 1) / seg);
  kern<<<grid, THREADS, bytes, stream>>>(static_cast<const MT*>(m), lr, kout,
                                         bout, out, h, w, c, halo_rows,
                                         opaque_alpha, seg);
  return (int)cudaGetLastError();
}

}  // namespace

// m: [h (+2 with halo_rows), w, 512] f32 (m_bf16 = 0) or bf16 (m_bf16 = 1),
// contiguous, 16-byte aligned. lr: [h (+3 with halo_rows), w, c] f32.
// kout: [3, 3, 32, 16] f32 (bf16-rounded values for a bf16 map). bout: [16].
// out: [4, 4h, w] u32. Returns cudaGetLastError() after the launch.
extern "C" int bim_packed_tail_map(const void* m, int m_bf16, const float* lr,
                                   const float* kout, const float* bout,
                                   uint32_t* out, int h, int w, int c,
                                   int halo_rows, int opaque_alpha,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m_bf16)
    return launch<true, __nv_bfloat16>(m, lr, kout, bout, out, h, w, c,
                                       halo_rows, opaque_alpha, st);
  return launch<false, float>(m, lr, kout, bout, out, h, w, c, halo_rows,
                              opaque_alpha, st);
}
