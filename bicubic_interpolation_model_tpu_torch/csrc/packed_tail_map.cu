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
// What bounds it on the H100: arithmetic. At the 348x510 frame the map is
// 363.5 MB in f32 and the kernel moves 377.7 MB (0.113 ms at 3.35 TB/s), but
// conv_out is 147,456 FLOP per LR pixel, 26.17 GFLOP, and the apply 0.36:
// 0.396 ms at the 67 TFLOP/s f32 peak. Unlike kernel A the 16 offset lanes
// of each phase are data here (zeroed outside the image by the caller), so
// conv_out contracts all 32 lanes: twice A's products. The design: one block
// per 8x8 LR tile stages the haloed map tile (10x10 pixels x 512 lanes, f32,
// 206 KB) and conv_out's kernel (18 KB) in shared memory; one thread per
// (LR pixel, column phase q) holds the 4 row phases x 16 outputs in
// registers, so each float4 of conv_out's kernel, read as a warp-wide
// broadcast, feeds 4 x 4 independent FMAs (8 FMAs per shared-memory load).
// A pixel occupies 513 floats and a tile row 5160 (8 mod 32), so the 8x4
// pixels of a warp read 32 distinct banks. The tile is loaded before any
// arithmetic and one block fits an SM: loads and FMAs do not overlap
// (cp.async/TMA double buffering, wgmma on bf16 maps: later work).
//
// bf16 maps: the wrapper rounds conv_out's kernel to bf16; products of two
// bf16 values are exact in f32 and accumulate in f32, as the TPU kernel's
// matmuls run in m.dtype with f32 accumulation.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int S = 4;                    // scale
constexpr int NW = 16;                  // predicted weights (conv_out outputs)
constexpr int TWOF = 32;                // merged channels per phase
constexpr int LANES = S * S * TWOF;     // 512 map lanes per LR pixel
constexpr int TH = 8, TW = 8;           // LR tile
constexpr int HH = TH + 2, HW = TW + 2; // with the 3x3 conv's halo
constexpr int PSTRIDE = LANES + 1;      // floats per staged pixel
constexpr int RSTRIDE = HW * PSTRIDE + 30;  // floats per staged tile row
constexpr int MAP_N = HH * RSTRIDE;
constexpr int KOUT_N = 9 * TWOF * NW;   // conv_out [3][3][32][16]
constexpr int THREADS = TH * TW * S;    // one thread per (pixel, column phase)
constexpr size_t SMEM_BYTES = (size_t)(MAP_N + KOUT_N + NW) * 4;
static_assert(SMEM_BYTES <= 232448, "tile does not fit shared memory");
static_assert(RSTRIDE % 32 == 8, "a warp's 8x4 pixels must hit 32 banks");
static_assert(MAP_N % 4 == 0, "conv_out's stage must be 16-byte aligned");

// 16 bytes of map lanes → 4 (f32) or 8 (bf16) floats in shared memory
__device__ __forceinline__ void stage16(const float* src, float* dst) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(src));
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}
__device__ __forceinline__ void stage16(const __nv_bfloat16* src, float* dst) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // a bf16 is the upper half of the f32 with the same bits
    dst[2 * k] = __uint_as_float(words[k] << 16);
    dst[2 * k + 1] = __uint_as_float(words[k] & 0xffff0000u);
  }
}

template <typename MT>
__global__ void __launch_bounds__(THREADS, 1)
packed_tail_map_kernel(const MT* __restrict__ m, const float* __restrict__ lr,
                       const float* __restrict__ kout,
                       const float* __restrict__ bout,
                       uint32_t* __restrict__ out, int h, int w, int c,
                       int halo_rows, int opaque_alpha) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* map = smem;                      // [HH][RSTRIDE], pixel [PSTRIDE]
  float* ks = smem + MAP_N;               // [9][32][16]
  float* bs = ks + KOUT_N;                // [16]

  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  // band row r lies at tensor row r + off; m holds m_rows, lr lr_rows rows
  const int off = halo_rows ? 1 : 0;
  const int m_rows = halo_rows ? h + 2 : h;
  const int lr_rows = halo_rows ? h + 3 : h;

  // 1. the haloed map tile (zero outside the tensor's rows and the columns)
  constexpr int PER16 = 16 / sizeof(MT);          // lanes per 16 bytes
  constexpr int CHUNKS = LANES / PER16;           // 16-byte chunks per pixel
  for (int idx = tid; idx < HH * HW * CHUNKS; idx += THREADS) {
    const int pix = idx / CHUNKS, ch = idx % CHUNKS;
    const int py = pix / HW, px = pix % HW;
    const int tr = y0 - 1 + py + off, gc = x0 - 1 + px;
    float* dst = map + py * RSTRIDE + px * PSTRIDE + ch * PER16;
    if (tr >= 0 && tr < m_rows && gc >= 0 && gc < w) {
      stage16(m + ((size_t)tr * w + gc) * LANES + ch * PER16, dst);
    } else {
#pragma unroll
      for (int k = 0; k < PER16; ++k) dst[k] = 0.f;
    }
  }
  for (int idx = tid; idx < KOUT_N; idx += THREADS) ks[idx] = __ldg(kout + idx);
  if (tid < NW) bs[tid] = __ldg(bout + tid);
  __syncthreads();

  // 2. conv_out for (pixel, column phase q), all 4 row phases
  const int q = tid / (TH * TW);
  const int lp = tid % (TH * TW);
  const int ty = lp / TW, tx = lp % TW;
  const int gy = y0 + ty, gx = x0 + tx;
  if (gy >= h || gx >= w) return;

  float acc[S][NW];
#pragma unroll
  for (int pp = 0; pp < S; ++pp)
#pragma unroll
    for (int o = 0; o < NW; ++o) acc[pp][o] = bs[o];

  for (int dy = -1; dy <= 1; ++dy) {
    for (int dx = -1; dx <= 1; ++dx) {
      const int qc = q + dx;
      const int q2 = (qc + S) % S, sx = qc < 0 ? -1 : (qc >= S ? 1 : 0);
      const float* src[S];
#pragma unroll
      for (int pp = 0; pp < S; ++pp) {
        const int pr = pp + dy;
        const int p2 = (pr + S) % S, sy = pr < 0 ? -1 : (pr >= S ? 1 : 0);
        src[pp] = map + (ty + 1 + sy) * RSTRIDE + (tx + 1 + sx) * PSTRIDE +
                  (p2 * S + q2) * TWOF;
      }
      const float4* kt = reinterpret_cast<const float4*>(
          ks + ((dy + 1) * 3 + dx + 1) * TWOF * NW);
#pragma unroll 2
      for (int i = 0; i < TWOF; ++i) {
        float k[NW];
#pragma unroll
        for (int o4 = 0; o4 < NW / 4; ++o4) {
          const float4 kv = kt[i * (NW / 4) + o4];
          k[4 * o4 + 0] = kv.x;
          k[4 * o4 + 1] = kv.y;
          k[4 * o4 + 2] = kv.z;
          k[4 * o4 + 3] = kv.w;
        }
#pragma unroll
        for (int pp = 0; pp < S; ++pp) {
          const float v = src[pp][i];
#pragma unroll
          for (int o = 0; o < NW; ++o) acc[pp][o] = fmaf(v, k[o], acc[pp][o]);
        }
      }
    }
  }

  // 3. tanh, the 16-tap apply, round and pack, one word per row phase
  const int n_ch = (opaque_alpha && c == 4) ? 3 : c;
  int rows[4], cols[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    rows[t] = min(max(gy - 1 + t + off, 0), lr_rows - 1);
    cols[t] = min(max(gx - 1 + t, 0), w - 1);
  }
#pragma unroll
  for (int pp = 0; pp < S; ++pp) {
    float wt[NW];
#pragma unroll
    for (int o = 0; o < NW; ++o) wt[o] = tanhf(acc[pp][o]);
    uint32_t word = 0;
    for (int ch = 0; ch < c; ++ch) {
      float v = 0.f;
      if (ch < n_ch) {
#pragma unroll
        for (int i = 0; i < 16; ++i)
          v = fmaf(wt[i],
                   __ldg(lr + ((size_t)rows[i / 4] * w + cols[i % 4]) * c + ch),
                   v);
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) v += wt[i];
        v *= 255.f;
      }
      const int iv = min(max(__float2int_rn(v), 0), 255);
      word |= (uint32_t)iv << (8 * ch);
    }
    out[((size_t)q * (h * S) + (size_t)gy * S + pp) * w + gx] = word;
  }
}

template <typename MT>
int launch(const void* m, const float* lr, const float* kout,
           const float* bout, uint32_t* out, int h, int w, int c,
           int halo_rows, int opaque_alpha, cudaStream_t stream) {
  auto kern = packed_tail_map_kernel<MT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH);
  kern<<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const MT*>(m), lr, kout, bout, out, h, w, c, halo_rows,
      opaque_alpha);
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
    return launch<__nv_bfloat16>(m, lr, kout, bout, out, h, w, c, halo_rows,
                                 opaque_alpha, st);
  return launch<float>(m, lr, kout, bout, out, h, w, c, halo_rows,
                       opaque_alpha, st);
}
