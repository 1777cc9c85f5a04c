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
// What bounds it on the H100: arithmetic. At the 348x510 frame the kernel
// reads ~25 MB and writes ~11 MB (~11 us at 3.35 TB/s) but does ~16.4
// GFLOP of f32 work (~0.245 ms at the 67 TFLOP/s f32 peak), 13.1 of them in
// conv_out. The offset lanes are an in-image flag times a per-phase
// constant, so their share of conv_out is a constant 16-vector per (tap,
// phase): each block folds it once (offc) and conv_out contracts only the
// 16 gated up-lanes, half the products of the 32-channel form. The design
// keeps every intermediate on chip: one block per 8x16 LR tile stages the
// haloed features (10x18x32) in shared memory, builds the merged map's 256
// up-lanes per pixel there (f32, odd pixel stride so the per-pixel reads of
// a warp hit 32 banks), then 4 threads per LR pixel (one per column phase)
// run conv_out, tanh and the tap apply from shared memory and registers.
// The merged map never reaches device memory. conv_out's kernel is read
// from shared memory as warp-wide broadcasts. The 4x block-diagonal
// padding of the TPU kernel's matmuls is not carried over. Tensor cores
// (wgmma) and TMA are later work.
//
// bf16 mode (y in bf16): the features, kup, att_w, offs and kout arrive
// rounded to bf16 (the wrapper rounds the parameters); the kernel rounds the
// merged-map stages where the TPU kernel casts them (the pre-gate map before
// the attention dot, att before the gate, the gated map before conv_out)
// and accumulates in f32, as the MXU does.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int S = 4;                  // scale
constexpr int F_IN = 32;              // conv feature width
constexpr int NW = 16;                // predicted weights (up-lanes per phase)
constexpr int TWOF = 2 * NW;          // merged channels per phase
constexpr int PH = S * S;             // output phases per LR pixel
constexpr int UPN = PH * NW;          // 256 up-lanes per LR pixel
constexpr int TH = 8, TW = 16;        // LR tile
constexpr int HH = TH + 2, HW = TW + 2;
constexpr int NPIX = HH * HW;         // haloed tile pixels
constexpr int MSTRIDE = UPN + 1;      // 256 gated up-lanes + valid flag
constexpr int YSTRIDE = F_IN + 1;
constexpr int THREADS = TH * TW * S;  // one thread per (pixel, column phase)
constexpr int KUP_N = 9 * NW * NW;    // conv_out rows of the up-lanes
constexpr int OFFC_N = 9 * PH * NW;   // folded offset lanes per (tap, phase)
constexpr int UNION_N = (NPIX * YSTRIDE > KUP_N + OFFC_N + NW)
                            ? NPIX * YSTRIDE : KUP_N + OFFC_N + NW;
constexpr size_t SMEM_BYTES = (size_t)(NPIX * MSTRIDE + UNION_N) * 4;
static_assert(SMEM_BYTES <= 232448, "tile does not fit shared memory");
static_assert((NPIX * MSTRIDE) % 4 == 0, "kout stage must be 16-byte aligned");

template <bool BF16>
__device__ __forceinline__ float rq(float v) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
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
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* m = smem;                       // [NPIX][MSTRIDE]
  float* ys = smem + NPIX * MSTRIDE;     // stage 1: [NPIX][YSTRIDE]
  float* ks = ys;                        // stage 2: kout up rows [9][16][16]
  float* offc = ks + KUP_N;              // [9][PH][NW] folded offset lanes
  float* bs = offc + OFFC_N;             // [NW] conv_out bias

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  y += (size_t)b * h * w * F_IN;
  lr += (size_t)b * h * w * c;
  out += (size_t)b * S * (h * S) * w;

  // 1. features of the haloed tile (zero outside the image)
  for (int idx = tid; idx < NPIX * F_IN; idx += THREADS) {
    const int pix = idx / F_IN, i = idx % F_IN;
    const int gy = y0 - 1 + pix / HW, gx = x0 - 1 + pix % HW;
    float v = 0.f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w)
      v = load_f(y + ((size_t)gy * w + gx) * F_IN + i);
    ys[pix * YSTRIDE + i] = v;
  }
  __syncthreads();

  // 2. merged map, up-lanes: one item = (phase block, haloed pixel)
  const float ab = att_b[0];
  for (int it = tid; it < PH * NPIX; it += THREADS) {
    const int blk = it / NPIX, pix = it % NPIX;
    const int gy = y0 - 1 + pix / HW, gx = x0 - 1 + pix % HW;
    const bool valid = gy >= 0 && gy < h && gx >= 0 && gx < w;
    float acc[NW];
#pragma unroll
    for (int o = 0; o < NW; ++o) acc[o] = 0.f;
    const float* yp = ys + pix * YSTRIDE;
#pragma unroll 4
    for (int i = 0; i < F_IN; ++i) {
      const float v = yp[i];
      const float4* kr =
          reinterpret_cast<const float4*>(kup + i * UPN + blk * NW);
#pragma unroll
      for (int o4 = 0; o4 < NW / 4; ++o4) {
        const float4 k = __ldg(kr + o4);
        acc[4 * o4 + 0] = fmaf(v, k.x, acc[4 * o4 + 0]);
        acc[4 * o4 + 1] = fmaf(v, k.y, acc[4 * o4 + 1]);
        acc[4 * o4 + 2] = fmaf(v, k.z, acc[4 * o4 + 2]);
        acc[4 * o4 + 3] = fmaf(v, k.w, acc[4 * o4 + 3]);
      }
    }
    float a = 0.f;
#pragma unroll
    for (int o = 0; o < NW; ++o) {
      acc[o] += __ldg(ubias + o);
      a = fmaf(rq<BF16>(acc[o]), __ldg(att_w + o), a);
    }
    const float att = rq<BF16>(1.f / (1.f + expf(-(a + ab))));
    float* mp = m + pix * MSTRIDE + blk * NW;
#pragma unroll
    for (int o = 0; o < NW; ++o) mp[o] = valid ? rq<BF16>(acc[o] * att) : 0.f;
    if (blk == 0) m[pix * MSTRIDE + UPN] = valid ? 1.f : 0.f;
  }
  __syncthreads();

  // 3. conv_out's up-lane rows [9][16][16], its offset lanes folded with
  //    the per-phase constants: offc[tap][ph] = offs[ph] @ kout[tap][16:32]
  for (int idx = tid; idx < KUP_N; idx += THREADS)
    ks[idx] = __ldg(kout + (idx / (NW * NW)) * TWOF * NW + idx % (NW * NW));
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
  __syncthreads();

  // 4. conv_out + tanh + 16-tap apply for (pixel, column phase q)
  const int q = tid / (TH * TW);
  const int lp = tid % (TH * TW);
  const int ty = lp / TW, tx = lp % TW;
  const int gy = y0 + ty, gx = x0 + tx;
  if (gy >= h || gx >= w) return;
  const int n_ch = (opaque_alpha && c == 4) ? 3 : c;
  int rows[4], cols[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    rows[t] = min(max(gy - 1 + t, 0), h - 1);
    cols[t] = min(max(gx - 1 + t, 0), w - 1);
  }

  for (int pp = 0; pp < S; ++pp) {
    float acc[NW];
#pragma unroll
    for (int o = 0; o < NW; ++o) acc[o] = bs[o];
    for (int dy = -1; dy <= 1; ++dy) {
      const int pr = pp + dy;
      const int p2 = (pr + S) % S, sy = pr < 0 ? -1 : (pr >= S ? 1 : 0);
      for (int dx = -1; dx <= 1; ++dx) {
        const int qc = q + dx;
        const int q2 = (qc + S) % S, sx = qc < 0 ? -1 : (qc >= S ? 1 : 0);
        const float* src = m + ((ty + 1 + sy) * HW + (tx + 1 + sx)) * MSTRIDE;
        const float valid = src[UPN];
        const float* up = src + (p2 * S + q2) * NW;
        const int tap = (dy + 1) * 3 + dx + 1;
        const float4* kt = reinterpret_cast<const float4*>(ks + tap * NW * NW);
        const float* oc = offc + (tap * PH + p2 * S + q2) * NW;
#pragma unroll 4
        for (int i = 0; i < NW; ++i) {
          const float v = up[i];
#pragma unroll
          for (int o4 = 0; o4 < NW / 4; ++o4) {
            const float4 k = kt[i * (NW / 4) + o4];
            acc[4 * o4 + 0] = fmaf(v, k.x, acc[4 * o4 + 0]);
            acc[4 * o4 + 1] = fmaf(v, k.y, acc[4 * o4 + 1]);
            acc[4 * o4 + 2] = fmaf(v, k.z, acc[4 * o4 + 2]);
            acc[4 * o4 + 3] = fmaf(v, k.w, acc[4 * o4 + 3]);
          }
        }
        // the offset lanes: zero outside the image, else the folded constant
#pragma unroll
        for (int o = 0; o < NW; ++o) acc[o] = fmaf(valid, oc[o], acc[o]);
      }
    }
#pragma unroll
    for (int o = 0; o < NW; ++o) acc[o] = tanhf(acc[o]);

    uint32_t word = 0;
    for (int ch = 0; ch < c; ++ch) {
      float v;
      if (ch < n_ch) {
        v = 0.f;
#pragma unroll
        for (int i = 0; i < 16; ++i)
          v = fmaf(acc[i], __ldg(lr + ((size_t)rows[i / 4] * w + cols[i % 4]) * c + ch), v);
      } else {
        v = 0.f;
#pragma unroll
        for (int i = 0; i < 16; ++i) v += acc[i];
        v *= 255.f;
      }
      const int iv = min(max(__float2int_rn(v), 0), 255);
      word |= (uint32_t)iv << (8 * ch);
    }
    out[((size_t)q * (h * S) + (size_t)gy * S + pp) * w + gx] = word;
  }
}

template <bool BF16, typename YT>
int launch(const void* y, const float* lr, const float* kout, const float* bout,
           const float* kup, const float* ubias, const float* offs,
           const float* att_w, const float* att_b, uint32_t* out, int batch,
           int h, int w, int c, int opaque_alpha, cudaStream_t stream) {
  auto kern = packed_tail_fused_kernel<BF16, YT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, batch);
  kern<<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const YT*>(y), lr, kout, bout, kup, ubias, offs, att_w, att_b,
      out, h, w, c, opaque_alpha);
  return (int)cudaGetLastError();
}

}  // namespace

// y: [batch, h, w, 32] f32 (y_bf16 = 0) or bf16 (y_bf16 = 1), contiguous.
// lr: [batch, h, w, c] f32. kout: [3, 3, 32, 16]. bout: [16].
// kup: [32, 256] upsample kernel, lane = phase * 16 + o. ubias: [16].
// offs: [16, 16] per-phase offset constants. att_w: [16]. att_b: [1]
// (all f32). out: [batch, 4, 4h, w] u32. Returns cudaGetLastError() after
// the launch.
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
