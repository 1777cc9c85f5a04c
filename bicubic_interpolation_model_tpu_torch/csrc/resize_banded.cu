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
// taps accumulate on one column, padding carries zero weight). Both products
// are dense f32 multiply-adds in this kernel's body, as in the TPU kernel's.
// u8 input is stored as clip(floor(v + 0.5), 0, 255), float input as the f32
// value. Input and output are interleaved HWC.
//
// What bounds it on the H100: as a function, bytes (a 1080x1920 RGBA frame at
// 4x moves 141 MB, ~0.042 ms at 3.35 TB/s, for 1.33 GFLOP of useful 4-tap
// sums); as written, the dense band products, ~9x the useful sums. The design
// is a plain shared-memory tiled f32 FMA kernel: a block owns one channel of
// one 16s x 32s output tile, stages window and bands in shared memory, keeps
// the row product in shared memory, and in the column product a thread owns
// 8 rows x 4 columns (a band value is read once for 8 pixels, a row-product
// value once for 4). The channel is the fastest block index, so the C blocks
// that fill one tile's interleaved bytes run together and meet in L2.

#include "resize_common.cuh"

namespace {

constexpr int RM = 8;   // rows per thread in the column product
constexpr int CM = 4;   // columns per thread

template <bool U8>
__global__ void __launch_bounds__(THREADS)
resize_banded_kernel(const typename Elem<U8>::type* __restrict__ in,
                     const float* __restrict__ brow, const float* __restrict__ bcolt,
                     typename Elem<U8>::type* __restrict__ out, int h, int w, int c, int ho, int wo,
                     int th, int tw, int kh, int kw, int step_h, int step_w, int left) {
  using T = typename Elem<U8>::type;
  extern __shared__ float4 smem4[];
  float* s_win = reinterpret_cast<float*>(smem4);   // [kh][kw]
  float* s_tmp = s_win + kh * kw;                   // [th][kw]
  float* s_bc = s_tmp + th * kw;                    // [kw][tw]
  float* s_br = s_bc + kw * tw;                     // [th][kh]

  const int tid = threadIdx.x;
  const int j = blockIdx.x / c, ch = blockIdx.x - j * c;
  const int i = blockIdx.y;
  const size_t b = blockIdx.z;

  // 1. window (zero outside the image) and the two bands
  const T* img = in + b * (size_t)h * w * c;
  for (int e = tid; e < kh * kw; e += THREADS) {
    const int rr = e / kw, cc = e - rr * kw;
    const int gr = i * step_h - left + rr, gc = j * step_w - left + cc;
    s_win[e] = gr >= 0 && gr < h && gc >= 0 && gc < w
                   ? (float)img[((size_t)gr * w + gc) * c + ch] : 0.f;
  }
  const float* br = brow + (size_t)i * th * kh;
  for (int e = tid; e < th * kh; e += THREADS) s_br[e] = br[e];
  const float4* bc4 = reinterpret_cast<const float4*>(bcolt + (size_t)j * kw * tw);
  for (int e = tid; e < (kw * tw) >> 2; e += THREADS)
    reinterpret_cast<float4*>(s_bc)[e] = bc4[e];
  __syncthreads();

  // 2. row product: tmp = B_row[i] @ window, four columns per thread
  const int n4 = kw >> 2;
  for (int e = tid; e < th * n4; e += THREADS) {
    const int o = e / n4, c4 = (e - o * n4) << 2;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < kh; ++k) {
      const float bw = s_br[o * kh + k];
      const float4 v = *reinterpret_cast<const float4*>(s_win + k * kw + c4);
      acc.x = fmaf(bw, v.x, acc.x);
      acc.y = fmaf(bw, v.y, acc.y);
      acc.z = fmaf(bw, v.z, acc.z);
      acc.w = fmaf(bw, v.w, acc.w);
    }
    *reinterpret_cast<float4*>(s_tmp + o * kw + c4) = acc;
  }
  __syncthreads();

  // 3. column product and store: out_tile = tmp @ B_colT[j]
  const int m4 = tw / CM;
  for (int e = tid; e < (th / RM) * m4; e += THREADS) {
    const int g = e / m4, c4 = (e - g * m4) * CM;
    const int gx = j * tw + c4;
    const int gr0 = i * th + g * RM;
    if (gx >= wo || gr0 >= ho) continue;
    float acc[RM][CM];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int t = 0; t < CM; ++t) acc[r][t] = 0.f;
    const float* trow = s_tmp + g * RM * kw;
    for (int k = 0; k < kw; ++k) {
      const float4 bv = *reinterpret_cast<const float4*>(s_bc + k * tw + c4);
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const float t = trow[r * kw + k];
        acc[r][0] = fmaf(t, bv.x, acc[r][0]);
        acc[r][1] = fmaf(t, bv.y, acc[r][1]);
        acc[r][2] = fmaf(t, bv.z, acc[r][2]);
        acc[r][3] = fmaf(t, bv.w, acc[r][3]);
      }
    }
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int gr = gr0 + r;
      if (gr >= ho) break;
      T* orow = out + ((b * ho + gr) * (size_t)wo) * c + ch;
#pragma unroll
      for (int t = 0; t < CM; ++t) {
        if (gx + t >= wo) break;
        if constexpr (U8)
          orow[(size_t)(gx + t) * c] = round_u8(acc[r][t]);
        else
          orow[(size_t)(gx + t) * c] = acc[r][t];
      }
    }
  }
}

template <bool U8>
int launch(const void* in, const float* brow, const float* bcolt, void* out, int b, int h, int w,
           int c, int ho, int wo, int n_i, int n_j, int th, int tw, int kh, int kw, int s, int left,
           cudaStream_t st) {
  using T = typename Elem<U8>::type;
  const size_t smem =
      sizeof(float) * ((size_t)kh * kw + (size_t)th * kw + (size_t)kw * tw + (size_t)th * kh);
  if (smem > SMEM_MAX) return -1;
  auto kern = resize_banded_kernel<U8>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(n_j * c, n_i, b);
  kern<<<grid, THREADS, smem, st>>>(static_cast<const T*>(in), brow, bcolt, static_cast<T*>(out), h,
                                    w, c, ho, wo, th, tw, kh, kw, th / s, tw / s, left);
  return (int)cudaGetLastError();
}

}  // namespace

// in:    [b, h, w, c] u8 (in_u8 != 0) or f32, contiguous
// brow:  [n_i, th, kh] f32;  bcolt: [n_j, kw, tw] f32, 16-byte aligned
//        (th a multiple of 8 and of s, tw and kw multiples of 4, tw of s)
// out:   [b, ho, wo, c], the input's kind (u8 -> u8, f32 -> f32)
// Returns cudaGetLastError() after the launch, -1 when the block's shared
// memory would exceed the card's 227 KB, or cudaErrorInvalidValue for tile
// sizes the kernel does not take (nothing is launched).
extern "C" int bim_resize_banded(const void* in, int in_u8, const float* brow, const float* bcolt,
                                 void* out, int b, int h, int w, int c, int ho, int wo, int n_i,
                                 int n_j, int th, int tw, int kh, int kw, int s, int left,
                                 void* stream) {
  if (s < 1 || th % RM || th % s || tw % CM || tw % s || kw % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return in_u8 ? launch<true>(in, brow, bcolt, out, b, h, w, c, ho, wo, n_i, n_j, th, tw, kh, kw, s,
                              left, st)
               : launch<false>(in, brow, bcolt, out, b, h, w, c, ho, wo, n_i, n_j, th, tw, kh, kw,
                               s, left, st);
}
