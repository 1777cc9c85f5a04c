// 3x3 stride-1 SAME convs on channel-major f32 frames as an implicit GEMM
// on the tensor cores, for Hopper (sm_90a).
//
// Replaces: no TPU kernel. The JAX package leaves its convs to XLA; the
// port's convs ran on cuDNN, whose f32 route (TF32 off) runs on the CUDA
// cores only. This kernel serves the published ESRGAN generator's dense
// blocks, conv_body and its HR-stage convs (models/esrgan.py, through
// ops/conv3x3.py).
//
// GEMM view: M = output pixels, N = C_out (an instance of 32 or 64; fewer
// output channels are zero columns of the packed weights, never stored),
// K = 9 C_in in k8 steps of 8 input channels x 1 tap.
//
// What bounds it on the H100: operations. A dense-block conv does ~280
// FLOP per byte it must move, so products at f32 accuracy are the limit.
// cuDNN's f32 route does them on FFMA (67 TFLOP/s at best); here they run
// as 3xTF32 on wgmma: each operand split into x = hi + lo, both rounded to
// the nearest TF32 value, and the products lo*hi + hi*lo + hi*hi summed.
// lo*lo (2^-22 relative) is dropped. The tensor cores truncate their sums,
// so a sum that runs over the whole K drifts (6-10x cuDNN f32's error on
// the card): the products of 8 input channels x 3 taps go to a fresh
// accumulator, added to the pixel's f32 sum by one FADD. That keeps the
// error at a third to a half of cuDNN f32's, and the cell's frames closer
// to float64 than cuDNN's f32 convs leave them (a fresh sum every 9 taps
// left them farther; every tap, no closer and 8% slower).
//
// Design:
// - A block computes an 8-row x 32-column tile of output pixels and all N
//   output channels: 8 warps in two warpgroups, one output row a warp, two
//   m16 tiles of 16 consecutive pixels a warp. A warpgroup's m64 tile is
//   4 rows x 16 pixels.
// - wgmma m64nNk8 tf32, A from registers (the warp's m16 rows of the
//   input halo at one tap, in mma.m16n8k8's fragment layout), B from
//   shared memory (the tap's weights, K-major, no swizzle: per 8 output
//   channels two 128-byte core matrices of 8 channels x 4 k, 256 bytes
//   apart). Each tap's 3 x 2 products are one commit group; the next tap's
//   A fragments load while it runs (one group in flight).
// - K runs in chunks of 8 input channels. A chunk's input halo (8 x 10
//   rows x 34 columns) and its packed weights (9 taps x hi, lo) arrive by
//   cp.async in a ring of 3 stages: the next two chunks load while one
//   computes. Each thread copies the same halo positions of every chunk
//   (offsets computed once a block), 16 bytes a copy where the frame's
//   rows allow it (the dense blocks' buffers), else 4. Reads outside the
//   stored frame are zero-filled by the copy, so one kernel serves both
//   SAME paddings: a frame that carries its own zero border (pad 0: the
//   dense blocks' buffers) and a plain frame (pad 1: the HR stage). The
//   landed halo is split into hi and lo planes once, not once a tap; the
//   weights come split (ops/conv3x3.pack).
// - Halo planes are 10 x 36 floats apart, 8 mod 32 banks, so the A
//   fragment's 4 channels x 8 pixels hit 32 distinct banks.
// - Epilogue, from the accumulators straight to device memory: + bias,
//   then leaky ReLU 0.2, or out = res + alpha * v and optionally
//   out = outer + beta * (...) (the dense block's scaled residual and the
//   RRDB's outer one). The output, the residual and the outer term are
//   strided planes (a dense block's buffer's interior), so no elementwise
//   pass re-reads what the conv wrote.
// Offsets are 64-bit.

#include <cuda_runtime.h>

#include <atomic>
#include <stdint.h>

#include "tail_mma.cuh"
#include "wgmma_tf32.cuh"

namespace {

using tail_mma::cp_async16;
using tail_mma::cp_async_commit;
using wgmma_tf32::b_desc;
using wgmma_tf32::cp_async_wait;
using wgmma_tf32::keep;
using wgmma_tf32::tf32_rn;
using wgmma_tf32::wg_commit;
using wgmma_tf32::wg_fence;
using wgmma_tf32::wg_wait;
using wgmma_tf32::Wgmma;

constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int TH = 8, TW = 32;       // output rows (one a warp), columns
constexpr int MT = TW / 16;          // m16 tiles a warp
constexpr int KC = 8;                // input channels of a chunk (one k8)
constexpr int STAGES = 3;            // chunks in flight
constexpr int HW = TW + 2;           // halo columns
constexpr int RS = TW + 4;           // halo row stride
constexpr int CS = (TH + 2) * RS;    // halo plane stride
constexpr int HALO = KC * CS;        // floats
constexpr int HALO_PX = (TH + 2) * HW;
constexpr int PX_PER_THREAD = (HALO_PX + THREADS - 1) / THREADS;
static_assert(CS % 32 == 8, "A fragment reads must not conflict");
static_assert(HALO % 4 == 0, "16-byte weight slots");

template <int N>
struct Shape {
  static constexpr int TAP = 8 * N;                 // floats of hi (or lo)
  static constexpr int WCHUNK = 9 * 2 * TAP;        // a chunk's weights
  static constexpr int STAGE = HALO + WCHUNK;       // floats
  // the ring of stages, then the current chunk's split halo (hi, lo)
  static constexpr size_t BYTES =
      sizeof(float) * (size_t(STAGES) * STAGE + 2 * HALO);
};

// a strided [C, H, W] plane set: element (c, y, x) at p[c cs + y rs + x]
struct Planes {
  const float* p;
  long long cs, rs;
};

struct Args {
  Planes in;
  int hs, ws, pad;           // stored input rows, columns; SAME padding
  int vec;                   // halo rows copied 16 bytes at a time
  const float4* wpk;         // packed weights (ops/conv3x3.pack)
  const float* bias;
  int cin, cout;
  float* out;
  long long out_cs, out_rs;
  int h, w;                  // output rows, columns
  int leaky;
  Planes res, outer;         // p null: no such term
  float alpha, beta;
};

// `bytes` (4 or 16; fewer are read, the rest zero-filled) global -> shared
template <int SIZE>
__device__ __forceinline__ void cp_async_z(float* dst, const float* src,
                                           int bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  if constexpr (SIZE == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(bytes)
                 : "memory");
}

// The halo positions a thread copies in every chunk: shared offset (-1:
// none), global offset within a plane, and the bytes that lie in the
// stored frame. Scalar: one float a position, 340 positions. Vector (a.vec:
// the frame carries its border, pad 0, and its rows and planes start at
// 16-byte boundaries): 4 floats a position, 10 rows x 9, the last ones of
// a row past column 34 unused; a position that runs past the frame's edge
// copies its part inside.
struct HaloPx {
  int soff[PX_PER_THREAD];
  long long goff[PX_PER_THREAD];
  int bytes[PX_PER_THREAD];
};

__device__ __forceinline__ HaloPx halo_px(const Args& a, int x0, int y0) {
  HaloPx h;
  const int step = a.vec ? 4 : 1;
  const int per_row = (HW + step - 1) / step;
#pragma unroll
  for (int i = 0; i < PX_PER_THREAD; ++i) {
    const int p = threadIdx.x + i * THREADS;
    const int r = p / per_row, j = (p - r * per_row) * step;
    const int gy = y0 + r - a.pad, gx = x0 + j - a.pad;
    const bool in = p < (TH + 2) * per_row;
    const bool ok = gy >= 0 && gy < a.hs && gx >= 0 && gx < a.ws;
    h.soff[i] = in ? r * RS + j : -1;
    h.bytes[i] = ok ? 4 * min(step, a.ws - gx) : 0;
    h.goff[i] = ok ? (long long)gy * a.in.rs + gx : 0;
  }
  return h;
}

// Chunk `chunk` (input channels 8 chunk ..) into a stage: the halo of the
// block's tile, zero outside the stored frame, and the chunk's weights.
template <int N>
__device__ __forceinline__ void load_chunk(const Args& a, const HaloPx& hp,
                                           float* stage, int chunk) {
  const float* plane = a.in.p + (long long)chunk * KC * a.in.cs;
#pragma unroll
  for (int c = 0; c < KC; ++c) {
#pragma unroll
    for (int i = 0; i < PX_PER_THREAD; ++i) {
      if (hp.soff[i] < 0) continue;
      float* dst = stage + c * CS + hp.soff[i];
      const float* src = hp.bytes[i] ? plane + hp.goff[i] : a.in.p;
      if (a.vec)
        cp_async_z<16>(dst, src, hp.bytes[i]);
      else
        cp_async_z<4>(dst, src, hp.bytes[i]);
    }
    plane += a.in.cs;
  }
  constexpr int N4 = Shape<N>::WCHUNK / 4;
  const float4* src = a.wpk + (size_t)chunk * N4;
  float4* wdst = reinterpret_cast<float4*>(stage + HALO);
#pragma unroll
  for (int i = threadIdx.x; i < N4; i += THREADS)
    cp_async16(wdst + i, src + i, true);
}

// the landed halo of a chunk split into hi and lo planes: each element
// once, not once a tap
__device__ __forceinline__ void split_halo(const float* raw, float* hi,
                                           float* lo) {
  const float4* r4 = reinterpret_cast<const float4*>(raw);
  float4* h4 = reinterpret_cast<float4*>(hi);
  float4* l4 = reinterpret_cast<float4*>(lo);
#pragma unroll
  for (int i = threadIdx.x; i < HALO / 4; i += THREADS) {
    const float4 v = r4[i];
    float4 h, l;
    h.x = __uint_as_float(tf32_rn(v.x));
    h.y = __uint_as_float(tf32_rn(v.y));
    h.z = __uint_as_float(tf32_rn(v.z));
    h.w = __uint_as_float(tf32_rn(v.w));
    l.x = __uint_as_float(tf32_rn(v.x - h.x));
    l.y = __uint_as_float(tf32_rn(v.y - h.y));
    l.z = __uint_as_float(tf32_rn(v.z - h.z));
    l.w = __uint_as_float(tf32_rn(v.w - h.w));
    h4[i] = h;
    l4[i] = l;
  }
}

constexpr int PROMOTE = 3;   // taps summed in a fresh accumulator

// acc += the chunk's products (8 input channels x 9 taps), summed in a
// fresh accumulator d for PROMOTE taps at a time
template <int N>
__device__ __forceinline__ void compute_chunk(const float* hi,
                                              const float* lo,
                                              const float* weights, int warp,
                                              int lane,
                                              float (&acc)[MT][N / 2]) {
  const int g = lane >> 2, t = lane & 3;
  const int a0 = t * CS + warp * RS + g;
  float d[MT][N / 2];
  uint32_t ah[2][MT][4], al[2][MT][4];   // this tap's and the previous one's
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3, kx = tap % 3, b = tap & 1;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int o = a0 + ky * RS + mt * 16 + kx;
      ah[b][mt][0] = __float_as_uint(hi[o]);
      ah[b][mt][1] = __float_as_uint(hi[o + 8]);
      ah[b][mt][2] = __float_as_uint(hi[o + 4 * CS]);
      ah[b][mt][3] = __float_as_uint(hi[o + 4 * CS + 8]);
      al[b][mt][0] = __float_as_uint(lo[o]);
      al[b][mt][1] = __float_as_uint(lo[o + 8]);
      al[b][mt][2] = __float_as_uint(lo[o + 4 * CS]);
      al[b][mt][3] = __float_as_uint(lo[o + 4 * CS + 8]);
    }
    const uint64_t bh = b_desc(weights + tap * 2 * Shape<N>::TAP);
    const uint64_t bl = b_desc(weights + (tap * 2 + 1) * Shape<N>::TAP);
    wg_fence();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      Wgmma<N>::run(d[mt], al[b][mt], bh, tap % PROMOTE != 0);
      Wgmma<N>::run(d[mt], ah[b][mt], bl, 1);
      Wgmma<N>::run(d[mt], ah[b][mt], bh, 1);
    }
    wg_commit();
    if ((tap + 1) % PROMOTE == 0) {
      wg_wait<0>();          // this tap's products are done: d is final
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        keep(d[mt]);
        keep(ah[b][mt]);
        keep(al[b][mt]);
        keep(ah[b ^ 1][mt]);
        keep(al[b ^ 1][mt]);
#pragma unroll
        for (int i = 0; i < N / 2; ++i) acc[mt][i] += d[mt][i];
      }
    } else if (tap > 0) {
      wg_wait<1>();          // the previous tap's products are done
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        keep(ah[b ^ 1][mt]);
        keep(al[b ^ 1][mt]);
      }
    }
  }
}

template <int N>
__global__ void __launch_bounds__(THREADS, 1)
    conv_implicit_gemm_kernel(const Args a) {
  using S = Shape<N>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* hi = smem + STAGES * S::STAGE;
  float* lo = hi + HALO;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int n_chunks = a.cin / KC;
  const HaloPx hp = halo_px(a, x0, y0);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_chunks) load_chunk<N>(a, hp, smem + s * S::STAGE, s);
    cp_async_commit();
  }
  float acc[MT][N / 2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[mt][i] = 0.f;

  for (int ch = 0; ch < n_chunks; ++ch) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();     // chunk ch landed; chunk ch - 1 is computed
    const int next = ch + STAGES - 1;
    if (next < n_chunks)
      load_chunk<N>(a, hp, smem + (next % STAGES) * S::STAGE, next);
    cp_async_commit();
    const float* stage = smem + (ch % STAGES) * S::STAGE;
    split_halo(stage, hi, lo);
    // the weights landed by cp.async are read by wgmma (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    compute_chunk<N>(hi, lo, stage + HALO, warp, lane, acc);
  }

  // epilogue: acc[mt][4 j + r] is the mma.m16n8k8 accumulator layout of
  // n8 tile j: pixel g (r < 2) or g + 8, output channel 8 j + 2 t + r % 2.
  // Per n8 tile, every residual and outer value is loaded before the first
  // store: loads behind each store of a possibly aliasing pointer wait out
  // a memory latency each (conv_4's epilogue took a fifth of its time so).
  const int y = y0 + warp;
  if (y >= a.h) return;
  const int g = lane >> 2, t = lane & 3;
  const float* __restrict__ res = a.res.p;
  const float* __restrict__ outer = a.outer.p;
  float* __restrict__ out = a.out;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    float v[2][MT][2], r[2][MT][2], q[2][MT][2];
    long long off[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = min(j * 8 + 2 * t + e, a.cout - 1);
      const float b = __ldg(a.bias + n);
      off[e] = (long long)n * a.out_cs + (long long)y * a.out_rs;
      const long long rrow = n * a.res.cs + (long long)y * a.res.rs;
      const long long qrow = n * a.outer.cs + (long long)y * a.outer.rs;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int x = min(x0 + mt * 16 + g + 8 * half, a.w - 1);
          float u = acc[mt][4 * j + 2 * half + e] + b;
          v[e][mt][half] = a.leaky && u <= 0.f ? u * 0.2f : u;
          r[e][mt][half] = res ? res[rrow + x] : 0.f;
          q[e][mt][half] = outer ? outer[qrow + x] : 0.f;
        }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (j * 8 + 2 * t + e >= a.cout) continue;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int x = x0 + mt * 16 + g + 8 * half;
          if (x >= a.w) continue;
          float u = v[e][mt][half];
          if (res) u = r[e][mt][half] + a.alpha * u;
          if (outer) u = q[e][mt][half] + a.beta * u;
          out[off[e] + x] = u;
        }
    }
  }
}

constexpr int MAX_DEVICES = 64;

template <int N>
int launch(const Args& a, cudaStream_t st) {
  auto kern = conv_implicit_gemm_kernel<N>;
  constexpr size_t bytes = Shape<N>::BYTES;
  // the shared-memory limit is set once per instance and device, not at
  // each of a frame's hundreds of launches
  static std::atomic<bool> ready[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES || !ready[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES) ready[dev].store(true, std::memory_order_release);
  }
  const dim3 grid((a.w + TW - 1) / TW, (a.h + TH - 1) / TH);
  kern<<<grid, THREADS, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// in:     [cin, hs, ws] f32 planes at in + c in_cs + y in_rs + x; pad 0
//         (the frame carries its own zero border: h = hs - 2, w = ws - 2)
//         or 1 (h = hs, w = ws); cin a multiple of 8
// wpk:    the packed weights of instance n (32 or 64 output columns),
//         16-byte aligned; bias: [cout]
// out:    [cout, h, w] at out + c out_cs + y out_rs + x
// res, outer: [cout, h, w] planes or null; leaky: 0 or 1
// out = ((v + bias) (leaky ReLU 0.2 if leaky), then res + alpha * (.) if
// res, then outer + beta * (.) if outer).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for shapes the kernel does not take (nothing is launched).
extern "C" int bim_conv3x3_tc(const float* in, long long in_cs,
                              long long in_rs, int hs, int ws, int pad,
                              const float* wpk, const float* bias, int cin,
                              int cout, int n, float* out, long long out_cs,
                              long long out_rs, int h, int w, int leaky,
                              const float* res, long long res_cs,
                              long long res_rs, float alpha,
                              const float* outer, long long outer_cs,
                              long long outer_rs, float beta, void* stream) {
  if (cin < KC || cin % KC || cout < 1 || cout > n ||
      (n != 32 && n != 64) || (pad != 0 && pad != 1) ||
      h != hs - 2 + 2 * pad || w != ws - 2 + 2 * pad || h < 1 || w < 1 ||
      (h + TH - 1) / TH > 65535 ||
      (reinterpret_cast<uintptr_t>(wpk) & 15))
    return (int)cudaErrorInvalidValue;
  // the dense blocks' buffers: bordered, rows and planes 16-byte aligned
  const int vec = pad == 0 && in_rs % 4 == 0 && in_cs % 4 == 0 &&
                  (reinterpret_cast<uintptr_t>(in) & 15) == 0;
  const Args a{{in, in_cs, in_rs}, hs, ws, pad, vec,
               reinterpret_cast<const float4*>(wpk), bias, cin, cout, out,
               out_cs, out_rs, h, w, leaky, {res, res_cs, res_rs},
               {outer, outer_cs, outer_rs}, alpha, beta};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return n == 64 ? launch<64>(a, st) : launch<32>(a, st);
}
