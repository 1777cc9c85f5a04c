// Column-phase interleave of packed-u32 planar frames, for Hopper (sm_90a).
//
// Replaces: bicubic_interpolation_model_tpu/ops/pallas_interleave.py
//           _interleave_kernel, the Pallas TPU kernel behind
//           interleave_planar_u32.
//
// Computes out[r][x * s + px] = in[px][r][x] for in [s, r, x] u32 — the
// RGBA32 HWC delivery of the fused tail's planar output (each word holds
// one pixel's channel bytes, little-endian).
//
// What bounds it on the H100: bytes. It does no arithmetic and moves each
// word once in and once out (22.7 MB for a 348x510 -> 4x RGBA frame,
// ~7 us at 3.35 TB/s). The design needs no shared memory: one thread per
// (r, x) reads its s words, one from each plane (a warp's reads of a plane
// are 32 consecutive words), and writes them as s consecutive output words
// (one 16-byte store when s = 4), so a warp's stores cover 32 * s
// consecutive words. Any r, x and s work, so the TPU kernel's divisor
// tiling is not needed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <int S>
__global__ void __launch_bounds__(THREADS)
interleave_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                  int s_rt, int r, int x) {
  const int s = S > 0 ? S : s_rt;
  const size_t idx = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (size_t)r * x) return;
  const size_t plane = (size_t)r * x;
  if constexpr (S == 4) {
    uint4 v;
    v.x = __ldg(in + idx);
    v.y = __ldg(in + plane + idx);
    v.z = __ldg(in + 2 * plane + idx);
    v.w = __ldg(in + 3 * plane + idx);
    reinterpret_cast<uint4*>(out)[idx] = v;
  } else {
    for (int px = 0; px < s; ++px)
      out[idx * s + px] = __ldg(in + px * plane + idx);
  }
}

}  // namespace

// in: [s, r, x] u32, out: [r, x * s] u32, both contiguous (16-byte aligned
// for s = 4), 1 <= s <= 16. Returns cudaGetLastError() after the launch.
extern "C" int bim_interleave_planar_u32(const uint32_t* in, uint32_t* out,
                                         int s, int r, int x, void* stream) {
  const size_t n = (size_t)r * x;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s == 4)
    interleave_kernel<4><<<blocks, THREADS, 0, st>>>(in, out, s, r, x);
  else
    interleave_kernel<0><<<blocks, THREADS, 0, st>>>(in, out, s, r, x);
  return (int)cudaGetLastError();
}
