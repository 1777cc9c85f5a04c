// Dense linears y = x W + bias, with an epilogue applied as the tile is
// stored, as one GEMM on the tensor cores, for Hopper (sm_90a).
//
// Replaces: no TPU kernel. The JAX package left its matrix products to
// XLA; the port's linears ran on cuBLAS, whose f32 route (TF32 off) runs
// on the CUDA cores only. This kernel serves every linear of SwinIR's
// no-grad f32 step (models/swinir.py, through ops/linear_tc.py): per Swin
// block qkv (180 -> 540), proj (180 -> 180, + the block's residual), fc1
// (180 -> 360, exact GELU) and fc2 (360 -> 180, + the residual), on the
// 176,128 tokens of a 344x512 grid.
//
// y[M, N] = x[M, K] W[K, N] + bias, x and the output row-major; then
//   mode 0  y
//   mode 1  y * 0.5 * (1 + erf(y / sqrt 2)): F.gelu's exact form
//   mode 2  res + y; out may be res (each element is read, then written,
//           by the same thread)
//
// What bounds it on the H100: operations. An output takes K = 180 or 360
// products against 8-12 bytes moved, so products at f32 accuracy are the
// limit. They run as 3xTF32 on wgmma, as in conv3x3_tc.cu: each operand
// split into x = hi + lo, both rounded to the nearest TF32 value, and
// lo*hi + hi*lo + hi*hi summed (lo*lo, 2^-22 relative, dropped). The
// tensor cores truncate their sums, so each stage's 32 k go to a fresh
// accumulator, added to the output's f32 sum by one FADD.
//
// Design:
// - A block computes a tile of 128 rows x 184 columns (BN): two
//   warpgroups, each an m64 x 184 tile by wgmma m64n184k8 tf32, A from
//   registers (the warp's 16 rows), B from shared memory (wgmma_tf32.cuh's
//   layout). N = 540, 360 and 180 take 3, 2 and 1 tiles (2.2% of the
//   columns padding, computed and never stored). Column tiles run
//   fastest, so the blocks at work share their rows of x in L2. (Tiles of
//   96 to 136 columns were as fast at best, and up to 18% slower.)
// - K runs in stages of KC = 32: a stage's A tile (128 x 32) and its packed
//   B (4 k8 steps x hi, lo x 184 columns, ops/linear_tc.pack) arrive by
//   cp.async in a ring of 3, two stages ahead of the one computed. Columns
//   of x past K are zero-filled by the copy (K = 180 is no multiple of 8);
//   the packed B is zero there. The bytes in device memory are read as
//   they are.
// - The ring's slots are handed over by mbarriers (full: every thread's
//   copies of the stage landed; empty: both warpgroups are done with it)
//   and not by a barrier of the whole block, so neither warpgroup waits
//   at each stage for the other's slowest warp: 2-8% faster than one
//   __syncthreads a stage.
// - Within a stage the k order is permuted: k8 step s, fragment column kk
//   (0..7) reads column 16 (s / 2) + 4 (kk % 4) + 2 (s % 2) + kk / 4 of the
//   stage, so a thread's fragments of all four steps are two 16-byte loads
//   a row. Odd rows store their two 64-byte halves swapped, so the loads
//   of 8 lanes hit 32 distinct banks. Each element is split into hi and lo
//   in registers, once.
// - Epilogue, from the accumulators straight to device memory: + bias
//   (from shared memory), then GELU or the residual, whose values are all
//   loaded before the first store (loads behind stores to a possibly
//   aliasing pointer each wait out a memory latency).
// - Where the time goes (qkv's shape): without its products the kernel
//   still takes two thirds of its time (the copies of x and of the packed
//   B, about 1.5 GB from L2, and the stores), without its copies five
//   sixths; the two overlap in part. Issuing a stage's products before
//   the previous stage's sum is taken (a second accumulator at 96
//   columns, or no fresh sums at all) was no faster, and with no fresh
//   sums the error grew 5-9x.
// Offsets are 64-bit.

#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <stdint.h>

#include "tail_mma.cuh"
#include "wgmma_tf32.cuh"

namespace {

using tail_mma::cp_async16;
using wgmma_tf32::b_desc;
using wgmma_tf32::keep;
using wgmma_tf32::tf32_rn;
using wgmma_tf32::wg_commit;
using wgmma_tf32::wg_fence;
using wgmma_tf32::wg_wait;
using wgmma_tf32::Wgmma;

constexpr int THREADS = 256;           // two warpgroups
constexpr int BM = 128, BN = 184;       // the tile: m64 x BN a warpgroup
constexpr int KC = 32;                  // k a stage
constexpr int STEPS = KC / 8;           // k8 steps a stage
constexpr int STAGES = 3;               // the ring
constexpr float SQRT1_2 = 0.70710678118654752440f;
// shared memory, in floats: a stage's A tile, its packed B (hi, lo), the
// ring, then the tile's bias; then a full and an empty mbarrier a stage
constexpr int A_TILE = BM * KC;
constexpr int B_TILE = STEPS * 2 * 8 * BN;
constexpr int STAGE = A_TILE + B_TILE;
constexpr size_t BARS = sizeof(float) * (size_t(STAGES) * STAGE + BN);
constexpr size_t SMEM_BYTES = BARS + 2 * 8 * STAGES;
static_assert(A_TILE == 16 * THREADS, "four 16-byte A copies a thread");
static_assert(BARS % 8 == 0, "mbarriers are 8 bytes");
static_assert(SMEM_BYTES <= 232448, "shared memory a block may use");

struct Args {
  const float* x;
  long long ldx;
  const float4* wpk;        // packed weights (ops/linear_tc.pack)
  const float* bias;
  int m, k, n;
  int n_pad, col_tiles;     // n_pad = col_tiles * BN
  float* out;
  long long ldo;
  const float* res;         // mode 2 only
  long long ldr;
  int mode;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// until the barrier's phase of parity `parity` has completed (the loop
// inside the asm: ptxas sees no branch that warps of a warpgroup could
// take apart before their wgmma)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// arrive on the barrier once this thread's cp.async copies so far landed
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// The A positions a thread copies in every stage (8 copies a row):
// offset in x of the row and column (-1: the row lies past M), offset in
// the stage, column in the stage.
struct ACopies {
  long long goff[4];
  int soff[4], col[4];
};

// Stage `chunk` (k 32 chunk ..) into `stage`: the block's A rows, zero past
// M and K, and the chunk's packed B of the block's columns.
__device__ __forceinline__ void load_stage(const Args& a, const ACopies& c,
                                           float* stage, int chunk, int n0) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool ok = c.goff[i] >= 0 && chunk * KC + c.col[i] < a.k;
    const float* src = ok ? a.x + c.goff[i] + chunk * KC : a.x;
    cp_async16(stage + c.soff[i], src, ok);
  }
  // per k8 step and part (hi, lo) the packed B holds n_pad x 8 floats;
  // the block's BN columns of it are contiguous
  float4* dst = reinterpret_cast<float4*>(stage + A_TILE);
  const float4* src = a.wpk + (size_t)chunk * STEPS * 2 * 2 * a.n_pad +
                      (size_t)n0 * 2;
  for (int i = threadIdx.x; i < B_TILE / 4; i += THREADS) {
    const int part = i / (2 * BN);
    cp_async16(dst + i,
               src + (size_t)part * 2 * a.n_pad + (i - part * 2 * BN), true);
  }
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rn(x);
  lo = tf32_rn(x - __uint_as_float(hi));
}

__global__ void __launch_bounds__(THREADS, 1)
    linear_xmma_gemm_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sbias = smem + STAGES * STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<char*>(smem4) + BARS);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ct = blockIdx.x % a.col_tiles;
  const long long m0 = (long long)(blockIdx.x / a.col_tiles) * BM;
  const int n0 = ct * BN;
  const int n_chunks = (a.k + KC - 1) / KC;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, THREADS);
      mbar_init(empty + s, THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < BN; i += THREADS)
    sbias[i] = n0 + i < a.n ? a.bias[n0 + i] : 0.f;
  __syncthreads();

  ACopies c;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = tid + i * THREADS, r = p >> 3, j = p & 7;
    c.goff[i] = m0 + r < a.m ? (m0 + r) * a.ldx + 4 * j : -1;
    c.soff[i] = r * KC + ((j ^ ((r & 1) << 2)) << 2);
    c.col[i] = 4 * j;
  }
  // stage q goes to slot q % STAGES, its fill q / STAGES of the slot
  auto produce = [&](int q) {
    const int slot = q % STAGES, fill = q / STAGES;
    if (fill > 0) mbar_wait(empty + slot, (fill - 1) & 1);
    load_stage(a, c, smem + slot * STAGE, q, n0);
    mbar_arrive_copies(full + slot);
  };
  for (int q = 0; q < STAGES - 1 && q < n_chunks; ++q) produce(q);

  float acc[BN / 2], d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  // this warp's rows g and g + 8 of the block's tile
  const int row = (warp >> 2) * 64 + (warp & 3) * 16 + g;

  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + STAGES - 1 < n_chunks) produce(ch + STAGES - 1);
    const int slot = ch % STAGES;
    mbar_wait(full + slot, (ch / STAGES) & 1);
    // B landed by cp.async is read by wgmma (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const float* sa = smem + slot * STAGE;
    const float* sb = sa + A_TILE;

    // A fragments of the four k8 steps: [0] row g, [1] row g + 8 at
    // fragment column t; [2], [3] at t + 4
    uint32_t ah[STEPS][4], al[STEPS][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h, sw = (r & 1) << 2;
      const float4 u = *reinterpret_cast<const float4*>(
          sa + r * KC + ((t ^ sw) << 2));
      const float4 v = *reinterpret_cast<const float4*>(
          sa + r * KC + (((t + 4) ^ sw) << 2));
      split(u.x, ah[0][h], al[0][h]);
      split(u.y, ah[0][2 + h], al[0][2 + h]);
      split(u.z, ah[1][h], al[1][h]);
      split(u.w, ah[1][2 + h], al[1][2 + h]);
      split(v.x, ah[2][h], al[2][h]);
      split(v.y, ah[2][2 + h], al[2][2 + h]);
      split(v.z, ah[3][h], al[3][h]);
      split(v.w, ah[3][2 + h], al[3][2 + h]);
    }
    // a step whose first column lies past K holds zeros only
    const int rem = a.k - ch * KC;
    wg_fence();
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      if (s > 0 && 16 * (s >> 1) + 2 * (s & 1) >= rem) continue;
      const uint64_t bh = b_desc(sb + (2 * s) * 8 * BN);
      const uint64_t bl = b_desc(sb + (2 * s + 1) * 8 * BN);
      Wgmma<BN>::run(d, al[s], bh, s != 0);
      Wgmma<BN>::run(d, ah[s], bl, 1);
      Wgmma<BN>::run(d, ah[s], bh, 1);
    }
    wg_commit();
    wg_wait<0>();        // the stage's products are done: d is final
    keep(d);
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      keep(ah[s]);
      keep(al[s]);
    }
    mbar_arrive(empty + slot);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += d[i];
  }

  // epilogue: acc[4 j + 2 h + e] is row g + 8 h, column 8 j + 2 t + e of
  // the tile (wgmma's accumulator layout); N is even, so a column pair is
  // stored whole or not at all
  const long long r0 = m0 + row;
  float rv[BN / 8][4];
  if (a.mode == 2) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long r = r0 + 8 * h;
        float2 v = make_float2(0.f, 0.f);
        if (r < a.m && n < a.n)
          v = *reinterpret_cast<const float2*>(a.res + r * a.ldr + n);
        rv[j][2 * h] = v.x;
        rv[j][2 * h + 1] = v.y;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * t, n = n0 + c;
    if (n >= a.n) continue;
    const float b0 = sbias[c], b1 = sbias[c + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long r = r0 + 8 * h;
      if (r >= a.m) continue;
      float v0 = acc[4 * j + 2 * h] + b0, v1 = acc[4 * j + 2 * h + 1] + b1;
      if (a.mode == 1) {
        v0 = v0 * 0.5f * (1.f + erff(v0 * SQRT1_2));
        v1 = v1 * 0.5f * (1.f + erff(v1 * SQRT1_2));
      } else if (a.mode == 2) {
        v0 = rv[j][2 * h] + v0;
        v1 = rv[j][2 * h + 1] + v1;
      }
      *reinterpret_cast<float2*>(a.out + r * a.ldo + n) = make_float2(v0, v1);
    }
  }
}

constexpr int MAX_DEVICES = 64;

int launch(const Args& a, cudaStream_t st) {
  // the shared-memory limit is set once per device, not at each of a
  // frame's 144 launches
  static std::atomic<bool> ready[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES || !ready[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(linear_xmma_gemm_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES) ready[dev].store(true, std::memory_order_release);
  }
  const long long blocks = (long long)((a.m + BM - 1) / BM) * a.col_tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  linear_xmma_gemm_kernel<<<(unsigned)blocks, THREADS, SMEM_BYTES, st>>>(a);
  return (int)cudaGetLastError();
}

bool misaligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes != 0;
}

}  // namespace

// x:    [m, k] f32 rows at x + r ldx; k a multiple of 4, x and ldx 16-byte
//       aligned
// wpk:  the packed weights of [k, n] for tiles of bn columns
//       (ops/linear_tc.pack), 16-byte aligned; bias: [n]
// out:  [m, n] rows at out + r ldo; n even; res: [m, n] rows at res + r ldr
//       (mode 2 only; out may be res)
// bn:   the columns of a tile that wpk was packed for: 184
// out = mode 0: x W + bias; 1: GELU(x W + bias); 2: res + (x W + bias).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for shapes the kernel does not take (nothing is launched).
extern "C" int bim_linear_tc(const float* x, long long ldx, const float* wpk,
                             const float* bias, int m, int k, int n, int bn,
                             float* out, long long ldo, const float* res,
                             long long ldr, int mode, void* stream) {
  if (m < 1 || k < 4 || k % 4 || n < 2 || n % 2 || bn != BN || ldx < k ||
      ldx % 4 || ldo < n || ldo % 2 || mode < 0 || mode > 2 ||
      (mode == 2) != (res != nullptr) ||
      (res != nullptr && (ldr < n || ldr % 2 || misaligned(res, 8))) ||
      misaligned(x, 16) || misaligned(wpk, 16) || misaligned(out, 8))
    return (int)cudaErrorInvalidValue;
  const int col_tiles = (n + bn - 1) / bn;
  const Args a{x, ldx, reinterpret_cast<const float4*>(wpk), bias, m, k, n,
               col_tiles * bn, col_tiles, out, ldo, res, ldr, mode};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch(a, st);
}
