// Fused adaptive bicubic at integer scales, for Hopper (sm_90a).
//
// Replaces: bicubic_interpolation_model_tpu/ops/pallas_adaptive.py
//           _adaptive_kernel, the Pallas TPU kernel behind
//           adaptive_resize_pallas.
//
// Computes, for a u8 image [b][h][w][c] (c = 3 or 4) and an integer scale s,
// every output pixel (r*s+q, x*s+p) as a normalised 16-tap sum over the LR
// pixels (r-1..r+2, x-1..x+2), clamped to the image:
//   weight(n,m) = E + (A - E) * F(n,m),  A = wy[r][q][n] * wx[p][m][x],
//                                        E = wye[r][q][n] * wxe[p][m][x]
// where wy/wx are the Keys weights at the clamped tap positions and wye/wxe
// the same weights where the clamped tap equals the clamped centre, else 0
// (host, float64: ops/adaptive_fused.row_vectors/col_vectors), and F is the
// modulation factor of the tap's luma distance d to the centre pixel
// (r + cy, x + cx), cy = (2q >= s), cx = (2p >= s), by the centre's class:
//   edge (5x5 luma variance > 50):  min(1.5, 1 + d/100)
//   flat (variance < 10):           max(0.5, 1 - d/30)
//   texture:                        0.8 + 0.4 exp(-d/20)
// Luma is BT.709 of the raw u8 channels; the variance window is clamped to
// the image and read at the clamped centre. The result is stored as
// clip(int(acc / wsum + 0.5), 0, 255).
// Layouts: interleaved HWC u8 [b][h*s][w*s][c], or column-phase planar u32
// words [b][s][h*s][w] (the c channel bytes of a pixel, little-endian).
//
// What bounds it on the H100: operations. A 1080x1920 RGBA frame at 4x moves
// 141 MB (~0.042 ms at 3.35 TB/s) but needs ~180 f32 operations per output
// pixel and ~650 per LR pixel, ~7.4 GFLOP (~0.11 ms at 67 TFLOP/s). The
// design keeps everything but the frame and the result out of device memory:
// a block owns 8 x 32 LR pixels, stages their pixel and luma windows (tile +
// 5, edge-replicated values) and the classes of the (tile + 1)^2 candidate
// centres in shared memory, then one thread per LR cell holds its 16 taps in
// registers, evaluates the 16 factors once per centre variant and walks the
// output phases of that variant. Output words are staged in shared memory
// so that the block stores whole rows of consecutive bytes: the whole
// (8s x 32s)-word tile in one pass while it fits (s <= 14), else in passes
// over qn row phases x pn column phases, so no scale is too large. The variance
// stage uses only correctly rounded intrinsics (no FMA contraction) in the
// plain version's order of summation, so both agree on every class.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TX = 32;             // LR columns per block
constexpr int TY = 8;              // LR rows per block
constexpr int WIN_X = TX + 5;      // window: 2 before, 3 after the tile
constexpr int WIN_Y = TY + 5;
constexpr int CEN_X = TX + 1;      // candidate centres: the tile and one more
constexpr int CEN_Y = TY + 1;
constexpr int SMEM_MAX = 232448;   // dynamic shared memory a block may ask for
constexpr int FIXED_WORDS = 2 * WIN_X * WIN_Y + CEN_X * CEN_Y;

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// PASSES: the tile is staged in several passes (qn x pn phases each);
// without it one pass stages all s x s phases and qn, pn are not read.
template <int C, bool OPAQUE, bool PASSES>
__global__ void __launch_bounds__(THREADS)
adaptive_kernel(const uint8_t* __restrict__ in, const float* __restrict__ wy,
                const float* __restrict__ wye, const float* __restrict__ wx,
                uint8_t* __restrict__ out, uint8_t* __restrict__ classes, int h, int w, int s,
                int qn, int pn, int planar) {
  constexpr int NC = OPAQUE ? 3 : C;  // channels that are summed
  extern __shared__ uint32_t smem[];
  uint32_t* s_pix = smem;                                          // [WIN_Y][WIN_X] packed
  float* s_lum = reinterpret_cast<float*>(smem + WIN_X * WIN_Y);   // [WIN_Y][WIN_X]
  int* s_cls = reinterpret_cast<int*>(smem + 2 * WIN_X * WIN_Y);   // [CEN_Y][CEN_X]
  uint32_t* s_out = smem + FIXED_WORDS;                            // [TY*qn][TX*pn] words

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TX, r0 = blockIdx.y * TY;
  const size_t b = blockIdx.z;
  const uint8_t* img = in + b * (size_t)h * w * C;

  // 1. pixel and luma windows, edge-replicated
  for (int e = tid; e < WIN_X * WIN_Y; e += THREADS) {
    const int gr = clampi(r0 - 2 + e / WIN_X, 0, h - 1);
    const int gc = clampi(x0 - 2 + e % WIN_X, 0, w - 1);
    const uint8_t* p = img + ((size_t)gr * w + gc) * C;
    uint32_t word;
    if (C == 4) {
      word = *reinterpret_cast<const uint32_t*>(p);
    } else {
      word = (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16);
    }
    s_pix[e] = word;
    const float r = (float)(word & 255u), g = (float)((word >> 8) & 255u),
                bl = (float)((word >> 16) & 255u);
    s_lum[e] = __fadd_rn(__fadd_rn(__fmul_rn(r, (float)0.2126), __fmul_rn(g, (float)0.7152)),
                         __fmul_rn(bl, (float)0.0722));
  }
  __syncthreads();

  // 2. class of each candidate centre, at the clamped centre position
  for (int e = tid; e < CEN_X * CEN_Y; e += THREADS) {
    const int rr = min(r0 + e / CEN_X, h - 1) - r0;   // window rows rr .. rr+4
    const int cc = min(x0 + e % CEN_X, w - 1) - x0;
    float sm = 0.f, sq = 0.f;
    for (int dy = 0; dy < 5; ++dy)
      for (int dx = 0; dx < 5; ++dx) {
        const float v = s_lum[(rr + dy) * WIN_X + cc + dx];
        sm = __fadd_rn(sm, v);
        sq = __fadd_rn(sq, __fmul_rn(v, v));
      }
    const float var = __fdiv_rn(__fsub_rn(sq, __fdiv_rn(__fmul_rn(sm, sm), 25.f)), 25.f);
    s_cls[e] = var > 50.f ? 2 : (var < 10.f ? 1 : 0);
  }
  __syncthreads();

  // 3. one thread per LR cell; a pass covers row phases q0..q1 and column
  //    phases p0..p1 of every cell (one pass when the whole tile fits)
  const int ly = tid / TX, lx = tid % TX;
  const int r = r0 + ly, x = x0 + lx;
  const bool active = r < h && x < w;
  const int ho = h * s, wo = w * s;
  const int split = (s + 1) / 2;   // first phase whose centre variant is 1
  float pix[4][4][NC];
  if (active) {
    if (classes != nullptr)
      classes[(b * h + r) * (size_t)w + x] = (uint8_t)s_cls[ly * CEN_X + lx];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const uint32_t word = s_pix[(ly + 1 + n) * WIN_X + lx + 1 + m];
#pragma unroll
        for (int ch = 0; ch < NC; ++ch) pix[n][m][ch] = (float)((word >> (8 * ch)) & 255u);
      }
  }
  const float* wyr = wy + (size_t)r * 4 * s;
  const float* wyer = wye + (size_t)r * 4 * s;
  const float* wxe = wx + (size_t)4 * s * w;
  for (int qv = 0; qv < s; qv += qn)
    for (int pv = 0; pv < s; pv += pn) {
      const int q0 = PASSES ? qv : 0, p0 = PASSES ? pv : 0;
      const int q1 = PASSES ? min(q0 + qn, s) : s, p1 = PASSES ? min(p0 + pn, s) : s;
      const int qc = q1 - q0, pc = p1 - p0;
      const int rows_o = TY * qc, cols_o = TX * pc;   // the staged tile
      if (active) {
        for (int cy = 0; cy < 2; ++cy) {
          const int qa = max(cy ? split : 0, q0), qb = min(cy ? s : split, q1);
          for (int cx = 0; cx < 2 && qa < qb; ++cx) {
            const int pa = max(cx ? split : 0, p0), pb = min(cx ? s : split, p1);
            if (pa >= pb) continue;
            const float cl = s_lum[(ly + 2 + cy) * WIN_X + lx + 2 + cx];
            const int cls = s_cls[(ly + cy) * CEN_X + lx + cx];
            float f[4][4];
#pragma unroll
            for (int n = 0; n < 4; ++n)
#pragma unroll
              for (int m = 0; m < 4; ++m) {
                const float d = fabsf(cl - s_lum[(ly + 1 + n) * WIN_X + lx + 1 + m]);
                if (cls == 2)
                  f[n][m] = fminf(1.5f, 1.f + d * 0.01f);
                else if (cls == 1)
                  f[n][m] = fmaxf(0.5f, 1.f - d * (1.f / 30.f));
                else
                  f[n][m] = 0.8f + 0.4f * expf(d * -0.05f);
              }
            for (int q = qa; q < qb; ++q) {
              float wyv[4], wyev[4];
#pragma unroll
              for (int n = 0; n < 4; ++n) {
                wyv[n] = __ldg(wyr + q * 4 + n);
                wyev[n] = __ldg(wyer + q * 4 + n);
              }
              for (int p = pa; p < pb; ++p) {
                float wxv[4], wxev[4];
#pragma unroll
                for (int m = 0; m < 4; ++m) {
                  wxv[m] = __ldg(wx + (size_t)(p * 4 + m) * w + x);
                  wxev[m] = __ldg(wxe + (size_t)(p * 4 + m) * w + x);
                }
                float wsum = 0.f, acc[NC];
#pragma unroll
                for (int ch = 0; ch < NC; ++ch) acc[ch] = 0.f;
#pragma unroll
                for (int n = 0; n < 4; ++n)
#pragma unroll
                  for (int m = 0; m < 4; ++m) {
                    const float av = wyv[n] * wxv[m], ev = wyev[n] * wxev[m];
                    const float wgt = fmaf(av - ev, f[n][m], ev);
                    wsum += wgt;
#pragma unroll
                    for (int ch = 0; ch < NC; ++ch) acc[ch] = fmaf(wgt, pix[n][m][ch], acc[ch]);
                  }
                const float rec = __frcp_rn(wsum);
                uint32_t word = OPAQUE ? 0xff000000u : 0u;
#pragma unroll
                for (int ch = 0; ch < NC; ++ch) {
                  const int v = (int)(acc[ch] * rec + 0.5f);   // round half up
                  word |= (uint32_t)min(max(v, 0), 255) << (8 * ch);
                }
                s_out[(ly * qc + q - q0) * cols_o + lx * pc + p - p0] = word;
              }
            }
          }
        }
      }
      __syncthreads();

      // 4. store the staged rows: a warp takes a row, its lanes consecutive
      //    bytes. Staged row sr is output row (r0 + sr/qc)*s + q0 + sr%qc,
      //    staged column sc is output column (x0 + sc/pc)*s + p0 + sc%pc,
      //    which is x0*s + sc when a pass holds whole rows (pc = s).
      const int warp = tid / 32, lane = tid % 32;
      if (planar) {
        uint32_t* o32 = reinterpret_cast<uint32_t*>(out);
        const int gx = x0 + lane;   // TX lanes: one LR column each
        for (int k = warp; k < pc * rows_o; k += THREADS / 32) {
          const int dp = k / rows_o, sr = k - dp * rows_o;
          const int gr = (r0 + sr / qc) * s + q0 + sr % qc;
          if (gr < ho && gx < w)
            o32[((b * s + p0 + dp) * ho + gr) * (size_t)w + gx] =
                s_out[sr * cols_o + lane * pc + dp];
        }
      } else {
        for (int sr = warp; sr < rows_o; sr += THREADS / 32) {
          const int gr = (r0 + sr / qc) * s + q0 + sr % qc;
          if (gr >= ho) continue;
          const uint32_t* srow = s_out + sr * cols_o;
          if (C == 4) {
            uint32_t* orow = reinterpret_cast<uint32_t*>(out) + (b * ho + gr) * (size_t)wo;
            for (int sc = lane; sc < cols_o; sc += 32) {
              const int gc = !PASSES || pc == s ? x0 * s + sc : (x0 + sc / pc) * s + p0 + sc % pc;
              if (gc < wo) orow[gc] = srow[sc];
            }
          } else {
            uint8_t* orow = out + (b * ho + gr) * (size_t)wo * C;
            for (int bcol = lane; bcol < cols_o * C; bcol += 32) {
              const int sc = bcol / C, ch = bcol - sc * C;
              const int gc = !PASSES || pc == s ? x0 * s + sc : (x0 + sc / pc) * s + p0 + sc % pc;
              if (gc < wo) orow[gc * C + ch] = (uint8_t)(srow[sc] >> (8 * ch));
            }
          }
        }
      }
      if (!PASSES) return;
      __syncthreads();   // the next pass reuses the tile
    }
}

template <int C, bool OPAQUE, bool PASSES>
int launch_passes(const uint8_t* in, const float* wy, const float* wye, const float* wx,
                  uint8_t* out, uint8_t* classes, int b, int h, int w, int s, int planar, int qn,
                  int pn, cudaStream_t st) {
  const size_t smem = sizeof(uint32_t) * ((size_t)FIXED_WORDS + (size_t)TY * qn * TX * pn);
  auto kern = adaptive_kernel<C, OPAQUE, PASSES>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((w + TX - 1) / TX, (h + TY - 1) / TY, b);
  kern<<<grid, THREADS, smem, st>>>(in, wy, wye, wx, out, classes, h, w, s, qn, pn, planar);
  return (int)cudaGetLastError();
}

template <int C, bool OPAQUE>
int launch(const uint8_t* in, const float* wy, const float* wye, const float* wx, uint8_t* out,
           uint8_t* classes, int b, int h, int w, int s, int planar, int stage, cudaStream_t st) {
  // phases staged per pass: all s x s while the tile fits, else whole rows
  // of column phases, else a run of column phases of one row phase
  int fit = (SMEM_MAX / (int)sizeof(uint32_t) - FIXED_WORDS) / (TY * TX);
  if (stage > 0 && stage < fit) fit = stage;
  int qn = s, pn = s;
  if ((long long)s * s > fit) {
    pn = s < fit ? s : fit;
    qn = fit / pn;
  }
  if (qn == s && pn == s)
    return launch_passes<C, OPAQUE, false>(in, wy, wye, wx, out, classes, b, h, w, s, planar, qn,
                                           pn, st);
  return launch_passes<C, OPAQUE, true>(in, wy, wye, wx, out, classes, b, h, w, s, planar, qn, pn,
                                        st);
}

}  // namespace

// in:      [b, h, w, c] u8, contiguous, c = 3 or 4
// wy, wye: [h, 4*s] f32;  wx: [8*s, w] f32 (wx over wx*eqx)
// out:     planar ? u32 [b, s, h*s, w] : u8 [b, h*s, w*s, c], 4-byte aligned
// classes: null, or u8 [b, h, w] receiving each LR pixel's class
//          (0 texture, 1 flat, 2 edge)
// opaque:  c = 4 only: alpha is written as 255 and not summed
// stage:   0, or the most (row phase, column phase) pairs of the tile to
//          stage per pass, below what shared memory holds (for checks of the
//          passes that large scales take)
// Returns cudaGetLastError() after the launch.
extern "C" int bim_adaptive_resize(const uint8_t* in, const float* wy, const float* wye,
                                   const float* wx, uint8_t* out, uint8_t* classes, int b, int h,
                                   int w, int c, int s, int planar, int opaque, int stage,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c == 4)
    return opaque ? launch<4, true>(in, wy, wye, wx, out, classes, b, h, w, s, planar, stage, st)
                  : launch<4, false>(in, wy, wye, wx, out, classes, b, h, w, s, planar, stage, st);
  if (c == 3) return launch<3, false>(in, wy, wye, wx, out, classes, b, h, w, s, planar, stage, st);
  return (int)cudaErrorInvalidValue;
}
