// Fused adaptive bicubic at integer scales, for Hopper (sm_90a).
//
// Replaces: bicubic_interpolation_model_tpu/ops/pallas_adaptive.py
//           _adaptive_kernel, the Pallas TPU kernel behind
//           adaptive_resize_pallas.
//
// Computes, for a u8 image [b][h][w][c] (c = 1 to 4) and an integer scale s,
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
// Luma is BT.709 of the raw u8 channels, channel min(i, c-1) standing in
// for channel i of a frame with fewer than 3 (as the JAX package's clamped
// indexing reads them); the variance window is clamped to the image and
// read at the clamped centre. The result is stored as
// clip(int(acc / wsum + 0.5), 0, 255).
// Layouts: interleaved HWC u8 [b][h*s][w*s][c], or column-phase planar u32
// words [b][s][h*s][w] (the c channel bytes of a pixel, little-endian, 0
// above them).
//
// What bounds it on the H100: operations. A 1080x1920 RGBA frame at 4x moves
// 141 MB (~0.042 ms at 3.35 TB/s); its f32 work is what sets the pace, so the
// design spends its effort on the operations per output pixel.
// - The sum is factored per centre variant. Inside one variant (cy, cx) the
//   16 factors F are fixed, so per row phase q a thread forms a = wy[n]*F,
//   the column sums u[m][ch] = sum_n a*pix and us[m] = sum_n a, and per
//   column phase p only acc[ch] = sum_m wx[m]*u[m][ch] and wsum = sum_m
//   wx[m]*us[m]: at s = 4 about half the multiply-adds of summing 16 taps
//   per output pixel. The exemption folds into one term: a tap with E != 0
//   is the clamped centre itself, so d = 0 and F = F(0) there (1 for edge
//   and flat, 1.2 for texture), and sum E*(1-F)*pix = (1 - F(0)) * pix_c *
//   (sum_n wye[n]) * (sum_m wxe[m]), added for texture centres only.
//   tests/test_torch_adaptive_factored.py emulates this order on the CPU.
// - Edge and flat share one law, min(1.5, max(0.5, 1 + k*d)) with k = 1/100
//   or -1/30; texture takes ex2.approx. The reciprocal is rcp.approx and
//   the rounding a clamp and a round-down add of 2^23 (no float-to-int
//   conversions, which issue at a quarter of the FMA rate).
// - The weights of a pass (wy/wye for the block's TY rows, wx/wxe for its
//   TX columns) are staged in shared memory once per block, by cp.async
//   issued before the windows are loaded, so their latency overlaps the
//   window and class stages.
// - Output words are staged in shared memory with one padding word per 32
//   (conflict-free for a warp writing at stride pc = 2, 4, 8, 16) and the
//   block stores whole rows: RGBA rows as 16-byte vectors. The whole
//   (8s x 32s)-word tile goes in one pass while it fits (s <= 14), else in
//   passes over qn row phases x pn column phases, so no scale is too large.
// A block owns 8 x 32 LR pixels and stages their pixel and luma windows
// (tile + 5, edge-replicated values) and the classes of the (tile + 1)^2
// candidate centres in shared memory; one thread per LR cell holds its 16
// taps in registers. The variance stage uses only correctly rounded
// intrinsics (no FMA contraction) in the plain version's order of
// summation, so both agree on every class.

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
// windows and classes, rounded up to whole 16-byte groups
constexpr int FIXED_WORDS = (2 * WIN_X * WIN_Y + CEN_X * CEN_Y + 3) & ~3;
// 1 - F(0) of a texture centre, in the plain version's f32 arithmetic
constexpr float TEXTURE_CENTRE = 1.f - (0.8f + 0.4f);

__host__ __device__ constexpr int padded(int col) { return col + (col >> 5); }

// shared-memory words of a pass over qn row phases x pn column phases:
// windows and classes, the pass's weights, the padded output tile
__host__ __device__ inline size_t pass_words(int qn, int pn) {
  return FIXED_WORDS + 8 * ((size_t)TY * qn + (size_t)TX * pn) +
         (size_t)TY * qn * padded(TX * pn);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// clip(trunc(acc * rec + 0.5), 0, 255) in the low byte of the result (the
// float bits of 2^23 + the value: the sum rounded down is that integer)
__device__ __forceinline__ uint32_t round_byte(float acc, float rec) {
  const float y = fminf(fmaxf(fmaf(acc, rec, 0.5f), 0.f), 255.f);
  return __float_as_uint(__fadd_rd(y, 8388608.f));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

// Start the async copies of a pass's weights (row phases q0.., column
// phases p0..): wy/wye of the block's LR rows, wx/wxe of its LR columns
// (edge copies past the image, never read).
__device__ void stage_weights(const float* wy, const float* wye, const float* wx, const float* wxe,
                              float* s_wy, float* s_wye, float* s_wx, float* s_wxe, int r0, int x0,
                              int h, int w, int s, int q0, int qc, int p0, int pc) {
  for (int e = threadIdx.x; e < TY * qc * 4; e += THREADS) {
    const size_t g = (size_t)min(r0 + e / (qc * 4), h - 1) * 4 * s + q0 * 4 + e % (qc * 4);
    cp_async4(s_wy + e, wy + g);
    cp_async4(s_wye + e, wye + g);
  }
  for (int e = threadIdx.x; e < pc * 4 * TX; e += THREADS) {
    const size_t g = (size_t)(p0 * 4 + e / TX) * w + min(x0 + e % TX, w - 1);
    cp_async4(s_wx + e, wx + g);
    cp_async4(s_wxe + e, wxe + g);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// PASSES: the tile is staged in several passes (qn x pn phases each);
// without it one pass stages all s x s phases (qn = pn = s).
template <int C, bool OPAQUE, bool PASSES>
__global__ void __launch_bounds__(THREADS, 2)
adaptive_kernel(const uint8_t* __restrict__ in, const float* __restrict__ wy,
                const float* __restrict__ wye, const float* __restrict__ wx,
                uint8_t* __restrict__ out, uint8_t* __restrict__ classes, int h, int w, int s,
                int qn, int pn, int planar) {
  constexpr int NC = OPAQUE ? 3 : C;  // channels that are summed
  extern __shared__ uint4 smem_raw[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem_raw);
  uint32_t* s_pix = smem;                                          // [WIN_Y][WIN_X] packed
  float* s_lum = reinterpret_cast<float*>(smem + WIN_X * WIN_Y);   // [WIN_Y][WIN_X]
  int* s_cls = reinterpret_cast<int*>(smem + 2 * WIN_X * WIN_Y);   // [CEN_Y][CEN_X]
  float* s_wy = reinterpret_cast<float*>(smem + FIXED_WORDS);      // [TY][qn][4]
  float* s_wye = s_wy + TY * qn * 4;                               // [TY][qn][4]
  float* s_wx = s_wye + TY * qn * 4;                               // [pn][4][TX]
  float* s_wxe = s_wx + pn * 4 * TX;                               // [pn][4][TX]
  uint32_t* s_out = reinterpret_cast<uint32_t*>(s_wxe + pn * 4 * TX);  // [TY*qn][padded]

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TX, r0 = blockIdx.y * TY;
  const size_t b = blockIdx.z;
  const uint8_t* img = in + b * (size_t)h * w * C;
  const float* wxe = wx + (size_t)4 * s * w;
  // the first pass's weights arrive while the windows and classes are made
  stage_weights(wy, wye, wx, wxe, s_wy, s_wye, s_wx, s_wxe, r0, x0, h, w, s, 0, qn, 0, pn);

  // 1. pixel and luma windows, edge-replicated
  for (int e = tid; e < WIN_X * WIN_Y; e += THREADS) {
    const int gr = clampi(r0 - 2 + e / WIN_X, 0, h - 1);
    const int gc = clampi(x0 - 2 + e % WIN_X, 0, w - 1);
    const uint8_t* p = img + ((size_t)gr * w + gc) * C;
    // the pixel's C bytes, and no byte past them
    uint32_t word;
    if constexpr (C == 4) {
      word = *reinterpret_cast<const uint32_t*>(p);
    } else {
      word = p[0];
#pragma unroll
      for (int ch = 1; ch < C; ++ch) word |= (uint32_t)p[ch] << (8 * ch);
    }
    s_pix[e] = word;
    // channel min(i, C-1) for i = 0, 1, 2
    constexpr int CH_G = C > 1 ? 1 : C - 1, CH_B = C > 2 ? 2 : C - 1;
    const float r = (float)(word & 255u), g = (float)((word >> (8 * CH_G)) & 255u),
                bl = (float)((word >> (8 * CH_B)) & 255u);
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
  for (int q0 = 0; q0 < s; q0 += qn)
    for (int p0 = 0; p0 < s; p0 += pn) {
      const int q1 = min(q0 + qn, s), p1 = min(p0 + pn, s);
      const int qc = q1 - q0, pc = p1 - p0;
      const int rows_o = TY * qc, cols_o = TX * pc;   // the staged tile
      const int stride = padded(cols_o);

      if (q0 > 0 || p0 > 0)   // the first pass's weights are on their way
        stage_weights(wy, wye, wx, wxe, s_wy, s_wye, s_wx, s_wxe, r0, x0, h, w, s, q0, qc, p0, pc);
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();

      if (active) {
#pragma unroll
        for (int cy = 0; cy < 2; ++cy) {
          const int qa = max(cy ? split : 0, q0), qb = min(cy ? s : split, q1);
          if (qa >= qb) continue;
#pragma unroll
          for (int cx = 0; cx < 2; ++cx) {
            const int pa = max(cx ? split : 0, p0), pb = min(cx ? s : split, p1);
            if (pa >= pb) continue;
            const float cl = s_lum[(ly + 2 + cy) * WIN_X + lx + 2 + cx];
            const int cls = s_cls[(ly + cy) * CEN_X + lx + cx];
            const bool texture = cls == 0;
            float f[4][4];
            if (texture) {
#pragma unroll
              for (int n = 0; n < 4; ++n)
#pragma unroll
                for (int m = 0; m < 4; ++m) {
                  const float d = fabsf(cl - s_lum[(ly + 1 + n) * WIN_X + lx + 1 + m]);
                  // exp(-d/20) = 2^(-d/20 * log2(e))
                  f[n][m] = fmaf(0.4f, ex2_approx(d * (-0.05f * 1.44269504f)), 0.8f);
                }
            } else {
              const float k = cls == 2 ? 0.01f : -(1.f / 30.f);
#pragma unroll
              for (int n = 0; n < 4; ++n)
#pragma unroll
                for (int m = 0; m < 4; ++m) {
                  const float d = fabsf(cl - s_lum[(ly + 1 + n) * WIN_X + lx + 1 + m]);
                  f[n][m] = fminf(1.5f, fmaxf(0.5f, fmaf(d, k, 1.f)));
                }
            }
            for (int q = qa; q < qb; ++q) {
              const int qr = (ly * qc + q - q0) * 4;
              const float4 wq = *reinterpret_cast<const float4*>(s_wy + qr);
              const float wyq[4] = {wq.x, wq.y, wq.z, wq.w};
              // per column tap m: the rows' sum of a * pix and of a
              float u[4][NC], us[4];
#pragma unroll
              for (int m = 0; m < 4; ++m) {
                float a = wyq[0] * f[0][m];
                us[m] = a;
#pragma unroll
                for (int ch = 0; ch < NC; ++ch) u[m][ch] = a * pix[0][m][ch];
#pragma unroll
                for (int n = 1; n < 4; ++n) {
                  a = wyq[n] * f[n][m];
                  us[m] += a;
#pragma unroll
                  for (int ch = 0; ch < NC; ++ch) u[m][ch] = fmaf(a, pix[n][m][ch], u[m][ch]);
                }
              }
              float tq = 0.f;
              if (texture) {
                const float4 we = *reinterpret_cast<const float4*>(s_wye + qr);
                tq = TEXTURE_CENTRE * (((we.x + we.y) + we.z) + we.w);
              }
              for (int p = pa; p < pb; ++p) {
                const float* wxp = s_wx + (p - p0) * 4 * TX + lx;
                float acc[NC], wsum;
                {
                  const float w0 = wxp[0];
                  wsum = w0 * us[0];
#pragma unroll
                  for (int ch = 0; ch < NC; ++ch) acc[ch] = w0 * u[0][ch];
                }
#pragma unroll
                for (int m = 1; m < 4; ++m) {
                  const float wm = wxp[m * TX];
                  wsum = fmaf(wm, us[m], wsum);
#pragma unroll
                  for (int ch = 0; ch < NC; ++ch) acc[ch] = fmaf(wm, u[m][ch], acc[ch]);
                }
                if (texture) {   // the exemption of the centre tap
                  const float* wxe_p = s_wxe + (p - p0) * 4 * TX + lx;
                  const float t = tq * (((wxe_p[0] + wxe_p[TX]) + wxe_p[2 * TX]) + wxe_p[3 * TX]);
                  wsum += t;
#pragma unroll
                  for (int ch = 0; ch < NC; ++ch)
                    acc[ch] = fmaf(t, pix[1 + cy][1 + cx][ch], acc[ch]);
                }
                const float rec = rcp_approx(wsum);
                // byte ch holds channel ch and the bytes above NC are 0 (255
                // for an opaque alpha); t01's bytes 2 and 3 copy round_byte's
                // byte 1, which is 0
                uint32_t word;
                if constexpr (NC == 1) {
                  word = round_byte(acc[0], rec) & 255u;
                } else {
                  const uint32_t t01 =
                      __byte_perm(round_byte(acc[0], rec), round_byte(acc[1], rec), 0x1140);
                  if constexpr (NC == 2)
                    word = t01;
                  else if constexpr (NC == 3)
                    word = __byte_perm(t01, round_byte(acc[2], rec), 0x2410) |
                           (OPAQUE ? 0xff000000u : 0u);
                  else
                    word = __byte_perm(t01, __byte_perm(round_byte(acc[2], rec),
                                                        round_byte(acc[3], rec), 0x1140),
                                       0x5410);
                }
                const int col = lx * pc + p - p0;
                s_out[(ly * qc + q - q0) * stride + padded(col)] = word;
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
                s_out[sr * stride + padded(lane * pc + dp)];
        }
      } else {
        const bool whole = !PASSES || pc == s;
        for (int sr = warp; sr < rows_o; sr += THREADS / 32) {
          const int gr = (r0 + sr / qc) * s + q0 + sr % qc;
          if (gr >= ho) continue;
          const uint32_t* srow = s_out + sr * stride;
          if constexpr (C == 4) {
            uint32_t* orow = reinterpret_cast<uint32_t*>(out) + (b * ho + gr) * (size_t)wo;
            if (whole && wo % 4 == 0) {
              // x0*s and the row start are multiples of 4 words: 16-byte
              // stores, and a vector that starts inside the row ends in it
              for (int sc = 4 * lane; sc < cols_o; sc += 4 * 32) {
                const int gc = x0 * s + sc;
                if (gc < wo)
                  *reinterpret_cast<uint4*>(orow + gc) =
                      make_uint4(srow[padded(sc)], srow[padded(sc + 1)], srow[padded(sc + 2)],
                                 srow[padded(sc + 3)]);
              }
            } else {
              for (int sc = lane; sc < cols_o; sc += 32) {
                const int gc = whole ? x0 * s + sc : (x0 + sc / pc) * s + p0 + sc % pc;
                if (gc < wo) orow[gc] = srow[padded(sc)];
              }
            }
          } else {
            // byte stores: a row of wo*C bytes need not start on a word
            uint8_t* orow = out + (b * ho + gr) * (size_t)wo * C;
            for (int bcol = lane; bcol < cols_o * C; bcol += 32) {
              const int sc = bcol / C, ch = bcol - sc * C;
              const int gc = whole ? x0 * s + sc : (x0 + sc / pc) * s + p0 + sc % pc;
              if (gc < wo) orow[gc * C + ch] = (uint8_t)(srow[padded(sc)] >> (8 * ch));
            }
          }
        }
      }
      if (!PASSES) return;
      __syncthreads();   // the next pass reuses the tile and the weights
    }
}

template <int C, bool OPAQUE, bool PASSES>
int launch_passes(const uint8_t* in, const float* wy, const float* wye, const float* wx,
                  uint8_t* out, uint8_t* classes, int b, int h, int w, int s, int planar, int qn,
                  int pn, cudaStream_t st) {
  const size_t smem = sizeof(uint32_t) * pass_words(qn, pn);
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
  const auto fits = [&](int q, int p) {
    return pass_words(q, p) * sizeof(uint32_t) <= (size_t)SMEM_MAX &&
           (stage <= 0 || (long long)q * p <= stage);
  };
  int qn = s, pn = s;
  if (!fits(s, s)) {
    while (qn > 1 && !fits(qn, pn)) --qn;
    if (!fits(qn, pn))
      while (pn > 1 && !fits(1, pn)) --pn;
  }
  if (qn == s && pn == s)
    return launch_passes<C, OPAQUE, false>(in, wy, wye, wx, out, classes, b, h, w, s, planar, qn,
                                           pn, st);
  return launch_passes<C, OPAQUE, true>(in, wy, wye, wx, out, classes, b, h, w, s, planar, qn, pn,
                                        st);
}

}  // namespace

// in:      [b, h, w, c] u8, contiguous, c = 1 to 4 (4-byte aligned at c = 4)
// wy, wye: [h, 4*s] f32;  wx: [8*s, w] f32 (wx over wx*eqx)
// out:     planar ? u32 [b, s, h*s, w] : u8 [b, h*s, w*s, c], 16-byte
//          aligned
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
  if (c == 2) return launch<2, false>(in, wy, wye, wx, out, classes, b, h, w, s, planar, stage, st);
  if (c == 1) return launch<1, false>(in, wy, wye, wx, out, classes, b, h, w, s, planar, stage, st);
  return (int)cudaErrorInvalidValue;
}
