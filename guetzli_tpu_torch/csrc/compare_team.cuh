// One block's CompareBlock error (butteraugli_comparator.cc:113-163)
// computed by a team of threads, with the table layout and helpers of
// compare_block.cuh: one unit of 64 threads (one pixel or one contraction
// output per thread) per 8x8 block, every intermediate in shared memory.
// Used by every kernel of this directory: the greedy kernels B, B' and B''
// (zeroing_loop.cu), the compares A, A' and A'' (tile_compare_lanes.cu)
// that check them, and the blocks-leading compare C (tile_compare.cu).
//
// Replaces the evaluation of the TPU kernels
// guetzli_tpu/kernels/zeroing_loop.py (_greedy_kernel, :146;
// zeroing_loop_lanes, :301) in its three modes "444", "420y" and "420c",
// guetzli_tpu/kernels/tile_compare_lanes.py (_tile_compare_lanes, :119)
// and guetzli_tpu/kernels/tile_compare.py (_tile_compare_pallas, :430),
// and the XLA compares guetzli_tpu/ops/tiles_lanes.py:331 and :380
// (compare_blocks_lanes420y, compare_blocks_lanes420c).
//
// Bound. Operations: ~5*10^4 float operations per float stage on ~1.5 KB
// of per-block state (PERF.md). The per-thread design ran one block's
// whole loop in one thread: 255 registers, a ~9 KB stack in local
// memory, and one thread per block (5,187 threads for B'' on 132 SMs,
// about 1.2 warps per SM). Here a block's 192 coefficients, its order
// list, its frozen state and every intermediate live in shared memory, a
// unit's thread holds only its pixel's values and its rows of the four
// constant 8x8 matrices in registers, and B'' and A'' run a candidate's
// four sub-blocks side by side. Small CTAs (one or four units) let 16 or
// 4 of them share an SM, so one CTA's barriers and one-thread tails are
// hidden by the others.
//
// Numerics. Every float operation is in the order of the plain PyTorch
// version: every 8-point contraction output is computed by one thread in
// the plain version's fixed order, and every sum the plain version takes
// sequentially (column means, edges, wsum, the three-channel diff) is
// taken sequentially by one thread: eight threads take one 8-term partial
// each and one thread adds the eight in order, which is the plain order.
// No tree reductions, warp shuffles or atomics; built with --fmad=false.
//
// Barriers. Every thread of the CTA calls every function below that
// contains __syncthreads(); a unit whose 420c sub-block is invalid passes
// active = false and skips the arithmetic only.

#pragma once

#include "compare_block.cuh"

namespace gtt {

constexpr int UNIT = 64;  // threads per unit

// A unit's float scratch in shared memory, in floats.
constexpr int F_LIN = 0;     // [3][64] linear RGB; then m0 - m1
constexpr int F_TMP = 192;   // [3][64] blur along y; then ave of Y [64];
                             // then the four |DFT|^2 [4][64] (with F_BLUR)
constexpr int F_BLUR = 384;  // [3][64] blurred; then (m0 + m1) / 2 of Y
constexpr int F_T1 = 576;    // [4][2][64] first DFT pass (re, im)
constexpr int F_PART = 1088; // [64] partial sums (see finish_team)
constexpr int F_UNIT = 1152;

// Row q = p & 7 of the four constant matrices, kept in registers: every
// contraction below takes its matrix row from the thread's low 3 bits.
struct Rows {
  float blur[8], re[8], im[8];
  int idct[8];
};

__device__ __forceinline__ void load_rows(const float* T, int q, Rows& R) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    R.blur[j] = T[T_BLUR + q * 8 + j];
    R.re[j] = T[T_DFT_RE + q * 8 + j];
    R.im[j] = T[T_DFT_IM + q * 8 + j];
    R.idct[j] = (int)T[T_IDCT + q * 8 + j];
  }
}

// First IDCT pass of one channel, output (i, x) = (lo, hi):
// col[i*8 + x] = (sum_j idct[i][j] * c[j*8 + x] + 2^10) >> 11, where c is
// the block's coefficients with slot `zero` (channel-relative) zeroed.
__device__ __forceinline__ int idct_col(const int* c, int zero, int hi,
                                        const Rows& R) {
  int acc = R.idct[0] * (zero == hi ? 0 : c[hi]);
#pragma unroll
  for (int j = 1; j < 8; ++j) {
    int k = j * 8 + hi;
    acc += R.idct[j] * (zero == k ? 0 : c[k]);
  }
  return (acc + (1 << 10)) >> 11;
}

// Second IDCT pass, output (y, i) = (hi, lo): the clipped byte.
__device__ __forceinline__ int idct_row(const int* col, int hi,
                                        const Rows& R) {
  int acc = R.idct[0] * col[hi * 8];
#pragma unroll
  for (int j = 1; j < 8; ++j) acc += R.idct[j] * col[hi * 8 + j];
  acc = (acc + (257 << 17)) >> 18;
  return acc < 0 ? 0 : (acc > 255 ? 255 : acc);
}

// The IDCT of a unit's three channels: the block's coefficients c [192]
// with slot `zero` zeroed -> bytes in ib[192..383] (ib[0..191]: the IDCT
// columns). Two barriers.
__device__ __forceinline__ void idct_444_team(const int* c, int zero,
                                              int* ib, const Rows& R,
                                              int p) {
  const int hi = p >> 3, lo = p & 7;
  for (int ch = 0; ch < 3; ++ch)
    ib[ch * 64 + lo * 8 + hi] = idct_col(c + ch * 64, zero - ch * 64, hi, R);
  __syncthreads();
  for (int ch = 0; ch < 3; ++ch)
    ib[192 + ch * 64 + p] = idct_row(ib + ch * 64, hi, R);
  __syncthreads();
}

// Mode 444 pixel stage of one unit (one candidate): the block's
// coefficients c [192] with slot `zero` zeroed -> IDCT -> edge replication
// -> linear RGB in LIN [3][64]. ib: the unit's int scratch [2][192] (IDCT
// columns, then bytes). Three barriers.
__device__ __forceinline__ void pixel_444_team(const int* c, int zero,
                                               int* ib, float* LIN,
                                               int ymax, int xmax,
                                               const float* T, const Rows& R,
                                               int p) {
  const int hi = p >> 3, lo = p & 7;
  idct_444_team(c, zero, ib, R, p);
  const int sy = hi <= ymax ? hi : ymax, sx = lo <= xmax ? lo : xmax;
  const int q = sy * 8 + sx;
  const int* v = ib + 192;
  gtk::store_linear(LIN, p,
                    gtk::ycc_to_linear(v[q], v[64 + q], v[128 + q], T));
  __syncthreads();
}

// Mode 444 pixel stage of kernel C (one unit, one candidate): the
// block's coefficients c [192] with slot `zero` zeroed -> IDCT -> the
// edge replication as two 0/1 selection contractions, as the TPU kernel
// computes it (guetzli_tpu/kernels/tile_compare.py:341-365), rows by
// sy[i*8 + j], then columns by sx[i*8 + j] (both in shared memory) ->
// linear RGB in LIN [3][64]. ib: the unit's int scratch [2][192] (IDCT
// columns, then bytes; row-selected bytes, then selected bytes). The sums
// are int32 and exact, j in order as in the plain version; for one-hot
// rows they are the clamp gather of pixel_444_team. Five barriers.
__device__ __forceinline__ void pixel_444_sel_team(const int* c, int zero,
                                                   int* ib, float* LIN,
                                                   const int* sy,
                                                   const int* sx,
                                                   const float* T,
                                                   const Rows& R, int p) {
  const int hi = p >> 3, lo = p & 7;
  idct_444_team(c, zero, ib, R, p);
  // Rows, output (i, x) = (hi, lo): t[i*8 + x] = sum_j sy[i][j] * v[j*8 + x].
  for (int ch = 0; ch < 3; ++ch) {
    const int* v = ib + 192 + ch * 64;
    int acc = sy[hi * 8] * v[lo];
    for (int j = 1; j < 8; ++j) acc += sy[hi * 8 + j] * v[j * 8 + lo];
    ib[ch * 64 + p] = acc;
  }
  __syncthreads();
  // Columns, output (y, i) = (hi, lo): v[y*8 + i] = sum_j sx[i][j] *
  // t[y*8 + j].
  for (int ch = 0; ch < 3; ++ch) {
    const int* t = ib + ch * 64 + hi * 8;
    int acc = sx[lo * 8] * t[0];
    for (int j = 1; j < 8; ++j) acc += sx[lo * 8 + j] * t[j];
    ib[192 + ch * 64 + p] = acc;
  }
  __syncthreads();
  const int* v = ib + 192;
  gtk::store_linear(LIN, p, gtk::ycc_to_linear(v[p], v[64 + p], v[128 + p],
                                               T));
  __syncthreads();
}

// Mode 420y pixel stage of one unit (one candidate): the Y channel of c
// (slot `zero` zeroed) -> IDCT -> edge replication of the Y byte -> linear
// RGB in LIN [3][64] against the frozen chroma bytes [2][64] (Cb, Cr),
// read at the unreplicated pixel p (they are edge-replicated already, as
// ops/tiles_lanes.compare_lanes_420y reads them). ib: the unit's int
// scratch [2][64] (IDCT columns, then bytes). Three barriers.
__device__ __forceinline__ void pixel_420y_team(const int* c, int zero,
                                                int* ib, float* LIN,
                                                const int* chroma, int ymax,
                                                int xmax, const float* T,
                                                const Rows& R, int p) {
  const int hi = p >> 3, lo = p & 7;
  ib[lo * 8 + hi] = idct_col(c, zero, hi, R);
  __syncthreads();
  ib[64 + p] = idct_row(ib, hi, R);
  __syncthreads();
  const int sy = hi <= ymax ? hi : ymax, sx = lo <= xmax ? lo : xmax;
  gtk::store_linear(LIN, p,
                    gtk::ycc_to_linear(ib[64 + sy * 8 + sx], chroma[p],
                                       chroma[64 + p], T));
  __syncthreads();
}

// Mode 420c pixel stage of one candidate's group of four units (one per
// 8x8 sub-block s of the 16x16 macroblock). g: the thread's index in the
// group (0..255); ib: the candidate's int scratch [2][2][64] (Cb and Cr
// IDCT columns, then bytes), computed by the group's first two units
// whether their sub-blocks are valid or not; nu, nv [10][10], y16
// [16][16]: the frozen state in shared memory; LIN: the unit's linear RGB
// [3][64]. active: sub-block s is valid. Three barriers.
__device__ __forceinline__ void pixel_420c_team(
    const int* c, int zero, int* ib, float* LIN, int s, const int* nu,
    const int* nv, const int* y16, int ymax, int xmax, const float* T,
    const Rows& R, int g, bool active) {
  const int p = g & 63, ch = g >> 6, hi = p >> 3, lo = p & 7;
  const int base = 64 + ch * 64;  // Cb at 64, Cr at 128
  if (ch < 2)
    ib[ch * 64 + lo * 8 + hi] = idct_col(c + base, zero - base, hi, R);
  __syncthreads();
  if (ch < 2)
    ib[128 + ch * 64 + p] = idct_row(ib + ch * 64, hi, R);
  __syncthreads();
  if (active) {
    const int yy = (s >> 1) * 8 + (hi <= ymax ? hi : ymax);
    const int xx = (s & 1) * 8 + (lo <= xmax ? lo : xmax);
    gtk::store_linear(
        LIN, p,
        gtk::ycc_to_linear(y16[yy * 16 + xx],
                           gtk::up_byte(ib + 128, nu, yy, xx),
                           gtk::up_byte(ib + 192, nv, yy, xx), T));
  }
  __syncthreads();
}

// The float stage by one unit (the twin of _finish_lanes_k,
// guetzli_tpu/kernels/zeroing_loop.py:56): opsin, MaskHighIntensityChange
// against the original, block diff and the weighted error. U: the
// unit's scratch, U[F_LIN..] holding the candidate's linear RGB; x0: the
// original opsin tile [3][64] in shared memory; sc: its three scales; p:
// the thread's index in the unit. Thread 0 of an active unit writes the
// block error to *err. Seven barriers.
__device__ __forceinline__ void finish_team(float* U,
                                            const float* x0,
                                            const float* sc,
                                            const float* T, const Rows& R,
                                            int p, bool active, float* err) {
  const float* S = T + T_SCAL;
  float* LIN = U + F_LIN;
  float* TMP = U + F_TMP;
  float* BL = U + F_BLUR;
  float* T1 = U + F_T1;
  float* PART = U + F_PART;
  float* F = U + F_TMP;  // [4][64]: X, Z, Y average, Y difference
  const int hi = p >> 3, lo = p & 7;

  // 1. Blur along y: TMP[c][i*8 + x] = sum_j B[i][j] * LIN[c][j*8 + x].
  if (active) {
    for (int ch = 0; ch < 3; ++ch) {
      const float* l = LIN + ch * 64;
      float acc = R.blur[0] * l[hi];
#pragma unroll
      for (int j = 1; j < 8; ++j) acc = acc + R.blur[j] * l[j * 8 + hi];
      TMP[ch * 64 + lo * 8 + hi] = acc;
    }
  }
  __syncthreads();
  // 2. Blur along x: BL[c][y*8 + i] = sum_j B[i][j] * TMP[c][y*8 + j].
  if (active) {
    for (int ch = 0; ch < 3; ++ch) {
      const float* m = TMP + ch * 64 + hi * 8;
      float acc = R.blur[0] * m[0];
#pragma unroll
      for (int j = 1; j < 8; ++j) acc = acc + R.blur[j] * m[j];
      BL[ch * 64 + p] = acc;
    }
  }
  __syncthreads();
  // 3. Opsin dynamics of pixel p, and its average with the original.
  float xyb[3], t0[3], ave[3];
  if (active) {
    float cur[3];
    for (int k = 0; k < 3; ++k) {
      const float* m = S + S_MIX + 3 * k;
      float pre = gtk::mix3(m, BL[p], BL[64 + p], BL[128 + p]) +
                  S[S_BIAS + k];
      float sens = gtk::gamma_fn(S, pre) / pre;
      cur[k] = (gtk::mix3(m, LIN[p], LIN[64 + p], LIN[128 + p]) +
                S[S_BIAS + k]) *
               sens;
    }
    for (int k = 0; k < 3; ++k) {
      xyb[k] = gtk::mix3(S + S_XYB + 3 * k, cur[0], cur[1], cur[2]);
      t0[k] = x0[k * 64 + p];
      ave[k] = (t0[k] + xyb[k]) * 0.5f;
    }
    TMP[p] = ave[1];
  }
  __syncthreads();
  // 4. MaskHighIntensityChange of pixel (y, x) = (hi, lo): LIN <- m0 - m1,
  // BL[0..63] <- (m0 + m1) / 2 of Y.
  if (active) {
    const float yc = ave[1];
    float d;
    d = (lo >= 1) ? TMP[p - 1] - yc : 0.0f;
    float sl = (lo >= 1) ? d * d : -1.0f;
    d = (lo <= 6) ? TMP[p + 1] - yc : 0.0f;
    float sr = (lo <= 6) ? d * d : -1.0f;
    d = (hi >= 1) ? TMP[p - 8] - yc : 0.0f;
    float su = (hi >= 1) ? d * d : -1.0f;
    d = (hi <= 6) ? TMP[p + 8] - yc : 0.0f;
    float sd = (hi <= 6) ? d * d : -1.0f;
    float sqr_max = gtk::max_nan(gtk::max_nan(sl, sr), gtk::max_nan(su, sd));
    const float red0 = S[S_RED], red1 = S[S_RED + 1], red2 = S[S_RED + 2];
    const float chroma = S[S_CHROMA];
    float chroma_scale = chroma / (yc + chroma);
    float mix[3];
    mix[0] = (chroma_scale * red0) / (sqr_max + red0);
    mix[1] = red1 / (sqr_max + red1);
    mix[2] = (chroma_scale * red2) / (sqr_max + red2);
    for (int ch = 0; ch < 3; ++ch) {
      float a = (1.0f - mix[ch]) * ave[ch];
      float m0 = mix[ch] * t0[ch] + a;
      float m1 = mix[ch] * xyb[ch] + a;
      LIN[ch * 64 + p] = m0 - m1;
      if (ch == 1) BL[p] = (m0 + m1) * 0.5f;
    }
  }
  __syncthreads();
  // 5. First DFT pass of the four inputs (X and Z half differences, Y
  // average, Y half difference), output (u, y) = (lo, hi).
  if (active) {
    for (int d = 0; d < 4; ++d) {
      const float* src = (d == 2) ? BL
                         : LIN + (d == 0 ? 0 : d == 1 ? 128 : 64);
      const float* xr = src + hi * 8;
      float x = (d == 2) ? xr[0] : xr[0] * 0.5f;
      float ar = R.re[0] * x;
      float ai = R.im[0] * x;
#pragma unroll
      for (int j = 1; j < 8; ++j) {
        x = (d == 2) ? xr[j] : xr[j] * 0.5f;
        ar = ar + R.re[j] * x;
        ai = ai + R.im[j] * x;
      }
      T1[d * 128 + lo * 8 + hi] = ar;
      T1[d * 128 + 64 + lo * 8 + hi] = ai;
    }
  }
  __syncthreads();
  // 6. Second pass, output (u, v) = (hi, lo): F[d][u*8 + v] = |.|^2 * mul.
  if (active) {
    const float mul = S[S_FFTMUL];
    for (int d = 0; d < 4; ++d) {
      const float* tr = T1 + d * 128 + hi * 8;
      const float* ti = tr + 64;
      float rr = R.re[0] * tr[0];
      float ii = R.im[0] * ti[0];
      float ir = R.im[0] * tr[0];
      float ri = R.re[0] * ti[0];
#pragma unroll
      for (int j = 1; j < 8; ++j) {
        rr = rr + R.re[j] * tr[j];
        ii = ii + R.im[j] * ti[j];
        ir = ir + R.im[j] * tr[j];
        ri = ri + R.re[j] * ti[j];
      }
      float gr = rr - ii;
      float gi = ir + ri;
      F[d * 64 + p] = (gr * gr + gi * gi) * mul;
    }
  }
  __syncthreads();
  // 7. Partial sums, each sequential: PART[0..23] the wsum column sums
  // of X, Z and the Y value (computed here, 8 pixels a thread);
  // PART[24..47] the column means of m0 - m1 per channel; PART[48..59]
  // the four edge means per channel.
  if (active) {
    const float* D = T + T_CSF;
    if (p < 24) {
      const int v = p & 7, which = p >> 3;
      const float rng = S[S_YLIM];
      const float ymul2 = S[S_ACY2];
      float s = 0.0f;
      for (int u = 0; u < 8; ++u) {
        const int q = u * 8 + v;
        float val;
        if (which < 2) {
          val = F[which * 64 + q];
        } else {
          float a = sqrtf(F[128 + q]);
          float h = sqrtf(F[192 + q]);
          float y0 = gtk::remove_range(a - h, rng);
          float y1 = gtk::remove_range(a + h, rng);
          const float* hf = S + S_HFDY;
          float valy = S[S_ACY] * (gtk::pw_progression(hf, y0 * ymul2) -
                                   gtk::pw_progression(hf, y1 * ymul2));
          val = valy * valy;
        }
        float term = D[q] * val;
        s = (u == 0) ? term : s + term;
      }
      PART[p] = s;
    } else if (p < 48) {
      const int ch = (p - 24) >> 3, x = (p - 24) & 7;
      const float* dd = LIN + ch * 64;
      float s = dd[x];
      for (int y = 1; y < 8; ++y) s = s + dd[y * 8 + x];
      PART[p] = s * 0.125f;
    } else if (p < 60) {
      const int k = (p - 48) / 3, ch = (p - 48) % 3;
      const float* dd = LIN + ch * 64;
      // Column x=0, row y=0, column x=7, row y=7.
      const int first = (k == 2) ? 7 : (k == 3) ? 56 : 0;
      const int step = (k == 1 || k == 3) ? 1 : 8;
      float e = dd[first];
      for (int i = 1; i < 8; ++i) e = e + dd[first + i * step];
      PART[p] = e * 0.125f;
    }
  }
  __syncthreads();
  // 8. The block error, by thread 0 (the caller's barrier follows).
  if (active && p == 0) {
    const float csf0 = S[S_CSF0];
    float avg[3];
    for (int ch = 0; ch < 3; ++ch) {
      float s = PART[24 + ch * 8];
      for (int x = 1; x < 8; ++x) s = s + PART[24 + ch * 8 + x];
      avg[ch] = s * 0.125f;
    }
    float dc[3], edge[3], qx, qy, qz;
    gtk::low_freq_sq(S, avg[0], avg[1], avg[2], &qx, &qy, &qz);
    dc[0] = qx * csf0;
    dc[1] = qy * csf0;
    dc[2] = qz * csf0;
    float sx = 0.0f, sy = 0.0f, sz = 0.0f;
    for (int k = 0; k < 4; ++k) {
      const float* e = PART + 48 + k * 3;
      gtk::low_freq_sq(S, e[0], e[1], e[2], &qx, &qy, &qz);
      sx = (k == 0) ? qx : sx + qx;
      sy = (k == 0) ? qy : sy + qy;
      sz = (k == 0) ? qz : sz + qz;
    }
    edge[0] = sx * csf0;
    edge[1] = sy * csf0;
    edge[2] = sz * csf0;
    float ac[3];
    for (int w = 0; w < 3; ++w) {
      float total = PART[w * 8];
      for (int v = 1; v < 8; ++v) total = total + PART[w * 8 + v];
      ac[w] = total;
    }
    // PART rows: X, Z, Y.
    const float acx = ac[0] * S[S_ACX];
    const float acz = ac[1] * S[S_ACZ];
    const float acy = ac[2];
    float diff = (dc[0] + acx) * sc[0];
    diff = diff + (dc[1] + acy) * sc[1];
    diff = diff + (dc[2] + acz) * sc[2];
    float diff_edge = edge[0] * sc[0];
    diff_edge = diff_edge + edge[1] * sc[1];
    diff_edge = diff_edge + edge[2] * sc[2];
    *err = sqrtf(S[S_1MEW] * diff + S[S_EW] * diff_edge);
  }
}

// ---- The team kernels: modes, shared memory, state, one evaluation -----
//
// Shared by the greedy kernels B, B', B'' (zeroing_loop.cu) and the team
// compares A, A', A'' (tile_compare_lanes.cu) and C (tile_compare.cu):
// each greedy kernel and the compare that checks it on the search path
// load the same state into the same layout and run the same evaluation,
// so their errors agree by construction; C runs A's float stage.

// The lane-major state operands of a block (tile_compare_lanes.cu gives
// their layouts), element e of lane b at [e * n + b]: the opsin tiles,
// scales, clamps and validity (null: all valid) of its SUBS sub-blocks,
// and its frozen int operands fz[0..2] of FZ0, FZ1, FZ2 rows.
struct State {
  const float* x0;
  const float* sc;
  const int* ymax;
  const int* xmax;
  const int* valid;
  const int* fz[3];
};

// A mode: SUBS 8x8 sub-blocks per block, one 64-thread unit each, so a CTA
// evaluates one candidate at a time; MINB: the CTAs per SM asked of ptxas
// (__launch_bounds__), which caps the registers at 64; IBC: IDCT scratch
// ints; FZ0..FZ2: rows of the frozen int operands (B', A': chroma [2][64];
// B'' and A'': nu, nv [10][10], y16 [16][16]; C: sy, sx [8][8]); pixel:
// the mode's pixel stage, given the frozen ints fz in shared memory.
struct Team444 {
  static constexpr int SUBS = 1, MINB = 16, IBC = 384;
  static constexpr int FZ0 = 0, FZ1 = 0, FZ2 = 0;
  static __device__ __forceinline__ void pixel(const int* c, int zero,
                                               int* ib, float* LIN,
                                               const int* fz, int ymax,
                                               int xmax, const float* T,
                                               const Rows& R, int tid, bool) {
    pixel_444_team(c, zero, ib, LIN, ymax, xmax, T, R, tid);
  }
};
// Kernel C: Team444 with the edge replication as selection contractions
// (its clamps stay 7 and unused).
struct Team444Sel {
  static constexpr int SUBS = 1, MINB = 16, IBC = 384;
  static constexpr int FZ0 = 64, FZ1 = 64, FZ2 = 0;
  static __device__ __forceinline__ void pixel(const int* c, int zero,
                                               int* ib, float* LIN,
                                               const int* fz, int, int,
                                               const float* T,
                                               const Rows& R, int tid, bool) {
    pixel_444_sel_team(c, zero, ib, LIN, fz, fz + 64, T, R, tid);
  }
};
struct Team420y {
  static constexpr int SUBS = 1, MINB = 16, IBC = 128;
  static constexpr int FZ0 = 128, FZ1 = 0, FZ2 = 0;
  static __device__ __forceinline__ void pixel(const int* c, int zero,
                                               int* ib, float* LIN,
                                               const int* fz, int ymax,
                                               int xmax, const float* T,
                                               const Rows& R, int tid, bool) {
    pixel_420y_team(c, zero, ib, LIN, fz, ymax, xmax, T, R, tid);
  }
};
struct Team420c {
  static constexpr int SUBS = 4, MINB = 4, IBC = 256;
  static constexpr int FZ0 = 100, FZ1 = 100, FZ2 = 256;
  static __device__ __forceinline__ void pixel(const int* c, int zero,
                                               int* ib, float* LIN,
                                               const int* fz, int ymax,
                                               int xmax, const float* T,
                                               const Rows& R, int tid,
                                               bool active) {
    pixel_420c_team(c, zero, ib, LIN, tid / UNIT, fz, fz + 100, fz + 200,
                    ymax, xmax, T, R, tid, active);
  }
};

// The CTA's dynamic shared memory: floats, then ints (offsets in words).
template <class M>
struct Layout {
  static constexpr int THREADS = M::SUBS * UNIT;
  static constexpr int TAB = 0;                        // N_TABLES
  static constexpr int UNITF = N_TABLES;               // units' scratch
  static constexpr int X0 = UNITF + M::SUBS * F_UNIT;  // [SUBS][192]
  static constexpr int SC = X0 + M::SUBS * 192;        // [SUBS][4]
  static constexpr int ERR = SC + M::SUBS * 4;         // [SUBS]
  static constexpr int NF = (ERR + M::SUBS + 3) / 4 * 4;
  static constexpr int C = 0;                   // [192] coefficients
  static constexpr int ORD = 192;               // [2][192] order, doubled
  static constexpr int IB = ORD + 384;          // [IBC]
  static constexpr int CL = IB + M::IBC;        // ymax, xmax, valid [SUBS]
  static constexpr int NBI = CL + 3 * M::SUBS;  // [NB] frozen ints
  static constexpr int NB = M::FZ0 + M::FZ1 + M::FZ2;
  static constexpr int NI = NBI + NB;
  static constexpr int BYTES = (NF + NI) * 4;
  // Within the 48 KB a launch may ask without cudaFuncSetAttribute.
  static_assert(BYTES <= 48 * 1024, "dynamic shared memory above 48 KB");
};

// Loads the table buffer and lane b's state into the CTA's shared memory
// (sf: its floats, si: its ints). The caller loads the coefficients and
// then synchronises.
template <class M>
__device__ __forceinline__ void load_state(const State& s,
                                           const float* __restrict__ tables,
                                           float* sf, int* si, int b, int n,
                                           int tid) {
  using L = Layout<M>;
  for (int i = tid; i < N_TABLES; i += L::THREADS) sf[L::TAB + i] = tables[i];
  for (int i = tid; i < M::SUBS * 192; i += L::THREADS)
    sf[L::X0 + i] = s.x0[(long)i * n + b];
  for (int i = tid; i < M::SUBS * 3; i += L::THREADS)
    sf[L::SC + (i / 3) * 4 + i % 3] = s.sc[(long)i * n + b];
  for (int i = tid; i < M::SUBS; i += L::THREADS) {
    si[L::CL + i] = s.ymax[(long)i * n + b];
    si[L::CL + M::SUBS + i] = s.xmax[(long)i * n + b];
    si[L::CL + 2 * M::SUBS + i] = s.valid ? s.valid[(long)i * n + b] : 1;
  }
  for (int i = tid; i < L::NB; i += L::THREADS)
    si[L::NBI + i] =
        i < M::FZ0             ? s.fz[0][(long)i * n + b]
        : i < M::FZ0 + M::FZ1  ? s.fz[1][(long)(i - M::FZ0) * n + b]
                               : s.fz[2][(long)(i - M::FZ0 - M::FZ1) * n + b];
}

// One candidate's error by the whole CTA: the coefficients c [192] in
// shared memory with slot `zero` zeroed (-1: none) -> the mode's pixel
// stage -> one float stage per unit. B, B', A, A': the block's error; B''
// and A'': the max over the valid sub-blocks, starting from 0, in sub-block
// order. Every thread returns the same value. Eleven barriers (C:
// thirteen).
template <class M>
__device__ __forceinline__ float eval_team(const int* c, int zero, float* sf,
                                           int* si, const Rows& R, int tid) {
  using L = Layout<M>;
  const int sub = tid / UNIT;
  const float* T = sf + L::TAB;
  float* U = sf + L::UNITF + sub * F_UNIT;
  const bool active = si[L::CL + 2 * M::SUBS + sub] > 0;
  M::pixel(c, zero, si + L::IB, U + F_LIN, si + L::NBI, si[L::CL + sub],
           si[L::CL + M::SUBS + sub], T, R, tid, active);
  finish_team(U, sf + L::X0 + sub * 192, sf + L::SC + sub * 4, T, R,
              tid % UNIT, active, sf + L::ERR + sub);
  __syncthreads();
  float e = M::SUBS == 1 ? sf[L::ERR] : 0.0f;
  if constexpr (M::SUBS > 1)
    for (int s = 0; s < M::SUBS; ++s)
      if (si[L::CL + 2 * M::SUBS + s] > 0) e = gtk::max_nan(e, sf[L::ERR + s]);
  return e;
}

// Asks for the largest shared-memory carveout of the SM's 256 KB, so that
// shared memory and not the L1 split limits the CTAs per SM.
template <class K>
static int prefer_smem(K kernel) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
}

// The launch geometry of a team kernel of mode M: threads and dynamic
// shared memory bytes per CTA, and the CTAs that fit on one SM.
template <class M, class K>
static int geometry(K kernel, int* threads, int* smem_bytes,
                    int* ctas_per_sm) {
  *threads = Layout<M>::THREADS;
  *smem_bytes = Layout<M>::BYTES;
  int rc = prefer_smem(kernel);
  if (rc == 0)
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas_per_sm, kernel, *threads, *smem_bytes);
  return rc;
}

}  // namespace gtt
