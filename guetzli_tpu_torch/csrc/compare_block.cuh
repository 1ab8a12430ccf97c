// One block's CompareBlock error (butteraugli_comparator.cc:113-163): the
// table layout, the helpers of the pixel stage and the per-thread float
// stage, shared by the kernels of this directory.
//
// Replaces the per-lane evaluation chain of the TPU kernels
// guetzli_tpu/kernels/tile_compare_lanes.py::_kernel and
// guetzli_tpu/kernels/zeroing_loop.py::_eval_lanes / _eval_lanes_420c /
// _finish_lanes_k (the jnp chain of guetzli_tpu/ops/tiles_lanes.py).
//
// Two stages. The pixel stage is integer and differs by mode: integer IDCT
// (>>11, >>18, clip) -> edge replication -> fixed-point YCbCr->RGB ->
// sRGB->linear by table. Mode 444 converts all three channels of one 8x8
// block; 420y only its Y channel, against frozen chroma bytes; 420c
// rebuilds a 16x16 macroblock's chroma (IDCT into a frozen 10x10
// neighbourhood, fancy upsample, dither: neigh_at and up_byte below) and
// converts each of its four 8x8 sub-blocks against frozen Y bytes
// (compare_team.cuh holds the three pixel stages). The float stage is one
// and the same for all: 8x8 opsin (tile-confined blur, Clenshaw gamma) ->
// MaskHighIntensityChange against the original -> DFT8 block diff (dc /
// ac / edge) -> sqrt((1-w) * sum_c (dc+ac)*sc + w * sum_c edge*sc).
//
// Numerics. Every float operation is written in the order of the plain
// PyTorch version (guetzli_tpu_torch/ops/tiles_lanes.py): fixed-order
// unrolled 8-point contractions and sequential sums. The sources are built
// with --fmad=false, so each multiply and each add rounds on its own, as the
// plain version's separate tensor ops do, and the kernels can equal it bit
// for bit. The integer IDCT stays in int32 (products reach 2^27, past the
// float32 mantissa). The sRGB->linear step reads a 256-entry table that
// the wrapper evaluates with the plain version's closed form on the same
// device, so it is that function exactly.
//
// Bound. About 10^5 float operations per block evaluation on ~1.5 KB of
// per-block state: arithmetic, not bytes, bounds it. This file holds the
// per-thread float stage (finish_block), which keeps the whole state of
// one block in one thread (local memory, cached in L1) with the tables in
// shared memory: kernel C runs it. The team kernels (compare_team.cuh: B,
// B', B'', A, A' and A'') split the same evaluation over 64 threads per
// 8x8 block and reuse the helpers here (color transform, table reads, the
// 420c upsample).

#pragma once

#include <cuda_runtime.h>

// Layout of the float table buffer (guetzli_tpu_torch/kernels/tables.py
// builds it; tests/test_torch_kernels.py holds the two in step).
#define T_IDCT 0        // [8][8] integer IDCT matrix, stored as floats
#define T_BLUR 64       // [8][8] in-tile opsin blur matrix
#define T_DFT_RE 128    // [8][8]
#define T_DFT_IM 192    // [8][8]
#define T_CSF 256       // [8 xf][8 yf] masked CSF weights
#define T_SRGB 320      // [256] sRGB byte -> linear
#define T_SCAL 576      // scalars below
#define S_MIX 0         // [3][3] opsin absorbance mix
#define S_BIAS 9        // [3]
#define S_XYB 12        // [3][3] opponent mix
#define S_GMIN 21
#define S_GRANGE 22
#define S_GP 23         // [6] Chebyshev numerator
#define S_GQ 29         // [6] Chebyshev denominator
#define S_RED 35        // [3] MHIC reduction
#define S_CHROMA 38
#define S_LF_Y2Z 39
#define S_LF_ZMUL 40
#define S_LF_XMUL 41
#define S_LF_YMUL 42
#define S_LFDY 43       // off, inc, cap
#define S_HFDY 46       // off, inc, cap
#define S_CSF0 49
#define S_FFTMUL 50
#define S_ACX 51
#define S_ACZ 52
#define S_ACY 53
#define S_ACY2 54
#define S_YLIM 55
#define S_EW 56
#define S_1MEW 57
#define N_TABLES 640

namespace gtk {

__device__ __forceinline__ float min_nan(float a, float b) {
  // torch.minimum: NaN propagates.
  if (a != a) return a;
  if (b != b) return b;
  return b < a ? b : a;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return b > a ? b : a;
}

// Odd piecewise-linear progression read (blockdiff.pw_progression).
__device__ __forceinline__ float pw_progression(const float* p, float s) {
  float off = p[0], inc = p[1], cap = p[2];
  float ix = fabsf(s);
  float res;
  if (off != 0.0f) {
    float lin = off + (ix - 1.0f) * inc;
    res = (ix < 1.0f) ? ix * off : min_nan(lin, cap);
  } else {
    res = min_nan(ix * inc, cap);
  }
  return (s < 0.0f) ? -res : res;
}

// blockdiff.xyb_diff_low_freq_squared.
__device__ __forceinline__ void low_freq_sq(const float* S, float x, float y,
                                            float z, float* ox, float* oy,
                                            float* oz) {
  z = z + S[S_LF_Y2Z] * y;
  float valz = z * S[S_LF_ZMUL];
  float valx = x * S[S_LF_XMUL];
  float valy = pw_progression(S + S_LFDY, y * S[S_LF_YMUL]);
  *ox = valx * valx;
  *oy = valy * valy;
  *oz = valz * valz;
}

__device__ __forceinline__ float clenshaw(float x, const float* c) {
  float b1 = 0.0f, b2 = 0.0f;
  for (int k = 5; k >= 1; --k) {
    float t = ((x * b1) * 2.0f - b2) + c[k];
    b2 = b1;
    b1 = t;
  }
  return (x * b1 - b2) + c[0];
}

__device__ __forceinline__ float gamma_fn(const float* S, float v) {
  float x01 = (v - S[S_GMIN]) / S[S_GRANGE];
  float xc = 2.0f * x01 - 1.0f;
  return clenshaw(xc, S + S_GP) / clenshaw(xc, S + S_GQ);
}

__device__ __forceinline__ float mix3(const float* m, float a, float b,
                                      float c) {
  return (m[0] * a + m[1] * b) + m[2] * c;
}

// |2-D DFT|^2 of x[y*8+x] -> out[u*8+v] (u: x frequency, v: y frequency).
__device__ void fft8_sq(const float* T, const float* x, float* out) {
  const float* RE = T + T_DFT_RE;
  const float* IM = T + T_DFT_IM;
  const float mul = T[T_SCAL + S_FFTMUL];
  float t1r[64], t1i[64];
  // t1[u][y] = sum_j W[u][j] * x[y][j]
  for (int u = 0; u < 8; ++u) {
    for (int y = 0; y < 8; ++y) {
      float ar = RE[u * 8] * x[y * 8];
      float ai = IM[u * 8] * x[y * 8];
      for (int j = 1; j < 8; ++j) {
        ar = ar + RE[u * 8 + j] * x[y * 8 + j];
        ai = ai + IM[u * 8 + j] * x[y * 8 + j];
      }
      t1r[u * 8 + y] = ar;
      t1i[u * 8 + y] = ai;
    }
  }
  for (int u = 0; u < 8; ++u) {
    for (int v = 0; v < 8; ++v) {
      float rr = RE[v * 8] * t1r[u * 8];
      float ii = IM[v * 8] * t1i[u * 8];
      float ir = IM[v * 8] * t1r[u * 8];
      float ri = RE[v * 8] * t1i[u * 8];
      for (int j = 1; j < 8; ++j) {
        rr = rr + RE[v * 8 + j] * t1r[u * 8 + j];
        ii = ii + IM[v * 8 + j] * t1i[u * 8 + j];
        ir = ir + IM[v * 8 + j] * t1r[u * 8 + j];
        ri = ri + RE[v * 8 + j] * t1i[u * 8 + j];
      }
      float gr = rr - ii;
      float gi = ir + ri;
      out[u * 8 + v] = (gr * gr + gi * gi) * mul;
    }
  }
}

// sum over v of (sum over u of d[u][v] * x[u][v]), both sequential.
__device__ __forceinline__ float wsum(const float* T, const float* x) {
  const float* d = T + T_CSF;
  float total = 0.0f;
  for (int v = 0; v < 8; ++v) {
    float s = d[v] * x[v];
    for (int u = 1; u < 8; ++u) s = s + d[u * 8 + v] * x[u * 8 + v];
    total = (v == 0) ? s : total + s;
  }
  return total;
}

__device__ __forceinline__ float remove_range(float v, float rng) {
  if (v >= -rng && v < rng) return 0.0f;
  return (v < 0.0f) ? v + rng : v - rng;
}

// Integer IDCT of one channel (ComputeBlockIDCT, idct.cc:139-161): 64
// dequantized coefficients c[u*8 + x] -> bytes v[y*8 + x] in 0..255.
__device__ __forceinline__ void idct_block(const int* c, int* v,
                                           const float* T) {
  int col[64];
  for (int i = 0; i < 8; ++i) {
    for (int x = 0; x < 8; ++x) {
      int acc = (int)T[T_IDCT + i * 8] * c[x];
      for (int j = 1; j < 8; ++j)
        acc += (int)T[T_IDCT + i * 8 + j] * c[j * 8 + x];
      col[i * 8 + x] = (acc + (1 << 10)) >> 11;
    }
  }
  for (int y = 0; y < 8; ++y) {
    for (int i = 0; i < 8; ++i) {
      int acc = (int)T[T_IDCT + i * 8] * col[y * 8];
      for (int j = 1; j < 8; ++j)
        acc += (int)T[T_IDCT + i * 8 + j] * col[y * 8 + j];
      acc = (acc + (257 << 17)) >> 18;
      v[y * 8 + i] = acc < 0 ? 0 : (acc > 255 ? 255 : acc);
    }
  }
}

// The pixel stage's last step: fixed-point YCbCr -> RGB bytes
// (color_transform.h), then sRGB -> linear through the table.
__device__ __forceinline__ float3 ycc_to_linear(int yy, int cb, int cr,
                                                const float* T) {
  cb -= 128;
  cr -= 128;
  int r = yy + ((91881 * cr + 32768) >> 16);
  int b = yy + ((116130 * cb + 32768) >> 16);
  int g = yy + (((-46802) * cr + (-22554) * cb + 32768) >> 16);
  r = r < 0 ? 0 : (r > 255 ? 255 : r);
  g = g < 0 ? 0 : (g > 255 ? 255 : g);
  b = b < 0 ? 0 : (b > 255 ? 255 : b);
  return make_float3(T[T_SRGB + r], T[T_SRGB + g], T[T_SRGB + b]);
}

// Stores one pixel's linear RGB into lin [3 * 64] (channel-major). The
// pixel buffer is flat and the helpers return values: with a
// float[3][64] buffer written through float (*)[64] parameters, the nvcc
// 12.8 sm_90a build gave NaN for every block on an H100 (a kernel that
// also copied the buffer out gave the right values, and so did the host
// build of the same source).
__device__ __forceinline__ void store_linear(float* lin, int p, float3 v) {
  lin[p] = v.x;
  lin[64 + p] = v.y;
  lin[128 + p] = v.z;
}

// The float stage, shared by every mode (the twin of _finish_lanes_k,
// guetzli_tpu/kernels/zeroing_loop.py:56): lin [3 * 64] linear RGB of the
// candidate block (channel-major); x0: the block's original opsin tile,
// element e at x0[e * stride]; sc0..sc2: whole-image mask scales; T: the
// table buffer (shared memory). Opsin, MaskHighIntensityChange, block
// diff and the weighted error.
__device__ __forceinline__ float finish_block(const float* lin,
                                              const float* __restrict__ x0,
                                              long stride, float sc0,
                                              float sc1, float sc2,
                                              const float* T) {
  const float* S = T + T_SCAL;

  // Opsin: tile-confined blur (y pass, then x pass), then the dynamics.
  float xyb1[3][64];
  {
    const float* B = T + T_BLUR;
    float blurred[3][64];
    for (int ch = 0; ch < 3; ++ch) {
      float tmp[64];
      for (int i = 0; i < 8; ++i)
        for (int x = 0; x < 8; ++x) {
          float acc = B[i * 8] * lin[ch * 64 + x];
          for (int j = 1; j < 8; ++j)
            acc = acc + B[i * 8 + j] * lin[ch * 64 + j * 8 + x];
          tmp[i * 8 + x] = acc;
        }
      for (int y = 0; y < 8; ++y)
        for (int i = 0; i < 8; ++i) {
          float acc = B[i * 8] * tmp[y * 8];
          for (int j = 1; j < 8; ++j)
            acc = acc + B[i * 8 + j] * tmp[y * 8 + j];
          blurred[ch][y * 8 + i] = acc;
        }
    }
    for (int p = 0; p < 64; ++p) {
      float cur[3];
      for (int k = 0; k < 3; ++k) {
        const float* m = S + S_MIX + 3 * k;
        float pre = mix3(m, blurred[0][p], blurred[1][p], blurred[2][p]) +
                    S[S_BIAS + k];
        float sens = gamma_fn(S, pre) / pre;
        cur[k] = (mix3(m, lin[p], lin[64 + p], lin[128 + p]) +
                  S[S_BIAS + k]) *
                 sens;
      }
      for (int k = 0; k < 3; ++k)
        xyb1[k][p] = mix3(S + S_XYB + 3 * k, cur[0], cur[1], cur[2]);
    }
  }

  // MaskHighIntensityChange against the original tile.
  float m0[3][64], m1[3][64];
  {
    float t0[3][64];
    for (int ch = 0; ch < 3; ++ch)
      for (int p = 0; p < 64; ++p) t0[ch][p] = x0[(ch * 64 + p) * stride];
    float ave[3][64];
    for (int ch = 0; ch < 3; ++ch)
      for (int p = 0; p < 64; ++p)
        ave[ch][p] = (t0[ch][p] + xyb1[ch][p]) * 0.5f;
    const float red0 = S[S_RED], red1 = S[S_RED + 1], red2 = S[S_RED + 2];
    const float chroma = S[S_CHROMA];
    for (int y = 0; y < 8; ++y) {
      for (int x = 0; x < 8; ++x) {
        int p = y * 8 + x;
        float yc = ave[1][p];
        float d;
        d = (x >= 1) ? ave[1][p - 1] - yc : 0.0f;
        float sl = (x >= 1) ? d * d : -1.0f;
        d = (x <= 6) ? ave[1][p + 1] - yc : 0.0f;
        float sr = (x <= 6) ? d * d : -1.0f;
        d = (y >= 1) ? ave[1][p - 8] - yc : 0.0f;
        float su = (y >= 1) ? d * d : -1.0f;
        d = (y <= 6) ? ave[1][p + 8] - yc : 0.0f;
        float sd = (y <= 6) ? d * d : -1.0f;
        float sqr_max = max_nan(max_nan(sl, sr), max_nan(su, sd));
        float chroma_scale = chroma / (yc + chroma);
        float mix[3];
        mix[0] = (chroma_scale * red0) / (sqr_max + red0);
        mix[1] = red1 / (sqr_max + red1);
        mix[2] = (chroma_scale * red2) / (sqr_max + red2);
        for (int ch = 0; ch < 3; ++ch) {
          float a = (1.0f - mix[ch]) * ave[ch][p];
          m0[ch][p] = mix[ch] * t0[ch][p] + a;
          m1[ch][p] = mix[ch] * xyb1[ch][p] + a;
        }
      }
    }
  }

  // Block diff: DC and edge terms from the plain difference.
  float dc[3], edge[3];
  {
    float avg[3], ed[4][3];
    for (int ch = 0; ch < 3; ++ch) {
      float colm[8];
      for (int x = 0; x < 8; ++x) {
        float s = m0[ch][x] - m1[ch][x];
        for (int y = 1; y < 8; ++y)
          s = s + (m0[ch][y * 8 + x] - m1[ch][y * 8 + x]);
        colm[x] = s * 0.125f;
      }
      float s = colm[0];
      for (int x = 1; x < 8; ++x) s = s + colm[x];
      avg[ch] = s * 0.125f;
      // Edges: column x=0, row y=0, column x=7, row y=7.
      float e0 = m0[ch][0] - m1[ch][0];
      float e1 = e0;
      float e2 = m0[ch][7] - m1[ch][7];
      float e3 = m0[ch][56] - m1[ch][56];
      for (int i = 1; i < 8; ++i) {
        e0 = e0 + (m0[ch][i * 8] - m1[ch][i * 8]);
        e1 = e1 + (m0[ch][i] - m1[ch][i]);
        e2 = e2 + (m0[ch][i * 8 + 7] - m1[ch][i * 8 + 7]);
        e3 = e3 + (m0[ch][56 + i] - m1[ch][56 + i]);
      }
      ed[0][ch] = e0 * 0.125f;
      ed[1][ch] = e1 * 0.125f;
      ed[2][ch] = e2 * 0.125f;
      ed[3][ch] = e3 * 0.125f;
    }
    const float csf0 = S[S_CSF0];
    float qx, qy, qz;
    low_freq_sq(S, avg[0], avg[1], avg[2], &qx, &qy, &qz);
    dc[0] = qx * csf0;
    dc[1] = qy * csf0;
    dc[2] = qz * csf0;
    float sx = 0.0f, sy = 0.0f, sz = 0.0f;
    for (int k = 0; k < 4; ++k) {
      low_freq_sq(S, ed[k][0], ed[k][1], ed[k][2], &qx, &qy, &qz);
      sx = (k == 0) ? qx : sx + qx;
      sy = (k == 0) ? qy : sy + qy;
      sz = (k == 0) ? qz : sz + qz;
    }
    edge[0] = sx * csf0;
    edge[1] = sy * csf0;
    edge[2] = sz * csf0;
  }

  // Block diff: AC terms from the DFTs of the half difference and the
  // average.
  float ac[3];
  {
    float buf[64], f[64];
    for (int p = 0; p < 64; ++p) buf[p] = (m0[0][p] - m1[0][p]) * 0.5f;
    fft8_sq(T, buf, f);
    ac[0] = wsum(T, f) * S[S_ACX];
    for (int p = 0; p < 64; ++p) buf[p] = (m0[2][p] - m1[2][p]) * 0.5f;
    fft8_sq(T, buf, f);
    ac[2] = wsum(T, f) * S[S_ACZ];
    float ya[64];
    for (int p = 0; p < 64; ++p) buf[p] = (m0[1][p] + m1[1][p]) * 0.5f;
    fft8_sq(T, buf, ya);
    for (int p = 0; p < 64; ++p) buf[p] = (m0[1][p] - m1[1][p]) * 0.5f;
    fft8_sq(T, buf, f);
    const float rng = S[S_YLIM];
    const float ymul2 = S[S_ACY2];
    for (int p = 0; p < 64; ++p) {
      float a = sqrtf(ya[p]);
      float h = sqrtf(f[p]);
      float y0 = remove_range(a - h, rng);
      float y1 = remove_range(a + h, rng);
      float valy = S[S_ACY] * (pw_progression(S + S_HFDY, y0 * ymul2) -
                               pw_progression(S + S_HFDY, y1 * ymul2));
      buf[p] = valy * valy;
    }
    ac[1] = wsum(T, buf);
  }

  float diff = (dc[0] + ac[0]) * sc0;
  diff = diff + (dc[1] + ac[1]) * sc1;
  diff = diff + (dc[2] + ac[2]) * sc2;
  float diff_edge = edge[0] * sc0;
  diff_edge = diff_edge + edge[1] * sc1;
  diff_edge = diff_edge + edge[2] * sc2;
  return sqrtf(S[S_1MEW] * diff + S[S_EW] * diff_edge);
}

// Entry (i, j) of a chroma channel's 10x10 x16 neighbourhood with the
// candidate's IDCT bytes v shifted << 4 into the interior [1..8]x[1..8];
// the frame comes from the frozen neighbourhood nb[10][10].
__device__ __forceinline__ int neigh_at(const int* v, const int* nb, int i,
                                        int j) {
  if (i >= 1 && i <= 8 && j >= 1 && j <= 8)
    return v[(i - 1) * 8 + (j - 1)] << 4;
  return nb[i * 10 + j];
}

// The chroma byte at (y, x) of the macroblock's 16x16 area: the fancy
// upsample (9*s00 + 3*s01 + 3*s10 + s11) >> 4 of the neighbourhood, then
// the ToPixels dither 8 - (x & 1) and >> 4 (x is the column within the
// macroblock; 16*bx is even, so its parity is the absolute column's).
__device__ __forceinline__ int up_byte(const int* v, const int* nb, int y,
                                       int x) {
  int cy = (y >> 1) + 1, cx = (x >> 1) + 1;
  int cy2 = cy + (y & 1) * 2 - 1, cx2 = cx + (x & 1) * 2 - 1;
  int s = (9 * neigh_at(v, nb, cy, cx) + 3 * neigh_at(v, nb, cy, cx2) +
           3 * neigh_at(v, nb, cy2, cx) + neigh_at(v, nb, cy2, cx2)) >> 4;
  return (s + 8 - (x & 1)) >> 4;
}

// Copies the table buffer into shared memory; every thread of the block
// must call it.
__device__ __forceinline__ void load_tables(const float* __restrict__ g,
                                            float* s) {
  for (int i = threadIdx.x; i < N_TABLES; i += blockDim.x) s[i] = g[i];
  __syncthreads();
}

}  // namespace gtk
