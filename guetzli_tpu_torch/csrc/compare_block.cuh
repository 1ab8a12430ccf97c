// One block's CompareBlock error (butteraugli_comparator.cc:113-163): the
// table layout and the per-pixel helpers that every kernel of this
// directory shares; compare_team.cuh computes the error from them.
//
// Replaces the per-lane evaluation chain of the TPU kernels
// guetzli_tpu/kernels/tile_compare_lanes.py::_kernel,
// guetzli_tpu/kernels/tile_compare.py::_kernel and
// guetzli_tpu/kernels/zeroing_loop.py::_eval_lanes / _eval_lanes_420c /
// _finish_lanes_k (the jnp chain of guetzli_tpu/ops/tiles_lanes.py).
//
// Two stages. The pixel stage is integer and differs by mode: integer IDCT
// (>>11, >>18, clip) -> edge replication -> fixed-point YCbCr->RGB ->
// sRGB->linear by table. Mode 444 converts all three channels of one 8x8
// block (kernel C replicates the edge by 0/1 selection contractions, the
// others by a clamp gather); 420y only its Y channel, against frozen
// chroma bytes; 420c rebuilds a 16x16 macroblock's chroma (IDCT into a
// frozen 10x10 neighbourhood, fancy upsample, dither: neigh_at and
// up_byte below) and converts each of its four 8x8 sub-blocks against
// frozen Y bytes. The float stage is one and the same for all: 8x8 opsin
// (tile-confined blur, Clenshaw gamma) -> MaskHighIntensityChange against
// the original -> DFT8 block diff (dc / ac / edge) -> sqrt((1-w) * sum_c
// (dc+ac)*sc + w * sum_c edge*sc). compare_team.cuh holds both stages.
//
// Numerics. Every float operation is written in the order of the plain
// PyTorch version (guetzli_tpu_torch/ops/tiles_lanes.py): fixed-order
// unrolled 8-point contractions and sequential sums. The sources are built
// with --fmad=false, so each multiply and each add rounds on its own, as the
// plain version's separate tensor ops do, and the kernels can equal it bit
// for bit. The integer IDCT stays in int32 (products reach 2^27, past the
// float32 mantissa). The two colour-difference DY reads take the closed
// form or, under GUETZLI_TPU_EXACT_LUT=1, the reference's 21-entry
// tables: a template parameter (EXACT) chooses, so the closed form's code
// and shared memory are those of a build without the tables; A, A', A'',
// B, B', B'' have a kernel of each form, C only the closed one. The sRGB->linear step reads a 256-entry table that
// the wrapper evaluates with the plain version's closed form on the same
// device, so it is that function exactly.
//
// Bound. About 5*10^4 float operations per block evaluation on ~1.5 KB of
// per-block state: arithmetic, not bytes, bounds it.

#pragma once

#include <cuda_runtime.h>

// Layout of the float table buffer (guetzli_tpu_torch/kernels/tables.py
// builds it; tests/test_torch_isolation.py holds the two in step).
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
#define N_CLOSED 640    // the closed forms' tables: everything above
#define T_LFDY_LUT 640  // [21] LF_COLOR_DIFF_DY (the table form only)
#define T_HFDY_LUT 661  // [21] HF_COLOR_DIFF_DY (the table form only)
#define N_TABLES 682

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

// Odd piecewise-linear read of an n-entry table (blockdiff.interpolate,
// in its order): the entries around |s|, then l0 + frac * (l1 - l0); the
// last entry from n - 1 on. A NaN reads from entry 0 and stays NaN.
__device__ __forceinline__ float interpolate(const float* lut, int n,
                                             float s) {
  float ix = fabsf(s);
  int base = (ix >= (float)(n - 1)) ? n - 1 : (ix >= 0.0f ? (int)ix : 0);
  int safe = base < n - 2 ? base : n - 2;
  float frac = ix - (float)base;
  float l0 = lut[safe], l1 = lut[safe + 1];
  float res = (base >= n - 1) ? lut[n - 1] : l0 + frac * (l1 - l0);
  return (s < 0.0f) ? -res : res;
}

// A colour-difference DY read: the closed form from the progression's
// scalars at S + prog, or in the table form (EXACT) the 21-entry table at
// T + lut (S = T + T_SCAL).
template <bool EXACT>
__device__ __forceinline__ float dy_read(const float* S, int prog, int lut,
                                         float s) {
  if constexpr (EXACT) return interpolate(S - T_SCAL + lut, 21, s);
  return pw_progression(S + prog, s);
}

// blockdiff.xyb_diff_low_freq_squared.
template <bool EXACT>
__device__ __forceinline__ void low_freq_sq(const float* S, float x, float y,
                                            float z, float* ox, float* oy,
                                            float* oz) {
  z = z + S[S_LF_Y2Z] * y;
  float valz = z * S[S_LF_ZMUL];
  float valx = x * S[S_LF_XMUL];
  float valy = dy_read<EXACT>(S, S_LFDY, T_LFDY_LUT, y * S[S_LF_YMUL]);
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

__device__ __forceinline__ float remove_range(float v, float rng) {
  if (v >= -rng && v < rng) return 0.0f;
  return (v < 0.0f) ? v + rng : v - rng;
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

}  // namespace gtk
