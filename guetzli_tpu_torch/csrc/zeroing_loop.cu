// Kernels B, B' and B'': the whole greedy zeroing search of every block.
//
// Replaces the TPU kernel guetzli_tpu/kernels/zeroing_loop.py
// (zeroing_loop_lanes, body _greedy_kernel) in its three modes: "444" (B,
// 8x8 blocks, all three channels), "420y" (B', the 4:2:0 Y pass: 8x8 Y
// blocks against frozen chroma bytes) and "420c" (B'', the 4:2:0 chroma
// pass: 16x16 macroblocks of Cb/Cr against frozen Y bytes, the max over
// the four 8x8 sub-blocks). The design is the reference's own: one
// work-item per block runs the block's whole greedy loop privately
// (clguetzli.cl:752-879, SURVEY.md section 3.2).
//
// Per step t of block b: evaluate the candidates order[0..L-1] zeroed
// (lookahead L, only those below the block's remaining count), take the
// strict-< argmin, commit the zero, shift the order list up from the chosen
// position, and write (index, error) into row t of the [192, N] rails.
// With early_exit a block stops once its best error reaches its limit.
// Rows past a block's last step hold (0, +inf), as in the TPU kernel. The
// three modes share this loop (greedy_loop below) and differ only in the
// block evaluation (compare_block.cuh).
//
// Layout. coeffs/order int32 [192, N], nrem int32 [N], lim float32 [N],
// then the mode's frozen state, lane axis minor (see tile_compare_lanes.cu
// for the three layouts); out_idx int32 [192, N], out_err float32
// [192, N]. One thread per block, block index minor, so each rail row is
// written coalesced. B and B' run 128 threads per CTA (20,634 blocks of a
// 1444x908 image fill 162 CTAs); B'' runs 32, because the chroma pass has
// a quarter as many lanes (5,187 macroblocks: 163 CTAs at 32, 41 at 128,
// on 132 SMs).
//
// Bound. Each step is up to L block evaluations of about 10^5 float
// operations (four of them in B''): arithmetic bounds it by far (the rails
// are ~1.5 KB per block). The thread keeps its 192 coefficients and 192
// order entries in local memory (about 1 KB). A per-thread trip count
// replaces the TPU kernel's per-tile bound; blocks arrive sorted by
// candidate count, so the threads of a warp run similar trip counts. Load
// balance across warps, shared-memory staging and splitting a block over
// several threads are later work.
//
// Built with --fmad=false (see compare_block.cuh), so each mode's errors
// equal its compare kernel's (A, A', A'') bit for bit on equal inputs.

#include <math_constants.h>

#include "compare_block.cuh"

// The greedy search of lane b; eval(c) scores the 192 coefficients c.
template <class Eval>
__device__ __forceinline__ void greedy_loop(
    const int* __restrict__ coeffs, const int* __restrict__ order, int r,
    float limit, int n, int b, int lookahead, int early_exit,
    int* __restrict__ out_idx, float* __restrict__ out_err, Eval eval) {
  int c[192];
  unsigned char ord[192];
  for (int k = 0; k < 192; ++k) {
    c[k] = coeffs[(long)k * n + b];
    ord[k] = (unsigned char)order[(long)k * n + b];
  }
  int t = 0;
  while (r > 0 && t < 192) {
    float best_err = 0.0f;
    int best_l = 0, best_idx = 0;
    for (int l = 0; l < lookahead && l < r; ++l) {
      int idx = ord[l];
      int saved = c[idx];
      c[idx] = 0;
      float err = eval(c);
      c[idx] = saved;
      if (l == 0 || err < best_err) {   // strict: ties keep the earlier
        best_err = err;
        best_l = l;
        best_idx = idx;
      }
    }
    c[best_idx] = 0;
    for (int j = best_l; j < 191; ++j) ord[j] = ord[j + 1];
    out_idx[(long)t * n + b] = best_idx;
    out_err[(long)t * n + b] = best_err;
    ++t;
    r = (early_exit && best_err >= limit) ? 0 : r - 1;
  }
  for (; t < 192; ++t) {
    out_idx[(long)t * n + b] = 0;
    out_err[(long)t * n + b] = CUDART_INF_F;
  }
}

extern "C" __global__ void __launch_bounds__(128)
zeroing_loop_kernel(const int* __restrict__ coeffs,
                    const int* __restrict__ order,
                    const int* __restrict__ nrem,
                    const float* __restrict__ lim,
                    const float* __restrict__ x0,
                    const float* __restrict__ sc,
                    const int* __restrict__ ymax,
                    const int* __restrict__ xmax,
                    const float* __restrict__ tables,
                    int* __restrict__ out_idx, float* __restrict__ out_err,
                    int n, int lookahead, int early_exit) {
  __shared__ float T[N_TABLES];
  gtk::load_tables(tables, T);
  const float* tab = T;
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  const float s0 = sc[b], s1 = sc[n + b], s2 = sc[2L * n + b];
  const int ym = ymax[b], xm = xmax[b];
  const float* xb = x0 + b;
  greedy_loop(coeffs, order, nrem[b], lim[b], n, b, lookahead, early_exit,
              out_idx, out_err, [&](const int* c) {
                return gtk::compare_block(c, xb, n, s0, s1, s2, ym, xm, tab);
              });
}

extern "C" __global__ void __launch_bounds__(128)
zeroing_loop_420y_kernel(const int* __restrict__ coeffs,
                         const int* __restrict__ order,
                         const int* __restrict__ nrem,
                         const float* __restrict__ lim,
                         const int* __restrict__ chroma,
                         const float* __restrict__ x0,
                         const float* __restrict__ sc,
                         const int* __restrict__ ymax,
                         const int* __restrict__ xmax,
                         const float* __restrict__ tables,
                         int* __restrict__ out_idx,
                         float* __restrict__ out_err, int n, int lookahead,
                         int early_exit) {
  __shared__ float T[N_TABLES];
  gtk::load_tables(tables, T);
  const float* tab = T;
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  const float s0 = sc[b], s1 = sc[n + b], s2 = sc[2L * n + b];
  const int ym = ymax[b], xm = xmax[b];
  const float* xb = x0 + b;
  const int* cb = chroma + b;
  greedy_loop(coeffs, order, nrem[b], lim[b], n, b, lookahead, early_exit,
              out_idx, out_err, [&](const int* c) {
                return gtk::compare_block_420y(c, cb, xb, n, s0, s1, s2, ym,
                                               xm, tab);
              });
}

extern "C" __global__ void __launch_bounds__(32)
zeroing_loop_420c_kernel(
    const int* __restrict__ coeffs, const int* __restrict__ order,
    const int* __restrict__ nrem, const float* __restrict__ lim,
    const int* __restrict__ nu, const int* __restrict__ nv,
    const int* __restrict__ y16, const float* __restrict__ x0c,
    const float* __restrict__ scc, const int* __restrict__ ymaxc,
    const int* __restrict__ xmaxc, const int* __restrict__ validc,
    const float* __restrict__ tables, int* __restrict__ out_idx,
    float* __restrict__ out_err, int n, int lookahead, int early_exit) {
  __shared__ float T[N_TABLES];
  gtk::load_tables(tables, T);
  const float* tab = T;
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  greedy_loop(coeffs, order, nrem[b], lim[b], n, b, lookahead, early_exit,
              out_idx, out_err, [&](const int* c) {
                return gtk::compare_block_420c(
                    c + 64, c + 128, nu + b, nv + b, y16 + b, x0c + b,
                    scc + b, ymaxc + b, xmaxc + b, validc + b, n, tab);
              });
}

static int grid(int n, int threads) { return (n + threads - 1) / threads; }

extern "C" int gt_zeroing_loop(const void* coeffs, const void* order,
                               const void* nrem, const void* lim,
                               const void* x0, const void* sc,
                               const void* ymax, const void* xmax,
                               const void* tables, void* out_idx,
                               void* out_err, int n, int lookahead,
                               int early_exit, void* stream) {
  if (n <= 0) return 0;
  zeroing_loop_kernel<<<grid(n, 128), 128, 0, (cudaStream_t)stream>>>(
      (const int*)coeffs, (const int*)order, (const int*)nrem,
      (const float*)lim, (const float*)x0, (const float*)sc,
      (const int*)ymax, (const int*)xmax, (const float*)tables,
      (int*)out_idx, (float*)out_err, n, lookahead, early_exit);
  return (int)cudaGetLastError();
}

extern "C" int gt_zeroing_loop_420y(const void* coeffs, const void* order,
                                    const void* nrem, const void* lim,
                                    const void* chroma, const void* x0,
                                    const void* sc, const void* ymax,
                                    const void* xmax, const void* tables,
                                    void* out_idx, void* out_err, int n,
                                    int lookahead, int early_exit,
                                    void* stream) {
  if (n <= 0) return 0;
  zeroing_loop_420y_kernel<<<grid(n, 128), 128, 0, (cudaStream_t)stream>>>(
      (const int*)coeffs, (const int*)order, (const int*)nrem,
      (const float*)lim, (const int*)chroma, (const float*)x0,
      (const float*)sc, (const int*)ymax, (const int*)xmax,
      (const float*)tables, (int*)out_idx, (float*)out_err, n, lookahead,
      early_exit);
  return (int)cudaGetLastError();
}

extern "C" int gt_zeroing_loop_420c(
    const void* coeffs, const void* order, const void* nrem, const void* lim,
    const void* nu, const void* nv, const void* y16, const void* x0c,
    const void* scc, const void* ymaxc, const void* xmaxc,
    const void* validc, const void* tables, void* out_idx, void* out_err,
    int n, int lookahead, int early_exit, void* stream) {
  if (n <= 0) return 0;
  zeroing_loop_420c_kernel<<<grid(n, 32), 32, 0, (cudaStream_t)stream>>>(
      (const int*)coeffs, (const int*)order, (const int*)nrem,
      (const float*)lim, (const int*)nu, (const int*)nv, (const int*)y16,
      (const float*)x0c, (const float*)scc, (const int*)ymaxc,
      (const int*)xmaxc, (const int*)validc, (const float*)tables,
      (int*)out_idx, (float*)out_err, n, lookahead, early_exit);
  return (int)cudaGetLastError();
}
