// Kernels B, B' and B'': the whole greedy zeroing search of every block.
//
// Replaces the TPU kernel guetzli_tpu/kernels/zeroing_loop.py
// (zeroing_loop_lanes, :301; body _greedy_kernel, :146) in its three
// modes: "444" (B, 8x8 blocks, all three channels), "420y" (B', the 4:2:0
// Y pass: 8x8 Y blocks against frozen chroma bytes) and "420c" (B'', the
// 4:2:0 chroma pass: 16x16 macroblocks of Cb/Cr against frozen Y bytes,
// the max over the four 8x8 sub-blocks).
//
// Per step t of block b: evaluate the candidates order[0..L-1] zeroed
// (lookahead L, only those below the block's remaining count), take the
// strict-< argmin, commit the zero, shift the order list up from the chosen
// position, and write (index, error) into row t of the [192, N] rails.
// With early_exit a block stops once its best error reaches its limit.
// Rows past a block's last step hold (0, +inf), as in the TPU kernel.
//
// Layout. coeffs/order int32 [192, N], nrem int32 [N], lim float32 [N],
// then the mode's frozen state, lane axis minor (see tile_compare_lanes.cu
// for the three layouts); out_idx int32 [192, N], out_err float32
// [192, N].
//
// Design. All three are team kernels (greedy_team below): one CTA per
// block (B, B') or macroblock (B''), which loads the block's coefficients,
// order list and frozen state into shared memory once and runs the
// block's whole loop, a step's candidates one after another, each
// evaluation done by one unit of 64 threads per 8x8 sub-block through
// compare_team.cuh (B and B': 64 threads, B'': 256). This geometry
// measured fastest on an H100 (PERF.md): with all of a step's candidates
// side by side, the CTAs held more registers and fewer fit on an SM.
// Blocks arrive sorted by candidate count, descending, so the longest
// loops start first and the grid's tail is short.
//
// Bound. Each step is up to L block evaluations of about 5*10^4 float
// operations each (four float stages in B''): arithmetic bounds all three
// by far (the rails are ~1.5 KB per block). The team kernels keep a
// block's state in shared memory, run 64 or 256 threads per block and
// hold 64 registers a thread, so 16 and 4 CTAs (32 warps) fit on an SM.
//
// Built with --fmad=false (see compare_block.cuh), so each mode's errors
// equal its compare kernel's (A, A', A'') bit for bit on equal inputs.

#include <math_constants.h>

#include "compare_block.cuh"
#include "compare_team.cuh"

extern __shared__ float4 team_smem[];

// The greedy loop of block b = blockIdx.x by the whole CTA. Every thread
// runs the same steps and candidates and reaches every barrier; the
// decision after each candidate is taken by every thread alike from the
// shared errors.
template <class M>
__device__ __forceinline__ void greedy_team(
    const int* __restrict__ coeffs, const int* __restrict__ order,
    const int* __restrict__ nrem, const float* __restrict__ lim,
    const gtt::State& state, const float* __restrict__ tables,
    int* __restrict__ out_idx, float* __restrict__ out_err, int n,
    int lookahead, int early_exit) {
  using L = gtt::Layout<M>;
  float* sf = (float*)team_smem;
  int* si = (int*)(sf + L::NF);
  const int b = blockIdx.x, tid = threadIdx.x;

  // One pass of loads of the block's state into shared memory.
  for (int i = tid; i < 192; i += L::THREADS) {
    si[L::C + i] = coeffs[(long)i * n + b];
    si[L::ORD + i] = order[(long)i * n + b];
  }
  gtt::load_state<M>(state, tables, sf, si, b, n, tid);
  __syncthreads();

  gtt::Rows R;
  gtt::load_rows(sf + L::TAB, tid & 7, R);
  const float limit = lim[b];
  int r = nrem[b];
  int t = 0, cur = 0;
  while (r > 0 && t < 192) {
    const int* ord = si + L::ORD + cur * 192;
    int* nxt = si + L::ORD + (cur ^ 1) * 192;
    const int nc = lookahead < r ? lookahead : r;
    float best_err = 0.0f;
    int best_l = 0;
    for (int l = 0; l < nc; ++l) {
      const float e = gtt::eval_team<M>(si + L::C, ord[l], sf, si, R, tid);
      if (l == 0 || e < best_err) {   // strict: ties keep the earlier
        best_err = e;
        best_l = l;
      }
    }
    const int best_idx = ord[best_l];
    for (int i = tid; i < 192; i += L::THREADS)
      nxt[i] = (i >= best_l && i < 191) ? ord[i + 1] : ord[i];
    if (tid == 0) {
      si[L::C + best_idx] = 0;
      out_idx[(long)t * n + b] = best_idx;
      out_err[(long)t * n + b] = best_err;
    }
    __syncthreads();
    cur ^= 1;
    ++t;
    r = (early_exit && best_err >= limit) ? 0 : r - 1;
  }
  for (int i = t + tid; i < 192; i += L::THREADS) {
    out_idx[(long)i * n + b] = 0;
    out_err[(long)i * n + b] = CUDART_INF_F;
  }
}

using L444 = gtt::Layout<gtt::Team444>;
using L420y = gtt::Layout<gtt::Team420y>;
using L420c = gtt::Layout<gtt::Team420c>;

extern "C" __global__ void __launch_bounds__(L444::THREADS,
                                             gtt::Team444::MINB)
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
  const gtt::State s{x0, sc, ymax, xmax, nullptr,
                     {nullptr, nullptr, nullptr}};
  greedy_team<gtt::Team444>(coeffs, order, nrem, lim, s, tables, out_idx,
                            out_err, n, lookahead, early_exit);
}

extern "C" __global__ void __launch_bounds__(L420y::THREADS,
                                             gtt::Team420y::MINB)
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
  const gtt::State s{x0, sc, ymax, xmax, nullptr,
                     {chroma, nullptr, nullptr}};
  greedy_team<gtt::Team420y>(coeffs, order, nrem, lim, s, tables, out_idx,
                             out_err, n, lookahead, early_exit);
}

extern "C" __global__ void __launch_bounds__(L420c::THREADS,
                                             gtt::Team420c::MINB)
zeroing_loop_420c_kernel(
    const int* __restrict__ coeffs, const int* __restrict__ order,
    const int* __restrict__ nrem, const float* __restrict__ lim,
    const int* __restrict__ nu, const int* __restrict__ nv,
    const int* __restrict__ y16, const float* __restrict__ x0c,
    const float* __restrict__ scc, const int* __restrict__ ymaxc,
    const int* __restrict__ xmaxc, const int* __restrict__ validc,
    const float* __restrict__ tables, int* __restrict__ out_idx,
    float* __restrict__ out_err, int n, int lookahead, int early_exit) {
  const gtt::State s{x0c, scc, ymaxc, xmaxc, validc, {nu, nv, y16}};
  greedy_team<gtt::Team420c>(coeffs, order, nrem, lim, s, tables, out_idx,
                             out_err, n, lookahead, early_exit);
}

extern "C" int gt_zeroing_loop(const void* coeffs, const void* order,
                               const void* nrem, const void* lim,
                               const void* x0, const void* sc,
                               const void* ymax, const void* xmax,
                               const void* tables, void* out_idx,
                               void* out_err, int n, int lookahead,
                               int early_exit, void* stream) {
  if (n <= 0) return 0;
  int rc = gtt::prefer_smem(zeroing_loop_kernel);
  if (rc != 0) return rc;
  zeroing_loop_kernel<<<n, L444::THREADS, L444::BYTES,
                        (cudaStream_t)stream>>>(
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
  int rc = gtt::prefer_smem(zeroing_loop_420y_kernel);
  if (rc != 0) return rc;
  zeroing_loop_420y_kernel<<<n, L420y::THREADS, L420y::BYTES,
                             (cudaStream_t)stream>>>(
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
  int rc = gtt::prefer_smem(zeroing_loop_420c_kernel);
  if (rc != 0) return rc;
  zeroing_loop_420c_kernel<<<n, L420c::THREADS, L420c::BYTES,
                             (cudaStream_t)stream>>>(
      (const int*)coeffs, (const int*)order, (const int*)nrem,
      (const float*)lim, (const int*)nu, (const int*)nv, (const int*)y16,
      (const float*)x0c, (const float*)scc, (const int*)ymaxc,
      (const int*)xmaxc, (const int*)validc, (const float*)tables,
      (int*)out_idx, (float*)out_err, n, lookahead, early_exit);
  return (int)cudaGetLastError();
}

// The launch geometry of team kernel `mode` (0: B, 1: B'', 2: B'): threads
// and dynamic shared memory bytes per CTA, and the CTAs that fit on one SM.
extern "C" int gt_zeroing_loop_geometry(int mode, int* threads,
                                        int* smem_bytes, int* ctas_per_sm) {
  if (mode == 0)
    return gtt::geometry<gtt::Team444>(zeroing_loop_kernel, threads,
                                       smem_bytes, ctas_per_sm);
  if (mode == 1)
    return gtt::geometry<gtt::Team420c>(zeroing_loop_420c_kernel, threads,
                                        smem_bytes, ctas_per_sm);
  return gtt::geometry<gtt::Team420y>(zeroing_loop_420y_kernel, threads,
                                      smem_bytes, ctas_per_sm);
}
