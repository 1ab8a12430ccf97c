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
// Two designs. B and B'' are team kernels (greedy_team below): one CTA
// per block (B) or macroblock (B''), which loads the block's
// coefficients, order list and frozen state into shared memory once and
// runs the block's whole loop, a step's candidates one after another,
// each evaluation done by one unit of 64 threads per 8x8 sub-block
// through compare_team.cuh (B: 64 threads, B'': 256). This geometry
// measured fastest on an H100 (PERF.md): with all of a step's candidates
// side by side, the CTAs held more registers and fewer fit on an SM.
// Blocks arrive sorted by candidate count, descending, so the longest
// loops start first and the grid's tail is short. B' keeps the
// reference's design (clguetzli.cl:752-879): one thread per block runs the
// block's whole loop privately (greedy_loop below, compare_block.cuh), 128
// threads per CTA.
//
// Bound. Each step is up to L block evaluations of about 5*10^4 float
// operations each (four float stages in B''): arithmetic bounds all three
// by far (the rails are ~1.5 KB per block). The per-thread design keeps a
// block's state in local memory (255 registers and a ~9.5 KB stack per
// thread) with one thread per block, so B'' had about 1.2 warps per SM;
// the team kernels keep it in shared memory, run 64 or 256 threads per
// block and hold 64 registers a thread, so 16 and 4 CTAs (32 warps) fit
// on an SM.
//
// Built with --fmad=false (see compare_block.cuh), so each mode's errors
// equal its compare kernel's (A, A', A'') bit for bit on equal inputs.

#include <math_constants.h>

#include "compare_block.cuh"
#include "compare_team.cuh"

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

static int grid(int n, int threads) { return (n + threads - 1) / threads; }

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


// ---- The team kernels B and B'' ----------------------------------------

// SUBS: 8x8 sub-blocks per block, one 64-thread unit each, so a CTA
// evaluates one candidate at a time; MINB: the CTAs per SM asked of ptxas
// (__launch_bounds__), which caps the registers at 64 (with a spill of 88
// and 160 bytes of stack); IBC: IDCT scratch ints; NB: frozen int state
// beyond the clamps (B'': nu, nv [10][10], y16 [16][16]).
struct Team444 {
  static constexpr int SUBS = 1, MINB = 16, IBC = 384, NB = 0;
};
struct Team420c {
  static constexpr int SUBS = 4, MINB = 4, IBC = 256, NB = 456;
};

// The CTA's dynamic shared memory: floats, then ints (offsets in words).
template <class M>
struct Layout {
  static constexpr int THREADS = M::SUBS * gtt::UNIT;
  static constexpr int TAB = 0;                             // N_TABLES
  static constexpr int UNITF = N_TABLES;                    // units' scratch
  static constexpr int X0 = UNITF + M::SUBS * gtt::F_UNIT;  // [SUBS][192]
  static constexpr int SC = X0 + M::SUBS * 192;             // [SUBS][4]
  static constexpr int ERR = SC + M::SUBS * 4;              // [SUBS]
  static constexpr int NF = (ERR + M::SUBS + 3) / 4 * 4;
  static constexpr int C = 0;                  // [192] coefficients
  static constexpr int ORD = 192;              // [2][192] order, doubled
  static constexpr int IB = ORD + 384;         // [IBC]
  static constexpr int CL = IB + M::IBC;       // ymax, xmax, valid [SUBS]
  static constexpr int NBI = CL + 3 * M::SUBS; // [NB]
  static constexpr int NI = NBI + M::NB;
  static constexpr int BYTES = (NF + NI) * 4;
  // Within the 48 KB a launch may ask without cudaFuncSetAttribute.
  static_assert(BYTES <= 48 * 1024, "dynamic shared memory above 48 KB");
};

extern __shared__ float4 team_smem[];

// The greedy loop of block b = blockIdx.x by the whole CTA. Every thread
// runs the same steps and candidates and reaches every barrier; the
// decision after each candidate is taken by every thread alike from the
// shared errors.
template <class M>
__device__ __forceinline__ void greedy_team(
    const int* __restrict__ coeffs, const int* __restrict__ order,
    const int* __restrict__ nrem, const float* __restrict__ lim,
    const float* __restrict__ x0, const float* __restrict__ sc,
    const int* __restrict__ ymax, const int* __restrict__ xmax,
    const int* __restrict__ valid, const int* __restrict__ nu,
    const int* __restrict__ nv, const int* __restrict__ y16,
    const float* __restrict__ tables, int* __restrict__ out_idx,
    float* __restrict__ out_err, int n, int lookahead, int early_exit) {
  using L = Layout<M>;
  float* sf = (float*)team_smem;
  int* si = (int*)(sf + L::NF);
  const float* T = sf + L::TAB;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int sub = tid / gtt::UNIT, p = tid % gtt::UNIT;

  // One pass of loads of the block's state into shared memory.
  for (int i = tid; i < N_TABLES; i += L::THREADS) sf[L::TAB + i] = tables[i];
  for (int i = tid; i < 192; i += L::THREADS) {
    si[L::C + i] = coeffs[(long)i * n + b];
    si[L::ORD + i] = order[(long)i * n + b];
  }
  for (int i = tid; i < M::SUBS * 192; i += L::THREADS)
    sf[L::X0 + i] = x0[(long)i * n + b];
  for (int i = tid; i < M::SUBS * 3; i += L::THREADS)
    sf[L::SC + (i / 3) * 4 + i % 3] = sc[(long)i * n + b];
  for (int i = tid; i < M::SUBS; i += L::THREADS) {
    si[L::CL + i] = ymax[(long)i * n + b];
    si[L::CL + M::SUBS + i] = xmax[(long)i * n + b];
    si[L::CL + 2 * M::SUBS + i] = valid ? valid[(long)i * n + b] : 1;
  }
  if constexpr (M::NB > 0) {
    for (int i = tid; i < M::NB; i += L::THREADS)
      si[L::NBI + i] = i < 100   ? nu[(long)i * n + b]
                       : i < 200 ? nv[(long)(i - 100) * n + b]
                                 : y16[(long)(i - 200) * n + b];
  }
  __syncthreads();

  gtt::Rows R;
  gtt::load_rows(T, p & 7, R);
  float* U = sf + L::UNITF + sub * gtt::F_UNIT;
  int* ib = si + L::IB;
  const int* c = si + L::C;
  const int ym = si[L::CL + sub], xm = si[L::CL + M::SUBS + sub];
  const bool active = si[L::CL + 2 * M::SUBS + sub] > 0;
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
      const int zero = ord[l];
      if constexpr (M::SUBS == 1)
        gtt::pixel_444_team(c, zero, ib, U + gtt::F_LIN, ym, xm, T, R, p);
      else
        gtt::pixel_420c_team(c, zero, ib, U + gtt::F_LIN, sub, si + L::NBI,
                             si + L::NBI + 100, si + L::NBI + 200, ym, xm, T,
                             R, tid, active);
      gtt::finish_team(U, sf + L::X0 + sub * 192, sf + L::SC + sub * 4, T,
                       R, p, active, sf + L::ERR + sub);
      __syncthreads();
      // B: the block's error; B'': the max over the valid sub-blocks,
      // starting from 0.
      float e = M::SUBS == 1 ? sf[L::ERR] : 0.0f;
      if constexpr (M::SUBS > 1)
        for (int s = 0; s < M::SUBS; ++s)
          if (si[L::CL + 2 * M::SUBS + s] > 0)
            e = gtk::max_nan(e, sf[L::ERR + s]);
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

extern "C" __global__ void __launch_bounds__(Layout<Team444>::THREADS,
                                             Team444::MINB)
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
  greedy_team<Team444>(coeffs, order, nrem, lim, x0, sc, ymax, xmax,
                       nullptr, nullptr, nullptr, nullptr, tables, out_idx,
                       out_err, n, lookahead, early_exit);
}

extern "C" __global__ void __launch_bounds__(Layout<Team420c>::THREADS,
                                             Team420c::MINB)
zeroing_loop_420c_kernel(
    const int* __restrict__ coeffs, const int* __restrict__ order,
    const int* __restrict__ nrem, const float* __restrict__ lim,
    const int* __restrict__ nu, const int* __restrict__ nv,
    const int* __restrict__ y16, const float* __restrict__ x0c,
    const float* __restrict__ scc, const int* __restrict__ ymaxc,
    const int* __restrict__ xmaxc, const int* __restrict__ validc,
    const float* __restrict__ tables, int* __restrict__ out_idx,
    float* __restrict__ out_err, int n, int lookahead, int early_exit) {
  greedy_team<Team420c>(coeffs, order, nrem, lim, x0c, scc, ymaxc, xmaxc,
                        validc, nu, nv, y16, tables, out_idx, out_err, n,
                        lookahead, early_exit);
}

// Asks for the largest shared-memory carveout of the SM's 256 KB, so that
// shared memory and not the L1 split limits the CTAs per SM.
template <class K>
static int prefer_smem(K kernel) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
}

extern "C" int gt_zeroing_loop(const void* coeffs, const void* order,
                               const void* nrem, const void* lim,
                               const void* x0, const void* sc,
                               const void* ymax, const void* xmax,
                               const void* tables, void* out_idx,
                               void* out_err, int n, int lookahead,
                               int early_exit, void* stream) {
  if (n <= 0) return 0;
  int rc = prefer_smem(zeroing_loop_kernel);
  if (rc != 0) return rc;
  zeroing_loop_kernel<<<n, Layout<Team444>::THREADS, Layout<Team444>::BYTES,
                        (cudaStream_t)stream>>>(
      (const int*)coeffs, (const int*)order, (const int*)nrem,
      (const float*)lim, (const float*)x0, (const float*)sc,
      (const int*)ymax, (const int*)xmax, (const float*)tables,
      (int*)out_idx, (float*)out_err, n, lookahead, early_exit);
  return (int)cudaGetLastError();
}

extern "C" int gt_zeroing_loop_420c(
    const void* coeffs, const void* order, const void* nrem, const void* lim,
    const void* nu, const void* nv, const void* y16, const void* x0c,
    const void* scc, const void* ymaxc, const void* xmaxc,
    const void* validc, const void* tables, void* out_idx, void* out_err,
    int n, int lookahead, int early_exit, void* stream) {
  if (n <= 0) return 0;
  int rc = prefer_smem(zeroing_loop_420c_kernel);
  if (rc != 0) return rc;
  zeroing_loop_420c_kernel<<<n, Layout<Team420c>::THREADS,
                             Layout<Team420c>::BYTES,
                             (cudaStream_t)stream>>>(
      (const int*)coeffs, (const int*)order, (const int*)nrem,
      (const float*)lim, (const int*)nu, (const int*)nv, (const int*)y16,
      (const float*)x0c, (const float*)scc, (const int*)ymaxc,
      (const int*)xmaxc, (const int*)validc, (const float*)tables,
      (int*)out_idx, (float*)out_err, n, lookahead, early_exit);
  return (int)cudaGetLastError();
}

// The launch geometry of team kernel `mode` (0: B, 1: B''): threads and
// dynamic shared memory bytes per CTA, and the CTAs that fit on one SM.
extern "C" int gt_zeroing_loop_geometry(int mode, int* threads,
                                        int* smem_bytes, int* ctas_per_sm) {
  int rc;
  if (mode == 0) {
    *threads = Layout<Team444>::THREADS;
    *smem_bytes = Layout<Team444>::BYTES;
    rc = prefer_smem(zeroing_loop_kernel);
    if (rc == 0)
      rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          ctas_per_sm, zeroing_loop_kernel, *threads, *smem_bytes);
  } else {
    *threads = Layout<Team420c>::THREADS;
    *smem_bytes = Layout<Team420c>::BYTES;
    rc = prefer_smem(zeroing_loop_420c_kernel);
    if (rc == 0)
      rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          ctas_per_sm, zeroing_loop_420c_kernel, *threads, *smem_bytes);
  }
  return rc;
}
