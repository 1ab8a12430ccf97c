// Kernels A, A' and A'': the per-block compare over lane-major candidates.
//
// A replaces the TPU kernel guetzli_tpu/kernels/tile_compare_lanes.py
// (_tile_compare_lanes, body _kernel): one 4:4:4 CompareBlock per 8x8
// block. A' and A'' are the 4:2:0 compares that the JAX package computes
// in XLA (guetzli_tpu/ops/tiles_lanes.py: compare_blocks_lanes420y, the Y
// pass against frozen chroma; compare_blocks_lanes420c, one 16x16
// macroblock's chroma against frozen Y). search/zeroing.py re-evaluates
// each greedy kernel (B, B', B'') with its mode's compare.
//
// Layout. Inputs are lane-major, block index minor: cand int32 [3,8,8,N]
// (A' reads plane 0, A'' planes 1 and 2), then the mode's frozen state:
// A: x0 float32 [3,8,8,N], sc float32 [3,N], ymax/xmax int32 [N];
// A': chroma int32 [2,8,8,N] and A's state; A'': nu/nv int32 [10,10,N],
// y16 int32 [16,16,N], x0c float32 [2,2,3,8,8,N], scc float32 [2,2,3,N],
// ymaxc/xmaxc/validc int32 [2,2,N]. out float32 [N].
//
// Design. All three are team compares: the lane's candidates and frozen
// state go into the shared-memory Layout of the mode's greedy kernel and
// one evaluation of compare_team.cuh runs on them (A, A': one 64-thread
// unit; A'': four, one per 8x8 sub-block), the same load and evaluation
// as B, B' and B'' (zeroing_loop.cu), so each compare equals its greedy
// kernel's last error by construction. One CTA per lane (block or
// macroblock), 16 CTAs per SM for A and A' and 4 for A''.
//
// No loop hides a compare's load: element k of lane b sits at [k * n + b],
// so a CTA reads one 4-byte word of each 32-byte sector. A form that took
// G consecutive lanes per CTA and staged their state in one coalesced pass
// was slower on an H100 at every G from 2 to 8 (PERF.md): the
// staging area costs CTAs per SM and the per-lane loop spills.
//
// Bound. About 5*10^4 float operations per 8x8 evaluation (four of them
// for A'') for about 1.6 KB (A'': 5.6 KB) of operand bytes: arithmetic
// bounds it, not memory.
//
// Built with --fmad=false (see compare_block.cuh): each multiply and add
// rounds on its own, as in the plain PyTorch version.

#include "compare_block.cuh"
#include "compare_team.cuh"

extern __shared__ float4 team_smem[];

// The error of lane blockIdx.x by the whole CTA of a team compare of mode
// M that reads the NC candidate rows from row C0, its DY reads in the
// closed form or by table (EXACT). Every thread reaches every barrier.
template <class M, int C0, int NC, bool EXACT>
__device__ __forceinline__ void compare_team(
    const int* __restrict__ cand, const gtt::State& s,
    const float* __restrict__ tables, float* __restrict__ out, int n) {
  using L = gtt::Layout<M, EXACT>;
  float* sf = (float*)team_smem;
  int* si = (int*)(sf + L::NF);
  const int tid = threadIdx.x, b = blockIdx.x;
  for (int i = C0 + tid; i < C0 + NC; i += L::THREADS)
    si[L::C + i] = cand[(long)i * n + b];
  gtt::load_state<M, EXACT>(s, tables, sf, si, b, n, tid);
  __syncthreads();
  gtt::Rows R;
  gtt::load_rows(sf + L::TAB, tid & 7, R);
  const float e = gtt::eval_team<M, EXACT>(si + L::C, -1, sf, si, R, tid);
  if (tid == 0) out[b] = e;
}

using L444 = gtt::Layout<gtt::Team444>;
using L420y = gtt::Layout<gtt::Team420y>;
using L420c = gtt::Layout<gtt::Team420c>;

// Each compare's kernel in the closed form and its table form (_exact,
// GUETZLI_TPU_EXACT_LUT=1); a macro writes the pair.
#define GT_COMPARE_444(NAME, EXACT)                                         \
  extern "C" __global__ void __launch_bounds__(L444::THREADS,              \
                                               gtt::Team444::MINB)         \
  NAME(const int* __restrict__ cand, const float* __restrict__ x0,          \
       const float* __restrict__ sc, const int* __restrict__ ymax,          \
       const int* __restrict__ xmax, const float* __restrict__ tables,      \
       float* __restrict__ out, int n) {                                    \
    const gtt::State s{x0, sc, ymax, xmax, nullptr,                         \
                       {nullptr, nullptr, nullptr}};                        \
    compare_team<gtt::Team444, 0, 192, EXACT>(cand, s, tables, out, n);     \
  }
GT_COMPARE_444(tile_compare_lanes_kernel, false)
GT_COMPARE_444(tile_compare_lanes_exact_kernel, true)

#define GT_COMPARE_420Y(NAME, EXACT)                                        \
  extern "C" __global__ void __launch_bounds__(L420y::THREADS,             \
                                               gtt::Team420y::MINB)        \
  NAME(const int* __restrict__ cand, const int* __restrict__ chroma,        \
       const float* __restrict__ x0, const float* __restrict__ sc,          \
       const int* __restrict__ ymax, const int* __restrict__ xmax,          \
       const float* __restrict__ tables, float* __restrict__ out, int n) {  \
    const gtt::State s{x0, sc, ymax, xmax, nullptr,                         \
                       {chroma, nullptr, nullptr}};                         \
    compare_team<gtt::Team420y, 0, 64, EXACT>(cand, s, tables, out, n);     \
  }
GT_COMPARE_420Y(tile_compare_lanes_420y_kernel, false)
GT_COMPARE_420Y(tile_compare_lanes_420y_exact_kernel, true)

#define GT_COMPARE_420C(NAME, EXACT)                                        \
  extern "C" __global__ void __launch_bounds__(L420c::THREADS,             \
                                               gtt::Team420c::MINB)        \
  NAME(const int* __restrict__ cand, const int* __restrict__ nu,            \
       const int* __restrict__ nv, const int* __restrict__ y16,             \
       const float* __restrict__ x0c, const float* __restrict__ scc,        \
       const int* __restrict__ ymaxc, const int* __restrict__ xmaxc,        \
       const int* __restrict__ validc, const float* __restrict__ tables,    \
       float* __restrict__ out, int n) {                                    \
    const gtt::State s{x0c, scc, ymaxc, xmaxc, validc, {nu, nv, y16}};     \
    compare_team<gtt::Team420c, 64, 128, EXACT>(cand, s, tables, out, n);   \
  }
GT_COMPARE_420C(tile_compare_lanes_420c_kernel, false)
GT_COMPARE_420C(tile_compare_lanes_420c_exact_kernel, true)

// Launches the closed-form kernel or, with `exact`, its table form over n
// CTAs, each with the dynamic shared memory of its Layout L or LX.
template <class L, class LX, class K, class... A>
static int launch(K kernel, K kernel_exact, int exact, int n, void* stream,
                  A... args) {
  if (n <= 0) return 0;
  K k = exact ? kernel_exact : kernel;
  int rc = gtt::prefer_smem(k);
  if (rc != 0) return rc;
  k<<<n, L::THREADS, exact ? LX::BYTES : L::BYTES, (cudaStream_t)stream>>>(
      args...);
  return (int)cudaGetLastError();
}

extern "C" int gt_tile_compare_lanes(const void* cand, const void* x0,
                                     const void* sc, const void* ymax,
                                     const void* xmax, const void* tables,
                                     void* out, int n, int exact,
                                     void* stream) {
  return launch<L444, gtt::Layout<gtt::Team444, true>>(
      tile_compare_lanes_kernel, tile_compare_lanes_exact_kernel, exact, n,
      stream, (const int*)cand, (const float*)x0, (const float*)sc,
      (const int*)ymax, (const int*)xmax, (const float*)tables, (float*)out,
      n);
}

extern "C" int gt_tile_compare_lanes_420y(const void* cand,
                                          const void* chroma, const void* x0,
                                          const void* sc, const void* ymax,
                                          const void* xmax,
                                          const void* tables, void* out,
                                          int n, int exact, void* stream) {
  return launch<L420y, gtt::Layout<gtt::Team420y, true>>(
      tile_compare_lanes_420y_kernel, tile_compare_lanes_420y_exact_kernel,
      exact, n, stream, (const int*)cand, (const int*)chroma,
      (const float*)x0, (const float*)sc, (const int*)ymax, (const int*)xmax,
      (const float*)tables, (float*)out, n);
}

extern "C" int gt_tile_compare_lanes_420c(
    const void* cand, const void* nu, const void* nv, const void* y16,
    const void* x0c, const void* scc, const void* ymaxc, const void* xmaxc,
    const void* validc, const void* tables, void* out, int n, int exact,
    void* stream) {
  return launch<L420c, gtt::Layout<gtt::Team420c, true>>(
      tile_compare_lanes_420c_kernel, tile_compare_lanes_420c_exact_kernel,
      exact, n, stream, (const int*)cand, (const int*)nu, (const int*)nv,
      (const int*)y16, (const float*)x0c, (const float*)scc,
      (const int*)ymaxc, (const int*)xmaxc, (const int*)validc,
      (const float*)tables, (float*)out, n);
}

// The launch geometry of team compare `mode` (0: A'', 1: A, 2: A'), in
// the closed form: threads and dynamic shared memory bytes per CTA, and
// the CTAs that fit on one SM.
extern "C" int gt_tile_compare_lanes_geometry(int mode, int* threads,
                                              int* smem_bytes,
                                              int* ctas_per_sm) {
  if (mode == 0)
    return gtt::geometry<gtt::Team420c>(tile_compare_lanes_420c_kernel,
                                        threads, smem_bytes, ctas_per_sm);
  if (mode == 1)
    return gtt::geometry<gtt::Team444>(tile_compare_lanes_kernel, threads,
                                       smem_bytes, ctas_per_sm);
  if (mode == 2)
    return gtt::geometry<gtt::Team420y>(tile_compare_lanes_420y_kernel,
                                        threads, smem_bytes, ctas_per_sm);
  return 1;  // cudaErrorInvalidValue
}
